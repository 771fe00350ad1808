// Every edge mask of a range-image labelling call in one launch.
//
// The counterpart of quatro_tpu/preprocessing/projection.py::
// _neighbor_edges (:141-158), called once a neighbour offset, and of
// label_components' composed 4CrossNeighbor masks (:196-244; XLA fuses the
// rolls, the angle criterion and the compositions into loop fusions; no
// Pallas kernel there), bit for bit quatro_tpu_torch/ops/range_image.py::
// edge_masks_plain.
//
// rimg (B, R, C) f32 and valid (B, R, C) bool -> out (S, B, R, C) bool,
// S = the offsets (at most 8, |dr|, |dc| <= 1), then under compose the four
// composed masks. For offset d = (dr, dc), with positions wrapping on both
// axes as the rolls do:
//   e_d[p] = valid[p] & valid[p + d] & (dr == 0 or 0 <= row(p) + dr < R)
//            & atan2(d2 sin_a, fma(d2, -cos_a, d1)) > theta,
// d1 / d2 the larger / smaller of rimg[p] and rimg[p + d], (sin_a, cos_a)
// the host's f32 constants of ang_res_x (dr == 0) or ang_res_y, the
// arithmetic that of utils/fused.py (fdlibm_atan2.cuh). The composed mask
// of the diagonal pair (a, b) is
//   (e_a[p] & e_b[p + a]) | (e_b[p] & e_a[p + b]).
//
// Bound on the card: bytes. The masks are written once (8 bytes a pixel
// under 4CrossNeighbor and 8Neighbor) and the image read once (5 bytes a
// pixel): at path P's B = 64 (128 images of 64 x 1800) 192 MB, 0.057 ms
// at 3.35 TB/s; the arithmetic, four arctangents a pixel, is ~1 GFLOP.
// Design: a block computes a tile of kTileR x kTileC pixels. It stages
// the tile's range and valid values with a halo of two rows and two
// columns in shared memory (wrapped indices), computes every base edge of
// the tile and its one-pixel halo into a byte of bits a pixel (the
// composed masks read the edges of diagonal neighbours), then writes each
// mask's bytes, neighbouring threads on neighbouring columns. Without
// compose the halo's edges are skipped.
#include <cuda_runtime.h>

#include "fdlibm_atan2.cuh"

namespace quatro {

constexpr int kEdgeThreads = 256;
constexpr int kTileR = 16;
constexpr int kTileC = 64;
constexpr int kHalo = 2;
constexpr int kLoadR = kTileR + 2 * kHalo;
constexpr int kLoadC = kTileC + 2 * kHalo;
constexpr int kBitsR = kTileR + 2;
constexpr int kBitsC = kTileC + 2;
constexpr int kMaxOffsets = 8;

struct EdgeParams {
  int n_off;
  int dr[kMaxOffsets], dc[kMaxOffsets];
  int compose;
  int comp_a[4], comp_b[4];   // offset indices of each composed pair
  float sin_x, cos_x, sin_y, cos_y, theta;
};

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__global__ void __launch_bounds__(kEdgeThreads)
edge_masks_kernel(const float* __restrict__ rimg, const bool* __restrict__ valid, int bsz,
                  int rows, int cols, EdgeParams p, bool* __restrict__ out) {
  using namespace fdlibm;
  __shared__ float s_r[kLoadR][kLoadC];
  __shared__ bool s_v[kLoadR][kLoadC];
  __shared__ unsigned char s_e[kBitsR][kBitsC];
  const int c0 = blockIdx.x * kTileC, r0 = blockIdx.y * kTileR;
  const size_t b = blockIdx.z;
  const size_t npix = (size_t)rows * cols;
  const float* img = rimg + b * npix;
  const bool* val = valid + b * npix;
  for (int t = threadIdx.x; t < kLoadR * kLoadC; t += kEdgeThreads) {
    const int i = t / kLoadC, j = t % kLoadC;
    const size_t q = (size_t)wrap(r0 - kHalo + i, rows) * cols + wrap(c0 - kHalo + j, cols);
    s_r[i][j] = img[q];
    s_v[i][j] = val[q];
  }
  __syncthreads();
  // base edges of the tile, and under compose of its one-pixel halo
  const int h = p.compose ? 1 : 0;
  const int er = kTileR + 2 * h, ec = kTileC + 2 * h;
  for (int t = threadIdx.x; t < er * ec; t += kEdgeThreads) {
    const int i = t / ec + 1 - h, j = t % ec + 1 - h;   // in the bits tile
    const int li = i + 1, lj = j + 1;                   // in the load tile
    const int grow = wrap(r0 - 1 + i, rows);
    unsigned bits = 0;
    if (s_v[li][lj]) {
      const float v = s_r[li][lj];
      for (int s = 0; s < p.n_off; ++s) {
        const int dr = p.dr[s], dc = p.dc[s];
        if (!s_v[li + dr][lj + dc]) continue;
        if (dr != 0 && (grow + dr < 0 || grow + dr >= rows)) continue;
        const float sv = s_r[li + dr][lj + dc];
        const float d1 = tmax(v, sv), d2 = tmin(v, sv);
        const float sa = dr == 0 ? p.sin_x : p.sin_y;
        const float ca = dr == 0 ? p.cos_x : p.cos_y;
        if (atan2(fmul(d2, sa), fma64(d2, -ca, d1)) > p.theta) bits |= 1u << s;
      }
    }
    s_e[i][j] = (unsigned char)bits;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kTileR * kTileC; t += kEdgeThreads) {
    const int ti = t / kTileC, tj = t % kTileC;
    const int r = r0 + ti, c = c0 + tj;
    if (r >= rows || c >= cols) continue;
    const int i = ti + 1, j = tj + 1;
    const unsigned e = s_e[i][j];
    const size_t o = b * npix + (size_t)r * cols + c;
    const size_t plane = (size_t)bsz * npix;
    for (int s = 0; s < p.n_off; ++s) out[s * plane + o] = (e >> s) & 1u;
    if (!p.compose) continue;
    for (int m = 0; m < 4; ++m) {
      const int a = p.comp_a[m], bb = p.comp_b[m];
      const unsigned at_a = s_e[i + p.dr[a]][j + p.dc[a]];
      const unsigned at_b = s_e[i + p.dr[bb]][j + p.dc[bb]];
      out[(p.n_off + m) * plane + o] =
          (((e >> a) & (at_a >> bb)) | ((e >> bb) & (at_b >> a))) & 1u;
    }
  }
}

}  // namespace quatro

// offs: host int32 (n_off, 2) offsets; comp: host int32 (4, 2) offset
// indices of the composed pairs (read only where compose is 1).
extern "C" int quatro_edge_masks(const float* rimg, const bool* valid, int bsz, int rows,
                                 int cols, int n_off, const int* offs, int compose,
                                 const int* comp, float sin_x, float cos_x, float sin_y,
                                 float cos_y, float theta, bool* out, cudaStream_t stream) {
  using namespace quatro;
  if (n_off < 1 || n_off > kMaxOffsets) return (int)cudaErrorInvalidValue;
  EdgeParams p{};
  p.n_off = n_off;
  for (int s = 0; s < n_off; ++s) {
    p.dr[s] = offs[2 * s];
    p.dc[s] = offs[2 * s + 1];
    if (p.dr[s] < -1 || p.dr[s] > 1 || p.dc[s] < -1 || p.dc[s] > 1)
      return (int)cudaErrorInvalidValue;
  }
  p.compose = compose;
  for (int m = 0; compose && m < 4; ++m) {
    p.comp_a[m] = comp[2 * m];
    p.comp_b[m] = comp[2 * m + 1];
  }
  p.sin_x = sin_x;
  p.cos_x = cos_x;
  p.sin_y = sin_y;
  p.cos_y = cos_y;
  p.theta = theta;
  dim3 grid((cols + kTileC - 1) / kTileC, (rows + kTileR - 1) / kTileR, bsz);
  edge_masks_kernel<<<grid, kEdgeThreads, 0, stream>>>(rimg, valid, bsz, rows, cols, p, out);
  return (int)cudaGetLastError();
}
