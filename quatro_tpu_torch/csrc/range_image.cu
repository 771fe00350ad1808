// The range-image projection's point keys and pixel owners, two kernels
// around the one stable sort of the (pixel, quantised range) keys.
//
// The counterpart of quatro_tpu/preprocessing/projection.py::
// project_to_range_image (:72-98, the keys, and :118-136, the owner
// image; XLA fuses each into loop fusions around its lax.sort; no Pallas
// kernel there), bit for bit quatro_tpu_torch/ops/range_image.py::
// range_image_plain, whose arithmetic is utils/fused.py's
// (fdlibm_atan2.cuh).
//
// keys: points (B, N, 3) f32 and mask (B, N) bool -> row, col (B, N)
//   int64, rng (B, N) f32, ok (B, N) bool, flat (B, N) int64 (npix where
//   not ok) and the sort key (flat << 15) + rq as int32 less 2^31 (the key
//   is below 2^32, so the order is the int64 key's), rq the range
//   quantised to 15 bits (0 where not ok). The same launch sets every
//   pixel of the owner image to empty (-1, f32 max).
// owner: the keys sorted (stable) with their point indices -> for each
//   pixel run's first sorted position among the first ``ac`` (the
//   max_points prefix), owner[flat] = the point's index and img[flat] =
//   (rq + 0.5) * 120 / 2^15; the packed word (rq << 17) + index of the
//   plain version is rebuilt from the key and the index, and a word equal
//   to the uint32 sentinel leaves the pixel empty, as there.
//
// Bound on the card: bytes. At path P's B = 64 (128 clouds of 131072
// points, 64 x 1800 images) the keys read 13 bytes a point and write 33,
// the owner image 12 bytes a pixel; 793 MB, 0.24 ms at 3.35 TB/s.
// Design: one thread a point (and a pixel) for the keys, with the
// arithmetic in registers (the plain version's ~80 elementwise launches
// in one pass); one thread a sorted position for the owners, which reads
// its key and its left neighbour's and writes only where a run starts.
#include <cstdint>

#include <cuda_runtime.h>

#include "fdlibm_atan2.cuh"

namespace quatro {

constexpr int kRangeThreads = 256;
constexpr int kRBits = 15;
constexpr int kIBits = 17;
constexpr float kF32Max = 3.40282346638528859812e+38f;

struct ProjectionParams {
  int rows, cols;
  float ang_bottom;     // f32(lidar.ang_bottom)
  float recip_y;        // fused.recip(lidar.ang_res_y)
  float recip_x;        // fused.recip(lidar.ang_res_x)
  float deg;            // f32(180 / pi)
  float min_range;      // compared in f32, as torch compares a scalar
  float rq_scale;       // f32(2^15 / 120)
};

__global__ void __launch_bounds__(kRangeThreads)
range_keys_kernel(const float* __restrict__ points, const bool* __restrict__ mask, int n,
                  ProjectionParams p, long long* __restrict__ row_out,
                  long long* __restrict__ col_out, float* __restrict__ rng_out,
                  bool* __restrict__ ok_out, long long* __restrict__ flat_out,
                  int* __restrict__ key_out, float* __restrict__ img,
                  long long* __restrict__ owner) {
  using namespace fdlibm;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  const int npix = p.rows * p.cols;
  if (e < npix) {
    img[b * npix + e] = kF32Max;
    owner[b * npix + e] = -1;
  }
  if (e >= n) return;
  const size_t i = b * n + e;
  const float x = points[3 * i], y = points[3 * i + 1], z = points[3 * i + 2];
  const float rxy = hypot(x, y);
  float r2 = fma64(z, z, fma64(x, x, fmul(y, y)));
  r2 = (r2 != r2) ? r2 : fmaxf(r2, 0.0f);               // torch.clamp(min=0)
  const float rng = __fsqrt_rn(r2);
  const float vert = fma64(atan2(z, rxy), p.deg, p.ang_bottom);
  const long long row = (long long)floorf(fmul(vert, p.recip_y));
  const float horiz = fma64(atan2(x, y), p.deg, -90.0f);
  // int64 sums wrap as torch's do (col saturates where horiz is NaN)
  unsigned long long ucol = (unsigned long long)(long long)(-rintf(fmul(horiz, p.recip_x))) +
                            (unsigned long long)(p.cols / 2);
  if ((long long)ucol >= p.cols) ucol -= (unsigned long long)p.cols;
  const long long col = (long long)ucol;
  const bool ok = mask[i] && row >= 0 && row < p.rows && col >= 0 && col < p.cols &&
                  rng >= p.min_range;
  const long long flat = ok ? row * p.cols + col : npix;
  float rqf = fmul(rng, p.rq_scale);
  rqf = (rqf != rqf) ? rqf : fminf(fmaxf(rqf, 0.0f), (float)((1 << kRBits) - 1));
  const unsigned rq = ok ? (unsigned)rqf : 0u;
  const unsigned key = ((unsigned)flat << kRBits) + rq;
  row_out[i] = row;
  col_out[i] = col;
  rng_out[i] = rng;
  ok_out[i] = ok;
  flat_out[i] = flat;
  key_out[i] = (int)(key ^ 0x80000000u);
}

__global__ void __launch_bounds__(kRangeThreads)
range_owner_kernel(const int* __restrict__ key_s, const long long* __restrict__ order, int n,
                   int ac, int npix, float* __restrict__ img, long long* __restrict__ owner) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  if (k >= ac) return;
  const unsigned u = (unsigned)key_s[b * n + k] ^ 0x80000000u;
  const unsigned f = u >> kRBits;
  if (f >= (unsigned)npix) return;
  if (k > 0 && (((unsigned)key_s[b * n + k - 1] ^ 0x80000000u) >> kRBits) == f) return;
  const unsigned idx = (unsigned)order[b * n + k];
  const unsigned rq = u & ((1u << kRBits) - 1);
  const unsigned packed = (rq << kIBits) + idx;
  if (packed == 0xFFFFFFFFu) return;                    // the sentinel: empty
  owner[b * npix + f] = packed & ((1u << kIBits) - 1);
  img[b * npix + f] = __fmul_rn((float)(packed >> kIBits) + 0.5f,
                                120.0f / (float)(1 << kRBits));
}

}  // namespace quatro

extern "C" int quatro_range_image_keys(const float* points, const bool* mask, int bsz, int n,
                                       int rows, int cols, float ang_bottom, float recip_y,
                                       float recip_x, float deg, float min_range,
                                       float rq_scale, long long* row, long long* col,
                                       float* rng, bool* ok, long long* flat, int* key,
                                       float* img, long long* owner, cudaStream_t stream) {
  using namespace quatro;
  const ProjectionParams p{rows, cols, ang_bottom, recip_y, recip_x, deg, min_range, rq_scale};
  const int span = n > rows * cols ? n : rows * cols;
  dim3 grid((span + kRangeThreads - 1) / kRangeThreads, bsz);
  range_keys_kernel<<<grid, kRangeThreads, 0, stream>>>(points, mask, n, p, row, col, rng, ok,
                                                        flat, key, img, owner);
  return (int)cudaGetLastError();
}

extern "C" int quatro_range_image_owner(const int* key_s, const long long* order, int bsz,
                                        int n, int ac, int npix, float* img, long long* owner,
                                        cudaStream_t stream) {
  using namespace quatro;
  if (ac <= 0) return (int)cudaGetLastError();
  dim3 grid((ac + kRangeThreads - 1) / kRangeThreads, bsz);
  range_owner_kernel<<<grid, kRangeThreads, 0, stream>>>(key_s, order, n, ac, npix, img, owner);
  return (int)cudaGetLastError();
}
