// SPFH: Darboux-angle bin counts and pair count per point.
//
// Replaces quatro_tpu/ops/pallas_frontend.py::spfh_pallas (_spfh_kernel,
// _spfh_body): for every valid row i, over every valid column j with
// 1e-12 < |p_i - p_j|^2 <= r^2 (self excluded) and a non-degenerate
// Darboux frame, one count in each of the three 11-bin histograms
// (f1 = atan2 angle, f2, f3) plus one in the pair count. Masked rows get
// zeros.
//
// Arithmetic, which ops/frontend.py::darboux_bins repeats in PyTorch's
// elementwise operations (spfh_plain on CUDA tensors takes the same bins):
// every product, sum and difference rounded once (common.cuh), rsqrtf and
// atan2f as torch.rsqrt and torch.atan2 take them on the card, and each
// bin floor(11 (f - lo) * (1 / width)) with the f32 reciprocal of the
// width, which is how both CUDA and the JAX package's compiled code divide
// by a constant. Counts are integers, exact in any order.
//
// Bound on the card: bytes. The inputs are ~200 KB per cloud and the
// outputs ~1.1 MB; the radius tests of the tile pairs an exact culling
// keeps and ~80 operations and one atan2f per in-radius pair take less.
// Design, as the moment sums' (moment_sums.cu), on the same pre-pass:
// 1. the pre-pass (tiles.cuh) writes each 32-point tile's AABB of its valid
//    points and the active limit (inside frontend_fpfh the FPFH kernel
//    reuses this table);
// 2. one warp per 32-row tile, one lane per row, four warps per block with
//    the row tiles interleaved across blocks; a warp whose rows all lie past
//    the limit writes zeros. The others walk the column tiles that pass
//    tiles_in_radius in ascending order, stage a tile's 32 points (masked
//    columns as NaN, which fail the radius test) and normals as SoA, load
//    the next passing tile's into registers while they work, and all lanes
//    walk the 32 columns in lockstep, four radius tests at a
//    time, skipping a column no lane has within the radius. Each lane's 34
//    counters are unsigned integers in shared memory laid out
//    [counter][lane] per warp, so a warp's increments fall in 32 distinct
//    banks whatever bins they hit, and no atomics are needed: each lane
//    owns its counters.
// The TPU kernel bins f1 with sector tests because Mosaic has no atan;
// here atan2f and the floor bin it as the dense path does, so only pairs
// within f32 rounding of a bin edge can differ from it.
#include "tiles.cuh"

namespace quatro {

namespace {

constexpr int kSpfhWarps = 4;              // row tiles per block
constexpr int kBins = 11;
constexpr int kCounters = 3 * kBins + 1;   // 33 bins + the pair count
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct V3 { float x, y, z; };

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}

__device__ __forceinline__ V3 scale3(V3 a, float s) {
  return {mul(a.x, s), mul(a.y, s), mul(a.z, s)};
}

// floor(11 (f - lo) * inv_width) clipped to [0, 10]
__device__ __forceinline__ int bin11(float f, float lo, float inv_width) {
  const float t = floorf(mul(mul(11.f, sub(f, lo)), inv_width));
  return (int)fminf(fmaxf(t, 0.f), (float)(kBins - 1));
}

}  // namespace

__global__ void __launch_bounds__(kSpfhWarps * 32)
spfh_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
            const float* __restrict__ maskf, int v, int tiles, float r2,
            const float* __restrict__ bounds, const int* __restrict__ lim,
            float* __restrict__ hist_out, float* __restrict__ cnt_out) {
  __shared__ __align__(16) float sp[kSpfhWarps][6][kTile];   // x y z, nx ny nz
  __shared__ unsigned int hist[kSpfhWarps][kCounters][kTile];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rt = blockIdx.x + gridDim.x * warp;
  if (rt >= tiles) return;
  const int i = rt * kTile + lane;
  const int limit = lim[b];
  const float* p = pts + (size_t)b * v * 3;
  const float* nn = nrm + (size_t)b * v * 3;
  const float* m = maskf + (size_t)b * v;
  const float* bt = bounds + (size_t)b * tiles * kBoundsCols;
  unsigned int (*h)[kTile] = hist[warp];
  float (*c)[kTile] = sp[warp];
  for (int k = 0; k < kCounters; ++k) h[k][lane] = 0u;
  if (rt * kTile < limit) {
    const float inv_two_pi = __fdiv_rn(1.f, kTwoPi);
    const bool live = i < v && m[i] > 0.f;
    V3 pi{0.f, 0.f, 0.f}, ni{0.f, 0.f, 0.f};
    if (live) {
      pi = {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
      ni = {nn[3 * i], nn[3 * i + 1], nn[3 * i + 2]};
    }
    PassingTiles walk{bt + rt * kBoundsCols, bt, r2, (limit + kTile - 1) / kTile};
    // this lane's column of a tile: its point (NaN where it is masked) and
    // normal
    float col[6];
    auto fetch = [&](int t) {
      const int j = t * kTile + lane;
      const bool in = t >= 0 && j < v;
      const bool vj = in && m[j] > 0.f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        col[d] = vj ? p[3 * j + d] : CUDART_NAN_F;
        col[3 + d] = in ? nn[3 * j + d] : 0.f;
      }
    };
    int t = walk.next(lane);
    fetch(t);
    while (t >= 0) {
      __syncwarp();   // the previous tile is consumed
#pragma unroll
      for (int d = 0; d < 6; ++d) c[d][lane] = col[d];
      __syncwarp();
      t = walk.next(lane);
      fetch(t);   // in flight while this tile is binned
      // four columns at a time: their radius tests overlap
      for (int q0 = 0; q0 < kTile; q0 += 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(&c[0][q0]);
        const float4 y4 = *reinterpret_cast<const float4*>(&c[1][q0]);
        const float4 z4 = *reinterpret_cast<const float4*>(&c[2][q0]);
        const float cx[4] = {x4.x, x4.y, x4.z, x4.w};
        const float cy[4] = {y4.x, y4.y, y4.z, y4.w};
        const float cz[4] = {z4.x, z4.y, z4.z, z4.w};
        V3 off[4];
        float dd[4];
        bool near[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // the offset dx = x_i - x_j; d below points i -> j
          off[k] = {sub(pi.x, cx[k]), sub(pi.y, cy[k]), sub(pi.z, cz[k])};
          dd[k] = sq3(off[k].x, off[k].y, off[k].z);
          near[k] = live && dd[k] <= r2 && dd[k] > 1e-12f;
        }
        if (!__any_sync(0xffffffffu, near[0] || near[1] || near[2] || near[3]))
          continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = near[k];
          if (!__any_sync(0xffffffffu, ok)) continue;
          const int q = q0 + k;
          const float dx = off[k].x, dy = off[k].y, dz = off[k].z, d2 = dd[k];
          const V3 d{-dx, -dy, -dz};
          const V3 nj{c[3][q], c[4][q], c[5][q]};
          const float inv_dist = rsqrtf(fmaxf(d2, 1e-30f));
          const float a1 = mul(dot3(ni, d), inv_dist);
          const float a2 = mul(dot3(nj, d), inv_dist);
          const bool swap = fabsf(a1) < fabsf(a2);
          const V3 n1 = swap ? nj : ni;
          const V3 n2 = swap ? ni : nj;
          const V3 ds = swap ? V3{dx, dy, dz} : d;
          const float f3 = swap ? -a2 : a1;
          V3 vv = cross3(ds, n1);
          const float vn2 = dot3(vv, vv);
          if (ok && vn2 > 1e-20f) {
            vv = scale3(vv, rsqrtf(fmaxf(vn2, 1e-30f)));
            const V3 ww = cross3(n1, vv);
            const float f2 = dot3(vv, n2);
            const float f1 = atan2f(dot3(ww, n2), dot3(n1, n2));
            h[bin11(f1, -kPi, inv_two_pi)][lane] += 1u;
            h[kBins + bin11(f2, -1.f, 0.5f)][lane] += 1u;
            h[2 * kBins + bin11(f3, -1.f, 0.5f)][lane] += 1u;
            h[3 * kBins][lane] += 1u;
          }
        }
      }
    }
  }
  if (i < v) {
    float* o = hist_out + ((size_t)b * v + i) * (3 * kBins);
    for (int k = 0; k < 3 * kBins; ++k) o[k] = (float)h[k][lane];
    cnt_out[(size_t)b * v + i] = (float)h[3 * kBins][lane];
  }
}

}  // namespace quatro

// points, normals (B, V, 3) f32, pair maskf (B, V) f32 0/1 -> hist (B, V,
// 33) f32 bin counts, cnt (B, V) f32 pair counts; bounds (B, ceil(V / 32),
// 8) f32 and lim (B,) int32 receive the pre-pass's tile AABBs and active
// limits, which the FPFH kernel can take.
extern "C" int quatro_spfh(const float* pts, const float* nrm, const float* maskf,
                           int batch, int v, float r2, float* bounds, int* lim,
                           float* hist, float* cnt, cudaStream_t stream) {
  const int tiles = (v + quatro::kTile - 1) / quatro::kTile;
  const int rc =
      quatro::launch_tile_bounds(pts, maskf, batch, v, tiles, bounds, lim, stream);
  if (rc != 0) return rc;
  dim3 grid((tiles + quatro::kSpfhWarps - 1) / quatro::kSpfhWarps, batch);
  quatro::spfh_kernel<<<grid, quatro::kSpfhWarps * 32, 0, stream>>>(
      pts, nrm, maskf, v, tiles, r2, bounds, lim, hist, cnt);
  return (int)cudaGetLastError();
}
