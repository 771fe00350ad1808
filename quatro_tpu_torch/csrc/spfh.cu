// SPFH: Darboux-angle bin counts and pair count per point.
//
// Replaces quatro_tpu/ops/pallas_frontend.py::spfh_pallas (_spfh_kernel,
// _spfh_body): for every valid row i, over every valid column j with
// 1e-12 < |p_i - p_j|^2 <= r^2 (self excluded) and a non-degenerate
// Darboux frame, one count in each of the three 11-bin histograms
// (f1 = atan2 angle, f2, f3) plus one in the pair count. Masked rows get
// zeros.
//
// Bound on the card: operations. ~100 f32 operations and one atan2f per
// in-radius pair over V^2 pairs; the inputs are ~200 KB per cloud.
// Design: one thread per output row; the block streams points and normals
// through shared memory and every thread walks the staged columns in
// ascending order. The 34 counters of each row are unsigned integers in
// shared memory laid out [counter][thread], so a warp's increments fall
// in 32 distinct banks whatever bins they hit, and no atomics are needed:
// each thread owns its counters. Counts are integers, exact in any order.
// The TPU kernel bins f1 with sector tests because Mosaic has no atan;
// here atan2f and floor(11 (f1 + pi) / 2pi) bin it as the dense path does,
// so only pairs within f32 rounding of a bin edge can differ from it.
#include "common.cuh"

namespace quatro {

namespace {

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

// floor(11 (f - lo) / width) clipped to [0, 10]
__device__ __forceinline__ int bin11(float f, float lo, float width) {
  const float t = floorf(__fdiv_rn(mul(11.f, sub(f, lo)), width));
  return (int)fminf(fmaxf(t, 0.f), (float)(kBins - 1));
}

}  // namespace

__global__ void __launch_bounds__(kRows)
spfh_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
            const float* __restrict__ maskf, int v, float r2,
            float* __restrict__ hist_out, float* __restrict__ cnt_out) {
  const int b = blockIdx.y;
  const float* p = pts + (size_t)b * v * 3;
  const float* nn = nrm + (size_t)b * v * 3;
  const float* m = maskf + (size_t)b * v;
  const int i = blockIdx.x * kRows + threadIdx.x;
  __shared__ float sp[3][kCols], sn[3][kCols], sm[kCols];
  __shared__ unsigned int hist[kCounters][kRows];

  for (int k = 0; k < kCounters; ++k) hist[k][threadIdx.x] = 0u;
  const bool live = i < v && m[i] > 0.f;
  V3 pi{0.f, 0.f, 0.f}, ni{0.f, 0.f, 0.f};
  if (live) {
    pi = {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
    ni = {nn[3 * i], nn[3 * i + 1], nn[3 * i + 2]};
  }

  for (int c0 = 0; c0 < v; c0 += kCols) {
    for (int t = threadIdx.x; t < kCols; t += kRows) {
      const int j = c0 + t;
      const bool in = j < v;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sp[c][t] = in ? p[3 * j + c] : 0.f;
        sn[c][t] = in ? nn[3 * j + c] : 0.f;
      }
      sm[t] = in ? m[j] : 0.f;
    }
    __syncthreads();
    if (live) {
      const int n = min(kCols, v - c0);
      for (int t = 0; t < n; ++t) {
        if (sm[t] <= 0.f) continue;
        // d points i -> j (the negated offset dx = x_i - x_j)
        const float dx = sub(pi.x, sp[0][t]), dy = sub(pi.y, sp[1][t]),
                    dz = sub(pi.z, sp[2][t]);
        const float d2 = sq3(dx, dy, dz);
        if (!(d2 <= r2 && d2 > 1e-12f)) continue;
        const V3 d{-dx, -dy, -dz};
        const V3 nj{sn[0][t], sn[1][t], sn[2][t]};
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
        if (!(vn2 > 1e-20f)) continue;
        vv = scale3(vv, rsqrtf(fmaxf(vn2, 1e-30f)));
        const V3 ww = cross3(n1, vv);
        const float f2 = dot3(vv, n2);
        const float f1 = atan2f(dot3(ww, n2), dot3(n1, n2));
        hist[bin11(f1, -kPi, kTwoPi)][threadIdx.x] += 1u;
        hist[kBins + bin11(f2, -1.f, 2.f)][threadIdx.x] += 1u;
        hist[2 * kBins + bin11(f3, -1.f, 2.f)][threadIdx.x] += 1u;
        hist[3 * kBins][threadIdx.x] += 1u;
      }
    }
    __syncthreads();
  }
  if (i < v) {
    float* o = hist_out + ((size_t)b * v + i) * (3 * kBins);
    for (int k = 0; k < 3 * kBins; ++k) o[k] = (float)hist[k][threadIdx.x];
    cnt_out[(size_t)b * v + i] = (float)hist[3 * kBins][threadIdx.x];
  }
}

}  // namespace quatro

// points, normals (B, V, 3) f32, pair maskf (B, V) f32 0/1
//   -> hist (B, V, 33) f32 bin counts, cnt (B, V) f32 pair counts.
extern "C" int quatro_spfh(const float* pts, const float* nrm, const float* maskf,
                           int batch, int v, float r2, float* hist, float* cnt,
                           cudaStream_t stream) {
  dim3 grid((v + quatro::kRows - 1) / quatro::kRows, batch);
  quatro::spfh_kernel<<<grid, quatro::kRows, 0, stream>>>(pts, nrm, maskf, v, r2,
                                                          hist, cnt);
  return (int)cudaGetLastError();
}
