// FPFH: inverse-squared-distance weighted sum of neighbour SPFH rows.
//
// Replaces the pair pass of quatro_tpu/ops/pallas_frontend.py::frontend_fpfh
// (_fpfh_kernel): for every valid row i,
//   out_i = sum_j SPFH_j / max(d2_ij, 1e-12)
// over valid columns j with 1e-12 < d2_ij <= r^2. Masked rows get zeros.
// The per-block x100/sum normalisation stays in PyTorch
// (ops/fpfh.py::normalize_blocks), as the TPU kernel left it to XLA.
//
// Bound on the card: operations. ~10 operations per pair for the weight
// over V^2 pairs, plus 33 FMAs per in-radius pair; inputs are ~1.2 MB per
// cloud (points + SPFH).
// Design: one thread per output row keeps its 33 sums in registers; the
// block stages kCols points and their SPFH rows in shared memory (33 KB),
// and every thread reads the same staged row at the same time, which the
// shared memory broadcasts. Sums run in ascending column order in full
// f32 FMA (no tensor cores, no TF32), the same on every run.
#include "common.cuh"

namespace quatro {

namespace {
constexpr int kDim = 33;
}

__global__ void __launch_bounds__(kRows)
fpfh_kernel(const float* __restrict__ pts, const float* __restrict__ spfh,
            const float* __restrict__ maskf, int v, float r2,
            float* __restrict__ out) {
  const int b = blockIdx.y;
  const float* p = pts + (size_t)b * v * 3;
  const float* s = spfh + (size_t)b * v * kDim;
  const float* m = maskf + (size_t)b * v;
  const int i = blockIdx.x * kRows + threadIdx.x;
  __shared__ float sx[kCols], sy[kCols], sz[kCols], sm[kCols];
  __shared__ float ss[kCols * kDim];

  const bool live = i < v && m[i] > 0.f;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) { xi = p[3 * i]; yi = p[3 * i + 1]; zi = p[3 * i + 2]; }
  float acc[kDim];
#pragma unroll
  for (int k = 0; k < kDim; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < v; c0 += kCols) {
    const int n = min(kCols, v - c0);
    for (int t = threadIdx.x; t < kCols; t += kRows) {
      const int j = c0 + t;
      const bool in = j < v;
      sx[t] = in ? p[3 * j] : 0.f;
      sy[t] = in ? p[3 * j + 1] : 0.f;
      sz[t] = in ? p[3 * j + 2] : 0.f;
      sm[t] = in ? m[j] : 0.f;
    }
    for (int e = threadIdx.x; e < n * kDim; e += kRows) ss[e] = s[(size_t)c0 * kDim + e];
    __syncthreads();
    if (live) {
      for (int t = 0; t < n; ++t) {
        if (sm[t] <= 0.f) continue;
        const float d2 = sq3(sub(xi, sx[t]), sub(yi, sy[t]), sub(zi, sz[t]));
        if (!(d2 <= r2 && d2 > 1e-12f)) continue;
        const float w = __fdiv_rn(1.f, fmaxf(d2, 1e-12f));
        const float* row = ss + t * kDim;
#pragma unroll
        for (int k = 0; k < kDim; ++k) acc[k] = fmaf(w, row[k], acc[k]);
      }
    }
    __syncthreads();
  }
  if (i < v) {
    float* o = out + ((size_t)b * v + i) * kDim;
#pragma unroll
    for (int k = 0; k < kDim; ++k) o[k] = acc[k];
  }
}

}  // namespace quatro

// points (B, V, 3) f32, spfh (B, V, 33) f32, pair maskf (B, V) f32 0/1
//   -> out (B, V, 33) f32 unnormalised weighted sums.
extern "C" int quatro_fpfh(const float* pts, const float* spfh, const float* maskf,
                           int batch, int v, float r2, float* out,
                           cudaStream_t stream) {
  dim3 grid((v + quatro::kRows - 1) / quatro::kRows, batch);
  quatro::fpfh_kernel<<<grid, quatro::kRows, 0, stream>>>(pts, spfh, maskf, v, r2,
                                                          out);
  return (int)cudaGetLastError();
}
