// Ten centred neighbourhood moment sums per point.
//
// Replaces quatro_tpu/ops/pallas_frontend.py::moment_sums_pallas
// (_moments_kernel): for every valid row i, over every valid column j with
// |p_i - p_j|^2 <= r^2 (self included), the sums of
//   1, dx, dy, dz, dx*dx, dx*dy, dx*dz, dy*dy, dy*dz, dz*dz,  dx = x_i - x_j.
// Masked rows get zeros.
//
// Bound on the card: operations. The input is ~100 KB per cloud, but each
// of the V^2 pairs costs ~25 f32 operations (67 M pairs per cloud at
// V = 8192), so the work is compute and issue, not bytes.
// Design: one thread per output row keeps its ten sums in registers; a
// block of kRows rows streams the cloud through shared memory kCols points
// at a time and every thread walks the staged points in ascending column
// order. No atomics, so the sums are the same on every run. The TPU
// kernel's per-tile bounding-box and active-tile skips are speed only and
// are left out of this first version.
#include "common.cuh"

namespace quatro {

__global__ void __launch_bounds__(kRows)
moment_sums_kernel(const float* __restrict__ pts, const float* __restrict__ maskf,
                   int v, float r2, float* __restrict__ out) {
  const int b = blockIdx.y;
  const float* p = pts + (size_t)b * v * 3;
  const float* m = maskf + (size_t)b * v;
  const int i = blockIdx.x * kRows + threadIdx.x;
  __shared__ float sx[kCols], sy[kCols], sz[kCols], sm[kCols];

  const bool live = i < v && m[i] > 0.f;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (live) { xi = p[3 * i]; yi = p[3 * i + 1]; zi = p[3 * i + 2]; }
  float acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < v; c0 += kCols) {
    for (int t = threadIdx.x; t < kCols; t += kRows) {
      const int j = c0 + t;
      const bool in = j < v;
      sx[t] = in ? p[3 * j] : 0.f;
      sy[t] = in ? p[3 * j + 1] : 0.f;
      sz[t] = in ? p[3 * j + 2] : 0.f;
      sm[t] = in ? m[j] : 0.f;
    }
    __syncthreads();
    if (live) {
      const int n = min(kCols, v - c0);
      for (int t = 0; t < n; ++t) {
        if (sm[t] <= 0.f) continue;
        const float dx = sub(xi, sx[t]), dy = sub(yi, sy[t]), dz = sub(zi, sz[t]);
        if (sq3(dx, dy, dz) <= r2) {
          acc[0] += 1.f;
          acc[1] += dx;
          acc[2] += dy;
          acc[3] += dz;
          acc[4] += dx * dx;
          acc[5] += dx * dy;
          acc[6] += dx * dz;
          acc[7] += dy * dy;
          acc[8] += dy * dz;
          acc[9] += dz * dz;
        }
      }
    }
    __syncthreads();
  }
  if (i < v) {
    float* o = out + ((size_t)b * v + i) * 10;
#pragma unroll
    for (int k = 0; k < 10; ++k) o[k] = acc[k];
  }
}

}  // namespace quatro

// points (B, V, 3) f32, maskf (B, V) f32 0/1 -> out (B, V, 10) f32.
extern "C" int quatro_moment_sums(const float* pts, const float* maskf, int batch,
                                  int v, float r2, float* out, cudaStream_t stream) {
  dim3 grid((v + quatro::kRows - 1) / quatro::kRows, batch);
  quatro::moment_sums_kernel<<<grid, quatro::kRows, 0, stream>>>(pts, maskf, v, r2, out);
  return (int)cudaGetLastError();
}
