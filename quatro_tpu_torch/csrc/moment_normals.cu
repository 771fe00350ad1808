// PCA normals from the radius neighbourhoods' moment sums: the tail of the
// front end's normals after B3.
//
// The counterpart of quatro_tpu/ops/pallas_frontend.py:321-353
// (normals_from_moments, XLA fusions after moment_sums_pallas; no Pallas
// kernel there), bit for bit quatro_tpu_torch/ops/normals.py::
// moment_normals_plain (normals_from_moments) on the card.
//
// points (B, V, 3) f32, mask (B, V) bool, B3's moments (B, V, S) f32 with
// S >= 10 ([count, s_dx, s_dy, s_dz, s_dxdx, s_dxdy, s_dxdz, s_dydy,
// s_dydz, s_dzdz]), the viewpoint -> normals (B, V, 3), curvature (B, V)
// f32, valid (B, V) bool. A thread a point: centered_covariance (the means
// as tensor quotients by the count clamped to 1, each covariance entry
// fused.fma's route: the exact product in f64, one f64 addition, then f32),
// the smallest eigenpair of eig_sym3.cuh, the trace and curvature, the
// viewpoint flip and the masks, each operation rounding once as its torch
// operation does on the card (no contraction: the _rn intrinsics).
//
// Bound on the card: bytes (path A: 2 x 8192 points, 57 bytes in and 17
// out a point, 1.2 MB, 0.0004 ms).
#include <cuda_runtime.h>

#include "eig_sym3.cuh"
#include "fdlibm_atan2.cuh"

namespace quatro {
namespace mnrm {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
moment_normals_kernel(const float* __restrict__ pts, const bool* __restrict__ mask,
                      const float* __restrict__ mom, int v, int stride, float vx, float vy,
                      float vz, float* __restrict__ normals, float* __restrict__ curvature,
                      bool* __restrict__ valid_out) {
  using namespace eig;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= v) return;
  const size_t o = (size_t)blockIdx.y * v + i;
  const float* m = mom + o * stride;
  const float c = m[0];
  const float cnt = clamp_min(c, 1.0f);
  const float mx = fdiv(m[1], cnt), my = fdiv(m[2], cnt), mz = fdiv(m[3], cnt);
  // fused.fma(-m_a, m_b, s_ab / cnt)
  auto cov = [&](int k, float ma, float mb) { return fdlibm::fma64(-ma, mb, fdiv(m[k], cnt)); };
  const float cxx = cov(4, mx, mx), cxy = cov(5, mx, my), cxz = cov(6, mx, mz);
  const float cyy = cov(7, my, my), cyz = cov(8, my, mz), czz = cov(9, mz, mz);
  const Eigenpair e = smallest_eigenpair_sym3(cxx, cxy, cxz, cyy, cyz, czz);
  const float curv = fdiv(e.eig, clamp_min(fadd(fadd(cxx, cyy), czz), kTiny));
  const float px = pts[3 * o], py = pts[3 * o + 1], pz = pts[3 * o + 2];
  const float facing =
      fadd(fadd(fmul(e.v1, fsub(vx, px)), fmul(e.v2, fsub(vy, py))), fmul(e.v3, fsub(vz, pz)));
  const float sign = (facing < 0.0f) ? -1.0f : 1.0f;
  const bool ok = (c >= 3.0f) && mask[o];
  const float okf = ok ? 1.0f : 0.0f;
  normals[3 * o] = fmul(fmul(e.v1, sign), okf);
  normals[3 * o + 1] = fmul(fmul(e.v2, sign), okf);
  normals[3 * o + 2] = fmul(fmul(e.v3, sign), okf);
  curvature[o] = ok ? curv : 0.0f;
  valid_out[o] = ok;
}

}  // namespace mnrm
}  // namespace quatro

// points (B, V, 3), mask (B, V), moments (B, V, stride) with stride >= 10,
// the viewpoint -> normals (B, V, 3), curvature (B, V), valid (B, V)
extern "C" int quatro_moment_normals(const float* pts, const bool* mask, const float* mom,
                                     int bsz, int v, int stride, float vx, float vy, float vz,
                                     float* normals, float* curvature, bool* valid_out,
                                     cudaStream_t stream) {
  using namespace quatro::mnrm;
  dim3 grid((v + kThreads - 1) / kThreads, bsz);
  moment_normals_kernel<<<grid, kThreads, 0, stream>>>(pts, mask, mom, v, stride, vx, vy, vz,
                                                       normals, curvature, valid_out);
  return (int)cudaGetLastError();
}
