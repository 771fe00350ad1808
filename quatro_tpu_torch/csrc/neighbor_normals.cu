// PCA normals over K-capped neighbour lists: the weighted mean and the
// centred moments of each point's K slots, then the smallest eigenpair.
//
// The counterpart of quatro_tpu/ops/normals.py:94-138 (estimate_normals,
// XLA loop fusions; no Pallas kernel there), bit for bit
// quatro_tpu_torch/ops/normals.py::estimate_normals_plain.
//
// points (B, N, 3) f32, idx (B, N, K) int32, valid (B, N, K) bool, the
// viewpoint -> normals (B, N, 3), curvature (B, N) f32, valid (B, N) bool.
// A warp a point, lane l holding slots l and l + 32 (K <= 64). Each of the
// ten sums (the count, three means, six moments) goes over the slots in
// fused.pairwise_sum's tree: the K values padded with +0 to a power of
// two P, then halves added, slots l and l + 32 in the lane when P = 64 and
// shuffles down from P / 2 (at most 16) to 1. The products are the plain
// version's, w * x and (w * (a - m_a)) * (b - m_b), and a quotient by the
// count is __fdiv_rn (a tensor quotient). Then lane 0 takes the eigenpair
// of eig_sym3.cuh (torch's card rounding of smallest_eigenpair_sym3), the
// curvature, the viewpoint flip and the masks, each operation rounding
// once as its torch operation does on the card.
//
// Bound on the card: bytes (path A: 8192 x 48 slots of 5 bytes, the points
// once and 20 bytes a point out, 2.3 MB, 0.0007 ms; the gathers hit L2).
#include <cuda_runtime.h>

#include "eig_sym3.cuh"

namespace quatro {
namespace nrm {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// the pairwise tree of a warp's values: lane l holds slot l's value v0 and
// slot l + 32's v1 (both +0 past K); p2 is the padded width
__device__ __forceinline__ float tree_sum(float v0, float v1, int p2) {
  using namespace eig;
  float v = (p2 == 64) ? fadd(v0, v1) : v0;
  for (int h = (p2 == 64 ? 32 : p2) / 2; h >= 1; h >>= 1)
    v = fadd(v, __shfl_down_sync(kFull, v, h));
  return __shfl_sync(kFull, v, 0);
}

__global__ void __launch_bounds__(kThreads)
neighbor_normals_kernel(const float* __restrict__ pts, const int* __restrict__ idx,
                        const bool* __restrict__ valid, int n, int k, int p2, float vx, float vy,
                        float vz, float* __restrict__ normals, float* __restrict__ curvature,
                        bool* __restrict__ valid_out) {
  using namespace eig;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const size_t b = blockIdx.y;
  if (row >= n) return;
  const float* P = pts + b * n * 3;
  const size_t base = (b * n + row) * k;
  // slot s of the row: its weight and point; +0 and no read past K
  float w[2] = {0.0f, 0.0f}, x[2] = {0.0f, 0.0f}, y[2] = {0.0f, 0.0f}, z[2] = {0.0f, 0.0f};
  bool in[2] = {false, false};
  int nvalid = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lane + 32 * h;
    if (s < k) {
      in[h] = true;
      const bool v = valid[base + s];
      const int j = idx[base + s];
      w[h] = v ? 1.0f : 0.0f;
      x[h] = P[3 * j];
      y[h] = P[3 * j + 1];
      z[h] = P[3 * j + 2];
      nvalid += v;
    }
  }
  nvalid = __reduce_add_sync(kFull, nvalid);
  // pairwise_sum(w * c) over the slots: +0 past K
  auto sum_of = [&](float t0, float t1) { return tree_sum(in[0] ? t0 : 0.0f, in[1] ? t1 : 0.0f, p2); };
  const float cnt = clamp_min(sum_of(w[0], w[1]), 1.0f);
  const float mx = fdiv(sum_of(fmul(w[0], x[0]), fmul(w[1], x[1])), cnt);
  const float my = fdiv(sum_of(fmul(w[0], y[0]), fmul(w[1], y[1])), cnt);
  const float mz = fdiv(sum_of(fmul(w[0], z[0]), fmul(w[1], z[1])), cnt);
  float dx[2], dy[2], dz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dx[h] = fsub(x[h], mx);
    dy[h] = fsub(y[h], my);
    dz[h] = fsub(z[h], mz);
  }
  auto moment = [&](const float* da, const float* db) {
    return fdiv(sum_of(fmul(fmul(w[0], da[0]), db[0]), fmul(fmul(w[1], da[1]), db[1])), cnt);
  };
  const float cxx = moment(dx, dx), cxy = moment(dx, dy), cxz = moment(dx, dz);
  const float cyy = moment(dy, dy), cyz = moment(dy, dz), czz = moment(dz, dz);
  if (lane != 0) return;
  const Eigenpair e = smallest_eigenpair_sym3(cxx, cxy, cxz, cyy, cyz, czz);
  const float curv = fdiv(e.eig, clamp_min(fadd(fadd(cxx, cyy), czz), kTiny));
  const float px = P[3 * row], py = P[3 * row + 1], pz = P[3 * row + 2];
  const float facing =
      fadd(fadd(fmul(e.v1, fsub(vx, px)), fmul(e.v2, fsub(vy, py))), fmul(e.v3, fsub(vz, pz)));
  const float sign = (facing < 0.0f) ? -1.0f : 1.0f;
  const bool ok = nvalid >= 3;
  const float okf = ok ? 1.0f : 0.0f;
  const size_t o = b * n + row;
  normals[3 * o] = fmul(fmul(e.v1, sign), okf);
  normals[3 * o + 1] = fmul(fmul(e.v2, sign), okf);
  normals[3 * o + 2] = fmul(fmul(e.v3, sign), okf);
  curvature[o] = ok ? curv : 0.0f;
  valid_out[o] = ok;
}

}  // namespace nrm
}  // namespace quatro

// points (B, N, 3), idx and valid (B, N, K) with K <= 64, the viewpoint ->
// normals (B, N, 3), curvature (B, N), valid (B, N)
extern "C" int quatro_neighbor_normals(const float* pts, const int* idx, const bool* valid,
                                       int bsz, int n, int k, float vx, float vy, float vz,
                                       float* normals, float* curvature, bool* valid_out,
                                       cudaStream_t stream) {
  using namespace quatro::nrm;
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  dim3 grid((n + kWarps - 1) / kWarps, bsz);
  neighbor_normals_kernel<<<grid, kThreads, 0, stream>>>(pts, idx, valid, n, k, p2, vx, vy, vz,
                                                         normals, curvature, valid_out);
  return (int)cudaGetLastError();
}
