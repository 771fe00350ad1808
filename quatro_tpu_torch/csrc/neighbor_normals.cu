// PCA normals over K-capped neighbour lists: the weighted mean and the
// centred moments of each point's K slots, then the smallest eigenpair.
//
// The counterpart of quatro_tpu/ops/normals.py:94-138 (estimate_normals,
// XLA loop fusions; no Pallas kernel there), bit for bit
// quatro_tpu_torch/ops/normals.py::estimate_normals_plain.
//
// points (B, N, 3) f32, idx (B, N, K) int32, valid (B, N, K) bool, the
// viewpoint -> normals (B, N, 3), curvature (B, N) f32, valid (B, N) bool.
// A warp a point, lane l holding slots l and l + 32 (K <= 64; larger K, a
// lane's slots l + 32 j folded by tree.cuh's strided_fold). Each of the
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
#include "tree.cuh"

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

// lane 0's tail of a point o (row `row` of its cloud P): the eigenpair,
// the curvature, the viewpoint flip and the masks
__device__ __forceinline__ void finish(const float* P, size_t o, int row, int nvalid, float cxx,
                                       float cxy, float cxz, float cyy, float cyz, float czz,
                                       float vx, float vy, float vz, float* normals,
                                       float* curvature, bool* valid_out) {
  using namespace eig;
  const Eigenpair e = smallest_eigenpair_sym3(cxx, cxy, cxz, cyy, cyz, czz);
  const float curv = fdiv(e.eig, clamp_min(fadd(fadd(cxx, cyy), czz), kTiny));
  const float px = P[3 * row], py = P[3 * row + 1], pz = P[3 * row + 2];
  const float facing =
      fadd(fadd(fmul(e.v1, fsub(vx, px)), fmul(e.v2, fsub(vy, py))), fmul(e.v3, fsub(vz, pz)));
  const float sign = (facing < 0.0f) ? -1.0f : 1.0f;
  const bool ok = nvalid >= 3;
  const float okf = ok ? 1.0f : 0.0f;
  normals[3 * o] = fmul(fmul(e.v1, sign), okf);
  normals[3 * o + 1] = fmul(fmul(e.v2, sign), okf);
  normals[3 * o + 2] = fmul(fmul(e.v3, sign), okf);
  curvature[o] = ok ? curv : 0.0f;
  valid_out[o] = ok;
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
  finish(P, b * n + row, row, nvalid, cxx, cxy, cxz, cyy, cyz, czz, vx, vy, vz, normals,
         curvature, valid_out);
}

// The wide route (K > 64): lane l holds slots l + 32 j, j < 2^levels (P =
// 2^(levels + 5) slots, +0 past K), each sum its halving tree: the lane's
// slots by tree.cuh's strided_fold (the levels from P / 2 down to 32), then
// shuffles from 16 down to 1, as the two-slot route's tree; the slots'
// values read again for each sum.
__global__ void __launch_bounds__(kThreads)
neighbor_normals_wide_kernel(const float* __restrict__ pts, const int* __restrict__ idx,
                             const bool* __restrict__ valid, int n, int k, int levels, float vx,
                             float vy, float vz, float* __restrict__ normals,
                             float* __restrict__ curvature, bool* __restrict__ valid_out) {
  using namespace eig;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const size_t b = blockIdx.y;
  if (row >= n) return;
  const float* P = pts + b * n * 3;
  const size_t base = (b * n + row) * k;
  int nvalid = 0;
  for (int s = lane; s < k; s += 32) nvalid += valid[base + s];
  nvalid = __reduce_add_sync(kFull, nvalid);
  // pairwise_sum over the slots of f(w, x, y, z), +0 past K
  auto sum_of = [&](auto f) {
    float o[1];
    tree::strided_fold<1>(
        [&](int j, float (&v)[1]) {
          const int s = lane + 32 * j;
          v[0] = 0.0f;
          if (s < k) {
            const int q = idx[base + s];
            v[0] = f(valid[base + s] ? 1.0f : 0.0f, P[3 * q], P[3 * q + 1], P[3 * q + 2]);
          }
        },
        levels, o);
    float v = o[0];
    for (int h = 16; h >= 1; h >>= 1) v = fadd(v, __shfl_down_sync(kFull, v, h));
    return __shfl_sync(kFull, v, 0);
  };
  const float cnt = clamp_min(sum_of([](float w, float, float, float) { return w; }), 1.0f);
  const float mx = fdiv(sum_of([](float w, float x, float, float) { return fmul(w, x); }), cnt);
  const float my = fdiv(sum_of([](float w, float, float y, float) { return fmul(w, y); }), cnt);
  const float mz = fdiv(sum_of([](float w, float, float, float z) { return fmul(w, z); }), cnt);
  auto moment = [&](int a, int c) {
    return fdiv(sum_of([&](float w, float x, float y, float z) {
                  const float d[3] = {fsub(x, mx), fsub(y, my), fsub(z, mz)};
                  return fmul(fmul(w, d[a]), d[c]);
                }),
                cnt);
  };
  const float cxx = moment(0, 0), cxy = moment(0, 1), cxz = moment(0, 2);
  const float cyy = moment(1, 1), cyz = moment(1, 2), czz = moment(2, 2);
  if (lane != 0) return;
  finish(P, b * n + row, row, nvalid, cxx, cxy, cxz, cyy, cyz, czz, vx, vy, vz, normals,
         curvature, valid_out);
}

}  // namespace nrm
}  // namespace quatro

// points (B, N, 3), idx and valid (B, N, K), the viewpoint -> normals (B,
// N, 3), curvature (B, N), valid (B, N); K > 64 takes the wide route
extern "C" int quatro_neighbor_normals(const float* pts, const int* idx, const bool* valid,
                                       int bsz, int n, int k, float vx, float vy, float vz,
                                       float* normals, float* curvature, bool* valid_out,
                                       cudaStream_t stream) {
  using namespace quatro::nrm;
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  dim3 grid((n + kWarps - 1) / kWarps, bsz);
  if (p2 > 64) {
    int levels = 0;
    while ((32 << levels) < p2) ++levels;
    neighbor_normals_wide_kernel<<<grid, kThreads, 0, stream>>>(
        pts, idx, valid, n, k, levels, vx, vy, vz, normals, curvature, valid_out);
  } else {
    neighbor_normals_kernel<<<grid, kThreads, 0, stream>>>(pts, idx, valid, n, k, p2, vx, vy,
                                                           vz, normals, curvature, valid_out);
  }
  return (int)cudaGetLastError();
}
