// ICP's passes: the gated point-to-plane correspondences of every source
// row, and each pair's damped Gauss-Newton update, in two kernels.
//
// The counterpart of quatro_tpu/solver/icp.py:108-117 (correspond) and
// :119-150 (step), which the JAX package compiles into one lax.scan (no
// Pallas kernel there); bit for bit quatro_tpu_torch/ops/icp.py's
// icp_correspond_plain and icp_update_plain. Both read nothing from the
// host (the gate is gates[step] on the device), so the fori device loop's
// CUDA graph captures them.
//
// correspond: src (B, K, 3), smask (B, K), rot (B, 3, 3), trans (B, 3),
//   tgt (B, V, 3), tgt_ok (B, V), normals (B, V, 3), gates (T,), step (1,)
//   int64 -> rows (B, K, 8) [p x n, n, w, r], ok (B, K). A warp a source
//   row, 8 rows a block; the block stages its pair's targets through shared
//   memory, 1024 at a time, as (x, |q|^2) and (y, z) converted to f64 once
//   (fma64's operands; -1 for |q|^2 marks a target that is masked or has
//   no normal): f32 <-> f64 conversions, a quarter of the f32 rate, bound
//   the pass, four a pair. p = R s + t in
//   rotate_points' order; each lane keeps the least key (d2 bits, target)
//   of its targets, d2 as ordered_sq_dists (fused.fma's f64 additions) or
//   the f32 maximum, and a shuffle tree takes the warp's least: torch.argmin's
//   first minimum (target 0 where all are masked). Lane 0 then takes the
//   gate, the residual, the Huber weight and the row.
// update: rows, ok, rot, trans, step, dof (6,) -> rot, trans, step + 1. A
//   block of 1024 threads a pair: the 36 entries of h = sum a^T (a w) and
//   the 6 of g = sum (a w) r over the K rows padded with +0 to a power of
//   two P, summed in fused.pairwise_sum's tree (each of H = min(P / 2,
//   1024) threads folds its P / H leaves t, t + H, ... in registers, up to
//   8 of them (P <= 8192; the wide route's instance 16, P <= 16384), past
//   that by tree.cuh's strided_fold, the same pairing for any K; then
//   halves in shared memory, 42 x H floats), the ok rows counted; then
//   one thread: the DoF mask, the trace by the same tree, the damping,
//   _solve_spd's Gauss-Jordan, the min_correspondences gate, exp_so3 with
//   its series below 1e-4 rad, dr @ R and dr @ t + dt.
//
// Rounding as torch's on the card: the _rn intrinsics (never contracted),
// __fdiv_rn for a tensor quotient, a tensor divided by a Python scalar as
// the product with the f32 reciprocal, torch.sqrt as __fsqrt_rn, sin and
// cos as sinf and cosf, torch.clamp keeping a NaN; Python scalars enter
// rounded to f32.
//
// Bound on the card: correspond, operations (path A: 2048 x 8192 pairs of
// ~10 f32-rated operations, 0.0025 ms a pass; the f64 additions and
// conversions run at a half and a quarter of that rate or less); update, a
// serial chain of one thread a pair after a 42 x 2048 tree (latency).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tree.cuh"

namespace quatro {
namespace icp {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;
constexpr int kRow = 8;              // [p x n, n, w, r]
constexpr int kSums = 42;            // 36 of h, 6 of g
constexpr int kUpdThreads = 1024;
constexpr int kMaxFold = 8;          // leaves a thread: P <= 8192
constexpr int kWideFold = 16;        // the wide route's in registers: P <= 16384
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFltMax = 3.40282346638528859812e+38f;
constexpr uint64_t kEmpty = ~0ull;
constexpr float kSixth = 0x1.555556p-3f;       // 1 / f32(6)
constexpr float kTwentyFourth = 0x1.555556p-5f;  // 1 / f32(24)
constexpr float kSeriesBelow = 1e-4f;
constexpr float kRFloor = 1e-12f;               // the Huber divisor's floor

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// fused.fma(a, b, c): the f32 product exact in f64, one f64 addition, then
// f32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return fma64(z, z, fma64(y, y, fmul(x, x)));
}

__global__ void __launch_bounds__(kThreads)
icp_correspond_kernel(const float* __restrict__ src, const bool* __restrict__ smask,
                      const float* __restrict__ rot, const float* __restrict__ trans,
                      const float* __restrict__ tgt, const bool* __restrict__ tgt_ok,
                      const float* __restrict__ normals, const float* __restrict__ gates,
                      const long long* __restrict__ step, int ks, int v, float huber,
                      float* __restrict__ rows, bool* __restrict__ ok_out) {
  // a staged target: (x, |q|^2 or -1) and (y, z) in f64, converted once a
  // block (fma64's operands)
  __shared__ float2 cols_xw[kChunk];
  __shared__ double2 cols_yz[kChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t b = blockIdx.y;
  const int row = blockIdx.x * kWarps + warp;
  const bool live = row < ks;
  const float* T = tgt + b * v * 3;
  const bool* TM = tgt_ok + b * v;
  const float* R = rot + b * 9;
  const float* t = trans + b * 3;
  // p = rotate_points(s, R) + t: ((s0 R[c][0] + s1 R[c][1]) + s2 R[c][2]) + t[c]
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    const float* s = src + (b * ks + row) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      p[c] = fadd(fadd(fadd(fmul(s[0], R[3 * c]), fmul(s[1], R[3 * c + 1])),
                       fmul(s[2], R[3 * c + 2])),
                  t[c]);
  }
  const float sqp = sq_norm(p[0], p[1], p[2]);
  const double py = p[1], pz = p[2];
  uint64_t best = kEmpty;
  for (int base = 0; base < v; base += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk; i += kThreads) {
      const int j = base + i;
      float2 xw = make_float2(0.0f, -1.0f);
      double2 yz = make_double2(0.0, 0.0);
      if (j < v) {
        const float qx = T[3 * j], qy = T[3 * j + 1], qz = T[3 * j + 2];
        xw.x = qx;
        if (TM[j]) xw.y = sq_norm(qx, qy, qz);
        yz = make_double2(qy, qz);
      }
      cols_xw[i] = xw;
      cols_yz[i] = yz;
    }
    __syncthreads();
    if (!live) continue;
    const int m = min(kChunk, v - base);
    for (int i = lane; i < m; i += 32) {
      const float2 q = cols_xw[i];
      float d2 = kFltMax;
      if (!(q.y < 0.0f)) {
        const double2 yz = cols_yz[i];
        // fma64(pz, qz, fma64(py, qy, px * qx)) with the f64 operands
        // staged
        const float t1 = __double2float_rn(__dadd_rn(__dmul_rn(py, yz.x),
                                                     (double)fmul(p[0], q.x)));
        const float dot = __double2float_rn(__dadd_rn(__dmul_rn(pz, yz.y), (double)t1));
        const float d = fsub(fadd(sqp, q.y), fmul(2.0f, dot));
        d2 = (d != d) ? d : fmaxf(d, 0.0f);
      }
      const uint64_t key = ((uint64_t)__float_as_uint(d2) << 32) | (uint32_t)(base + i);
      best = key < best ? key : best;
    }
  }
  if (!live) return;
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const uint64_t o = __shfl_xor_sync(kFull, best, h);
    best = o < best ? o : best;
  }
  if (lane != 0) return;
  // v >= 1, so best names a target
  const int j = (int)(uint32_t)(best & 0xffffffffu);
  const float d2min = __uint_as_float((uint32_t)(best >> 32));
  const float gate = gates[step[0]];
  const size_t o = b * ks + row;
  const bool ok = smask[o] && (d2min <= fmul(gate, gate));
  const float* nj = normals + (b * v + j) * 3;
  const float n0 = nj[0], n1 = nj[1], n2 = nj[2];
  const float d0 = fsub(p[0], T[3 * j]), d1 = fsub(p[1], T[3 * j + 1]),
              d2 = fsub(p[2], T[3 * j + 2]);
  const float r = fadd(fadd(fmul(n0, d0), fmul(n1, d1)), fmul(n2, d2));
  const float absr = fabsf(r);
  const float floor_r = (absr != absr) ? absr : fmaxf(absr, kRFloor);
  const float hub = (absr <= huber) ? 1.0f : fdiv(huber, floor_r);
  const float w = fmul(ok ? 1.0f : 0.0f, hub);
  float* out = rows + o * kRow;
  out[0] = fsub(fmul(p[1], n2), fmul(p[2], n1));
  out[1] = fsub(fmul(p[2], n0), fmul(p[0], n2));
  out[2] = fsub(fmul(p[0], n1), fmul(p[1], n0));
  out[3] = n0;
  out[4] = n1;
  out[5] = n2;
  out[6] = w;
  out[7] = r;
  ok_out[o] = ok;
}

// leaf q of a row x: a_i (a_j w) for the 36 of h, (a_i w) r for the 6 of g
// (a row of zeros past the K rows gives the pad's +0)
__device__ __forceinline__ float leaf(const float* x, int q) {
  if (q < 36) return fmul(x[q / 6], fmul(x[q % 6], x[6]));
  return fmul(fmul(x[q - 36], x[6]), x[7]);
}

__device__ __forceinline__ void load_row(const float* __restrict__ rw, int ks, int k,
                                         float* x) {
  if (k < ks) {
    const float4* r4 = reinterpret_cast<const float4*>(rw + (size_t)k * kRow);
    const float4 lo = r4[0], hi = r4[1];
    x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
    x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
  } else {
#pragma unroll
    for (int c = 0; c < kRow; ++c) x[c] = 0.0f;
  }
}

// F: the leaves a thread folds in registers (kMaxFold; the wide route
// kWideFold, K <= 16384); a larger fold goes through tree::strided_fold
// (the same halving pairing, any fold)
template <int F>
__global__ void __launch_bounds__(kUpdThreads)
icp_update_kernel(const float* __restrict__ rows, const bool* __restrict__ ok, const float* rot,
                  const float* trans, const long long* step, const float* __restrict__ dof,
                  int ks, int p2, int hw, float damping, int min_corr,
                  float* __restrict__ rot_out, float* __restrict__ trans_out,
                  long long* __restrict__ step_out) {
  extern __shared__ float sums[];  // kSums x hw
  __shared__ int count;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* rw = rows + b * ks * kRow;
  if (tid == 0) count = 0;
  __syncthreads();
  int c = 0;
  for (int i = tid; i < ks; i += kUpdThreads) c += ok[b * ks + i];
  c = __reduce_add_sync(kFull, c);
  if ((tid & 31) == 0 && c) atomicAdd(&count, c);
  // the tree down to hw entries: each thread folds its leaves t, t + hw,
  // ... (fold of them) in registers
  const int fold = p2 / hw;
  if (tid < hw && fold <= 2) {
    // the rows held in registers (P <= 2048: the main path's)
    float xa[kRow], xb[kRow];
    load_row(rw, ks, tid, xa);
    load_row(rw, ks, fold == 2 ? tid + hw : ks, xb);
#pragma unroll
    for (int q = 0; q < kSums; ++q) {
      const float y = leaf(xa, q);
      sums[q * hw + tid] = (fold == 2) ? fadd(y, leaf(xb, q)) : y;
    }
  } else if (tid < hw && fold <= F) {
    for (int q = 0; q < kSums; ++q) {
      float y[F];
#pragma unroll
      for (int m = 0; m < F; ++m) {
        float x[kRow];
        load_row(rw, ks, m < fold ? tid + hw * m : ks, x);
        y[m] = leaf(x, q);
      }
#pragma unroll
      for (int len = F; len >= 2; len >>= 1) {
        if (len > fold) continue;
#pragma unroll
        for (int i = 0; i < F / 2; ++i)
          if (i < len / 2) y[i] = fadd(y[i], y[i + len / 2]);
      }
      sums[q * hw + tid] = y[0];
    }
  } else if (tid < hw) {
    if constexpr (F > kMaxFold) {
      int levels = 0;
      while ((1 << levels) < fold) ++levels;
      for (int q = 0; q < kSums; ++q) {
        float y[1];
        tree::strided_fold<1>(
            [&](int m, float (&v)[1]) {
              float x[kRow];
              load_row(rw, ks, tid + hw * m, x);
              v[0] = leaf(x, q);
            },
            levels, y);
        sums[q * hw + tid] = y[0];
      }
    }
  }
  // then halves in shared memory: entry (q, i) of level 2^lg adds i + 2^lg
  int lg = 0;
  while ((2 << lg) <= hw) ++lg;
  for (--lg; lg >= 0; --lg) {
    __syncthreads();
    const int h = 1 << lg;
    for (int e = tid; e < (kSums << lg); e += kUpdThreads) {
      const int q = e >> lg, i = e & (h - 1);
      sums[q * hw + i] = fadd(sums[q * hw + i], sums[q * hw + i + h]);
    }
  }
  __syncthreads();
  if (tid != 0) return;

  float m[6][7];
  float d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) d[i] = dof[i];
  // h * (dof dof^T) + diag(1 - dof); g * dof
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j)
      m[i][j] = fadd(fmul(sums[(6 * i + j) * hw], fmul(d[i], d[j])),
                     (i == j) ? fsub(1.0f, d[i]) : 0.0f);
    m[i][6] = fmul(sums[(36 + i) * hw], d[i]);
  }
  // lambda = damping * (pairwise_sum(diag h) + 1): the 6 padded to 8
  const float tr = fadd(fadd(fadd(m[0][0], m[4][4]), fadd(m[2][2], 0.0f)),
                        fadd(fadd(m[1][1], m[5][5]), fadd(m[3][3], 0.0f)));
  const float lam = fmul(damping, fadd(tr, 1.0f));
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) m[i][j] = fadd(m[i][j], fmul(lam, (i == j) ? 1.0f : 0.0f));
  // _solve_spd: Gauss-Jordan without pivoting, every row from the last
  // step's values
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float piv[7];
#pragma unroll
    for (int cc = 0; cc < 7; ++cc) piv[cc] = fdiv(m[j][cc], m[j][j]);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i == j) continue;
      const float mij = m[i][j];
#pragma unroll
      for (int cc = 0; cc < 7; ++cc) m[i][cc] = fsub(m[i][cc], fmul(mij, piv[cc]));
    }
#pragma unroll
    for (int cc = 0; cc < 7; ++cc) m[j][cc] = piv[cc];
  }
  const bool enough = count >= min_corr;
  float delta[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = enough ? -m[i][6] : 0.0f;
  // exp_so3(delta[:3])
  const float w0 = delta[0], w1 = delta[1], w2 = delta[2];
  const float theta_sq = fadd(fadd(fmul(w0, w0), fmul(w1, w1)), fmul(w2, w2));
  const float theta = __fsqrt_rn(theta_sq);
  const bool small = theta < kSeriesBelow;
  const float k[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  const float a = small ? fsub(1.0f, fmul(theta_sq, kSixth)) : fdiv(sinf(theta), theta);
  const float bb = small ? fsub(0.5f, fmul(theta_sq, kTwentyFourth))
                         : fdiv(fsub(1.0f, cosf(theta)), theta_sq);
  float dr[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      const float kk = fadd(fadd(fmul(k[i][0], k[0][cc]), fmul(k[i][1], k[1][cc])),
                            fmul(k[i][2], k[2][cc]));
      dr[i][cc] = fadd(fadd((i == cc) ? 1.0f : 0.0f, fmul(a, k[i][cc])), fmul(bb, kk));
    }
  const float* R = rot + b * 9;
  const float* t = trans + b * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int cc = 0; cc < 3; ++cc)
      rot_out[b * 9 + 3 * i + cc] =
          fadd(fadd(fmul(dr[i][0], R[cc]), fmul(dr[i][1], R[3 + cc])), fmul(dr[i][2], R[6 + cc]));
    trans_out[b * 3 + i] =
        fadd(fadd(fadd(fmul(t[0], dr[i][0]), fmul(t[1], dr[i][1])), fmul(t[2], dr[i][2])),
             delta[3 + i]);
  }
  if (b == 0) step_out[0] = step[0] + 1;
}

}  // namespace icp
}  // namespace quatro

// src (B, K, 3), smask (B, K), rot (B, 3, 3), trans (B, 3), tgt (B, V, 3),
// tgt_ok (B, V), normals (B, V, 3), gates (T,), step (1,) int64 -> rows
// (B, K, 8), ok (B, K); V >= 1
extern "C" int quatro_icp_correspond(const float* src, const bool* smask, const float* rot,
                                     const float* trans, const float* tgt, const bool* tgt_ok,
                                     const float* normals, const float* gates,
                                     const long long* step, int bsz, int ks, int v,
                                     float huber, float* rows, bool* ok,
                                     cudaStream_t stream) {
  using namespace quatro::icp;
  dim3 grid((ks + kWarps - 1) / kWarps, bsz);
  icp_correspond_kernel<<<grid, kThreads, 0, stream>>>(src, smask, rot, trans, tgt, tgt_ok,
                                                       normals, gates, step, ks, v, huber, rows,
                                                       ok);
  return (int)cudaGetLastError();
}

// rows (B, K, 8), ok (B, K), rot, trans, step (1,) int64, dof (6,) ->
// rot, trans, step + 1; K >= 1 (past 8192 rows the wide route)
extern "C" int quatro_icp_update(const float* rows, const bool* ok, const float* rot,
                                 const float* trans, const long long* step, const float* dof,
                                 int bsz, int ks, float damping, int min_corr, float* rot_out,
                                 float* trans_out, long long* step_out, cudaStream_t stream) {
  using namespace quatro::icp;
  int p2 = 1;
  while (p2 < ks) p2 <<= 1;
  const int hw = p2 >= 2 ? (p2 / 2 < kUpdThreads ? p2 / 2 : kUpdThreads) : 1;
  const size_t smem = sizeof(float) * kSums * hw;
  static bool attr = false;
  if (!attr) {
    const int bytes = (int)(sizeof(float) * kSums * kUpdThreads);
    int rc = (int)cudaFuncSetAttribute(icp_update_kernel<kMaxFold>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc == 0)
      rc = (int)cudaFuncSetAttribute(icp_update_kernel<kWideFold>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc) return rc;
    attr = true;
  }
  // more than kMaxFold leaves a thread (K > 8192 rows): the wide route
  auto kernel =
      p2 / hw > kMaxFold ? icp_update_kernel<kWideFold> : icp_update_kernel<kMaxFold>;
  kernel<<<bsz, kUpdThreads, smem, stream>>>(rows, ok, rot, trans, step, dof, ks, p2, hw,
                                             damping, min_corr, rot_out, trans_out, step_out);
  return (int)cudaGetLastError();
}
