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
//   int64 -> rows (B, K, 8) [p x n, n, w, r], ok (B, K). p = R s + t in
//   rotate_points' order; the chosen target is the least key (d2 bits,
//   target) over the targets, d2 as ordered_sq_dists (fused.fma's f64
//   additions) or the f32 maximum for a masked target, a NaN d2 first:
//   torch.argmin's first minimum, NaN included (target 0 where all are
//   masked). Then the gate, the residual, the Huber weight and the row.
//   The layout:
//   - a CTA of kCorrThreads threads takes a tile of kCorrTile source rows,
//     kCorrRows a thread in registers, and one of `splits` slices of the
//     targets (128 to 1024 targets, about four CTAs an SM); it stages its
//     slice's valid targets once, compacted in index order, as float4 (x,
//     y, z, index) in shared memory, each used by the tile's 512 rows;
//   - pass 1, the screen, in f32 only: a = |p - q|^2 from the coordinates'
//     differences, and per row the least a (a1, its target j1, the first
//     on a tie) and the second least a2;
//   - the exact key of j1 alone (four f32 <-> f64 conversions, the
//     distance's bits as the plain version's), d1 its d2. Error bound:
//     with u = 2^-24, S = |p|^2 + |q|^2, D = |p - q|^2 and no overflow
//     (|p|^2, |q|^2 <= 2^120), a <= D (1 + 5.01 u) (six roundings of
//     non-negative terms) and the exact path's d >= (D - 7.11 u S)(1 - u)
//     (|sq_norm - |x|^2| <= 3.01 u |x|^2, |dot - p.q| <= 3.01 u |p||q|,
//     one rounding of the norms' sum and one of the difference), so a
//     target of a > thr = (d1 + 2^-20 (|p|^2 + max |q|^2)) (1 + 2^-20) +
//     2^-100 (the norms in f32; the last term covers subnormal results)
//     has an exact d2 strictly above d1 and cannot tie or win. Where a2 >
//     thr, j1's key is the slice's; else (a near tie) the row scans the
//     staged slice again and takes the exact key of every target with a <=
//     thr. A row or slice with a norm past 2^120, an inf or a NaN takes
//     every exact key of its slice;
//   - a masked target's key is (f32 max, index), so a slice's masked
//     targets enter as the key of its first one;
//   - the slices' keys merge by a 64-bit integer atomicMax of the key's
//     complement into a zeroed buffer (the same least key in any order; no
//     float atomics); the tile's last CTA (a ticket) reads the keys, writes
//     the rows and sets keys and ticket back to 0 for the next launch.
//   The buffer and tickets are the wrapper's, zero between launches; no
//   host read, so the kernel stays capturable.
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
// ~10 f32-rated operations, 0.0025 ms a pass); the screen takes ~11 f32
// instructions a pair and leaves the f64 path one target a row and slice.
// update, a serial chain of one thread a pair after a 42 x 2048 tree
// (latency).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tree.cuh"

namespace quatro {
namespace icp {

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

constexpr int kCorrThreads = 128;
constexpr int kCorrRows = 4;                          // rows a thread
constexpr int kCorrTile = kCorrThreads * kCorrRows;   // rows a CTA
constexpr int kCorrChunk = 1024;                      // most targets a slice
constexpr int kCorrPer = kCorrChunk / kCorrThreads;   // a thread's targets a chunk
constexpr float kSafeNorm = 0x1p120f;                 // the screen's norm limit
constexpr float kSlack = 0x1p-20f;                    // 16 u

// The least-first key of a valid staged target q = (x, y, z, index bits)
// for the point p: (d2 bits + 1, index), a NaN d2 as 0 (first); d2 in
// ordered_sq_dists' arithmetic. A masked target's key is (f32 max bits +
// 1, index).
__device__ __forceinline__ uint64_t exact_key(float px, float py, float pz, float sqp, float4 q) {
  const float sqq = sq_norm(q.x, q.y, q.z);
  // fma64(pz, qz, fma64(py, qy, px * qx))
  const float t1 = __double2float_rn(__dadd_rn(__dmul_rn((double)py, (double)q.y),
                                               (double)fmul(px, q.x)));
  const float dot = __double2float_rn(__dadd_rn(__dmul_rn((double)pz, (double)q.z), (double)t1));
  const float d = fsub(fadd(sqp, sqq), fmul(2.0f, dot));
  const uint32_t hi = (d != d) ? 0u : __float_as_uint(fmaxf(d, 0.0f)) + 1u;
  return ((uint64_t)hi << 32) | (uint32_t)__float_as_int(q.w);
}

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) { return a < b ? a : b; }

// the screen's distance: |p - q|^2 from the differences, in f32
__device__ __forceinline__ float screen_d2(float px, float py, float pz, float qx, float qy,
                                           float qz) {
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
}

// grid (splits, tiles, B): slice x of the targets for tile y of pair z's
// source rows. keys (B, K) u64 and tickets (B, tiles) int32: zero at entry,
// zero again at exit.
__global__ void __launch_bounds__(kCorrThreads)
icp_correspond_kernel(const float* __restrict__ src, const bool* __restrict__ smask,
                      const float* __restrict__ rot, const float* __restrict__ trans,
                      const float* __restrict__ tgt, const bool* __restrict__ tgt_ok,
                      const float* __restrict__ normals, const float* __restrict__ gates,
                      const long long* __restrict__ step, int ks, int v, int per_split,
                      float huber, float* __restrict__ rows, bool* __restrict__ ok_out,
                      unsigned long long* keys, int* tickets) {
  __shared__ float4 stage[kCorrChunk];
  __shared__ int warp_cnt[kCorrThreads / 32];
  __shared__ float warp_max[kCorrThreads / 32];
  __shared__ int warp_flags[kCorrThreads / 32][2];
  __shared__ int last_cta;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.z;
  const int tile = blockIdx.y;
  const int t0 = blockIdx.x * per_split, t1 = min(v, t0 + per_split);
  const float* T = tgt + b * v * 3;
  const bool* TM = tgt_ok + b * v;
  const float* R = rot + b * 9;
  const float* t = trans + b * 3;
  // the thread's rows: p = rotate_points(s, R) + t, ((s0 R[c][0] + s1
  // R[c][1]) + s2 R[c][2]) + t[c]
  float px[kCorrRows], py[kCorrRows], pz[kCorrRows], sqp[kCorrRows];
  float a1[kCorrRows], a2[kCorrRows];
  int j1[kCorrRows];
#pragma unroll
  for (int r = 0; r < kCorrRows; ++r) {
    const int row = tile * kCorrTile + r * kCorrThreads + tid;
    float p[3] = {0.0f, 0.0f, 0.0f};
    if (row < ks) {
      const float* s = src + (b * ks + row) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        p[c] = fadd(fadd(fadd(fmul(s[0], R[3 * c]), fmul(s[1], R[3 * c + 1])),
                         fmul(s[2], R[3 * c + 2])),
                    t[c]);
    }
    px[r] = p[0];
    py[r] = p[1];
    pz[r] = p[2];
    sqp[r] = sq_norm(p[0], p[1], p[2]);
    a1[r] = a2[r] = INFINITY;
    j1[r] = -1;
  }
  // the slice's valid targets (at most kCorrChunk: the launcher's rule),
  // kCorrPer consecutive ones a thread, compacted in index order; all
  // loads issued before any is used
  const int j0 = t0 + tid * kCorrPer;
  float qx[kCorrPer], qy[kCorrPer], qz[kCorrPer];
  bool qok[kCorrPer];
#pragma unroll
  for (int k = 0; k < kCorrPer; ++k) {
    const int j = j0 + k;
    qok[k] = j < t1 && TM[j];
    qx[k] = j < t1 ? T[3 * j] : 0.0f;
    qy[k] = j < t1 ? T[3 * j + 1] : 0.0f;
    qz[k] = j < t1 ? T[3 * j + 2] : 0.0f;
  }
  int cnt = 0, bad = 0, fm = v;
  float mx = 0.0f;
#pragma unroll
  for (int k = 0; k < kCorrPer; ++k) {
    if (qok[k]) {
      ++cnt;
      const float nq = qx[k] * qx[k] + qy[k] * qy[k] + qz[k] * qz[k];
      bad |= !(nq <= kSafeNorm);
      mx = fmaxf(mx, nq);
    } else if (j0 + k < t1) {
      fm = min(fm, j0 + k);
    }
  }
  // exclusive scan of the counts over the block; the slice's largest
  // norm, whether any target is past the screen's limit (an inf or a NaN
  // too), its first masked target
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    bad |= __shfl_xor_sync(kFull, bad, o);
    fm = min(fm, __shfl_xor_sync(kFull, fm, o));
  }
  if (lane == 31) warp_cnt[warp] = incl;
  if (lane == 0) {
    warp_max[warp] = mx;
    warp_flags[warp][0] = bad;
    warp_flags[warp][1] = fm;
  }
  __syncthreads();
  int pos = incl - cnt, m = 0, unsafe = 0, first_masked = v;
  float qmax = 0.0f;
#pragma unroll
  for (int k = 0; k < kCorrThreads / 32; ++k) {
    if (k < warp) pos += warp_cnt[k];
    m += warp_cnt[k];
    qmax = fmaxf(qmax, warp_max[k]);
    unsafe |= warp_flags[k][0];
    first_masked = min(first_masked, warp_flags[k][1]);
  }
#pragma unroll
  for (int k = 0; k < kCorrPer; ++k)
    if (qok[k]) stage[pos++] = make_float4(qx[k], qy[k], qz[k], __int_as_float(j0 + k));
  __syncthreads();
  // pass 1, the screen: per row the least a (a1 at stage position i1, the
  // first on a tie) and the second least a2
#pragma unroll 4
  for (int i = 0; i < m; ++i) {
    const float4 q = stage[i];
#pragma unroll
    for (int r = 0; r < kCorrRows; ++r) {
      const float a = screen_d2(px[r], py[r], pz[r], q.x, q.y, q.z);
      const bool lt = a < a1[r];
      a2[r] = fminf(a2[r], fmaxf(a, a1[r]));
      j1[r] = lt ? i : j1[r];
      a1[r] = lt ? a : a1[r];
    }
  }
  // each row's key over the slice, merged into the pair's keys
  unsigned long long* K = keys + b * ks;
#pragma unroll
  for (int r = 0; r < kCorrRows; ++r) {
    const int row = tile * kCorrTile + r * kCorrThreads + tid;
    if (row >= ks) continue;
    uint64_t key = first_masked < t1 ? (((uint64_t)__float_as_uint(kFltMax) + 1u) << 32 |
                                        (uint32_t)first_masked)
                                     : kEmpty;
    const bool safe = !unsafe && sqp[r] <= kSafeNorm;
    if (!safe) {
      for (int i = 0; i < m; ++i)
        key = umin64(key, exact_key(px[r], py[r], pz[r], sqp[r], stage[i]));
    } else if (j1[r] >= 0) {
      const uint64_t k1 = exact_key(px[r], py[r], pz[r], sqp[r], stage[j1[r]]);
      const float d1 = __uint_as_float((uint32_t)(k1 >> 32) - 1u);
      const float thr = fadd(fmul(fadd(d1, fmul(kSlack, fadd(sqp[r], qmax))), 1.0f + kSlack),
                             0x1p-100f);
      if (a2[r] > thr) {
        key = umin64(key, k1);
      } else {              // a near tie: every target the screen cannot rule out
        for (int i = 0; i < m; ++i) {
          const float4 q = stage[i];
          if (screen_d2(px[r], py[r], pz[r], q.x, q.y, q.z) <= thr)
            key = umin64(key, exact_key(px[r], py[r], pz[r], sqp[r], q));
        }
      }
    }
    if (key != kEmpty) atomicMax(K + row, ~key);
  }
  // the tile's last CTA writes its rows
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = tickets + b * gridDim.y + tile;
    last_cta = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
    if (last_cta) *ticket = 0;
  }
  __syncthreads();
  if (!last_cta) return;
  __threadfence();
  const float gate = gates[step[0]];
  const float gate2 = fmul(gate, gate);
#pragma unroll
  for (int r = 0; r < kCorrRows; ++r) {
    const int row = tile * kCorrTile + r * kCorrThreads + tid;
    if (row >= ks) continue;
    const uint64_t best = ~__ldcg(K + row);
    K[row] = 0ull;
    // v >= 1, so best names a target
    const int j = (int)(uint32_t)(best & 0xffffffffu);
    const uint32_t hi = (uint32_t)(best >> 32);
    const float d2min = hi == 0u ? __uint_as_float(0x7fffffffu) : __uint_as_float(hi - 1u);
    const size_t o = b * ks + row;
    const bool ok = smask[o] && (d2min <= gate2);
    const float* nj = normals + (b * v + j) * 3;
    const float n0 = nj[0], n1 = nj[1], n2 = nj[2];
    const float p0 = px[r], p1 = py[r], p2 = pz[r];
    const float d0 = fsub(p0, T[3 * j]), dd1 = fsub(p1, T[3 * j + 1]),
                dd2 = fsub(p2, T[3 * j + 2]);
    const float res = fadd(fadd(fmul(n0, d0), fmul(n1, dd1)), fmul(n2, dd2));
    const float absr = fabsf(res);
    const float floor_r = (absr != absr) ? absr : fmaxf(absr, kRFloor);
    const float hub = (absr <= huber) ? 1.0f : fdiv(huber, floor_r);
    const float w = fmul(ok ? 1.0f : 0.0f, hub);
    float* out = rows + o * kRow;
    out[0] = fsub(fmul(p1, n2), fmul(p2, n1));
    out[1] = fsub(fmul(p2, n0), fmul(p0, n2));
    out[2] = fsub(fmul(p0, n1), fmul(p1, n0));
    out[3] = n0;
    out[4] = n1;
    out[5] = n2;
    out[6] = w;
    out[7] = res;
    ok_out[o] = ok;
  }
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
// (B, K, 8), ok (B, K); V >= 1. scratch: B K int64 keys, then B
// ceil(K / kCorrTile) int32 tickets, all zero (and zero again after).
extern "C" int quatro_icp_correspond(const float* src, const bool* smask, const float* rot,
                                     const float* trans, const float* tgt, const bool* tgt_ok,
                                     const float* normals, const float* gates,
                                     const long long* step, int bsz, int ks, int v,
                                     float huber, float* rows, bool* ok, int* scratch,
                                     cudaStream_t stream) {
  using namespace quatro::icp;
  if (bsz <= 0 || ks <= 0 || v <= 0 || bsz > 65535) return (int)cudaErrorInvalidValue;
  static int sms[64] = {0};
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  if (dev < 64 && sms[dev] == 0) {
    rc = (int)cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (rc) return rc;
  }
  const int sm = dev < 64 ? sms[dev] : 132;
  const int tiles = (ks + kCorrTile - 1) / kCorrTile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  // about four CTAs an SM, no slice under 128 targets or over kCorrChunk
  const long long want = (4LL * sm + (long long)bsz * tiles - 1) / ((long long)bsz * tiles);
  const long long most = (v + 127) / 128;
  const long long least = (v + kCorrChunk - 1) / kCorrChunk;  // a slice fits the stage
  long long splits = want < most ? want : most;
  if (splits < least) splits = least;
  const int per = (int)((v + splits - 1) / splits);
  splits = (v + per - 1) / per;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(scratch);
  int* tickets = scratch + 2LL * bsz * ks;
  const dim3 grid((unsigned)splits, (unsigned)tiles, (unsigned)bsz);
  icp_correspond_kernel<<<grid, kCorrThreads, 0, stream>>>(src, smask, rot, trans, tgt, tgt_ok,
                                                           normals, gates, step, ks, v, per,
                                                           huber, rows, ok, keys, tickets);
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
