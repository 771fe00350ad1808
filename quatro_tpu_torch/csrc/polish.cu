// The polish of every hypothesis row: the chain TIMs, the yaw GNC and COTE,
// three kernels with no device loop and no host read.
//
// The counterpart of quatro_tpu/solver/quatro.py::_solve_from_inliers (one
// jax.jit, vmapped over the hypotheses: the chain order :56-70 and TIMs
// :110-127, the GNC's lax.while_loop quatro_tpu/solver/rotation.py:79-189,
// COTE's lax.sort and cumsums quatro_tpu/solver/translation.py:31-148,
// the composition and gating quatro.py:146-194; no Pallas kernel there),
// bit for bit quatro_tpu_torch/ops/polish.py's polish_chain_plain,
// gnc_yaw_plain and polish_cote_plain / cote_translation_plain on the card.
//
// chain: src, tgt (B, N, 3), the selection (B, H, N) bool, scale (B, H),
//   the prior (3, 3) or (B, 3, 3) -> the chain order (the chosen indices
//   ascending, then the rest ascending), the cyclic successor leaf, the
//   chain mask, its length m, and the TIMs (a - b) * chain, the target's
//   / scale, the source's levelled by the prior where one is given.
// gnc_yaw: the TIMs' xy (any row and point strides), the chain mask and the
//   noise bound a row -> the GNC's rotation (2 x 2), weights, inliers
//   (weights >= 0.4), iterations and cost; GNC-TLS or FGR's graduated
//   Geman-McClure, iteration 0 (mu's start, the noise-free stop) and then
//   each row to its own exit or max_iterations.
// cote: the rotation composed with the prior, the rotation inliers chained
//   and counted, the selection compacted (sel_idx), COTE's source scale *
//   R src[sel_idx]; per axis the 2N interval events sorted stably (masked
//   events at FLT_MAX, last in index order), the series eps, eps x,
//   eps x x prefix-summed in XLA:CPU's blocked order (scan.cuh), the cost
//   at every centre and its first minimum (torch.argmin: NaN counts as the
//   least), the median (the last card events' values sorted) or the
//   weighted mean; then the three axes' inliers ANDed, scattered back
//   through sel_idx, and the valid gating. Also on given points (the bare
//   COTE of solver/translation.solve_translation).
//
// Every operation rounds once, as the torch operation it stands for does on
// the card: products, sums, quotients and square roots by the _rn
// intrinsics (no contraction), atan2f / cosf / sinf as torch calls them; a
// pairwise_sum is its tree (the length padded with zeros to a power of two,
// x[i] + x[i + half] level by level), a sum over two coordinates (0 + a) +
// b as torch's reduction adds it, torch.sort(stable=True) of floats its
// order on the card (ordered_bits; ties by index).
//
// Bound on the card: none that bytes or operations set. Each row is a
// chain: the GNC's rounds (up to max_iterations, each two trees of
// log2(N) levels and the angle), COTE's bitonic sorts (66 stages at N =
// 1024) and blocked prefix; path A has 6 rows, B = 64 has 384.
// Design:
// - chain: a block of 256 threads a row; the order by one block count and
//   one block scan (a compaction, no sort), then a thread a position.
// - gnc_yaw: a block a row (256 threads up to N = 1024, 1024 above), each
//   thread holding the points i = t + k * threads in registers; a round
//   is the residuals, one tree of three sums (the cost at the old weights
//   and the next round's Procrustes dot and cross at the new weights,
//   which do not depend on the cost) and the scalar update, computed by
//   every thread from the broadcast sums. The tree's first levels add a
//   thread's own points, the next ones go through shared memory, the last
//   five through warp shuffles.
// - cote: a block of 1024 threads a (row, axis); 64-bit (bits, index) keys
//   sorted bitonically in shared memory, a thread a block of 16 events for
//   the prefix and the costs, a block argmin; the row's last block (an
//   integer ticket after a fence) ANDs the axes and scatters the mask.
// - rows of more than kMaxPoints points (the JAX package takes any width):
//   the chain and COTE keep the same code with their buffers in a global
//   workspace of the wrapper's (the chain's order, n ints a row; COTE's
//   events, values, levels and selection, cote_bytes a (row, axis)), so the
//   same sort and scans give the same bits; the GNC runs
//   gnc_yaw_wide_kernel, 1024 threads a row folding 2^L points each
//   through tree.cuh's strided_fold (the register kernel's tree, any L),
//   the weights in global memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan.cuh"
#include "sort.cuh"
#include "tree.cuh"

namespace quatro {
namespace pol {

constexpr int kMaxPoints = 4096;
constexpr int kChainThreads = 256;
constexpr int kCoteThreads = 1024;
constexpr int kWideThreads = 1024;     // the GNC past kMaxPoints
constexpr float kFltMax = 3.40282346638528859812e+38f;

using sort::bitonic_sort;
using sort::kBitonicSortMax;
using sort::ordered_bits;
using tree::tree_sum;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// Row j of p @ R^T (utils/se3.rotate_points): p0 R[j][0] + p1 R[j][1] +
// p2 R[j][2], left to right.
__device__ __forceinline__ float rot_row(const float* rj, float p0, float p1, float p2) {
  return add(add(mul(p0, rj[0]), mul(p1, rj[1])), mul(p2, rj[2]));
}

// ------------------------------------------------------------------ chain

struct ChainParams {
  int hyps;          // rows a pair
  int n;
  int prior_stride;  // 9: a prior a pair; 0: one for all
  int has_prior;
};

// G: the order staged in `work` (n ints a row, global memory) past
// kMaxPoints points a row; else in shared memory
template <bool G>
__global__ void __launch_bounds__(kChainThreads)
polish_chain_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                    const bool* __restrict__ clique_mask, const float* __restrict__ scale,
                    const float* __restrict__ prior, ChainParams p,
                    long long* __restrict__ order, long long* __restrict__ leaf,
                    bool* __restrict__ chain_mask, long long* __restrict__ m_out,
                    float* __restrict__ src_tims, float* __restrict__ dst_tims,
                    int* __restrict__ work) {
  __shared__ int ord_s[G ? 1 : kMaxPoints];
  __shared__ int warp_sums[32];
  const size_t r = blockIdx.x;
  int* ord = G ? work + r * p.n : ord_s;
  const int n = p.n, tid = threadIdx.x;
  const size_t pair = r / p.hyps;
  const bool* mask = clique_mask + r * n;

  int m = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + tid;
    m += __syncthreads_count(i < n && mask[i]);
  }
  // the stable order of where(mask, i, n + i): chosen, then the rest
  int chosen = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + tid;
    const bool in = i < n && mask[i];
    int total;
    const int before = chosen + scan::block_exclusive_scan(in ? 1 : 0, warp_sums, &total);
    if (i < n) ord[in ? before : m + (i - before)] = i;
    chosen += total;
  }
  __syncthreads();

  const float sc = scale[r];
  const float* pr = prior + pair * p.prior_stride;
  const float* s = src + pair * n * 3;
  const float* t = tgt + pair * n * 3;
  for (int i = tid; i < n; i += blockDim.x) {
    const int o = ord[i];
    const int l = ord[i + 1 < m ? i + 1 : 0];
    const bool in = i < m;
    const float cf = in ? 1.0f : 0.0f;
    const size_t at = r * n + i;
    order[at] = o;
    leaf[at] = l;
    chain_mask[at] = in;
    float a[3], b[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      a[d] = mul(sub(s[3 * l + d], s[3 * o + d]), cf);
      b[d] = dvd(mul(sub(t[3 * l + d], t[3 * o + d]), cf), sc);
    }
    if (p.has_prior) {
      const float a0 = a[0], a1 = a[1], a2 = a[2];
#pragma unroll
      for (int j = 0; j < 3; ++j) a[j] = rot_row(pr + 3 * j, a0, a1, a2);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      src_tims[3 * at + d] = a[d];
      dst_tims[3 * at + d] = b[d];
    }
  }
  if (tid == 0) m_out[r] = m;
}

// -------------------------------------------------------------------- GNC

struct GncParams {
  int n;
  int half;           // half the tree's length (N padded to a power of two)
  int src_rs, src_ps, dst_rs, dst_ps;  // row and point strides, in floats
  float nb;           // the noise bound where no per-row one is given
  int algo;           // 0 GNC-TLS, 1 FGR
  float factor;       // mu's factor: gnc_factor (TLS), its f32 reciprocal (FGR)
  int max_iter;
  float threshold;
};

// torch.amax's maximum (NaN propagates) of the points' values; every
// thread gets it.
template <int T, int NPT>
__device__ __forceinline__ float block_amax(const float (&v)[NPT], int n, float* sm) {
  const int t = threadIdx.x;
  float x = -INFINITY;
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const float y = v[k];
    if (t + k * T < n && (isnan(y) || y > x)) x = y;
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const float y = __shfl_down_sync(0xffffffffu, x, o);
    if (isnan(y) || y > x) x = y;
  }
  __syncthreads();
  if ((t & 31) == 0) sm[t >> 5] = x;
  __syncthreads();
  if (t < 32) {
    x = t < T / 32 ? sm[t] : -INFINITY;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      const float y = __shfl_down_sync(0xffffffffu, x, o);
      if (isnan(y) || y > x) x = y;
    }
    if (t == 0) sm[32] = x;
  }
  __syncthreads();
  return sm[32];
}

template <int T, int NPT>
__global__ void __launch_bounds__(T)
gnc_yaw_kernel(const float* __restrict__ src, const float* __restrict__ dst,
               const bool* __restrict__ mask, const float* __restrict__ nb_rows, GncParams p,
               float* __restrict__ rotation, float* __restrict__ weights,
               bool* __restrict__ inliers, int* __restrict__ iters_out,
               float* __restrict__ cost_out) {
  __shared__ float sm[3 * T];
  __shared__ float red[3];
  const int tid = threadIdx.x;
  const size_t r = blockIdx.x;
  const int n = p.n;
  const bool fgr = p.algo == 1;

  float sx[NPT], sy[NPT], dx[NPT], dy[NPT], mf[NPT], w[NPT], sdot[NPT], scr[NPT];
  bool mk[NPT];
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int i = tid + k * T;
    const bool in = i < n;
    sx[k] = in ? src[r * p.src_rs + (size_t)i * p.src_ps] : 0.0f;
    sy[k] = in ? src[r * p.src_rs + (size_t)i * p.src_ps + 1] : 0.0f;
    dx[k] = in ? dst[r * p.dst_rs + (size_t)i * p.dst_ps] : 0.0f;
    dy[k] = in ? dst[r * p.dst_rs + (size_t)i * p.dst_ps + 1] : 0.0f;
    mk[k] = in && mask[r * n + i];
    mf[k] = mk[k] ? 1.0f : 0.0f;
    w[k] = mf[k];
    // yaw_procrustes' (src * dst).sum(-1) and its cross term
    sdot[k] = add(add(0.0f, mul(sx[k], dx[k])), mul(sy[k], dy[k]));
    scr[k] = sub(mul(sx[k], dy[k]), mul(sy[k], dx[k]));
  }
  const float nb = nb_rows != nullptr ? nb_rows[r] : p.nb;
  const float nb2 = mul(nb, nb);
  // TLS: where(nb^2 < 1e-16, 1e-2, nb^2); FGR: clamp(nb^2, min=1e-16)
  const float nb_sq = fgr ? clamp_min(nb2, 1e-16f) : (nb2 < 1e-16f ? 1e-2f : nb2);

  // the Procrustes angle at weights we: atan2 of the weighted cross and dot
  auto solve = [&](const float (&we)[NPT]) {
    float v[2][NPT];
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const bool in = tid + k * T < n;
      v[0][k] = in ? mul(we[k], sdot[k]) : 0.0f;
      v[1][k] = in ? mul(we[k], scr[k]) : 0.0f;
    }
    tree_sum<T, NPT, 2>(v, p.half, sm, red);
    return atan2f(red[1], red[0]);
  };
  // rotate_points(src, rot2d(theta)) subtracted from dst, squared, summed
  // over the two coordinates, masked
  float res[NPT];
  auto residuals = [&](float theta) {
    const float c = cosf(theta), s = sinf(theta), ns = -s;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const float d0 = sub(dx[k], add(mul(sx[k], c), mul(sy[k], ns)));
      const float d1 = sub(dy[k], add(mul(sx[k], s), mul(sy[k], c)));
      res[k] = mul(add(add(0.0f, mul(d0, d0)), mul(d1, d1)), mf[k]);
    }
  };
  // one round after the residuals: the new weights wn at mu, and in one
  // tree the cost c (TLS: at the old weights; FGR: at the new ones) and the
  // next round's dot and cross at the new weights
  float wn[NPT];
  float c = 0.0f, nd = 0.0f, nc = 0.0f;
  auto round_sums = [&](float mu) {
    float v[3][NPT];
    if (fgr) {
      const float me = mul(mu, nb_sq);
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        const float q = dvd(me, add(res[k], me));
        wn[k] = mul(mul(q, q), mf[k]);
        v[0][k] = mul(wn[k], res[k]);
      }
    } else {
      const float mu1 = add(mu, 1.0f);
      const float th1 = mul(dvd(mu1, mu), nb_sq);
      const float th2 = mul(dvd(mu, mu1), nb_sq);
      const float num = mul(mul(nb_sq, mu), mu1);
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        const float mid = sub(__fsqrt_rn(dvd(num, clamp_min(res[k], 1e-30f))), mu);
        wn[k] = mul(res[k] >= th1 ? 0.0f : (res[k] <= th2 ? 1.0f : mid), mf[k]);
        v[0][k] = mul(w[k], res[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const bool in = tid + k * T < n;
      const float we = mul(wn[k], mf[k]);
      if (!in) v[0][k] = 0.0f;
      v[1][k] = in ? mul(we, sdot[k]) : 0.0f;
      v[2][k] = in ? mul(we, scr[k]) : 0.0f;
    }
    tree_sum<T, NPT, 3>(v, p.half, sm, red);
    c = red[0];
    nd = red[1];
    nc = red[2];
  };

  float theta, cost = INFINITY, prev = INFINITY;
  int iters = 0;
  if (p.max_iter <= 0) {                    // no iteration runs
    theta = solve(mf);
  } else {
    // iteration 0
    float we[NPT];
#pragma unroll
    for (int k = 0; k < NPT; ++k) we[k] = mul(w[k], mf[k]);
    theta = solve(we);
    residuals(theta);
    const float top = block_amax<T, NPT>(res, n, sm);
    float mu = fgr ? clamp_min(dvd(top, nb_sq), 1.0f)
                   : dvd(1.0f, sub(dvd(mul(2.0f, top), nb_sq), 1.0f));
    round_sums(mu);
    iters = 1;
    bool live;
    if (fgr) {
      const bool done = mu <= 1.0f && fabsf(sub(c, prev)) < p.threshold;
#pragma unroll
      for (int k = 0; k < NPT; ++k) w[k] = wn[k];
      mu = clamp_min(mul(mu, p.factor), 1.0f);
      prev = c;
      live = !done;
    } else {
      cost = c;
      const bool step = !(mu <= 0.0f);      // noise-free: keep the weights
      if (step) {
#pragma unroll
        for (int k = 0; k < NPT; ++k) w[k] = wn[k];
      }
      const bool converged = fabsf(sub(c, prev)) < p.threshold;
      if (step) {
        mu = mul(mu, p.factor);
        prev = c;
      }
      live = step && !converged;
    }
    // iterations 1 .. max_iter - 1, to this row's exit
    for (int it = 1; live && it < p.max_iter; ++it) {
      theta = atan2f(nc, nd);
      residuals(theta);
      const float mu_round = mu;
      round_sums(mu_round);
      ++iters;
      bool done;
      if (fgr) {
        done = mu <= 1.0f && fabsf(sub(c, prev)) < p.threshold;
        mu = clamp_min(mul(mu, p.factor), 1.0f);
      } else {
        cost = c;
        done = fabsf(sub(c, prev)) < p.threshold;
        mu = mul(mu, p.factor);
      }
#pragma unroll
      for (int k = 0; k < NPT; ++k) w[k] = wn[k];
      prev = c;
      live = !done;
    }
    if (fgr) cost = prev;
  }
  if (tid == 0) {
    const float cs = cosf(theta), sn = sinf(theta);
    rotation[4 * r + 0] = cs;
    rotation[4 * r + 1] = -sn;
    rotation[4 * r + 2] = sn;
    rotation[4 * r + 3] = cs;
    iters_out[r] = iters;
    cost_out[r] = cost;
  }
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int i = tid + k * T;
    if (i < n) {
      weights[r * n + i] = w[k];
      inliers[r * n + i] = w[k] >= 0.4f && mk[k];
    }
  }
}

// The GNC of rows wider than the register kernel's 4096 points: the same
// rounds, each point's values recomputed from the inputs where the
// register kernel keeps them (the same operations, so the same bits), the
// weights kept in `weights` and the next round's in `wnext` (rows x n
// floats each; a thread reads and writes only its own points). A thread
// folds its 2^levels points t + k * T (+0 past the row) in the tree's
// pairing (tree::strided_fold), then tree_sum takes the levels below T.
template <int T>
__global__ void __launch_bounds__(T)
gnc_yaw_wide_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                    const bool* __restrict__ mask, const float* __restrict__ nb_rows,
                    GncParams p, int levels, float* __restrict__ rotation,
                    float* __restrict__ weights, float* __restrict__ wnext,
                    bool* __restrict__ inliers, int* __restrict__ iters_out,
                    float* __restrict__ cost_out) {
  __shared__ float sm[3 * T];
  __shared__ float red[3];
  const int tid = threadIdx.x;
  const size_t r = blockIdx.x;
  const int n = p.n;
  const bool fgr = p.algo == 1;
  const int members = 1 << levels;
  float* w = weights + r * n;
  float* wn = wnext + r * n;
  const bool* mrow = mask + r * n;

  struct Pt {
    float sx, sy, dx, dy, mf, sdot, scr;
  };
  auto point = [&](int i) {
    Pt q;
    q.sx = src[r * p.src_rs + (size_t)i * p.src_ps];
    q.sy = src[r * p.src_rs + (size_t)i * p.src_ps + 1];
    q.dx = dst[r * p.dst_rs + (size_t)i * p.dst_ps];
    q.dy = dst[r * p.dst_rs + (size_t)i * p.dst_ps + 1];
    q.mf = mrow[i] ? 1.0f : 0.0f;
    q.sdot = add(add(0.0f, mul(q.sx, q.dx)), mul(q.sy, q.dy));
    q.scr = sub(mul(q.sx, q.dy), mul(q.sy, q.dx));
    return q;
  };
  for (int k = 0; k < members; ++k) {
    const int i = tid + k * T;
    if (i < n) w[i] = mrow[i] ? 1.0f : 0.0f;
  }
  const float nb = nb_rows != nullptr ? nb_rows[r] : p.nb;
  const float nb2 = mul(nb, nb);
  const float nb_sq = fgr ? clamp_min(nb2, 1e-16f) : (nb2 < 1e-16f ? 1e-2f : nb2);

  auto residual = [&](const Pt& q, float c, float s, float ns) {
    const float d0 = sub(q.dx, add(mul(q.sx, c), mul(q.sy, ns)));
    const float d1 = sub(q.dy, add(mul(q.sx, s), mul(q.sy, c)));
    return mul(add(add(0.0f, mul(d0, d0)), mul(d1, d1)), q.mf);
  };
  // the Procrustes angle at the weights w * mf
  auto solve = [&]() {
    float o[2];
    tree::strided_fold<2>(
        [&](int k, float (&x)[2]) {
          const int i = tid + k * T;
          x[0] = x[1] = 0.0f;
          if (i < n) {
            const Pt q = point(i);
            const float we = mul(w[i], q.mf);
            x[0] = mul(we, q.sdot);
            x[1] = mul(we, q.scr);
          }
        },
        levels, o);
    float v[2][1] = {{o[0]}, {o[1]}};
    tree_sum<T, 1, 2>(v, p.half, sm, red);
    return atan2f(red[1], red[0]);
  };
  // one round at theta and mu: the next weights into wn, and in one tree
  // the cost c and the next round's dot and cross (gnc_yaw_kernel's
  // round_sums)
  float c = 0.0f, nd = 0.0f, nc = 0.0f;
  auto round_sums = [&](float theta, float mu) {
    const float cs = cosf(theta), sn = sinf(theta), ns = -sn;
    const float me = mul(mu, nb_sq);
    const float mu1 = add(mu, 1.0f);
    const float th1 = mul(dvd(mu1, mu), nb_sq);
    const float th2 = mul(dvd(mu, mu1), nb_sq);
    const float num = mul(mul(nb_sq, mu), mu1);
    float o[3];
    tree::strided_fold<3>(
        [&](int k, float (&x)[3]) {
          const int i = tid + k * T;
          x[0] = x[1] = x[2] = 0.0f;
          if (i >= n) return;
          const Pt q = point(i);
          const float res = residual(q, cs, sn, ns);
          float wk;
          if (fgr) {
            const float qq = dvd(me, add(res, me));
            wk = mul(mul(qq, qq), q.mf);
            x[0] = mul(wk, res);
          } else {
            const float mid = sub(__fsqrt_rn(dvd(num, clamp_min(res, 1e-30f))), mu);
            wk = mul(res >= th1 ? 0.0f : (res <= th2 ? 1.0f : mid), q.mf);
            x[0] = mul(w[i], res);
          }
          wn[i] = wk;
          const float we = mul(wk, q.mf);
          x[1] = mul(we, q.sdot);
          x[2] = mul(we, q.scr);
        },
        levels, o);
    float v[3][1] = {{o[0]}, {o[1]}, {o[2]}};
    tree_sum<T, 1, 3>(v, p.half, sm, red);
    c = red[0];
    nd = red[1];
    nc = red[2];
  };
  auto take = [&]() {
    for (int k = 0; k < members; ++k) {
      const int i = tid + k * T;
      if (i < n) w[i] = wn[i];
    }
  };

  float theta, cost = INFINITY, prev = INFINITY;
  int iters = 0;
  if (p.max_iter <= 0) {
    theta = solve();
  } else {
    theta = solve();
    // the largest residual at theta (block_amax's order inside a thread)
    float top[1] = {-INFINITY};
    {
      const float cs = cosf(theta), sn = sinf(theta), ns = -sn;
      for (int k = 0; k < members; ++k) {
        const int i = tid + k * T;
        if (i >= n) continue;
        const float y = residual(point(i), cs, sn, ns);
        if (isnan(y) || y > top[0]) top[0] = y;
      }
    }
    const float mx = block_amax<T, 1>(top, T, sm);
    float mu = fgr ? clamp_min(dvd(mx, nb_sq), 1.0f)
                   : dvd(1.0f, sub(dvd(mul(2.0f, mx), nb_sq), 1.0f));
    round_sums(theta, mu);
    iters = 1;
    bool live;
    if (fgr) {
      const bool done = mu <= 1.0f && fabsf(sub(c, prev)) < p.threshold;
      take();
      mu = clamp_min(mul(mu, p.factor), 1.0f);
      prev = c;
      live = !done;
    } else {
      cost = c;
      const bool step = !(mu <= 0.0f);
      if (step) take();
      const bool converged = fabsf(sub(c, prev)) < p.threshold;
      if (step) {
        mu = mul(mu, p.factor);
        prev = c;
      }
      live = step && !converged;
    }
    for (int it = 1; live && it < p.max_iter; ++it) {
      theta = atan2f(nc, nd);
      round_sums(theta, mu);
      ++iters;
      bool done;
      if (fgr) {
        done = mu <= 1.0f && fabsf(sub(c, prev)) < p.threshold;
        mu = clamp_min(mul(mu, p.factor), 1.0f);
      } else {
        cost = c;
        done = fabsf(sub(c, prev)) < p.threshold;
        mu = mul(mu, p.factor);
      }
      take();
      prev = c;
      live = !done;
    }
    if (fgr) cost = prev;
  }
  if (tid == 0) {
    const float cs = cosf(theta), sn = sinf(theta);
    rotation[4 * r + 0] = cs;
    rotation[4 * r + 1] = -sn;
    rotation[4 * r + 2] = sn;
    rotation[4 * r + 3] = cs;
    iters_out[r] = iters;
    cost_out[r] = cost;
  }
  for (int k = 0; k < members; ++k) {
    const int i = tid + k * T;
    if (i < n) inliers[r * n + i] = w[i] >= 0.4f && mrow[i];
  }
}

// ------------------------------------------------------------------- COTE

struct CoteParams {
  int hyps;          // rows a pair (the polish)
  int n;
  int rdim;          // the GNC's rotation: 2 (yaw) or 3
  int prior_stride;
  float beta;
  int median;
  int rot_inliers;   // using_rot_inliers_when_estimating_cote
  int polish;        // 0: COTE on given points
  int pe, pn;        // 2N and N padded to powers of two (the sorts)
  int words;         // the prefix's level words of one series
};

// torch.argmin's order on the card: NaN is the least, ties to the lower
// index
struct ArgMin {
  float v;
  int i;
  float x_hat, card;
};

__device__ __forceinline__ bool before(const ArgMin& a, const ArgMin& b) {
  if (isnan(a.v)) return isnan(b.v) ? a.i < b.i : true;
  if (isnan(b.v)) return false;
  return a.v == b.v ? a.i < b.i : a.v < b.v;
}

__device__ __forceinline__ ArgMin shfl_down(const ArgMin& a, int o) {
  return ArgMin{__shfl_down_sync(0xffffffffu, a.v, o), __shfl_down_sync(0xffffffffu, a.i, o),
                __shfl_down_sync(0xffffffffu, a.x_hat, o),
                __shfl_down_sync(0xffffffffu, a.card, o)};
}

__device__ ArgMin block_argmin(ArgMin a, ArgMin* sm) {
  const int t = threadIdx.x;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const ArgMin b = shfl_down(a, o);
    if (before(b, a)) a = b;
  }
  if ((t & 31) == 0) sm[t >> 5] = a;
  __syncthreads();
  if (t < 32) {
    a = t < (int)(blockDim.x >> 5) ? sm[t] : ArgMin{INFINITY, 0x7fffffff, 0.0f, 0.0f};
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      const ArgMin b = shfl_down(a, o);
      if (before(b, a)) a = b;
    }
    if (t == 0) sm[32] = a;
  }
  __syncthreads();
  return sm[32];
}

struct CoteInputs {
  const float* src;       // (B, N, 3) (polish) or (R, N, 3)
  const float* tgt;
  const float* scale;     // (R,)
  const float* gnc_rot;   // (R, d, d)
  const float* prior;
  const bool* gnc_inl;    // (R, N)
  const long long* order;
  const long long* m;
  const bool* valid;
  const bool* mask;       // (R, N), COTE on given points
};

struct CoteOutputs {
  int* ticket;            // R ints that are 0, left at 0
  float* est;             // (R, 3) scratch
  float* rotation;        // (R, 3, 3)
  float* translation;     // (R, 3)
  bool* inliers;          // (R, N): the final mask (polish) or COTE's
  int* num_rot;           // (R,)
};

// G: the events, candidates, values, prefix levels, selection and mask
// of each (row, axis) in its `block_words` 64-bit words of `work` (global
// memory) past kMaxPoints points a row; else in shared memory
template <bool G>
__global__ void __launch_bounds__(kCoteThreads)
polish_cote_kernel(CoteInputs in, CoteParams p, CoteOutputs out,
                   unsigned long long* __restrict__ work, long long block_words) {
  extern __shared__ unsigned long long smem_keys[];   // pe event keys, then pn
  unsigned long long* keys =
      G ? work + ((size_t)blockIdx.x * 3 + blockIdx.y) * block_words : smem_keys;
  __shared__ float rot[9];
  __shared__ int warp_sums[32];
  __shared__ ArgMin arg[33];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const size_t r = blockIdx.x;       // rows on x: up to 2^31 - 1 of them
  const int axis = blockIdx.y;
  const int n = p.n, n2 = 2 * n;
  unsigned long long* ckeys = keys + p.pe;
  float* x = reinterpret_cast<float*>(ckeys + p.pn);
  float* lv = x + n;
  int* sel = reinterpret_cast<int*>(lv + 3 * p.words);
  unsigned char* msk = reinterpret_cast<unsigned char*>(sel + n);

  const size_t pair = p.polish ? r / p.hyps : r;
  const float* src = in.src + pair * n * 3;
  const float* tgt = in.tgt + pair * n * 3;
  float sc = 1.0f;
  int count = 0;                 // COTE's valid points
  int num_rot = 0;
  if (p.polish) {
    // the rotation R RyRx: the GNC's (the yaw in the identity) times the
    // prior
    if (tid < 9) {
      const int j = tid / 3, k = tid % 3;
      const float* pr = in.prior + pair * p.prior_stride;
      float g[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        g[c] = p.rdim == 3 ? in.gnc_rot[9 * r + 3 * j + c]
                           : (j < 2 && c < 2 ? in.gnc_rot[4 * r + 2 * j + c]
                                             : (j == c ? 1.0f : 0.0f));
      rot[tid] = add(add(mul(g[0], pr[k]), mul(g[1], pr[3 + k])), mul(g[2], pr[6 + k]));
    }
    // the rotation inliers: an inlier whose chain predecessor is one
    const int m = (int)in.m[r];
    const bool* gi = in.gnc_inl + r * n;
    const int first_prev = m - 1 > 0 ? m - 1 : 0;
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + tid;
      const bool ri = i < n && i < m && gi[i] && gi[i == 0 ? first_prev : i - 1];
      num_rot += __syncthreads_count(ri);
    }
    const bool use_rot = p.rot_inliers && num_rot > 0;
    count = use_rot ? num_rot : m;
    // sel_idx: the chain order at the selected positions, then the rest
    int chosen = 0;
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + tid;
      const bool s = i < n && (use_rot ? (i < m && gi[i] && gi[i == 0 ? first_prev : i - 1])
                                       : i < m);
      int total;
      const int b = chosen + scan::block_exclusive_scan(s ? 1 : 0, warp_sums, &total);
      if (i < n) sel[s ? b : count + (i - b)] = (int)in.order[r * n + i];
      chosen += total;
    }
    sc = in.scale[r];
    __syncthreads();
  }

  // this axis' values: dst - scale * R src, at the selection (polish), or
  // dst - src
  auto value = [&](int q, int a) {
    if (!p.polish) return sub(tgt[3 * q + a], src[3 * q + a]);
    const int idx = sel[q];
    const float s0 = mul(sc, src[3 * idx]), s1 = mul(sc, src[3 * idx + 1]),
                s2 = mul(sc, src[3 * idx + 2]);
    return sub(tgt[3 * idx + a], rot_row(rot + 3 * a, s0, s1, s2));
  };
  int masked = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int q = base + tid;
    bool v = false;
    if (q < n) {
      x[q] = value(q, axis);
      v = p.polish ? q < count : in.mask[r * n + q];
      msk[q] = v;
    }
    masked += __syncthreads_count(v);
  }
  if (!p.polish) count = masked;
  const float beta = p.beta;

  // the 2N events sorted: entries x - beta, exits x + beta, masked at
  // FLT_MAX
  for (int e = tid; e < p.pe; e += blockDim.x) {
    unsigned long long key = ~0ull;
    if (e < n2) {
      const int i = e < n ? e : e - n;
      const float v = msk[i] ? (e < n ? sub(x[i], beta) : add(x[i], beta)) : kFltMax;
      key = (unsigned long long)ordered_bits(v, false) << 32 | (unsigned)e;
    }
    keys[e] = key;
  }
  __syncthreads();
  bitonic_sort(keys, p.pe);

  // the series at sorted position q: eps, eps * x_s, eps * x_s * x_s
  auto series = [&](int q, float (&s)[3], float& eps) {
    const int e = (int)(keys[q] & 0xffffffffu);
    const int i = e < n ? e : e - n;
    const float mf = msk[i] ? 1.0f : 0.0f;
    eps = e < n ? mf : -mf;
    const float xs = mul(x[i], fabsf(eps));
    s[0] = eps;
    s[1] = mul(eps, xs);
    s[2] = mul(s[1], xs);
  };
  // level 0: a thread a block of 16 positions, its total into level 1
  const int m1 = (n2 + scan::kScanBlock - 1) / scan::kScanBlock;
  for (int b = tid; b < m1; b += blockDim.x) {
    float acc[3];
    const int stop = min(n2, (b + 1) * scan::kScanBlock);
    for (int q = b * scan::kScanBlock; q < stop; ++q) {
      float s[3], eps;
      series(q, s, eps);
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[j] = q == b * scan::kScanBlock ? s[j] : add(acc[j], s[j]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) lv[j * p.words + b] = acc[j];
  }
  __syncthreads();
  scan::scan_levels(lv, p.words, 3, m1, [](const float* a) { return *a; });

  // the cost at every centre, and its first minimum
  const float total = (float)count;
  const float inv_b2 = dvd(1.0f, clamp_min(mul(beta, beta), 1e-30f));
  ArgMin best{INFINITY, 0x7fffffff, 0.0f, 0.0f};
  for (int b = tid; b < m1; b += blockDim.x) {
    float acc[3];
    const int stop = min(n2, (b + 1) * scan::kScanBlock);
    for (int q = b * scan::kScanBlock; q < stop; ++q) {
      float s[3], eps;
      series(q, s, eps);
      float v[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        acc[j] = q == b * scan::kScanBlock ? s[j] : add(acc[j], s[j]);
        v[j] = scan::prefix_at(acc[j], lv + j * p.words, n2, q);
      }
      const float card = v[0], sum_x = v[1], sum_x2 = v[2];
      const float dot_w = mul(card, inv_b2);
      const float dot_xw = mul(sum_x, inv_b2);
      const float range_rem = mul(beta, sub(total, card));
      const float x_hat = dvd(dot_xw, dot_w == 0.0f ? 1.0f : dot_w);
      float cost = add(sub(add(mul(mul(card, x_hat), x_hat), sum_x2),
                           mul(mul(2.0f, sum_x), x_hat)), range_rem);
      if (!(card > 0.5f && eps != 0.0f)) cost = kFltMax;
      const ArgMin here{cost, q, x_hat, card};
      if (before(here, best)) best = here;
    }
  }
  best = block_argmin(best, arg);
  float est = best.x_hat;

  if (p.median) {
    // the reference's median mode: the values of the n_card events up to
    // the minimum, sorted; 0.5 (lo + hi) at its even-parity ranks
    const long long n_card = (long long)best.card;
    const int at = best.i;
    auto cand = [&](int j) {
      const int back = at - j;
      if (!(j < n_card && back >= 0)) return kFltMax;
      const int pos = min(back, n2 - 1);
      const int e = (int)(keys[pos] & 0xffffffffu);
      return x[e < n ? e : e - n];
    };
    for (int j = tid; j < p.pn; j += blockDim.x)
      ckeys[j] = j < n ? ((unsigned long long)ordered_bits(cand(j), n <= kBitonicSortMax) << 32 |
                          (unsigned)j)
                       : ~0ull;
    __syncthreads();
    bitonic_sort(ckeys, p.pn);
    const long long half = n_card / 2;
    const int lo = (int)min(max(half - 1, 0ll), (long long)(n - 1));
    const int hi = (int)min(max(half, 0ll), (long long)(n - 1));
    const float v0 = cand((int)(ckeys[0] & 0xffffffffu));
    const float vlo = cand((int)(ckeys[lo] & 0xffffffffu));
    const float vhi = cand((int)(ckeys[hi] & 0xffffffffu));
    const float median = n_card == 1 ? v0 : mul(0.5f, add(vlo, vhi));
    if (n_card > 0) est = median;
  }

  const bool ok = p.polish ? in.valid[r] : true;
  if (tid == 0) {
    out.est[3 * r + axis] = est;
    out.translation[3 * r + axis] = ok ? est : 0.0f;
    if (p.polish && axis == 0) {
      for (int j = 0; j < 9; ++j) out.rotation[9 * r + j] = ok ? rot[j] : (j % 4 == 0 ? 1.0f : 0.0f);
      out.num_rot[r] = num_rot;
    }
  }
  // the row's last block: the inliers on all three axes
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(out.ticket + r, 1) == 2;
  __syncthreads();
  if (!last) return;
  if (tid == 0) out.ticket[r] = 0;
  __threadfence();
  float e3[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) e3[a] = __ldcg(out.est + 3 * r + a);
  for (int q = tid; q < n; q += blockDim.x) {
    bool inl = msk[q];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v = a == axis ? x[q] : value(q, a);
      inl = inl && fabsf(sub(v, e3[a])) <= beta;
    }
    if (p.polish)
      out.inliers[r * n + sel[q]] = inl && ok;
    else
      out.inliers[r * n + q] = inl;
  }
}

inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// the prefix's level words of a length: ceil(n / 16) + ceil(n / 256) + ...,
// down to a level of at most 16 (ops/voxel.py::level_words)
inline int level_words(int n) {
  int words = 0, m = (n + scan::kScanBlock - 1) / scan::kScanBlock;
  for (;;) {
    words += m;
    if (m <= scan::kScanBlock) return words;
    m = (m + scan::kScanBlock - 1) / scan::kScanBlock;
  }
}

// the bytes of one (row, axis)'s buffers: pe + pn keys, x, the levels,
// sel, msk (the wrapper's cote_block_words gives them in 64-bit words)
inline long long cote_bytes(int n) {
  return (long long)(pow2_at_least(2 * n) + pow2_at_least(n)) * 8 +
         (long long)(n + 3 * level_words(2 * n) + n) * 4 + n;
}

// work: null within kMaxPoints points a row (shared memory), else rows x 3
// blocks of work_words 64-bit words each
inline int cote_launch(const CoteInputs& in, CoteParams p, const CoteOutputs& out, int rows,
                       unsigned long long* work, int work_words, cudaStream_t stream) {
  p.pe = pow2_at_least(2 * p.n);
  p.pn = pow2_at_least(p.n);
  p.words = level_words(2 * p.n);
  if (p.n > kMaxPoints) {
    if (work == nullptr || (long long)work_words * 8 < cote_bytes(p.n))
      return (int)cudaErrorInvalidValue;
    polish_cote_kernel<true><<<dim3(rows, 3), kCoteThreads, 0, stream>>>(in, p, out, work,
                                                                         work_words);
    return (int)cudaGetLastError();
  }
  const int smem = (p.pe + p.pn) * 8 + (p.n + 3 * p.words + p.n) * 4 + p.n;
  const int rc = (int)cudaFuncSetAttribute(polish_cote_kernel<false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  polish_cote_kernel<false><<<dim3(rows, 3), kCoteThreads, smem, stream>>>(in, p, out, nullptr,
                                                                          0);
  return (int)cudaGetLastError();
}

template <int T, int NPT>
int gnc_launch(const float* src, const float* dst, const bool* mask, const float* nb_rows,
               const GncParams& p, int rows, float* rotation, float* weights, bool* inliers,
               int* iters, float* cost, cudaStream_t stream) {
  gnc_yaw_kernel<T, NPT><<<rows, T, 0, stream>>>(src, dst, mask, nb_rows, p, rotation,
                                                  weights, inliers, iters, cost);
  return (int)cudaGetLastError();
}

}  // namespace pol
}  // namespace quatro

// order, leaf: (pairs * hyps, n) int64; chain_mask (.., n) bool; m (..) int64;
// src_tims, dst_tims (.., n, 3) f32.
extern "C" int quatro_polish_chain(const float* src, const float* tgt, const bool* clique_mask,
                                   const float* scale, const float* prior, int pairs, int hyps,
                                   int n, int prior_stride, int has_prior, long long* order,
                                   long long* leaf, bool* chain_mask, long long* m,
                                   float* src_tims, float* dst_tims, int* work,
                                   cudaStream_t stream) {
  using namespace quatro::pol;
  if (pairs <= 0 || hyps <= 0 || n <= 0) return (int)cudaGetLastError();
  const ChainParams p{hyps, n, prior_stride, has_prior};
  if (n > kMaxPoints) {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    polish_chain_kernel<true><<<pairs * hyps, kChainThreads, 0, stream>>>(
        src, tgt, clique_mask, scale, prior, p, order, leaf, chain_mask, m, src_tims, dst_tims,
        work);
  } else {
    polish_chain_kernel<false><<<pairs * hyps, kChainThreads, 0, stream>>>(
        src, tgt, clique_mask, scale, prior, p, order, leaf, chain_mask, m, src_tims, dst_tims,
        nullptr);
  }
  return (int)cudaGetLastError();
}

// nb_rows: one noise bound a row, or null (then nb); factor: gnc_factor
// (algo 0, GNC-TLS) or its f32 reciprocal (algo 1, FGR).
extern "C" int quatro_gnc_yaw(const float* src, const float* dst, const bool* mask,
                              const float* nb_rows, int rows, int n, int src_rs, int src_ps,
                              int dst_rs, int dst_ps, float nb, int algo, float factor,
                              int max_iter, float threshold, float* rotation, float* weights,
                              bool* inliers, int* iters, float* cost, float* work,
                              cudaStream_t stream) {
  using namespace quatro::pol;
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  const int pow2 = pow2_at_least(n);
  const GncParams p{n, pow2 / 2, src_rs, src_ps, dst_rs, dst_ps, nb, algo, factor,
                    max_iter, threshold};
  if (n > kMaxPoints) {     // work: rows x n floats, the next round's weights
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    int levels = 0;
    while ((kWideThreads << levels) < pow2) ++levels;
    gnc_yaw_wide_kernel<kWideThreads><<<rows, kWideThreads, 0, stream>>>(
        src, dst, mask, nb_rows, p, levels, rotation, weights, work, inliers, iters, cost);
    return (int)cudaGetLastError();
  }
  if (pow2 <= 256)
    return gnc_launch<256, 1>(src, dst, mask, nb_rows, p, rows, rotation, weights, inliers,
                              iters, cost, stream);
  if (pow2 == 512)
    return gnc_launch<256, 2>(src, dst, mask, nb_rows, p, rows, rotation, weights, inliers,
                              iters, cost, stream);
  if (pow2 == 1024)
    return gnc_launch<256, 4>(src, dst, mask, nb_rows, p, rows, rotation, weights, inliers,
                              iters, cost, stream);
  if (pow2 == 2048)
    return gnc_launch<1024, 2>(src, dst, mask, nb_rows, p, rows, rotation, weights, inliers,
                               iters, cost, stream);
  return gnc_launch<1024, 4>(src, dst, mask, nb_rows, p, rows, rotation, weights, inliers,
                             iters, cost, stream);
}

// The polish's COTE. ticket: pairs * hyps ints that are 0 (left at 0); est:
// pairs * hyps * 3 f32 words of scratch.
extern "C" int quatro_polish_cote(const float* src, const float* tgt, const float* scale,
                                  const float* gnc_rot, const float* prior,
                                  const bool* gnc_inl, const long long* order,
                                  const long long* m, const bool* valid, int pairs, int hyps,
                                  int n, int rdim, int prior_stride, float beta, int median,
                                  int rot_inliers, int* ticket, float* est, float* rotation,
                                  float* translation, bool* final_mask, int* num_rot,
                                  unsigned long long* work, int work_words,
                                  cudaStream_t stream) {
  using namespace quatro::pol;
  if (pairs <= 0 || hyps <= 0 || n <= 0) return (int)cudaGetLastError();
  const CoteInputs in{src, tgt, scale, gnc_rot, prior, gnc_inl, order, m, valid, nullptr};
  const CoteOutputs out{ticket, est, rotation, translation, final_mask, num_rot};
  const CoteParams p{hyps, n, rdim, prior_stride, beta, median, rot_inliers, 1, 0, 0, 0};
  return cote_launch(in, p, out, pairs * hyps, work, work_words, stream);
}

// COTE on given points (solver/translation.solve_translation): src, dst
// (rows, n, 3), mask (rows, n) -> translation (rows, 3), inliers (rows, n).
extern "C" int quatro_cote(const float* src, const float* dst, const bool* mask, int rows, int n,
                           float beta, int median, int* ticket, float* est,
                           float* translation, bool* inliers, unsigned long long* work,
                           int work_words, cudaStream_t stream) {
  using namespace quatro::pol;
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  const CoteInputs in{src, dst, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      mask};
  const CoteOutputs out{ticket, est, nullptr, translation, inliers, nullptr};
  const CoteParams p{1, n, 3, 0, beta, median, 0, 0, 0, 0, 0};
  return cote_launch(in, p, out, rows, work, work_words, stream);
}
