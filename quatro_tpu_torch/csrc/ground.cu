// The ground-plane leveling of clouds: the plane fit, its gates and the
// leveling rotation, a thread-block cluster a cloud, no host read.
//
// The counterpart of quatro_tpu/solver/ground.py:53-146 (fit_ground_plane,
// leveling_rotation and align_ground's gates, one jax.jit of XLA fusions;
// no Pallas kernel there), bit for bit quatro_tpu_torch/ops/ground.py::
// ground_fit_plain on the card.
//
// Two sets of clouds a (Ca, Na, 3) and b (Cb, Nb, 3) f32 with ground masks
// (bool; Cb = 0: one set) -> level (Ca + Cb, 3, 3), height (Ca + Cb) f32
// and ok (Ca + Cb) bool, the clouds of a first. Per cloud:
// - the count and w.sum() (exact integers in any order);
// - the centroid sum_i p_i w_i and the scatter sum_i d_a d_b with
//   d = (p - c) w, each in utils/fused.pairwise_sum's tree over N (the
//   length padded with +0 to a power of two P, x[i] + x[i + half] level by
//   level; d_a d_b and d_b d_a are the same bits, so six sums), quotients
//   by max(w.sum, 1) (tensor quotients, __fdiv_rn);
// - the smallest eigenpair of eig_sym3.cuh, the normal times
//   sign(n_z + f32(1e-12)) (torch.sign: 0 at 0 and NaN), the trace and the
//   flatness lambda_min / max(trace, 1e-30);
// - the gates count >= min_points, n_z >= min_cos, flatness <=
//   max_flatness (the f32 constants of the Python side);
// - leveling_rotation: the normal over max(|n|, 1e-12), |n| as
//   sqrt(fma(n_z, n_z, fma(n_y, n_y, n_x n_x))) (fused.fma's route, the
//   order of torch.linalg.vector_norm on the CPU, now the plain version's
//   explicit order), k = 1 / max(1 + c, 1e-6), I + [v]x + k [v]x^2 with
//   [v]x^2 as _matmul3 adds it (rotate_points' order);
// - level = ok ? L : I, height = ok ? (l20 c0 + l21 c1) + l22 c2 : 0.
// With `pairs` (Ca == Cb, align_ground) cloud c and cloud Ca + c are one
// pair, which levels only where both pass: the pair's second block to
// finish (an integer ticket after a fence, set back to 0 by it) writes
// identity and zero heights to both where either failed, and the pair's
// ok to both.
//
// Design: a cluster of 8 CTAs of 1024 threads a cloud (16 SMs at path A).
// Thread t of CTA r holds the strided set {g, g + S, g + 2S, ...} of the
// cloud's points, g = 8 t + r, S = 8192; it folds the tree's levels at or
// above S over them itself (a recursion on the even and odd members,
// which is the halving pairing of pairwise_sum; past 32 members a thread,
// a cloud of more than 2^18 points, tree.cuh's strided_fold, the same
// pairing for any count); the levels from S / 2
// down to 8 pair positions of one CTA (tree.cuh: shared memory, then
// shuffles); the last three pair CTA r with CTA r + h, added by every CTA
// from the partials in distributed shared memory in that order. The
// centroid's pass must end before the scatter's: the cluster's barrier
// is the wait, with no second launch and no grid-wide sync. The cluster's
// CTA 0 finishes the cloud.
//
// Every operation rounds once, as the torch operation it stands for does
// on the card (the _rn intrinsics, which nvcc never contracts).
//
// Bound on the card: bytes (path A: 2 x 131072 points of 12 bytes and a
// mask byte, read twice, 3.4 MB, 0.001 ms).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "eig_sym3.cuh"
#include "fdlibm_atan2.cuh"
#include "tree.cuh"

namespace quatro {
namespace gnd {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;                  // CTAs a cloud (portable size)
constexpr int kThreads = 1024;
constexpr int kSpan = kCluster * kThreads;   // strided sets a cloud
constexpr int kMaxLevels = 5;    // points a set in registers: up to 2^5 (N <= 2^18)
constexpr float kSignEps = 0x1.197998p-40f;   // f32(1e-12)
constexpr float kNormEps = 0x1.197998p-40f;   // f32(1e-12)
constexpr float kOneCEps = 0x1.0c6f7ap-20f;   // f32(1e-6)

struct Cloud {
  const float* p;
  const bool* m;
  int n;
};

struct GroundParams {
  const float* pa;
  const bool* ma;
  const float* pb;
  const bool* mb;
  int ca, na, nb;
  int pairs;
  int min_points;
  float min_cos, max_flat;
};

// The pairwise tree over the strided set {base + j * stride : j < 2^L}
// (zero past N): the tree of the even members plus that of the odd ones,
// which is the halving pairing x[j] + x[j + 2^(L-1)] level by level.
template <int L, int NV, class Leaf>
__device__ __forceinline__ void subtree(const Leaf& leaf, int base, int stride, float (&out)[NV]) {
  if constexpr (L == 0) {
    leaf(base, out);
  } else {
    float a[NV], b[NV];
    subtree<L - 1, NV>(leaf, base, 2 * stride, a);
    subtree<L - 1, NV>(leaf, base + stride, 2 * stride, b);
#pragma unroll
    for (int j = 0; j < NV; ++j) out[j] = __fadd_rn(a[j], b[j]);
  }
}

template <int NV, class Leaf>
__device__ __forceinline__ void fold(const Leaf& leaf, int levels, int g, float (&out)[NV]) {
  switch (levels) {
    case 0: subtree<0, NV>(leaf, g, kSpan, out); break;
    case 1: subtree<1, NV>(leaf, g, kSpan, out); break;
    case 2: subtree<2, NV>(leaf, g, kSpan, out); break;
    case 3: subtree<3, NV>(leaf, g, kSpan, out); break;
    case 4: subtree<4, NV>(leaf, g, kSpan, out); break;
    default: subtree<kMaxLevels, NV>(leaf, g, kSpan, out); break;
  }
}

// fold, or past kMaxLevels levels (W: more than 2^18 points a cloud)
// tree.cuh's strided_fold: the same halving pairing for any count
template <bool W, int NV, class Leaf>
__device__ __forceinline__ void fold_set(const Leaf& leaf, int levels, int g, float (&out)[NV]) {
  if constexpr (W) {
    tree::strided_fold<NV>([&](int k, float (&x)[NV]) { leaf(g + k * kSpan, x); }, levels, out);
  } else {
    fold<NV>(leaf, levels, g, out);
  }
}

// The tree's levels below kCluster across the cluster: CTA r's partial is
// the value at position r (CTA r holds the positions r + kCluster t), so
// the halves 4, 2, 1 (those under `top`, the first half of the tree
// after the threads' folds) add CTA r + h to CTA r. Every CTA adds all
// kCluster partials in that order and gets the sums, and the cluster's
// count. part: this CTA's NV partials, then its count (as int bits).
template <int NV>
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cluster, float* part, int top,
                                             float* sums, int* count) {
  cluster.sync();                           // every CTA's partials written
  if (threadIdx.x == 0) {
    float v[kCluster][NV];
    int cnt = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float* q = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int j = 0; j < NV; ++j) v[r][j] = q[j];
      cnt += __float_as_int(q[NV]);
    }
    for (int h = min(top, kCluster / 2); h >= 1; h >>= 1)
      for (int r = 0; r < h; ++r)
#pragma unroll
        for (int j = 0; j < NV; ++j) v[r][j] = __fadd_rn(v[r][j], v[r + h][j]);
#pragma unroll
    for (int j = 0; j < NV; ++j) sums[j] = v[0][j];
    *count = cnt;
  }
  cluster.sync();                           // partials read: free again
}

// torch.sign of an f32: 1, -1, or 0 (at +-0 and NaN)
__device__ __forceinline__ float tsign(float x) {
  return (float)((0.0f < x) - (x < 0.0f));
}

template <bool W>
__global__ void __launch_bounds__(kThreads)
ground_fit_kernel(GroundParams g, int* __restrict__ tickets, float* __restrict__ level,
                  float* __restrict__ height, bool* __restrict__ ok_out) {
  using namespace eig;
  __shared__ float sm[6 * kThreads];
  __shared__ float part[8];
  __shared__ float sums[6];
  __shared__ int count, total;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / kCluster;
  const int t = threadIdx.x;
  const int gt = t * kCluster + rank;        // this thread's strided set
  const bool in_a = c < g.ca;
  const Cloud cl = in_a ? Cloud{g.pa + (size_t)c * g.na * 3, g.ma + (size_t)c * g.na, g.na}
                        : Cloud{g.pb + (size_t)(c - g.ca) * g.nb * 3,
                                g.mb + (size_t)(c - g.ca) * g.nb, g.nb};
  const int n = cl.n;
  int p2 = 1;                              // pairwise_sum's padded length
  while (p2 < n) p2 <<= 1;
  int levels = 0;
  while ((kSpan << levels) < p2) ++levels;
  const int top = (p2 < kSpan ? p2 : kSpan) / 2;   // the first half after the folds
  const int half = top / kCluster;                  // its levels inside a CTA

  if (t == 0) count = 0;
  __syncthreads();
  int mine = 0;
  for (int i = gt; i < n; i += kSpan) mine += cl.m[i];
  if (mine) atomicAdd(&count, mine);

  // the centroid: pairwise_sum(points * w) over N
  {
    float v[3][1];
    float o[3];
    fold_set<W, 3>(
        [&](int i, float (&x)[3]) {
          if (i < n) {
            const float w = cl.m[i] ? 1.0f : 0.0f;
#pragma unroll
            for (int d = 0; d < 3; ++d) x[d] = fmul(cl.p[3 * (size_t)i + d], w);
          } else {
#pragma unroll
            for (int d = 0; d < 3; ++d) x[d] = 0.0f;
          }
        },
        levels, gt, o);
#pragma unroll
    for (int d = 0; d < 3; ++d) v[d][0] = o[d];
    tree::tree_sum<kThreads, 1, 3>(v, half, sm, part);
    if (t == 0) part[3] = __int_as_float(count);
    cluster_sums<3>(cluster, part, top, sums, &total);
  }
  const int cnt = total;
  const float denom = fmaxf((float)cnt, 1.0f);
  const float c0 = fdiv(sums[0], denom), c1 = fdiv(sums[1], denom), c2 = fdiv(sums[2], denom);

  // the scatter: pairwise_sum(d_a * d_b) with d = (p - c) * w
  {
    float v[6][1];
    float o[6];
    fold_set<W, 6>(
        [&](int i, float (&x)[6]) {
          if (i < n) {
            const float w = cl.m[i] ? 1.0f : 0.0f;
            const float* q = cl.p + 3 * (size_t)i;
            const float d0 = fmul(fsub(q[0], c0), w), d1 = fmul(fsub(q[1], c1), w),
                        d2 = fmul(fsub(q[2], c2), w);
            x[0] = fmul(d0, d0);
            x[1] = fmul(d0, d1);
            x[2] = fmul(d0, d2);
            x[3] = fmul(d1, d1);
            x[4] = fmul(d1, d2);
            x[5] = fmul(d2, d2);
          } else {
#pragma unroll
            for (int d = 0; d < 6; ++d) x[d] = 0.0f;
          }
        },
        levels, gt, o);
#pragma unroll
    for (int d = 0; d < 6; ++d) v[d][0] = o[d];
    tree::tree_sum<kThreads, 1, 6>(v, half, sm, part);
    if (t == 0) part[6] = __int_as_float(0);
    cluster_sums<6>(cluster, part, top, sums, &total);
  }

  if (rank != 0) return;
  if (t == 0) {
    const float a11 = fdiv(sums[0], denom), a12 = fdiv(sums[1], denom),
                a13 = fdiv(sums[2], denom), a22 = fdiv(sums[3], denom),
                a23 = fdiv(sums[4], denom), a33 = fdiv(sums[5], denom);
    const Eigenpair e = smallest_eigenpair_sym3(a11, a12, a13, a22, a23, a33);
    const float s = tsign(fadd(e.v3, kSignEps));
    const float n0 = fmul(e.v1, s), n1 = fmul(e.v2, s), n2 = fmul(e.v3, s);
    const float trace = fadd(fadd(a11, a22), a33);
    const float flat = fdiv(e.eig, clamp_min(trace, kTiny));
    const bool ok = cnt >= g.min_points && n2 >= g.min_cos && flat <= g.max_flat;

    // leveling_rotation(normal)
    const float nrm = __fsqrt_rn(fdlibm::fma64(n2, n2, fdlibm::fma64(n1, n1, fmul(n0, n0))));
    const float den = clamp_min(nrm, kNormEps);
    const float u0 = fdiv(n0, den), u1 = fdiv(n1, den), u2 = fdiv(n2, den);
    const float vx = u1, vy = -u0, cc = u2;
    const float k = fdiv(1.0f, clamp_min(fadd(1.0f, cc), kOneCEps));
    const float h[3][3] = {{0.0f, 0.0f, vy}, {0.0f, 0.0f, -vx}, {-vy, vx, 0.0f}};
    float lv[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float hh =
            fadd(fadd(fmul(h[i][0], h[0][j]), fmul(h[i][1], h[1][j])), fmul(h[i][2], h[2][j]));
        lv[i][j] = ok ? fadd(fadd(i == j ? 1.0f : 0.0f, h[i][j]), fmul(k, hh))
                      : (i == j ? 1.0f : 0.0f);
      }
    const float ht =
        ok ? fadd(fadd(fmul(lv[2][0], c0), fmul(lv[2][1], c1)), fmul(lv[2][2], c2)) : 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) level[9 * (size_t)c + i] = lv[i / 3][i % 3];
    height[c] = ht;
    ok_out[c] = ok;
    if (!g.pairs) return;
    // the pair's second block to finish gates both clouds
    const int pair = in_a ? c : c - g.ca;
    __threadfence();
    if (atomicAdd(tickets + pair, 1) != 1) return;
    tickets[pair] = 0;
    __threadfence();
    const int other = in_a ? c + g.ca : c - g.ca;
    const bool both = ok && *(volatile bool*)(ok_out + other);
    const int qs[2] = {c, other};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = qs[r];
      if (!both) {
#pragma unroll
        for (int i = 0; i < 9; ++i) level[9 * (size_t)q + i] = (i % 4 == 0) ? 1.0f : 0.0f;
        height[q] = 0.0f;
      }
      ok_out[q] = both;
    }
  }
}

}  // namespace gnd
}  // namespace quatro

// clouds a (ca, na, 3) with masks (ca, na), clouds b (cb, nb, 3) with masks
// (cb, nb) (cb = 0: none), pairs (ca == cb: cloud c pairs with ca + c),
// the gates; tickets: ca zeroed ints (pairs only) -> level (ca + cb, 3, 3),
// height (ca + cb), ok (ca + cb)
extern "C" int quatro_ground_fit(const float* pa, const bool* ma, int ca, int na, const float* pb,
                                 const bool* mb, int cb, int nb, int pairs, int min_points,
                                 float min_cos, float max_flat, int* tickets, float* level,
                                 float* height, bool* ok, cudaStream_t stream) {
  using namespace quatro::gnd;
  if (ca + cb == 0) return 0;
  const GroundParams g{pa, ma, pb, mb, ca, na, nb, pairs, min_points, min_cos, max_flat};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((ca + cb) * kCluster), 1, 1);
  cfg.blockDim = dim3((unsigned)kThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // a cloud of more than 2^18 points: the wide route
  const bool wide = (na > (kSpan << kMaxLevels)) || (cb > 0 && nb > (kSpan << kMaxLevels));
  const cudaError_t err =
      wide ? cudaLaunchKernelEx(&cfg, ground_fit_kernel<true>, g, tickets, level, height, ok)
           : cudaLaunchKernelEx(&cfg, ground_fit_kernel<false>, g, tickets, level, height, ok);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
