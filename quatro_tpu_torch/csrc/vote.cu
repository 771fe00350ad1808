// The (yaw, translation) vote around B2: the yaw histogram's entries and,
// after B2's sums, the yaw modes and the translation vote's candidate
// masks; two kernels with no host read.
//
// The counterpart of quatro_tpu/solver/vote.py:65-206 (yaw_vote and
// translation_vote_masks, traced into one jax.jit: XLA fusions around the
// segment_sums Pallas call and two lax.sorts; no Pallas kernel of their
// own), bit for bit quatro_tpu_torch/ops/vote.py's vote_entries_plain and
// vote_translation_plain on the card.
//
// entries: src, tgt (B, N, 3) f32, mask (B, N) bool, the consistency graph
//   adj (B, N, N) bool -> ids (B, M N) int32 and vals (B, 3, M N) f32, the
//   edges against the M = min(num_anchors, N) anchors of largest degree of
//   adj & mask & mask^T (torch.sort(descending, stable): the largest degree
//   first, ties to the lower index, masked rows at -1). Entry m N + j:
//   v = src_j - src_a, w = tgt_j - tgt_a (xy), cross and dot, atan2f, the
//   baseline __fsqrt_rn(v.v), the weight where the edge and the baseline
//   gate hold (clamped to the weight baseline), the bin (ang + f32(pi)) x
//   f32(bins / 2 pi) clamped and truncated (num_bins where the weight is
//   0), and (w, w cross / |.|, w dot / |.|).
// translation: B2's histograms (B, bins, 3) or given yaws, the clouds, mask
//   and scales (B,) -> the yaw of each mode (B, modes) and, unless only the
//   yaws are asked for, the candidate masks (B, modes, cand, N) bool. The
//   roll-smoothed votes' first maximum (torch.argmax: NaN is the largest),
//   then the +-2-bin exclusion zones of the earlier modes; the refine
//   (hist[b] + hist[b + 1]) + hist[b - 1] and atan2f; yaw_to_rotation
//   (cosf, sinf) and t = tgt - scale rotate_points(src, R); the two grids'
//   keys (floor(t inv_bin + offset) as int64, + 512, clamped to 10 bits,
//   the second grid + 2^30, masked at the sentinel 2^31 - 1); the 2N keys
//   sorted stably (bitonic on (key, index), sort.cuh); the runs (a run
//   reaches the next new key or the end, as the cummin gives it), the
//   cand smallest occupancy rank keys ((4095 - min(len, 4095)) << 12 |
//   min(pos, 4095)), chosen by cand block minima (the keys are distinct:
//   a sort's first cand); the three rows' blocked prefix sums (scan.cuh, XLA's
//   order) at the chosen runs' ends; the means over float(count); and
//   the masks amax |t - mean| <= r (NaN fails), & mask & got.
//
// Every operation rounds once, as the torch operation it stands for does
// on the card (the _rn intrinsics, which nvcc never contracts; atan2f,
// cosf and sinf as torch calls them; float to int64 and int32 as torch's
// static_cast, NaN to 0).
//
// Design: entries, a cluster of 8 CTAs of 512 threads a pair (8 SMs at
// path A): the degrees a warp a row, each CTA an eighth of the rows
// (16-byte words of the graph and the mask where N % 16 == 0, popc of
// their AND); the anchors by each row's rank among the N (degree, index)
// keys, gathered through distributed shared memory, with no sort; then
// an eighth of the entries a CTA, a thread an entry. translation: one
// block of 1024 threads a (pair, mode), everything in shared memory
// (N <= 2048, 2N <= 4096 keys).
//
// Bound on the card: bytes (the graph read once: 1 MB a pair at N = 1024,
// and 16 bytes an entry written); the translation's sorts are chains of
// log2(2N)^2 / 2 block steps, which no bound of bytes or operations sets.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "scan.cuh"
#include "sort.cuh"

namespace quatro {
namespace vote {

constexpr int kThreads = 1024;
constexpr int kSentinel = 0x7fffffff;        // int32 max: the sort sentinel
constexpr int kQBits = 10;
constexpr int kQHalf = 1 << (kQBits - 1);
constexpr int kRankBits = 12;
constexpr int kRankMax = (1 << kRankBits) - 1;
constexpr float kPi = 0x1.921fb6p+1f;        // f32(pi)
constexpr float kTiny = 0x1.197998p-40f;     // f32(1e-12)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo) / clamp(x, lo, hi): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// ---------------------------------------------------------------- entries

constexpr int kCluster = 8;                  // CTAs a pair (portable size)
constexpr int kEntryThreads = 512;

struct EntryParams {
  int n, m;           // points, anchors
  int bins;
  float min_baseline, max_weight, bin_scale;
  int vec;            // 16-byte words of the graph (N % 16 == 0, aligned)
};

// A cluster of kCluster CTAs a pair. CTA r takes the rows i = r (mod
// kCluster): their degrees of adj & mask & mask^T (masked rows at -1) as
// (INT_MAX - degree, index) keys in its shared memory; after a cluster
// barrier every CTA gathers the other rows' keys through DSMEM, ranks its
// own rows among all N (the number of smaller keys: torch.sort(descending,
// stable)'s position), and writes a row of rank < M into every CTA's
// anchor list; after a second barrier each CTA computes a contiguous
// M N / kCluster share of the entries.
__global__ void __launch_bounds__(kEntryThreads)
vote_entries_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                    const bool* __restrict__ mask, const bool* __restrict__ adj, EntryParams p,
                    int* __restrict__ ids, float* __restrict__ vals) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = p.n;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* msk = smem + 8 * (size_t)n;                       // 16-aligned
  int* anc_i = reinterpret_cast<int*>(msk + ((n + 15) & ~15));
  float* anc = reinterpret_cast<float*>(anc_i + ((p.m + 3) & ~3));  // 4 floats an anchor
  const float* S = src + (size_t)b * n * 3;
  const float* T = tgt + (size_t)b * n * 3;
  const bool* Mk = mask + (size_t)b * n;
  const bool* A = adj + (size_t)b * n * n;
  for (int j = tid; j < n; j += kEntryThreads) msk[j] = Mk[j] ? 1 : 0;
  __syncthreads();

  // this CTA's rows' degrees and keys
  for (int i = rank + kCluster * warp; i < n; i += kCluster * (kEntryThreads / 32)) {
    int deg = 0;
    const unsigned char* row = reinterpret_cast<const unsigned char*>(A + (size_t)i * n);
    if (p.vec) {
      const uint4* r4 = reinterpret_cast<const uint4*>(row);
      const uint4* m4 = reinterpret_cast<const uint4*>(msk);
      for (int w = lane; w < n / 16; w += 32) {
        const uint4 a = __ldg(r4 + w), mm = m4[w];
        deg += __popc(a.x & mm.x) + __popc(a.y & mm.y) + __popc(a.z & mm.z) + __popc(a.w & mm.w);
      }
    } else {
      for (int j = lane; j < n; j += 32) deg += (row[j] & msk[j]) ? 1 : 0;
    }
    deg = __reduce_add_sync(0xffffffffu, deg);
    const int d = msk[i] ? deg : -1;
    if (lane == 0) keys[i] = (unsigned long long)(unsigned)(kSentinel - d) << 32 | (unsigned)i;
  }
  cluster.sync();
  // the other rows' keys from their CTAs
  for (int i = tid; i < n; i += kEntryThreads)
    if (i % kCluster != rank) keys[i] = *cluster.map_shared_rank(keys + i, i % kCluster);
  __syncthreads();
  // each own row's rank among all N keys: a quarter warp a row
  constexpr int kPerRow = 8;
  for (int q0 = 0; rank + kCluster * q0 < n; q0 += kEntryThreads / kPerRow) {
    const int i = rank + kCluster * (q0 + tid / kPerRow);
    const bool live = i < n;
    int below = 0;
    if (live) {
      const unsigned long long ki = keys[i];
      for (int j = tid % kPerRow; j < n; j += kPerRow) below += keys[j] < ki;
    }
#pragma unroll
    for (int o = kPerRow / 2; o >= 1; o >>= 1)
      below += __shfl_down_sync(0xffffffffu, below, o, kPerRow);
    if (live && tid % kPerRow == 0 && below < p.m) {
      for (int c = 0; c < kCluster; ++c) *cluster.map_shared_rank(anc_i + below, c) = i;
    }
  }
  cluster.sync();
  for (int a = tid; a < p.m; a += kEntryThreads) {
    const int i = anc_i[a];
    anc[4 * a] = S[3 * i];
    anc[4 * a + 1] = S[3 * i + 1];
    anc[4 * a + 2] = T[3 * i];
    anc[4 * a + 3] = T[3 * i + 1];
  }
  __syncthreads();

  const size_t mn = (size_t)p.m * n;
  const size_t share = (mn + kCluster - 1) / kCluster;
  const size_t e0 = share * rank, e1 = min(mn, e0 + share);
  int* I = ids + (size_t)b * mn;
  float* V = vals + (size_t)b * 3 * mn;
  for (size_t e = e0 + tid; e < e1; e += kEntryThreads) {
    const int a = (int)(e / n), j = (int)(e % n);
    const int ai = anc_i[a];
    const float v0 = sub(S[3 * j], anc[4 * a]), v1 = sub(S[3 * j + 1], anc[4 * a + 1]);
    const float w0 = sub(T[3 * j], anc[4 * a + 2]), w1 = sub(T[3 * j + 1], anc[4 * a + 3]);
    const float cross = sub(mul(v0, w1), mul(v1, w0));
    const float dot = add(mul(v0, w0), mul(v1, w1));
    const float ang = atan2f(cross, dot);
    const float blen = __fsqrt_rn(add(mul(v0, v0), mul(v1, v1)));
    const bool edge = A[(size_t)ai * n + j] && msk[ai] && msk[j];
    const float wgt = (edge && blen > p.min_baseline) ? fminf(blen, p.max_weight) : 0.0f;
    const int bin = (int)clamp(mul(add(ang, kPi), p.bin_scale), 0.0f, (float)(p.bins - 1));
    const float norm = clamp_min(__fsqrt_rn(add(mul(cross, cross), mul(dot, dot))), kTiny);
    I[e] = wgt > 0.0f ? bin : p.bins;
    V[e] = wgt;
    V[mn + e] = dvd(mul(wgt, cross), norm);
    V[2 * mn + e] = dvd(mul(wgt, dot), norm);
  }
}

// ------------------------------------------------------------ translation

struct TransParams {
  int n, p, words;    // points, 2N padded to a power of two, prefix words
  int bins, modes, cand, min_votes;
  float inv_bin, radius;
  int want_masks;
};

// The block's minimum of one 64-bit key a thread; every thread gets it.
// mins: 32 words of shared memory, free again when it returns.
__device__ unsigned long long block_min(unsigned long long v, unsigned long long* mins) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) mins[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? mins[lane] : ~0ull;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) mins[0] = v;
  }
  __syncthreads();
  v = mins[0];
  __syncthreads();
  return v;
}

// torch.argmax over s[0..bins): the first maximum, NaN the largest
__device__ int first_argmax(const float* s, int bins) {
  int best = 0;
  for (int k = 1; k < bins; ++k) {
    const float v = s[k], bv = s[best];
    if (isnan(bv)) break;
    if (isnan(v) || v > bv) best = k;
  }
  return best;
}

// int64 floor(x) + 512 clamped to 10 bits, as torch's chain on the card
// (static_cast of a float to int64 saturates, NaN to 0; the int64 sum wraps)
__device__ __forceinline__ long long grid_q(float x) {
  const long long f = (long long)floorf(x);
  const long long q = (long long)((unsigned long long)f + (unsigned long long)kQHalf);
  return q < 0 ? 0 : (q > (1 << kQBits) - 1 ? (1 << kQBits) - 1 : q);
}

__global__ void __launch_bounds__(kThreads)
vote_translation_kernel(const float* __restrict__ hist, const float* __restrict__ yaw_in,
                        const float* __restrict__ src, const float* __restrict__ tgt,
                        const bool* __restrict__ mask, const float* __restrict__ scale,
                        TransParams p, float* __restrict__ yaw_out, bool* __restrict__ masks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int n = p.n, m2 = 2 * n;
  __shared__ float yaw_s;
  if (hist != nullptr) {
    // the yaw modes: the smoothed votes in shared memory
    float* s = reinterpret_cast<float*>(smem);
    const float* H = hist + (size_t)b * p.bins * 3;
    for (int k = tid; k < p.bins; k += kThreads) {
      const float v = H[3 * k], vm = H[3 * ((k + p.bins - 1) % p.bins)],
                  vp = H[3 * ((k + 1) % p.bins)];
      s[k] = add(add(v, vm), vp);
    }
    __syncthreads();
    if (tid == 0) {
      int bm = 0;
      for (int q = 0; q <= r; ++q) {
        bm = first_argmax(s, p.bins);
        if (q == r) break;
        for (int k = 0; k < p.bins; ++k) {
          int d = (k - bm + p.bins / 2) % p.bins;
          if (d < 0) d += p.bins;
          d = abs(d - p.bins / 2);
          if (d <= 2) s[k] = -1.0f;
        }
      }
      const int up = (bm + 1) % p.bins, dn = (bm + p.bins - 1) % p.bins;
      const float w1 = add(add(H[3 * bm + 1], H[3 * up + 1]), H[3 * dn + 1]);
      const float w2 = add(add(H[3 * bm + 2], H[3 * up + 2]), H[3 * dn + 2]);
      yaw_s = atan2f(w1, w2);
      yaw_out[(size_t)b * p.modes + r] = yaw_s;
    }
  } else if (tid == 0) {
    yaw_s = yaw_in[(size_t)b * p.modes + r];
    yaw_out[(size_t)b * p.modes + r] = yaw_s;
  }
  __syncthreads();
  if (!p.want_masks) return;

  // shared memory: t (3 x N), the sorted keys (p), the rank keys (p), the
  // chosen rank keys (cand), the run starts (2N + 1 ints), the prefix's
  // level words (3 rows), the chosen runs' means and flags
  float* tt = reinterpret_cast<float*>(smem);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(tt + 3 * ((n + 1) & ~1));
  unsigned long long* rk = keys + p.p;
  unsigned long long* chosen = rk + p.p;      // the cand smallest rank keys
  int* starts = reinterpret_cast<int*>(chosen + p.cand);
  float* lv = reinterpret_cast<float*>(starts + m2 + 2);
  float* mean = lv + 3 * p.words;             // 3 x cand
  int* got = reinterpret_cast<int*>(mean + 3 * p.cand);
  __shared__ int warp_sums[32];
  __shared__ unsigned long long mins[32];
  __shared__ int nstarts;

  const float yaw = yaw_s;
  const float c = cosf(yaw), sn = sinf(yaw);
  const float R[3][3] = {{c, -sn, 0.0f}, {sn, c, 0.0f}, {0.0f, 0.0f, 1.0f}};
  const float sc = scale[b];
  const float* S = src + (size_t)b * n * 3;
  const float* T = tgt + (size_t)b * n * 3;
  const bool* Mk = mask + (size_t)b * n;
  for (int i = tid; i < n; i += kThreads) {
    const float p0 = S[3 * i], p1 = S[3 * i + 1], p2 = S[3 * i + 2];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float rot = add(add(mul(p0, R[d][0]), mul(p1, R[d][1])), mul(p2, R[d][2]));
      tt[d * n + i] = sub(T[3 * i + d], mul(sc, rot));
    }
  }
  __syncthreads();
  // the 2N keys of both grids, sorted stably by (key, index)
  for (int e = tid; e < p.p; e += kThreads) {
    unsigned long long key = ~0ull;
    if (e < m2) {
      const int i = e < n ? e : e - n;
      long long k = kSentinel;
      if (Mk[i]) {
        const float off = e < n ? 0.0f : 0.5f;
        long long q[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) q[d] = grid_q(add(mul(tt[d * n + i], p.inv_bin), off));
        k = (q[0] << (2 * kQBits)) + (q[1] << kQBits) + q[2] + (e < n ? 0 : (1ll << (3 * kQBits)));
      }
      key = (unsigned long long)k << kRankBits | (unsigned)e;
    }
    keys[e] = key;
  }
  __syncthreads();
  sort::bitonic_sort(keys, p.p);
  auto key_at = [&](int e) { return (long long)(keys[e] >> kRankBits); };
  auto is_new = [&](int e) {
    const long long k = key_at(e);
    return k != kSentinel && (e == 0 || k != key_at(e - 1));
  };

  // the run starts in order (a block scan over chunks of positions)
  const int per = (m2 + kThreads - 1) / kThreads;
  const int lo = tid * per, hi = min(m2, lo + per);
  int mine = 0;
  for (int e = lo; e < hi; ++e) mine += is_new(e);
  int total;
  int at = scan::block_exclusive_scan(mine, warp_sums, &total);
  for (int e = lo; e < hi; ++e)
    if (is_new(e)) starts[at++] = e;
  if (tid == 0) nstarts = total;
  __syncthreads();
  const int ns = nstarts;
  // occupancy rank keys of the runs of min_votes or more; the run's length
  // rides in the low word
  for (int e = tid; e < p.p; e += kThreads) {
    unsigned long long key = ~0ull;
    if (e < ns) {
      const int pos = starts[e];
      const int len = (e + 1 < ns ? starts[e + 1] : m2) - pos;
      if (len >= p.min_votes) {
        const long long rank =
            ((long long)(kRankMax - min(len, kRankMax)) << kRankBits) + min(pos, kRankMax);
        key = (unsigned long long)rank << 32 | (unsigned)len;
      }
    }
    rk[e] = key;
  }
  // the cand smallest rank keys in order (all distinct but the empty
  // ~0): a block minimum each, taken out after it is chosen
  for (int q = 0; q < p.cand; ++q) {
    unsigned long long best = ~0ull;
    for (int e = tid; e < ns; e += kThreads) best = min(best, rk[e]);
    best = block_min(best, mins);
    if (tid == 0) chosen[q] = best;
    if (best != ~0ull)
      for (int e = tid; e < ns; e += kThreads)
        if (rk[e] == best) rk[e] = ~0ull;
  }
  __syncthreads();

  // level 0 of the three rows' prefix: each block of 16's total, the
  // rows t_s = t[order mod N]
  auto ts = [&](int d, int e) {
    const int o = (int)(keys[e] & kRankMax);
    return tt[d * n + (o < n ? o : o - n)];
  };
  const int m1 = (m2 + scan::kScanBlock - 1) / scan::kScanBlock;
  for (int q = tid; q < m1; q += kThreads) {
    const int stop = min(m2, (q + 1) * scan::kScanBlock);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float acc = ts(d, q * scan::kScanBlock);
      for (int e = q * scan::kScanBlock + 1; e < stop; ++e) acc = add(acc, ts(d, e));
      lv[d * p.words + q] = acc;
    }
  }
  __syncthreads();
  scan::scan_levels(lv, p.words, 3, m1, [](const float* a) { return *a; });
  // prefix_sum(t_s)[d][e]
  auto prefix = [&](int d, int e) {
    const int b0 = e - e % scan::kScanBlock;
    float acc = ts(d, b0);
    for (int q = b0 + 1; q <= e; ++q) acc = add(acc, ts(d, q));
    return scan::prefix_at(acc, lv + d * p.words, m2, e);
  };
  for (int q = tid; q < p.cand; q += kThreads) {
    const unsigned long long key = chosen[q];
    const bool g = key != ~0ull;
    const int st = g ? (int)((key >> 32) & kRankMax) : 0;
    const int cnt = g ? (int)(key & 0xffffffffu) : 0;
    const int end = st + cnt;
    const int hi_i = min(max(end - 1, 0), m2 - 1);
    const int lo_i = max(st - 1, 0);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float h = prefix(d, hi_i);
      const float l = st > 0 ? prefix(d, lo_i) : 0.0f;
      mean[d * p.cand + q] = dvd(sub(h, l), (float)max(cnt, 1));
    }
    got[q] = g;
  }
  __syncthreads();
  bool* out = masks + ((size_t)b * p.modes + r) * p.cand * n;
  for (size_t e = tid; e < (size_t)p.cand * n; e += kThreads) {
    const int q = (int)(e / n), i = (int)(e % n);
    bool close = true;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      close = close && fabsf(sub(tt[d * n + i], mean[d * p.cand + q])) <= p.radius;
    out[e] = close && Mk[i] && got[q];
  }
}

inline int pow2_at_least(int v) {
  int q = 1;
  while (q < v) q <<= 1;
  return q;
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

}  // namespace vote
}  // namespace quatro

// src, tgt (bsz, n, 3), mask (bsz, n), adj (bsz, n, n) -> ids (bsz, m n),
// vals (bsz, 3, m n); m = min(num_anchors, n), n <= 4096; aligned: adj's
// address is a multiple of 16
extern "C" int quatro_vote_entries(const float* src, const float* tgt, const bool* mask,
                                   const bool* adj, int bsz, int n, int m, int bins,
                                   float min_baseline, float max_weight, float bin_scale,
                                   int aligned, int* ids, float* vals, cudaStream_t stream) {
  using namespace quatro::vote;
  if (bsz == 0 || n == 0) return 0;
  const int vec = aligned && (n % 16) == 0;
  EntryParams p{n, m, bins, min_baseline, max_weight, bin_scale, vec};
  const int smem = 8 * n + ((n + 15) & ~15) + 4 * ((m + 3) & ~3) + 16 * m;
  cudaError_t err = cudaFuncSetAttribute(vote_entries_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(bsz * kCluster), 1, 1);
  cfg.blockDim = dim3((unsigned)kEntryThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, vote_entries_kernel, src, tgt, mask, adj, p, ids, vals);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// hist (bsz, bins, 3) or null, then yaw_in (bsz, modes); src, tgt (bsz, n,
// 3), mask (bsz, n), scale (bsz,) -> yaw_out (bsz, modes) and, with
// want_masks, masks (bsz, modes, cand, n); n <= 2048
extern "C" int quatro_vote_translation(const float* hist, const float* yaw_in, const float* src,
                                       const float* tgt, const bool* mask, const float* scale,
                                       int bsz, int n, int bins, int modes, int cand,
                                       int min_votes, float inv_bin, float radius,
                                       int want_masks, float* yaw_out, bool* masks,
                                       cudaStream_t stream) {
  using namespace quatro::vote;
  if (bsz == 0 || modes == 0) return 0;
  TransParams p{n, pow2_at_least(2 * n), level_words(2 * n), bins, modes, cand, min_votes,
                inv_bin, radius, want_masks};
  int smem = 4 * bins;
  if (want_masks) {
    const int t_words = 3 * ((n + 1) & ~1);
    const int need = 4 * t_words + 16 * p.p + 8 * cand + 4 * (2 * n + 2) + 4 * 3 * p.words +
                     4 * 3 * cand + 4 * cand;
    smem = need > smem ? need : smem;
  }
  cudaError_t err = cudaFuncSetAttribute(vote_translation_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(modes, bsz);
  vote_translation_kernel<<<grid, kThreads, smem, stream>>>(hist, yaw_in, src, tgt, mask, scale,
                                                            p, yaw_out, masks);
  return (int)cudaGetLastError();
}
