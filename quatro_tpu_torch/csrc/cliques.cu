// The clique stage of the solver on a bit-packed consistency graph: the
// k-core search, the greedy growth, the (1,2)-swap and the distinct-clique
// greedy, one launch each for every pair of a batch.
//
// Replaces no pl.pallas_call: the JAX package runs these as lax.while_loop
// and lax.fori_loop over XLA fusions (quatro_tpu/solver/clique.py):
//   kcore_kernel     max_kcore, its peel (:43-62) inside the binary search
//                    (:65-99), and _count_mm(adj, mask), the seed scores'
//                    degree term (:396, :471);
//   grow_*_kernel    grow_greedy_cliques (:102-193), both phases;
//   swap_kernel      improve_top_cliques (:273-285) over
//                    improve_cliques_1swap (:196-270);
//   distinct_kernel  top_distinct_cliques (:400-450).
// Each gives the bits of its plain version in
// quatro_tpu_torch/ops/cliques.py (the torch device loops these replace):
// every degree is an exact integer count (a popcount of 32-bit words), and
// every decision that the plain version takes in f32 is taken on the same
// f32 values (deg + tiebreak by __fadd_rn, the distinct test by __fmul_rn,
// the early-completion test on counts that f32 holds exactly while a
// candidate set has at most 4096 vertices). Ties break as torch.argmax and
// stable sorts do: the first maximum, the lower index. No float atomics;
// a run repeats bit for bit.
//
// The graph. clique_pack_kernel packs the (B, N, N) bool adjacency once
// into rows[b][i][w] (bit t: adj[i][32 w + t]) and cols[b][j][w] (bit t:
// adj[32 w + t][j]), W = ceil(N / 32) words a row, 128 KB a pair at N =
// 1024. The growth counts a candidate's degree down a column (cand @ adj);
// every other count is along a row.
//
// Layout: the k-core search, the swaps and the distinct greedy take one
// block of 1024 threads a pair. Where the packed rows fit in the block's
// shared memory (at a row stride of W | 1 words, so that 32 lanes reading
// 32 rows at one word hit 32 banks), the block stages them there; else it
// reads them from device memory through L2 (use_smem 0): the same bits
// either way. quatro_clique_smem reports both sizes and the card's limit.
// The growth takes a block a (pair, seed) over three launches and reads
// the packed rows and columns through L1 / L2 at any N (see its section
// below).
//
// Bound on the card: the bool adjacency read once by the pack (N^2 bytes a
// pair) dominates the bytes; the loops after it are dependent chains of
// rounds (a peel round, a growth round, a swap round). The k-core search
// and the swaps run one block a pair, so at path A one SM of 132 works
// there; the growth's 128 seeds take 128 SMs.
#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace quatro {
namespace clq {

constexpr int kThreads = 1024;              // threads a block (one pair)
constexpr int kWarps = kThreads / 32;
constexpr int kPackWarps = 8;               // 32 x 32 tiles a pack block
constexpr int kSwapCand = 128;              // the swap's k_cand
constexpr int kStaticReserve = 1024;        // static shared of a kernel
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int words_of(int n) { return (n + 31) >> 5; }
// odd: rows i .. i + 31 at one word fall in 32 distinct banks
__host__ __device__ __forceinline__ int smem_stride(int w) { return w | 1; }

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ long long warp_sum_ll(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int block_max(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int k = 1; k < kWarps; ++k) v = max(v, red[k]);
  __syncthreads();
  return v;
}

__device__ __forceinline__ bool bit_of(const uint32_t* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// The packed rows at their stride: staged into shared memory (use_smem),
// or the device rows themselves.
__device__ const uint32_t* stage_rows(const uint32_t* g, int n, int w, uint32_t* smem,
                                      int use_smem) {
  if (!use_smem) return g;
  const int rs = smem_stride(w);
  for (int k = threadIdx.x; k < n * w; k += kThreads) {
    const int i = k / w;
    smem[i * rs + (k - i * w)] = g[k];
  }
  return smem;
}

// ------------------------------------------------------------------ pack --

// One warp a 32 x 32 tile: lane l reads column c0 + l of the tile's 32 rows
// (one byte each), its column word directly and each row word by a ballot.
__global__ void __launch_bounds__(32 * kPackWarps)
clique_pack_kernel(const unsigned char* __restrict__ adj, int n, uint32_t* __restrict__ rows,
                   uint32_t* __restrict__ cols) {
  const int w = words_of(n);
  const int tile = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (tile >= w * w) return;                 // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const int tr = tile / w, tc = tile - (tile / w) * w;
  const int r0 = 32 * tr, c = 32 * tc + lane;
  const unsigned char* a = adj + (size_t)blockIdx.y * n * n;
  uint32_t colw = 0u, roww = 0u;
#pragma unroll 8
  for (int rr = 0; rr < 32; ++rr) {
    const int r = r0 + rr;
    const bool v = r < n && c < n && a[(size_t)r * n + c] != 0;
    colw |= (uint32_t)v << rr;
    const uint32_t word = __ballot_sync(kFull, v);
    if (lane == rr) roww = word;
  }
  const size_t base = (size_t)blockIdx.y * n * w;
  if (r0 + lane < n) rows[base + (size_t)(r0 + lane) * w + tc] = roww;
  if (c < n) cols[base + (size_t)c * w + tr] = colw;
}

// ----------------------------------------------------------- k-core search --

// Per pair: deg = the row counts over the mask (_count_mm(adj, mask)); hi =
// their largest over the mask; the binary search lo < hi over k, each probe
// mid = (lo + hi + 1) / 2 peeling from the best core so far (every alive
// vertex with fewer than mid alive neighbours dropped, all at once, to the
// fixed point), lo = mid and best = the core where it is non-empty, else hi
// = mid - 1. Outputs lo, the best core and deg.
__global__ void __launch_bounds__(kThreads)
kcore_kernel(const uint32_t* __restrict__ rows_g, const unsigned char* __restrict__ mask, int n,
             int use_smem, long long* __restrict__ lo_out, unsigned char* __restrict__ core_out,
             float* __restrict__ deg_out) {
  extern __shared__ uint32_t sm[];
  __shared__ int red[kWarps];
  const int b = blockIdx.x, w = words_of(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* best = sm + (use_smem ? n * smem_stride(w) : 0);
  uint32_t* cur = best + w;
  uint32_t* nxt = cur + w;
  const uint32_t* R = stage_rows(rows_g + (size_t)b * n * w, n, w, sm, use_smem);
  const int rs = use_smem ? smem_stride(w) : w;
  mask += (size_t)b * n;
  for (int wd = warp; wd < w; wd += kWarps) {
    const int i = 32 * wd + lane;
    const uint32_t word = __ballot_sync(kFull, i < n && mask[i] != 0);
    if (lane == 0) best[wd] = word;
  }
  __syncthreads();
  int hi = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const uint32_t* ri = R + (size_t)i * rs;
    int d = 0;
    for (int k = 0; k < w; ++k) d += __popc(ri[k] & best[k]);
    deg_out[(size_t)b * n + i] = (float)d;
    if (bit_of(best, i)) hi = max(hi, d);
  }
  hi = block_max(hi, red);
  int lo = 0;
  while (lo < hi) {                          // block-uniform
    const int mid = (lo + hi + 1) >> 1;
    for (int k = threadIdx.x; k < w; k += kThreads) cur[k] = best[k];
    __syncthreads();
    uint32_t *c = cur, *x = nxt;
    for (;;) {
      int changed = 0;
      for (int wd = warp; wd < w; wd += kWarps) {
        const uint32_t cw = c[wd];
        const int i = 32 * wd + lane;
        bool keep = false;
        if ((cw >> lane) & 1u) {
          const uint32_t* ri = R + (size_t)i * rs;
          int d = 0;
          for (int k = 0; k < w && d < mid; ++k) {
            const uint32_t ck = c[k];
            if (ck) d += __popc(ri[k] & ck);
          }
          keep = d >= mid;
        }
        const uint32_t nw = __ballot_sync(kFull, keep);
        if (lane == 0) x[wd] = nw;
        changed |= nw != cw;
      }
      const int any = __syncthreads_or(changed);
      uint32_t* t = c;
      c = x;
      x = t;
      if (!any) break;
    }
    int nonempty = 0;
    for (int k = threadIdx.x; k < w; k += kThreads) nonempty |= c[k] != 0u;
    if (__syncthreads_or(nonempty)) {
      lo = mid;
      for (int k = threadIdx.x; k < w; k += kThreads) best[k] = c[k];
    } else {
      hi = mid - 1;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += kThreads)
    core_out[(size_t)b * n + i] = (unsigned char)bit_of(best, i);
  if (threadIdx.x == 0) lo_out[b] = lo;
}

// ------------------------------------------------------------------ growth --

// The growth in three launches, spread over the card:
//   grow_seeds_kernel   the seeds: a block a pair selects the num_seeds
//                       best masked scores (a radix selection) and ranks
//                       them among themselves;
//   grow_phase1_kernel  a block of 256 or 128 threads a (pair, seed): the rounds
//                       up to phase 1's limit (or all of them in one
//                       phase), its state saved to the scratch;
//   grow_phase2_kernel  a block a (pair, seed): the seed's rank among the
//                       candidates left (stable descending, an O(S) count
//                       of its own), the survivors' rounds on to max_size -
//                       1, every seed's clique written.
// A round splits its candidates over the block's warps, a warp a word of
// the candidate bits and a lane a candidate j: the lane counts |cand &
// column j| over the W words, 16 bytes a load (4 bytes where W is no
// multiple of 4), the loads independent of each other. The packed columns
// are read through L1 and L2, not staged: a round reads only its
// candidates' columns, and at N = 1024 a pair's 128 KB of columns stay in
// L1 across the rounds; the candidate and clique bits (2 W words) sit in
// shared
// memory at any N, so no global workspace is needed. The argmax is reduced
// in (score, lower index) order, and the edge sum is an exact 64-bit count,
// so the reduction's order changes no bit. The columns are always the pack
// kernel's, so no symmetry test runs.
// threads a seed's block: 256, or 128 where the batch's seeds outnumber
// four blocks an SM (more blocks an SM; on an NVIDIA H100 80GB HBM3 at
// 700 W, tests/torch_stage_busy.py: 64 pairs' 8192 seeds took 0.43 ms at
// 256 threads and 0.31 at 128, one pair's 128 seeds 0.059 and 0.074)
constexpr int kGrowThreads = 256;
constexpr int kGrowThreadsMany = 128;
constexpr int kGrowWarps = kGrowThreads / 32;
constexpr int kSeedThreads = 1024;           // threads a pair's seed selection
constexpr int kSeedInts = 6;                 // v, csize, rounds, sigma, kappa, promise

// A seed's growth state beside its bitsets: its vertex v, the f32 sum of
// its clique csize, its rounds, and v's own entries of the plain version's
// f32 candidate and clique vectors, sigma and kappa. Off v both vectors
// hold 0 or 1 (the bitsets cand and clq, which never hold v); a seed on a
// self loop starts with sigma = 1, and where it picks itself its entries
// leave {0, 1} (clique 2, candidate -1), as the plain version's do.
struct Seed {
  int v, csize, rounds, sigma, kappa;
};

// A seed score's place in torch.sort(descending=True, stable=True) order
// as an unsigned key, larger first: NaN first, -0.0 tied with +0.0.
__device__ __forceinline__ uint32_t desc_key(float f) {
  if (isnan(f)) return 0xffffffffu;
  if (f == 0.0f) f = 0.0f;
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Per pair (a block of kSeedThreads): seeds[rank] = i for the num_seeds
// vertices of least rank, the rank of i the count of vertices before it (a
// larger key, or an equal key at a lower index) among the scores, -inf off
// the mask. The num_seeds-th largest key by a radix selection (four passes
// of 8 bits, a shared histogram each), the vertices above it and the first
// of those equal to it (a block scan in index order) into `list` as (key,
// ~index), and each one's rank among them by a count: O(N) passes and
// O(num_seeds^2) compares, not O(N^2).
__device__ __forceinline__ uint32_t score_key(const float* scores, const unsigned char* mask,
                                              int j) {
  return desc_key(mask[j] ? scores[j] : -INFINITY);
}

__global__ void __launch_bounds__(kSeedThreads)
grow_seeds_kernel(const float* __restrict__ scores_g, const unsigned char* __restrict__ mask_g,
                  int n, int num_seeds, unsigned long long* __restrict__ list_g,
                  int* __restrict__ seeds) {
  __shared__ int hist[256];
  __shared__ int warp_tot[kSeedThreads / 32];
  __shared__ int digit_s, above_s, count_s;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* scores = scores_g + (size_t)b * n;
  const unsigned char* mask = mask_g + (size_t)b * n;
  unsigned long long* list = list_g + (size_t)b * num_seeds;
  // the num_seeds-th largest key, 8 bits at a time from the top; `want`
  // its place among the keys that share the bits decided so far
  uint32_t prefix = 0u, pmask = 0u;
  int want = num_seeds;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int t = tid; t < 256; t += kSeedThreads) hist[t] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kSeedThreads) {
      const uint32_t k = score_key(scores, mask, i);
      if ((k & pmask) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1);
    }
    __syncthreads();
    if (warp == 0) {           // lane l: digits 255 - 8 l ... 248 - 8 l
      int c[8], tot = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) tot += c[q] = hist[255 - 8 * lane - q];
      int incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      int run = incl - tot;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (run < want && want <= run + c[q]) {
          digit_s = 255 - 8 * lane - q;
          above_s = run;
        }
        run += c[q];
      }
    }
    __syncthreads();
    want -= above_s;
    prefix |= (uint32_t)digit_s << shift;
    pmask |= 255u << shift;
    __syncthreads();           // digit_s, above_s read before the next pass
  }
  // the keys above prefix, and the first `want` equal to it in index order
  if (tid == 0) count_s = 0;
  int taken = 0;               // equal keys before this chunk
  for (int base = 0; base < n; base += kSeedThreads) {
    const int i = base + tid;
    const uint32_t k = i < n ? score_key(scores, mask, i) : 0u;
    const bool eq = i < n && k == prefix;
    const unsigned bal = __ballot_sync(kFull, eq);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    int before = taken + __popc(bal & ((1u << lane) - 1u));
    int chunk = 0;
#pragma unroll
    for (int q = 0; q < kSeedThreads / 32; ++q) {
      before += q < warp ? warp_tot[q] : 0;
      chunk += warp_tot[q];
    }
    if (i < n && (k > prefix || (eq && before < want)))
      list[atomicAdd(&count_s, 1)] = ((unsigned long long)k << 32) | (0xffffffffu - (uint32_t)i);
    taken += chunk;
    __syncthreads();           // warp_tot read before the next chunk
  }
  __syncthreads();
  for (int e = tid; e < num_seeds; e += kSeedThreads) {
    const unsigned long long me = list[e];
    int rank = 0;
    for (int f = 0; f < num_seeds; ++f) rank += list[f] > me;
    seeds[(size_t)b * num_seeds + rank] = (int)(0xffffffffu - (uint32_t)me);
  }
}

// |column & cand| over W words by one lane (V4: 16 bytes a load)
template <bool V4>
__device__ __forceinline__ int col_count(const uint32_t* __restrict__ col, const uint32_t* cand,
                                         int w) {
  int d = 0;
  if (V4) {
    const uint4* c4 = reinterpret_cast<const uint4*>(col);
    const uint4* m4 = reinterpret_cast<const uint4*>(cand);
#pragma unroll 8
    for (int k = 0; k < (w >> 2); ++k) {
      const uint4 a = __ldg(c4 + k), m = m4[k];
      d += __popc(a.x & m.x) + __popc(a.y & m.y) + __popc(a.z & m.z) + __popc(a.w & m.w);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < w; ++k) d += __popc(__ldg(col + k) & cand[k]);
  }
  return d;
}

// (score, vertex) b after a: the larger score, the lower vertex on a tie
__device__ __forceinline__ bool better(float sb, int jb, float sa, int ja) {
  return sb > sa || (sb == sa && jb < ja);
}

struct GrowShared {
  long long esum[kGrowWarps];
  float best[kGrowWarps];
  int bj[kGrowWarps];
  int cnt[kGrowWarps];
};

// |cand| over the block, every thread given the sum
__device__ int block_popc(const uint32_t* cand, int w, GrowShared& red) {
  int c = 0;
  for (int k = threadIdx.x; k < w; k += blockDim.x) c += __popc(cand[k]);
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) red.cnt[threadIdx.x >> 5] = c;
  __syncthreads();
  int t = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) t += red.cnt[k];
  __syncthreads();
  return t;
}

// One seed's rounds by the whole block, from its candidate set cand and
// clique clq (W words each, in shared memory), while rounds < limit and
// its candidate sum |cand| + sigma is positive (past that no round changes
// its clique). A round, as _grow_round: raw_j = |cand & column j| + sigma
// adj[v][j], deg_j = raw_j for j in cand and sigma raw_v for v; a
// candidate set that is a clique (sum deg == csz (csz - 1)) with room
// under max_size is absorbed whole; else, below max_size, the first j of
// largest deg_j + tiebreak_j among the positive candidates joins and every
// candidate entry is multiplied by adj[j][.] and by 1 - its clique entry;
// at max_size the candidates empty. Returns the candidate sum at the end.
// R, C: the pair's packed rows and columns (W words a row).
template <bool V4>
__device__ int grow_rounds(const uint32_t* __restrict__ R, const uint32_t* __restrict__ C,
                           const float* __restrict__ tiebreak, int n, int w, int max_size,
                           int limit, uint32_t* cand, uint32_t* clq, Seed& st, GrowShared& red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t* rv = R + (size_t)st.v * w;
  const int vself = (int)bit_of(rv, st.v);
  int csz = block_popc(cand, w, red) + st.sigma;
  while (st.rounds < limit && csz > 0) {
    long long esum = 0;
    float best = -INFINITY;
    int bj = n;
    // the candidates, a warp a word (strided), a lane a set bit: the lane
    // counts its column over all W words, 16 bytes a load where W is a
    // multiple of 4, its loads independent of each other
    for (int wd = warp; wd < w; wd += (int)(blockDim.x >> 5)) {
      const uint32_t bits = cand[wd];
      if (!((bits >> lane) & 1u)) continue;
      const int j = 32 * wd + lane;
      const int d = st.sigma * (int)bit_of(rv, j) + col_count<V4>(C + (size_t)j * w, cand, w);
      esum += d;
      const float score = __fadd_rn((float)d, tiebreak[j]);
      if (better(score, j, best, bj)) {
        best = score;
        bj = j;
      }
    }
    if (st.sigma != 0 && warp == 0) {        // v's own candidate entry
      const uint32_t* cv = C + (size_t)st.v * w;
      int dv = 0;
      for (int k = lane; k < w; k += 32) dv += __popc(__ldg(cv + k) & cand[k]);
      const int deg_v = st.sigma * (warp_sum(dv) + st.sigma * vself);
      if (lane == 0) {
        esum += deg_v;
        const float score = __fadd_rn((float)deg_v, tiebreak[st.v]);
        if (st.sigma > 0 && better(score, st.v, best, bj)) {
          best = score;
          bj = st.v;
        }
      }
    }
    esum = warp_sum_ll(esum);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int oj = __shfl_xor_sync(kFull, bj, o);
      if (better(ob, oj, best, bj)) {
        best = ob;
        bj = oj;
      }
    }
    if (lane == 0) {
      red.esum[warp] = esum;
      red.best[warp] = best;
      red.bj[warp] = bj;
    }
    __syncthreads();
    esum = red.esum[0];
    best = red.best[0];
    bj = red.bj[0];
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
      esum += red.esum[k];
      if (better(red.best[k], red.bj[k], best, bj)) {
        best = red.best[k];
        bj = red.bj[k];
      }
    }
    int c = 0;
    if (esum == (long long)csz * (csz - 1) && (long long)st.csize + csz <= max_size) {
      for (int k = threadIdx.x; k < w; k += blockDim.x) {
        clq[k] |= cand[k];
        cand[k] = 0u;
      }
      st.csize += csz;
      st.kappa += st.sigma;
      st.sigma = 0;
    } else if (st.csize < max_size) {
      const bool self = bj == st.v;
      const uint32_t* rp = R + (size_t)bj * w;
      for (int k = threadIdx.x; k < w; k += blockDim.x) {
        const uint32_t q = clq[k] | (!self && k == (bj >> 5) ? 1u << (bj & 31) : 0u);
        const uint32_t nc = cand[k] & __ldg(rp + k) & ~q;
        clq[k] = q;
        cand[k] = nc;
        c += __popc(nc);
      }
      st.csize += 1;
      st.kappa += self;
      st.sigma *= (int)bit_of(rp, st.v) * (1 - st.kappa);
    } else {
      for (int k = threadIdx.x; k < w; k += blockDim.x) cand[k] = 0u;
      st.sigma = 0;
    }
    c = warp_sum(c);
    if (lane == 0) red.cnt[warp] = c;
    __syncthreads();
    csz = st.sigma;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) csz += red.cnt[k];
    ++st.rounds;
  }
  return csz;
}

// A seed's record in the scratch: cand, clq (W words each), then the Seed
// and its candidate sum.
__device__ void save_seed(uint32_t* rec, int w, const uint32_t* cand, const uint32_t* clq,
                          const Seed& st, int promise) {
  for (int k = threadIdx.x; k < w; k += blockDim.x) {
    rec[k] = cand[k];
    rec[w + k] = clq[k];
  }
  if (threadIdx.x == 0) {
    int* t = reinterpret_cast<int*>(rec + 2 * w);
    t[0] = st.v;
    t[1] = st.csize;
    t[2] = st.rounds;
    t[3] = st.sigma;
    t[4] = st.kappa;
    t[5] = promise;
  }
}

// A seed's clique as N bytes: the clique bits, and v where kappa > 0.
__device__ void write_clique(unsigned char* __restrict__ o, int n, const uint32_t* clq, int v,
                             int kappa) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    o[i] = (unsigned char)(i == v ? kappa > 0 : bit_of(clq, i));
}

// Block (s, b): seed s of pair b from its row and the mask; its rounds up
// to phase 1's limit (with two_phase; else max_size - 1 and its clique
// written); its record saved.
template <bool V4>
__global__ void __launch_bounds__(kGrowThreads)
grow_phase1_kernel(const uint32_t* __restrict__ rows_g, const uint32_t* __restrict__ cols_g,
                   const unsigned char* __restrict__ mask_g, const float* __restrict__ tiebreak,
                   const int* __restrict__ seeds, int n, int num_seeds, int max_size, int phase1,
                   int two_phase, uint32_t* __restrict__ scratch, unsigned char* __restrict__ out) {
  // cand and clq, W words each, 16-byte aligned
  extern __shared__ __align__(16) uint32_t gsm[];
  __shared__ GrowShared red;
  const int s = blockIdx.x, b = blockIdx.y, w = words_of(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* cand = gsm;
  uint32_t* clq = cand + ((w + 3) & ~3);
  const uint32_t* R = rows_g + (size_t)b * n * w;
  const uint32_t* C = cols_g + (size_t)b * n * w;
  const unsigned char* mask = mask_g + (size_t)b * n;
  const int v = seeds[(size_t)b * num_seeds + s];
  const uint32_t* rv = R + (size_t)v * w;
  for (int wd = warp; wd < w; wd += (int)(blockDim.x >> 5)) {
    const int i = 32 * wd + lane;
    const uint32_t mw = __ballot_sync(kFull, i < n && mask[i] != 0);
    if (lane == 0) {
      cand[wd] = __ldg(rv + wd) & mw & (wd == (v >> 5) ? ~(1u << (v & 31)) : kFull);
      clq[wd] = 0u;
    }
  }
  __syncthreads();
  Seed st = {v, 1, 0, (int)(bit_of(rv, v) && mask[v] != 0), 1};
  const int left = grow_rounds<V4>(R, C, tiebreak, n, w, max_size,
                                   two_phase ? phase1 : max_size - 1, cand, clq, st, red);
  if (two_phase) {
    const int rec_words = 2 * w + kSeedInts;
    save_seed(scratch + ((size_t)b * num_seeds + s) * rec_words, w, cand, clq, st, left);
  } else {
    write_clique(out + ((size_t)b * num_seeds + s) * n, n, clq, st.v, st.kappa);
  }
}

// Block (s, b): seed s's rank among the pair's seeds by the candidates
// left (stable descending); a survivor (rank < survivors) runs on to
// max_size - 1 rounds; every seed's clique written.
template <bool V4>
__global__ void __launch_bounds__(kGrowThreads)
grow_phase2_kernel(const uint32_t* __restrict__ rows_g, const uint32_t* __restrict__ cols_g,
                   const float* __restrict__ tiebreak, int n, int num_seeds, int max_size,
                   int survivors, const uint32_t* __restrict__ scratch,
                   unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t gsm[];
  __shared__ GrowShared red;
  const int s = blockIdx.x, b = blockIdx.y, w = words_of(n);
  const int rec_words = 2 * w + kSeedInts;
  const uint32_t* recs = scratch + (size_t)b * num_seeds * rec_words;
  const uint32_t* rec = recs + (size_t)s * rec_words;
  const int* t = reinterpret_cast<const int*>(rec + 2 * w);
  const int ps = t[5];
  int before = 0;
  for (int q = threadIdx.x; q < num_seeds; q += blockDim.x) {
    const int pq = reinterpret_cast<const int*>(recs + (size_t)q * rec_words + 2 * w)[5];
    before += pq > ps || (pq == ps && q < s);
  }
  before = warp_sum(before);
  if ((threadIdx.x & 31) == 0) red.cnt[threadIdx.x >> 5] = before;
  __syncthreads();
  int rank = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) rank += red.cnt[k];
  __syncthreads();
  unsigned char* o = out + ((size_t)b * num_seeds + s) * n;
  if (rank >= survivors) {
    write_clique(o, n, rec + w, t[0], t[4]);
    return;
  }
  uint32_t* cand = gsm;
  uint32_t* clq = cand + ((w + 3) & ~3);
  for (int k = threadIdx.x; k < w; k += blockDim.x) {
    cand[k] = rec[k];
    clq[k] = rec[w + k];
  }
  Seed st = {t[0], t[1], t[2], t[3], t[4]};
  __syncthreads();
  grow_rounds<V4>(rows_g + (size_t)b * n * w, cols_g + (size_t)b * n * w, tiebreak, n, w,
                  max_size, max_size - 1, cand, clq, st, red);
  write_clique(o, n, clq, st.v, st.kappa);
}

// -------------------------------------------------------------------- swap --

// Per pair: every row copied; the `top` largest rows (stable descending by
// size) each improved in turn, up to `rounds` rounds, stopping at the first
// round that moves nothing. A round, as _swap_round: s = |x|; for each j
// outside x and in the mask, cnt_j = |row j & x|; the first j with cnt_j ==
// s joins x; else among the first kSwapCand vertices with cnt_j == s - 1
// (in index order), each with u_j its first member not adjacent to it, the
// first pair (c1, c2) in row-major order with adj[v1][v2] and u_v1 == u_v2
// gives x - u + v1 + v2.
__global__ void __launch_bounds__(kThreads)
swap_kernel(const uint32_t* __restrict__ rows_g, const unsigned char* __restrict__ cliques,
            const unsigned char* __restrict__ mask_g, int n, int s_rows, int top, int rounds,
            int use_smem, unsigned char* __restrict__ out) {
  extern __shared__ uint32_t sm[];
  __shared__ int pair_best, m_count;
  const int b = blockIdx.x, w = words_of(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kc = min(kSwapCand, n);
  uint32_t* maskb = sm + (use_smem ? n * smem_stride(w) : 0);
  uint32_t* x = maskb + w;
  uint32_t* addb = x + w;
  uint32_t* missb = addb + w;
  int* uidx = reinterpret_cast<int*>(missb + w);
  int* cand = uidx + n;
  int* sizes = cand + kSwapCand;
  int* topi = sizes + s_rows;
  const uint32_t* R = stage_rows(rows_g + (size_t)b * n * w, n, w, sm, use_smem);
  const int rs = use_smem ? smem_stride(w) : w;
  const unsigned char* mask = mask_g + (size_t)b * n;
  cliques += (size_t)b * s_rows * n;
  out += (size_t)b * s_rows * n;
  for (int k = threadIdx.x; k < s_rows * n; k += kThreads) out[k] = cliques[k];
  for (int wd = warp; wd < w; wd += kWarps) {
    const int i = 32 * wd + lane;
    const uint32_t word = __ballot_sync(kFull, i < n && mask[i] != 0);
    if (lane == 0) maskb[wd] = word;
  }
  for (int r = warp; r < s_rows; r += kWarps) {
    int c = 0;
    for (int i = lane; i < n; i += 32) c += cliques[(size_t)r * n + i] != 0;
    c = warp_sum(c);
    if (lane == 0) sizes[r] = c;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < s_rows; r += kThreads) {
    const int sr = sizes[r];
    int rank = 0;
    for (int t = 0; t < s_rows; ++t) rank += sizes[t] > sr || (sizes[t] == sr && t < r);
    if (rank < top) topi[rank] = r;
  }
  __syncthreads();
  for (int t = 0; t < top; ++t) {
    const int row = topi[t];
    const unsigned char* xr = cliques + (size_t)row * n;
    for (int wd = warp; wd < w; wd += kWarps) {
      const int i = 32 * wd + lane;
      const uint32_t word = __ballot_sync(kFull, i < n && xr[i] != 0);
      if (lane == 0) x[wd] = word;
    }
    __syncthreads();
    for (int r = 0; r < rounds; ++r) {
      int sz = 0;
      for (int k = 0; k < w; ++k) sz += __popc(x[k]);
      for (int wd = warp; wd < w; wd += kWarps) {
        const int j = 32 * wd + lane;
        bool add = false, mis = false;
        if (((maskb[wd] & ~x[wd]) >> lane) & 1u) {
          const uint32_t* rj = R + (size_t)j * rs;
          int cnt = 0;
          for (int k = 0; k < w; ++k) cnt += __popc(rj[k] & x[k]);
          add = cnt == sz;
          mis = cnt == sz - 1;
          if (mis) {
            int u = 0;
            for (int k = 0; k < w; ++k) {
              const uint32_t d = x[k] & ~rj[k];
              if (d) {
                u = 32 * k + __ffs(d) - 1;
                break;
              }
            }
            uidx[j] = u;
          }
        }
        const uint32_t aw = __ballot_sync(kFull, add);
        const uint32_t mw = __ballot_sync(kFull, mis);
        if (lane == 0) {
          addb[wd] = aw;
          missb[wd] = mw;
        }
      }
      __syncthreads();
      int add_idx = -1;
      for (int k = 0; k < w; ++k)
        if (addb[k]) {
          add_idx = 32 * k + __ffs(addb[k]) - 1;
          break;
        }
      bool moved = true;
      if (add_idx >= 0) {
        if (threadIdx.x == 0) x[add_idx >> 5] |= 1u << (add_idx & 31);
      } else {
        if (warp == 0) {
          int base = 0;
          for (int g = 0; g < w && base < kc; g += 32) {
            const int k = g + lane;
            uint32_t mw = k < w ? missb[k] : 0u;
            const int c = __popc(mw);
            int incl = c;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const int y = __shfl_up_sync(kFull, incl, o);
              if (lane >= o) incl += y;
            }
            int pos = base + incl - c;
            while (mw && pos < kc) {
              cand[pos++] = 32 * k + __ffs(mw) - 1;
              mw &= mw - 1u;
            }
            base += __shfl_sync(kFull, incl, 31);
          }
          if (lane == 0) {
            m_count = min(base, kc);
            pair_best = INT_MAX;
          }
        }
        __syncthreads();
        const int m = m_count;
        for (int c1 = threadIdx.x; c1 < m; c1 += kThreads) {
          const int v1 = cand[c1], u1 = uidx[v1];
          const uint32_t* r1 = R + (size_t)v1 * rs;
          for (int c2 = 0; c2 < m; ++c2) {
            const int v2 = cand[c2];
            if (((r1[v2 >> 5] >> (v2 & 31)) & 1u) && uidx[v2] == u1) {
              atomicMin(&pair_best, c1 * kSwapCand + c2);
              break;
            }
          }
        }
        __syncthreads();
        const int pb = pair_best;
        moved = pb != INT_MAX;
        if (moved && threadIdx.x == 0) {
          const int v1 = cand[pb / kSwapCand], v2 = cand[pb % kSwapCand], u = uidx[v1];
          x[u >> 5] &= ~(1u << (u & 31));
          x[v1 >> 5] |= 1u << (v1 & 31);
          x[v2 >> 5] |= 1u << (v2 & 31);
        }
      }
      __syncthreads();
      if (!moved) break;
    }
    for (int i = threadIdx.x; i < n; i += kThreads)
      out[(size_t)row * n + i] = (unsigned char)bit_of(x, i);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- distinct --

// Per pair: the rows packed and counted; the stable descending order of
// their sizes (row 0's size + 1e9 first with force_first); the greedy over
// the sorted rows, taking row i while fewer than k are taken, no taken row t
// has |row i & row t| >= frac * max(min(size_t, size_i), 1) in f32, and
// size_i > 1; the picks are the taken rows, then the first untaken ones,
// k in all, with their sizes (0 past the taken count).
__global__ void __launch_bounds__(kThreads)
distinct_kernel(const unsigned char* __restrict__ cliques, int s_rows, int n, int k, float frac,
                int force_first, int use_smem, uint32_t* scratch, unsigned char* __restrict__ out,
                float* __restrict__ sizes_out) {
  extern __shared__ uint32_t sm[];
  __shared__ int count_s;
  const int b = blockIdx.x, w = words_of(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* P = use_smem ? sm : scratch + (size_t)b * s_rows * w;
  int* sizes = reinterpret_cast<int*>(sm + (use_smem ? s_rows * w : 0));
  int* order = sizes + s_rows;
  int* pick = order + s_rows;
  cliques += (size_t)b * s_rows * n;
  for (int r = warp; r < s_rows; r += kWarps) {
    const unsigned char* cr = cliques + (size_t)r * n;
    int c = 0;
    for (int wd = 0; wd < w; ++wd) {
      const int i = 32 * wd + lane;
      const uint32_t word = __ballot_sync(kFull, i < n && cr[i] != 0);
      if (lane == 0) P[(size_t)r * w + wd] = word;
      c += __popc(word);
    }
    if (lane == 0) sizes[r] = c;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < s_rows; r += kThreads) {
    const float kr = (force_first && r == 0) ? __fadd_rn((float)sizes[0], 1e9f) : (float)sizes[r];
    int rank = 0;
    for (int t = 0; t < s_rows; ++t) {
      const float kt = (force_first && t == 0) ? __fadd_rn((float)sizes[0], 1e9f) : (float)sizes[t];
      rank += kt > kr || (kt == kr && t < r);
    }
    order[rank] = r;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int i = 0; i < s_rows && count < k; ++i) {
      const int ri = order[i], si = sizes[ri];
      if (si <= 1) continue;
      const uint32_t* pi = P + (size_t)ri * w;
      bool conflict = false;
      for (int t = 0; t < count && !conflict; ++t) {
        const int rt = order[pick[t]];
        const uint32_t* pt = P + (size_t)rt * w;
        int c = 0;
        for (int wd = lane; wd < w; wd += 32) c += __popc(pi[wd] & pt[wd]);
        c = warp_sum(c);
        conflict = (float)c >= __fmul_rn(frac, fmaxf((float)min(sizes[rt], si), 1.0f));
      }
      if (!conflict) {
        if (lane == 0) pick[count] = i;
        ++count;
        __syncwarp();
      }
    }
    if (lane == 0) {
      count_s = count;
      int q = count, t = 0;
      for (int i = 0; i < s_rows && q < k; ++i) {
        if (t < count && pick[t] == i) {
          ++t;
          continue;
        }
        pick[q++] = i;
      }
    }
  }
  __syncthreads();
  const int count = count_s;
  unsigned char* o = out + (size_t)b * k * n;
  for (int idx = threadIdx.x; idx < k * n; idx += kThreads) {
    const int q = idx / n, i = idx - q * n;
    o[idx] = (unsigned char)(cliques[(size_t)order[pick[q]] * n + i] != 0);
  }
  for (int q = threadIdx.x; q < k; q += kThreads)
    sizes_out[(size_t)b * k + q] = q < count ? (float)sizes[order[pick[q]]] : 0.0f;
}

// Dynamic shared bytes of each kernel (kind 0 k-core, 1 growth, 2 swap, 3
// distinct) without the staged rows; the rows' bytes where they are staged.
inline long long base_smem(int kind, int n, int s, int k) {
  const long long w = words_of(n);
  switch (kind) {
    case 0: return 4 * (3 * w);
    case 1: return 4 * 2 * ((w + 3) & ~3LL);
    case 2: return 4 * (4 * w + n + kSwapCand + 2LL * s);
    default: return 4 * (2LL * s + k);
  }
}

inline long long rows_smem(int kind, int n, int s) {
  const long long w = words_of(n);
  return kind == 3 ? 4 * (long long)s * w : 4 * (long long)n * smem_stride((int)w);
}

template <typename K>
int set_smem(K kernel, long long bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

inline long long smem_bytes(int kind, int n, int s, int k, int use_smem) {
  return base_smem(kind, n, s, k) + (use_smem ? rows_smem(kind, n, s) : 0);
}

}  // namespace clq
}  // namespace quatro

using namespace quatro::clq;

// out[0]: dynamic shared bytes of kernel `kind` with the packed rows staged,
// out[1]: without them, out[2]: the card's limit for a block (its opt-in
// maximum less the kernels' static shared memory). s: seeds (growth), rows
// (swap, distinct); k: picks (distinct).
extern "C" int quatro_clique_smem(int kind, int n, int s, int k, int* out) {
  if (kind < 0 || kind > 3 || n <= 0 || s < 0 || k < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long with = smem_bytes(kind, n, s, k, 1), without = smem_bytes(kind, n, s, k, 0);
  out[0] = (int)(with < INT_MAX ? with : INT_MAX);
  out[1] = (int)(without < INT_MAX ? without : INT_MAX);
  out[2] = limit - kStaticReserve;
  return 0;
}

// adj (B, N, N) bool; rows, cols (B, N, W) uint32, W = ceil(N / 32).
extern "C" int quatro_clique_pack(const unsigned char* adj, int batch, int n, unsigned* rows,
                                  unsigned* cols, cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  const long long w = words_of(n);
  const dim3 grid((unsigned)((w * w + kPackWarps - 1) / kPackWarps), (unsigned)batch);
  clique_pack_kernel<<<grid, 32 * kPackWarps, 0, stream>>>(adj, n, rows, cols);
  return (int)cudaGetLastError();
}

// rows (B, N, W); mask (B, N) bool; lo (B,) int64, core (B, N) bool, deg
// (B, N) f32.
extern "C" int quatro_kcore_search(const unsigned* rows, const unsigned char* mask, int batch,
                                   int n, int use_smem, long long* lo, unsigned char* core,
                                   float* deg, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long bytes = smem_bytes(0, n, 0, 0, use_smem);
  int err = set_smem(kcore_kernel, bytes);
  if (err) return err;
  kcore_kernel<<<batch, kThreads, bytes, stream>>>(rows, mask, n, use_smem, lo, core, deg);
  return (int)cudaGetLastError();
}

// rows, cols (B, N, W); scores (B, N) f32; mask (B, N) bool; tiebreak (N,)
// f32; scratch B * num_seeds * (2 W + 9) + 1 uint32 (the seeds' records,
// the seeds, the selection's keys at an even word); out (B, num_seeds, N)
// bool. survivors 0 without two_phase. Two launches, or three with
// two_phase.
extern "C" int quatro_grow_cliques(const unsigned* rows, const unsigned* cols,
                                   const float* scores, const unsigned char* mask,
                                   const float* tiebreak, int batch, int n, int num_seeds,
                                   int max_size, int phase1_rounds, int survivors,
                                   int two_phase, unsigned* scratch, unsigned char* out,
                                   cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || num_seeds <= 0 || num_seeds > n || survivors > num_seeds ||
      survivors < 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const long long w = words_of(n);
  const long long bytes = base_smem(1, n, num_seeds, 0);
  const bool v4 = (w & 3) == 0;
  static int sms[64] = {0};
  int dev = 0;
  int err0 = (int)cudaGetDevice(&dev);
  if (err0) return err0;
  if (dev < 64 && sms[dev] == 0) {
    err0 = (int)cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err0) return err0;
  }
  const int sm = dev < 64 ? sms[dev] : 132;
  const int threads = (long long)batch * num_seeds > 4LL * sm ? kGrowThreadsMany : kGrowThreads;
  int err = v4 ? set_smem(grow_phase1_kernel<true>, bytes)
               : set_smem(grow_phase1_kernel<false>, bytes);
  if (!err && two_phase)
    err = v4 ? set_smem(grow_phase2_kernel<true>, bytes) : set_smem(grow_phase2_kernel<false>, bytes);
  if (err) return err;
  const size_t seeds_at = (size_t)batch * num_seeds * (2 * w + kSeedInts);
  int* seeds = reinterpret_cast<int*>(scratch + seeds_at);
  unsigned long long* list = reinterpret_cast<unsigned long long*>(
      scratch + ((seeds_at + (size_t)batch * num_seeds + 1) & ~(size_t)1));
  grow_seeds_kernel<<<batch, kSeedThreads, 0, stream>>>(scores, mask, n, num_seeds, list, seeds);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((unsigned)num_seeds, (unsigned)batch);
  if (v4)
    grow_phase1_kernel<true><<<grid, threads, bytes, stream>>>(
        rows, cols, mask, tiebreak, seeds, n, num_seeds, max_size, phase1_rounds, two_phase,
        scratch, out);
  else
    grow_phase1_kernel<false><<<grid, threads, bytes, stream>>>(
        rows, cols, mask, tiebreak, seeds, n, num_seeds, max_size, phase1_rounds, two_phase,
        scratch, out);
  err = (int)cudaGetLastError();
  if (err || !two_phase) return err;
  if (v4)
    grow_phase2_kernel<true><<<grid, threads, bytes, stream>>>(
        rows, cols, tiebreak, n, num_seeds, max_size, survivors, scratch, out);
  else
    grow_phase2_kernel<false><<<grid, threads, bytes, stream>>>(
        rows, cols, tiebreak, n, num_seeds, max_size, survivors, scratch, out);
  return (int)cudaGetLastError();
}

// rows (B, N, W); cliques, out (B, S, N) bool; mask (B, N) bool; top <= S.
extern "C" int quatro_swap_cliques(const unsigned* rows, const unsigned char* cliques,
                                   const unsigned char* mask, int batch, int n, int s_rows,
                                   int top, int rounds, int use_smem, unsigned char* out,
                                   cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || s_rows <= 0 || top < 0 || top > s_rows)
    return (int)cudaErrorInvalidValue;
  const long long bytes = smem_bytes(2, n, s_rows, 0, use_smem);
  int err = set_smem(swap_kernel, bytes);
  if (err) return err;
  swap_kernel<<<batch, kThreads, bytes, stream>>>(rows, cliques, mask, n, s_rows, top, rounds,
                                                  use_smem, out);
  return (int)cudaGetLastError();
}

// cliques (B, S, N) bool; scratch B * S * W uint32 (read where the rows are
// not staged); out (B, k, N) bool, sizes (B, k) f32; 0 < k <= S.
extern "C" int quatro_distinct_cliques(const unsigned char* cliques, int batch, int s_rows,
                                       int n, int k, float frac, int force_first, int use_smem,
                                       unsigned* scratch, unsigned char* out, float* sizes,
                                       cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || s_rows <= 0 || k <= 0 || k > s_rows)
    return (int)cudaErrorInvalidValue;
  const long long bytes = smem_bytes(3, n, s_rows, k, use_smem);
  int err = set_smem(distinct_kernel, bytes);
  if (err) return err;
  distinct_kernel<<<batch, kThreads, bytes, stream>>>(cliques, s_rows, n, k, frac, force_first,
                                                      use_smem, scratch, out, sizes);
  return (int)cudaGetLastError();
}
