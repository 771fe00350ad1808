// The fixed-radius K-capped neighbour lists of a batch of clouds: for every
// point, the K least keys (d2 bits, column) over all columns of its cloud.
//
// The counterpart of quatro_tpu/ops/neighbors.py:48-78 (radius_neighbors:
// a lax.map over row tiles of a Gram-identity distance block and one
// lax.top_k; no Pallas kernel there), bit for bit
// quatro_tpu_torch/ops/neighbors.py::radius_neighbors_plain.
//
// points (B, N, 3) f32, mask (B, N) bool -> idx (B, N, K) int32, valid
// (B, N, K) bool, d2 (B, N, K) f32. The keys are unique (column index in
// the low word), so the list is the K least keys in any order of
// insertion: lax.top_k's and torch.topk's selection with ties to the lower
// index, masked columns at the f32 maximum filling a row of fewer than K
// valid columns in index order, self first.
//
// Distances as ordered_sq_dists (the exact key): |p|^2 = fma(z, z, fma(y,
// y, x * x)) and the dot product alike, each fma as fused.fma forms it (the
// exact product in f64, one f64 addition, rounded to f32), then max((|a|^2
// + |b|^2) - 2 a.b, 0) with torch.clamp's NaN; the _rn intrinsics, never
// contracted.
//
// The warp routes (K <= 256), two launches:
// - knn_prep_kernel, the pre-pass: each column as float4 (x, y, z, |q|^2,
//   -1 where masked), and each tile of 32 columns' and each super tile of
//   8 tiles' AABB of its valid points, their largest |q|^2 and whether one
//   is unsafe (below);
// - radius_knn_kernel<S>: a warp takes a row and keeps its sorted list in
//   S = ceil(K / 32) slots a lane (slot 32 s + lane in list[s]; the K-th
//   key then sits in the last slot register, a constant). A block of 8
//   warps stages the cloud's bounds table in shared memory; then each warp
//   walks the super tiles on its own, no barrier: its own first, then
//   outwards (+1, -1, +2, ...), 32 at a time tested a lane a super tile at
//   the row's current K-th key (culling, below), each tested again before
//   it is opened; in an open super tile, its 8 tiles tested a lane a tile,
//   nearest the row first, each tested again before its columns are loaded
//   (one float4 a lane, from L2). A lane takes a column: the exact key only
//   where the f32 screen cannot rule the column out, and a key below the
//   list's K-th enters the list: up to kSeqMax keys a step one at a time
//   (a ballot a slot for the position, the slots above shifted up by one),
//   more by a bitonic sort across the warp and a merge into the list slot
//   by slot (the least 32 of the slot and the carried keys stay, the rest
//   carry up; a slot below the carried keys is untouched).
//
// The screen. a = sq3(sub(p - q)) in f32 (the differences, their squares,
// two additions, as tiles.cuh's sq3). With u = 2^-24, S = |p|^2 + |q|^2,
// D = |p - q|^2 and no overflow (|p|^2, |q|^2 <= 2^120), a <= D (1 +
// 5.01 u) (five roundings of non-negative terms) and the exact key's d >=
// (D - 7.11 u S)(1 - u) (|sq_norm - |x|^2| <= 3.01 u |x|^2, |dot - p.q|
// <= 3.01 u |p||q|, one rounding of the norms' sum and one of the
// difference): csrc/icp.cu's argument, the same arithmetic. So a column
// with a > thr = (dK + 2^-20 (|p|^2 + max |q|^2)) (1 + 2^-20) + 2^-100
// (dK the d2 of the row's K-th key, the norms in f32 and the maximum over
// the column's tile; the last term covers subnormal results) has an exact
// d2 strictly above dK and cannot enter the list. Where the list holds
// fewer than K keys, or its K-th d2 is the f32 maximum, an inf or a NaN,
// thr is +inf. A row or a tile with a norm past 2^120, an inf or a NaN
// (`unsafe`) takes every exact key.
//
// The culling. A row skips a column tile when both are safe and gap2 =
// sq3(max(0, lo - p, p - hi)) per axis of the tile's AABB is above thr. As
// in tiles.cuh, lo <= q_x gives sub(lo, p) <= sub(q, p) (rounding is
// monotone), likewise sub(p, hi) <= sub(p, q), so the gap lies in [0,
// |sub(p, q)|] on each axis and gap2 <= a for every valid column of the
// tile: no valid column of a skipped tile passes the screen. A masked
// column's key (f32 max, index) is above a K-th key whose d2 is below the
// f32 maximum, the only case where thr is finite; an empty tile's box is
// [+inf, -inf], so it is skipped then and only then.
// ops/neighbors.py::knn_tiles_culled mirrors the predicate.
//
// Bound on the card: the larger of the bytes (points and mask read, the
// lists written) and the distances of the (row, column) pairs in the tiles
// that the final lists do not cull (path A: under 5 % of the 8192^2
// pairs); the list insertions (shuffle chains) bound the kernel in
// practice.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "sort.cuh"

namespace quatro {
namespace knn {

constexpr int kWarps = 8;                           // warps a block of the warp routes
constexpr int kThreads = kWarps * 32;
constexpr int kTileCols = 32;                       // a column tile: one warp step
constexpr int kSeqMax = 4;                          // keys a step inserted one at a time
constexpr int kSuperTiles = 8;                      // tiles a super tile; warps a pre-pass block
constexpr int kBoundsCols = 8;                      // [lo x, y, z, max |q|^2, hi x, y, z, unsafe]
constexpr int kSmemTable = 200 * 1024;              // the bounds table in shared memory up to this
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFltMax = 3.40282346638528859812e+38f;
constexpr uint64_t kEmpty = ~0ull;
constexpr uint64_t kMaskedHi = (uint64_t)0x7f7fffffu << 32;  // a masked column's d2 word
constexpr float kSafeNorm = 0x1p120f;               // the screen's norm limit
constexpr float kSlack = 0x1p-20f;                  // 16 u

// fused.fma(a, b, c): the f32 product exact in f64, one f64 addition, then
// f32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return fma64(z, z, fma64(y, y, __fmul_rn(x, x)));
}

// ordered_sq_dists for one pair, given both squared norms and the y and z
// components in f64 (fma64's operands)
__device__ __forceinline__ float sq_dist(float ax, double ay, double az, float sqa, float bx,
                                         double by, double bz, float sqb) {
  const float t1 = __double2float_rn(__dadd_rn(__dmul_rn(ay, by), (double)__fmul_rn(ax, bx)));
  const float dot = __double2float_rn(__dadd_rn(__dmul_rn(az, bz), (double)t1));
  const float d = __fsub_rn(__fadd_rn(sqa, sqb), __fmul_rn(2.0f, dot));
  return (d != d) ? d : fmaxf(d, 0.0f);
}

// the exact key of the valid staged column q = (x, y, z, |q|^2), index j
__device__ __forceinline__ uint64_t exact_key(float px, float py, float pz, float sqp, float4 q,
                                              int j) {
  const float d2 = sq_dist(px, py, pz, sqp, q.x, q.y, q.z, q.w);
  return ((uint64_t)__float_as_uint(d2) << 32) | (uint32_t)j;
}

// the screen's threshold for a row whose K-th key is kth, against a tile
// whose valid points' largest |q|^2 is qmax (+inf where the list is open)
__device__ __forceinline__ float screen_thr(uint64_t kth, float sqp, float qmax) {
  const float dk = __uint_as_float((uint32_t)(kth >> 32));
  if (!(dk < kFltMax)) return CUDART_INF_F;  // not full, the f32 maximum, inf or NaN
  return add(mul(add(dk, mul(kSlack, add(sqp, qmax))), 1.0f + kSlack), 0x1p-100f);
}

// gap2 of the point p to the box [lo, hi], in the screen's sub/mul/add order
__device__ __forceinline__ float box_gap2(float px, float py, float pz, float4 lo, float4 hi) {
  const float gx = fmaxf(fmaxf(sub(lo.x, px), sub(px, hi.x)), 0.0f);
  const float gy = fmaxf(fmaxf(sub(lo.y, py), sub(py, hi.y)), 0.0f);
  const float gz = fmaxf(fmaxf(sub(lo.z, pz), sub(pz, hi.z)), 0.0f);
  return sq3(gx, gy, gz);
}

// whether a row (p, |p|^2, its K-th key) needs the column tile with the
// box [lo, hi] (lo.w its largest |q|^2, hi.w its unsafe flag)
__device__ __forceinline__ bool tile_needed(float px, float py, float pz, float sqp, bool safe,
                                            uint64_t kth, float4 lo, float4 hi) {
  return !safe || hi.w != 0.0f || box_gap2(px, py, pz, lo, hi) <= screen_thr(kth, sqp, lo.w);
}

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) { return a < b ? a : b; }
__device__ __forceinline__ uint64_t umax64(uint64_t a, uint64_t b) { return a < b ? b : a; }

// the K-th key of the list: slot k - 1, in the last slot register (the
// route takes S = ceil(K / 32) slots a lane, so the register is a
// constant: a slot chosen at run time would put the list in local memory)
template <int S>
__device__ __forceinline__ uint64_t kth_key(const uint64_t (&list)[S], int k) {
  return __shfl_sync(kFull, list[S - 1], (k - 1) & 31);
}

// one key a lane (kEmpty where none), sorted ascending across the warp by
// a bitonic network
__device__ __forceinline__ uint64_t warp_sort(uint64_t x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const bool low = ((lane & j) == 0) == ((lane & k) == 0);
      const uint64_t y = __shfl_xor_sync(kFull, x, j);
      x = low ? umin64(x, y) : umax64(x, y);
    }
  return x;
}

// 32 ascending keys (kEmpty past the candidates) into the sorted list,
// slot by slot: the least 32 of the slot and the carried keys stay (min of
// the slot and the carried keys reversed, a bitonic sequence, then
// sorted), the rest carry up; what carries past the last slot is dropped.
// A slot is untouched where nothing is left to place or the whole slot
// lies below the carried keys.
template <int S>
__device__ __forceinline__ void merge(uint64_t (&list)[S], uint64_t m, int lane) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const uint64_t least = __shfl_sync(kFull, m, 0);
    const uint64_t top = __shfl_sync(kFull, list[s], 31);
    if (least == kEmpty || top < least) continue;  // warp-uniform
    const uint64_t rev = __shfl_sync(kFull, m, 31 - lane);
    const uint64_t lo = umin64(list[s], rev);
    m = umax64(list[s], rev);
    list[s] = lo;
#pragma unroll
    for (int j = 16; j > 0; j >>= 1) {
      const bool low = (lane & j) == 0;
      const uint64_t a = __shfl_xor_sync(kFull, list[s], j);
      const uint64_t b = __shfl_xor_sync(kFull, m, j);
      list[s] = low ? umin64(list[s], a) : umax64(list[s], a);
      m = low ? umin64(m, b) : umax64(m, b);
    }
  }
}

// A step's keys (one a lane, kEmpty where none) into the list; kth its
// K-th key, kept current. Up to kSeqMax keys below the K-th enter one at a
// time (a ballot a slot for the position, the slots above it shifted up by
// one); more are sorted and merged at once.
template <int S>
__device__ __forceinline__ void insert(uint64_t (&list)[S], uint64_t& kth, uint64_t key, int k,
                                       int lane) {
  unsigned cand = __ballot_sync(kFull, key < kth);
  if (__popc(cand) > kSeqMax) {
    merge(list, warp_sort(((cand >> lane) & 1) ? key : kEmpty, lane), lane);
    kth = kth_key(list, k);
    return;
  }
  while (cand) {
    const uint64_t ck = __shfl_sync(kFull, key, __ffs(cand) - 1);
    cand &= cand - 1;
    if (!(ck < kth)) continue;  // the list moved past it (warp-uniform)
    int pos = 0;
    uint64_t up[S], last[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      pos += __popc(__ballot_sync(kFull, list[s] < ck));
      up[s] = __shfl_up_sync(kFull, list[s], 1);
      last[s] = __shfl_sync(kFull, list[s], 31);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int slot = 32 * s + lane;
      const uint64_t prev = (lane == 0) ? (s > 0 ? last[s - 1] : kEmpty) : up[s];
      list[s] = (slot < pos) ? list[s] : ((slot == pos) ? ck : prev);
    }
    kth = kth_key(list, k);
  }
}

// The pre-pass, a warp a tile of 32 columns and a block of 8 warps a
// super tile of 8 tiles. cols (B, N, 4): each column as (x, y, z, |q|^2 by
// sq_norm), |q|^2 -1 where masked. bounds (B, tiles + supers, 8): each
// tile's, then each super tile's, [lo x, lo y, lo z, max |q|^2, hi x, hi
// y, hi z, unsafe] over its valid points: lo +inf and hi -inf where none is
// valid; max |q|^2 0 if none; unsafe 1 where a valid point's |q|^2 is past
// 2^120 or NaN (an inf or NaN coordinate too), else 0. A super tile's box
// holds its tiles' boxes, so a row that skips it would skip each of them
// (the gap is monotone in the box, thr in max |q|^2). Grid (supers, B).
__global__ void __launch_bounds__(kSuperTiles * 32)
knn_prep_kernel(const float* __restrict__ pts, const bool* __restrict__ mask, int n, int tiles,
                float4* __restrict__ cols, float4* __restrict__ bounds) {
  __shared__ float4 box[kSuperTiles][2];
  const size_t b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int supers = (tiles + kSuperTiles - 1) / kSuperTiles;
  const int t = blockIdx.x * kSuperTiles + warp;
  const int i = t * kTileCols + lane;
  const bool in = i < n;
  const bool ok = in && mask[b * n + i];
  float q[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int d = 0; d < 3; ++d)
    if (in) q[d] = pts[(b * n + i) * 3 + d];
  const float nq = sq_norm(q[0], q[1], q[2]);
  if (in) cols[b * n + i] = make_float4(q[0], q[1], q[2], ok ? nq : -1.0f);
  float lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = ok ? q[d] : CUDART_INF_F;
    hi[d] = ok ? q[d] : -CUDART_INF_F;
  }
  const unsigned bad = __ballot_sync(kFull, ok && !(nq <= kSafeNorm));
  float qmax = ok ? nq : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmax = fmaxf(qmax, __shfl_xor_sync(kFull, qmax, off));
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], __shfl_xor_sync(kFull, lo[d], off));
      hi[d] = fmaxf(hi[d], __shfl_xor_sync(kFull, hi[d], off));
    }
  }
  float4* out = bounds + b * (size_t)(tiles + supers) * 2;
  if (lane == 0) {
    box[warp][0] = make_float4(lo[0], lo[1], lo[2], qmax);
    box[warp][1] = make_float4(hi[0], hi[1], hi[2], bad ? 1.0f : 0.0f);
    if (t < tiles) {
      out[2 * t] = box[warp][0];
      out[2 * t + 1] = box[warp][1];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float4 l = box[0][0], h = box[0][1];
    for (int w = 1; w < kSuperTiles; ++w) {
      const float4 a = box[w][0], c = box[w][1];
      l = make_float4(fminf(l.x, a.x), fminf(l.y, a.y), fminf(l.z, a.z), fmaxf(l.w, a.w));
      h = make_float4(fmaxf(h.x, c.x), fmaxf(h.y, c.y), fmaxf(h.z, c.z), fmaxf(h.w, c.w));
    }
    out[2 * (tiles + blockIdx.x)] = l;
    out[2 * (tiles + blockIdx.x) + 1] = h;
  }
}

// The warp routes: S slots a lane (K <= 32 S), a warp a row. grid
// (ceil(N / 8), B); dynamic shared memory: the cloud's bounds table where
// table_in_smem (32 bytes a tile and a super tile), else none (read from
// `bounds`). stats, where not null, gets the (row, column tile) pairs
// screened.
template <int S>
__global__ void __launch_bounds__(kThreads, 1)
radius_knn_kernel(const float4* __restrict__ cols, const bool* __restrict__ mask,
                  const float4* __restrict__ bounds, int n, int k, float r2, int table_in_smem,
                  int* __restrict__ idx_out, bool* __restrict__ valid_out,
                  float* __restrict__ d2_out, unsigned long long* __restrict__ stats) {
  extern __shared__ float4 smem_table[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t b = blockIdx.y;
  const int tiles = (n + kTileCols - 1) / kTileCols;
  const int supers = (tiles + kSuperTiles - 1) / kSuperTiles;
  const int row = blockIdx.x * kWarps + warp;
  const float4* C = cols + b * n;
  const float4* table = bounds + b * (size_t)(tiles + supers) * 2;
  if (table_in_smem) {
    for (int i = threadIdx.x; i < 2 * (tiles + supers); i += kThreads) smem_table[i] = table[i];
    table = smem_table;
  }
  __syncthreads();
  if (row >= n) return;  // warp-uniform; no barrier follows
  const float4* super = table + 2 * tiles;
  const float4 p = C[row];
  const float sqp = sq_norm(p.x, p.y, p.z);
  const bool safe = sqp <= kSafeNorm;
  uint64_t list[S], kth = kEmpty;
#pragma unroll
  for (int s = 0; s < S; ++s) list[s] = kEmpty;
  // whether the row needs the box [lo, hi] at its K-th key now
  const auto needs = [&](float4 lo, float4 hi) {
    return tile_needed(p.x, p.y, p.z, sqp, safe, kth, lo, hi);
  };
  unsigned long long screened = 0;
  const int own_t = row / kTileCols;
  const int own_u = own_t / kSuperTiles;
  // the super tiles outwards from the row's own (own, own + 1, own - 1,
  // ...): the own first, then 32 positions at a time, a lane a super tile
  // tested at the list's K-th key then, each tested again before its
  // tiles; a super tile's tiles nearest the row first (outwards from the
  // row's own tile in its own, upwards above it, downwards below), a lane
  // a tile tested at once, each tested again before its columns
  for (int first = 0; first < 2 * supers; first = first == 0 ? 1 : first + 32) {
    unsigned todo = 1u;  // position 0: the own super tile
    if (first > 0) {
      const int pos = first + lane;
      const int u = own_u + ((pos & 1) ? (pos + 1) / 2 : -(pos / 2));
      todo = __ballot_sync(kFull, u >= 0 && u < supers && needs(super[2 * u], super[2 * u + 1]));
    }
    while (todo) {
      const int l = __ffs(todo) - 1;
      todo &= todo - 1;
      const int pos = first + l;
      const int u = own_u + ((pos & 1) ? (pos + 1) / 2 : -(pos / 2));
      if (first > 0 && !needs(super[2 * u], super[2 * u + 1])) continue;  // warp-uniform
      const int t0 = u * kSuperTiles;
      const int ts = t0 + lane;
      const unsigned tiles_todo = __ballot_sync(
          kFull, lane < kSuperTiles && ts < tiles && needs(table[2 * ts], table[2 * ts + 1]));
      const int own_s = own_t - t0;
      for (int i = 0; i < 2 * kSuperTiles - 1; ++i) {
        const int s = u == own_u ? own_s + ((i & 1) ? (i + 1) / 2 : -(i / 2))
                                 : (u > own_u ? i : kSuperTiles - 1 - i);
        if (s < 0 || s >= kSuperTiles || !((tiles_todo >> s) & 1)) continue;  // warp-uniform
        const int t = t0 + s;
        const float4 lo = table[2 * t], hi = table[2 * t + 1];
        if (!needs(lo, hi)) continue;  // warp-uniform
        const int j = t * kTileCols + lane;
        const float4 q = j < n ? C[j] : make_float4(0.0f, 0.0f, 0.0f, -1.0f);
        uint64_t key = kEmpty;
        if (j < n) {
          if (q.w < 0.0f) {
            key = kMaskedHi | (uint32_t)j;
          } else if (!safe || hi.w != 0.0f ||
                     sq3(sub(p.x, q.x), sub(p.y, q.y), sub(p.z, q.z)) <=
                         screen_thr(kth, sqp, lo.w)) {
            key = exact_key(p.x, p.y, p.z, sqp, q, j);
          }
        }
        ++screened;
        insert(list, kth, key, k, lane);
      }
    }
  }
  if (stats != nullptr && lane == 0 && screened) atomicAdd(stats, screened);
  const bool rmask = mask[b * n + row];
  const size_t out = (b * n + row) * k;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = lane + 32 * s;
    const float d2 = __uint_as_float((uint32_t)(list[s] >> 32));
    if (slot < k) {
      idx_out[out + slot] = (int)(uint32_t)(list[s] & 0xffffffffu);
      d2_out[out + slot] = d2;
      valid_out[out + slot] = (d2 <= r2) && rmask;
    }
  }
}

// The block route past 256 slots (any K <= N): a block of 1024 threads a
// row at a time, the row's N keys (the warp route's, masked columns at the
// f32 maximum) in `keys` (pow2(N) 64-bit words a block, padded with the
// empty key: shared memory where it fits, else a global workspace),
// sorted bitonically (sort.cuh); the first K are the list.
constexpr int kSortThreads = 1024;

__global__ void __launch_bounds__(kSortThreads)
radius_knn_sort_kernel(const float* __restrict__ pts, const bool* __restrict__ mask, int bsz,
                       int n, int k, int pn, float r2, unsigned long long* __restrict__ work,
                       int* __restrict__ idx_out, bool* __restrict__ valid_out,
                       float* __restrict__ d2_out) {
  extern __shared__ unsigned long long smem_keys[];
  unsigned long long* keys = work ? work + (size_t)blockIdx.x * pn : smem_keys;
  const size_t rows = (size_t)bsz * n;
  for (size_t rr = blockIdx.x; rr < rows; rr += gridDim.x) {
    const size_t b = rr / n;
    const int row = (int)(rr % n);
    const float* P = pts + b * n * 3;
    const bool* M = mask + b * n;
    const float ax = P[3 * row], ay = P[3 * row + 1], az = P[3 * row + 2];
    const float sqa = sq_norm(ax, ay, az);
    const double ay_d = ay, az_d = az;
    __syncthreads();                        // the previous row's keys read
    for (int j = threadIdx.x; j < pn; j += kSortThreads) {
      uint64_t key = kEmpty;
      if (j < n) {
        const float x = P[3 * j], y = P[3 * j + 1], z = P[3 * j + 2];
        const float w = M[j] ? sq_norm(x, y, z) : -1.0f;
        const float d2 = (w < 0.0f) ? kFltMax : sq_dist(ax, ay_d, az_d, sqa, x, y, z, w);
        key = ((uint64_t)__float_as_uint(d2) << 32) | (uint32_t)j;
      }
      keys[j] = key;
    }
    __syncthreads();
    sort::bitonic_sort(keys, pn);
    const bool rmask = M[row];
    const size_t out = rr * k;
    for (int slot = threadIdx.x; slot < k; slot += kSortThreads) {
      const uint64_t key = keys[slot];
      const float d2 = __uint_as_float((uint32_t)(key >> 32));
      idx_out[out + slot] = (int)(uint32_t)(key & 0xffffffffu);
      d2_out[out + slot] = d2;
      valid_out[out + slot] = (d2 <= r2) && rmask;
    }
  }
}

template <int S>
int launch_lists(const float4* cols, const bool* mask, const float4* bounds, int bsz, int n,
                 int k, float r2, int* idx, bool* valid, float* d2, unsigned long long* stats,
                 cudaStream_t stream) {
  const int tiles = (n + kTileCols - 1) / kTileCols;
  const int supers = (tiles + kSuperTiles - 1) / kSuperTiles;
  const int table = (tiles + supers) * kBoundsCols * (int)sizeof(float);
  const int in_smem = table <= kSmemTable;
  const int smem = in_smem ? table : 0;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(radius_knn_kernel<S>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
  }
  dim3 grid((n + kWarps - 1) / kWarps, bsz);
  radius_knn_kernel<S><<<grid, kThreads, smem, stream>>>(cols, mask, bounds, n, k, r2, in_smem, idx,
                                                        valid, d2, stats);
  return (int)cudaGetLastError();
}

}  // namespace knn
}  // namespace quatro

// points (B, N, 3), mask (B, N) -> idx, valid, d2 (B, N, K); 1 <= K <= N
// (the wrapper checks). K <= 256: the pre-pass into `bounds` (B, tiles of
// 32 columns and super tiles of 8, 8) f32, then the warp route at S =
// ceil(K / 32) slots a lane, one row a warp; `stats`, where not
// null, a u64 that gets the (row, column tile) pairs screened. Above, the
// block route, its keys in `work` (blocks x pn 64-bit words, pn = N padded
// to a power of two) or, where work is null, in shared memory
// (quatro_knn_plan gives both); bounds and stats unused.
extern "C" int quatro_radius_knn(const float* pts, const bool* mask, int bsz, int n, int k,
                                 float r2, int* idx, bool* valid, float* d2, void* work,
                                 int blocks, float* cols, float* bounds,
                                 unsigned long long* stats, cudaStream_t stream) {
  using namespace quatro::knn;
  if (k <= 256) {
    const int tiles = (n + kTileCols - 1) / kTileCols;
    const int supers = (tiles + kSuperTiles - 1) / kSuperTiles;
    float4* c4 = reinterpret_cast<float4*>(cols);
    float4* b4 = reinterpret_cast<float4*>(bounds);
    knn_prep_kernel<<<dim3(supers, bsz), kSuperTiles * 32, 0, stream>>>(pts, mask, n, tiles, c4,
                                                                          b4);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
    switch ((k + 31) / 32) {
#define QUATRO_KNN_ROUTE(S)                                                                  \
  case S:                                                                                   \
    return launch_lists<S>(c4, mask, b4, bsz, n, k, r2, idx, valid, d2, stats, stream);
      QUATRO_KNN_ROUTE(1)
      QUATRO_KNN_ROUTE(2)
      QUATRO_KNN_ROUTE(3)
      QUATRO_KNN_ROUTE(4)
      QUATRO_KNN_ROUTE(5)
      QUATRO_KNN_ROUTE(6)
      QUATRO_KNN_ROUTE(7)
      QUATRO_KNN_ROUTE(8)
#undef QUATRO_KNN_ROUTE
    }
  }
  int pn = 1;
  while (pn < n) pn <<= 1;
  const int smem = work ? 0 : pn * 8;
  if (smem) {
    const int rc = (int)cudaFuncSetAttribute(radius_knn_sort_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
  }
  radius_knn_sort_kernel<<<blocks, kSortThreads, smem, stream>>>(
      pts, mask, bsz, n, k, pn, r2, static_cast<unsigned long long*>(work), idx, valid, d2);
  return (int)cudaGetLastError();
}
