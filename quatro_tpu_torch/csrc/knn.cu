// The fixed-radius K-capped neighbour lists of a batch of clouds: for every
// point, the K least keys (d2 bits, column) over all columns of its cloud.
//
// The counterpart of quatro_tpu/ops/neighbors.py:48-78 (radius_neighbors:
// a lax.map over row tiles of a Gram-identity distance block and one
// lax.top_k; no Pallas kernel there), bit for bit
// quatro_tpu_torch/ops/neighbors.py::radius_neighbors_plain.
//
// points (B, N, 3) f32, mask (B, N) bool -> idx (B, N, K) int32, valid
// (B, N, K) bool, d2 (B, N, K) f32. A warp a row, 16 rows a block; the
// block stages its cloud's columns through shared memory, 512 at a time,
// as (x, |q|^2) and (y, z) converted to f64 once (fma64's operands; -1 for
// |q|^2 marks a masked column), and
// starts at the chunk of its own rows (voxel clouds are in Morton order,
// so the first chunk already holds most neighbours and few later keys pass
// the list's last). Each lane takes a column of the chunk; a key below the
// list's K-th is inserted into the warp's sorted list of K <= 64 keys (two
// slots a lane) by a ballot and two shuffles up; K <= 128 or 256 take 4 or
// 8 slots a lane, larger K a block a row sorting all its keys (the JAX
// function takes any K <= N). The keys are unique
// (column index in the low word), so the list is the K least keys in any
// order of insertion: lax.top_k's and torch.topk's selection with ties to
// the lower index, masked columns at the f32 maximum filling a row of
// fewer than K valid columns in index order, self first.
//
// Distances as ordered_sq_dists: |p|^2 = fma(z, z, fma(y, y, x * x)) and
// the dot product alike, each fma as fused.fma forms it (the exact product
// in f64, one f64 addition, rounded to f32), then max((|a|^2 + |b|^2) -
// 2 a.b, 0) with torch.clamp's NaN; the _rn intrinsics, never contracted.
//
// Bound on the card: operations (path A: 8192^2 pairs of ~10 f32-rated
// operations each, 0.010 ms at 67 TFLOP/s); the four f32 <-> f64
// conversions a pair run at a quarter of the f32 rate and bound the
// kernel in practice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort.cuh"

namespace quatro {
namespace knn {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = kThreads;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFltMax = 3.40282346638528859812e+38f;
constexpr uint64_t kEmpty = ~0ull;

// fused.fma(a, b, c): the f32 product exact in f64, one f64 addition, then
// f32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return fma64(z, z, fma64(y, y, __fmul_rn(x, x)));
}

// ordered_sq_dists for one pair, given both squared norms and the y and z
// components in f64 (fma64's operands, converted once)
__device__ __forceinline__ float sq_dist(float ax, double ay, double az, float sqa, float bx,
                                         double by, double bz, float sqb) {
  const float t1 = __double2float_rn(__dadd_rn(__dmul_rn(ay, by), (double)__fmul_rn(ax, bx)));
  const float dot = __double2float_rn(__dadd_rn(__dmul_rn(az, bz), (double)t1));
  const float d = __fsub_rn(__fadd_rn(sqa, sqb), __fmul_rn(2.0f, dot));
  return (d != d) ? d : fmaxf(d, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
radius_knn_kernel(const float* __restrict__ pts, const bool* __restrict__ mask, int n, int k,
                  float r2, int* __restrict__ idx_out, bool* __restrict__ valid_out,
                  float* __restrict__ d2_out) {
  // a staged column: (x, |q|^2 or -1) and (y, z) in f64
  __shared__ float2 cols_xw[kChunk];
  __shared__ double2 cols_yz[kChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t b = blockIdx.y;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  const float* P = pts + b * n * 3;
  const bool* M = mask + b * n;
  const bool live = row < n;
  float ax = 0.0f, ay = 0.0f, az = 0.0f, sqa = 0.0f;
  if (live) {
    ax = P[3 * row];
    ay = P[3 * row + 1];
    az = P[3 * row + 2];
    sqa = sq_norm(ax, ay, az);
  }
  const double ay_d = ay, az_d = az;
  // the sorted list: slot lane in lo, slot 32 + lane in hi
  uint64_t lo = kEmpty, hi = kEmpty, thr = kEmpty;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int first = row0 / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const int base = ((first + c) % chunks) * kChunk;
    __syncthreads();
    {
      const int j = base + threadIdx.x;
      float2 xw = make_float2(0.0f, -1.0f);
      double2 yz = make_double2(0.0, 0.0);
      if (j < n) {
        const float x = P[3 * j], y = P[3 * j + 1], z = P[3 * j + 2];
        xw.x = x;
        if (M[j]) xw.y = sq_norm(x, y, z);
        yz = make_double2(y, z);
      }
      cols_xw[threadIdx.x] = xw;
      cols_yz[threadIdx.x] = yz;
    }
    __syncthreads();
    if (!live) continue;
    const int m = min(kChunk, n - base);
    for (int s = 0; s < m; s += 32) {
      const int t = s + lane;
      uint64_t key = kEmpty;
      if (t < m) {
        const float2 q = cols_xw[t];
        // a masked column: the f32 maximum (its |q|^2 is -1; a valid one's
        // is >= 0 or NaN)
        const float d2 = (q.y < 0.0f) ? kFltMax
                                      : sq_dist(ax, ay_d, az_d, sqa, q.x, cols_yz[t].x,
                                                cols_yz[t].y, q.y);
        key = ((uint64_t)__float_as_uint(d2) << 32) | (uint32_t)(base + t);
      }
      unsigned cand = __ballot_sync(kFull, key < thr);
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        const uint64_t ck = __shfl_sync(kFull, key, src);
        if (ck >= thr) continue;  // the list moved past it (warp-uniform)
        const int pos = __popc(__ballot_sync(kFull, lo < ck)) +
                        __popc(__ballot_sync(kFull, hi < ck));
        const uint64_t up_lo = __shfl_up_sync(kFull, lo, 1);
        const uint64_t up_hi = __shfl_up_sync(kFull, hi, 1);
        const uint64_t last_lo = __shfl_sync(kFull, lo, 31);
        const uint64_t prev_hi = (lane == 0) ? last_lo : up_hi;
        lo = (lane < pos) ? lo : ((lane == pos) ? ck : up_lo);
        hi = (32 + lane < pos) ? hi : ((32 + lane == pos) ? ck : prev_hi);
        thr = (k <= 32) ? __shfl_sync(kFull, lo, k - 1) : __shfl_sync(kFull, hi, k - 33);
      }
    }
  }
  if (!live) return;
  const bool rmask = M[row];
  const size_t out = (b * n + row) * k;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int slot = lane + 32 * half;
    if (slot >= k) continue;
    const uint64_t key = half ? hi : lo;
    const float d2 = __uint_as_float((uint32_t)(key >> 32));
    idx_out[out + slot] = (int)(uint32_t)(key & 0xffffffffu);
    d2_out[out + slot] = d2;
    valid_out[out + slot] = (d2 <= r2) && rmask;
  }
}

// The warp route at S slots a lane (K <= 32 S): slot 32 s + lane in
// list[s]; the same insertion (a ballot for the position, shuffles up by
// one slot) over S registers. S = 4 and 8, for K up to 128 and 256.
template <int S>
__global__ void __launch_bounds__(kThreads)
radius_knn_slots_kernel(const float* __restrict__ pts, const bool* __restrict__ mask, int n,
                        int k, float r2, int* __restrict__ idx_out, bool* __restrict__ valid_out,
                        float* __restrict__ d2_out) {
  __shared__ float2 cols_xw[kChunk];
  __shared__ double2 cols_yz[kChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t b = blockIdx.y;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  const float* P = pts + b * n * 3;
  const bool* M = mask + b * n;
  const bool live = row < n;
  float ax = 0.0f, ay = 0.0f, az = 0.0f, sqa = 0.0f;
  if (live) {
    ax = P[3 * row];
    ay = P[3 * row + 1];
    az = P[3 * row + 2];
    sqa = sq_norm(ax, ay, az);
  }
  const double ay_d = ay, az_d = az;
  uint64_t list[S];
#pragma unroll
  for (int s = 0; s < S; ++s) list[s] = kEmpty;
  uint64_t thr = kEmpty;
  const int kth_slot = (k - 1) >> 5, kth_lane = (k - 1) & 31;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int first = row0 / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const int base = ((first + c) % chunks) * kChunk;
    __syncthreads();
    {
      const int j = base + threadIdx.x;
      float2 xw = make_float2(0.0f, -1.0f);
      double2 yz = make_double2(0.0, 0.0);
      if (j < n) {
        const float x = P[3 * j], y = P[3 * j + 1], z = P[3 * j + 2];
        xw.x = x;
        if (M[j]) xw.y = sq_norm(x, y, z);
        yz = make_double2(y, z);
      }
      cols_xw[threadIdx.x] = xw;
      cols_yz[threadIdx.x] = yz;
    }
    __syncthreads();
    if (!live) continue;
    const int m = min(kChunk, n - base);
    for (int s0 = 0; s0 < m; s0 += 32) {
      const int t = s0 + lane;
      uint64_t key = kEmpty;
      if (t < m) {
        const float2 q = cols_xw[t];
        const float d2 = (q.y < 0.0f) ? kFltMax
                                      : sq_dist(ax, ay_d, az_d, sqa, q.x, cols_yz[t].x,
                                                cols_yz[t].y, q.y);
        key = ((uint64_t)__float_as_uint(d2) << 32) | (uint32_t)(base + t);
      }
      unsigned cand = __ballot_sync(kFull, key < thr);
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        const uint64_t ck = __shfl_sync(kFull, key, src);
        if (ck >= thr) continue;  // the list moved past it (warp-uniform)
        int pos = 0;
        uint64_t up[S], last[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          pos += __popc(__ballot_sync(kFull, list[s] < ck));
          up[s] = __shfl_up_sync(kFull, list[s], 1);
          last[s] = __shfl_sync(kFull, list[s], 31);
        }
        uint64_t kth = 0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int slot = 32 * s + lane;
          const uint64_t prev = (lane == 0) ? (s > 0 ? last[s - 1] : kEmpty) : up[s];
          list[s] = (slot < pos) ? list[s] : ((slot == pos) ? ck : prev);
          if (s == kth_slot) kth = list[s];
        }
        thr = __shfl_sync(kFull, kth, kth_lane);
      }
    }
  }
  if (!live) return;
  const bool rmask = M[row];
  const size_t out = (b * n + row) * k;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = lane + 32 * s;
    if (slot >= k) continue;
    const float d2 = __uint_as_float((uint32_t)(list[s] >> 32));
    idx_out[out + slot] = (int)(uint32_t)(list[s] & 0xffffffffu);
    d2_out[out + slot] = d2;
    valid_out[out + slot] = (d2 <= r2) && rmask;
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

}  // namespace knn
}  // namespace quatro

// points (B, N, 3), mask (B, N) -> idx, valid, d2 (B, N, K); 1 <= K <= N
// (the wrapper checks). K <= 64: two slots a lane; <= 128 and <= 256: four
// and eight; above, the block route, its keys in `work` (blocks x pn 64-bit
// words, pn = N padded to a power of two) or, where work is null, in
// shared memory (quatro_knn_plan gives both).
extern "C" int quatro_radius_knn(const float* pts, const bool* mask, int bsz, int n, int k,
                                 float r2, int* idx, bool* valid, float* d2, void* work,
                                 int blocks, cudaStream_t stream) {
  using namespace quatro::knn;
  dim3 grid((n + kWarps - 1) / kWarps, bsz);
  if (k <= 64) {
    radius_knn_kernel<<<grid, kThreads, 0, stream>>>(pts, mask, n, k, r2, idx, valid, d2);
  } else if (k <= 128) {
    radius_knn_slots_kernel<4><<<grid, kThreads, 0, stream>>>(pts, mask, n, k, r2, idx, valid,
                                                              d2);
  } else if (k <= 256) {
    radius_knn_slots_kernel<8><<<grid, kThreads, 0, stream>>>(pts, mask, n, k, r2, idx, valid,
                                                              d2);
  } else {
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
  }
  return (int)cudaGetLastError();
}
