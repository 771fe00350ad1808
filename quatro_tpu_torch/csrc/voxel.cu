// The voxel grid: per-point Morton keys and fractions, the run lengths and
// the occupancy cut, and the centroids, three kernels around the one
// stable sort of the int32 keys.
//
// The counterpart of quatro_tpu/ops/voxel.py::voxel_downsample (one
// jax.jit whose elementwise work XLA fuses around two lax.sorts: the keys
// and fractions :113-148, the run lengths and the occupancy ranking
// :151-194, the cumsum and the centroid arithmetic :196-228; no Pallas
// kernel there), bit for bit quatro_tpu_torch/ops/voxel.py's voxel_keys_plain,
// voxel_select_plain and voxel_centroids_plain.
//
// keys: points (C, N, 3) f32, mask (C, N) bool and each cloud's corner
//   minb (C, 3) f32 (torch's amin over the valid points) -> key (C, N)
//   int32, the 30-bit Morton key of the point's cell or 2^31 - 1 where the
//   point is masked or outside the 1024^3 grid, and payload (C, N, 2)
//   int32, ((qx << 15) + qy, qz), the corner-relative fractions quantised
//   to 15 bits (0 where the key is the sentinel). v = (p - minb) * inv,
//   cell = floor(v), f = v - cell, each rounded once as torch rounds them
//   (no contraction); q = trunc(clamp(f * 2^15, 0, 2^15 - 1)).
// select: the sorted keys (their first n, the active prefix) -> for each
//   cloud the run starts (the valid positions whose key differs from the
//   previous one) and lengths (to the next start, or to n: the last run
//   takes the sentinels after it, as the JAX package counts it); the
//   top-k runs (k = min(capacity, n)) by count clamped to 16383,
//   descending, ties toward the lower position, in position order ->
//   starts_top, counts_top (unclamped) and key_top (the run's key) (C,
//   capacity) int32; slots no run takes get 0, 0 and the cloud's first
//   sorted key.
// centroids: the fractions gathered through the sort's order, f = (q +
//   0.5) * 2^-15 (0 at a sentinel), their prefix sum in XLA:CPU's blocked
//   order (utils/scan.py::prefix_sum: running sums inside blocks of 16,
//   the block totals summed so recursively, each block's exclusive carry
//   added) taken at each chosen run's two boundaries, and minb + (k +
//   sum / count) * leaf with torch's four roundings -> out (C, capacity,
//   3) f32 (0 where no run) and out_mask (C, capacity) bool.
//
// Bound on the card: bytes. At path P's B = 64 (128 clouds of 131072
// points, an active prefix of 32768, 8192 slots) the keys read 13 bytes a
// point and write 12 (419 MB), the selection reads the 4-byte keys of the
// prefix and writes 12 bytes a slot (29 MB), the centroids read the keys,
// the order and the payload of the prefix and the three slot words and
// write 13 bytes a slot (101 MB): 0.16 ms at 3.35 TB/s in all.
// Design:
// - keys: one thread a point, every cloud in one launch; the arithmetic in
//   registers (the plain version's ~110 elementwise launches in one pass).
// - select: one block of 1024 threads a cloud (its runs depend on the
//   whole prefix). It compacts the run starts in position order by block
//   scans into global scratch (n + 1 words a cloud, L2-resident), and
//   replaces the JAX package's two sorts (the rank key's and the chosen
//   positions') by a counting selection: a 2^14-bin histogram of the
//   clamped counts in shared memory, the threshold count from a block scan
//   of the bins (highest first), then one pass over the runs in position
//   order that keeps those above the threshold and the first ones at it.
//   The same integers as the sorts, since the rank key orders by count
//   and then by position.
// - centroids, two launches, every cloud in each, no state between calls:
//   - voxel_levels_kernel, a CTA of 128 threads a span of 2048 positions
//     (level 0 and level 1 of the blocked order): the CTA reads the span's
//     keys and order coalesced, 16 rounds of 128 consecutive positions,
//     all issued before the payload's 16 gathers through them, and stages
//     the payload in shared memory (a row of 17 words a block of 16,
//     against bank conflicts), with a boundary flag
//     where a run ends (the last prefix position, or a run start after
//     it); then a thread runs a block of 16 in order, writing its running
//     sums (float4) only at the run ends, the positions a slot reads;
//     then 8 threads run the span's 8 blocks of 16 level-0 totals, writing
//     level 1's running sums (float4) and each block's total (level 2);
//   - voxel_centroids_kernel, a CTA of 256 slots of a cloud: it completes
//     the cloud's level 2 and above in shared memory (scan.cuh's
//     scan_levels over the level-2 totals, at most 546 words an axis at
//     a prefix of 2^17), then each slot's prefix at its two run ends from
//     two level-0 and two level-1 running sums and its level-2 carries,
//     each carry added as scan_levels adds it, and the centroid.
//   The level-0 positions are read once and coalesced, the prefix is never
//   written at every position, and the levels and slots spread over many
//   CTAs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace quatro {
namespace vox {

constexpr int kGrid = 1 << 10;               // cells per axis
constexpr int kFBits = 15;                   // fraction bits
constexpr int kCBits = 14;                   // clamped count bits
constexpr int kCMax = (1 << kCBits) - 1;
constexpr int kSentinel = 0x7fffffff;
using scan::kScanBlock;
constexpr int kKeysThreads = 256;
constexpr int kSelectThreads = 1024;
constexpr int kSelectItems = 4;              // positions a thread per tile
constexpr int kBinsPerThread = (1 << kCBits) / kSelectThreads;

__device__ __forceinline__ unsigned part1by2(unsigned v) {
  v &= 0x3ffu;
  v = (v | (v << 16)) & 0xff0000ffu;
  v = (v | (v << 8)) & 0x0300f00fu;
  v = (v | (v << 4)) & 0x030c30c3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__device__ __forceinline__ unsigned compact1by2(unsigned v) {
  v &= 0x09249249u;
  v = (v | (v >> 2)) & 0x030c30c3u;
  v = (v | (v >> 4)) & 0x0300f00fu;
  v = (v | (v >> 8)) & 0xff0000ffu;
  v = (v | (v >> 16)) & 0x3ffu;
  return v;
}

__global__ void __launch_bounds__(kKeysThreads)
voxel_keys_kernel(const float* __restrict__ points, const bool* __restrict__ mask,
                  const float* __restrict__ minb, int n, float inv, int* __restrict__ key,
                  int2* __restrict__ payload) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t c = blockIdx.y;
  if (e >= n) return;
  const size_t i = c * n + e;
  float v[3], cell[3];
  bool in_grid = mask[i];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    v[d] = __fmul_rn(__fsub_rn(points[3 * i + d], minb[3 * c + d]), inv);
    cell[d] = floorf(v[d]);
    in_grid = in_grid && cell[d] >= 0.0f && cell[d] < (float)kGrid;
  }
  if (!in_grid) {
    key[i] = kSentinel;
    payload[i] = make_int2(0, 0);
    return;
  }
  int q[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float f = __fmul_rn(__fsub_rn(v[d], cell[d]), (float)(1 << kFBits));
    q[d] = __float2int_rz(fminf(fmaxf(f, 0.0f), (float)((1 << kFBits) - 1)));
  }
  key[i] = (int)(part1by2((unsigned)cell[0]) + (part1by2((unsigned)cell[1]) << 1) +
                 (part1by2((unsigned)cell[2]) << 2));
  payload[i] = make_int2((q[0] << kFBits) + q[1], q[2]);
}

__global__ void __launch_bounds__(kSelectThreads)
voxel_select_kernel(const int* __restrict__ key_s, int stride, int n, int capacity, int k,
                    int* __restrict__ run_start, int* __restrict__ starts_top,
                    int* __restrict__ counts_top, int* __restrict__ key_top) {
  extern __shared__ int hist[];                 // 2^14 clamped-count bins
  __shared__ int warp_sums[32];
  __shared__ int cut[2];                        // threshold count, runs taken at it
  const size_t c = blockIdx.x;
  const int tid = threadIdx.x;
  const int* keys = key_s + c * stride;
  int* starts = run_start + c * (size_t)(n + 1);
  const size_t slots = c * (size_t)capacity;

  // 1. the run starts, compacted in position order
  int runs = 0;
  for (int base = 0; base < n; base += kSelectThreads * kSelectItems) {
    const int i0 = base + tid * kSelectItems;
    int prev = (i0 > 0 && i0 <= n) ? keys[i0 - 1] : kSentinel;
    int flags = 0, count = 0;
#pragma unroll
    for (int t = 0; t < kSelectItems; ++t) {
      const int i = i0 + t;
      if (i < n) {
        const int kv = keys[i];
        if (kv != kSentinel && (i == 0 || kv != prev)) {
          flags |= 1 << t;
          ++count;
        }
        prev = kv;
      }
    }
    int total;
    int at = runs + scan::block_exclusive_scan(count, warp_sums, &total);
#pragma unroll
    for (int t = 0; t < kSelectItems; ++t)
      if (flags >> t & 1) starts[at++] = i0 + t;
    runs += total;
  }
  if (tid == 0) starts[runs] = n;
  __syncthreads();

  // 2. where the capacity binds, the threshold count: the largest T with
  // at least k runs of clamped count >= T, and how many runs at T to take
  int threshold = 0, need = 0;                  // else every run
  if (runs > k) {
    for (int b = tid; b < (1 << kCBits); b += kSelectThreads) hist[b] = 0;
    __syncthreads();
    for (int j = tid; j < runs; j += kSelectThreads)
      atomicAdd(&hist[min(starts[j + 1] - starts[j], kCMax)], 1);
    __syncthreads();
    const int top = kCMax - tid * kBinsPerThread;  // this thread's highest bin
    int sum = 0;
#pragma unroll
    for (int b = 0; b < kBinsPerThread; ++b) sum += hist[top - b];
    int total;
    const int above = scan::block_exclusive_scan(sum, warp_sums, &total);
    if (above < k && above + sum >= k) {
      int s = above;
      for (int b = 0; b < kBinsPerThread; ++b) {
        const int h = hist[top - b];
        if (s + h >= k) {
          cut[0] = top - b;
          cut[1] = k - s;
          break;
        }
        s += h;
      }
    }
    __syncthreads();
    threshold = cut[0];
    need = cut[1];
  }

  // 3. the chosen runs in position order: every run above the threshold
  // and the first `need` at it
  int ties = 0, chosen = 0;
  for (int base = 0; base < runs; base += kSelectThreads) {
    const int j = base + tid;
    int start = 0, len = 0;
    if (j < runs) {
      start = starts[j];
      len = starts[j + 1] - start;
    }
    const int clamped = min(len, kCMax);
    const bool tie = j < runs && clamped == threshold;
    int tie_total, sel_total;
    const int tie_rank = ties + scan::block_exclusive_scan(tie ? 1 : 0, warp_sums, &tie_total);
    const bool sel = j < runs && (clamped > threshold || (tie && tie_rank < need));
    const int slot = chosen + scan::block_exclusive_scan(sel ? 1 : 0, warp_sums, &sel_total);
    if (sel) {
      starts_top[slots + slot] = start;
      counts_top[slots + slot] = len;
      key_top[slots + slot] = keys[start];
    }
    ties += tie_total;
    chosen += sel_total;
  }
  const int first = keys[0];
  for (int slot = chosen + tid; slot < capacity; slot += kSelectThreads) {
    starts_top[slots + slot] = 0;
    counts_top[slots + slot] = 0;
    key_top[slots + slot] = first;
  }
}

struct CentroidParams {
  int n;          // the active prefix
  int stride;     // N, the row length of key_s, order and payload
  int capacity;
  int m1;         // ceil(n / 16): level-0 blocks, the length of level 1
  int m2;         // ceil(m1 / 16): level-1 blocks, the length of level 2
  int words2;     // level 2's words of one axis: m2 and the levels above it
  float leaf;
};

constexpr int kLevelThreads = 128;                    // a block of 16 positions a thread
constexpr int kSpan = kLevelThreads * kScanBlock;     // 2048 positions a CTA
constexpr int kSpanL1 = kLevelThreads / kScanBlock;   // 8 level-1 blocks a CTA
constexpr int kSlotThreads = 256;
constexpr int kEndBit = (int)0x80000000;              // a staged position ends a run

// grid (ceil(n / 2048), C). w0 (C, n) float4: the level-0 running sums at
// the run ends (elsewhere unwritten); w1 (C, m1) float4: level 1's running
// sums inside its blocks of 16; l2 (C, 3, m2): level 2, each level-1
// block's total.
__global__ void __launch_bounds__(kLevelThreads)
voxel_levels_kernel(const int* __restrict__ key_s, const long long* __restrict__ order,
                    const int2* __restrict__ payload, CentroidParams p, float4* __restrict__ w0,
                    float4* __restrict__ w1, float* __restrict__ l2) {
  __shared__ int2 stage[kLevelThreads][kScanBlock + 1];
  __shared__ float4 tot[kLevelThreads];
  const size_t c = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = p.n;
  const int base = blockIdx.x * kSpan;
  const size_t row = c * (size_t)p.stride;
  // the span, coalesced: (q x, q y) packed and q z, x = -1 at a sentinel or
  // past n, kEndBit in y where a run ends
  int kv[kScanBlock], nx[kScanBlock];
  long long at[kScanBlock];
#pragma unroll
  for (int j = 0; j < kScanBlock; ++j) {
    const int i = base + j * kLevelThreads + tid;
    kv[j] = i < n ? key_s[row + i] : kSentinel;
    nx[j] = i + 1 < n ? key_s[row + i + 1] : kSentinel;
    at[j] = i < n ? order[row + i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kScanBlock; ++j) {
    const int q = j * kLevelThreads + tid;
    const int i = base + q;
    int2 e = make_int2(-1, 0);
    if (kv[j] != kSentinel) e = payload[row + at[j]];
    if (i == n - 1 || (i < n && nx[j] != kSentinel && nx[j] != kv[j])) e.y |= kEndBit;
    stage[q / kScanBlock][q % kScanBlock] = e;
  }
  __syncthreads();
  // level 0: this thread's block of 16 in order
  const int r = blockIdx.x * kLevelThreads + tid;
  float s[3] = {0.0f, 0.0f, 0.0f};
  if (r < p.m1) {
    float4* out = w0 + c * (size_t)n;
    for (int k = 0; k < kScanBlock; ++k) {
      const int i = r * kScanBlock + k;
      if (i >= n) break;
      const int2 e = stage[tid][k];
      float f[3] = {0.0f, 0.0f, 0.0f};
      if (e.x >= 0) {
        f[0] = __fmul_rn((float)(e.x >> kFBits) + 0.5f, 1.0f / (1 << kFBits));
        f[1] = __fmul_rn((float)(e.x & ((1 << kFBits) - 1)) + 0.5f, 1.0f / (1 << kFBits));
        f[2] = __fmul_rn((float)(e.y & ((1 << kFBits) - 1)) + 0.5f, 1.0f / (1 << kFBits));
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) s[d] = k == 0 ? f[d] : __fadd_rn(s[d], f[d]);
      if (e.y & kEndBit) out[i] = make_float4(s[0], s[1], s[2], 0.0f);
    }
  }
  tot[tid] = make_float4(s[0], s[1], s[2], 0.0f);
  __syncthreads();
  // level 1: running sums inside each block of 16 totals, its total to level 2
  if (tid < kSpanL1) {
    const int g = blockIdx.x * kSpanL1 + tid;
    const int r0 = g * kScanBlock;
    if (r0 < p.m1) {
      float t[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < kScanBlock && r0 + k < p.m1; ++k) {
        const float4 v = tot[tid * kScanBlock + k];
        t[0] = k == 0 ? v.x : __fadd_rn(t[0], v.x);
        t[1] = k == 0 ? v.y : __fadd_rn(t[1], v.y);
        t[2] = k == 0 ? v.z : __fadd_rn(t[2], v.z);
        w1[c * (size_t)p.m1 + r0 + k] = make_float4(t[0], t[1], t[2], 0.0f);
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) l2[(c * 3 + d) * (size_t)p.m2 + g] = t[d];
    }
  }
}

// The prefix at position i of axis d: its level-0 running sum plus the
// level-1 prefix of the block before (0.0 in the first block; none where
// the prefix is at most 16 long), the level-1 prefix likewise from its
// running sum and level 2's (lv: level 2's prefix of the axis); each
// carry added as scan.cuh's scan_levels and prefix_at add it.
__device__ __forceinline__ float prefix_of(const float4* __restrict__ w0,
                                           const float4* __restrict__ w1, const float* lv,
                                           int n, int m1, int i, int d) {
  const float4 a = __ldg(w0 + i);
  const float within = d == 0 ? a.x : (d == 1 ? a.y : a.z);
  if (n <= kScanBlock) return within;
  const int r = i / kScanBlock;
  float carry = 0.0f;
  if (r > 0) {
    const float4 v = __ldg(w1 + (r - 1));
    const float w = d == 0 ? v.x : (d == 1 ? v.y : v.z);
    const int g = (r - 1) / kScanBlock;
    carry = m1 <= kScanBlock ? w : __fadd_rn(w, g > 0 ? lv[g - 1] : 0.0f);
  }
  return __fadd_rn(within, carry);
}

// grid (ceil(capacity / 256), C); dynamic shared memory: 3 * words2 f32.
__global__ void __launch_bounds__(kSlotThreads)
voxel_centroids_kernel(const float* __restrict__ minb, const int* __restrict__ starts_top,
                       const int* __restrict__ counts_top, const int* __restrict__ key_top,
                       CentroidParams p, const float4* __restrict__ w0,
                       const float4* __restrict__ w1, const float* __restrict__ l2,
                       float* __restrict__ out, bool* __restrict__ out_mask) {
  extern __shared__ float lv[];
  const size_t c = blockIdx.y;
  const int tid = threadIdx.x;
  // level 2 and above: level 2's prefix in the blocked order
  for (int i = tid; i < 3 * p.m2; i += kSlotThreads)
    lv[(i / p.m2) * p.words2 + i % p.m2] = l2[c * 3 * (size_t)p.m2 + i];
  __syncthreads();
  scan::scan_levels(lv, p.words2, 3, p.m2, [](const float* a) { return *a; });
  const int j = blockIdx.x * kSlotThreads + tid;
  if (j >= p.capacity) return;
  const size_t slot = c * (size_t)p.capacity + j;
  const int count = counts_top[slot];
  float o[3] = {0.0f, 0.0f, 0.0f};
  if (count > 0) {
    const int start = starts_top[slot];
    const unsigned kk = (unsigned)key_top[slot];
    const float cells[3] = {(float)compact1by2(kk), (float)compact1by2(kk >> 1),
                            (float)compact1by2(kk >> 2)};
    const float cnt = (float)count;
    const float4* a0 = w0 + c * (size_t)p.n;
    const float4* a1 = w1 + c * (size_t)p.m1;
    const int last = start + count - 1;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float* l = lv + d * p.words2;
      const float hi = prefix_of(a0, a1, l, p.n, p.m1, last, d);
      const float lo = start > 0 ? prefix_of(a0, a1, l, p.n, p.m1, start - 1, d) : 0.0f;
      const float mean = __fdiv_rn(__fsub_rn(hi, lo), cnt);
      o[d] = __fadd_rn(minb[3 * c + d], __fmul_rn(__fadd_rn(cells[d], mean), p.leaf));
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) out[3 * slot + d] = o[d];
  out_mask[slot] = count > 0;
}

}  // namespace vox
}  // namespace quatro

extern "C" int quatro_voxel_keys(const float* points, const bool* mask, const float* minb,
                                 int clouds, int n, float inv, int* key, int2* payload,
                                 cudaStream_t stream) {
  using namespace quatro::vox;
  if (clouds <= 0 || n <= 0) return (int)cudaGetLastError();
  dim3 grid((n + kKeysThreads - 1) / kKeysThreads, clouds);
  voxel_keys_kernel<<<grid, kKeysThreads, 0, stream>>>(points, mask, minb, n, inv, key, payload);
  return (int)cudaGetLastError();
}

// run_start: clouds * (n + 1) int32 words of scratch.
extern "C" int quatro_voxel_select(const int* key_s, int clouds, int stride, int n,
                                   int capacity, int* run_start, int* starts_top,
                                   int* counts_top, int* key_top, cudaStream_t stream) {
  using namespace quatro::vox;
  if (clouds <= 0 || n <= 0) return (int)cudaGetLastError();
  const int smem = (1 << kCBits) * (int)sizeof(int);
  const int rc = (int)cudaFuncSetAttribute(voxel_select_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const int k = capacity < n ? capacity : n;
  voxel_select_kernel<<<clouds, kSelectThreads, smem, stream>>>(
      key_s, stride, n, capacity, k, run_start, starts_top, counts_top, key_top);
  return (int)cudaGetLastError();
}

// w0: clouds * n float4 of scratch (only run ends written), w1: clouds *
// m1 float4, l2: clouds * 3 * m2 f32, m1 = ceil(n / 16), m2 = ceil(m1 /
// 16); words2: m2 and the levels above it (scan.cuh's scan_levels), whose
// 3 * words2 f32 the slots kernel holds in shared memory.
extern "C" int quatro_voxel_centroids(const int* key_s, const long long* order,
                                      const int2* payload, const float* minb,
                                      const int* starts_top, const int* counts_top,
                                      const int* key_top, int clouds, int stride, int n,
                                      int capacity, int words2, float leaf, float* w0,
                                      float* w1, float* l2, float* out, bool* out_mask,
                                      cudaStream_t stream) {
  using namespace quatro::vox;
  if (clouds <= 0 || n <= 0) return (int)cudaGetLastError();
  const int m1 = (n + kScanBlock - 1) / kScanBlock;
  const int m2 = (m1 + kScanBlock - 1) / kScanBlock;
  const CentroidParams p{n, stride, capacity, m1, m2, words2, leaf};
  dim3 lgrid((n + kSpan - 1) / kSpan, clouds);
  voxel_levels_kernel<<<lgrid, kLevelThreads, 0, stream>>>(
      key_s, order, payload, p, reinterpret_cast<float4*>(w0), reinterpret_cast<float4*>(w1), l2);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int smem = 3 * words2 * (int)sizeof(float);
  if (smem > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(voxel_centroids_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
  }
  dim3 sgrid((capacity + kSlotThreads - 1) / kSlotThreads, clouds);
  voxel_centroids_kernel<<<sgrid, kSlotThreads, smem, stream>>>(
      minb, starts_top, counts_top, key_top, p, reinterpret_cast<const float4*>(w0),
      reinterpret_cast<const float4*>(w1), l2, out, out_mask);
  return (int)cudaGetLastError();
}
