// Block scans shared by the kernels that compact or prefix-sum along a row.
//
// - block_exclusive_scan: an exclusive scan of one int a thread over the
//   block (compactions: the voxel grid's run starts and chosen runs, the
//   polish's chain order and COTE's selection).
// - prefix_at / scan_levels: XLA:CPU's blocked f32 prefix sum
//   (quatro_tpu_torch/utils/scan.py::prefix_sum): running sums inside
//   blocks of 16, the block totals summed so recursively, each block's
//   exclusive carry added (0.0 to the first block, none where the whole
//   length is at most 16). A caller writes the level-0 running sums and
//   each block's total (level 1); scan_levels completes the levels above
//   in place; prefix_at gives the prefix at a position from its level-0
//   running sum and the level-1 prefix.
#pragma once

#include <cuda_runtime.h>

namespace quatro {
namespace scan {

constexpr int kScanBlock = 16;               // XLA:CPU's prefix-sum block
constexpr int kMaxLevels = 8;                // enough for any int n

// Exclusive scan of one int a thread over the block (a multiple of 32
// threads, at most 1024); *total gets the block's sum. warp_sums: 32 ints
// of shared memory, free again when it returns.
__device__ inline int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[warps - 1];
  __syncthreads();
  return before;
}

// The prefix of a length-n row at position i, from the level-0 running
// sum there (`within`) and the level-1 prefix (`level1`, the totals of the
// blocks of 16 after scan_levels): the previous block's carry added, or
// 0.0 in the first block; a length of at most 16 is one sequential run,
// with no carry added.
__device__ __forceinline__ float prefix_at(float within, const float* level1, int n, int i) {
  if (n <= kScanBlock) return within;
  const int r = i / kScanBlock;
  return __fadd_rn(within, r > 0 ? level1[r - 1] : 0.0f);
}

// The levels above level 0 of `arrays` rows, completed in place by the
// whole block: row a's words start at lv + a * stride and hold level 1
// (the m1 block totals of level 0), then room for level 2 (ceil(m1 / 16)
// words), level 3, ... (level_words in ops/voxel.py). Afterwards each
// level holds its prefix in the blocked order. `load` reads a word (the
// voxel centroids read global words past L1 with __ldcg; shared words are
// read plainly). Every thread of the block must call it.
template <class Load>
__device__ void scan_levels(float* lv, size_t stride, int arrays, int m1, Load load) {
  const int tid = threadIdx.x;
  int offs[kMaxLevels], lens[kMaxLevels];
  int top = 0, off = 0, m = m1;
  // up: running sums inside blocks of 16 in place, each block's total
  // into the next level, until a level of at most 16
  for (;;) {
    offs[top] = off;
    lens[top] = m;
    if (m <= kScanBlock) break;
    const int next = (m + kScanBlock - 1) / kScanBlock;
    for (int task = tid; task < arrays * next; task += blockDim.x) {
      float* a = lv + (task / next) * stride + off;
      const int b = task % next;
      const int stop = min(m, (b + 1) * kScanBlock);
      float s = load(a + b * kScanBlock);
      for (int i = b * kScanBlock + 1; i < stop; ++i) {
        s = __fadd_rn(s, load(a + i));
        a[i] = s;
      }
      a[m + b] = s;
    }
    __syncthreads();
    off += m;
    m = next;
    ++top;
  }
  // the top level: one sequential run
  for (int t = tid; t < arrays; t += blockDim.x) {
    float* a = lv + t * stride + offs[top];
    float s = load(a);
    for (int i = 1; i < lens[top]; ++i) {
      s = __fadd_rn(s, load(a + i));
      a[i] = s;
    }
  }
  __syncthreads();
  // down again: each block of a level gets its exclusive carry
  for (int l = top - 1; l >= 0; --l) {
    const int len = lens[l];
    for (int task = tid; task < arrays * len; task += blockDim.x) {
      float* a = lv + (task / len) * stride + offs[l];
      const int i = task % len;
      const int b = i / kScanBlock;
      a[i] = __fadd_rn(load(a + i), b > 0 ? load(a + lens[l] + b - 1) : 0.0f);
    }
    __syncthreads();
  }
}

}  // namespace scan
}  // namespace quatro
