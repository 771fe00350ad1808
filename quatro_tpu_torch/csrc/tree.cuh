// utils/fused.pairwise_sum's tree over a block, shared by the kernels whose
// plain versions sum with it: the polish's yaw GNC (polish.cu) and the
// ground-plane fit (ground.cu).
//
// pairwise_sum pads its length to a power of two P with zeros and adds
// x[i] + x[i + half] for half = P / 2 down to 1. A thread that holds the
// entries of a strided set {t, t + T, t + 2T, ...} can fold the levels at
// or above T itself, in the same pairing; tree_sum then takes the levels
// below T through shared memory and the last five through warp shuffles.
// Every addition is __fadd_rn, which nvcc never contracts.
#pragma once

#include <cuda_runtime.h>

namespace quatro {
namespace tree {

// NV pairwise sums (utils/fused.pairwise_sum) of the T * NPT values v[j][k]
// at points t + k * T (zero past N); every thread gets them in out[]. The
// tree's levels are x[i] + x[i + half] from half = `half` down to 1: those
// at or above T inside a thread, then through shared memory down to 32
// entries, then warp shuffles. sm holds NV * T floats.
template <int T, int NPT, int NV>
__device__ __forceinline__ void tree_sum(float (&v)[NV][NPT], int half, float* sm,
                                         float* out) {
  const int t = threadIdx.x;
  __syncthreads();                          // sm and out free again
#pragma unroll
  for (int h = NPT / 2; h >= 1; h >>= 1) {
    if (h * T <= half) {
#pragma unroll
      for (int k = 0; k < h; ++k)
#pragma unroll
        for (int j = 0; j < NV; ++j) v[j][k] = __fadd_rn(v[j][k], v[j][k + h]);
    }
  }
  if (half >= T) half = T / 2;
  if (half >= 32) {
    if (t < 2 * half) {
#pragma unroll
      for (int j = 0; j < NV; ++j) sm[j * T + t] = v[j][0];
    }
    __syncthreads();
    for (; half >= 32; half >>= 1) {
      if (t < half) {
#pragma unroll
        for (int j = 0; j < NV; ++j)
          sm[j * T + t] = __fadd_rn(sm[j * T + t], sm[j * T + t + half]);
      }
      if (half > 32) __syncthreads();
    }
    if (t < 32) {
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j][0] = sm[j * T + t];
    }
  }
  if (t < 32) {
    for (; half >= 1; half >>= 1) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        v[j][0] = __fadd_rn(v[j][0], __shfl_down_sync(0xffffffffu, v[j][0], half));
    }
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) out[j] = v[j][0];
    }
  }
  __syncthreads();
}

// The NV pairwise sums of one thread's strided set of 2^levels members
// (member k at point t + k * T, say): the halving tree x[k] + x[k + half]
// level by level, for any count, as the register folds above give it for a
// fixed one. The tree adds its leaves in bit-reversed order of k pairwise,
// so a stack of partials (the binary counter of pairwise summation) takes
// them one at a time: leaf(k, out) gives member k's values (+0 past the
// row). The wide routes use it where a thread's members do not fit in
// registers: the polish's yaw GNC, ICP's update and the leveling past their
// register folds, the neighbour normals past two slots a lane.
template <int NV, class Leaf>
__device__ __forceinline__ void strided_fold(const Leaf& leaf, int levels, float (&out)[NV]) {
  float stk[32][NV];
  int top = 0;
  const unsigned count = 1u << levels;
  for (unsigned j = 0; j < count; ++j) {
    const int k = levels ? (int)(__brev(j) >> (32 - levels)) : 0;
    float cur[NV];
    leaf(k, cur);
    for (unsigned b = j; b & 1u; b >>= 1) {
      --top;
#pragma unroll
      for (int v = 0; v < NV; ++v) cur[v] = __fadd_rn(stk[top][v], cur[v]);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) stk[top][v] = cur[v];
    ++top;
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) out[v] = stk[0][v];
}

}  // namespace tree
}  // namespace quatro
