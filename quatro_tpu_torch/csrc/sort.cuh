// Sorts in shared memory in the card's torch.sort order, shared by the
// kernels that sort along a row: the polish's COTE events and median
// candidates (polish.cu) and the translation vote's grid keys and
// occupancy ranks (vote.cu).
//
// - ordered_bits: the 32-bit key under which a float sorts as torch.sort
//   sorts it on the card.
// - bitonic_sort: an ascending sort of 64-bit keys by the whole block; a
//   key of (value bits, index) gives torch.sort(stable=True)'s order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace quatro {
namespace sort {

// torch.sort's key of a float on the card (torch 2.11): a stable sort,
// and an unstable one past 32 values a row, is a cub radix sort on the
// order-preserving bits, -0.0 ranked as +0.0, a NaN with the sign bit first
// and one without last; an unstable sort of at most 32 values is a bitonic
// sort on torch's less-than, under which every NaN is the largest
// (nan_last; its -0.0 and +0.0 come in no set order).
__device__ __forceinline__ unsigned ordered_bits(float v, bool nan_last) {
  if (nan_last && isnan(v)) return 0xffffffffu;
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

constexpr int kBitonicSortMax = 32;          // torch's small unstable sort

// Ascending bitonic sort of the p (a power of two) keys in shared memory
// by the whole block.
__device__ inline void bitonic_sort(unsigned long long* k, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = threadIdx.x; q < p / 2; q += blockDim.x) {
        const int i = 2 * q - (q & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = k[i], b = k[j];
        if ((a > b) == ((i & size) == 0)) {
          k[i] = b;
          k[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace sort
}  // namespace quatro
