// The second pass of the two-pass segment sums (B8, B9): per-chunk partial
// sums added in chunk order, so a run repeats bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace quatro {

// partial (B, chunks, per) f32 -> out (B, per) f32; one thread per output,
// grid (ceil(per / blockDim.x), B).
__global__ void chunk_sum_kernel(const float* __restrict__ partial, int chunks,
                                 int per, float* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (o >= per) return;
  const float* p = partial + (size_t)b * chunks * per + o;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += p[(size_t)c * per];
  out[(size_t)b * per + o] = s;
}

inline int launch_chunk_sum(const float* partial, int bsz, int chunks, int per,
                            float* out, cudaStream_t stream) {
  dim3 grid((per + 255) / 256, bsz);
  chunk_sum_kernel<<<grid, 256, 0, stream>>>(partial, chunks, per, out);
  return (int)cudaGetLastError();
}

}  // namespace quatro
