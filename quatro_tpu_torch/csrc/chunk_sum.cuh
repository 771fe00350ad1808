// The second pass of the two-pass segment sums (B8, B9): per-chunk partial
// sums added in chunk order, so a run repeats bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace quatro {

// partial (B, chunks, per) f32 -> out (B, per) f32; one thread per output,
// grid (ceil(per / blockDim.x), B). With lim (B,), only the chunks of
// `chunk` points that start before lim[b] are added: the others hold
// nothing (adding their zeros would leave the same bits) and were never
// written. Kernel is the caller's number (8 or 9), so that a profile
// tells B8's second pass from B9's.
template <int Kernel>
__global__ void chunk_sum_kernel(const float* __restrict__ partial, int chunks,
                                 int per, float* __restrict__ out,
                                 const int* __restrict__ lim, int chunk) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (o >= per) return;
  const int live = lim ? min(chunks, (lim[b] + chunk - 1) / chunk) : chunks;
  const float* p = partial + (size_t)b * chunks * per + o;
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < live; ++c) s += p[(size_t)c * per];   // loads in flight together
  out[(size_t)b * per + o] = s;
}

template <int Kernel>
int launch_chunk_sum(const float* partial, int bsz, int chunks, int per, float* out,
                     cudaStream_t stream, const int* lim = nullptr, int chunk = 0) {
  dim3 grid((per + 255) / 256, bsz);
  chunk_sum_kernel<Kernel><<<grid, 256, 0, stream>>>(partial, chunks, per, out, lim,
                                                     chunk);
  return (int)cudaGetLastError();
}

}  // namespace quatro
