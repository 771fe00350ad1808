// Weighted 2-D histogram: the Patchwork seed stage's (patch, z-bin) counts
// and z sums.
//
// Replaces quatro_tpu/ops/segment_matmul.py::cross_histogram (_hist_kernel):
//   out[b, k, a, c] = sum over i with ids_a[b, i] == a and ids_b[b, i] == c
//                     of w[b, k, i],
// ids (B, N) int32 x 2, w (B, K, N) f32, out (B, K, a_pad, b_pad) f32; ids
// outside [0, a_pad) or [0, b_pad) are dropped. The TPU kernel builds both
// one-hot tiles and contracts them on the MXU, its weighted channels at
// DEFAULT precision (the weights rounded to bf16); this kernel adds in f32.
//
// Bound on the card: bytes. On the main path (B = 2, N = 131072, K = 2,
// 512 x 128 bins) the inputs and the output are 5.2 MB, 1.6 us at
// 3.35 TB/s; the 0.5 M additions are nothing.
// Design, with no float atomics so a run repeats bit for bit:
// 1. a block takes a chunk of `chunk` consecutive points and 32 rows a of
//    the histogram, which it holds in shared memory (32 x K x b_pad floats,
//    32 KB on the main path); its 32 threads stage the chunk's ids and
//    weights 256 points at a time, and each thread, owning one row a,
//    walks the staged points in index order and adds the weights of the
//    points of its row into it; the block then writes the chunk's partial
//    rows;
// 2. one thread per output adds the chunks' partials in chunk order
//    (chunk_sum.cuh).
// Each point is tested by every row block of its chunk (N x a_pad / 32
// tests), which the small patch axis (504 patches) keeps cheap.
#include <cuda_runtime.h>

#include "chunk_sum.cuh"

namespace quatro {

constexpr int kHistRows = 32;   // threads per block = histogram rows per block
constexpr int kHistTile = 256;  // points staged per step
constexpr int kHistMaxK = 4;    // weight channels

__global__ void __launch_bounds__(kHistRows)
hist_partials_kernel(const int* __restrict__ ids_a, const int* __restrict__ ids_b,
                     const float* __restrict__ w, int n, int k, int a_pad, int b_pad,
                     int chunk, int chunks, float* __restrict__ partial) {
  extern __shared__ float hist[];           // [kHistRows][k][b_pad]
  __shared__ int sa[kHistTile];
  __shared__ int sb[kHistTile];
  __shared__ float sw[kHistMaxK][kHistTile];
  const int c = blockIdx.x;
  const int a0 = blockIdx.y * kHistRows;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int a = a0 + t;
  const int row = k * b_pad;
  for (int i = t; i < kHistRows * row; i += kHistRows) hist[i] = 0.f;
  const int* ia = ids_a + (size_t)b * n;
  const int* ib = ids_b + (size_t)b * n;
  const float* wb = w + (size_t)b * k * n;
  float* mine = hist + t * row;
  const int e0 = c * chunk;
  const int e1 = min(n, e0 + chunk);
  for (int t0 = e0; t0 < e1; t0 += kHistTile) {
    const int m = min(kHistTile, e1 - t0);
    __syncthreads();   // the rows are zeroed, the previous tile consumed
    for (int j = t; j < kHistTile; j += kHistRows) {
      const bool in = j < m;
      sa[j] = in ? ia[t0 + j] : -1;
      sb[j] = in ? ib[t0 + j] : -1;
      for (int g = 0; g < k; ++g) sw[g][j] = in ? wb[(size_t)g * n + t0 + j] : 0.f;
    }
    __syncthreads();
    if (a < a_pad) {
      for (int j = 0; j < m; ++j) {
        if (sa[j] != a) continue;
        const int cb = sb[j];
        if (cb < 0 || cb >= b_pad) continue;
        for (int g = 0; g < k; ++g) mine[g * b_pad + cb] += sw[g][j];
      }
    }
  }
  __syncthreads();
  // partial[b][c][g][a][cb], each row written by the whole block, coalesced
  float* out = partial + ((size_t)b * chunks + c) * k * a_pad * b_pad;
  for (int r = 0; r < kHistRows && a0 + r < a_pad; ++r)
    for (int g = 0; g < k; ++g)
      for (int cb = t; cb < b_pad; cb += kHistRows)
        out[((size_t)g * a_pad + a0 + r) * b_pad + cb] = hist[r * row + g * b_pad + cb];
}

}  // namespace quatro

// ids_a, ids_b (B, N) int32, w (B, K, N) f32, partial (B, ceil(N / chunk),
// K, a_pad, b_pad) f32 scratch -> out (B, K, a_pad, b_pad) f32. K <= 4.
extern "C" int quatro_cross_histogram(const int* ids_a, const int* ids_b, const float* w,
                                      int bsz, int n, int k, int a_pad, int b_pad,
                                      int chunk, float* partial, float* out,
                                      cudaStream_t stream) {
  if (k > quatro::kHistMaxK) return (int)cudaErrorInvalidValue;
  const int chunks = (n + chunk - 1) / chunk;
  const int smem = quatro::kHistRows * k * b_pad * (int)sizeof(float);
  int rc = (int)cudaFuncSetAttribute(quatro::hist_partials_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  dim3 grid(chunks, (a_pad + quatro::kHistRows - 1) / quatro::kHistRows, bsz);
  quatro::hist_partials_kernel<<<grid, quatro::kHistRows, smem, stream>>>(
      ids_a, ids_b, w, n, k, a_pad, b_pad, chunk, chunks, partial);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return quatro::launch_chunk_sum(partial, bsz, chunks, k * a_pad * b_pad, out, stream);
}
