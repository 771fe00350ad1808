// Per-point delivery of a per-group table row.
//
// Replaces quatro_tpu/ops/segment_matmul.py::table_lookup (_lookup_kernel):
// out[b, q, i] = tab[b, ids[b, i], q], zeros for ids outside [0, p_pad);
// ids (B, N) int32, tab (B, p_pad, K) f32, out (B, K, N) f32, K-major. The
// TPU kernel delivers the rows through a bf16 one-hot MXU contraction split
// three ways so that it is exact, because a gather is slow there; on the
// card the same function is a plain gather, and since it only copies, the
// output equals the plain version (ops/segment.py::table_lookup_plain) bit
// for bit.
//
// Bound on the card: bytes. At the Patchwork shapes (B = 2, N = 131072,
// K = 5, p_pad = 512) ids, table and output are 6.3 MB, 1.9 us at
// 3.35 TB/s; there is no arithmetic.
// Design: a block stages its cloud's table (p_pad x K floats, 10 KB at
// those shapes) in shared memory once and then serves kPointsPerThread
// tiles of 256 points, so the staging is read 64 times per cloud rather
// than once per 256 points. One thread per point of a tile; each thread
// writes its K values at stride N, so the stores of a warp coalesce along N.
#include <cuda_runtime.h>

namespace quatro {

constexpr int kLookupThreads = 256;
constexpr int kPointsPerThread = 8;

__global__ void __launch_bounds__(kLookupThreads)
table_lookup_kernel(const int* __restrict__ ids, const float* __restrict__ tab, int n,
                    int p_pad, int k, float* __restrict__ out) {
  extern __shared__ float stab[];           // [p_pad][k]
  const int b = blockIdx.y;
  const float* tb = tab + (size_t)b * p_pad * k;
  for (int i = threadIdx.x; i < p_pad * k; i += kLookupThreads) stab[i] = tb[i];
  __syncthreads();
  const int* ib = ids + (size_t)b * n;
  float* ob = out + (size_t)b * k * n;
  const int base = blockIdx.x * kLookupThreads * kPointsPerThread + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kPointsPerThread; ++r) {
    const int e = base + r * kLookupThreads;
    if (e < n) {
      const int id = ib[e];
      const bool in = id >= 0 && id < p_pad;
      const float* row = stab + (in ? id : 0) * k;
      for (int q = 0; q < k; ++q) ob[(size_t)q * n + e] = in ? row[q] : 0.f;
    }
  }
}

}  // namespace quatro

// ids (B, N) int32, tab (B, p_pad, K) f32 -> out (B, K, N) f32.
extern "C" int quatro_table_lookup(const int* ids, const float* tab, int bsz, int n,
                                   int p_pad, int k, float* out, cudaStream_t stream) {
  const int smem = p_pad * k * (int)sizeof(float);
  int rc = (int)cudaFuncSetAttribute(quatro::table_lookup_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const int per_block = quatro::kLookupThreads * quatro::kPointsPerThread;
  dim3 grid((n + per_block - 1) / per_block, bsz);
  quatro::table_lookup_kernel<<<grid, quatro::kLookupThreads, smem, stream>>>(ids, tab, n,
                                                                              p_pad, k, out);
  return (int)cudaGetLastError();
}
