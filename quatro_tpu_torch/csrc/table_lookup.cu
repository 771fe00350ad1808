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
// 3.35 TB/s; there is no arithmetic. A kernel of a few microseconds is
// bound by its round trips to memory as much as by its bytes.
// Design: a thread serves 4 consecutive points of one cloud, 256 threads a
// block, so 128 blocks per cloud at those shapes (two per SM for B = 2):
// - the thread's 4 ids are one 16-byte load, issued before the table is
//   staged, so the ids' and the table's trips to memory overlap;
// - the table (p_pad x K floats, 10 KB there) is staged in shared memory
//   by every block; reading it through the read-only path (__ldg, L1- and
//   L2-resident) instead took 1.2x as long at those shapes (H100 80GB
//   HBM3, 700 W);
// - per channel q the 4 values are one 16-byte store where the output row
//   b, q is 16-byte aligned at the thread's points; a row that is not
//   (N % 4 != 0 puts rows at every 4-byte offset) and the ragged tail of
//   N take 4-byte loads and stores, inside the same kernel. Alignment is
//   decided from the addresses themselves, so views at any offset work.
#include <cstdint>

#include <cuda_runtime.h>

namespace quatro {

constexpr int kLookupThreads = 256;
constexpr int kLookupPoints = 4;           // points a thread: one int4, one float4

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kLookupThreads)
table_lookup_kernel(const int* __restrict__ ids, const float* __restrict__ tab, int n,
                    int p_pad, int k, float* __restrict__ out) {
  extern __shared__ float stab[];           // [p_pad][k]
  const int b = blockIdx.y;
  const int i0 = (blockIdx.x * kLookupThreads + threadIdx.x) * kLookupPoints;
  const int* ib = ids + (size_t)b * n + i0;
  const float* tb = tab + (size_t)b * p_pad * k;
  const bool full = i0 + kLookupPoints <= n;
  int id[kLookupPoints];
  if (full && aligned16(ib)) {
    const int4 v = *reinterpret_cast<const int4*>(ib);
    id[0] = v.x; id[1] = v.y; id[2] = v.z; id[3] = v.w;
  } else {
#pragma unroll
    for (int u = 0; u < kLookupPoints; ++u) id[u] = i0 + u < n ? ib[u] : -1;
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < p_pad * k; e += kLookupThreads) stab[e] = tb[e];
  __syncthreads();
  if (i0 >= n) return;
  int row[kLookupPoints];                   // row offset, or -1 out of range
#pragma unroll
  for (int u = 0; u < kLookupPoints; ++u)
    row[u] = id[u] >= 0 && id[u] < p_pad ? id[u] * k : -1;
  float* ob = out + (size_t)b * k * n + i0;
  for (int q = 0; q < k; ++q) {
    float v[kLookupPoints];
#pragma unroll
    for (int u = 0; u < kLookupPoints; ++u)
      v[u] = row[u] < 0 ? 0.f : stab[row[u] + q];
    float* o = ob + (size_t)q * n;
    if (full && aligned16(o)) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int u = 0; u < kLookupPoints; ++u)
        if (i0 + u < n) o[u] = v[u];
    }
  }
}

}  // namespace quatro

// ids (B, N) int32, tab (B, p_pad, K) f32 -> out (B, K, N) f32; p_pad * K
// floats must fit in shared memory.
extern "C" int quatro_table_lookup(const int* ids, const float* tab, int bsz, int n,
                                   int p_pad, int k, float* out, cudaStream_t stream) {
  if (bsz <= 0 || n <= 0 || k <= 0) return 0;
  const int smem = p_pad * k * (int)sizeof(float);
  int rc = (int)cudaFuncSetAttribute(quatro::table_lookup_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const int per_block = quatro::kLookupThreads * quatro::kLookupPoints;
  dim3 grid((n + per_block - 1) / per_block, bsz);
  quatro::table_lookup_kernel<<<grid, quatro::kLookupThreads, smem, stream>>>(ids, tab, n,
                                                                              p_pad, k, out);
  return (int)cudaGetLastError();
}
