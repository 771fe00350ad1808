// Segment sums over a small group axis.
//
// Replaces quatro_tpu/ops/segment_matmul.py::segment_sums (_seg_kernel):
//   out[p, k] = sum over i with ids[i] == p of vals[k, i],
// ids (N,) int32, vals (K, N) f32, out (p_pad, K) f32; ids outside
// [0, p_pad) are dropped. The TPU kernel builds one-hot tiles for the MXU
// in a 3-term bf16 split because the TPU has no cheap scatter; none of
// that carries over.
//
// Bound on the card: bytes. On the vote's shape (N = 65536, K = 3,
// p_pad = 256) the inputs are 1.05 MB, 0.31 us at 3.35 TB/s, and the
// 0.2 M additions are nothing, so the two launches cost more than the work.
// Design, with no float atomics so a run repeats bit for bit:
// 1. each block takes a chunk of `chunk` consecutive entries and 256
//    bins; its threads stage the entries' ids and 8 value channels at a
//    time in shared memory, and each thread, owning one bin, adds the
//    values of its bin's entries in index order into registers, then
//    writes the chunk's partial sums;
// 2. one thread per (bin, channel) adds the chunks' partials in chunk
//    order.
// Each entry is compared against every bin of its block (N x p_pad
// compares), which suits the small group axes of the port (256 vote bins,
// 640 Patchwork patches).
#include <cuda_runtime.h>

namespace quatro {

constexpr int kSegBins = 256;    // threads per block = bins per block
constexpr int kSegTile = 256;    // entries staged per step
constexpr int kSegGroup = 8;     // value channels summed per pass

__global__ void __launch_bounds__(kSegBins)
segment_partials_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                        int n, int k, int p_pad, int chunk,
                        float* __restrict__ partial) {
  __shared__ int sid[kSegTile];
  __shared__ float sv[kSegGroup][kSegTile];
  const int c = blockIdx.x;
  const int p = blockIdx.y * kSegBins + threadIdx.x;
  const int e0 = c * chunk;
  const int e1 = min(n, e0 + chunk);
  for (int k0 = 0; k0 < k; k0 += kSegGroup) {
    const int kg = min(kSegGroup, k - k0);
    float acc[kSegGroup];
#pragma unroll
    for (int g = 0; g < kSegGroup; ++g) acc[g] = 0.f;
    for (int t0 = e0; t0 < e1; t0 += kSegTile) {
      const int m = min(kSegTile, e1 - t0);
      for (int t = threadIdx.x; t < kSegTile; t += kSegBins) {
        sid[t] = t < m ? ids[t0 + t] : -1;
#pragma unroll
        for (int g = 0; g < kSegGroup; ++g)
          sv[g][t] = (t < m && g < kg) ? vals[(size_t)(k0 + g) * n + t0 + t] : 0.f;
      }
      __syncthreads();
      for (int t = 0; t < m; ++t) {
        if (sid[t] == p) {
#pragma unroll
          for (int g = 0; g < kSegGroup; ++g) acc[g] += sv[g][t];
        }
      }
      __syncthreads();
    }
    if (p < p_pad) {
      float* o = partial + ((size_t)c * p_pad + p) * k + k0;
      for (int g = 0; g < kg; ++g) o[g] = acc[g];
    }
  }
}

__global__ void segment_reduce_kernel(const float* __restrict__ partial, int chunks,
                                      int pk, float* __restrict__ out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= pk) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * pk + o];
  out[o] = s;
}

}  // namespace quatro

// ids (N,) int32, vals (K, N) f32, partial (ceil(N / chunk), p_pad, K) f32
// scratch -> out (p_pad, K) f32.
extern "C" int quatro_segment_sums(const int* ids, const float* vals, int n, int k,
                                   int p_pad, int chunk, float* partial, float* out,
                                   cudaStream_t stream) {
  const int chunks = (n + chunk - 1) / chunk;
  dim3 grid(chunks, (p_pad + quatro::kSegBins - 1) / quatro::kSegBins);
  quatro::segment_partials_kernel<<<grid, quatro::kSegBins, 0, stream>>>(
      ids, vals, n, k, p_pad, chunk, partial);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int pk = p_pad * k;
  quatro::segment_reduce_kernel<<<(pk + 255) / 256, 256, 0, stream>>>(partial, chunks,
                                                                     pk, out);
  return (int)cudaGetLastError();
}
