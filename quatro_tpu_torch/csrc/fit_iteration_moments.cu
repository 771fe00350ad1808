// One Patchwork plane-fit iteration: table delivery, membership and the ten
// moment sums, fused.
//
// Replaces quatro_tpu/ops/segment_matmul.py::fit_iteration_moments
// (_fit_kernel). Per cloud b and point i with patch id p = ids[b, i]:
//   row    = tab[b, p] = [n1, n2, n3, th, _] (zeros outside [0, p_pad)),
//   member = p < p_cnt and (n1 x + n2 y) + n3 z < th,
//   mom    = [1, px, py, z, px px, px py, px z, py py, py z, z z] if member,
//            else 0, each rounded to bf16 (to nearest even) when !exact,
//   out[b, p, :] = sum of mom over the points of patch p,
// chan (B, 5, N) = [x, y, z, px, py], out (B, p_pad, 10) f32. The TPU kernel
// delivers the table through a one-hot MXU contraction and sums the moments
// through another in a 3-term bf16 split (1 term when !exact); here a point
// reads its row and the sums are f32 in shared memory.
//
// Bound on the card: bytes. On the main path (B = 2, N = 131072, p_pad 512)
// the inputs and the output are 6.3 MB, 1.9 us at 3.35 TB/s, against 5.5 M
// f32 operations (0.08 us at 67 TFLOP/s).
// Design, with no float atomics so a run repeats bit for bit, as B2
// (segment_sums.cu):
// 1. a block takes a chunk of `chunk` consecutive points and 256 patches;
//    it stages the table (p_pad x 5 floats, 10 KB) in shared memory; for
//    each tile of 256 points each thread computes one point's membership
//    and moments into shared memory, then each thread, owning one patch,
//    adds the moments of its patch's points in index order in registers,
//    and writes the chunk's partial sums;
// 2. one thread per output adds the chunks' partials in chunk order
//    (chunk_sum.cuh).
// Membership and the products use the round-to-nearest intrinsics in the
// plain version's order, so kernel and plain version take the same
// membership decisions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chunk_sum.cuh"
#include "patchwork.cuh"

namespace quatro {

constexpr int kFitBins = 256;   // threads per block = patches per block
constexpr int kMoments = 10;

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kFitBins)
fit_partials_kernel(const int* __restrict__ ids, const float* __restrict__ chan,
                    const float* __restrict__ tab, int n, int p_pad, int p_cnt, int exact,
                    int chunk, int chunks, float* __restrict__ partial) {
  extern __shared__ float stab[];           // [p_pad][5]
  __shared__ int sid[kFitBins];
  __shared__ float smom[kMoments][kFitBins];
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int p = blockIdx.y * kFitBins + t;
  const int* ib = ids + (size_t)b * n;
  const float* cb = chan + (size_t)b * kTabCols * n;
  const float* tb = tab + (size_t)b * p_pad * kTabCols;
  for (int i = t; i < p_pad * kTabCols; i += kFitBins) stab[i] = tb[i];
  float acc[kMoments];
#pragma unroll
  for (int g = 0; g < kMoments; ++g) acc[g] = 0.f;
  const int e0 = c * chunk;
  const int e1 = min(n, e0 + chunk);
  for (int t0 = e0; t0 < e1; t0 += kFitBins) {
    __syncthreads();   // the table is staged, the previous tile consumed
    const int e = t0 + t;
    int id = -1;
    float mom[kMoments];
#pragma unroll
    for (int g = 0; g < kMoments; ++g) mom[g] = 0.f;
    if (e < e1) {
      id = ib[e];
      const float x = cb[e], y = cb[(size_t)n + e], z = cb[2 * (size_t)n + e];
      const float px = cb[3 * (size_t)n + e], py = cb[4 * (size_t)n + e];
      float row[kTabCols];
      deliver_row(stab, p_pad, id, row);
      if (id < p_cnt && plane_proj(row, x, y, z) < row[3]) {
        mom[0] = 1.f;
        mom[1] = px;
        mom[2] = py;
        mom[3] = z;
        mom[4] = mul(px, px);
        mom[5] = mul(px, py);
        mom[6] = mul(px, z);
        mom[7] = mul(py, py);
        mom[8] = mul(py, z);
        mom[9] = mul(z, z);
        if (!exact) {
#pragma unroll
          for (int g = 0; g < kMoments; ++g) mom[g] = to_bf16(mom[g]);
        }
      }
    }
    sid[t] = id;
#pragma unroll
    for (int g = 0; g < kMoments; ++g) smom[g][t] = mom[g];
    __syncthreads();
    const int m = min(kFitBins, e1 - t0);
    for (int j = 0; j < m; ++j) {
      if (sid[j] == p) {
#pragma unroll
        for (int g = 0; g < kMoments; ++g) acc[g] += smom[g][j];
      }
    }
  }
  if (p < p_pad) {
    float* o = partial + (((size_t)b * chunks + c) * p_pad + p) * kMoments;
#pragma unroll
    for (int g = 0; g < kMoments; ++g) o[g] = acc[g];
  }
}

}  // namespace quatro

// ids (B, N) int32, chan (B, 5, N) f32, tab (B, p_pad, 5) f32, partial
// (B, ceil(N / chunk), p_pad, 10) f32 scratch -> out (B, p_pad, 10) f32.
extern "C" int quatro_fit_iteration_moments(const int* ids, const float* chan,
                                            const float* tab, int bsz, int n, int p_pad,
                                            int p_cnt, int exact, int chunk, float* partial,
                                            float* out, cudaStream_t stream) {
  const int chunks = (n + chunk - 1) / chunk;
  const int smem = p_pad * quatro::kTabCols * (int)sizeof(float);
  int rc = (int)cudaFuncSetAttribute(quatro::fit_partials_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  dim3 grid(chunks, (p_pad + quatro::kFitBins - 1) / quatro::kFitBins, bsz);
  quatro::fit_partials_kernel<<<grid, quatro::kFitBins, smem, stream>>>(
      ids, chan, tab, n, p_pad, p_cnt, exact, chunk, chunks, partial);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return quatro::launch_chunk_sum(partial, bsz, chunks, p_pad * quatro::kMoments, out,
                                  stream);
}
