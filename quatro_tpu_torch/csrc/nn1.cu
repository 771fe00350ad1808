// Nearest neighbour (1-NN) of each 33-D descriptor row of A among B's rows.
//
// Replaces quatro_tpu/ops/pallas_frontend.py::nearest_neighbors_pallas
// (_nn_kernel), with its tie rule kept exactly:
//   d2 = max((|a|^2 - 2 a.b) + |b|^2, 0); masked pairs get FLT_MAX;
//   the first minimum wins. The TPU kernel takes the lowest index within a
//   2048-column chunk and replaces across chunks only on strictly less, so
//   over all columns it is argmin's first minimum; a scan of the columns in
//   order that replaces only on strictly less is the same rule, and needs
//   no chunk bookkeeping.
// The wrapper (ops/frontend.py) supplies |a|^2 and |b|^2 and sets the
// outputs of invalid rows and of rows with no valid column to index 0 /
// FLT_MAX. The per-pair arithmetic is nn2.cu's (the dot product from 0,
// one round-to-nearest multiply and one add per component in component
// order, then the expansion), so this kernel's (index, d2) equal the first
// slot of the top-2 kernel bit for bit, and the plain version's
// (ops/frontend.py::_ordered_dot) given the same |a|^2 and |b|^2.
//
// Bound on the card: operations. 2 x 33 f32 operations per (a, b) pair,
// 4.4 GFLOP at 8192 x 8192 (0.066 ms at 67 TFLOP/s), against 2.2 MB of
// input (0.0007 ms at 3.35 TB/s).
// Design: a block of 256 threads owns 32 A rows; the 8 threads of a row
// (neighbouring lanes of one warp) each hold the row in 33 registers and
// take every 8th column of the tile of 256 B rows staged in shared memory
// (bank (col + k) mod 32: the 8 lanes hit 8 banks, the 4 rows of a warp
// read the same words). Each thread keeps its own first minimum; the 8 are
// merged by warp shuffles, the smaller distance winning and the lower index
// on equal distances, which is the first minimum over all columns. 256
// blocks at Na = 8192, where one row per thread would give 64. No float
// atomics and no tensor cores (a TF32 product would blur the near-ties the
// matcher relies on): a run repeats bit for bit.
#include <cfloat>

#include "common.cuh"

namespace quatro {

namespace {
constexpr int kDim = 33;
constexpr int kLanes = 8;                  // threads per A row
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kLanes * kRowsPerBlock;
constexpr int kTile = 256;                 // B rows staged per step
}

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ a, const float* __restrict__ bdesc,
           const float* __restrict__ sqa, const float* __restrict__ sqb,
           const float* __restrict__ ma, const float* __restrict__ mb, int na,
           int nb, int* __restrict__ idx_out, float* __restrict__ d_out) {
  const int bt = blockIdx.y;
  const float* A = a + (size_t)bt * na * kDim;
  const float* B = bdesc + (size_t)bt * nb * kDim;
  const float* SB = sqb + (size_t)bt * nb;
  const float* MB = mb + (size_t)bt * nb;
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  __shared__ float sb[kTile * kDim], ssq[kTile], smk[kTile];

  const bool live = i < na && ma[(size_t)bt * na + i] > 0.f;
  float row[kDim];
  float sa = 0.f;
#pragma unroll
  for (int k = 0; k < kDim; ++k) row[k] = live ? A[(size_t)i * kDim + k] : 0.f;
  if (live) sa = sqa[(size_t)bt * na + i];

  float best = FLT_MAX;
  int best_i = 0;
  for (int c0 = 0; c0 < nb; c0 += kTile) {
    const int n = min(kTile, nb - c0);
    for (int e = threadIdx.x; e < n * kDim; e += kThreads)
      sb[e] = B[(size_t)c0 * kDim + e];
    for (int t = threadIdx.x; t < n; t += kThreads) {
      ssq[t] = SB[c0 + t];
      smk[t] = MB[c0 + t];
    }
    __syncthreads();
    if (live) {
      for (int t = lane; t < n; t += kLanes) {
        if (smk[t] > 0.f) {
          const float* col = sb + t * kDim;
          float dot = 0.f;
#pragma unroll
          for (int k = 0; k < kDim; ++k) dot = add(dot, mul(row[k], col[k]));
          const float d = fmaxf(add(sub(sa, mul(2.f, dot)), ssq[t]), 0.f);
          if (d < best) {
            best = d;
            best_i = c0 + t;
          }
        }
      }
    }
    __syncthreads();
  }
  // merge the 8 lanes of the row: smaller distance, then lower index
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    const float od = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (od < best || (od == best && oi < best_i)) {
      best = od;
      best_i = oi;
    }
  }
  if (i < na && lane == 0) {
    const size_t o = (size_t)bt * na + i;
    idx_out[o] = best_i;
    d_out[o] = best;
  }
}

}  // namespace quatro

// desc_a (B, Na, 33), desc_b (B, Nb, 33) f32; sq_a (B, Na), sq_b (B, Nb)
// squared norms; masks (B, Na), (B, Nb) f32 0/1 -> idx (B, Na) int32 and
// d2 (B, Na) f32.
extern "C" int quatro_nn1(const float* a, const float* b, const float* sqa,
                          const float* sqb, const float* ma, const float* mb,
                          int batch, int na, int nb, int* idx, float* d2,
                          cudaStream_t stream) {
  dim3 grid((na + quatro::kRowsPerBlock - 1) / quatro::kRowsPerBlock, batch);
  quatro::nn1_kernel<<<grid, quatro::kThreads, 0, stream>>>(a, b, sqa, sqb, ma, mb,
                                                            na, nb, idx, d2);
  return (int)cudaGetLastError();
}
