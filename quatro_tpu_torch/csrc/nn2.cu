// Top-2 nearest neighbours of each 33-D descriptor row of A among B's rows.
//
// Replaces quatro_tpu/ops/pallas_frontend.py::nearest_neighbors2_pallas
// (_nn2_kernel), with its tie rule kept exactly:
//   d2 = max((|a|^2 - 2 a.b) + |b|^2, 0); masked pairs get FLT_MAX;
//   columns are visited in chunks of `chunk` (2048 where it divides Nb,
//   else all of Nb: ops/frontend.py::_nn_chunk);
//   inside a chunk the first minimum wins, then the first minimum of the
//   remaining columns; each chunk's pair merges into the running pair by
//   the strict-less rules of the TPU kernel (earlier chunks win ties).
// The wrapper (ops/frontend.py) supplies |a|^2 and |b|^2 and sets the
// outputs of invalid rows and empty slots to index 0 / FLT_MAX.
//
// Bound on the card: operations. 2 x 33 f32 operations per (a, b) pair,
// 4.4 GFLOP per direction at 8192 x 8192, against 2.2 MB of input.
// Design: one thread per A row holds its descriptor in 33 registers; the
// block stages kTile B rows in shared memory, read by all threads at the
// same address (broadcast). The dot product runs over the 33 components
// in order with FMAs, the same for every column, so identical B rows give
// identical distances and the tie rule decides between them. No tensor
// cores: a TF32 product would blur the near-ties the matcher relies on.
#include <cfloat>

#include "common.cuh"

namespace quatro {

namespace {
constexpr int kDim = 33;
constexpr int kTile = 64;
}

__global__ void __launch_bounds__(kRows)
nn2_kernel(const float* __restrict__ a, const float* __restrict__ bdesc,
           const float* __restrict__ sqa, const float* __restrict__ sqb,
           const float* __restrict__ ma, const float* __restrict__ mb, int na,
           int nb, int chunk, int* __restrict__ i1o, float* __restrict__ d1o,
           int* __restrict__ i2o, float* __restrict__ d2o) {
  const int bt = blockIdx.y;
  const float* A = a + (size_t)bt * na * kDim;
  const float* B = bdesc + (size_t)bt * nb * kDim;
  const float* SB = sqb + (size_t)bt * nb;
  const float* MB = mb + (size_t)bt * nb;
  const int i = blockIdx.x * kRows + threadIdx.x;
  __shared__ float sb[kTile * kDim], ssq[kTile], smk[kTile];

  const bool live = i < na && ma[(size_t)bt * na + i] > 0.f;
  float row[kDim];
  float sa = 0.f;
#pragma unroll
  for (int k = 0; k < kDim; ++k) row[k] = live ? A[(size_t)i * kDim + k] : 0.f;
  if (live) sa = sqa[(size_t)bt * na + i];

  // running pair (rd1, ri1) <= (rd2, ri2) and the current chunk's pair
  float rd1 = FLT_MAX, rd2 = FLT_MAX, cd1 = FLT_MAX, cd2 = FLT_MAX;
  int ri1 = 0, ri2 = 0, ci1 = 0, ci2 = 0;

  for (int c0 = 0; c0 < nb; c0 += kTile) {
    const int n = min(kTile, nb - c0);
    for (int e = threadIdx.x; e < n * kDim; e += kRows) sb[e] = B[(size_t)c0 * kDim + e];
    for (int t = threadIdx.x; t < n; t += kRows) {
      ssq[t] = SB[c0 + t];
      smk[t] = MB[c0 + t];
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < n; ++t) {
        const int j = c0 + t;
        if (j % chunk == 0) {          // a new chunk starts at column j
          cd1 = FLT_MAX; cd2 = FLT_MAX; ci1 = j; ci2 = j;
        }
        float d = FLT_MAX;
        if (smk[t] > 0.f) {
          const float* col = sb + t * kDim;
          float dot = 0.f;
#pragma unroll
          for (int k = 0; k < kDim; ++k) dot = fmaf(row[k], col[k], dot);
          d = fmaxf(add(sub(sa, mul(2.f, dot)), ssq[t]), 0.f);
        }
        if (d < cd1) {
          cd2 = cd1; ci2 = ci1; cd1 = d; ci1 = j;
        } else if (d < cd2) {
          cd2 = d; ci2 = j;
        }
        if ((j + 1) % chunk == 0 || j + 1 == nb) {   // merge the chunk
          const bool w1 = cd1 < rd1;
          float nd1 = w1 ? cd1 : rd1;
          int ni1 = w1 ? ci1 : ri1;
          float nd2 = w1 ? rd1 : cd1;   // the loser of the first slot
          int ni2 = w1 ? ri1 : ci1;
          if (rd2 < nd2) { nd2 = rd2; ni2 = ri2; }
          if (cd2 < nd2) { nd2 = cd2; ni2 = ci2; }
          rd1 = nd1; ri1 = ni1; rd2 = nd2; ri2 = ni2;
        }
      }
    }
    __syncthreads();
  }
  if (i < na) {
    const size_t o = (size_t)bt * na + i;
    i1o[o] = ri1; d1o[o] = rd1; i2o[o] = ri2; d2o[o] = rd2;
  }
}

}  // namespace quatro

// desc_a (B, Na, 33), desc_b (B, Nb, 33) f32; sq_a (B, Na), sq_b (B, Nb)
// squared norms; masks (B, Na), (B, Nb) f32 0/1; chunk divides Nb
//   -> i1, i2 (B, Na) int32 and d1, d2 (B, Na) f32.
extern "C" int quatro_nn2(const float* a, const float* b, const float* sqa,
                          const float* sqb, const float* ma, const float* mb,
                          int batch, int na, int nb, int chunk, int* i1, float* d1,
                          int* i2, float* d2, cudaStream_t stream) {
  dim3 grid((na + quatro::kRows - 1) / quatro::kRows, batch);
  quatro::nn2_kernel<<<grid, quatro::kRows, 0, stream>>>(a, b, sqa, sqb, ma, mb, na,
                                                         nb, chunk, i1, d1, i2, d2);
  return (int)cudaGetLastError();
}
