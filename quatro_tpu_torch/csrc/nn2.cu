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
// The dot product a.b is taken from 0, one round-to-nearest multiply and
// one add per component, in component order: the plain version
// (ops/frontend.py::_ordered_dot) does the same, so given the same |a|^2
// and |b|^2, which the wrapper supplies, kernel and plain version agree
// bit for bit on any host. The wrapper sets the outputs of invalid rows
// and empty slots to index 0 / FLT_MAX.
//
// Bound on the card: operations. 2 x 33 f32 operations per (a, b) pair of
// valid rows: 2.4 GFLOP per direction at path A's 3034 x 2413 valid
// descriptors, against 2.2 MB of input.
// Design (B6's, csrc/nn1.cu, with top-2 bookkeeping and the TPU kernel's
// active limits):
// - a block of 128 threads owns 16 A rows; the 8 threads of a row
//   (neighbouring lanes of one warp) each hold the row in 33 registers and
//   take every 8th column of a tile of 256 B rows staged in shared memory
//   (padded to 36 floats, so each thread reads a column with nine 16-byte
//   loads: the 8 lanes hit 32 distinct banks, the 4 rows of a warp read
//   the same words). Each thread keeps its own top-2 of the current chunk,
//   in column order;
// - the chunk bookkeeping is per tile, not per column: 256 divides 2048,
//   and where the chunk is all of Nb the last tile closes it. At a chunk's
//   end the 8 lanes' pairs merge by shuffles in (d, index) order, which for
//   distinct columns is the sequential "first minimum, then the first
//   minimum of the rest", and the merged pair merges into the running one
//   by the strict-less rules;
// - active limits (the TPU kernel's _nn_active_limits): lim[b] holds one
//   past the last valid row and one past the last valid column of batch
//   entry b, found on the card by the wrapper. Blocks past the last valid
//   row only write the empty result; the column loop stops at the tile of
//   the last valid column. This is exact: a masked column has FLT_MAX,
//   which never wins a strict-less comparison, and any slot left at
//   FLT_MAX is refilled by the wrapper.
// No float atomics and no tensor cores (a TF32 product would blur the
// near-ties the matcher relies on): a run repeats bit for bit.
#include <cfloat>

#include "common.cuh"

namespace quatro {

namespace {
constexpr int kDim = 33;
constexpr int kPad = 36;                   // staged floats per column
constexpr int kLanes = 8;                  // threads per A row
constexpr int kRowsPerBlock = 16;
constexpr int kThreads = kLanes * kRowsPerBlock;
constexpr int kTile = 256;                 // B rows staged per step

// (d, i) before (e, j) in (distance, index) order
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}
}  // namespace

__global__ void __launch_bounds__(kThreads)
nn2_kernel(const float* __restrict__ a, const float* __restrict__ bdesc,
           const float* __restrict__ sqa, const float* __restrict__ sqb,
           const float* __restrict__ ma, const float* __restrict__ mb,
           const int* __restrict__ lim, int na, int nb, int chunk,
           int* __restrict__ i1o, float* __restrict__ d1o,
           int* __restrict__ i2o, float* __restrict__ d2o) {
  const int bt = blockIdx.y;
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  const size_t o = (size_t)bt * na + i;
  if (blockIdx.x * kRowsPerBlock >= lim[2 * bt]) {   // no valid row here
    if (i < na && lane == 0) {
      i1o[o] = 0; d1o[o] = FLT_MAX; i2o[o] = 0; d2o[o] = FLT_MAX;
    }
    return;
  }
  const int c_end = lim[2 * bt + 1];
  const float* A = a + (size_t)bt * na * kDim;
  const float* B = bdesc + (size_t)bt * nb * kDim;
  const float* SB = sqb + (size_t)bt * nb;
  const float* MB = mb + (size_t)bt * nb;
  __shared__ __align__(16) float sb[kTile * kPad];
  __shared__ float ssq[kTile], smk[kTile];

  const bool live = i < na && ma[o] > 0.f;
  float row[kDim];
  float sa = 0.f;
#pragma unroll
  for (int k = 0; k < kDim; ++k) row[k] = live ? A[(size_t)i * kDim + k] : 0.f;
  if (live) sa = sqa[o];

  // running pair (rd1, ri1) <= (rd2, ri2); this thread's pair of the chunk
  float rd1 = FLT_MAX, rd2 = FLT_MAX, cd1 = FLT_MAX, cd2 = FLT_MAX;
  int ri1 = 0, ri2 = 0, ci1 = 0, ci2 = 0;

  for (int c0 = 0; c0 < c_end; c0 += kTile) {
    const int n = min(kTile, nb - c0);
    for (int e = threadIdx.x; e < n * kDim; e += kThreads) {
      const int t = e / kDim;
      sb[t * kPad + (e - t * kDim)] = B[(size_t)c0 * kDim + e];
    }
    for (int t = threadIdx.x; t < n; t += kThreads) {
      ssq[t] = SB[c0 + t];
      smk[t] = MB[c0 + t];
    }
    __syncthreads();
    if (live) {
      for (int t = lane; t < n; t += kLanes) {
        if (!(smk[t] > 0.f)) continue;
        const float4* col = reinterpret_cast<const float4*>(sb + t * kPad);
        float dot = 0.f;
#pragma unroll
        for (int q = 0; q < kPad / 4; ++q) {
          const float4 v = col[q];
          dot = add(dot, mul(row[4 * q], v.x));
          if (4 * q + 1 < kDim) dot = add(dot, mul(row[4 * q + 1], v.y));
          if (4 * q + 2 < kDim) dot = add(dot, mul(row[4 * q + 2], v.z));
          if (4 * q + 3 < kDim) dot = add(dot, mul(row[4 * q + 3], v.w));
        }
        const float d = fmaxf(add(sub(sa, mul(2.f, dot)), ssq[t]), 0.f);
        const int j = c0 + t;
        if (d < cd1) {
          cd2 = cd1; ci2 = ci1; cd1 = d; ci1 = j;
        } else if (d < cd2) {
          cd2 = d; ci2 = j;
        }
      }
    }
    const int next = c0 + kTile;
    if (next % chunk == 0 || next >= c_end) {   // the chunk ends here
      // the 8 lanes' pairs in (d, index) order
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2) {
        const float od1 = __shfl_xor_sync(0xffffffffu, cd1, off);
        const int oi1 = __shfl_xor_sync(0xffffffffu, ci1, off);
        const float od2 = __shfl_xor_sync(0xffffffffu, cd2, off);
        const int oi2 = __shfl_xor_sync(0xffffffffu, ci2, off);
        if (before(od1, oi1, cd1, ci1)) {       // the other's first leads
          const bool keep = before(cd1, ci1, od2, oi2);
          cd2 = keep ? cd1 : od2; ci2 = keep ? ci1 : oi2;
          cd1 = od1; ci1 = oi1;
        } else if (before(od1, oi1, cd2, ci2)) {
          cd2 = od1; ci2 = oi1;
        }
      }
      // into the running pair, earlier chunks winning ties
      const bool w1 = cd1 < rd1;
      float nd1 = w1 ? cd1 : rd1;
      int ni1 = w1 ? ci1 : ri1;
      float nd2 = w1 ? rd1 : cd1;    // the loser of the first slot
      int ni2 = w1 ? ri1 : ci1;
      if (rd2 < nd2) { nd2 = rd2; ni2 = ri2; }
      if (cd2 < nd2) { nd2 = cd2; ni2 = ci2; }
      rd1 = nd1; ri1 = ni1; rd2 = nd2; ri2 = ni2;
      cd1 = FLT_MAX; cd2 = FLT_MAX; ci1 = next; ci2 = next;
    }
    __syncthreads();
  }
  if (i < na && lane == 0) {
    i1o[o] = ri1; d1o[o] = rd1; i2o[o] = ri2; d2o[o] = rd2;
  }
}

}  // namespace quatro

// desc_a (B, Na, 33), desc_b (B, Nb, 33) f32; sq_a (B, Na), sq_b (B, Nb)
// squared norms; masks (B, Na), (B, Nb) f32 0/1; lim (B, 2) int32, one
// past the last valid row and column; chunk divides Nb
//   -> i1, i2 (B, Na) int32 and d1, d2 (B, Na) f32.
extern "C" int quatro_nn2(const float* a, const float* b, const float* sqa,
                          const float* sqb, const float* ma, const float* mb,
                          const int* lim, int batch, int na, int nb, int chunk,
                          int* i1, float* d1, int* i2, float* d2,
                          cudaStream_t stream) {
  dim3 grid((na + quatro::kRowsPerBlock - 1) / quatro::kRowsPerBlock, batch);
  quatro::nn2_kernel<<<grid, quatro::kThreads, 0, stream>>>(
      a, b, sqa, sqb, ma, mb, lim, na, nb, chunk, i1, d1, i2, d2);
  return (int)cudaGetLastError();
}
