// Nearest neighbour (1-NN) of each 33-D descriptor row of A among B's rows.
//
// Replaces quatro_tpu/ops/pallas_frontend.py::nearest_neighbors_pallas
// (_nn_kernel, launched at pallas_frontend.py:652), with its tie rule kept
// exactly:
//   d2 = max((|a|^2 - 2 a.b) + |b|^2, 0); masked pairs get FLT_MAX;
//   the first minimum wins. The TPU kernel takes the lowest index within a
//   2048-column chunk and replaces across chunks only on strictly less, so
//   over all columns it is argmin's first minimum: the least (d2, index)
//   pair in lexicographic order. That order is associative and
//   commutative, so the columns can be split across threads and blocks
//   and the pieces merged in any order without changing a bit.
// The wrapper (ops/frontend.py) supplies |a|^2, |b|^2 and the active
// limits, and sets the outputs of invalid rows and of rows with no valid
// column to index 0 / FLT_MAX. The per-pair arithmetic is nn2.cu's (the
// dot product from 0, one round-to-nearest multiply and one add per
// component in component order, never fused, then the expansion), so this
// kernel's (index, d2) equal the first slot of the top-2 kernel bit for
// bit, and the plain version's (ops/frontend.py::_ordered_dot) given the
// same |a|^2 and |b|^2.
//
// Bound on the card: operations. 70 f32 operations per pair of valid rows
// (chip_smoke.py's OPS_NN1), 0.0054 ms at path B's 2429 x 2172 valid
// descriptors and 67 TFLOP/s. The kernel issues 66 unfused FP32
// instructions per pair (33 multiplies, 33 adds), and the FP32 pipe
// issues one a lane a clock, so its own floor is about twice that bound,
// ~0.011 ms there; the input (2.2 MB) is far below either.
// Design:
// - active limits (the TPU kernel's _nn_active_limits): lim[b] holds one
//   past the last valid row and one past the last valid column of batch
//   entry b, found on the card by the wrapper and never read back. The
//   voxel grid packs its occupied voxels at the front, so on path B the
//   limits cut ~85 % of the pairs;
// - work items of 64 A rows x one split of 256 B columns: the grid
//   covers every (row tile, split) of the full (Na, Nb); blocks past the
//   row limit write the empty result (index 0, FLT_MAX) for their rows
//   (split 0) or exit, and blocks past the column limit exit, so path B's
//   ~38 x 9 busy items fill the 132 SMs where one block per row tile
//   would give 38 blocks;
// - register tiling: a block of 256 threads holds its 64 rows in shared
//   memory, k-major, and stages 64 columns at a time, k-major, the next
//   tile's loads in flight while the current one is computed. A thread
//   owns 4 rows x 4 columns: per component it reads 4 row values and 4
//   column values (two 16-byte loads) and advances 16 independent
//   multiply-add chains, each in component order, so the adds' latency is
//   hidden within the thread. Each thread keeps each row's first minimum
//   over its columns (visited in ascending order);
// - merges in (d2, index) order: the 16 threads of a row by shuffles;
//   then, where the row tile has more than one active split, each block
//   writes its 64 partial results to a per-(device, stream) scratch and
//   the last block of the row tile to finish (an integer ticket, taken
//   after a fence; the only atomic, which decides who merges and never
//   the result) merges the splits' partials and sets the ticket back to 0.
//   One launch per call.
// No float atomics, no tensor cores and no TF32 (a TF32 product would blur
// the near-ties the matcher relies on): a run repeats bit for bit.
#include <cfloat>

#include "common.cuh"

namespace quatro {

namespace {
constexpr int kDim = 33;
constexpr int kTileRows = 64;            // A rows per work item
constexpr int kTileCols = 64;            // B columns staged per step
constexpr int kMicro = 4;                // rows and columns per thread
constexpr int kGroup = kTileCols / kMicro;        // threads per row group (16)
constexpr int kThreads = (kTileRows / kMicro) * kGroup;   // 256
constexpr int kStride = kTileCols + 4;   // floats per component row, 16-byte rows
constexpr int kStageLoads = (kTileCols * kDim + kThreads - 1) / kThreads;   // 9
constexpr int kSplit = 256;              // B columns per work item
static_assert(kSplit % kTileCols == 0, "a split is whole column tiles");

// (d, i) before (e, j) in (distance, index) order
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}
}  // namespace

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ a, const float* __restrict__ bdesc,
           const float* __restrict__ sqa, const float* __restrict__ sqb,
           const float* __restrict__ ma, const float* __restrict__ mb,
           const int* __restrict__ lim, int na, int nb,
           float* __restrict__ part_d, int* __restrict__ part_i,
           int* __restrict__ ticket, int* __restrict__ idx_out,
           float* __restrict__ d_out) {
  __shared__ __align__(16) float sa_t[kDim][kStride];   // A rows, k-major
  __shared__ __align__(16) float sb_t[kDim][kStride];   // B columns, k-major
  __shared__ float ssq[kTileCols], smk[kTileCols];
  __shared__ bool last;
  const int s = blockIdx.x;
  const int rt = blockIdx.y;
  const int bt = blockIdx.z;
  const int tid = threadIdx.x;
  const int row0 = rt * kTileRows;
  const size_t orow = (size_t)bt * na;
  const int r_end = lim[2 * bt];
  const int c_end = lim[2 * bt + 1];
  if (row0 >= r_end) {                    // no valid row in this tile
    if (s == 0)
      for (int r = tid; r < kTileRows && row0 + r < na; r += kThreads) {
        idx_out[orow + row0 + r] = 0;
        d_out[orow + row0 + r] = FLT_MAX;
      }
    return;
  }
  // splits holding a column before the limit; split 0 always runs
  const int active = max(1, (c_end + kSplit - 1) / kSplit);
  if (s >= active) return;

  const float* A = a + ((size_t)bt * na + row0) * kDim;
  const float* B = bdesc + (size_t)bt * nb * kDim;
  const float* SB = sqb + (size_t)bt * nb;
  const float* MB = mb + (size_t)bt * nb;
  const int tx = tid % kGroup;            // column group: columns 4 tx .. 4 tx + 3
  const int ty = tid / kGroup;            // row group: rows 4 ty .. 4 ty + 3
  const int rows_here = min(kTileRows, na - row0);
  for (int e = tid; e < kTileRows * kDim; e += kThreads) {
    const int r = e / kDim;
    sa_t[e - r * kDim][r] = r < rows_here ? A[e] : 0.f;
  }
  bool live[kMicro];
  float sa[kMicro], best[kMicro];
  int best_i[kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int i = row0 + ty * kMicro + r;
    live[r] = i < na && ma[orow + i] > 0.f;
    sa[r] = live[r] ? sqa[orow + i] : 0.f;
    best[r] = FLT_MAX;
    best_i[r] = 0;
  }

  const int c_begin = s * kSplit;
  const int c_stop = min(c_begin + kSplit, c_end);
  // the next tile's loads, held in registers while the current one runs
  float nxt[kStageLoads];
  float nsq = 0.f, nmk = 0.f;
  auto fetch = [&](int c0) {
    const int avail = (min(c0 + kTileCols, c_stop) - c0) * kDim;
    const float* src = B + (size_t)c0 * kDim;
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = tid + u * kThreads;
      nxt[u] = e < avail ? src[e] : 0.f;
    }
    if (tid < kTileCols) {
      const bool in = c0 + tid < c_stop;
      nsq = in ? SB[c0 + tid] : 0.f;
      nmk = in ? MB[c0 + tid] : 0.f;
    }
  };
  if (c_begin < c_stop) fetch(c_begin);
  for (int c0 = c_begin; c0 < c_stop; c0 += kTileCols) {
    __syncthreads();                      // the previous tile is consumed
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = tid + u * kThreads;
      if (e < kTileCols * kDim) {
        const int c = e / kDim;
        sb_t[e - c * kDim][c] = nxt[u];
      }
    }
    if (tid < kTileCols) {
      ssq[tid] = nsq;
      smk[tid] = nmk;
    }
    __syncthreads();
    if (c0 + kTileCols < c_stop) fetch(c0 + kTileCols);

    float dot[kMicro][kMicro];
#pragma unroll
    for (int r = 0; r < kMicro; ++r)
#pragma unroll
      for (int c = 0; c < kMicro; ++c) dot[r][c] = 0.f;
#pragma unroll
    for (int k = 0; k < kDim; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sa_t[k][ty * kMicro]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb_t[k][tx * kMicro]);
      const float ar[kMicro] = {av.x, av.y, av.z, av.w};
      const float bc[kMicro] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) dot[r][c] = add(dot[r][c], mul(ar[r], bc[c]));
    }
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int t = tx * kMicro + c;
      if (!(smk[t] > 0.f)) continue;
      const float sbt = ssq[t];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
        const float d = fmaxf(add(sub(sa[r], mul(2.f, dot[r][c])), sbt), 0.f);
        if (live[r] && d < best[r]) {     // columns ascend: the first minimum
          best[r] = d;
          best_i[r] = c0 + t;
        }
      }
    }
  }

  // the 16 threads of a row group: the least (d, index) of each row
#pragma unroll
  for (int off = kGroup / 2; off > 0; off /= 2)
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      const float od = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[r], off);
      if (before(od, oi, best[r], best_i[r])) {
        best[r] = od;
        best_i[r] = oi;
      }
    }
  if (active == 1) {                      // one split: the result itself
    if (tx == 0)
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
        const int i = row0 + ty * kMicro + r;
        if (i < na) {
          idx_out[orow + i] = best_i[r];
          d_out[orow + i] = best[r];
        }
      }
    return;
  }

  // more splits: partials to the scratch, the row tile's last block merges
  const int tile = bt * gridDim.y + rt;
  const size_t pbase = (size_t)tile * gridDim.x * kTileRows;
  if (tx == 0)
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      const size_t p = pbase + (size_t)s * kTileRows + ty * kMicro + r;
      part_d[p] = best[r];
      part_i[p] = best_i[r];
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket + tile, 1) == active - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // 4 threads a row, each over every 4th split, then merged by shuffles
  const int r = tid / 4;
  const int q = tid % 4;
  float bd = FLT_MAX;
  int bi = 0;
  for (int ss = q; ss < active; ss += 4) {
    const size_t p = pbase + (size_t)ss * kTileRows + r;
    const float d = __ldcg(part_d + p);
    const int j = __ldcg(part_i + p);
    if (before(d, j, bd, bi)) {
      bd = d;
      bi = j;
    }
  }
#pragma unroll
  for (int off = 2; off > 0; off /= 2) {
    const float od = __shfl_xor_sync(0xffffffffu, bd, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (before(od, oi, bd, bi)) {
      bd = od;
      bi = oi;
    }
  }
  if (q == 0 && row0 + r < na) {
    idx_out[orow + row0 + r] = bi;
    d_out[orow + row0 + r] = bd;
  }
  if (tid == 0) ticket[tile] = 0;
}

}  // namespace quatro

// desc_a (B, Na, 33), desc_b (B, Nb, 33) f32; sq_a (B, Na), sq_b (B, Nb)
// squared norms; masks (B, Na), (B, Nb) f32 0/1; lim (B, 2) int32, one
// past the last valid row and column -> idx (B, Na) int32 and d2 (B, Na)
// f32. `split` must be the kernel's 256 columns a work item. Where Nb >
// split, partial holds 2 * B * ceil(Na / 64) * ceil(Nb / split) * 64
// words of scratch and ticket B * ceil(Na / 64) ints that are 0 (and are
// 0 again when the kernel ends); both may be null otherwise. One launch.
extern "C" int quatro_nn1(const float* a, const float* b, const float* sqa,
                          const float* sqb, const float* ma, const float* mb,
                          const int* lim, int batch, int na, int nb, int split,
                          float* partial, int* ticket, int* idx, float* d2,
                          cudaStream_t stream) {
  using namespace quatro;
  if (split != kSplit) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || na <= 0) return 0;
  const int splits = (nb + kSplit - 1) / kSplit;
  const int tiles = (na + kTileRows - 1) / kTileRows;
  if (splits > 1 && (partial == nullptr || ticket == nullptr))
    return (int)cudaErrorInvalidValue;
  int* part_i = partial == nullptr ? nullptr : reinterpret_cast<int*>(
      partial + (size_t)batch * tiles * splits * kTileRows);
  dim3 grid(splits > 1 ? splits : 1, tiles, batch);
  nn1_kernel<<<grid, kThreads, 0, stream>>>(a, b, sqa, sqb, ma, mb, lim, na, nb,
                                            partial, part_i, ticket, idx, d2);
  return (int)cudaGetLastError();
}
