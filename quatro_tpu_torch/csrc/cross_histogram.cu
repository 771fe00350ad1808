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
// Order of the sums, which ops/segment.py::cross_histogram_plain repeats
// on the CPU bit for bit: within each chunk of `chunk` consecutive points,
// every bin adds its points in index order starting from 0; then the
// chunks' partials are added in chunk order (chunk_sum.cuh). No float
// atomics: a run repeats bit for bit.
//
// Bound on the card: bytes. On the main path (B = 2, N = 131072, K = 2,
// 512 x 128 bins) the inputs and the output are 5.2 MB, 1.6 us at
// 3.35 TB/s; the 0.5 M additions are nothing.
// Design. A block takes one chunk and 32 rows a of the histogram, which it
// holds in shared memory (32 x K x b_pad floats, 32 KB on the main path),
// with 256 threads. A histogram of more than 4 channels or more than 176 KB
// of rows (the JAX kernel takes any) is launched in tiles of at most 4
// channels and the columns that fit, each writing its part of the partials
// (the per-bin order is the same), then summed as one. Its rows are interleaved, a = rb + 16 i for block rb
// of 16, so that neighbouring patches, whose points come in runs one after the
// other, fall to different blocks; warp w owns rows 4w..4w+3, and lane l of it the bins
// (4w + i, c) with (c + 8 i) % 32 == l. Per tile of 1024 points:
// 1. each thread reads the ids of 4 consecutive points and keeps those
//    whose row falls in the block's rows and whose column is in range;
//    the kept points are counted per row group (the 8 groups packed in one
//    64-bit word, 8 bits each), scanned across the warp by shuffles and
//    across the warps by 8 lanes of warp 0, and written to the group's part
//    of a shared list in index order, each as one word (bin and owning
//    lane) with its weights; each group's part starts at a multiple of 8
//    entries and is padded with entries nobody owns;
// 2. each warp walks its group's list 32 entries at a time: 32 entries of
//    one bin are added in order by its owner from 16-byte loads; others go
//    8 at a time (entries and weights loaded first, then applied in
//    order), the lane owning an
//    entry's bin adds its weights to a register copy of that bin, which it
//    writes back when the next entry it owns is another bin. A bin has one
//    owner, which adds in index order; a run of points in one bin (the
//    main path's dump patch 504 fills whole chunks with one bin) costs
//    register additions, not shared-memory round trips, and a step in
//    which no lane changes bins has no branch;
// 3. the block writes its partial rows, coalesced along the columns; one
//    thread per output then adds the chunks' partials in chunk order.
#include <cuda_runtime.h>

#include "chunk_sum.cuh"

namespace quatro {

constexpr int kHistRows = 32;       // histogram rows per block
constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistGroupRows = kHistRows / kHistWarps;   // rows per warp
constexpr int kHistPer = 4;         // consecutive points per thread per tile
constexpr int kHistTile = kHistThreads * kHistPer;
constexpr int kHistBatch = 8;       // list entries loaded per step
constexpr int kHistWindow = 32;     // list entries tested for one bin at once
// the list: each group's part starts at a multiple of kHistBatch and is
// padded with entries nobody owns to the next one
constexpr int kHistList = kHistTile + kHistWarps * kHistBatch;
constexpr int kHistMaxK = 4;        // weight channels
constexpr int kNobody = 32 << 16;   // a list entry no lane owns

// A list entry: the bin key = c * 32 + row in the low 16 bits, the lane
// that owns the bin above them. The 4 rows of a group put the same column
// c in lanes 8 apart, since neighbouring patches' points sit at the same
// heights.
__device__ __forceinline__ int entry(int c, int row) {
  const int owner = (c + 8 * (row % kHistGroupRows)) & 31;
  return (owner << 16) | (c * kHistRows + row);
}

// the sums of bin `ent` in the block's shared histogram (channel 0)
__device__ __forceinline__ float* bin_sums(float* hist, int ent, int row) {
  const int key = ent & 0xFFFF;
  return hist + (key % kHistRows) * row + key / kHistRows;
}

// the count of group g in a word of 8 packed 8-bit counts (a warp keeps at
// most 128 points of a group per tile)
__device__ __forceinline__ int packed(unsigned long long x, int g) {
  return (int)((x >> (8 * g)) & 0xFFull);
}

// A tile of the histogram past the first route's size: channels g0 ..
// g0 + K - 1 of k_total, columns c0 .. c0 + b_pad - 1 of b_full, written
// into the whole histogram's partials.
struct HistTile {
  int k_total, g0, b_full, c0;
};

template <int K, bool T>   // weight channels; T: a tile of a larger histogram
__global__ void __launch_bounds__(kHistThreads)
hist_partials_kernel(const int* __restrict__ ids_a, const int* __restrict__ ids_b,
                     const float* __restrict__ w, int n, int a_pad, int b_pad,
                     int chunk, int chunks, float* __restrict__ partial, HistTile tile) {
  extern __shared__ float hist[];           // [kHistRows][K][b_pad]
  __shared__ __align__(16) int lent[kHistList];   // the kept points' entries
  __shared__ __align__(16) float lw[K][kHistList];
  __shared__ unsigned long long wtot[kHistWarps];
  __shared__ int gbase[kHistWarps][kHistWarps];   // [warp][group]
  __shared__ int gspan[kHistWarps][2];            // a group's padded part
  const int c = blockIdx.x;
  // this block's rows: a = rb + nrb * i for local rows i = 0..31
  const int rb = blockIdx.y;
  const int nrb = gridDim.y;
  const int rows = (a_pad - rb + nrb - 1) / nrb;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = K * b_pad;
  for (int i = tid; i < kHistRows * row; i += kHistThreads) hist[i] = 0.f;
  const int* ia = ids_a + (size_t)b * n;
  const int* ib = ids_b + (size_t)b * n;
  const float* wb = T ? w + ((size_t)b * tile.k_total + tile.g0) * n : w + (size_t)b * K * n;
  // this lane's register copy of one of its bins (its entry, or -1)
  int cur = -1;
  float acc[K] = {};
  const int e0 = c * chunk;
  const int e1 = min(n, e0 + chunk);
  for (int t0 = e0; t0 < e1; t0 += kHistTile) {
    // 1. select this thread's points, count them per row group, place them
    const int p0 = t0 + tid * kHistPer;
    int grp[kHistPer], ent[kHistPer];
    unsigned long long cnt = 0;
#pragma unroll
    for (int j = 0; j < kHistPer; ++j) {
      const int p = p0 + j;
      const bool in = p < e1;
      const int a = in ? ia[p] : -1;
      // a tile's columns from c0 (unsigned: a column below c0 wraps past
      // b_pad)
      const int cb = in ? (T ? (int)((unsigned)ib[p] - (unsigned)tile.c0) : ib[p]) : -1;
      const bool keep = (unsigned)a < (unsigned)a_pad && a % nrb == rb &&
                        (unsigned)cb < (unsigned)b_pad;
      const int ra = a / nrb;
      grp[j] = keep ? ra / kHistGroupRows : -1;
      ent[j] = entry(cb, ra);
      if (keep) cnt += 1ull << (8 * grp[j]);
    }
    unsigned long long incl = cnt;          // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const unsigned long long v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();   // the warp totals are in; the previous tile consumed
    if (warp == 0) {   // lane g < 8: group g's place in the list
      int run = 0;
      if (lane < kHistWarps)
        for (int w2 = 0; w2 < kHistWarps; ++w2) {
          gbase[w2][lane] = run;
          run += packed(wtot[w2], lane);
        }
      const int padded = (run + kHistBatch - 1) / kHistBatch * kHistBatch;
      int start = lane < kHistWarps ? padded : 0;
#pragma unroll
      for (int off = 1; off < kHistWarps; off *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, start, off);
        if (lane >= off) start += v;
      }
      start -= padded;
      if (lane < kHistWarps) {
        for (int w2 = 0; w2 < kHistWarps; ++w2) gbase[w2][lane] += start;
        for (int e = start + run; e < start + padded; ++e) lent[e] = kNobody;
        gspan[lane][0] = start;
        gspan[lane][1] = start + padded;
      }
    }
    __syncthreads();
    unsigned long long excl = incl - cnt;
#pragma unroll
    for (int j = 0; j < kHistPer; ++j) {
      if (grp[j] < 0) continue;
      const int g = grp[j];
      const int slot = gbase[warp][g] + packed(excl, g);
      excl += 1ull << (8 * g);
      lent[slot] = ent[j];
#pragma unroll
      for (int gg = 0; gg < K; ++gg) lw[gg][slot] = wb[(size_t)gg * n + p0 + j];
    }
    __syncthreads();
    // 2. warp `warp` walks its group's list, 32 entries at a time; each
    // bin's owner adds
    const int ge = gspan[warp][1];
    for (int w0 = gspan[warp][0]; w0 < ge; w0 += kHistWindow) {
      const int mine_e = w0 + lane < ge ? lent[w0 + lane] : kNobody;
      const int first = __shfl_sync(0xffffffffu, mine_e, 0);
      if (__all_sync(0xffffffffu, mine_e == first) && first != kNobody) {
        // one bin: its owner adds this window's weights in order from
        // registers, and those of the following windows while they hold
        // nothing but this bin
        const int own = first >> 16;
        int next = w0;
        if (lane == own) {
          if (first != cur) {
            if (cur >= 0) {
              float* h = bin_sums(hist, cur, row);
#pragma unroll
              for (int g = 0; g < K; ++g) h[g * b_pad] = acc[g];
            }
            cur = first;
            const float* h = bin_sums(hist, cur, row);
#pragma unroll
            for (int g = 0; g < K; ++g) acc[g] = h[g * b_pad];
          }
          bool same = true;
          for (next = w0; same; next += kHistWindow) {
#pragma unroll
            for (int v = 0; v < kHistWindow; v += 4)
#pragma unroll
              for (int g = 0; g < K; ++g) {
                const float4 w4 = *reinterpret_cast<const float4*>(lw[g] + next + v);
                acc[g] += w4.x; acc[g] += w4.y; acc[g] += w4.z; acc[g] += w4.w;
              }
            same = next + 2 * kHistWindow <= ge;
#pragma unroll
            for (int v = 0; v < kHistWindow; v += 4) {
              const int4 e4 = *reinterpret_cast<const int4*>(
                  lent + min(next + kHistWindow + v, kHistList - 4));
              same &= e4.x == first && e4.y == first && e4.z == first &&
                      e4.w == first;
            }
          }
        }
        w0 = __shfl_sync(0xffffffffu, next, own) - kHistWindow;
        continue;
      }
      for (int q = 0; q < kHistWindow && w0 + q < ge; q += kHistBatch) {
        const int q0 = w0 + q;
        int kk[kHistBatch];
        float wv[K][kHistBatch];
#pragma unroll
        for (int v = 0; v < kHistBatch; v += 4) {
          const int4 k4 = *reinterpret_cast<const int4*>(lent + q0 + v);
          kk[v] = k4.x; kk[v + 1] = k4.y; kk[v + 2] = k4.z; kk[v + 3] = k4.w;
#pragma unroll
          for (int g = 0; g < K; ++g) {
            const float4 w4 = *reinterpret_cast<const float4*>(lw[g] + q0 + v);
            wv[g][v] = w4.x; wv[g][v + 1] = w4.y; wv[g][v + 2] = w4.z;
            wv[g][v + 3] = w4.w;
          }
        }
        bool mine[kHistBatch];
        bool other = false;                   // an owned entry of another bin
#pragma unroll
        for (int u = 0; u < kHistBatch; ++u) {
          mine[u] = (kk[u] >> 16) == lane;
          other |= mine[u] && kk[u] != cur;
        }
        if (__any_sync(0xffffffffu, other)) {
          // some lane changes bins in this step: entry by entry, the owner
          // swapping its register copy where its bin changes
#pragma unroll
          for (int u = 0; u < kHistBatch; ++u) {
            const bool swap = mine[u] && kk[u] != cur;
            if (__any_sync(0xffffffffu, swap) && swap) {
              if (cur >= 0) {
                float* h = bin_sums(hist, cur, row);
#pragma unroll
                for (int g = 0; g < K; ++g) h[g * b_pad] = acc[g];
              }
              cur = kk[u];
              const float* h = bin_sums(hist, cur, row);
#pragma unroll
              for (int g = 0; g < K; ++g) acc[g] = h[g * b_pad];
            }
#pragma unroll
            for (int g = 0; g < K; ++g) acc[g] += mine[u] ? wv[g][u] : 0.f;
          }
        } else {
          // every owned entry is in its lane's current bin: additions only,
          // no branch; the other lanes add +0, which leaves their sums' bits
          // as they are (a sum here is never -0)
#pragma unroll
          for (int u = 0; u < kHistBatch; ++u)
#pragma unroll
            for (int g = 0; g < K; ++g) acc[g] += mine[u] ? wv[g][u] : 0.f;
        }
      }
    }
  }
  if (cur >= 0) {
    float* h = bin_sums(hist, cur, row);
#pragma unroll
    for (int g = 0; g < K; ++g) h[g * b_pad] = acc[g];
  }
  __syncthreads();
  // 3. partial[b][c][g][a][cb], each row written by the whole block
  if constexpr (T) {
    float* out = partial + ((size_t)b * chunks + c) * tile.k_total * a_pad * tile.b_full;
    for (int i = tid; i < rows * row; i += kHistThreads) {
      const int rr = i / row;
      const int g = (i % row) / b_pad;
      const int col = i % b_pad;
      out[((size_t)(tile.g0 + g) * a_pad + rb + nrb * rr) * tile.b_full + tile.c0 + col] =
          hist[i];
    }
  } else {
    float* out = partial + ((size_t)b * chunks + c) * K * a_pad * b_pad;
    for (int i = tid; i < rows * row; i += kHistThreads) {
      const int rr = i / row;
      const int g = (i % row) / b_pad;
      const int col = i % b_pad;
      out[((size_t)g * a_pad + rb + nrb * rr) * b_pad + col] = hist[i];
    }
  }
}

template <int K, bool T = false>
int launch_hist(const int* ids_a, const int* ids_b, const float* w, int n, int a_pad,
                int b_pad, int chunk, int chunks, float* partial, dim3 grid, int smem,
                cudaStream_t stream, HistTile tile = {}) {
  int rc = (int)cudaFuncSetAttribute(hist_partials_kernel<K, T>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  hist_partials_kernel<K, T><<<grid, kHistThreads, smem, stream>>>(
      ids_a, ids_b, w, n, a_pad, b_pad, chunk, chunks, partial, tile);
  return (int)cudaGetLastError();
}

constexpr int kHistSmemMax = 176 * 1024;   // a block's histogram rows

// Past K = kHistMaxK channels or kHistSmemMax bytes of rows: the histogram
// in tiles of at most kHistMaxK channels and as many columns as fit, each
// a launch of the same kernel writing its part of every chunk's partial, so
// that every bin adds its points in the same order; one chunk sum after.
inline int launch_tiles(const int* ids_a, const int* ids_b, const float* w, int n, int k,
                        int a_pad, int b_pad, int chunk, int chunks, float* partial, int bsz,
                        cudaStream_t stream) {
  for (int g0 = 0; g0 < k; g0 += kHistMaxK) {
    const int kg = k - g0 < kHistMaxK ? k - g0 : kHistMaxK;
    int bt = kHistSmemMax / (kHistRows * kg * 4);    // columns a tile: a bin key
    if (bt > 65536 / kHistRows) bt = 65536 / kHistRows;   // in 16 bits
    if (bt > b_pad) bt = b_pad;
    for (int c0 = 0; c0 < b_pad; c0 += bt) {
      const int width = b_pad - c0 < bt ? b_pad - c0 : bt;
      const HistTile tile{k, g0, b_pad, c0};
      const int smem = kHistRows * kg * width * (int)sizeof(float);
      const dim3 grid(chunks, (a_pad + kHistRows - 1) / kHistRows, bsz);
      int rc;
      switch (kg) {
        case 1: rc = launch_hist<1, true>(ids_a, ids_b, w, n, a_pad, width, chunk, chunks,
                                          partial, grid, smem, stream, tile); break;
        case 2: rc = launch_hist<2, true>(ids_a, ids_b, w, n, a_pad, width, chunk, chunks,
                                          partial, grid, smem, stream, tile); break;
        case 3: rc = launch_hist<3, true>(ids_a, ids_b, w, n, a_pad, width, chunk, chunks,
                                          partial, grid, smem, stream, tile); break;
        default: rc = launch_hist<4, true>(ids_a, ids_b, w, n, a_pad, width, chunk, chunks,
                                           partial, grid, smem, stream, tile);
      }
      if (rc != 0) return rc;
    }
  }
  return 0;
}

}  // namespace quatro

// ids_a, ids_b (B, N) int32, w (B, K, N) f32, partial (B, ceil(N / chunk),
// K, a_pad, b_pad) f32 scratch -> out (B, K, a_pad, b_pad) f32. K <= 4 and
// 32 K b_pad floats within kHistSmemMax: one launch; else the tiles.
extern "C" int quatro_cross_histogram(const int* ids_a, const int* ids_b, const float* w,
                                      int bsz, int n, int k, int a_pad, int b_pad,
                                      int chunk, float* partial, float* out,
                                      cudaStream_t stream) {
  if (k < 1 || b_pad < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (n + chunk - 1) / chunk;
  if (k > quatro::kHistMaxK ||
      (long long)quatro::kHistRows * k * b_pad * 4 > quatro::kHistSmemMax) {
    const int rc = quatro::launch_tiles(ids_a, ids_b, w, n, k, a_pad, b_pad, chunk, chunks,
                                        partial, bsz, stream);
    if (rc != 0) return rc;
    return quatro::launch_chunk_sum<8>(partial, bsz, chunks, k * a_pad * b_pad, out, stream);
  }
  const int smem = quatro::kHistRows * k * b_pad * (int)sizeof(float);
  const dim3 grid(chunks, (a_pad + quatro::kHistRows - 1) / quatro::kHistRows, bsz);
  int rc = 0;
  switch (k) {
    case 1: rc = quatro::launch_hist<1>(ids_a, ids_b, w, n, a_pad, b_pad, chunk, chunks,
                                        partial, grid, smem, stream); break;
    case 2: rc = quatro::launch_hist<2>(ids_a, ids_b, w, n, a_pad, b_pad, chunk, chunks,
                                        partial, grid, smem, stream); break;
    case 3: rc = quatro::launch_hist<3>(ids_a, ids_b, w, n, a_pad, b_pad, chunk, chunks,
                                        partial, grid, smem, stream); break;
    default: rc = quatro::launch_hist<4>(ids_a, ids_b, w, n, a_pad, b_pad, chunk, chunks,
                                         partial, grid, smem, stream);
  }
  if (rc != 0) return rc;
  return quatro::launch_chunk_sum<8>(partial, bsz, chunks, k * a_pad * b_pad, out,
                                     stream);
}
