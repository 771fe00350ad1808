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
// reads its row and the sums are f32.
//
// Order of the sums, which ops/segment.py::fit_iteration_moments_plain
// repeats on the CPU bit for bit (segment_sums_plain at FIT_CHUNK): within
// each chunk of `chunk` consecutive points, every patch adds its members'
// moments in index order starting from 0; then the chunks' partials are
// added in chunk order (chunk_sum.cuh). A point that is no member adds
// nothing, which is what adding its zeros does (a sum that starts from +0
// is never -0). No float atomics: a run repeats bit for bit.
//
// Bound on the card: bytes. On the main path (B = 2, N = 131072, p_pad 512)
// the inputs and the output are 6.3 MB, 1.9 us at 3.35 TB/s, against 5.5 M
// f32 operations (0.08 us at 67 TFLOP/s).
// Design, after B8 (cross_histogram.cu): every patch has one owner warp,
// which adds its members in index order into a register copy of the
// patch's ten sums, one channel in each of lanes 0-9, and carries that
// copy along a run of one patch. Patchwork's points come in runs of one
// patch (a sector of a ring), so most steps change no patch.
// 0. a pre-pass finds the active limit, one past the last point whose id
//    lies in [0, p_cnt) (segment_matmul.py::_tile_limit at point
//    granularity); blocks of chunks past it exit at once, and the second
//    pass adds only the chunks before it;
// 1. a block takes a chunk and the patches p with p % npb == pb (npb, a
//    power of two, blocks share the patch axis, 256 patches each, whose
//    sums it keeps in shared memory); warp w owns those with (p / npb) % 8
//    == w. So neighbouring patches fall to different warps and blocks;
// 2. per tile of 256 points, each thread takes one point's id and
//    channels (loaded during the previous tile), and only for a point of
//    the block's patches reads its row and computes membership and
//    moments: every point is tested once. The members are counted per owning warp
//    by ballots, placed by a scan over the warps into one shared list, each
//    warp's part in index order, as a patch and ten moments (SoA, a row
//    stride of 257 floats so that the ten channel lanes hit ten banks);
// 3. each warp walks its part of the list in order, 16 entries at a time:
//    each channel lane loads its channel of all 16 at once, one ballot
//    marks where a run of one patch starts, and for each run the lanes
//    add its entries in order from registers (predicated, no branch per
//    entry); where the patch changes, the copy goes back to shared memory
//    and the next patch's sums come out;
// 4. the block writes its patches' partial sums.
// A block's walk is serial, so the chunk (FIT_CHUNK, 1024 points) trades
// the blocks' length against the second pass's: of 512 to 4096, 1024 was
// the fastest on the main path (tests/torch_fit_table_timing.py).
// The table is read through the read-only cache, which measured a little
// faster than a copy staged in shared memory by every block (PERF.md).
// Membership and the products use the round-to-nearest intrinsics in the
// plain version's order, so kernel and plain version take the same
// membership decisions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chunk_sum.cuh"
#include "patchwork.cuh"

namespace quatro {

constexpr int kFitThreads = 256;   // threads per block = points per tile
constexpr int kFitWarps = kFitThreads / 32;
constexpr int kFitPatches = 256;   // patches per block
constexpr int kMoments = 10;
constexpr int kListStride = kFitThreads + 1;   // a moment row of the list
constexpr int kWalk = 16;          // list entries a warp walks at a time
constexpr int kLimitThreads = 256;
constexpr int kLimitSpan = 8192;   // points per block of the limit pre-pass

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// lim (B,), zeroed by the caller: one past the last i with ids[b, i] in
// [0, p_lim). Grid (ceil(n / kLimitSpan), B).
__global__ void __launch_bounds__(kLimitThreads)
fit_limit_kernel(const int* __restrict__ ids, int n, int p_lim, int* __restrict__ lim) {
  __shared__ int wmax[kLimitThreads / 32];
  const int b = blockIdx.y;
  const int* ib = ids + (size_t)b * n;
  const int e0 = blockIdx.x * kLimitSpan;
  const int e1 = min(n, e0 + kLimitSpan);
  int last = 0;
  for (int e = e0 + threadIdx.x; e < e1; e += kLimitThreads)
    if ((unsigned)ib[e] < (unsigned)p_lim) last = e + 1;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < kLimitThreads / 32; ++w) m = max(m, wmax[w]);
    if (m > 0) atomicMax(lim + b, m);
  }
}

__global__ void __launch_bounds__(kFitThreads)
fit_partials_kernel(const int* __restrict__ ids, const float* __restrict__ chan,
                    const float* __restrict__ tab, int n, int p_pad, int p_lim, int exact,
                    int chunk, int chunks, int shift, const int* __restrict__ lim,
                    float* __restrict__ partial) {
  __shared__ int lpatch[kFitThreads];                     // the list: patches
  __shared__ float lmom[kMoments][kListStride];           // and moments
  __shared__ float sums[kFitPatches][kMoments];           // the block's patches
  __shared__ int wcnt[kFitWarps][kFitWarps];              // [warp][owning warp]
  __shared__ int wbase[kFitWarps][kFitWarps];             // an entry's first slot
  __shared__ int gspan[kFitWarps][2];                     // a warp's part
  const int c = blockIdx.x;
  const int pb = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e0 = c * chunk;
  const int e1 = min(min(n, e0 + chunk), lim[b]);
  if (e0 >= e1) return;   // past the active limit: nothing to add
  const int* ib = ids + (size_t)b * n;
  const float* cb = chan + (size_t)b * kTabCols * n;
  const float* tb = tab + (size_t)b * p_pad * kTabCols;
  for (int i = tid; i < kFitPatches * kMoments; i += kFitThreads)
    (&sums[0][0])[i] = 0.f;
  // this warp's register copy: channel `lane` (lanes 0-9) of patch `cur`
  int cur = -1;
  float acc = 0.f;
  // the next tile's point, loaded while this tile is worked on
  int next_id = -1;
  float next[kTabCols];
  auto fetch = [&](int e) {
    next_id = e < e1 ? ib[e] : -1;
#pragma unroll
    for (int k = 0; k < kTabCols; ++k) next[k] = e < e1 ? cb[k * (size_t)n + e] : 0.f;
  };
  fetch(e0 + tid);
  for (int t0 = e0; t0 < e1; t0 += kFitThreads) {
    // 2. this thread's point: membership and moments if the block owns it
    const int id = next_id;
    const float x = next[0], y = next[1], z = next[2], px = next[3], py = next[4];
    fetch(t0 + kFitThreads + tid);
    bool member = false;
    int q = 0, grp = 0;
    float mom[kMoments];
    if ((unsigned)id < (unsigned)p_lim && (id & ((1 << shift) - 1)) == pb) {
      q = id >> shift;
      grp = q % kFitWarps;
      float row[kTabCols];
#pragma unroll
      for (int k = 0; k < kTabCols; ++k) row[k] = __ldg(tb + id * kTabCols + k);
      member = plane_proj(row, x, y, z) < row[3];
      if (member) {
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
    // count the members per owning warp; this lane's rank among its warp's
    int rank = 0;
#pragma unroll
    for (int g = 0; g < kFitWarps; ++g) {
      const unsigned bal = __ballot_sync(0xffffffffu, member && grp == g);
      if (lane == g) wcnt[warp][g] = __popc(bal);
      if (member && grp == g) rank = __popc(bal & ((1u << lane) - 1u));
    }
    __syncthreads();   // the counts are in (the sums zeroed); the previous
                       // tile's list consumed
    if (warp == 0) {   // lane g < 8: the owning warp g's part of the list
      int run = 0;
      if (lane < kFitWarps)
        for (int w = 0; w < kFitWarps; ++w) {
          wbase[w][lane] = run;
          run += wcnt[w][lane];
        }
      int start = lane < kFitWarps ? run : 0;
#pragma unroll
      for (int off = 1; off < kFitWarps; off *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, start, off);
        if (lane >= off) start += v;
      }
      start -= run;
      if (lane < kFitWarps) {
        for (int w = 0; w < kFitWarps; ++w) wbase[w][lane] += start;
        gspan[lane][0] = start;
        gspan[lane][1] = start + run;
      }
    }
    __syncthreads();
    if (member) {
      const int slot = wbase[warp][grp] + rank;
      lpatch[slot] = q;
#pragma unroll
      for (int g = 0; g < kMoments; ++g) lmom[g][slot] = mom[g];
    }
    __syncthreads();
    // 3. this warp's part, in index order, kWalk entries at a time
    const int ge = gspan[warp][1];
    for (int w0 = gspan[warp][0]; w0 < ge; w0 += kWalk) {
      const int m = min(kWalk, ge - w0);
      const int pj = lane < m ? lpatch[w0 + lane] : -1;
      float v[kWalk];   // this lane's channel of the window's entries
#pragma unroll
      for (int j = 0; j < kWalk; ++j)
        v[j] = lane < kMoments && j < m ? lmom[lane][w0 + j] : 0.f;
      // the entries where a run of one patch starts
      const int before = __shfl_up_sync(0xffffffffu, pj, 1);
      unsigned starts = __ballot_sync(0xffffffffu, lane < m && (lane == 0 || pj != before));
      while (starts) {   // the same for the whole warp
        const int a = __ffs(starts) - 1;
        starts &= starts - 1;
        const int z = starts ? __ffs(starts) - 1 : m;
        const int key = __shfl_sync(0xffffffffu, pj, a);
        if (key != cur) {
          if (cur >= 0 && lane < kMoments) sums[cur][lane] = acc;
          cur = key;
          if (lane < kMoments) acc = sums[cur][lane];
        }
#pragma unroll
        for (int j = 0; j < kWalk; ++j)
          if ((unsigned)(j - a) < (unsigned)(z - a)) acc = add(acc, v[j]);
      }
    }
  }
  if (cur >= 0 && lane < kMoments) sums[cur][lane] = acc;
  __syncthreads();
  // 4. partial[b][c][p], p = (q << shift) | pb for the block's patches q
  float* out = partial + ((size_t)b * chunks + c) * p_pad * kMoments;
  for (int i = tid; i < kFitPatches * kMoments; i += kFitThreads) {
    const int p = ((i / kMoments) << shift) | pb;
    if (p < p_pad) out[p * kMoments + i % kMoments] = (&sums[0][0])[i];
  }
}

}  // namespace quatro

// ids (B, N) int32, chan (B, 5, N) f32, tab (B, p_pad, 5) f32, scratch lim
// (B,) int32 and partial (B, ceil(N / chunk), p_pad, 10) f32 -> out (B,
// p_pad, 10) f32.
extern "C" int quatro_fit_iteration_moments(const int* ids, const float* chan,
                                            const float* tab, int bsz, int n, int p_pad,
                                            int p_cnt, int exact, int chunk, int* lim,
                                            float* partial, float* out,
                                            cudaStream_t stream) {
  int shift = 0;   // 2^shift blocks share the patch axis, 256 patches each
  while ((quatro::kFitPatches << shift) < p_pad) ++shift;
  const int p_lim = p_cnt < p_pad ? p_cnt : p_pad;
  const int chunks = (n + chunk - 1) / chunk;
  int rc = (int)cudaMemsetAsync(lim, 0, bsz * sizeof(int), stream);
  if (rc != 0) return rc;
  quatro::fit_limit_kernel<<<dim3((n + quatro::kLimitSpan - 1) / quatro::kLimitSpan, bsz),
                             quatro::kLimitThreads, 0, stream>>>(ids, n, p_lim, lim);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dim3 grid(chunks, 1 << shift, bsz);
  quatro::fit_partials_kernel<<<grid, quatro::kFitThreads, 0, stream>>>(
      ids, chan, tab, n, p_pad, p_lim, exact, chunk, chunks, shift, lim, partial);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return quatro::launch_chunk_sum<9>(partial, bsz, chunks, p_pad * quatro::kMoments, out,
                                  stream, lim, chunk);
}
