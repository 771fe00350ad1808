// Segment sums over a small group axis, for a batch of segment problems.
//
// Replaces quatro_tpu/ops/segment_matmul.py::segment_sums (_seg_kernel),
// with the pair axis that jax.vmap gives it in the JAX package's vote:
//   out[b, p, k] = sum over i with ids[b, i] == p of vals[b, k, i],
// ids (B, N) int32, vals (B, K, N) f32, out (B, p_pad, K) f32; ids
// outside [0, p_pad) are dropped. The TPU kernel builds one-hot tiles for
// the MXU in a 3-term bf16 split because the TPU has no cheap scatter;
// none of that carries over.
//
// Order of the sums, which ops/segment.py::segment_sums_plain repeats on
// the CPU bit for bit: within each chunk of 1024 consecutive entries of a
// row (SEG_CHUNK), every bin adds its entries in index order starting
// from 0; then the row's chunk sums are added in chunk order, starting
// from 0. So row b's sums are those of a call on row b alone. No float
// atomics: a run repeats bit for bit.
//
// Bound on the card: bytes. On the vote's shape (N = 65536, K = 3,
// p_pad = 256) the inputs are 1.05 MB a pair, 0.31 us at 3.35 TB/s, and
// the 0.2 M additions are nothing; on the pose graph's J^T apply (N ~ 38,
// K = 4, p_pad 12) the launch is all there is. So the design aims at
// latency: one launch, few dependent steps, and a merge per row: with the
// rows flattened into one problem of B * p_pad bins, the vote at B = 64
// wrote 4096 chunks x 16384 bins x 3 of partials (805 MB) and one block
// read them all back.
// Design: a block of 1024 threads takes one chunk of one row (one entry a
// thread; blockIdx.z is the row) and up to 256 bins (blockIdx.y covers
// more):
// 1. a stable counting sort of the chunk's in-range entries by bin, in
//    shared memory: each warp ranks its 32 entries by bin with
//    __match_any_sync and __popc of the lower lanes, the lowest lane of a
//    bin writes the warp's count; for each bin a thread turns the 32
//    warps' counts into the counts of the warps before (in warp order)
//    and the bin's total, and one scan over the bins gives each bin's
//    first slot. An entry's slot is its bin's first slot, plus the
//    entries of its bin in earlier warps, plus its rank in its warp: the
//    bin's entries lie in index order. Ids out of range (the vote's
//    zero-weight entries go to bin p_pad) take no slot;
// 2. per group of 4 channels, the entries' values are placed at their
//    slots, and thread (bin, channel) adds its bin's run in order, loading
//    the next 16 entries while it adds the last 16. A run of r entries is
//    r dependent additions, which no order-keeping design can shorten: a
//    chunk whose entries all fall in one bin takes 1024 of them;
//    the vote's entries (64 anchors, one chunk each) hold a few dozen in
//    range per chunk on the main path;
// 3. a single chunk (N <= 1024: the pose graph) writes out directly
//    (0 + s == s for a sum that starts from +0). Otherwise each block
//    writes its chunk's sums to its row's partial scratch (B x chunks x
//    p_pad x K in all: 12.6 MB at the vote's B = 64), and the last block
//    of the row to finish, known by the row's integer ticket (atomicAdd
//    after __threadfence), adds the row's partials in chunk order (32
//    loads in flight per output) and sets the ticket back to 0, so a CUDA
//    graph's replay finds every ticket at 0. The ticket decides who adds,
//    never the order of the additions.
#include <cuda_runtime.h>

namespace quatro {

constexpr int kSegThreads = 1024;                  // entries per chunk = threads
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegBins = 256;                      // bins per block
constexpr int kSegLanes = kSegThreads / kSegBins;  // channels per walk (4)
constexpr int kSegStride = kSegBins + 2;           // a warp's row of counts
constexpr int kSegAhead = 16;                      // run entries loaded ahead
constexpr int kSegInFlight = 32;                   // partials loaded at once

__global__ void __launch_bounds__(kSegThreads)
segment_sums_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                    int n, int k, int p_pad, int chunks, float* __restrict__ partial,
                    int* __restrict__ ticket, float* __restrict__ out) {
  // this block's row
  const size_t row = blockIdx.z;
  ids += row * n;
  vals += row * k * n;
  out += row * p_pad * k;
  if (chunks > 1) {
    partial += row * chunks * p_pad * k;
    ticket += row;
  }
  // per warp and bin: the warp's count, then the count of the warps before
  __shared__ __align__(16) unsigned short cnt[kSegWarps][kSegStride];
  __shared__ int first[kSegBins + 1];                // a bin's first slot
  __shared__ int wsum[kSegBins / 32];
  __shared__ float sval[kSegLanes][kSegThreads];     // values in slot order
  __shared__ bool last;
  const int c = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e = c * kSegThreads + tid;
  const int id = e < n ? ids[e] : -1;
  const int local = id - g * kSegBins;
  const bool in = (unsigned)id < (unsigned)p_pad && (unsigned)local < (unsigned)kSegBins;
  float v[kSegLanes];   // this entry's values of the first channel group
#pragma unroll
  for (int q = 0; q < kSegLanes; ++q) v[q] = in && q < k ? vals[(size_t)q * n + e] : 0.f;
  for (int i = tid; i < kSegWarps * kSegStride / 2; i += kSegThreads)
    reinterpret_cast<unsigned*>(&cnt[0][0])[i] = 0u;
  __syncthreads();

  // 1. stable counting sort: rank in the warp, then the warps before
  const unsigned peers = __match_any_sync(0xffffffffu, in ? local : -1);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (in && rank == 0) cnt[warp][local] = (unsigned short)__popc(peers);
  __syncthreads();
  int total = 0, incl = 0;
  if (tid < kSegBins) {
    unsigned short w_cnt[kSegWarps];
#pragma unroll
    for (int w = 0; w < kSegWarps; ++w) w_cnt[w] = cnt[w][tid];
#pragma unroll
    for (int w = 0; w < kSegWarps; ++w) {
      cnt[w][tid] = (unsigned short)total;
      total += w_cnt[w];
    }
    incl = total;   // inclusive scan of the bins' totals: in the warp,
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
  }
  __syncthreads();
  if (tid < kSegBins) {   // then over the warps
    for (int w = 0; w < warp; ++w) incl += wsum[w];
    first[tid] = incl - total;
    if (tid == kSegBins - 1) first[kSegBins] = incl;
  }
  __syncthreads();
  const int slot = in ? first[local] + cnt[warp][local] + rank : -1;

  // 2. per channel group, thread (b, q) adds bin b's run of channel k0 + q
  const int b = tid % kSegBins;
  const int q = tid / kSegBins;
  const int p = g * kSegBins + b;
  const int r0 = first[b], r1 = first[b + 1];
  float* dst = chunks == 1 ? out : partial + (size_t)c * p_pad * k;
  for (int k0 = 0; k0 < k; k0 += kSegLanes) {
    if (k0 > 0) {
      __syncthreads();   // every walk of the previous group is done
#pragma unroll
      for (int u = 0; u < kSegLanes; ++u)
        v[u] = in && k0 + u < k ? vals[(size_t)(k0 + u) * n + e] : 0.f;
    }
    if (in) {
#pragma unroll
      for (int u = 0; u < kSegLanes; ++u) sval[u][slot] = v[u];
    }
    __syncthreads();
    if (k0 + q < k && p < p_pad) {
      const float* run = sval[q];
      float acc = 0.f;
      int r = r0;
      if (r1 - r0 >= kSegAhead) {   // the next entries load while these add
        float x[kSegAhead];
#pragma unroll
        for (int u = 0; u < kSegAhead; ++u) x[u] = run[r + u];
        for (r += kSegAhead; r + kSegAhead <= r1; r += kSegAhead) {
          float y[kSegAhead];
#pragma unroll
          for (int u = 0; u < kSegAhead; ++u) y[u] = run[r + u];
#pragma unroll
          for (int u = 0; u < kSegAhead; ++u) acc += x[u];
#pragma unroll
          for (int u = 0; u < kSegAhead; ++u) x[u] = y[u];
        }
#pragma unroll
        for (int u = 0; u < kSegAhead; ++u) acc += x[u];
      }
      for (; r < r1; ++r) acc += run[r];
      dst[(size_t)p * k + k0 + q] = acc;
    }
  }
  if (chunks == 1) return;

  // 3. the last block adds the chunks' partials in chunk order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == chunks * (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int pk = p_pad * k;
  for (int o = tid; o < pk; o += kSegThreads) {
    const float* src = partial + o;
    float s = 0.f;
    int cc = 0;
    for (; cc + kSegInFlight <= chunks; cc += kSegInFlight) {
      float x[kSegInFlight];   // loads in flight together, added in order
#pragma unroll
      for (int u = 0; u < kSegInFlight; ++u) x[u] = __ldcg(src + (size_t)(cc + u) * pk);
#pragma unroll
      for (int u = 0; u < kSegInFlight; ++u) s += x[u];
    }
    for (; cc < chunks; ++cc) s += __ldcg(src + (size_t)cc * pk);
    out[o] = s;
  }
  if (tid == 0) *ticket = 0;
}

}  // namespace quatro

// ids (B, N) int32, vals (B, K, N) f32 -> out (B, p_pad, K) f32, in
// chunks of `chunk` entries, which must be the block's 1024; 1 <= B <=
// 65535. Where N > chunk, partial holds B * ceil(N / chunk) * p_pad * K
// f32 of scratch and ticket B ints that are 0 (and are 0 again when the
// kernel ends); both may be null otherwise. One launch per call.
extern "C" int quatro_segment_sums(const int* ids, const float* vals, int bsz, int n,
                                   int k, int p_pad, int chunk, float* partial, int* ticket,
                                   float* out, cudaStream_t stream) {
  if (chunk != quatro::kSegThreads || n < 0 || bsz < 1 || bsz > 65535)
    return (int)cudaErrorInvalidValue;
  const int chunks = n > chunk ? (n + chunk - 1) / chunk : 1;
  if (chunks > 1 && (partial == nullptr || ticket == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid(chunks, (p_pad + quatro::kSegBins - 1) / quatro::kSegBins, bsz);
  quatro::segment_sums_kernel<<<grid, quatro::kSegThreads, 0, stream>>>(
      ids, vals, n, k, p_pad, chunks, partial, ticket, out);
  return (int)cudaGetLastError();
}
