// The matcher's candidates as int64 sort keys, for a batch of pairs.
//
// The counterpart of quatro_tpu/ops/matching.py:230-285 (the candidate
// assembly of match_features, which XLA fuses; no Pallas kernel there) up
// to its two-key sort's key; bit for bit
// quatro_tpu_torch/ops/match_kernels.py's match_candidates_plain.
//
// i_ab, d_ab (B, Na) int32 / f32: each source row's nearest target and its
// squared distance, i_ba, d_ba (B, Nb) the reverse, as the neighbour
// kernels write them (the wrappers' fill of empty rows, index 0 / f32 max
// where the row is masked or no column was valid, is applied here); the
// second neighbours i_ab2 .. d_ba2 under the fallback branch (null
// otherwise); smask (B, Na), tmask (B, Nb) -> keys (B, n_cand) int64 and
// ncorr (B,) int32. With nn the filled neighbours:
//   mutual_a[i] = nn_ba[nn_ab[i]] == i & smask[i] & tmask[nn_ab[i]],
//   mutual_b[j] = nn_ab[nn_ba[j]] == j & tmask[j] & smask[nn_ba[j]],
//   union_a[i] = smask[i] & tmask[nn_ab[i]],
//   union_b[j] = tmask[j] & smask[nn_ba[j]] & !mutual_b[j],
//   second_a[i] = smask[i] & tmask[nn_ab2[i]], second_b[j] likewise;
// the candidate slots by branch (mode):
//   0 fallback: [i: (i, nn_ab[i]), j: (nn_ba[j], j), i: (i, nn_ab2[i]),
//     j: (nn_ba2[j], j)], flags [union_a, union_b, second_a, second_b]
//     where the pair's mutual count is below min_matches, else
//     [mutual_a, 0, 0, 0];
//   1 crosscheck: [i: (i, nn_ab[i])], flag mutual_a;
//   2 union: [i: (i, nn_ab[i]), j: (nn_ba[j], j)], flags [union_a,
//     union_b];
// key = (flag ? bits(max(d, 0)) : 2^31 - 1) << 32 | (src << 15) + tgt, d
// the slot's filled distance, max as torch.clamp keeps a NaN; ncorr the
// flags' count. Exact integer work: no rounding anywhere.
//
// Bound on the card: bytes (at path P's B = 64, Na = Nb = 8192 under the
// fallback: 10.5 MB of neighbours and masks read, 16.8 MB of keys
// written, ~8 us at 3.35 TB/s). Design: a block of 1024 threads a pair;
// under the fallback it first counts the pair's mutual pairs (a block
// sum, no atomics), then each thread walks the slots t, t + 1024, ...,
// gathering what its slot needs (a few L2-resident loads), writes the key
// and counts its flags; a block sum gives ncorr. At B = 1 this is one SM
// with ~40 slots a thread.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace quatro {
namespace mc {

constexpr int kThreads = 1024;
constexpr float kFltMax = 3.40282346638528859812e+38f;
constexpr unsigned kNone = 0x7fffffffu;      // the key of a slot that is none

// the neighbour wrappers' fill
__device__ __forceinline__ int fill_idx(int i, float d, bool m) {
  return (!m || d >= kFltMax) ? 0 : i;
}
__device__ __forceinline__ float fill_d(float d, bool m) {
  return (!m || d >= kFltMax) ? kFltMax : d;
}

// (quality bits << 32) | packed pair
__device__ __forceinline__ long long slot_key(bool flag, float d, int src, int tgt) {
  const float q = isnan(d) ? d : fmaxf(d, 0.f);   // torch.clamp(d, min=0)
  const unsigned hi = flag ? __float_as_uint(q) : kNone;
  const unsigned lo = ((unsigned)src << 15) + (unsigned)tgt;
  return (long long)(((unsigned long long)hi << 32) | lo);
}

// the block's sum of one int a thread (every thread gets it)
__device__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();                       // red may still be read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
match_candidates_kernel(const int* __restrict__ i_ab, const float* __restrict__ d_ab,
                        const int* __restrict__ i_ba, const float* __restrict__ d_ba,
                        const int* __restrict__ i_ab2, const float* __restrict__ d_ab2,
                        const int* __restrict__ i_ba2, const float* __restrict__ d_ba2,
                        const bool* __restrict__ smask, const bool* __restrict__ tmask,
                        int na, int nb, int mode, int min_matches,
                        long long* __restrict__ keys, int* __restrict__ ncorr) {
  __shared__ int red[32];
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  i_ab += b * na; d_ab += b * na; smask += b * na;
  i_ba += b * nb; d_ba += b * nb; tmask += b * nb;
  const bool fallback = mode == 0;
  if (fallback) {
    i_ab2 += b * na; d_ab2 += b * na;
    i_ba2 += b * nb; d_ba2 += b * nb;
  }
  const int n_cand = mode == 0 ? 2 * (na + nb) : mode == 1 ? na : na + nb;
  keys += b * n_cand;

  // the fallback's branch: the pair's mutual count
  bool use_union = mode == 2;
  if (fallback) {
    int cnt = 0;
    for (int i = tid; i < na; i += kThreads) {
      const bool sm = smask[i];
      const int j = fill_idx(i_ab[i], d_ab[i], sm);
      const bool tm = tmask[j];
      cnt += sm && tm && fill_idx(i_ba[j], d_ba[j], tm) == i;
    }
    use_union = block_sum(cnt, red) < min_matches;
  }

  int flags = 0;
#pragma unroll 4
  for (int s = tid; s < n_cand; s += kThreads) {
    const int block = s < na ? 0 : s < na + nb ? 1 : s < 2 * na + nb ? 2 : 3;
    const int r = s - (block == 0 ? 0 : block == 1 ? na : block == 2 ? na + nb : 2 * na + nb);
    int src, tgt;
    float d;
    bool flag;
    if (block == 0) {              // (i, nn_ab[i])
      const bool sm = smask[r];
      const float d0 = d_ab[r];
      src = r;
      tgt = fill_idx(i_ab[r], d0, sm);
      d = fill_d(d0, sm);
      const bool tm = tmask[tgt];
      if (use_union) {
        flag = sm && tm;
      } else {                     // mutual_a
        flag = sm && tm && fill_idx(i_ba[tgt], d_ba[tgt], tm) == r;
      }
    } else if (block == 1) {       // (nn_ba[j], j)
      const bool tm = tmask[r];
      const float d0 = d_ba[r];
      tgt = r;
      src = fill_idx(i_ba[r], d0, tm);
      d = fill_d(d0, tm);
      if (use_union) {             // union_b, the mutual pairs left out
        const bool sm = smask[src];
        const bool mutual_b = tm && sm && fill_idx(i_ab[src], d_ab[src], sm) == r;
        flag = tm && sm && !mutual_b;
      } else {
        flag = false;
      }
    } else if (block == 2) {       // (i, nn_ab2[i])
      const bool sm = smask[r];
      const float d0 = d_ab2[r];
      src = r;
      tgt = fill_idx(i_ab2[r], d0, sm);
      d = fill_d(d0, sm);
      flag = use_union && sm && tmask[tgt];
    } else {                       // (nn_ba2[j], j)
      const bool tm = tmask[r];
      const float d0 = d_ba2[r];
      tgt = r;
      src = fill_idx(i_ba2[r], d0, tm);
      d = fill_d(d0, tm);
      flag = use_union && tm && smask[src];
    }
    keys[s] = slot_key(flag, d, src, tgt);
    flags += flag;
  }
  const int total = block_sum(flags, red);
  if (tid == 0) ncorr[b] = total;
}

}  // namespace mc
}  // namespace quatro

// see the head of this file; mode 0 fallback (the second neighbours
// non-null), 1 crosscheck, 2 union; Na, Nb <= 32768. One launch a call.
extern "C" int quatro_match_candidates(const int* i_ab, const float* d_ab, const int* i_ba,
                                       const float* d_ba, const int* i_ab2, const float* d_ab2,
                                       const int* i_ba2, const float* d_ba2, const bool* smask,
                                       const bool* tmask, int bsz, int na, int nb, int mode,
                                       int min_matches, long long* keys, int* ncorr,
                                       cudaStream_t stream) {
  if (mode < 0 || mode > 2 || na < 0 || nb < 0 || na > 32768 || nb > 32768 || bsz < 1)
    return (int)cudaErrorInvalidValue;
  if (mode == 0 && (!i_ab2 || !d_ab2 || !i_ba2 || !d_ba2)) return (int)cudaErrorInvalidValue;
  quatro::mc::match_candidates_kernel<<<bsz, quatro::mc::kThreads, 0, stream>>>(
      i_ab, d_ab, i_ba, d_ba, i_ab2, d_ab2, i_ba2, d_ba2, smask, tmask, na, nb, mode,
      min_matches, keys, ncorr);
  return (int)cudaGetLastError();
}
