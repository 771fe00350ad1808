// The matcher's tuple test and compaction, for a batch of pairs.
//
// The counterpart of quatro_tpu/ops/matching.py:165-184 (tuple_test_keep's
// lax.scan over the trials) and :295-333 (the tuple_min_keep gate and the
// compaction's sort), which XLA compiles (no Pallas kernel there); bit for
// bit quatro_tpu_torch/ops/match_kernels.py's tuple_compact_plain.
//
// keys (B, n_cand) int64 sorted along each row, ncorr (B,) int32,
// src_xyz (B, Na, 3), tgt_xyz (B, Nb, 3), shifts (T, 2) int32 -> src_idx,
// tgt_idx (B, C) int32, mask (B, C) bool, src_out, tgt_out (B, C, 3) f32.
// On the prefix of tt candidates (packed = key & 0xffffffff, src = packed
// >> 15, tgt = packed & 0x7fff) with live = min(ncorr, tt):
// 1. the test (use_tuple): trial t = (s1, s2) tests the triple (i, f1 =
//    (i + s1) % tt, f2 = (i + s2) % tt) for every i with i, f1, f2 <
//    live; it passes when, for the three sides (i, f1), (f1, f2), (f2, i)
//    with source length a and target length b, a * scale < b and b < a /
//    scale; a candidate is kept when a passing triple holds it (the
//    reference's jnp.roll of the pass mask by s1 and s2 is the same
//    relation seen from the triple's other members);
// 2. the gate: the kept candidates where there are at least min_keep of
//    them, else all live ones (without the test: all live ones);
// 3. the compaction: the kept candidates in prefix order, then slots
//    past them zero (mask false, indices 0, coordinates +0), the first C.
//
// Rounding as torch's on the card: a length is
// __fsqrt_rn(((dx*dx + dy*dy) + dz*dz)) with every difference, product
// and sum an _rn intrinsic (never contracted; utils/fused.sqrt is
// correctly rounded), a * scale the f32 product with f32(scale), and a /
// scale, a tensor divided by a Python scalar, the f32 product with the
// f32 reciprocal inv = f32(1) / f32(scale) (fused.recip), as torch computes
// it on the card. The gate and the partition are exact.
//
// Bound on the card: operations (up to live x T triples, six lengths of
// ~9 operations and six products, ~80 a triple: at live = 2048 and T =
// 100, 16 M a pair, 0.25 us at 67 TFLOP/s; the keys and outputs a few
// hundred KB). Design: a block of 1024 threads a pair, no exchange between
// blocks. The pair's prefix (6 coordinates and the packed pair a
// candidate, 28 bytes, and a keep byte) is staged in shared memory (58 KB
// at tt = 2048; past 200 KB in the pair's slice of a workspace in device
// memory, read through L1); each thread takes the triples that start at
// its candidates i, i + 1024, ..., its own coordinates in registers, and a
// passing triple marks its three members' keep bytes (a byte written 1 by
// any number of threads: the union, the same in any order). The sides'
// gates are tested one after the other, each side's lengths formed only
// when the gates before it passed (the same decision). Then a block sum
// of the kept candidates for the gate, and a block scan (ballot, warp
// counts) in tiles of 1024 for the stable partition, each kept candidate
// writing its slot and gathering its coordinates. At B = 1 the test runs
// on one SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace quatro {
namespace tup {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float side(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by), dz = __fsub_rn(az, bz);
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz)));
}

__device__ __forceinline__ bool ratio_ok(float a, float b, float scale, float inv) {
  return __fmul_rn(a, scale) < b && b < __fmul_rn(a, inv);
}

__global__ void __launch_bounds__(kThreads)
tuple_compact_kernel(const long long* __restrict__ keys, const int* __restrict__ ncorr,
                     const float* __restrict__ src_xyz, const float* __restrict__ tgt_xyz,
                     const int* __restrict__ shifts, float* __restrict__ work, int n_cand,
                     int na, int nb, int tt, int capacity, int trials, int use_tuple,
                     float scale, float inv, int min_keep, int* __restrict__ src_idx,
                     int* __restrict__ tgt_idx, bool* __restrict__ out_mask,
                     float* __restrict__ src_out, float* __restrict__ tgt_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int red[kWarps];
  __shared__ int carry;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t words = 7 * (size_t)tt + (tt + 3) / 4;
  float* base = work ? work + b * words : smem;
  float* co = base;                                      // co[c * tt + i]
  int* pk = reinterpret_cast<int*>(base + 6 * (size_t)tt);
  unsigned char* keep = reinterpret_cast<unsigned char*>(base + 7 * (size_t)tt);
  keys += b * n_cand;
  src_xyz += b * na * 3;
  tgt_xyz += b * nb * 3;
  const int live = min(ncorr[b], tt);

  for (int i = tid; i < tt; i += kThreads) {
    const int p = (int)(unsigned)(unsigned long long)keys[i];
    pk[i] = p;
    keep[i] = 0;
    if (use_tuple && i < live) {
      const float* s = src_xyz + (size_t)(p >> 15) * 3;
      const float* t = tgt_xyz + (size_t)(p & 0x7fff) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        co[c * tt + i] = s[c];
        co[(3 + c) * tt + i] = t[c];
      }
    }
  }
  __syncthreads();

  int kept = 0;
  if (use_tuple) {
    for (int i = tid; i < live; i += kThreads) {
      const float px = co[i], py = co[tt + i], pz = co[2 * tt + i];
      const float qx = co[3 * tt + i], qy = co[4 * tt + i], qz = co[5 * tt + i];
      for (int t = 0; t < trials; ++t) {
        const int f1 = (i + __ldg(shifts + 2 * t)) % tt;
        const int f2 = (i + __ldg(shifts + 2 * t + 1)) % tt;
        if (f1 >= live || f2 >= live) continue;
        const float p1x = co[f1], p1y = co[tt + f1], p1z = co[2 * tt + f1];
        const float q1x = co[3 * tt + f1], q1y = co[4 * tt + f1], q1z = co[5 * tt + f1];
        if (!ratio_ok(side(px, py, pz, p1x, p1y, p1z), side(qx, qy, qz, q1x, q1y, q1z), scale,
                      inv))
          continue;
        const float p2x = co[f2], p2y = co[tt + f2], p2z = co[2 * tt + f2];
        const float q2x = co[3 * tt + f2], q2y = co[4 * tt + f2], q2z = co[5 * tt + f2];
        if (!ratio_ok(side(p1x, p1y, p1z, p2x, p2y, p2z), side(q1x, q1y, q1z, q2x, q2y, q2z),
                      scale, inv))
          continue;
        if (!ratio_ok(side(p2x, p2y, p2z, px, py, pz), side(q2x, q2y, q2z, qx, qy, qz), scale,
                      inv))
          continue;
        keep[i] = 1;
        keep[f1] = 1;
        keep[f2] = 1;
      }
    }
    __syncthreads();
    for (int i = tid; i < live; i += kThreads) kept += keep[i];
  }
  // the gate: the survivors where there are at least min_keep of them
  int v = kept;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) red[warp] = v;
  if (tid == 0) carry = 0;
  __syncthreads();
  int survivors = 0;
  for (int w = 0; w < kWarps; ++w) survivors += red[w];
  const bool tested = use_tuple && survivors >= min_keep;
  __syncthreads();                                 // red is reused below

  // the stable partition: kept candidates in prefix order
  for (int i0 = 0; i0 < live; i0 += kThreads) {
    const int i = i0 + tid;
    const bool k = i < live && (tested ? keep[i] != 0 : true);
    const unsigned ballot = __ballot_sync(kFull, k);
    if (lane == 0) red[warp] = __popc(ballot);
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += red[w];
    const int slot = before + __popc(ballot & ((1u << lane) - 1u));
    if (k && slot < capacity) {
      const int p = pk[i];
      const int s = p >> 15, t = p & 0x7fff;
      const size_t o = b * capacity + slot;
      src_idx[o] = s;
      tgt_idx[o] = t;
      out_mask[o] = true;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        src_out[o * 3 + c] = src_xyz[(size_t)s * 3 + c];
        tgt_out[o * 3 + c] = tgt_xyz[(size_t)t * 3 + c];
      }
    }
    __syncthreads();                               // every thread read carry
    if (tid == kThreads - 1) carry = slot + k;
    __syncthreads();
  }
  // the slots past the kept candidates
  for (int slot = carry + tid; slot < capacity; slot += kThreads) {
    const size_t o = b * capacity + slot;
    src_idx[o] = 0;
    tgt_idx[o] = 0;
    out_mask[o] = false;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      src_out[o * 3 + c] = 0.f;
      tgt_out[o * 3 + c] = 0.f;
    }
  }
}

}  // namespace tup
}  // namespace quatro

// see the head of this file. 1 <= tt <= n_cand; Na, Nb <= 32768; shifts
// (trials, 2) with 0 < s < 2 tt, null when use_tuple is 0; work null when
// the pair's prefix (7 tt + ceil(tt / 4) words) fits the block's shared
// memory (at most 200 KB), else B such slices of device memory. One launch
// a call.
extern "C" int quatro_tuple_compact(const long long* keys, const int* ncorr,
                                    const float* src_xyz, const float* tgt_xyz,
                                    const int* shifts, float* work, int bsz, int n_cand, int na,
                                    int nb, int tt, int capacity, int trials, int use_tuple,
                                    float scale, float inv, int min_keep, int* src_idx,
                                    int* tgt_idx, bool* out_mask, float* src_out,
                                    float* tgt_out, cudaStream_t stream) {
  using namespace quatro::tup;
  if (bsz < 1 || tt < 1 || tt > n_cand || capacity < 1 || na > 32768 || nb > 32768 ||
      (use_tuple && trials > 0 && !shifts))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = 4 * (7 * (size_t)tt + (tt + 3) / 4);
  if (!work && bytes > 200 * 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = work ? 0 : bytes;
  static bool attr = false;
  if (!attr) {
    const int rc = (int)cudaFuncSetAttribute(tuple_compact_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             200 * 1024);
    if (rc) return rc;
    attr = true;
  }
  tuple_compact_kernel<<<bsz, kThreads, smem, stream>>>(
      keys, ncorr, src_xyz, tgt_xyz, shifts, work, n_cand, na, nb, tt, capacity, trials,
      use_tuple, scale, inv, min_keep, src_idx, tgt_idx, out_mask, src_out, tgt_out);
  return (int)cudaGetLastError();
}
