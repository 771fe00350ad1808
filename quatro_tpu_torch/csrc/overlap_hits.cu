// Hit counts of the registration overlap, for every (pair, pose) in one
// call.
//
// The counterpart of quatro_tpu/solver/verify.py:63 (alignment_overlap's
// block_hits: XLA fuses the difference, square, sum, mask and row min of a
// block into one fusion inside lax.map; no Pallas kernel there), bit for
// bit quatro_tpu_torch/ops/overlap.py::overlap_hits_plain, the blocked
// torch route.
//
// For each lead index l (the poses and pairs broadcast together) and
// source row i of the posed source p (Lp, N, 3) f32:
//   d2[j] = ((dx dx) + (dy dy)) + (dz dz), dx = p[i].x - t[j].x, ...,
//           each operation rounded on its own (the _rn intrinsics, never
//           contracted into an FMA), +inf where the target mask is False;
//   hit   = src_mask[i] and min_j d2[j] <= r2, the min as torch.amin takes
//           it: a NaN among the d2 makes the row's min NaN, so no hit;
//   out[l] += hits (int64, zeroed by the wrapper).
// pack (2, Ct) int32 gives each target combination its target row and
// target-mask row, idx (3, L) int32 each lead index its row of p, its
// source-mask row and its target combination (the wrapper's broadcast),
// so the K poses of a pair read one packed target.
//
// Bound on the card: operations, ~9 f32 operations (3 sub, 3 mul, 2 add,
// the min) per (valid source row, valid target point): 0.0564 ms at path
// P's B = 64 (384 poses of 2048 rows against 8192 targets) and 0.00148 ms
// at path A at 67 TFLOP/s.
// Design: only valid points are computed.
// - Compact first (overlap_pack_kernel, one block of 1024 threads a row):
//   each target combination's valid points packed as float4 (x, y, z, 0)
//   with their count, each source-mask row's valid row indices with
//   theirs, in index order, by a block-wide integer prefix sum (a warp
//   ballot and a scan of the warps' counts, a fixed order).
// - Then the product (overlap_hits_kernel): a block of 128 threads takes
//   (lead index, tile of 128 x R valid rows, split of the valid targets);
//   each thread holds its R rows in registers and the split's targets
//   stream through shared memory in tiles of 1024 float4, each read by
//   every thread at once (a broadcast). A tile past the valid rows exits.
//   The row min with PTX's min.NaN (NaN-propagating, as torch.amin).
//   Dropping a masked target (an +inf) changes no min, and min.NaN does
//   not depend on order, so compacting and splitting change no bit; no
//   row stops early on a hit (a later NaN target must still reach it).
// - R rows a thread (4, 2 or 1) and the splits are chosen by the wrapper
//   (ops/overlap.overlap_plan) from the shapes, so that the grid holds at
//   least two blocks an SM (path A: 6 poses x 16 tiles x 3 splits; B = 64:
//   one split). Where a tile has more than one split, each block writes
//   its partial minima to a per-(device, stream) scratch and the tile's
//   last block (an integer ticket taken after a fence, which decides who
//   merges and never the result) merges them and sets the ticket back to
//   0. Hits are counted with one integer atomic a warp.
#include <cuda_runtime.h>

#include "common.cuh"

namespace quatro {

constexpr int kOverlapThreads = 128;
constexpr int kOverlapTile = 1024;
constexpr int kPackThreads = 1024;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Blocks [0, ct): target combination b's valid points (tgt row pack[b],
// mask row pack[ct + b]) into tpack[b], their count into tcount[b].
// Blocks [ct, ct + lpm): source-mask row s's valid row indices into
// sidx[s], their count into scount[s]. In index order.
__global__ void __launch_bounds__(kPackThreads)
overlap_pack_kernel(const float* __restrict__ tgt, const unsigned char* __restrict__ tm,
                    const unsigned char* __restrict__ pm, const int* __restrict__ pack,
                    int ct, int n, int m, float4* __restrict__ tpack, int* __restrict__ tcount,
                    int* __restrict__ sidx, int* __restrict__ scount) {
  __shared__ int warp_incl[kPackThreads / 32];
  const bool is_tgt = blockIdx.x < (unsigned)ct;
  const int b = is_tgt ? blockIdx.x : blockIdx.x - ct;
  const int len = is_tgt ? m : n;
  const unsigned char* mk = is_tgt ? tm + (size_t)pack[ct + b] * m : pm + (size_t)b * n;
  const float* pts = is_tgt ? tgt + (size_t)pack[b] * m * 3 : nullptr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int base = 0;
  for (int start = 0; start < len; start += kPackThreads) {
    const int i = start + threadIdx.x;
    const bool v = i < len && mk[i] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    const int pre = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) warp_incl[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      int x = warp_incl[lane];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      warp_incl[lane] = x;
    }
    __syncthreads();
    if (v) {
      const int o = base + (warp > 0 ? warp_incl[warp - 1] : 0) + pre;
      if (is_tgt)
        tpack[(size_t)b * m + o] = make_float4(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], 0.0f);
      else
        sidx[(size_t)b * n + o] = i;
    }
    base += warp_incl[31];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (is_tgt)
      tcount[b] = base;
    else
      scount[b] = base;
  }
}

template <int R>
__global__ void __launch_bounds__(kOverlapThreads)
overlap_hits_kernel(const float* __restrict__ p, const float4* __restrict__ tpack,
                    const int* __restrict__ tcount, const int* __restrict__ sidx,
                    const int* __restrict__ scount, const float* __restrict__ r2p,
                    const int* __restrict__ idx, int lead, int n, int m, int tiles, int splits,
                    float* __restrict__ partial, int* __restrict__ ticket,
                    unsigned long long* __restrict__ out) {
  __shared__ float4 tile[kOverlapTile];
  __shared__ int last;
  const int per_lead = tiles * splits;
  const int l = blockIdx.x / per_lead;
  const int rem = blockIdx.x - l * per_lead;
  const int t = rem / splits;
  const int sp = rem - t * splits;
  const int prow = idx[l];
  const int srow = idx[lead + l];
  const int trow = idx[2 * lead + l];
  const int nrows = scount[srow];
  const int row0 = t * (kOverlapThreads * R);
  if (row0 >= nrows) return;          // the whole tile (every split) exits
  const int nt = tcount[trow];
  const int chunk = (nt + splits - 1) / splits;
  const int j0 = min(nt, sp * chunk);
  const int j1 = min(nt, j0 + chunk);
  const float* pl = p + (size_t)prow * n * 3;
  const int* rows = sidx + (size_t)srow * n;
  const float4* tl = tpack + (size_t)trow * m;

  float px[R], py[R], pz[R], best[R];
  bool live[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int kk = row0 + k * kOverlapThreads + threadIdx.x;
    live[k] = kk < nrows;
    const int i = live[k] ? rows[kk] : 0;
    px[k] = live[k] ? pl[3 * i] : 0.0f;
    py[k] = live[k] ? pl[3 * i + 1] : 0.0f;
    pz[k] = live[k] ? pl[3 * i + 2] : 0.0f;
    best[k] = __int_as_float(0x7f800000);   // +inf
  }
  for (int base = j0; base < j1; base += kOverlapTile) {
    const int cnt = min(kOverlapTile, j1 - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kOverlapThreads) tile[j] = tl[base + j];
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 q = tile[j];
#pragma unroll
      for (int k = 0; k < R; ++k)
        best[k] = min_nan(best[k], sq3(sub(px[k], q.x), sub(py[k], q.y), sub(pz[k], q.z)));
    }
  }
  const float r2 = *r2p;
  int hits = 0;
  if (splits == 1) {
#pragma unroll
    for (int k = 0; k < R; ++k) hits += (live[k] && best[k] <= r2) ? 1 : 0;
  } else {
    // partials to the scratch, the tile's last block merges
    const int tix = l * tiles + t;
    const size_t pbase = (size_t)tix * splits * (kOverlapThreads * R);
#pragma unroll
    for (int k = 0; k < R; ++k)
      partial[pbase + (size_t)sp * (kOverlapThreads * R) + k * kOverlapThreads + threadIdx.x] =
          best[k];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket + tix, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float b = __int_as_float(0x7f800000);
      for (int s = 0; s < splits; ++s)
        b = min_nan(b, __ldcg(partial + pbase + (size_t)s * (kOverlapThreads * R) +
                              k * kOverlapThreads + threadIdx.x));
      hits += (live[k] && b <= r2) ? 1 : 0;
    }
    if (threadIdx.x == 0) ticket[tix] = 0;
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  if ((threadIdx.x & 31) == 0 && hits != 0) atomicAdd(out + l, (unsigned long long)hits);
}

template <int R>
int launch_overlap(const float* p, const float4* tpack, const int* tcount, const int* sidx,
                   const int* scount, const float* r2, const int* idx, int lead, int n, int m,
                   int tiles, int splits, float* partial, int* ticket, unsigned long long* out,
                   cudaStream_t stream) {
  const long long blocks = (long long)lead * tiles * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  overlap_hits_kernel<R><<<(unsigned)blocks, kOverlapThreads, 0, stream>>>(
      p, tpack, tcount, sidx, scount, r2, idx, lead, n, m, tiles, splits, partial, ticket, out);
  return (int)cudaGetLastError();
}

}  // namespace quatro

// p (Lp, N, 3), pm (Lpm, N) bool, tgt (Lt, M, 3), tm (Ltm, M) bool, r2 a
// device f32; pack (2, ct), idx (3, lead) int32 (above). rows_per_thread
// 1, 2 or 4, tiles = ceil(N / (128 rows_per_thread)) and splits >= 1 from
// the wrapper's plan. Scratch: tpack ct x M float4, tcount ct ints, sidx
// lpm x N ints, scount lpm ints; where splits > 1, partial lead x tiles x
// splits x 128 x rows_per_thread floats and ticket lead x tiles ints that
// are 0 (and are 0 again when the kernel ends). out (lead,) int64, zeroed.
// Two kernels, one call.
extern "C" int quatro_overlap_hits(const float* p, const unsigned char* pm, const float* tgt,
                                   const unsigned char* tm, const float* r2, const int* pack,
                                   const int* idx, int ct, int lpm, int lead, int n, int m,
                                   int rows_per_thread, int tiles, int splits, float* tpack,
                                   int* tcount, int* sidx, int* scount, float* partial,
                                   int* ticket, unsigned long long* out, cudaStream_t stream) {
  using namespace quatro;
  if (lead <= 0 || n <= 0) return 0;
  if (ct <= 0 || lpm <= 0 || splits < 1 ||
      tiles != (n + kOverlapThreads * rows_per_thread - 1) / (kOverlapThreads * rows_per_thread))
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (partial == nullptr || ticket == nullptr)) return (int)cudaErrorInvalidValue;
  float4* tp = reinterpret_cast<float4*>(tpack);
  overlap_pack_kernel<<<ct + lpm, kPackThreads, 0, stream>>>(tgt, tm, pm, pack, ct, n, m, tp,
                                                             tcount, sidx, scount);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (rows_per_thread) {
    case 4:
      return launch_overlap<4>(p, tp, tcount, sidx, scount, r2, idx, lead, n, m, tiles, splits,
                               partial, ticket, out, stream);
    case 2:
      return launch_overlap<2>(p, tp, tcount, sidx, scount, r2, idx, lead, n, m, tiles, splits,
                               partial, ticket, out, stream);
    case 1:
      return launch_overlap<1>(p, tp, tcount, sidx, scount, r2, idx, lead, n, m, tiles, splits,
                               partial, ticket, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
