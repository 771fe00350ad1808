// Hit counts of the registration overlap, for every (pair, pose) in one
// launch.
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
// idx (4, L) int32 gives each lead index its row of p, the source mask, the
// target and the target mask (the wrapper's broadcast), so the K poses of
// a pair read one target and nothing is copied K times.
//
// Bound on the card: operations, ~9 f32 operations (3 sub, 3 mul, 2 add,
// the min) per (valid source row, valid target point): 384 x 2048 x 8192
// at path P's B = 64, 0.86 ms at 67 TFLOP/s.
// Design: 128 threads a block, R source rows a thread in registers (R = 8,
// 4, 2 or 1, as many as keep >= 2 blocks an SM busy), the target streamed
// through shared memory in tiles of 1024 points as float4 (x, y, z, valid),
// each read by every thread at once (a broadcast); the row min with PTX's
// min.NaN (NaN-propagating, as torch.amin); one integer atomic per warp.
// A block whose rows are all masked or padding exits before the target.
#include <cuda_runtime.h>

#include "common.cuh"

namespace quatro {

constexpr int kOverlapThreads = 128;
constexpr int kOverlapTile = 1024;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <int R>
__global__ void __launch_bounds__(kOverlapThreads)
overlap_hits_kernel(const float* __restrict__ p, const unsigned char* __restrict__ pm,
                    const float* __restrict__ tgt, const unsigned char* __restrict__ tm,
                    const float* __restrict__ r2p, const int* __restrict__ idx, int lead,
                    int n, int m, int blocks_per_lead, unsigned long long* __restrict__ out) {
  __shared__ float4 tile[kOverlapTile];
  const int l = blockIdx.x / blocks_per_lead;
  const int row0 = (blockIdx.x - l * blocks_per_lead) * (kOverlapThreads * R);
  const float* pl = p + (size_t)idx[l] * n * 3;
  const unsigned char* pml = pm + (size_t)idx[lead + l] * n;
  const float* tl = tgt + (size_t)idx[2 * lead + l] * m * 3;
  const unsigned char* tml = tm + (size_t)idx[3 * lead + l] * m;

  float px[R], py[R], pz[R], best[R];
  bool live[R];
  bool any = false;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = row0 + k * kOverlapThreads + threadIdx.x;
    live[k] = i < n && pml[i];
    any |= live[k];
    px[k] = live[k] ? pl[3 * i] : 0.0f;
    py[k] = live[k] ? pl[3 * i + 1] : 0.0f;
    pz[k] = live[k] ? pl[3 * i + 2] : 0.0f;
    best[k] = __int_as_float(0x7f800000);   // +inf
  }
  if (!__syncthreads_or(any)) return;

  const float inf = __int_as_float(0x7f800000);
  for (int t0 = 0; t0 < m; t0 += kOverlapTile) {
    const int cnt = min(kOverlapTile, m - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kOverlapThreads) {
      const int g = t0 + j;
      tile[j] = make_float4(tl[3 * g], tl[3 * g + 1], tl[3 * g + 2], tml[g] ? 1.0f : 0.0f);
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 q = tile[j];
      const bool valid = q.w != 0.0f;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float d = sq3(sub(px[k], q.x), sub(py[k], q.y), sub(pz[k], q.z));
        best[k] = min_nan(best[k], valid ? d : inf);
      }
    }
  }
  const float r2 = *r2p;
  int hits = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) hits += (live[k] && best[k] <= r2) ? 1 : 0;
  hits = __reduce_add_sync(0xffffffffu, hits);
  if ((threadIdx.x & 31) == 0 && hits != 0) atomicAdd(out + l, (unsigned long long)hits);
}

template <int R>
int launch_overlap(const float* p, const unsigned char* pm, const float* tgt,
                   const unsigned char* tm, const float* r2, const int* idx, int lead, int n,
                   int m, unsigned long long* out, cudaStream_t stream) {
  const int per = (n + kOverlapThreads * R - 1) / (kOverlapThreads * R);
  const long long blocks = (long long)per * lead;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  overlap_hits_kernel<R><<<(unsigned)blocks, kOverlapThreads, 0, stream>>>(
      p, pm, tgt, tm, r2, idx, lead, n, m, per, out);
  return (int)cudaGetLastError();
}

}  // namespace quatro

extern "C" int quatro_overlap_hits(const float* p, const unsigned char* pm, const float* tgt,
                                   const unsigned char* tm, const float* r2, const int* idx,
                                   int lead, int n, int m, unsigned long long* out,
                                   cudaStream_t stream) {
  using namespace quatro;
  if (lead <= 0 || n <= 0) return 0;
  // as many rows a thread as keep two blocks on each of the 132 SMs
  const long long want = 2 * 132;
  int r = 8;
  while (r > 1 && (long long)lead * ((n + kOverlapThreads * r - 1) / (kOverlapThreads * r)) < want)
    r /= 2;
  switch (r) {
    case 8: return launch_overlap<8>(p, pm, tgt, tm, r2, idx, lead, n, m, out, stream);
    case 4: return launch_overlap<4>(p, pm, tgt, tm, r2, idx, lead, n, m, out, stream);
    case 2: return launch_overlap<2>(p, pm, tgt, tm, r2, idx, lead, n, m, out, stream);
    default: return launch_overlap<1>(p, pm, tgt, tm, r2, idx, lead, n, m, out, stream);
  }
}
