// Patchwork's per-patch algebra: the seed heights from B8's histogram, and
// each plane fit's planes from B9's moment sums, in two kernels.
//
// The counterpart of quatro_tpu/preprocessing/patchwork.py:296-319 (the
// seed stage) and :328-387 (the plane algebra, the next table, the gates),
// which XLA fuses into loop fusions (no Pallas kernel there); bit for bit
// quatro_tpu_torch/ops/czm.py::seed_heights_plain and plane_fit_plain.
//
// seed: hist (B, 2, p_pad, 128) f32 [counts, z sums] and b0 (B,) int32 ->
//   lpr_h, live (B, P) and the first fit's table (B, p_pad, 5). A warp a
//   patch, lane l holding bins l, l + 32, l + 64, l + 96: counts and the
//   eligible counts' prefix by shuffles (integer-valued f32 counts, exact
//   in any order); each bin's share take * zsum / max(cnt, 1); the shares
//   added in fused.pairwise_sum's tree (bins j and j + 64, then j + 32,
//   then shuffles down 16 to 1); lpr_h = share sum / need where need > 0.
// plane: sums (B, p_pad, 10) f32, ptab (5, P) f32 [centre x, centre y,
//   elevation and flatness thresholds, concentric index] and, on the last
//   fit, live (B, P) bool -> the next table (B, p_pad, 5) [n1, n2, n3,
//   th_dist - d, flags] and, on the last fit, out (6, B, P) [n1, n2, n3,
//   th_dist_d, surface_var, elevation] and accepted (B, P). A thread a
//   (cloud, table row): the covariance (two roundings an entry, as
//   plane_covariance), the eigenpair of eig_sym3.cuh, the sanitising and
//   the sign, d and the gates.
//
// Rounding as torch's on the card: the _rn intrinsics, __fdiv_rn for a
// tensor quotient, torch.clamp and torch.maximum keeping a NaN; Python
// scalars enter rounded to f32. Bound on the card: bytes (path P's B = 64:
// 128 x 512 x 128 x 2 histogram words, 33.6 MB, 0.010 ms; the plane kernel
// 128 x 512 x 15 words, 3.9 MB, 0.0012 ms). The plane kernel reads no host
// memory, so a CUDA graph captures it (the bf16 fits' fori).
#include <cuda_runtime.h>

#include "eig_sym3.cuh"

namespace quatro {

constexpr int kSeedThreads = 256;
constexpr int kPlaneThreads = 128;
constexpr int kSeedBins = 128;
constexpr int kTabCols = 5;
constexpr int kSums = 10;

// torch.clamp(v, max=hi) and torch.minimum: a NaN stays NaN
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return (v != v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__global__ void __launch_bounds__(kSeedThreads)
seed_heights_kernel(const float* __restrict__ hist, const int* __restrict__ b0, int p_pad,
                    int p_cnt, int zone0_end, int num_lpr, int num_min_pts, float th_seeds,
                    float* __restrict__ lpr_out, bool* __restrict__ live_out,
                    float* __restrict__ tab) {
  using namespace eig;
  const int p = (blockIdx.x * kSeedThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const size_t b = blockIdx.y;
  if (p >= p_pad) return;
  float* row = tab + (b * p_pad + p) * kTabCols;
  if (p >= p_cnt) {                       // the zero rows past P
    if (lane < kTabCols) row[lane] = 0.0f;
    return;
  }
  const float* cnt_h = hist + (b * 2 * p_pad + p) * kSeedBins;
  const float* zsum_h = cnt_h + (size_t)p_pad * kSeedBins;
  const int first = b0[b];
  float cnt[4], cnt_e[4], zsum_e[4], incl[4];
  float counts = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = lane + 32 * q;
    cnt[q] = cnt_h[j];
    const float elig = (p < zone0_end && j < first) ? 0.0f : 1.0f;
    cnt_e[q] = fmul(cnt[q], elig);
    zsum_e[q] = fmul(zsum_h[j], elig);
    counts = fadd(counts, cnt[q]);
  }
  // counts and eligible prefixes: integer-valued, exact in any order
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) counts = fadd(counts, __shfl_xor_sync(0xffffffffu, counts, s));
  float before = 0.0f;                    // eligible counts of the groups before
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v = cnt_e[q];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, v, s);
      if (lane >= s) v = fadd(v, o);
    }
    incl[q] = fadd(before, v);
    before = fadd(before, __shfl_sync(0xffffffffu, v, 31));
  }
  const float need = clamp_max(before, (float)num_lpr);
  float share[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float take = tmin(clamp_min(fsub(need, fsub(incl[q], cnt_e[q])), 0.0f), cnt_e[q]);
    share[q] = fdiv(fmul(take, zsum_e[q]), clamp_min(cnt_e[q], 1.0f));
  }
  // fused.pairwise_sum over the 128 bins
  float acc = fadd(fadd(share[0], share[2]), fadd(share[1], share[3]));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc = fadd(acc, __shfl_down_sync(0xffffffffu, acc, s));
  if (lane == 0) {
    const float lpr = need > 0.0f ? fdiv(acc, clamp_min(need, 1.0f)) : 0.0f;
    lpr_out[b * p_cnt + p] = lpr;
    live_out[b * p_cnt + p] = counts > (float)num_min_pts;
    row[0] = 0.0f;
    row[1] = 0.0f;
    row[2] = 1.0f;
    row[3] = fadd(lpr, th_seeds);
    row[4] = 0.0f;
  }
}

struct PlaneParams {
  int p_pad, p_cnt, final_fit;
  float th_dist, upright_thr;
  int rings_of_interest, global_elevation;
  float global_elevation_thr;
};

__global__ void __launch_bounds__(kPlaneThreads)
plane_fit_kernel(const float* __restrict__ sums, const float* __restrict__ ptab,
                 const bool* __restrict__ live, PlaneParams pp, float* __restrict__ tab,
                 float* __restrict__ out, bool* __restrict__ accepted_out) {
  using namespace eig;
  const int p = blockIdx.x * kPlaneThreads + threadIdx.x;
  const size_t b = blockIdx.y;
  if (p >= pp.p_pad) return;
  float* row = tab + (b * pp.p_pad + p) * kTabCols;
  if (p >= pp.p_cnt) {
#pragma unroll
    for (int q = 0; q < kTabCols; ++q) row[q] = 0.0f;
    return;
  }
  float s[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = sums[(b * pp.p_pad + p) * kSums + k];
  // plane_covariance
  const float cnt = clamp_min(s[0], 1.0f);
  const float mx = fdiv(s[1], cnt), my = fdiv(s[2], cnt), mz = fdiv(s[3], cnt);
  const float cxx = fsub(fdiv(s[4], cnt), fmul(mx, mx));
  const float cxy = fsub(fdiv(s[5], cnt), fmul(mx, my));
  const float cxz = fsub(fdiv(s[6], cnt), fmul(mx, mz));
  const float cyy = fsub(fdiv(s[7], cnt), fmul(my, my));
  const float cyz = fsub(fdiv(s[8], cnt), fmul(my, mz));
  const float czz = fsub(fdiv(s[9], cnt), fmul(mz, mz));
  const Eigenpair e = smallest_eigenpair_sym3(cxx, cxy, cxz, cyy, cyz, czz);
  // sanitise empty or degenerate patches, then n_z >= 0
  const bool okp = s[0] > 0.5f;
  float n1 = okp && isfinite(e.v1) ? e.v1 : 0.0f;
  float n2 = okp && isfinite(e.v2) ? e.v2 : 0.0f;
  float n3 = okp && isfinite(e.v3) ? e.v3 : 1.0f;
  const float lam = okp && isfinite(e.eig) ? e.eig : 0.0f;
  if (n3 < 0.0f) {
    n1 = -n1;
    n2 = -n2;
    n3 = -n3;
  }
  const float mx_w = fadd(mx, ptab[p]), my_w = fadd(my, ptab[pp.p_cnt + p]);
  const float d = -fadd(fadd(fmul(n1, mx_w), fmul(n2, my_w)), fmul(n3, mz));
  const float th = fsub(pp.th_dist, d);
  row[0] = n1;
  row[1] = n2;
  row[2] = n3;
  row[3] = th;
  if (!pp.final_fit) {
    row[4] = 0.0f;
    return;
  }
  const float trace = fadd(fadd(cxx, cyy), czz);
  const float surface_var = fdiv(lam, clamp_min(trace, kTiny));
  const float elevation = mz;
  // the gates and the revert / reject bookkeeping
  const bool is_live = live[b * pp.p_cnt + p];
  const bool upright = fabsf(n3) >= pp.upright_thr;
  const bool near = ptab[4 * pp.p_cnt + p] < (float)pp.rings_of_interest;
  const bool high = elevation > ptab[2 * pp.p_cnt + p];
  const bool flat_ok = ptab[3 * pp.p_cnt + p] > surface_var;
  const bool near_accept = high ? flat_ok : true;
  const bool far_accept = pp.global_elevation ? !(elevation > pp.global_elevation_thr) : true;
  const bool accepted = upright && (near ? near_accept : far_accept) && is_live;
  const bool revert = is_live && upright && near && high && flat_ok;
  const bool reject = is_live && upright && near && high && !flat_ok;
  row[4] = (float)accepted + 2.0f * (float)revert + 4.0f * (float)reject + 8.0f * (float)is_live;
  const size_t bp = b * pp.p_cnt + p, plane = (size_t)gridDim.y * pp.p_cnt;
  out[bp] = n1;
  out[plane + bp] = n2;
  out[2 * plane + bp] = n3;
  out[3 * plane + bp] = th;
  out[4 * plane + bp] = surface_var;
  out[5 * plane + bp] = elevation;
  accepted_out[bp] = accepted;
}

}  // namespace quatro

extern "C" int quatro_seed_heights(const float* hist, const int* b0, int bsz, int p_pad,
                                   int p_cnt, int zone0_end, int num_lpr, int num_min_pts,
                                   float th_seeds, float* lpr_h, bool* live, float* tab,
                                   cudaStream_t stream) {
  using namespace quatro;
  const int warps = kSeedThreads / 32;
  dim3 grid((p_pad + warps - 1) / warps, bsz);
  seed_heights_kernel<<<grid, kSeedThreads, 0, stream>>>(hist, b0, p_pad, p_cnt, zone0_end,
                                                         num_lpr, num_min_pts, th_seeds, lpr_h,
                                                         live, tab);
  return (int)cudaGetLastError();
}

extern "C" int quatro_plane_fit(const float* sums, const float* ptab, const bool* live, int bsz,
                                int p_pad, int p_cnt, int final_fit, float th_dist,
                                float upright_thr, int rings_of_interest, int global_elevation,
                                float global_elevation_thr, float* tab, float* out,
                                bool* accepted, cudaStream_t stream) {
  using namespace quatro;
  const PlaneParams pp{p_pad, p_cnt, final_fit, th_dist, upright_thr, rings_of_interest,
                       global_elevation, global_elevation_thr};
  dim3 grid((p_pad + kPlaneThreads - 1) / kPlaneThreads, bsz);
  plane_fit_kernel<<<grid, kPlaneThreads, 0, stream>>>(sums, ptab, live, pp, tab, out,
                                                       accepted);
  return (int)cudaGetLastError();
}
