// Patchwork's per-point work: the CZM bins, the channels of B8-B10 and the
// seed stage's z-bins, in two kernels.
//
// The counterpart of quatro_tpu/preprocessing/patchwork.py:119-186 (czm_bin,
// _patch_center_of_point) and :232-295 (the channels, the z range, b0 and
// the z-bins), which XLA fuses into loop fusions (no Pallas kernel there);
// bit for bit quatro_tpu_torch/ops/czm.py::czm_points_plain, whose
// hypotenuse and arctangent are utils/fused.py's (fdlibm_atan2.cuh).
//
// zrange: points (B, N, 3) f32 and mask (B, N) bool -> per chunk of
//   `chunk` points the min and max z of the kept points (mask and z >=
//   keep_z), +inf / -inf where none: zpart (B, chunks, 2). A block a chunk;
//   min and max do not depend on the order, and the kept heights hold no
//   NaN.
// points: each block first folds its cloud's partials into zmin and zmax,
//   then the margin bin b0 = clamp(ceil((margin - zmin) / binw), 0, 128)
//   with binw = clamp(zmax - zmin, min=1e-6) / 128; then a thread a point:
//   r = hypot(x, y), theta = atan2(y, x) (+ 2 pi where not > 0), the zone
//   by r against the zone edges, ring and sector by truncated quotients,
//   the patch id (P where not in the CZM), the patch centre gathered from
//   the (2, P) table, ok = in the CZM and finite, and
//     pid = ok ? patch : P,
//     chan = ok ? [x, y, z, x - cx, y - cy] : 0,
//     zb = clamp(int(floor((z_c - margin) / binw)) + b0, 0, 127),
//     w = [ok, z_c * ok].
//   Block (0, b) writes b0[b].
//
// Every operation rounds as its torch operation does on the card: the _rn
// intrinsics (no FMA contraction), __fdiv_rn for a tensor quotient, binw as
// the product with 1/128 (exact), float to int32 by truncation with
// saturation (__float2int_rz, as torch's cast), int32 sums that wrap,
// torch.clamp keeping a NaN. Python scalars enter rounded to f32.
//
// Bound on the card: bytes. At path P's B = 64 (128 clouds of 131072
// points) the two passes read 13 + 13 bytes a point and write 36; 1.04 GB,
// 0.31 ms at 3.35 TB/s. Design: the arithmetic of the plain version's ~110
// elementwise launches in registers, one pass; the zone table in the
// kernel's parameters (up to kMaxZones zones; a larger one, which a
// Patchwork YAML may give, is read from two small device arrays by the
// same code); no atomics, so the outputs repeat bit for bit.
#include <cstdint>

#include <cuda_runtime.h>

#include "fdlibm_atan2.cuh"

namespace quatro {

constexpr int kCzmThreads = 256;
constexpr int kMaxZones = 8;
constexpr int kZBins = 128;
constexpr float kMinSpan = 0x1.0c6f7ap-20f;   // f32(1e-6)
constexpr float kInvZBins = 0x1p-7f;          // 1 / 128

struct ZoneTable {
  int nz;
  float edge[kMaxZones];      // zone k + 1 starts at r >= edge[k], k < nz - 1
  float min_rng[kMaxZones], ring_sz[kMaxZones], sect_sz[kMaxZones];
  int nrings[kMaxZones], nsect[kMaxZones], offs[kMaxZones];
};

// The zone table past kMaxZones zones: the same fields as device arrays
// (zone_f (4, nz) and zone_i (3, nz) rows of the wrapper's), read in the
// same order by the same code
struct ZoneRef {
  int nz;
  const float *edge, *min_rng, *ring_sz, *sect_sz;
  const int *nrings, *nsect, *offs;
};

struct CzmParams {
  int n, p_cnt, chunk, chunks;
  float min_r, max_r;         // f32(cfg.min_r), f32(cfg.max_r)
  float keep_z;               // f32(-1.8 * sensor_height)
  float two_pi;               // f32(2 pi)
  float margin;               // f32(margin)
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7F800000); }

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return (v != v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

__global__ void __launch_bounds__(kCzmThreads)
czm_zrange_kernel(const float* __restrict__ points, const bool* __restrict__ mask, CzmParams p,
                  float* __restrict__ zpart) {
  const int c = blockIdx.x;
  const size_t b = blockIdx.y;
  const int end = min(p.n, (c + 1) * p.chunk);
  float lo = inf_f(), hi = -inf_f();
  for (int e = c * p.chunk + threadIdx.x; e < end; e += kCzmThreads) {
    const size_t i = b * p.n + e;
    const float z = points[3 * i + 2];
    if (mask[i] && z >= p.keep_z) {
      lo = fminf(lo, z);
      hi = fmaxf(hi, z);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = fminf(lo, __shfl_down_sync(0xffffffffu, lo, s));
    hi = fmaxf(hi, __shfl_down_sync(0xffffffffu, hi, s));
  }
  __shared__ float s_lo[kCzmThreads / 32], s_hi[kCzmThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kCzmThreads / 32; ++w) {
      lo = fminf(lo, s_lo[w]);
      hi = fmaxf(hi, s_hi[w]);
    }
    zpart[(b * p.chunks + c) * 2] = lo;
    zpart[(b * p.chunks + c) * 2 + 1] = hi;
  }
}

template <class Zones>
__global__ void __launch_bounds__(kCzmThreads)
czm_points_kernel(const float* __restrict__ points, const bool* __restrict__ mask, Zones zt,
                  CzmParams p, const float* __restrict__ centers,
                  const float* __restrict__ zpart, int* __restrict__ pid_out,
                  int* __restrict__ zb_out, float* __restrict__ chan,
                  float* __restrict__ weights, int* __restrict__ b0_out) {
  using namespace fdlibm;
  __shared__ float s_binw;
  __shared__ int s_b0;
  const size_t b = blockIdx.y;
  if (threadIdx.x < 32) {
    float lo = inf_f(), hi = -inf_f();
    for (int c = threadIdx.x; c < p.chunks; c += 32) {
      lo = fminf(lo, zpart[(b * p.chunks + c) * 2]);
      hi = fmaxf(hi, zpart[(b * p.chunks + c) * 2 + 1]);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      lo = fminf(lo, __shfl_down_sync(0xffffffffu, lo, s));
      hi = fmaxf(hi, __shfl_down_sync(0xffffffffu, hi, s));
    }
    if (threadIdx.x == 0) {
      float span = fsub(hi, lo);
      span = (span != span) ? span : fmaxf(span, kMinSpan);   // clamp(min=1e-6)
      const float binw = fmul(span, kInvZBins);
      const int b0 = __float2int_rz(
          clamp_nan(ceilf(fdiv(fsub(p.margin, lo), binw)), 0.0f, (float)kZBins));
      s_binw = binw;
      s_b0 = b0;
      if (blockIdx.x == 0) b0_out[b] = b0;
    }
  }
  __syncthreads();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.n) return;
  const size_t i = b * p.n + e;
  const float x = points[3 * i], y = points[3 * i + 1], z = points[3 * i + 2];
  const bool keep = mask[i] && z >= p.keep_z;

  // czm_bin
  const float r = hypot(x, y);
  float theta = atan2(y, x);
  theta = theta > 0.0f ? theta : fadd(theta, p.two_pi);
  const bool in_czm = r > p.min_r && r <= p.max_r && keep;
  int zone = 0;
  for (int k = 0; k + 1 < zt.nz; ++k) zone += r >= zt.edge[k];
  int ring = __float2int_rz(fdiv(fsub(r, zt.min_rng[zone]), zt.ring_sz[zone]));
  ring = min(ring, zt.nrings[zone] - 1);
  int sector = __float2int_rz(fdiv(theta, zt.sect_sz[zone]));
  sector = min(sector, zt.nsect[zone] - 1);
  ring = max(ring, 0);
  const int patch = wrap_add(wrap_add(zt.offs[zone], wrap_mul(ring, zt.nsect[zone])), sector);
  const int pid0 = in_czm ? patch : p.p_cnt;

  // the channels, sanitised
  const int cidx = min(max(pid0, 0), p.p_cnt - 1);
  const float pcx = centers[cidx], pcy = centers[p.p_cnt + cidx];
  const bool ok = in_czm && isfinite(x) && isfinite(y) && isfinite(z);
  const float x_c = ok ? x : 0.0f, y_c = ok ? y : 0.0f, z_c = ok ? z : 0.0f;
  const size_t cb = b * 5 * (size_t)p.n + e;
  chan[cb] = x_c;
  chan[cb + (size_t)p.n] = y_c;
  chan[cb + 2 * (size_t)p.n] = z_c;
  chan[cb + 3 * (size_t)p.n] = ok ? fsub(x, pcx) : 0.0f;
  chan[cb + 4 * (size_t)p.n] = ok ? fsub(y, pcy) : 0.0f;
  pid_out[i] = ok ? pid0 : p.p_cnt;

  // the seed stage's z-bin and B8's weights
  const int zq = __float2int_rz(floorf(fdiv(fsub(z_c, p.margin), s_binw)));
  zb_out[i] = min(max(wrap_add(zq, s_b0), 0), kZBins - 1);
  const float okf = ok ? 1.0f : 0.0f;
  const size_t wb = b * 2 * (size_t)p.n + e;
  weights[wb] = okf;
  weights[wb + (size_t)p.n] = fmul(z_c, okf);
}

}  // namespace quatro

extern "C" int quatro_czm_points(const float* points, const bool* mask, int bsz, int n,
                                 int chunk, const float* zone_f, const int* zone_i, int nz,
                                 int p_cnt, float min_r, float max_r, float keep_z,
                                 float two_pi, float margin, const float* centers,
                                 float* zpart, int* pid, int* zb, float* chan, float* weights,
                                 int* b0, cudaStream_t stream) {
  using namespace quatro;
  if (nz < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (n + chunk - 1) / chunk;
  const CzmParams p{n, p_cnt, chunk, chunks, min_r, max_r, keep_z, two_pi, margin};
  const dim3 grid((n + kCzmThreads - 1) / kCzmThreads, bsz);
  if (nz > kMaxZones) {
    // zone_f, zone_i on the device (the wide route)
    const ZoneRef zr{nz,         zone_f,         zone_f + nz, zone_f + 2 * nz, zone_f + 3 * nz,
                     zone_i,     zone_i + nz,    zone_i + 2 * nz};
    czm_zrange_kernel<<<dim3(chunks, bsz), kCzmThreads, 0, stream>>>(points, mask, p, zpart);
    czm_points_kernel<<<grid, kCzmThreads, 0, stream>>>(points, mask, zr, p, centers, zpart, pid,
                                                        zb, chan, weights, b0);
    return (int)cudaGetLastError();
  }
  // zone_f (host, 4 x nz): zone edges (bounds[1:]), min ranges, ring and
  // sector sizes; zone_i (host, 3 x nz): ring and sector counts, offsets
  ZoneTable zt{};
  zt.nz = nz;
  for (int k = 0; k < nz; ++k) {
    zt.edge[k] = zone_f[k];
    zt.min_rng[k] = zone_f[nz + k];
    zt.ring_sz[k] = zone_f[2 * nz + k];
    zt.sect_sz[k] = zone_f[3 * nz + k];
    zt.nrings[k] = zone_i[k];
    zt.nsect[k] = zone_i[nz + k];
    zt.offs[k] = zone_i[2 * nz + k];
  }
  czm_zrange_kernel<<<dim3(chunks, bsz), kCzmThreads, 0, stream>>>(points, mask, p, zpart);
  czm_points_kernel<<<grid, kCzmThreads, 0, stream>>>(points, mask, zt, p, centers, zpart, pid,
                                                      zb, chan, weights, b0);
  return (int)cudaGetLastError();
}
