// FPFH: inverse-squared-distance weighted sum of neighbour SPFH rows.
//
// Replaces the pair pass of quatro_tpu/ops/pallas_frontend.py::frontend_fpfh
// (_fpfh_kernel): for every valid row i,
//   out_i = sum_j SPFH_j / max(d2_ij, 1e-12)
// over valid columns j with 1e-12 < d2_ij <= r^2. Masked rows get zeros.
// The per-block x100/sum normalisation stays in PyTorch
// (ops/fpfh.py::normalize_blocks), as the TPU kernel left it to XLA.
//
// Order of the sums, which ops/frontend.py::fpfh_sums_plain repeats on the
// CPU bit for bit: each row adds its in-radius terms in ascending column
// order from 0, the weight w = 1 / max(d2, 1e-12) rounded once, then each
// product w * SPFH_j[k] and each addition rounded once (mul/add from
// common.cuh, never contracted into FMAs). No float atomics: a run repeats
// bit for bit.
//
// Bound on the card: bytes. The inputs are ~1.2 MB per cloud (points and
// SPFH rows); the radius tests of the tile pairs an exact culling keeps
// (~10 operations each) and 66 operations per in-radius pair take less.
// Design, as the moment sums' (moment_sums.cu), on the same pre-pass:
// 1. the pre-pass (tiles.cuh) writes each 32-point tile's AABB of its valid
//    points and the active limit; inside frontend_fpfh the SPFH kernel's
//    table is reused and the pre-pass is not launched again;
// 2. one warp per 32-row tile, one lane per row, four warps per block with
//    the row tiles interleaved across blocks; a warp whose rows all lie past
//    the limit writes zeros. The others walk the column tiles that pass
//    tiles_in_radius in ascending order: the warp stages a tile's 32 points
//    as SoA (masked columns as NaN, which fail the radius test), loads the
//    next passing tile's points into registers while it works, and finds
//    the columns some lane has within the radius (one vote per column;
//    most tile pairs that pass the AABB test hold few). Only then does it
//    stage the tile's 32 x 33 SPFH block, read with 16-byte loads, into
//    rows padded to 36 floats; all lanes walk the active columns in
//    lockstep, in ascending order, and read each SPFH row as nine 16-byte
//    shared-memory broadcasts. Each add is predicated on the lane's radius
//    test (a select, so an unused staged row never reaches a sum). A
//    skipped tile holds no in-radius pair, so every row still adds all its
//    terms in ascending column order.
#include <cstdint>

#include "tiles.cuh"

namespace quatro {

namespace {
constexpr int kFpfhWarps = 4;   // row tiles per block
constexpr int kDim = 33;
constexpr int kRowPad = 36;     // a staged SPFH row, padded to 16 bytes

// whether row (xi, yi, zi) takes column (xj, yj, zj): 1e-12 < d2 <= r2
__device__ __forceinline__ bool near(float xi, float yi, float zi, float xj, float yj,
                                     float zj, bool live, float r2) {
  const float d2 = sq3(sub(xi, xj), sub(yi, yj), sub(zi, zj));
  return live && d2 <= r2 && d2 > 1e-12f;
}

}  // namespace

__global__ void __launch_bounds__(kFpfhWarps * 32)
fpfh_kernel(const float* __restrict__ pts, const float* __restrict__ spfh,
            const float* __restrict__ maskf, int v, int tiles, float r2,
            const float* __restrict__ bounds, const int* __restrict__ lim,
            float* __restrict__ out) {
  __shared__ __align__(16) float sx[kFpfhWarps][kTile];
  __shared__ __align__(16) float sy[kFpfhWarps][kTile];
  __shared__ __align__(16) float sz[kFpfhWarps][kTile];
  __shared__ __align__(16) float ss[kFpfhWarps][kTile * kRowPad];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rt = blockIdx.x + gridDim.x * warp;
  if (rt >= tiles) return;
  const int i = rt * kTile + lane;
  const int limit = lim[b];
  const float* p = pts + (size_t)b * v * 3;
  const float* s = spfh + (size_t)b * v * kDim;
  const float* m = maskf + (size_t)b * v;
  const float* bt = bounds + (size_t)b * tiles * kBoundsCols;
  float* rows = ss[warp];
  float acc[kDim];
#pragma unroll
  for (int k = 0; k < kDim; ++k) acc[k] = 0.f;
  if (rt * kTile < limit) {
    const bool live = i < v && m[i] > 0.f;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (live) { xi = p[3 * i]; yi = p[3 * i + 1]; zi = p[3 * i + 2]; }
    PassingTiles walk{bt + rt * kBoundsCols, bt, r2, (limit + kTile - 1) / kTile};
    // this lane's column of a tile: its point, or NaN where it is masked
    float cx, cy, cz;
    auto fetch = [&](int t) {
      const int j = t * kTile + lane;
      const bool vj = t >= 0 && j < v && m[j] > 0.f;
      cx = vj ? p[3 * j] : CUDART_NAN_F;
      cy = vj ? p[3 * j + 1] : CUDART_NAN_F;
      cz = vj ? p[3 * j + 2] : CUDART_NAN_F;
    };
    int t = walk.next(lane);
    fetch(t);
    while (t >= 0) {
      const int j0 = t * kTile;
      __syncwarp();   // the previous tile is consumed
      sx[warp][lane] = cx;
      sy[warp][lane] = cy;
      sz[warp][lane] = cz;
      __syncwarp();
      t = walk.next(lane);
      fetch(t);   // in flight while this tile is summed
      // the columns some lane has within the radius, four tests at a time
      unsigned active = 0;
      auto column = [&](float xj, float yj, float zj, int q) {
        const bool ok = near(xi, yi, zi, xj, yj, zj, live, r2);
        return __any_sync(0xffffffffu, ok) ? 1u << q : 0u;
      };
      for (int q0 = 0; q0 < kTile; q0 += 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(&sx[warp][q0]);
        const float4 y4 = *reinterpret_cast<const float4*>(&sy[warp][q0]);
        const float4 z4 = *reinterpret_cast<const float4*>(&sz[warp][q0]);
        active |= column(x4.x, y4.x, z4.x, q0) | column(x4.y, y4.y, z4.y, q0 + 1) |
                  column(x4.z, y4.z, z4.z, q0 + 2) | column(x4.w, y4.w, z4.w, q0 + 3);
      }
      if (!active) continue;   // the next tile's points are in flight
      // the tile's SPFH rows are contiguous: n * 33 floats from row j0
      const int total = min(kTile, v - j0) * kDim;
      const float* src = s + (size_t)j0 * kDim;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int e = 4 * lane; e < total; e += 4 * 32) {
          if (e + 3 < total) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(src + e));
            rows[(e / kDim) * kRowPad + e % kDim] = q.x;
            rows[((e + 1) / kDim) * kRowPad + (e + 1) % kDim] = q.y;
            rows[((e + 2) / kDim) * kRowPad + (e + 2) % kDim] = q.z;
            rows[((e + 3) / kDim) * kRowPad + (e + 3) % kDim] = q.w;
          } else {
            for (int f = e; f < total; ++f)
              rows[(f / kDim) * kRowPad + f % kDim] = __ldg(src + f);
          }
        }
      } else {
        for (int e = lane; e < total; e += 32)
          rows[(e / kDim) * kRowPad + e % kDim] = __ldg(src + e);
      }
      __syncwarp();
      // the active columns in ascending order
      for (; active; active &= active - 1) {
        const int q = __ffs(active) - 1;
        const float d2 = sq3(sub(xi, sx[warp][q]), sub(yi, sy[warp][q]),
                             sub(zi, sz[warp][q]));
        const bool ok = live && d2 <= r2 && d2 > 1e-12f;   // as near()
        const float w = __frcp_rn(fmaxf(d2, 1e-12f));   // 1 / max(d2, 1e-12)
        const float* row = rows + q * kRowPad;
#pragma unroll
        for (int k4 = 0; k4 < 8; ++k4) {
          const float4 r = reinterpret_cast<const float4*>(row)[k4];
          acc[4 * k4] = ok ? add(acc[4 * k4], mul(w, r.x)) : acc[4 * k4];
          acc[4 * k4 + 1] = ok ? add(acc[4 * k4 + 1], mul(w, r.y)) : acc[4 * k4 + 1];
          acc[4 * k4 + 2] = ok ? add(acc[4 * k4 + 2], mul(w, r.z)) : acc[4 * k4 + 2];
          acc[4 * k4 + 3] = ok ? add(acc[4 * k4 + 3], mul(w, r.w)) : acc[4 * k4 + 3];
        }
        acc[32] = ok ? add(acc[32], mul(w, row[32])) : acc[32];
      }
    }
  }
  if (i < v) {
    float* o = out + ((size_t)b * v + i) * kDim;
#pragma unroll
    for (int k = 0; k < kDim; ++k) o[k] = acc[k];
  }
}

}  // namespace quatro

// points (B, V, 3) f32, spfh (B, V, 33) f32, pair maskf (B, V) f32 0/1,
// tile AABBs bounds (B, ceil(V / 32), 8) f32 and active limits lim (B,)
// int32 of the same points and pair mask -> out (B, V, 33) f32
// unnormalised weighted sums. build != 0: the pre-pass fills bounds and lim
// first; else they hold the SPFH kernel's.
extern "C" int quatro_fpfh(const float* pts, const float* spfh, const float* maskf,
                           int batch, int v, float r2, float* bounds, int* lim,
                           int build, float* out, cudaStream_t stream) {
  const int tiles = (v + quatro::kTile - 1) / quatro::kTile;
  if (build) {
    const int rc =
        quatro::launch_tile_bounds(pts, maskf, batch, v, tiles, bounds, lim, stream);
    if (rc != 0) return rc;
  }
  dim3 grid((tiles + quatro::kFpfhWarps - 1) / quatro::kFpfhWarps, batch);
  quatro::fpfh_kernel<<<grid, quatro::kFpfhWarps * 32, 0, stream>>>(
      pts, spfh, maskf, v, tiles, r2, bounds, lim, out);
  return (int)cudaGetLastError();
}
