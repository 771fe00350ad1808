// Ten centred neighbourhood moment sums per point.
//
// Replaces quatro_tpu/ops/pallas_frontend.py::moment_sums_pallas
// (_moments_kernel): for every valid row i, over every valid column j with
// |p_i - p_j|^2 <= r^2 (self included), the sums of
//   1, dx, dy, dz, dx*dx, dx*dy, dx*dz, dy*dy, dy*dz, dz*dz,  dx = x_i - x_j.
// Masked rows get zeros.
//
// Order of the sums, which ops/frontend.py::moment_sums_plain repeats on
// the CPU bit for bit: each row adds its in-radius terms in ascending
// column order, starting from 0, every product and every addition rounded
// once (mul/add from common.cuh, never contracted into FMAs). No float
// atomics: a run repeats bit for bit.
//
// Bound on the card: operations. The input is ~100 KB per cloud, but every
// pair of valid points costs the radius test (9 f32 operations) and each
// pair within it 16 more, so the work is compute and issue, not bytes.
// Design. Only the valid points before the cloud's active limit and the
// tile pairs within the radius are touched:
// 1. a pre-pass (tiles.cuh) writes each 32-point tile's AABB of its valid
//    points and the active limit, one past the last valid point;
// 2. one warp per 32-row tile, one lane per row, four warps per block with
//    the row tiles interleaved across blocks (tile = block + grid * warp),
//    so that the ~100 live tiles of a cloud spread over the SMs. A warp
//    whose rows all lie past the limit writes zeros and stops. The others
//    test the column tiles before the limit 32 at a time against their row
//    tile's AABB (tiles_in_radius, exact: see tiles.cuh), and walk the
//    passing ones in ascending order: the warp stages a tile's 32 columns
//    in shared memory as 16-byte-aligned SoA, masked columns as NaN (which
//    fail the radius test), loads the next passing tile's columns into
//    registers, and every lane adds the in-radius columns of its row from
//    16-byte loads while they arrive. A skipped tile holds no in-radius
//    pair, so every row still adds all its terms in ascending column
//    order.
#include "tiles.cuh"

namespace quatro {

constexpr int kMomWarps = 4;   // row tiles per block
constexpr int kMoments = 10;

__device__ __forceinline__ void add_column(float acc[kMoments], float xi, float yi,
                                           float zi, float xj, float yj, float zj,
                                           float r2) {
  const float dx = sub(xi, xj), dy = sub(yi, yj), dz = sub(zi, zj);
  if (sq3(dx, dy, dz) <= r2) {
    acc[0] = add(acc[0], 1.f);
    acc[1] = add(acc[1], dx);
    acc[2] = add(acc[2], dy);
    acc[3] = add(acc[3], dz);
    acc[4] = add(acc[4], mul(dx, dx));
    acc[5] = add(acc[5], mul(dx, dy));
    acc[6] = add(acc[6], mul(dx, dz));
    acc[7] = add(acc[7], mul(dy, dy));
    acc[8] = add(acc[8], mul(dy, dz));
    acc[9] = add(acc[9], mul(dz, dz));
  }
}

__global__ void __launch_bounds__(kMomWarps * 32)
moment_sums_kernel(const float* __restrict__ pts, const float* __restrict__ maskf, int v,
                   int tiles, float r2, const float* __restrict__ bounds,
                   const int* __restrict__ lim, float* __restrict__ out) {
  __shared__ __align__(16) float sx[kMomWarps][kTile];
  __shared__ __align__(16) float sy[kMomWarps][kTile];
  __shared__ __align__(16) float sz[kMomWarps][kTile];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rt = blockIdx.x + gridDim.x * warp;
  if (rt >= tiles) return;
  const int i = rt * kTile + lane;
  const int limit = lim[b];
  const float* p = pts + (size_t)b * v * 3;
  const float* m = maskf + (size_t)b * v;
  const float* bt = bounds + (size_t)b * tiles * kBoundsCols;
  float acc[kMoments];
#pragma unroll
  for (int k = 0; k < kMoments; ++k) acc[k] = 0.f;
  if (rt * kTile < limit) {
    const bool live = i < v && m[i] > 0.f;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (live) { xi = p[3 * i]; yi = p[3 * i + 1]; zi = p[3 * i + 2]; }
    PassingTiles walk{bt + rt * kBoundsCols, bt, r2, (limit + kTile - 1) / kTile};
    // this lane's column of a tile: its point, and whether it is valid
    float cx, cy, cz, cm;
    auto fetch = [&](int t) {
      const int j = t * kTile + lane;
      const bool in = t >= 0 && j < v;
      cx = in ? p[3 * j] : 0.f;
      cy = in ? p[3 * j + 1] : 0.f;
      cz = in ? p[3 * j + 2] : 0.f;
      cm = in ? m[j] : 0.f;
    };
    int t = walk.next(lane);
    fetch(t);
    while (t >= 0) {
      const bool vj = cm > 0.f;
      __syncwarp();   // the previous tile's columns are consumed
      sx[warp][lane] = vj ? cx : CUDART_NAN_F;
      sy[warp][lane] = vj ? cy : CUDART_NAN_F;
      sz[warp][lane] = vj ? cz : CUDART_NAN_F;
      __syncwarp();
      t = walk.next(lane);
      fetch(t);   // in flight while this tile is summed
      if (live) {
#pragma unroll 2
        for (int q = 0; q < kTile; q += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(&sx[warp][q]);
          const float4 y4 = *reinterpret_cast<const float4*>(&sy[warp][q]);
          const float4 z4 = *reinterpret_cast<const float4*>(&sz[warp][q]);
          add_column(acc, xi, yi, zi, x4.x, y4.x, z4.x, r2);
          add_column(acc, xi, yi, zi, x4.y, y4.y, z4.y, r2);
          add_column(acc, xi, yi, zi, x4.z, y4.z, z4.z, r2);
          add_column(acc, xi, yi, zi, x4.w, y4.w, z4.w, r2);
        }
      }
    }
  }
  if (i < v) {
    float* o = out + ((size_t)b * v + i) * kMoments;
#pragma unroll
    for (int k = 0; k < kMoments; ++k) o[k] = acc[k];
  }
}

}  // namespace quatro

// points (B, V, 3) f32, maskf (B, V) f32 0/1, scratch bounds (B, ceil(V /
// 32), 8) f32 and lim (B,) int32 -> out (B, V, 10) f32.
extern "C" int quatro_moment_sums(const float* pts, const float* maskf, int batch, int v,
                                  float r2, float* bounds, int* lim, float* out,
                                  cudaStream_t stream) {
  const int tiles = (v + quatro::kTile - 1) / quatro::kTile;
  int rc = quatro::launch_tile_bounds(pts, maskf, batch, v, tiles, bounds, lim, stream);
  if (rc != 0) return rc;
  dim3 grid((tiles + quatro::kMomWarps - 1) / quatro::kMomWarps, batch);
  quatro::moment_sums_kernel<<<grid, quatro::kMomWarps * 32, 0, stream>>>(
      pts, maskf, v, tiles, r2, bounds, lim, out);
  return (int)cudaGetLastError();
}
