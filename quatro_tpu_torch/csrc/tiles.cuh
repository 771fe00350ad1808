// Tile culling for the radius-pair kernels (B3, B4 and B5): a per-tile
// AABB table of the valid points, the cloud's active limit, and the
// predicate that skips a (row tile, column tile) pair holding no pair
// within the radius.
//
// Replaces quatro_tpu/ops/pallas_frontend.py::_tile_bounds,
// ::_bbox_in_radius and ::_active_limits. The torch mirrors are
// ops/frontend.py::tile_bounds, ::tiles_in_radius and ::active_limit.
//
// Why a skipped tile pair holds no in-radius pair. Take a valid row point i
// of row tile R and a valid column point j of column tile C with
// d2(i, j) = sq3(sub(x_i, x_j), ...) <= r2. Both points are then finite,
// and per dimension lo_R <= x_i, x_j <= hi_C, lo_C <= x_j, x_i <= hi_R
// (min and max are exact; fminf and fmaxf skip NaN). So lo_R - hi_C <=
// x_i - x_j exactly, and as rounding to nearest is monotone, sub(lo_R, hi_C)
// <= sub(x_i, x_j) = dx; likewise sub(lo_C, hi_R) <= sub(x_j, x_i) = -dx.
// Hence the gap g = max(0, sub(lo_R, hi_C), sub(lo_C, hi_R)) lies in
// [0, |dx|], mul(g, g) <= mul(dx, dx), and add, monotone in both operands,
// gives gap2 = sq3(gx, gy, gz) <= sq3(dx, dy, dz) <= r2: the pair passes.
// The gap is written with the same sub/mul/add as the distance (sq3's
// order; the intrinsics are never contracted into FMAs), which is what
// makes the comparison hold in floating point and not only in exact
// arithmetic. An empty tile has bounds [+inf, -inf] and never passes.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace quatro {

constexpr int kTile = 32;          // points per tile: one warp's rows or columns
constexpr int kBoundsCols = 8;     // [lo x, lo y, lo z, 0, hi x, hi y, hi z, 0]
constexpr int kBoundsWarps = 8;    // tiles per block of the pre-pass

// bounds (B, tiles, 8): each tile's AABB of its valid points (maskf > 0);
// lim (B,), zeroed by the caller: one past the last valid point (0 if
// none), by one atomicMax per block. Grid (ceil(tiles / 8), B), 256
// threads, one warp per tile.
__global__ void __launch_bounds__(kBoundsWarps * 32)
tile_bounds_kernel(const float* __restrict__ pts, const float* __restrict__ maskf,
                   int v, int tiles, float* __restrict__ bounds, int* __restrict__ lim) {
  __shared__ int last[kBoundsWarps];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kBoundsWarps + warp;
  const int i = t * kTile + lane;
  const bool valid = t < tiles && i < v && maskf[(size_t)b * v + i] > 0.f;
  float lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float x = valid ? pts[((size_t)b * v + i) * 3 + d] : 0.f;
    lo[d] = valid ? x : CUDART_INF_F;
    hi[d] = valid ? x : -CUDART_INF_F;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], __shfl_xor_sync(0xffffffffu, lo[d], off));
      hi[d] = fmaxf(hi[d], __shfl_xor_sync(0xffffffffu, hi[d], off));
    }
  const unsigned any = __ballot_sync(0xffffffffu, valid);
  if (lane == 0) {
    if (t < tiles) {
      float* o = bounds + ((size_t)b * tiles + t) * kBoundsCols;
      o[0] = lo[0]; o[1] = lo[1]; o[2] = lo[2]; o[3] = 0.f;
      o[4] = hi[0]; o[5] = hi[1]; o[6] = hi[2]; o[7] = 0.f;
    }
    last[warp] = any ? t * kTile + 32 - __clz(any) : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
#pragma unroll
    for (int w = 0; w < kBoundsWarps; ++w) m = max(m, last[w]);
    if (m > 0) atomicMax(lim + b, m);
  }
}

// False only when no pair of the two tiles lies within sqrt(r2): the gap
// between the AABBs, per dimension max(0, lo_r - hi_c, lo_c - hi_r),
// summed in squares in sq3's order (see the header for why that is exact).
__device__ __forceinline__ bool tiles_in_radius(const float* __restrict__ rb,
                                                const float* __restrict__ cb, float r2) {
  float g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    g[d] = fmaxf(fmaxf(sub(rb[d], cb[4 + d]), sub(cb[d], rb[4 + d])), 0.f);
  return sq3(g[0], g[1], g[2]) <= r2;
}

// The column tiles before the active limit that pass tiles_in_radius
// against one row tile, in ascending order, tested 32 at a time: every lane
// of the warp calls next() together and gets the same tile (-1 past the
// last).
struct PassingTiles {
  const float* rb;   // the row tile's AABB
  const float* bt;   // the cloud's AABB table
  float r2;
  int nct;           // column tiles before the limit
  int c0 = -32;
  unsigned pass = 0;

  __device__ __forceinline__ int next(int lane) {
    while (!pass) {
      c0 += 32;
      if (c0 >= nct) return -1;
      const int ct = c0 + lane;
      pass = __ballot_sync(0xffffffffu,
                           ct < nct && tiles_in_radius(rb, bt + ct * kBoundsCols, r2));
    }
    const int t = c0 + __ffs(pass) - 1;
    pass &= pass - 1;
    return t;
  }
};

// The pre-pass of a radius-pair kernel: zero lim, then fill bounds and lim.
inline int launch_tile_bounds(const float* pts, const float* maskf, int batch, int v,
                              int tiles, float* bounds, int* lim, cudaStream_t stream) {
  int rc = (int)cudaMemsetAsync(lim, 0, batch * sizeof(int), stream);
  if (rc != 0) return rc;
  dim3 grid((tiles + kBoundsWarps - 1) / kBoundsWarps, batch);
  tile_bounds_kernel<<<grid, kBoundsWarps * 32, 0, stream>>>(pts, maskf, v, tiles,
                                                             bounds, lim);
  return (int)cudaGetLastError();
}

}  // namespace quatro
