// What the Patchwork kernels B9 (fit_iteration_moments) and B10
// (classify_points) share: the delivery of a patch's table row to a point
// and the plane projection that decides membership. The TPU kernels deliver
// the row through a one-hot MXU contraction (segment_matmul.py:277-286);
// here a point reads its row directly.
#pragma once

#include "common.cuh"

namespace quatro {

constexpr int kTabCols = 5;   // [n1, n2, n3, th, flags]

// Row `id` of a (p_pad, 5) table; zeros for ids outside [0, p_pad).
__device__ __forceinline__ void deliver_row(const float* tab, int p_pad, int id,
                                            float row[kTabCols]) {
  const bool in = id >= 0 && id < p_pad;
#pragma unroll
  for (int q = 0; q < kTabCols; ++q) row[q] = in ? tab[id * kTabCols + q] : 0.f;
}

// (n1 * x + n2 * y) + n3 * z, each product and sum rounded once, as the
// plain version (ops/segment.py::_plane_proj) evaluates it.
__device__ __forceinline__ float plane_proj(const float row[kTabCols], float x,
                                            float y, float z) {
  return add(add(mul(row[0], x), mul(row[1], y)), mul(row[2], z));
}

}  // namespace quatro
