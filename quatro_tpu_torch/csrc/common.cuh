// Shared helpers of the front-end pair kernels.
//
// Geometry that decides a discrete outcome (radius test, histogram bin,
// neighbour order) is written with the round-to-nearest intrinsics, which
// nvcc never contracts into FMAs. The plain PyTorch versions in
// quatro_tpu_torch/ops/frontend.py do the same separate multiply and add,
// so kernel and plain version take the same decisions on the same inputs
// wherever the maths library is not involved.
#pragma once

#include <cuda_runtime.h>

namespace quatro {

constexpr int kRows = 64;     // threads per block = output rows per block
constexpr int kCols = 256;    // column points staged in shared memory

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// ((dx*dx + dy*dy) + dz*dz), as torch evaluates it.
__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
}

}  // namespace quatro
