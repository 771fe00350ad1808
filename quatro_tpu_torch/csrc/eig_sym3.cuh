// The smallest eigenpair of a symmetric 3x3 matrix in closed form, as
// quatro_tpu_torch/ops/normals.py::smallest_eigenpair_sym3 evaluates it in
// torch's elementwise operations on the card: the trigonometric
// eigenvalue, then the eigenvector as the longest cross product of two rows
// of A - eig I, normalised.
//
// Every operation rounds once, as the torch operation it stands for does on
// the card: products, sums, differences and tensor quotients through the
// _rn intrinsics (which nvcc never contracts into an FMA); a tensor divided
// by a Python scalar as the product with the f32 reciprocal (torch's CUDA
// division by a CPU scalar); torch.sqrt as __fsqrt_rn, torch.rsqrt as
// rsqrtf, torch.acos and torch.cos as acosf and cosf; torch.clamp and
// torch.maximum propagating a NaN. The constants are the f32 values the
// Python scalars round to, as hex literals.
#pragma once

#include <cuda_runtime.h>

namespace quatro {
namespace eig {

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (v != v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return (v != v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.maximum: a NaN in either operand gives NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

constexpr float kThird = 0x1.555556p-2f;      // 1 / f32(3), the reciprocal of 3.0
constexpr float kSixth = 0x1.555556p-3f;      // 1 / f32(6)
constexpr float kTwoPiThird = 0x1.0c1524p+1f; // f32(2 pi / 3)
constexpr float kTiny = 0x1.4484c0p-100f;     // f32(1e-30)

struct Eigenpair {
  float v1, v2, v3;   // unit eigenvector
  float eig;          // smallest eigenvalue
};

__device__ __forceinline__ void cross(float u1, float u2, float u3, float v1, float v2, float v3,
                                      float c[3]) {
  c[0] = fsub(fmul(u2, v3), fmul(u3, v2));
  c[1] = fsub(fmul(u3, v1), fmul(u1, v3));
  c[2] = fsub(fmul(u1, v2), fmul(u2, v1));
}

__device__ __forceinline__ float nrm2(const float c[3]) {
  return fadd(fadd(fmul(c[0], c[0]), fmul(c[1], c[1])), fmul(c[2], c[2]));
}

// smallest_eigenpair_sym3(a11, a12, a13, a22, a23, a33)
__device__ __forceinline__ Eigenpair smallest_eigenpair_sym3(float a11, float a12, float a13,
                                                             float a22, float a23, float a33) {
  const float tr = fadd(fadd(a11, a22), a33);
  const float q = fmul(tr, kThird);
  const float b11 = fsub(a11, q), b22 = fsub(a22, q), b33 = fsub(a33, q);
  const float off = fadd(fadd(fmul(a12, a12), fmul(a13, a13)), fmul(a23, a23));
  const float p2 = fmul(fadd(fadd(fadd(fmul(b11, b11), fmul(b22, b22)), fmul(b33, b33)),
                            fmul(2.0f, off)),
                       kSixth);
  const float p = __fsqrt_rn(clamp_min(p2, kTiny));
  const float detb =
      fadd(fsub(fmul(b11, fsub(fmul(b22, b33), fmul(a23, a23))),
                fmul(a12, fsub(fmul(a12, b33), fmul(a23, a13)))),
           fmul(a13, fsub(fmul(a12, a23), fmul(b22, a13))));
  const float r = clamp(fdiv(detb, fmul(2.0f, fmul(fmul(p, p), p))), -1.0f, 1.0f);
  const float phi = fmul(acosf(r), kThird);
  const float eig3 = fadd(q, fmul(fmul(2.0f, p), cosf(fadd(phi, kTwoPiThird))));

  const float m11 = fsub(a11, eig3), m22 = fsub(a22, eig3), m33 = fsub(a33, eig3);
  float c01[3], c02[3], c12[3];
  cross(m11, a12, a13, a12, m22, a23, c01);
  cross(m11, a12, a13, a13, a23, m33, c02);
  cross(a12, m22, a23, a13, a23, m33, c12);
  const float n01 = nrm2(c01), n02 = nrm2(c02), n12 = nrm2(c12);
  const bool best12 = n12 >= tmax(n01, n02);
  const bool best02 = (n02 >= n01) && !best12;
  float vec[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) vec[i] = best12 ? c12[i] : (best02 ? c02[i] : c01[i]);
  const float inv = rsqrtf(clamp_min(nrm2(vec), kTiny));
  return {fmul(vec[0], inv), fmul(vec[1], inv), fmul(vec[2], inv), eig3};
}

}  // namespace eig
}  // namespace quatro
