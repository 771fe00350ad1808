// fdlibm's single-precision arctangent (s_atanf.c, e_atan2f.c) and the
// hypotenuse, as quatro_tpu_torch/utils/fused.py writes them out in torch's
// elementwise operations (_atanf, atan2, hypot, fma, sqrt), for the kernels
// whose plain versions call those functions.
//
// Every operation rounds once, as the torch operation it stands for does
// on the card: products, sums and quotients through the _rn intrinsics,
// which nvcc never contracts into an FMA; fused.fma's sum in f64, rounded
// once there and once to f32; the correctly rounded square root. The
// interval picks read the same int bits with the same thresholds, and the
// constants are the f32 values of fused.py's (hex literals, so that no
// decimal rounding comes between). CUDA's own atan2f is an ulp off on some
// inputs (fused.py, ROADMAP C 12), so it is not used. Special values go
// the way of the torch chain: atan(NaN) and atan(inf) take the x >= 2**25
// branch (pi / 2), torch.maximum / minimum propagate a NaN.
#pragma once

#include <cuda_runtime.h>

namespace quatro {
namespace fdlibm {

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// fused.fma: (double) a * b + c, the sum rounded in f64, then to f32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// torch.maximum / torch.minimum: a NaN in either operand gives NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

// the f32 values of fused._ATAN_HI, _ATAN_LO, _AT, _PI, _PI_O_2, _PI_LO,
// f32(_ATAN_HI[3] + _ATAN_LO[3]) and f32(_PI_O_2 + f32(0.5 * _PI_LO))
constexpr float kAtanHi0 = 0x1.dac670p-2f, kAtanHi1 = 0x1.921fb4p-1f,
                kAtanHi2 = 0x1.f730bcp-1f, kAtanHi3 = 0x1.921fb4p+0f;
constexpr float kAtanLo0 = 0x1.586ed2p-28f, kAtanLo1 = 0x1.4442d0p-25f,
                kAtanLo2 = 0x1.281f68p-25f, kAtanLo3 = 0x1.4442d0p-24f;
constexpr float kAt0 = 0x1.555556p-2f, kAt1 = -0x1.99999ap-3f, kAt2 = 0x1.24924ap-3f,
                kAt3 = -0x1.c71c70p-4f, kAt4 = 0x1.745cdcp-4f, kAt5 = -0x1.3b0f2ap-4f,
                kAt6 = 0x1.10d66ap-4f, kAt7 = -0x1.dde2d6p-5f, kAt8 = 0x1.97b4b2p-5f,
                kAt9 = -0x1.2b4442p-5f, kAt10 = 0x1.0ad3aep-6f;
constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kPiO2 = 0x1.921fb6p+0f;
constexpr float kPiLo = -0x1.777a5cp-24f;
constexpr float kAtanHuge = 0x1.921fb6p+0f;   // f32(_ATAN_HI[3] + _ATAN_LO[3])
constexpr float kPiO2Half = 0x1.921fb6p+0f;   // f32(_PI_O_2 + f32(0.5 * _PI_LO))

// fused._atanf of x >= 0 (or NaN / inf with the sign bit clear)
__device__ __forceinline__ float atanf_pos(float x) {
  const int ix = __float_as_int(x);
  if (ix >= 0x4C000000) return kAtanHuge;      // x >= 2**25, inf, NaN
  if (ix < 0x31000000) return x;               // x < 2**-29
  const bool small = ix < 0x3EE00000;          // x < 7/16: no reduction
  float t = x, hi = 0.0f, lo = 0.0f;
  if (!small) {
    const int id = (ix >= 0x3F300000) + (ix >= 0x3F980000) + (ix >= 0x401C0000);
    if (id == 0) {              // 7/16 <= x < 11/16
      t = fdiv(fsub(fmul(2.0f, x), 1.0f), fadd(x, 2.0f));
      hi = kAtanHi0;
      lo = kAtanLo0;
    } else if (id == 1) {       // 11/16 <= x < 19/16
      t = fdiv(fsub(x, 1.0f), fadd(x, 1.0f));
      hi = kAtanHi1;
      lo = kAtanLo1;
    } else if (id == 2) {       // 19/16 <= x < 39/16
      t = fdiv(fsub(x, 1.5f), fadd(1.0f, fmul(1.5f, x)));
      hi = kAtanHi2;
      lo = kAtanLo2;
    } else {                    // 39/16 <= x < 2**25
      t = fdiv(-1.0f, x);
      hi = kAtanHi3;
      lo = kAtanLo3;
    }
  }
  const float z = fmul(t, t);
  const float w = fmul(z, z);
  // _horner(w, _AT[0::2]) and _horner(w, _AT[1::2]): acc = w * acc + c
  float s1 = kAt10;
  s1 = fadd(fmul(w, s1), kAt8);
  s1 = fadd(fmul(w, s1), kAt6);
  s1 = fadd(fmul(w, s1), kAt4);
  s1 = fadd(fmul(w, s1), kAt2);
  s1 = fadd(fmul(w, s1), kAt0);
  float s2 = kAt9;
  s2 = fadd(fmul(w, s2), kAt7);
  s2 = fadd(fmul(w, s2), kAt5);
  s2 = fadd(fmul(w, s2), kAt3);
  s2 = fadd(fmul(w, s2), kAt1);
  const float ts = fmul(t, fadd(fmul(z, s1), fmul(w, s2)));
  return small ? fsub(t, ts) : fsub(hi, fsub(fsub(ts, lo), t));
}

// fused.atan2(y, x)
__device__ __forceinline__ float atan2(float y, float x) {
  const int hx = __float_as_int(x), hy = __float_as_int(y);
  const int ix = hx & 0x7FFFFFFF, iy = hy & 0x7FFFFFFF;
  if (ix == 0 && iy != 0) return hy < 0 ? -kPiO2 : kPiO2;
  if (iy == 0) return hx < 0 ? (hy < 0 ? -kPi : kPi) : y;
  const int k = (iy - ix) >> 23;               // exponent of |y / x|
  float z;
  if (k > 60) {
    z = kPiO2Half;
  } else if (hx < 0 && k < -60) {
    z = 0.0f;
  } else {
    z = atanf_pos(fabsf(fdiv(y, x)));
  }
  if (hx < 0) {
    const float zl = fsub(z, kPiLo);
    return hy < 0 ? fsub(zl, kPi) : fsub(kPi, zl);
  }
  return hy < 0 ? -z : z;
}

// fused.hypot(x, y): hi * sqrt(fma(q, q, 1)), q = lo / hi
__device__ __forceinline__ float hypot(float x, float y) {
  const float ax = fabsf(x), ay = fabsf(y);
  if (isinf(x) || isinf(y)) return __int_as_float(0x7F800000);
  const float hi = tmax(ax, ay), lo = tmin(ax, ay);
  if (hi == 0.0f) return hi;
  const float q = fdiv(lo, hi);
  return fmul(hi, __fsqrt_rn(fma64(q, q, 1.0f)));
}

}  // namespace fdlibm
}  // namespace quatro
