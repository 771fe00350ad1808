"""Single-rounding arithmetic where the JAX package's compiled code has it.

The JAX package's CPU backend fuses ``a * b + c`` inside its compiled
elementwise loops into one fused multiply-add, which rounds once. Where
such a sum decides a discrete outcome on data that sits exactly on the
decision's edge, the port rounds it once too. On the synthetic scans every
ring lies exactly on a range-image row edge, so the row of every point is
decided by that rounding (quatro_tpu/preprocessing/projection.py:73-77).

``fma`` forms the sum in f64: the product of two f32 values is exact there,
and the one f64 rounding then the f32 rounding equal a single f32 rounding
but for sums within 2**-29 of a tie. ``sqrt`` is the correctly rounded f32
square root, as the JAX package's and the CUDA kernels' are. torch's CPU
square root goes through MKL and is not: it is an ulp off on 0.6 % of
distances on an AVX-512 host, 15-17 % with SSE4.2 and none with AVX2, so
plain distances that decide an edge differed from host to host.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def f32(v: float) -> float:
    """v rounded to f32, as a Python float (exact in f64)."""
    return float(np.float32(v))


def recip(c: float) -> float:
    """1 / c with c and the quotient rounded to f32: XLA compiles a
    division by a constant into a multiplication by this reciprocal, and
    CUDA a tensor divided by a Python scalar."""
    return float(np.float32(1.0) / np.float32(c))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c (f32 tensors, or Python floats already rounded to f32)
    rounded once to f32."""
    if torch.is_tensor(b):
        b = b.double()
    if torch.is_tensor(c):
        c = c.double()
    return (a.double() * b + c).to(torch.float32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root of an f32 tensor: an estimate
    through f64, then moved to a neighbour where the exact midpoint test
    says so (a midpoint of two f32 values squares exactly in f64), so the
    result does not depend on how the library rounds."""
    xd = x.double()
    r = torch.sqrt(xd).to(torch.float32)
    for toward in (math.inf, 0.0):
        nb = torch.nextafter(r, torch.full_like(r, toward))
        mid = (r.double() + nb.double()) * 0.5
        past = mid * mid < xd if toward > 0 else mid * mid > xd
        r = torch.where(past, nb, r)
    return r


# fdlibm's single-precision arctangent (s_atanf.c, e_atan2f.c), which the
# C library's atan2f implements, and which the JAX package's compiled CPU
# arctan2 and torch's CPU atan2 on strided operands call: the constants as
# the C literals round to f32
_ATAN_HI = [f32(v) for v in (4.6364760399e-01, 7.8539812565e-01,
                             9.8279368877e-01, 1.5707962513e+00)]
_ATAN_LO = [f32(v) for v in (5.0121582440e-09, 3.7748947079e-08,
                             3.4473217170e-08, 7.5497894159e-08)]
_AT = [f32(v) for v in (3.3333334327e-01, -2.0000000298e-01,
                        1.4285714924e-01, -1.1111110449e-01,
                        9.0908870101e-02, -7.6918758452e-02,
                        6.6610731184e-02, -5.8335702866e-02,
                        4.9768779427e-02, -3.6531571299e-02,
                        1.6285819933e-02)]
_PI = f32(3.1415927410e+00)
_PI_O_2 = f32(1.5707963705e+00)
_PI_LO = f32(-8.7422776573e-08)


def _horner(w: torch.Tensor, coefs) -> torch.Tensor:
    """c0 + w * (c1 + w * (...)), each product and sum rounded once."""
    acc = torch.full_like(w, coefs[-1])
    for c in coefs[-2::-1]:
        acc = w * acc + c
    return acc


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's atanf of finite x >= 0: reduction to one of four intervals
    around atan(0.5), atan(1), atan(1.5) and atan(inf), then the odd /
    even polynomial split."""
    ix = x.view(torch.int32)
    one = torch.ones_like(x)
    reduced = [(2.0 * x - one) / (2.0 + x),      # 7/16 <= x < 11/16
               (x - one) / (x + one),            # 11/16 <= x < 19/16
               (x - 1.5) / (one + 1.5 * x),      # 19/16 <= x < 39/16
               torch.full_like(x, -1.0) / x]     # 39/16 <= x < 2**25
    ident = sum((ix >= b).to(torch.int32)
                for b in (0x3F300000, 0x3F980000, 0x401C0000))
    small = ix < 0x3EE00000                      # x < 7/16: no reduction
    t = torch.where(small, x, reduced[3])
    hi, lo = torch.zeros_like(x), torch.zeros_like(x)
    for k in range(4):
        pick = ~small & (ident == k)
        t = torch.where(pick, reduced[k], t)
        hi = torch.where(pick, _ATAN_HI[k], hi)
        lo = torch.where(pick, _ATAN_LO[k], lo)
    z = t * t
    w = z * z
    ts = t * (z * _horner(w, _AT[0::2]) + w * _horner(w, _AT[1::2]))
    out = torch.where(small, t - ts, hi - ((ts - lo) - t))
    out = torch.where(ix < 0x31000000, x, out)   # x < 2**-29
    return torch.where(ix >= 0x4C000000, f32(_ATAN_HI[3] + _ATAN_LO[3]), out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 atan2(y, x) of finite f32 tensors as the C library's atan2f
    (fdlibm) computes it, written out in torch's elementwise operations.
    Each rounds once in f32, on the CPU and on the card alike, so both
    devices give the same bits, and these are the bits of the JAX
    package's compiled arctan2 on the CPU. CUDA's own atan2f is an ulp off
    on some inputs, and so is torch's CPU atan2 on contiguous operands
    (SLEEF's vector arctangent), while on strided ones it calls atan2f."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    k = (iy - ix) >> 23                          # exponent of |y / x|
    z = _atanf(torch.abs(y / torch.where(ix == 0, torch.ones_like(x), x)))
    z = torch.where(k > 60, f32(_PI_O_2 + f32(0.5 * _PI_LO)), z)
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    zl = z - _PI_LO
    out = torch.where(hx < 0, torch.where(hy < 0, zl - _PI, _PI - zl),
                      torch.where(hy < 0, -z, z))
    # y = 0 gives y, or +-pi where x has its sign bit set; x = 0 gives
    # +-pi/2
    on_axis = torch.where(hx < 0, torch.where(hy < 0, -_PI, _PI), y)
    out = torch.where(iy == 0, on_axis, out)
    return torch.where((ix == 0) & (iy != 0),
                       torch.where(hy < 0, -_PI_O_2, _PI_O_2), out)


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of the JAX package's compiled
    CPU reduction: XLA rewrites a long reduction into windows of 32
    consecutive entries, each added from 0 one entry after the other,
    repeated until 32 or fewer partial sums are left, which are then
    added the same way. The same bits as XLA's where every level's length
    is a multiple of 32 or at most 32: up to 32, multiples of 32 up to
    1024 and multiples of 1024 (the dense front end's widths of 2048 and
    8192 among them). For other lengths XLA's split was not worked out,
    and the last window is zero-padded here."""
    while x.shape[-1] > 32:
        x = torch.nn.functional.pad(x, (0, -x.shape[-1] % 32))
        x = x.reshape(*x.shape[:-1], -1, 32)
        acc = torch.zeros_like(x[..., 0])
        for k in range(32):
            acc = acc + x[..., k]
        x = acc
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def pairwise_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in one fixed order: the axis zero-padded to a power
    of two, then its two halves added elementwise until one entry is
    left. Elementwise additions round alike on the CPU and the card,
    whatever the other axes hold, where torch's reductions choose their
    order by the shape (on the card the number of outputs sets how many
    lanes share a row), so a row of a batch sums as the row alone."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    size = 1 << max(0, (n - 1).bit_length())
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.hypot's formula, hi * sqrt(1 + (lo / hi)**2), with the inner
    multiply-add rounded once as the JAX package's compiled code does."""
    x, y = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    q = lo / torch.where(zero, torch.ones_like(hi), hi)
    out = torch.where(zero, hi, hi * sqrt(fma(q, q, 1.0)))
    return torch.where(torch.isinf(x) | torch.isinf(y), torch.inf, out)
