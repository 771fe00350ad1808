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


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp.hypot's formula, hi * sqrt(1 + (lo / hi)**2), with the inner
    multiply-add rounded once as the JAX package's compiled code does."""
    x, y = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    q = lo / torch.where(zero, torch.ones_like(hi), hi)
    out = torch.where(zero, hi, hi * sqrt(fma(q, q, 1.0)))
    return torch.where(torch.isinf(x) | torch.isinf(y), torch.inf, out)
