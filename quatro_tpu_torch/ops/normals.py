"""Surface normals: the closed-form smallest eigenpair of 3x3 covariances.

PyTorch counterpart of ``quatro_tpu/ops/normals.py`` (the reference's
``pcl::NormalEstimation``, src/teaser_utils/fpfh.cc:57-63): per point, the
eigenvector of the smallest eigenvalue of its neighbourhood covariance,
oriented toward the viewpoint. The 3x3 problem is solved in closed form
(trigonometric eigenvalues + cross-product eigenvector), elementwise over
all points.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Normals(NamedTuple):
    normals: torch.Tensor    # (N, 3) unit normals (0 where undefined)
    curvature: torch.Tensor  # (N,) lambda_min / trace (PCL's surface variation)
    valid: torch.Tensor      # (N,) >= 3 neighbors and non-degenerate


def smallest_eigenpair_sym3(a11, a12, a13, a22, a23, a33):
    """Smallest eigenpair of symmetric 3x3 matrices given as six component
    tensors of one shape. Returns ((v1, v2, v3) unit eigenvector
    components, eigval)."""
    tr = a11 + a22 + a33
    q = tr / 3.0
    b11, b22, b33 = a11 - q, a22 - q, a33 - q
    p2 = (b11 * b11 + b22 * b22 + b33 * b33
          + 2.0 * (a12 * a12 + a13 * a13 + a23 * a23)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detb = (b11 * (b22 * b33 - a23 * a23)
            - a12 * (a12 * b33 - a23 * a13)
            + a13 * (a12 * a23 - b22 * a13))
    r = torch.clamp(detb / (2.0 * (p * p * p)), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    eig3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    # rows of M = A - eig3*I
    m11, m22, m33 = a11 - eig3, a22 - eig3, a33 - eig3

    def cross(u1, u2, u3, v1, v2, v3):
        return (u2 * v3 - u3 * v2, u3 * v1 - u1 * v3, u1 * v2 - u2 * v1)

    c01 = cross(m11, a12, a13, a12, m22, a23)
    c02 = cross(m11, a12, a13, a13, a23, m33)
    c12 = cross(a12, m22, a23, a13, a23, m33)

    def nrm2(c):
        return c[0] * c[0] + c[1] * c[1] + c[2] * c[2]

    n01, n02, n12 = nrm2(c01), nrm2(c02), nrm2(c12)
    best12 = n12 >= torch.maximum(n01, n02)
    best02 = (n02 >= n01) & ~best12
    vec = tuple(torch.where(best12, c12[i], torch.where(best02, c02[i], c01[i]))
                for i in range(3))
    inv = torch.rsqrt(torch.clamp(nrm2(vec), min=1e-30))
    return tuple(v * inv for v in vec), eig3


def normals_from_moments(points: torch.Tensor, mask: torch.Tensor,
                         mom: torch.Tensor,
                         viewpoint=(0.0, 0.0, 0.0)) -> Normals:
    """PCA normals from the ten centred moment sums of each point's radius
    neighbourhood: mom (V, >=10) = [count, s_dx, s_dy, s_dz, s_dxdx,
    s_dxdy, s_dxdz, s_dydy, s_dydz, s_dzdz] with dx = x_i - x_j. Shared by
    the dense and kernel front ends (identical math to the JAX package's
    dense_normals / normals_from_moments)."""
    c = mom[..., 0]
    cnt = torch.clamp(c, min=1.0)
    mdx, mdy, mdz = mom[..., 1] / cnt, mom[..., 2] / cnt, mom[..., 3] / cnt
    cxx = mom[..., 4] / cnt - mdx * mdx
    cxy = mom[..., 5] / cnt - mdx * mdy
    cxz = mom[..., 6] / cnt - mdx * mdz
    cyy = mom[..., 7] / cnt - mdy * mdy
    cyz = mom[..., 8] / cnt - mdy * mdz
    czz = mom[..., 9] / cnt - mdz * mdz

    (n1, n2, n3), lam_min = smallest_eigenpair_sym3(cxx, cxy, cxz, cyy, cyz,
                                                    czz)
    trace = cxx + cyy + czz
    curvature = lam_min / torch.clamp(trace, min=1e-30)

    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    flip = (n1 * (viewpoint[0] - x) + n2 * (viewpoint[1] - y)
            + n3 * (viewpoint[2] - z)) < 0
    sign = torch.where(flip, -1.0, 1.0).to(points.dtype)

    valid = (c >= 3) & mask
    ok = valid.to(points.dtype)
    normal = torch.stack([n1 * sign * ok, n2 * sign * ok, n3 * sign * ok],
                         dim=-1)
    curvature = torch.where(valid, curvature, torch.zeros_like(curvature))
    return Normals(normal, curvature, valid)
