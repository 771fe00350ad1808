"""Surface normals: the closed-form smallest eigenpair of 3x3 covariances.

PyTorch counterpart of ``quatro_tpu/ops/normals.py`` (the reference's
``pcl::NormalEstimation``, src/teaser_utils/fpfh.cc:57-63): per point, the
eigenvector of the smallest eigenvalue of its neighbourhood covariance,
oriented toward the viewpoint. The 3x3 problem is solved in closed form
(trigonometric eigenvalues + cross-product eigenvector), elementwise over
all points, from moment sums (the front end: ``moment_normals``, csrc/
moment_normals.cu on the card after B3, ``normals_from_moments`` on the
CPU and for the dense front end) or from K-capped neighbour lists
(``estimate_normals``, the ICP target's normals: csrc/
neighbor_normals.cu on the card, ``estimate_normals_plain`` on the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from quatro_tpu_torch.ops.launch import (LAUNCHES, check, launch, same_device,
                                         size_route)
from quatro_tpu_torch.utils import fused


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


def centered_covariance(mom):
    """Means and covariance of each neighbourhood from its ten
    raw moment sums ``mom`` = [count, s_x, s_y, s_z, s_xx, s_xy, s_xz,
    s_yy, s_yz, s_zz] (a sequence of ten tensors, count clamped to 1):
    ``((m_x, m_y, m_z), (c_xx, c_xy, c_xz, c_yy, c_yz, c_zz))``.
    Each entry s_ab / count - m_a m_b rounds its product and difference
    once, as XLA's CPU code fuses them in the JAX package's dense_normals
    (``fused.fma``): the same sums give the same covariance bits."""
    cnt = torch.clamp(mom[0], min=1.0)
    m = tuple(mom[k] / cnt for k in (1, 2, 3))
    cov = tuple(fused.fma(-m[a], m[b], mom[k] / cnt)
                for k, a, b in ((4, 0, 0), (5, 0, 1), (6, 0, 2), (7, 1, 1),
                                (8, 1, 2), (9, 2, 2)))
    return m, cov


def normals_from_moments(points: torch.Tensor, mask: torch.Tensor,
                         mom: torch.Tensor,
                         viewpoint=(0.0, 0.0, 0.0)) -> Normals:
    """PCA normals from the ten centred moment sums of each point's radius
    neighbourhood: mom (V, >=10) = [count, s_dx, s_dy, s_dz, s_dxdx,
    s_dxdy, s_dxdz, s_dydy, s_dydz, s_dzdz] with dx = x_i - x_j. Shared by
    the dense and kernel front ends (identical math to the JAX package's
    dense_normals / normals_from_moments)."""
    c = mom[..., 0]
    _, (cxx, cxy, cxz, cyy, cyz, czz) = centered_covariance(
        mom[..., :10].unbind(-1))

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


def moment_normals(points: torch.Tensor, mask: torch.Tensor,
                   mom: torch.Tensor,
                   viewpoint=(0.0, 0.0, 0.0)) -> Normals:
    """``normals_from_moments`` of a batch: points (B, V, 3), mask (B, V)
    bool, B3's moments (B, V, >= 10). For CUDA tensors one launch of
    csrc/moment_normals.cu (a thread a point: the covariance by
    ``fused.fma``'s route, the eigenpair of csrc/eig_sym3.cuh, the
    curvature, the viewpoint flip and the masks), bit for bit
    ``normals_from_moments``, which runs for CPU tensors."""
    if same_device(points, mask, mom).type != "cuda":
        return normals_from_moments(points, mask, mom, viewpoint)
    bsz, v = mask.shape
    check("points", points, (bsz, v, 3))
    check("mask", mask, (bsz, v), torch.bool)
    width = mom.shape[-1]
    if width < 10:
        raise ValueError(f"moment_normals: {width} moments a point, not 10")
    check("mom", mom, (bsz, v, width))
    dev = points.device
    normal = torch.empty((bsz, v, 3), dtype=torch.float32, device=dev)
    curvature = torch.empty((bsz, v), dtype=torch.float32, device=dev)
    valid = torch.empty((bsz, v), dtype=torch.bool, device=dev)
    if bsz and v:
        launch("moment_normals", points, mask, mom, bsz, v, width,
               *(fused.f32(c) for c in viewpoint), normal, curvature, valid)
        LAUNCHES["moment_normals"] += 1
    return Normals(normal, curvature, valid)


def smallest_eigenvector_3x3(a: torch.Tensor):
    """Matrix-shaped wrapper of ``smallest_eigenpair_sym3``: a (..., 3, 3)
    symmetric -> (eigenvector (..., 3), eigenvalue (...,))."""
    (v1, v2, v3), eig = smallest_eigenpair_sym3(
        a[..., 0, 0], a[..., 0, 1], a[..., 0, 2],
        a[..., 1, 1], a[..., 1, 2], a[..., 2, 2])
    return torch.stack([v1, v2, v3], dim=-1), eig


def estimate_normals_plain(points: torch.Tensor, nbrs,
                           viewpoint=(0.0, 0.0, 0.0)) -> Normals:
    """``estimate_normals`` in torch operations. Each neighbourhood's sums
    go over its K slots in ``fused.pairwise_sum``'s tree, the same for any
    batch on the CPU and the card (a torch reduction's order follows the
    shape on the card), and every other step is elementwise."""
    lead, (n, k) = points.shape[:-2], nbrs.idx.shape[-2:]
    pts = points.reshape(-1, n, 3)
    idx = nbrs.idx.reshape(-1, n * k).long()
    x, y, z = pts.unbind(-1)
    w = nbrs.valid.reshape(-1, n, k).to(points.dtype)
    cnt = torch.clamp(fused.pairwise_sum(w), min=1.0)
    xs, ys, zs = (c.gather(1, idx).reshape(-1, n, k) for c in (x, y, z))
    mx, my, mz = (fused.pairwise_sum(w * c) / cnt for c in (xs, ys, zs))

    def moment(ca, ma, cb, mb):
        return fused.pairwise_sum(
            w * (ca - ma[..., None]) * (cb - mb[..., None])) / cnt

    cxx, cxy, cxz = moment(xs, mx, xs, mx), moment(xs, mx, ys, my), \
        moment(xs, mx, zs, mz)
    cyy, cyz, czz = moment(ys, my, ys, my), moment(ys, my, zs, mz), \
        moment(zs, mz, zs, mz)
    (n1, n2, n3), lam_min = smallest_eigenpair_sym3(cxx, cxy, cxz, cyy, cyz,
                                                    czz)
    curvature = lam_min / torch.clamp(cxx + cyy + czz, min=1e-30)
    flip = (n1 * (viewpoint[0] - x) + n2 * (viewpoint[1] - y)
            + n3 * (viewpoint[2] - z)) < 0
    sign = torch.where(flip, -1.0, 1.0).to(points.dtype)
    valid = nbrs.valid.reshape(-1, n, k).sum(-1) >= 3
    ok = valid.to(points.dtype)
    normal = torch.stack([n1 * sign * ok, n2 * sign * ok, n3 * sign * ok],
                         dim=-1)
    return Normals(normal.reshape(*lead, n, 3),
                   torch.where(valid, curvature, 0.0).reshape(*lead, n),
                   valid.reshape(*lead, n))


def estimate_normals(points: torch.Tensor, nbrs,
                     viewpoint=(0.0, 0.0, 0.0)) -> Normals:
    """PCA normals over neighbour lists (ops/neighbors.radius_neighbors,
    self included): points (N, 3), or a batch of clouds (B, N, 3) with
    lists (B, N, K). The covariance is centred on the neighbourhood mean,
    as the JAX package's estimate_normals. For CUDA tensors one launch of
    csrc/neighbor_normals.cu (a warp a point, the eigenpair of
    csrc/eig_sym3.cuh; past 64 slots its wide route, counted in
    ``SIZE_ROUTES``), bit for bit ``estimate_normals_plain``,
    which runs for CPU tensors."""
    if same_device(points, nbrs.idx, nbrs.valid).type != "cuda":
        return estimate_normals_plain(points, nbrs, viewpoint)
    lead, (n, k) = points.shape[:-2], nbrs.idx.shape[-2:]
    check("points", points, (*lead, n, 3))
    check("idx", nbrs.idx, (*lead, n, k), torch.int32)
    check("valid", nbrs.valid, (*lead, n, k), torch.bool)
    dev = points.device
    normal = torch.empty((*lead, n, 3), dtype=torch.float32, device=dev)
    curvature = torch.empty((*lead, n), dtype=torch.float32, device=dev)
    valid = torch.empty((*lead, n), dtype=torch.bool, device=dev)
    bsz = points[..., 0, 0].numel()
    if bsz and n:
        launch("neighbor_normals", points, nbrs.idx, nbrs.valid, bsz, n, k,
               *(fused.f32(v) for v in viewpoint), normal, curvature, valid)
        LAUNCHES["neighbor_normals"] += 1
        size_route("neighbor_normals", k > 64)
    return Normals(normal, curvature, valid)
