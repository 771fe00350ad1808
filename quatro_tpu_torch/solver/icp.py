"""Point-to-plane ICP refinement of a coarse pose.

PyTorch counterpart of ``quatro_tpu/solver/icp.py`` (an extension beyond
the reference, which stops at the coarse global pose, README.md:26-44):
correspondences by brute-force squared distances from a fixed strided
subsample of the source voxels to all target voxels (first minimum per
row), gated by a distance schedule and the target normals' validity;
Huber-weighted point-to-plane Gauss-Newton steps on the 6x6 normal
equations, damped; a left-multiplicative ``exp_so3`` update of the whole
transform. The iteration count is fixed: the passes are a ``fori`` device
loop (utils/loops.py, the JAX package's ``lax.scan``; one CUDA graph on
the card) that reads nothing back, and a batch of pairs runs as one;
``yaw_only`` solves the constrained normal equations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.config import IcpConfig
from quatro_tpu_torch.ops.neighbors import pairwise_sq_dists
from quatro_tpu_torch.utils import loops
from quatro_tpu_torch.utils.batch import gather_rows
from quatro_tpu_torch.utils.fused import pairwise_sum
from quatro_tpu_torch.utils.se3 import exp_so3, rotate_points

_FLT_MAX = torch.finfo(torch.float32).max


class IcpResult(NamedTuple):
    # shapes of one pair; a batch of pairs adds a leading B
    rotation: torch.Tensor     # (3, 3) refined rotation
    translation: torch.Tensor  # (3,) refined translation
    rmse: torch.Tensor         # () point-to-plane RMSE over final inliers
    num_inliers: torch.Tensor  # () int32 matched correspondences, last pose
    converged: torch.Tensor    # () bool: >= min_correspondences at the end


def _subsample(points: torch.Tensor, mask: torch.Tensor, k: int):
    """Evenly strided k of the valid points of each cloud (..., N, 3),
    compacted to (..., k, 3). Strided, not the first k: voxel clouds are
    in Morton order, so a prefix would be a slab of the scene."""
    n = points.shape[-2]
    if k >= n:
        return points, mask
    iota = torch.arange(n, device=points.device)
    order = torch.sort(torch.where(mask, iota, n + iota), dim=-1).indices
    m = mask.sum(-1, keepdim=True)
    ik = torch.arange(k, device=points.device)
    # fewer than k valid: take them as they are
    take = torch.where(m >= k, (ik * torch.clamp(m, min=1)) // k, ik)
    sel = order.gather(-1, torch.clamp(take, max=n - 1))
    return (gather_rows(points, sel),
            mask.gather(-1, sel) & (ik < torch.clamp(m, max=k)))


def _solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with a @ x = b for (..., n, n) symmetric positive definite a (the
    damped normal equations) and (..., n) b: Gauss-Jordan elimination
    without pivoting, in elementwise operations, so every system of a
    batch is solved in the same operations whatever the batch (torch's
    batched solvers pick their algorithm by the batch size on the card).
    Nothing is read back from the device."""
    n = a.shape[-1]
    m = torch.cat([a, b[..., None]], -1)                   # (..., n, n + 1)
    rows = torch.arange(n, device=a.device)[:, None]
    for j in range(n):
        pivot = m[..., j:j + 1, :] / m[..., j:j + 1, j:j + 1]
        m = torch.where(rows == j, pivot, m - m[..., :, j:j + 1] * pivot)
    return m[..., n]


def _gates(config: IcpConfig) -> list:
    """The correspondence-distance schedule: hold the wide gate for basin
    capture, then anneal geometrically to the final gate."""
    d0 = max(config.max_correspondence_distance,
             config.final_correspondence_distance)
    d1 = config.final_correspondence_distance
    hold = min(config.hold_iterations, config.iterations)
    n_anneal = config.iterations - hold
    return [d0] * hold + [d0 * (d1 / d0) ** ((i + 1) / max(n_anneal, 1))
                          for i in range(n_anneal)]


def _correspond(clouds, rot, trans, gate):
    """Gated point-to-plane residuals at the current pose: (p, n, r, ok)
    of the subsampled source (..., K)."""
    src_s, smask_s, tgt_points, tgt_ok, tgt_normals = clouds
    p = rotate_points(src_s, rot) + trans[..., None, :]            # (K, 3)
    d2 = torch.where(tgt_ok[..., None, :],
                     pairwise_sq_dists(p, tgt_points), _FLT_MAX)   # (K, V)
    j = torch.argmin(d2, dim=-1)                                   # first min
    d2min = d2.gather(-1, j[..., None])[..., 0]
    ok = smask_s & (d2min <= gate * gate)
    n = gather_rows(tgt_normals, j)
    return p, n, (n * (p - gather_rows(tgt_points, j))).sum(-1), ok


def _pass(consts, state, cfg):
    """One Gauss-Newton pass of ``refine_icp``'s device loop: the state
    (rot, trans, step) after the pass; its gate is read on the device at
    ``step`` (a captured chunk replays for every later chunk, so no
    position may come from the host)."""
    *clouds, gates, dof, eye6 = consts
    rot, trans, step = state
    huber_delta, damping, min_corr = cfg
    dtype = rot.dtype
    p, n, r, ok = _correspond(clouds, rot, trans, gates.gather(0, step))
    absr = torch.abs(r)
    # a tensor numerator: `float / tensor` is reciprocal-then-multiply
    huber = torch.where(absr <= huber_delta, 1.0,
                        torch.full_like(absr, huber_delta)
                        / torch.clamp(absr, min=1e-12))
    w = ok.to(dtype) * huber
    a = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=-1)   # (K, 6)
    aw = a * w[..., None]
    # the normal equations' sums over K in one fixed order, so a pair of
    # a batch gets its own bits (a matrix product's order follows the
    # batch on the card)
    h = pairwise_sum(a[..., :, :, None] * aw[..., :, None, :], -3)
    g = pairwise_sum(aw * r[..., None], -2)
    # constrained GN for yaw_only: disabled DoF decoupled before the
    # solve (zero rows / columns / gradient, unit diagonal)
    h = h * (dof[:, None] * dof[None, :]) + torch.diag(1.0 - dof)
    g = g * dof
    lam = damping * (pairwise_sum(h.diagonal(dim1=-2, dim2=-1)) + 1.0)
    delta = -_solve_spd(h + lam[..., None, None] * eye6, g)
    enough = ok.sum(-1) >= min_corr
    delta = torch.where(enough[..., None], delta, 0.0)
    # the Jacobian linearises about p = R src + t: the increment acts on
    # the whole transform
    dr = exp_so3(delta[..., :3])
    rot = rotate_points(dr, rot.transpose(-1, -2))                # dr @ rot
    trans = (rotate_points(trans[..., None, :], dr)[..., 0, :]
             + delta[..., 3:])                                     # dr @ t
    return rot, trans, step + 1


def refine_icp(src_points: torch.Tensor, src_mask: torch.Tensor,
               tgt_points: torch.Tensor, tgt_mask: torch.Tensor,
               tgt_normals: torch.Tensor, tgt_normal_valid: torch.Tensor,
               init_rotation: torch.Tensor, init_translation: torch.Tensor,
               config: IcpConfig, valid=True) -> IcpResult:
    """Polish (R, t) so that R @ src + t aligns to tgt, point-to-plane.

    src/tgt: (V, 3) voxel clouds with masks; tgt_normals (V, 3) and their
    validity from ops/normals.estimate_normals; or a batch of B pairs with
    a leading B on every argument (and on the result's fields), solved
    together. ``valid`` (the coarse solution's) gates the whole
    refinement: where it is False the pose passes through unchanged.
    """
    dtype, dev = src_points.dtype, src_points.device
    src_s, smask_s = _subsample(src_points, src_mask,
                                config.max_source_points)
    # the schedule is computed on the host and rounded to f32 once
    gates = torch.tensor(_gates(config), dtype=dtype).to(dev)
    tgt_ok = tgt_mask & tgt_normal_valid
    dof = torch.ones(6, dtype=dtype, device=dev)   # [wx, wy, wz, tx, ty, tz]
    if config.yaw_only:
        dof[:2] = 0.0
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    clouds = (src_s, smask_s, tgt_points, tgt_ok, tgt_normals)
    cfg = (config.huber_delta, config.damping, config.min_correspondences)

    def body(consts, state):
        return _pass(consts, state, cfg)

    rot, trans, _ = loops.fori(
        "icp", body, (*clouds, gates, dof, eye6),
        (init_rotation, init_translation,
         torch.zeros(1, dtype=torch.int64, device=dev)),
        config.iterations, config.iterations)

    # metrics at the returned pose
    _, _, r_fin, ok_fin = _correspond(clouds, rot, trans, gates[-1])
    n_fin = ok_fin.sum(-1)
    rmse = torch.sqrt(pairwise_sum(ok_fin * r_fin * r_fin)
                      / torch.clamp(n_fin, min=1).to(dtype))
    validb = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    return IcpResult(
        rotation=torch.where(validb[..., None, None], rot, init_rotation),
        translation=torch.where(validb[..., None], trans, init_translation),
        rmse=rmse,
        num_inliers=n_fin.to(torch.int32),
        converged=validb & (n_fin >= config.min_correspondences))
