"""Point-to-plane ICP refinement of a coarse pose.

PyTorch counterpart of ``quatro_tpu/solver/icp.py`` (an extension beyond
the reference, which stops at the coarse global pose, README.md:26-44):
correspondences by brute-force squared distances from a fixed strided
subsample of the source voxels to all target voxels (first minimum per
row), gated by a distance schedule and the target normals' validity;
Huber-weighted point-to-plane Gauss-Newton steps on the 6x6 normal
equations, damped; a left-multiplicative ``exp_so3`` update of the whole
transform. The iteration count is fixed, so the loop reads nothing back
from the device; ``yaw_only`` solves the constrained normal equations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.config import IcpConfig
from quatro_tpu_torch.ops.neighbors import pairwise_sq_dists
from quatro_tpu_torch.utils.se3 import exp_so3, rotate_points

_FLT_MAX = torch.finfo(torch.float32).max


class IcpResult(NamedTuple):
    rotation: torch.Tensor     # (3, 3) refined rotation
    translation: torch.Tensor  # (3,) refined translation
    rmse: torch.Tensor         # () point-to-plane RMSE over final inliers
    num_inliers: torch.Tensor  # () int32 matched correspondences, last pose
    converged: torch.Tensor    # () bool: >= min_correspondences at the end


def _subsample(points: torch.Tensor, mask: torch.Tensor, k: int):
    """Evenly strided k of the valid points, compacted to (k, 3). Strided,
    not the first k: voxel clouds are in Morton order, so a prefix would
    be a slab of the scene."""
    n = points.shape[0]
    if k >= n:
        return points, mask
    iota = torch.arange(n, device=points.device)
    order = torch.sort(torch.where(mask, iota, n + iota)).indices
    m = mask.sum()
    ik = torch.arange(k, device=points.device)
    # fewer than k valid: take them as they are
    take = torch.where(m >= k, (ik * torch.clamp(m, min=1)) // k, ik)
    sel = order[torch.clamp(take, max=n - 1)]
    return points[sel], mask[sel] & (ik < torch.clamp(m, max=k))


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


def refine_icp(src_points: torch.Tensor, src_mask: torch.Tensor,
               tgt_points: torch.Tensor, tgt_mask: torch.Tensor,
               tgt_normals: torch.Tensor, tgt_normal_valid: torch.Tensor,
               init_rotation: torch.Tensor, init_translation: torch.Tensor,
               config: IcpConfig, valid=True) -> IcpResult:
    """Polish (R, t) so that R @ src + t aligns to tgt, point-to-plane.

    src/tgt: (V, 3) voxel clouds with masks; tgt_normals (V, 3) and their
    validity from ops/normals.estimate_normals. ``valid`` (the coarse
    solution's) gates the whole refinement: where it is False the pose
    passes through unchanged.
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

    def correspond(rot, trans, gate):
        """Gated point-to-plane residuals at the current pose."""
        p = rotate_points(src_s, rot) + trans                     # (K, 3)
        d2 = torch.where(tgt_ok[None, :], pairwise_sq_dists(p, tgt_points),
                         _FLT_MAX)                                # (K, V)
        j = torch.argmin(d2, dim=1)                               # first min
        d2min = d2.gather(1, j[:, None])[:, 0]
        ok = smask_s & (d2min <= gate * gate)
        n = tgt_normals[j]
        return p, n, (n * (p - tgt_points[j])).sum(-1), ok

    rot, trans = init_rotation, init_translation
    for it in range(config.iterations):
        p, n, r, ok = correspond(rot, trans, gates[it])
        absr = torch.abs(r)
        # a tensor numerator: `float / tensor` is reciprocal-then-multiply
        huber = torch.where(absr <= config.huber_delta, 1.0,
                            torch.full_like(absr, config.huber_delta)
                            / torch.clamp(absr, min=1e-12))
        w = ok.to(dtype) * huber
        a = torch.cat([torch.linalg.cross(p, n, dim=-1), n], dim=-1)  # (K, 6)
        aw = a * w[:, None]
        h = a.T @ aw
        g = aw.T @ r
        # constrained GN for yaw_only: disabled DoF decoupled before the
        # solve (zero rows / columns / gradient, unit diagonal)
        h = h * (dof[:, None] * dof[None, :]) + torch.diag(1.0 - dof)
        g = g * dof
        lam = config.damping * (torch.trace(h) + 1.0)
        # solve_ex: no error check, so no read back from the device
        delta = -torch.linalg.solve_ex(h + lam * eye6, g)[0]
        enough = ok.sum() >= config.min_correspondences
        delta = torch.where(enough, delta, 0.0)
        # the Jacobian linearises about p = R src + t: the increment acts
        # on the whole transform
        dr = exp_so3(delta[:3])
        rot = rotate_points(dr, rot.T)                            # dr @ rot
        trans = rotate_points(trans[None], dr)[0] + delta[3:]     # dr @ t

    # metrics at the returned pose
    _, _, r_fin, ok_fin = correspond(rot, trans, gates[-1])
    n_fin = ok_fin.sum()
    rmse = torch.sqrt((ok_fin * r_fin * r_fin).sum()
                      / torch.clamp(n_fin, min=1).to(dtype))
    validb = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    return IcpResult(
        rotation=torch.where(validb, rot, init_rotation),
        translation=torch.where(validb, trans, init_translation),
        rmse=rmse,
        num_inliers=n_fin.to(torch.int32),
        converged=validb & (n_fin >= config.min_correspondences))
