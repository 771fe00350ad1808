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
``yaw_only`` solves the constrained normal equations. On the card a pass is
two kernel launches (ops/icp.py: the correspondences, then the update);
the final correspondences at the returned pose are one more.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from quatro_tpu_torch.config import IcpConfig
from quatro_tpu_torch.ops.icp import icp_correspond, icp_update
from quatro_tpu_torch.utils import loops
from quatro_tpu_torch.utils.batch import drop_axis, gather_rows
from quatro_tpu_torch.utils.fused import pairwise_sum


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


def _pass(consts, state, cfg):
    """One Gauss-Newton pass of ``refine_icp``'s device loop: the state
    (rot, trans, step) after the pass; its gate is read on the device at
    ``step`` (a captured chunk replays for every later chunk, so no
    position may come from the host)."""
    *clouds, gates, dof = consts
    rot, trans, step = state
    huber_delta, damping, min_corr = cfg
    rows, ok = icp_correspond(*clouds[:2], rot, trans, *clouds[2:], gates,
                              step, huber_delta)
    return icp_update(rows, ok, rot, trans, step, dof, damping, min_corr)


def refine_icp(src_points: torch.Tensor, src_mask: torch.Tensor,
               tgt_points: torch.Tensor, tgt_mask: torch.Tensor,
               tgt_normals: torch.Tensor, tgt_normal_valid: torch.Tensor,
               init_rotation: torch.Tensor, init_translation: torch.Tensor,
               config: IcpConfig, valid=True,
               timer: Optional[Callable[[str], None]] = None) -> IcpResult:
    """Polish (R, t) so that R @ src + t aligns to tgt, point-to-plane.

    src/tgt: (V, 3) voxel clouds with masks; tgt_normals (V, 3) and their
    validity from ops/normals.estimate_normals; or a batch of B pairs with
    a leading B on every argument (and on the result's fields), solved
    together. ``valid`` (the coarse solution's) gates the whole
    refinement: where it is False the pose passes through unchanged.
    ``timer`` marks "icp passes" after the loop and "icp final" after the
    metrics.
    """
    dtype, dev = src_points.dtype, src_points.device
    validb = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    if src_points.dim() == 2:
        return drop_axis(refine_icp(
            *(t[None] for t in (src_points, src_mask, tgt_points, tgt_mask,
                                tgt_normals, tgt_normal_valid, init_rotation,
                                init_translation)), config, validb[None],
            timer))
    src_s, smask_s = _subsample(src_points, src_mask,
                                config.max_source_points)
    # the schedule is computed on the host and rounded to f32 once
    gates = torch.tensor(_gates(config), dtype=dtype).to(dev)
    tgt_ok = tgt_mask & tgt_normal_valid
    dof = torch.ones(6, dtype=dtype, device=dev)   # [wx, wy, wz, tx, ty, tz]
    if config.yaw_only:
        dof[:2] = 0.0
    clouds = tuple(t.contiguous() for t in (src_s, smask_s, tgt_points,
                                            tgt_ok, tgt_normals))
    cfg = (config.huber_delta, config.damping, config.min_correspondences)

    def body(consts, state):
        return _pass(consts, state, cfg)

    rot, trans, _ = loops.fori(
        "icp", body, (*clouds, gates, dof),
        (init_rotation.contiguous(), init_translation.contiguous(),
         torch.zeros(1, dtype=torch.int64, device=dev)),
        config.iterations, config.iterations)
    if timer:
        timer("icp passes")

    # metrics at the returned pose
    last = torch.full((1,), len(gates) - 1, dtype=torch.int64, device=dev)
    rows, ok_fin = icp_correspond(*clouds[:2], rot, trans, *clouds[2:],
                                  gates, last, config.huber_delta)
    r_fin = rows[..., 7]
    n_fin = ok_fin.sum(-1)
    rmse = torch.sqrt(pairwise_sum(ok_fin * r_fin * r_fin)
                      / torch.clamp(n_fin, min=1).to(dtype))
    out = IcpResult(
        rotation=torch.where(validb[..., None, None], rot, init_rotation),
        translation=torch.where(validb[..., None], trans, init_translation),
        rmse=rmse,
        num_inliers=n_fin.to(torch.int32),
        converged=validb & (n_fin >= config.min_correspondences))
    if timer:
        timer("icp final")
    return out
