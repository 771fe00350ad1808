"""GNC rotation estimation: quasi-SO(3) (yaw only) and full SO(3).

PyTorch counterpart of ``quatro_tpu/solver/rotation.py`` (reference:
include/quatro.hpp:430-572). The weighted 2x2 orthogonal Procrustes
problem has the closed form
theta* = atan2(sum_i w_i (x_i x y_i), sum_i w_i (x_i . y_i)), so each yaw
iteration is two masked reductions and a weight update; the full SO(3)
variant (TEASER mode) solves a weighted Kabsch problem (one 3x3 SVD) per
iteration. Two robust losses: GNC-TLS (the reference's default) and the
graduated Geman-McClure of its FGR option. Every function takes leading
axes (pairs, hypotheses). The loops are Python loops with the JAX
package's bound and exit test per row; one flag is read back from the
device per iteration, whatever the number of rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.utils.fused import pairwise_sum
from quatro_tpu_torch.utils.se3 import rotate_points


class GncResult(NamedTuple):
    rotation: torch.Tensor     # (..., 2, 2) or (..., 3, 3)
    weights: torch.Tensor      # (..., N) final TLS weights
    inlier_mask: torch.Tensor  # (..., N) weights >= 0.4 (quatro.hpp:567-571)
    iterations: torch.Tensor   # (...) int32
    cost: torch.Tensor         # (...) f32 final cost


def yaw_procrustes(src_xy: torch.Tensor, dst_xy: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Closed-form weighted 2D rotation angle aligning R @ src -> dst
    (teaser::utils::svdRot2d, include/teaser/utils.h:151-166); any
    leading axes. The sums over N add in one fixed order, so a row of a
    batch gives the row's own bits (utils/fused.pairwise_sum)."""
    dot = pairwise_sum(weights * (src_xy * dst_xy).sum(-1))
    cross = pairwise_sum(weights * (src_xy[..., 0] * dst_xy[..., 1]
                                    - src_xy[..., 1] * dst_xy[..., 0]))
    return torch.atan2(cross, dot)


def rot2d(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def svd_rot3d(src: torch.Tensor, dst: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
    """Weighted Kabsch: the proper rotation R with R @ src ~= dst
    (teaser::utils::svdRot, include/teaser/utils.h:123-149): H = X W Y^T,
    R = V U^T with the determinant fix; any leading axes. H is the JAX
    package's f32 matrix product (TF32 is never enabled); on a
    97 %-outlier fixture a sum in another order moved FGR's 3-D optimum
    by 6e-5."""
    h = (src * weights[..., None]).transpose(-1, -2) @ dst
    u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    det = torch.linalg.det(u) * torch.linalg.det(v)
    v = torch.cat([v[..., :2], v[..., 2:]
                   * torch.where(det < 0, -1.0, 1.0)[..., None, None]], -1)
    return rotate_points(v, u)                           # v @ u.T


# (solve_rotation, apply_rotation) of the two rotation parametrisations
_YAW = (yaw_procrustes, lambda th, x: rotate_points(x, rot2d(th)))
_SO3 = (svd_rot3d, lambda r, x: rotate_points(x, r))


def _keep(live, new, old):
    """``new`` on the live rows (leading axes of ``live``), else ``old``."""
    return torch.where(live.reshape(live.shape
                                    + (1,) * (new.dim() - live.dim())),
                       new, old)


def _gnc_tls(src, dst, mask, noise_bound, gnc_factor: float,
             max_iterations: int, cost_threshold: float, solve_rotation,
             apply_rotation):
    """GNC-TLS loop in the reference's operation order
    (include/quatro.hpp:485-558): solve from the current weights ->
    residuals -> (iteration 0: mu init, early break if noise-free) ->
    cost from the old weights -> TLS weight update -> mu *= factor ->
    converge on the cost difference.

    Rows (the leading axes of ``mask``) run as vmap runs the JAX
    package's ``lax.while_loop``: the loop goes on while a row is live,
    and each row keeps its state from the iteration its own test ended
    it, by ``torch.where`` on its live mask; one flag is read back per
    iteration."""
    dtype, dev = src.dtype, src.device
    maskf = mask.to(dtype)
    nb_sq = torch.as_tensor(noise_bound, dtype=dtype, device=dev) ** 2
    nb_sq = torch.where(nb_sq < 1e-16, 1e-2, nb_sq).expand(mask.shape[:-1])

    weights = maskf
    param = None
    mu = torch.ones_like(nb_sq)
    prev_cost = torch.full_like(nb_sq, float("inf"))
    cost = prev_cost
    iters = torch.zeros(mask.shape[:-1], dtype=torch.int32, device=dev)
    live = torch.ones(mask.shape[:-1], dtype=torch.bool, device=dev)
    for i in range(max_iterations):
        p = solve_rotation(src, dst, weights * maskf)
        diff = dst - apply_rotation(p, src)
        res_sq = (diff * diff).sum(-1) * maskf
        if i == 0:                      # mu initialisation
            mu = 1.0 / (2.0 * res_sq.amax(-1) / nb_sq - 1.0)
            degenerate = mu <= 0        # noise-free: keep the weights
        else:
            degenerate = torch.zeros_like(live)
        th1 = (mu + 1.0) / mu * nb_sq
        th2 = mu / (mu + 1.0) * nb_sq
        c = pairwise_sum(weights * res_sq)
        param = p if param is None else _keep(live, p, param)
        cost = torch.where(live, c, cost)
        iters = iters + live.to(torch.int32)
        w_mid = torch.sqrt((nb_sq * mu * (mu + 1.0))[..., None]
                           / torch.clamp(res_sq, min=1e-30)) - mu[..., None]
        w_new = torch.where(res_sq >= th1[..., None], 0.0,
                            torch.where(res_sq <= th2[..., None], 1.0,
                                        w_mid)) * maskf
        step = live & ~degenerate
        weights = _keep(step, w_new, weights)
        converged = torch.abs(c - prev_cost) < cost_threshold
        mu = torch.where(step, mu * gnc_factor, mu)
        prev_cost = torch.where(step, c, prev_cost)
        live = step & ~converged
        if not bool(live.any()):
            break
    if param is None:                   # no iteration ran
        param = solve_rotation(src, dst, maskf)
    inliers = (weights >= 0.4) & mask
    return param, weights, inliers, iters, cost


def _fgr_gm(src, dst, mask, noise_bound, gnc_factor: float,
            max_iterations: int, cost_threshold: float, solve_rotation,
            apply_rotation):
    """Graduated Geman-McClure, the reference's FGR option
    (include/quatro.hpp:172-175,225-243): w_i = (mu e^2 / (r_i^2 +
    mu e^2))^2, mu divided by gnc_factor per iteration (from convex toward
    GM), stopping on cost convergence once mu has annealed to <= 1. Rows
    run as in ``_gnc_tls``."""
    dtype, dev = src.dtype, src.device
    maskf = mask.to(dtype)
    eps_sq = torch.clamp(torch.as_tensor(noise_bound, dtype=dtype,
                                         device=dev) ** 2, min=1e-16
                         ).expand(mask.shape[:-1])
    weights = maskf
    param = None
    mu = torch.ones_like(eps_sq)
    prev_cost = torch.full_like(eps_sq, float("inf"))
    iters = torch.zeros(mask.shape[:-1], dtype=torch.int32, device=dev)
    live = torch.ones(mask.shape[:-1], dtype=torch.bool, device=dev)
    for i in range(max_iterations):
        p = solve_rotation(src, dst, weights * maskf)
        diff = dst - apply_rotation(p, src)
        res_sq = (diff * diff).sum(-1) * maskf
        if i == 0:                      # convex enough for the worst residual
            mu = torch.clamp(res_sq.amax(-1) / eps_sq, min=1.0)
        me = (mu * eps_sq)[..., None]
        w = me / (res_sq + me)
        w_new = (w * w) * maskf
        c = pairwise_sum(w_new * res_sq)
        done = (mu <= 1.0) & (torch.abs(c - prev_cost) < cost_threshold)
        param = p if param is None else _keep(live, p, param)
        weights = _keep(live, w_new, weights)
        mu = torch.where(live, torch.clamp(mu / gnc_factor, min=1.0), mu)
        prev_cost = torch.where(live, c, prev_cost)
        iters = iters + live.to(torch.int32)
        live = live & ~done
        if not bool(live.any()):
            break
    if param is None:                   # no iteration ran
        param = solve_rotation(src, dst, maskf)
    inliers = (weights >= 0.4) & mask
    return param, weights, inliers, iters, prev_cost


def _loop(algorithm: str):
    if algorithm == "GNC_TLS":
        return _gnc_tls
    if algorithm == "FGR":
        return _fgr_gm
    raise ValueError(f"unknown rotation algorithm {algorithm!r}")


def gnc_rotation_2d(src_xy: torch.Tensor, dst_xy: torch.Tensor,
                    mask: torch.Tensor, noise_bound,
                    gnc_factor: float = 1.4, max_iterations: int = 50,
                    cost_threshold: float = 0.00011,
                    algorithm: str = "GNC_TLS") -> GncResult:
    """Quasi-SO(3) GNC: yaw-only rotation on XY projections
    (reference: Quatro::solveForRotation2D, include/quatro.hpp:430-572),
    src_xy, dst_xy (..., N, 2), mask (..., N), noise_bound a scalar or
    one per row. algorithm: "GNC_TLS" (the reference's default) or
    "FGR"."""
    theta, weights, inliers, iters, cost = _loop(algorithm)(
        src_xy, dst_xy, mask, noise_bound, gnc_factor, max_iterations,
        cost_threshold, *_YAW)
    return GncResult(rot2d(theta), weights, inliers, iters, cost)


def gnc_rotation_3d(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                    noise_bound, gnc_factor: float = 1.4,
                    max_iterations: int = 50,
                    cost_threshold: float = 0.00011,
                    algorithm: str = "GNC_TLS") -> GncResult:
    """Full SO(3) GNC (TEASER mode; the reference reserves the hook via
    reg_name == "TEASER", include/quatro.hpp:394-411), over any leading
    axes as ``gnc_rotation_2d``."""
    rot, weights, inliers, iters, cost = _loop(algorithm)(
        src, dst, mask, noise_bound, gnc_factor, max_iterations,
        cost_threshold, *_SO3)
    return GncResult(rot, weights, inliers, iters, cost)
