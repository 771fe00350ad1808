"""GNC rotation estimation: quasi-SO(3) (yaw only) and full SO(3).

PyTorch counterpart of ``quatro_tpu/solver/rotation.py`` (reference:
include/quatro.hpp:430-572). The weighted 2x2 orthogonal Procrustes
problem has the closed form
theta* = atan2(sum_i w_i (x_i x y_i), sum_i w_i (x_i . y_i)), so each yaw
iteration is two masked reductions and a weight update; the full SO(3)
variant (TEASER mode) solves a weighted Kabsch problem (one 3x3 SVD) per
iteration. Two robust losses: GNC-TLS (the reference's default) and the
graduated Geman-McClure of its FGR option. The loops are Python loops with
the JAX package's bound and exit test; the exit test reads one flag back
from the device per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.utils.se3 import rotate_points


class GncResult(NamedTuple):
    rotation: torch.Tensor     # (2, 2) or (3, 3)
    weights: torch.Tensor      # (N,) final TLS weights
    inlier_mask: torch.Tensor  # (N,) weights >= 0.4 (reference quatro.hpp:567-571)
    iterations: torch.Tensor   # () int32
    cost: torch.Tensor         # () f32 final cost


def yaw_procrustes(src_xy: torch.Tensor, dst_xy: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Closed-form weighted 2D rotation angle aligning R @ src -> dst
    (teaser::utils::svdRot2d, include/teaser/utils.h:151-166)."""
    dot = (weights * (src_xy * dst_xy).sum(-1)).sum()
    cross = (weights * (src_xy[:, 0] * dst_xy[:, 1]
                        - src_xy[:, 1] * dst_xy[:, 0])).sum()
    return torch.atan2(cross, dot)


def rot2d(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def svd_rot3d(src: torch.Tensor, dst: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
    """Weighted Kabsch: the proper rotation R with R @ src ~= dst
    (teaser::utils::svdRot, include/teaser/utils.h:123-149): H = X W Y^T,
    R = V U^T with the determinant fix. H is the JAX package's f32
    matrix product (TF32 is never enabled); on a 97 %-outlier fixture a
    sum in another order moved FGR's 3-D optimum by 6e-5."""
    h = (src * weights[:, None]).T @ dst
    u, _, vt = torch.linalg.svd(h)
    v = vt.T
    det = torch.linalg.det(u) * torch.linalg.det(v)
    v = torch.cat([v[:, :2], v[:, 2:] * torch.where(det < 0, -1.0, 1.0)], 1)
    return rotate_points(v, u)                           # v @ u.T


# (solve_rotation, apply_rotation) of the two rotation parametrisations
_YAW = (yaw_procrustes, lambda th, x: rotate_points(x, rot2d(th)))
_SO3 = (svd_rot3d, lambda r, x: rotate_points(x, r))


def _gnc_tls(src, dst, mask, noise_bound, gnc_factor: float,
             max_iterations: int, cost_threshold: float, solve_rotation,
             apply_rotation):
    """GNC-TLS loop in the reference's operation order
    (include/quatro.hpp:485-558): solve from the current weights ->
    residuals -> (iteration 0: mu init, early break if noise-free) ->
    cost from the old weights -> TLS weight update -> mu *= factor ->
    converge on the cost difference."""
    dtype, dev = src.dtype, src.device
    maskf = mask.to(dtype)
    nb_sq = torch.as_tensor(noise_bound, dtype=dtype, device=dev) ** 2
    nb_sq = torch.where(nb_sq < 1e-16, 1e-2, nb_sq)

    weights = maskf
    param = None
    mu = torch.ones((), dtype=dtype, device=dev)
    prev_cost = torch.tensor(float("inf"), dtype=dtype, device=dev)
    cost = prev_cost
    i = 0
    while i < max_iterations:
        param = solve_rotation(src, dst, weights * maskf)
        diff = dst - apply_rotation(param, src)
        res_sq = (diff * diff).sum(-1) * maskf
        if i == 0:                      # mu initialisation
            mu = 1.0 / (2.0 * res_sq.max() / nb_sq - 1.0)
        degenerate = i == 0 and bool(mu <= 0)
        th1 = (mu + 1.0) / mu * nb_sq
        th2 = mu / (mu + 1.0) * nb_sq
        cost = (weights * res_sq).sum()
        i += 1
        if degenerate:                  # noise-free: keep the weights
            break
        w_mid = torch.sqrt(nb_sq * mu * (mu + 1.0)
                           / torch.clamp(res_sq, min=1e-30)) - mu
        weights = torch.where(res_sq >= th1, 0.0,
                              torch.where(res_sq <= th2, 1.0, w_mid)) * maskf
        converged = bool(torch.abs(cost - prev_cost) < cost_threshold)
        mu = mu * gnc_factor
        prev_cost = cost
        if converged:
            break
    if param is None:                   # no iteration ran
        param = solve_rotation(src, dst, maskf)
    inliers = (weights >= 0.4) & mask
    return param, weights, inliers, i, cost


def _fgr_gm(src, dst, mask, noise_bound, gnc_factor: float,
            max_iterations: int, cost_threshold: float, solve_rotation,
            apply_rotation):
    """Graduated Geman-McClure, the reference's FGR option
    (include/quatro.hpp:172-175,225-243): w_i = (mu e^2 / (r_i^2 +
    mu e^2))^2, mu divided by gnc_factor per iteration (from convex toward
    GM), stopping on cost convergence once mu has annealed to <= 1."""
    dtype, dev = src.dtype, src.device
    maskf = mask.to(dtype)
    eps_sq = torch.clamp(torch.as_tensor(noise_bound, dtype=dtype,
                                         device=dev) ** 2, min=1e-16)
    weights = maskf
    param = None
    mu = torch.ones((), dtype=dtype, device=dev)
    prev_cost = torch.tensor(float("inf"), dtype=dtype, device=dev)
    i = 0
    while i < max_iterations:
        param = solve_rotation(src, dst, weights * maskf)
        diff = dst - apply_rotation(param, src)
        res_sq = (diff * diff).sum(-1) * maskf
        if i == 0:                      # convex enough for the worst residual
            mu = torch.clamp(res_sq.max() / eps_sq, min=1.0)
        w = (mu * eps_sq) / (res_sq + mu * eps_sq)
        weights = (w * w) * maskf
        cost = (weights * res_sq).sum()
        done = bool((mu <= 1.0) & (torch.abs(cost - prev_cost)
                                   < cost_threshold))
        mu = torch.clamp(mu / gnc_factor, min=1.0)
        prev_cost = cost
        i += 1
        if done:
            break
    if param is None:                   # no iteration ran
        param = solve_rotation(src, dst, maskf)
    inliers = (weights >= 0.4) & mask
    return param, weights, inliers, i, prev_cost


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
    (reference: Quatro::solveForRotation2D, include/quatro.hpp:430-572).
    algorithm: "GNC_TLS" (the reference's default) or "FGR"."""
    theta, weights, inliers, iters, cost = _loop(algorithm)(
        src_xy, dst_xy, mask, noise_bound, gnc_factor, max_iterations,
        cost_threshold, *_YAW)
    return GncResult(rot2d(theta), weights, inliers,
                     torch.tensor(iters, dtype=torch.int32,
                                  device=src_xy.device), cost)


def gnc_rotation_3d(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                    noise_bound, gnc_factor: float = 1.4,
                    max_iterations: int = 50,
                    cost_threshold: float = 0.00011,
                    algorithm: str = "GNC_TLS") -> GncResult:
    """Full SO(3) GNC (TEASER mode; the reference reserves the hook via
    reg_name == "TEASER", include/quatro.hpp:394-411)."""
    rot, weights, inliers, iters, cost = _loop(algorithm)(
        src, dst, mask, noise_bound, gnc_factor, max_iterations,
        cost_threshold, *_SO3)
    return GncResult(rot, weights, inliers,
                     torch.tensor(iters, dtype=torch.int32,
                                  device=src.device), cost)
