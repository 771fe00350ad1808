"""GNC-TLS yaw estimation (quasi-SO(3)).

PyTorch counterpart of the yaw path of ``quatro_tpu/solver/rotation.py``
(reference: include/quatro.hpp:430-572). The weighted 2x2 orthogonal
Procrustes problem has the closed form
theta* = atan2(sum_i w_i (x_i x y_i), sum_i w_i (x_i . y_i)), so each GNC
iteration is two masked reductions and a weight update. The loop is a
Python loop with the JAX package's bound and exit test; the exit test
reads one flag back from the device per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.utils.se3 import rotate_points


class GncResult(NamedTuple):
    rotation: torch.Tensor     # (2, 2)
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


def _gnc_tls(src, dst, mask, noise_bound: float, gnc_factor: float,
             max_iterations: int, cost_threshold: float):
    """GNC-TLS loop in the reference's operation order
    (include/quatro.hpp:485-558): solve from the current weights ->
    residuals -> (iteration 0: mu init, early break if noise-free) ->
    cost from the old weights -> TLS weight update -> mu *= factor ->
    converge on the cost difference."""
    dtype, dev = src.dtype, src.device
    maskf = mask.to(dtype)
    nb_sq = torch.tensor(noise_bound, dtype=dtype, device=dev) ** 2
    nb_sq = torch.where(nb_sq < 1e-16, 1e-2, nb_sq)

    weights = maskf
    theta = yaw_procrustes(src, dst, maskf)    # returned if no iteration runs
    mu = torch.ones((), dtype=dtype, device=dev)
    prev_cost = torch.tensor(float("inf"), dtype=dtype, device=dev)
    cost = prev_cost
    i = 0
    while i < max_iterations:
        theta = yaw_procrustes(src, dst, weights * maskf)
        diff = dst - rotate_points(src, rot2d(theta))
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
    inliers = (weights >= 0.4) & mask
    return theta, weights, inliers, i, cost


def gnc_rotation_2d(src_xy: torch.Tensor, dst_xy: torch.Tensor,
                    mask: torch.Tensor, noise_bound: float,
                    gnc_factor: float = 1.4, max_iterations: int = 50,
                    cost_threshold: float = 0.00011,
                    algorithm: str = "GNC_TLS") -> GncResult:
    """Quasi-SO(3) GNC: yaw-only rotation on XY projections
    (reference: Quatro::solveForRotation2D, include/quatro.hpp:430-572)."""
    if algorithm != "GNC_TLS":
        raise NotImplementedError(
            f"rotation algorithm {algorithm!r}: only GNC_TLS is ported so far")
    theta, weights, inliers, iters, cost = _gnc_tls(
        src_xy, dst_xy, mask, noise_bound, gnc_factor, max_iterations,
        cost_threshold)
    return GncResult(rot2d(theta), weights, inliers,
                     torch.tensor(iters, dtype=torch.int32,
                                  device=src_xy.device), cost)

