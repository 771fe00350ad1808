"""GNC rotation estimation: quasi-SO(3) (yaw only) and full SO(3).

PyTorch counterpart of ``quatro_tpu/solver/rotation.py`` (reference:
include/quatro.hpp:430-572). The weighted 2x2 orthogonal Procrustes
problem has the closed form
theta* = atan2(sum_i w_i (x_i x y_i), sum_i w_i (x_i . y_i)), so each yaw
iteration is two masked reductions and a weight update; the full SO(3)
variant (TEASER mode) solves a weighted Kabsch problem per iteration
(ops/kabsch.py: the JAX package's H and LAPACK SVD, rounding by rounding,
one kernel launch on the card). Two robust losses: GNC-TLS (the
reference's default) and the graduated Geman-McClure of its FGR option.
Every function takes leading axes (pairs, hypotheses). The loops keep
the JAX package's bound and exit test per row. On the card the yaw GNC is
one kernel launch for all rows (ops/polish.gnc_yaw, each row to its own
exit); its plain version, the CPU's route, is the loop below over the yaw
parametrisation (``_YAW``), and ``gnc_rotation_2d`` chooses by device.
The loops are device loops (utils/loops.py) that read one flag back per
GNC_CHUNK iterations, whatever the number of rows, and on the card
replay CUDA graphs (the SO(3) GNC's, and the yaw's plain route).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.ops import kabsch
from quatro_tpu_torch.ops.launch import same_device
from quatro_tpu_torch.ops.polish import gnc_yaw
from quatro_tpu_torch.utils import fused, loops
from quatro_tpu_torch.utils.fused import pairwise_sum
from quatro_tpu_torch.utils.se3 import rotate_points

GNC_CHUNK = 8           # GNC iterations per flag read


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
    R = V U^T with the determinant fix; any leading axes. The JAX
    package's H and SVD rounding by rounding (ops/kabsch.py: H by fused
    multiply-adds in point order, LAPACK's sgesdd on the 3 x 3 H), one
    kernel launch for all rows on the card, nothing read back: a GNC loop
    that ends on an ill-conditioned H turns one ulp into 1e-5 of
    rotation."""
    return kabsch.kabsch_rotation(src, dst, weights)


def _rotate_fused(points: torch.Tensor, rotation: torch.Tensor):
    """points @ rotation.T as the JAX package's compiled dot computes it:
    each entry a fused multiply-add of the next product, in index order.
    The SO(3) GNC's residuals, and so its weights, keep its bits."""
    rt = rotation.transpose(-1, -2)
    out = points[..., :, 0:1] * rt[..., 0:1, :]
    for k in (1, 2):
        out = fused.fma(points[..., :, k:k + 1], rt[..., k:k + 1, :], out)
    return out


# (solve_rotation, apply_rotation) of the two rotation parametrisations
_YAW = (yaw_procrustes, lambda th, x: rotate_points(x, rot2d(th)))
_SO3 = (svd_rot3d, lambda r, x: _rotate_fused(x, r))


def _keep(live, new, old):
    """``new`` on the live rows (leading axes of ``live``), else ``old``."""
    return torch.where(live.reshape(live.shape
                                    + (1,) * (new.dim() - live.dim())),
                       new, old)


def _tls_round(src, dst, maskf, nb_sq, state, gnc_factor: float,
               cost_threshold: float, solve_rotation, apply_rotation,
               first: bool = False):
    """One GNC-TLS iteration of every row; a row that is not live keeps
    its state. ``first``: iteration 0, which initialises mu and stops the
    noise-free rows with their weights."""
    param, weights, mu, prev_cost, cost, iters, live = state
    p = solve_rotation(src, dst, weights * maskf)
    diff = dst - apply_rotation(p, src)
    res_sq = (diff * diff).sum(-1) * maskf
    if first:                           # mu initialisation
        mu = 1.0 / (2.0 * res_sq.amax(-1) / nb_sq - 1.0)
        degenerate = mu <= 0            # noise-free: keep the weights
        param = p
    else:
        degenerate = torch.zeros_like(live)
        param = _keep(live, p, param)
    th1 = (mu + 1.0) / mu * nb_sq
    th2 = mu / (mu + 1.0) * nb_sq
    c = pairwise_sum(weights * res_sq)
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
    return param, weights, mu, prev_cost, cost, iters, live


def _any_live(state):
    return state[-1].any()


def _run_iterations(name, round_fn, src, dst, maskf, scale_sq, state,
                    bound):
    """Iterations 1.. of a GNC loop as a device loop (utils/loops.py), one
    flag read per GNC_CHUNK iterations, replayed as CUDA graphs on the
    card (both parametrisations)."""
    state, _ = loops.while_chunks(
        name, round_fn, _any_live, (src, dst, maskf, scale_sq), state,
        bound, GNC_CHUNK)
    return state


def _gnc_tls(src, dst, mask, noise_bound, gnc_factor: float,
             max_iterations: int, cost_threshold: float, solve_rotation,
             apply_rotation):
    """GNC-TLS loop in the reference's operation order
    (include/quatro.hpp:485-558): solve from the current weights ->
    residuals -> (iteration 0: mu init, early break if noise-free) ->
    cost from the old weights -> TLS weight update -> mu *= factor ->
    converge on the cost difference.

    Rows (the leading axes of ``mask``) run as vmap runs the JAX
    package's ``lax.while_loop`` (quatro_tpu/solver/rotation.py:145): the
    loop goes on while a row is live, and each row keeps its state from
    the iteration its own test ended it, by ``torch.where`` on its live
    mask, so the iterations a chunk runs past a row's end change none of
    its bits. Iteration 0 runs alone; iterations 1.. are a device loop
    that reads its flag once per GNC_CHUNK iterations."""
    dtype, dev = src.dtype, src.device
    maskf = mask.to(dtype)
    nb_sq = torch.as_tensor(noise_bound, dtype=dtype, device=dev) ** 2
    nb_sq = torch.where(nb_sq < 1e-16, 1e-2, nb_sq).expand(mask.shape[:-1])
    if max_iterations <= 0:             # no iteration runs
        param = solve_rotation(src, dst, maskf)
        return (param, maskf, (maskf >= 0.4) & mask,
                torch.zeros(mask.shape[:-1], dtype=torch.int32, device=dev),
                torch.full_like(nb_sq, float("inf")))
    inf = torch.full_like(nb_sq, float("inf"))
    state = (None, maskf, torch.ones_like(nb_sq), inf, inf,
             torch.zeros(mask.shape[:-1], dtype=torch.int32, device=dev),
             torch.ones(mask.shape[:-1], dtype=torch.bool, device=dev))
    state = _tls_round(src, dst, maskf, nb_sq, state, gnc_factor,
                       cost_threshold, solve_rotation, apply_rotation,
                       first=True)

    def round_fn(consts, state):
        return _tls_round(*consts, state, gnc_factor, cost_threshold,
                          solve_rotation, apply_rotation)

    param, weights, _, _, cost, iters, _ = _run_iterations(
        "gnc_tls", round_fn, src, dst, maskf, nb_sq, state,
        max_iterations - 1)
    inliers = (weights >= 0.4) & mask
    return param, weights, inliers, iters, cost


def _gm_round(src, dst, maskf, eps_sq, state, gnc_factor: float,
              cost_threshold: float, solve_rotation, apply_rotation,
              first: bool = False):
    """One graduated Geman-McClure iteration of every row; a row that is
    not live keeps its state. ``first``: iteration 0, which sets mu
    convex enough for the worst residual."""
    param, weights, mu, prev_cost, iters, live = state
    p = solve_rotation(src, dst, weights * maskf)
    diff = dst - apply_rotation(p, src)
    res_sq = (diff * diff).sum(-1) * maskf
    if first:
        mu = torch.clamp(res_sq.amax(-1) / eps_sq, min=1.0)
    me = (mu * eps_sq)[..., None]
    w = me / (res_sq + me)
    w_new = (w * w) * maskf
    c = pairwise_sum(w_new * res_sq)
    done = (mu <= 1.0) & (torch.abs(c - prev_cost) < cost_threshold)
    param = p if first else _keep(live, p, param)
    weights = _keep(live, w_new, weights)
    # mu / gnc_factor as XLA compiles a division by a constant
    mu = torch.where(live, torch.clamp(mu * fused.recip(gnc_factor), min=1.0),
                     mu)
    prev_cost = torch.where(live, c, prev_cost)
    iters = iters + live.to(torch.int32)
    live = live & ~done
    return param, weights, mu, prev_cost, iters, live


def _fgr_gm(src, dst, mask, noise_bound, gnc_factor: float,
            max_iterations: int, cost_threshold: float, solve_rotation,
            apply_rotation):
    """Graduated Geman-McClure, the reference's FGR option
    (include/quatro.hpp:172-175,225-243): w_i = (mu e^2 / (r_i^2 +
    mu e^2))^2, mu divided by gnc_factor per iteration (from convex toward
    GM), stopping on cost convergence once mu has annealed to <= 1. Rows
    run as in ``_gnc_tls`` (quatro_tpu/solver/rotation.py:187)."""
    dtype, dev = src.dtype, src.device
    maskf = mask.to(dtype)
    eps_sq = torch.clamp(torch.as_tensor(noise_bound, dtype=dtype,
                                         device=dev) ** 2, min=1e-16
                         ).expand(mask.shape[:-1])
    iters = torch.zeros(mask.shape[:-1], dtype=torch.int32, device=dev)
    if max_iterations <= 0:             # no iteration runs
        param = solve_rotation(src, dst, maskf)
        return (param, maskf, (maskf >= 0.4) & mask, iters,
                torch.full_like(eps_sq, float("inf")))
    state = (None, maskf, torch.ones_like(eps_sq),
             torch.full_like(eps_sq, float("inf")), iters,
             torch.ones(mask.shape[:-1], dtype=torch.bool, device=dev))
    state = _gm_round(src, dst, maskf, eps_sq, state, gnc_factor,
                      cost_threshold, solve_rotation, apply_rotation,
                      first=True)

    def round_fn(consts, state):
        return _gm_round(*consts, state, gnc_factor, cost_threshold,
                         solve_rotation, apply_rotation)

    param, weights, _, prev_cost, iters, _ = _run_iterations(
        "fgr_gm", round_fn, src, dst, maskf, eps_sq, state,
        max_iterations - 1)
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
    "FGR". For CUDA tensors one launch of the GNC kernel
    (ops/polish.gnc_yaw); for others its plain version,
    ``gnc_rotation_2d_plain``."""
    tensors = [src_xy, dst_xy, mask] + ([noise_bound]
                                        if torch.is_tensor(noise_bound)
                                        else [])
    if same_device(*tensors).type == "cuda":
        return GncResult(*gnc_yaw(src_xy, dst_xy, mask, noise_bound,
                                  gnc_factor, max_iterations, cost_threshold,
                                  algorithm))
    return gnc_rotation_2d_plain(src_xy, dst_xy, mask, noise_bound,
                                 gnc_factor, max_iterations, cost_threshold,
                                 algorithm)


def gnc_rotation_2d_plain(src_xy: torch.Tensor, dst_xy: torch.Tensor,
                          mask: torch.Tensor, noise_bound,
                          gnc_factor: float = 1.4, max_iterations: int = 50,
                          cost_threshold: float = 0.00011,
                          algorithm: str = "GNC_TLS") -> GncResult:
    """``gnc_rotation_2d`` in torch operations on any device: the yaw
    kernel's plain version, ``_loop(algorithm)`` over ``_YAW`` (a
    ``while_chunks`` device loop)."""
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
