"""The Quatro robust registration back end.

PyTorch counterpart of ``quatro_tpu/solver/quatro.py`` (reference:
``Quatro<S,T>::computeTransformation``, include/quatro.hpp:769-936), in the
reference's stage order:

    consistency graph -> inlier selection (max-clique replacement) ->
    chain TIMs over the clique -> GNC-TLS yaw -> rotation-inlier
    chaining -> COTE translation -> compose [R|t].
"""

from __future__ import annotations

from typing import Optional

import torch

from quatro_tpu_torch.config import SolverConfig
from quatro_tpu_torch.device import resolve_device, to_tensor
from quatro_tpu_torch.solver import clique as clique_mod
from quatro_tpu_torch.solver import rotation as rot_mod
from quatro_tpu_torch.solver import translation as trans_mod
from quatro_tpu_torch.solver.scale import tim_consistency_graph
from quatro_tpu_torch.types import RegistrationSolution
from quatro_tpu_torch.utils.se3 import rotate_points


def _consistency_inputs(src, tgt, mask, config: SolverConfig):
    """(scale, adjacency): the solver preamble."""
    if config.estimate_scaling:
        raise NotImplementedError("estimate_scaling (TLS scale) is not "
                                  "ported yet")
    scale = torch.ones((), dtype=src.dtype, device=src.device)
    adj = tim_consistency_graph(src, tgt, mask, config.noise_bound,
                                config.cbar2,
                                use_pallas=config.use_pallas_graph)
    return scale, adj


def _chain_order(inlier_mask: torch.Tensor):
    """Sorted clique indices + cyclic successor with static shapes
    (include/quatro.hpp:806,828-843): positions 0..m-1 hold the clique
    indices ascending; leaf(i) = clique[(i+1) % m]."""
    n = inlier_mask.shape[0]
    iota = torch.arange(n, device=inlier_mask.device)
    order = torch.sort(torch.where(inlier_mask, iota, n + iota),
                       stable=True).indices
    m = inlier_mask.sum()
    nxt = torch.where(iota + 1 < m, iota + 1, 0)
    return order, order[nxt], iota < m, m


def _solve_from_inliers(src, tgt, clique_mask, valid, scale,
                        config: SolverConfig, prior_ryrx, has_prior):
    """Chain TIMs -> GNC rotation -> COTE translation given a selected
    inlier set (include/quatro.hpp:817-936)."""
    dtype, dev = src.dtype, src.device
    n = src.shape[0]

    order, leaf, chain_mask, m = _chain_order(clique_mask)
    chainf = chain_mask.to(dtype)[:, None]
    src_tims = (src[leaf] - src[order]) * chainf
    dst_tims = (tgt[leaf] - tgt[order]) * chainf / scale
    if has_prior:
        # level the source with the IMU roll/pitch before the yaw solve
        src_tims = rotate_points(src_tims, prior_ryrx)

    if config.reg_name != "Quatro":
        raise NotImplementedError("reg_name='TEASER' (full SO(3)) is not "
                                  "ported yet")
    # the reference rescales the rotation noise bound by 2/scale
    # (include/quatro.hpp:846-852): rotation_noise_bound_scale
    rot_noise_bound = (config.noise_bound * config.rotation_noise_bound_scale
                       / float(scale))
    gnc = rot_mod.gnc_rotation_2d(
        src_tims[:, :2], dst_tims[:, :2], chain_mask, rot_noise_bound,
        config.rotation_gnc_factor, config.rotation_max_iterations,
        config.rotation_cost_threshold,
        algorithm=config.rotation_estimation_algorithm)
    rotation = torch.eye(3, dtype=dtype, device=dev)
    rotation[:2, :2] = gnc.rotation
    rotation = rotate_points(rotation, prior_ryrx.T)     # R @ RyRx

    # rotation-inlier chaining (include/quatro.hpp:860-874)
    iota = torch.arange(n, device=dev)
    prev = torch.where(iota == 0, torch.clamp(m - 1, min=0), iota - 1)
    rot_inliers = gnc.inlier_mask & gnc.inlier_mask[prev] & chain_mask
    num_rot_inliers = rot_inliers.sum().to(torch.int32)

    # COTE translation (include/quatro.hpp:879-911)
    if config.using_rot_inliers_when_estimating_cote:
        sel_mask = rot_inliers if bool(num_rot_inliers > 0) else chain_mask
    else:
        sel_mask = chain_mask
    pos_order = torch.sort(torch.where(sel_mask, iota, n + iota),
                           stable=True).indices
    cote_mask = iota < sel_mask.sum()
    sel_idx = order[pos_order]
    cote = trans_mod.solve_translation(
        rotate_points(scale * src[sel_idx], rotation), tgt[sel_idx],
        cote_mask, config.noise_bound * config.cote_noise_bound_coeff,
        config.cbar2, use_median=(config.cote_mode == "median"))

    final_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    final_mask[sel_idx] = cote.inlier_mask & cote_mask
    eye = torch.eye(3, dtype=dtype, device=dev)
    return RegistrationSolution(
        valid=valid,
        scale=scale,
        rotation=torch.where(valid, rotation, eye),
        translation=torch.where(valid, cote.translation,
                                torch.zeros(3, dtype=dtype, device=dev)),
        max_clique_mask=clique_mask,
        final_inlier_mask=final_mask & valid,
        num_rotation_inliers=num_rot_inliers,
        gnc_iterations=gnc.iterations,
        gnc_cost=gnc.cost,
    )


def register_correspondences(
        src, tgt, mask, config: SolverConfig = SolverConfig(),
        prior_ryrx: Optional[torch.Tensor] = None,
        device=None) -> RegistrationSolution:
    """Solve the robust registration problem on matched correspondences.

    src, tgt: (N, 3) matched keypoints (padded; numpy or tensors); mask:
    (N,) validity. prior_ryrx: optional IMU roll/pitch rotation; the
    estimated yaw is composed as Rz @ RyRx and COTE sees RyRx @ src
    (reference: include/quatro.hpp:276-279,419-426,892). device: None
    means "cuda" (RuntimeError without a card); tests pass "cpu".
    """
    dev = resolve_device(device)
    src = to_tensor(src, torch.float32, dev)
    tgt = to_tensor(tgt, torch.float32, dev)
    mask = to_tensor(mask, torch.bool, dev)
    has_prior = prior_ryrx is not None
    prior = (torch.eye(3, dtype=src.dtype, device=dev) if prior_ryrx is None
             else to_tensor(prior_ryrx, torch.float32, dev))

    scale, adj = _consistency_inputs(src, tgt, mask, config)
    clique_mask, valid = clique_mod.select_inliers(
        adj, mask, mode=config.inlier_selection_mode,
        kcore_threshold=config.kcore_heuristic_threshold,
        num_seeds=config.clique_num_seeds,
        max_size=config.max_clique_size,
        swap_rounds=config.clique_swap_rounds,
        exact_cap=config.exact_clique_cap,
        exact_max_steps=config.exact_clique_max_steps)
    return _solve_from_inliers(src, tgt, clique_mask, valid, scale, config,
                               prior, has_prior)
