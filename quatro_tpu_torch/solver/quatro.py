"""The Quatro robust registration back end.

PyTorch counterpart of ``quatro_tpu/solver/quatro.py`` (reference:
``Quatro<S,T>::computeTransformation``, include/quatro.hpp:769-936), in the
reference's stage order:

    consistency graph -> inlier selection (max-clique replacement) ->
    chain TIMs over the clique -> GNC-TLS yaw -> rotation-inlier
    chaining -> COTE translation -> compose [R|t].

Both entry points take an optional ``timer``: a callable given the name
of each solver stage as it ends ("graph", "cliques", then "vote" on the
multi-hypothesis path, and "polish"), for per-stage timing.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quatro_tpu_torch.config import SolverConfig
from quatro_tpu_torch.device import resolve_device, to_tensor
from quatro_tpu_torch.solver import clique as clique_mod
from quatro_tpu_torch.solver import rotation as rot_mod
from quatro_tpu_torch.solver import translation as trans_mod
from quatro_tpu_torch.solver.scale import tim_consistency_graph
from quatro_tpu_torch.types import RegistrationSolution
from quatro_tpu_torch.utils.se3 import rotate_points


def _noop(stage: str) -> None:
    pass


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


def _solver_inputs(src, tgt, mask, prior_ryrx, device):
    """The inputs as contiguous f32 / bool tensors on the device, and the
    prior (identity when none is given)."""
    dev = resolve_device(device)
    src = to_tensor(src, torch.float32, dev)
    tgt = to_tensor(tgt, torch.float32, dev)
    mask = to_tensor(mask, torch.bool, dev)
    prior = (torch.eye(3, dtype=src.dtype, device=dev) if prior_ryrx is None
             else to_tensor(prior_ryrx, torch.float32, dev))
    return src, tgt, mask, prior


def register_correspondences(
        src, tgt, mask, config: SolverConfig = SolverConfig(),
        prior_ryrx: Optional[torch.Tensor] = None, device=None,
        timer: Optional[Callable[[str], None]] = None
        ) -> RegistrationSolution:
    """Solve the robust registration problem on matched correspondences.

    src, tgt: (N, 3) matched keypoints (padded; numpy or tensors); mask:
    (N,) validity. prior_ryrx: optional IMU roll/pitch rotation; the
    estimated yaw is composed as Rz @ RyRx and COTE sees RyRx @ src
    (reference: include/quatro.hpp:276-279,419-426,892). device: None
    means "cuda" (RuntimeError without a card); tests pass "cpu".
    """
    timer = timer or _noop
    src, tgt, mask, prior = _solver_inputs(src, tgt, mask, prior_ryrx, device)
    scale, adj = _consistency_inputs(src, tgt, mask, config)
    timer("graph")
    clique_mask, valid = clique_mod.select_inliers(
        adj, mask, mode=config.inlier_selection_mode,
        kcore_threshold=config.kcore_heuristic_threshold,
        num_seeds=config.clique_num_seeds,
        max_size=config.max_clique_size,
        swap_rounds=config.clique_swap_rounds,
        exact_cap=config.exact_clique_cap,
        exact_max_steps=config.exact_clique_max_steps)
    timer("cliques")
    sol = _solve_from_inliers(src, tgt, clique_mask, valid, scale, config,
                              prior, prior_ryrx is not None)
    timer("polish")
    return sol


def register_hypotheses(
        src, tgt, mask, config: SolverConfig = SolverConfig(), k: int = 4,
        prior_ryrx: Optional[torch.Tensor] = None, device=None,
        timer: Optional[Callable[[str], None]] = None
        ) -> RegistrationSolution:
    """Multi-hypothesis solve: the K largest mutually distinct cliques of
    the consistency graph, then ``config.num_vote_hypotheses`` vote
    hypotheses (solver/vote.py), each solved on its own. Returns a
    RegistrationSolution with a leading axis of K + num_vote_hypotheses,
    clique hypotheses first; the caller arbitrates (solver/verify.py).

    Hypothesis 0 is exactly register_correspondences' selection, so more
    hypotheses only add candidates. A clique hypothesis is valid when it
    has more than one vertex, a vote hypothesis from two supporters on
    (the cyclic chain TIM is estimable from two). The JAX package vmaps
    the polish over the hypotheses; here it is a loop, and each
    hypothesis's GNC stops on its own test as under vmap.
    """
    timer = timer or _noop
    src, tgt, mask, prior = _solver_inputs(src, tgt, mask, prior_ryrx, device)
    scale, adj = _consistency_inputs(src, tgt, mask, config)
    timer("graph")
    top = max(8, k)
    if config.inlier_selection_mode == "clique":
        # one growth pass serves hypothesis 0 and the candidate set
        sel0, _, grown = clique_mod.select_inliers_with_candidates(
            adj, mask, kcore_threshold=config.kcore_heuristic_threshold,
            num_seeds=config.clique_num_seeds,
            max_size=config.max_clique_size,
            swap_rounds=config.clique_swap_rounds, top=top)
    else:
        sel0, _ = clique_mod.select_inliers(
            adj, mask, mode=config.inlier_selection_mode,
            kcore_threshold=config.kcore_heuristic_threshold,
            num_seeds=config.clique_num_seeds,
            max_size=config.max_clique_size,
            swap_rounds=config.clique_swap_rounds,
            exact_cap=config.exact_clique_cap,
            exact_max_steps=config.exact_clique_max_steps)
        grown = clique_mod.grow_greedy_cliques(
            adj, clique_mod.clique_seed_scores(adj, mask), mask,
            num_seeds=config.clique_num_seeds,
            max_size=config.max_clique_size)
        grown = clique_mod.improve_top_cliques(
            adj, grown, mask, top=top, rounds=config.clique_swap_rounds)
    cliques, sizes = clique_mod.top_distinct_cliques(
        torch.cat([sel0[None], grown]), k, force_first=True)
    valid_k = sizes > 1
    timer("cliques")

    if config.num_vote_hypotheses > 0:
        from quatro_tpu_torch.solver.vote import vote_hypotheses
        vmasks, vsizes = vote_hypotheses(
            src, tgt, mask, adj, scale, config.num_vote_hypotheses,
            bin_m=config.vote_trans_bin_scale * abs(config.noise_bound),
            num_anchors=config.vote_yaw_anchors,
            num_bins=config.vote_yaw_bins,
            num_yaw_modes=config.vote_yaw_modes)
        cliques = torch.cat([cliques, vmasks])
        valid_k = torch.cat([valid_k, vsizes >= 2])
        timer("vote")

    sols = RegistrationSolution.stack([
        _solve_from_inliers(src, tgt, sel, ok, scale, config, prior,
                            prior_ryrx is not None)
        for sel, ok in zip(cliques, valid_k)])
    timer("polish")
    return sols
