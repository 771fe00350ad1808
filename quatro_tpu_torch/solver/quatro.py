"""The Quatro robust registration back end.

PyTorch counterpart of ``quatro_tpu/solver/quatro.py`` (reference:
``Quatro<S,T>::computeTransformation``, include/quatro.hpp:769-936), in the
reference's stage order:

    consistency graph (or the TLS scale's adjacency) -> inlier selection
    (max-clique replacement) -> chain TIMs over the clique -> GNC rotation
    (yaw, or full SO(3) in TEASER mode) -> rotation-inlier chaining ->
    COTE translation -> compose [R|t].

Every entry point takes one pair (N, 3) or a batch of B pairs (B, N, 3),
solved together: each loop of the solver reads one flag back per round
for the whole batch. Each takes an optional ``timer``: a callable given
the name of each solver stage as it ends ("graph", "cliques", then "vote" on the
multi-hypothesis path, and "polish"), for per-stage timing.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from quatro_tpu_torch.config import SolverConfig
from quatro_tpu_torch.device import resolve_device, to_tensor
from quatro_tpu_torch.ops.polish import polish_chain, polish_cote
from quatro_tpu_torch.solver import clique as clique_mod
from quatro_tpu_torch.solver import rotation as rot_mod
from quatro_tpu_torch.solver.scale import (solve_scale_tls,
                                           tim_consistency_graph)
from quatro_tpu_torch.types import RegistrationSolution
from quatro_tpu_torch.utils.batch import drop_axis


def _noop(stage: str) -> None:
    pass


def _consistency_inputs(src, tgt, mask, config: SolverConfig):
    """(scale (B,), adjacency (B, N, N)): the solver preamble. With
    ``estimate_scaling`` the TLS scale and its own pair-inlier adjacency
    (the reference's flag is inert; see solve_scale_tls), else scale 1
    and the consistency graph (one B1 launch for the batch)."""
    if config.estimate_scaling:
        return solve_scale_tls(src, tgt, mask, config.noise_bound,
                               config.cbar2)
    scale = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
    adj = tim_consistency_graph(src, tgt, mask, config.noise_bound,
                                config.cbar2,
                                use_pallas=config.use_pallas_graph)
    return scale, adj


def _solve_from_inliers(src, tgt, clique_mask, valid, scale,
                        config: SolverConfig, prior_ryrx, has_prior):
    """Chain TIMs -> GNC rotation -> COTE translation given selected
    inlier sets (include/quatro.hpp:817-936): src, tgt (B, N, 3), one
    selection per row of clique_mask (B, ..., N) (hypotheses of a pair
    share its points), valid and scale of the rows' shape, prior_ryrx
    (3, 3) or one per pair (B, 3, 3). Every row is solved on its own: on
    the card three kernels for all rows (ops/polish.py: ``polish_chain``,
    ``gnc_yaw`` or the SO(3) GNC, ``polish_cote``)."""
    rows = clique_mask.shape[:-1]
    b = src.shape[0]

    def pair_rows(x):                     # rows (B, ...) -> (B, H, ...)
        return x.reshape(b, -1, *x.shape[len(rows):])

    def row_shape(x):                     # (B, H, ...) -> rows
        return x.reshape(*rows, *x.shape[2:])

    scale_h = pair_rows(scale).contiguous()
    prior = prior_ryrx.contiguous()
    order, _, chain_mask, m, src_tims, dst_tims = polish_chain(
        src, tgt, pair_rows(clique_mask).contiguous(), scale_h, prior,
        has_prior)
    chain_mask, src_tims, dst_tims = (row_shape(x) for x in
                                      (chain_mask, src_tims, dst_tims))

    # the reference rescales the rotation noise bound by 2/scale
    # (include/quatro.hpp:846-852): rotation_noise_bound_scale; one f32
    # division on the device, as the JAX package's
    rot_noise_bound = torch.full_like(
        scale, config.noise_bound * config.rotation_noise_bound_scale) / scale
    gnc_args = (rot_noise_bound, config.rotation_gnc_factor,
                config.rotation_max_iterations,
                config.rotation_cost_threshold)
    if config.reg_name == "Quatro":
        gnc = rot_mod.gnc_rotation_2d(
            src_tims[..., :2], dst_tims[..., :2], chain_mask, *gnc_args,
            algorithm=config.rotation_estimation_algorithm)
    else:                                 # full SO(3) (TEASER mode)
        gnc = rot_mod.gnc_rotation_3d(
            src_tims, dst_tims, chain_mask, *gnc_args,
            algorithm=config.rotation_estimation_algorithm)

    # R RyRx, rotation-inlier chaining, COTE (include/quatro.hpp:860-911)
    rotation, translation, final_mask, num_rot_inliers = polish_cote(
        src, tgt, scale_h, pair_rows(gnc.rotation).contiguous(), prior,
        pair_rows(gnc.inlier_mask).contiguous(), order, m,
        pair_rows(valid).contiguous(),
        config.noise_bound * config.cote_noise_bound_coeff, config.cbar2,
        config.cote_mode == "median",
        config.using_rot_inliers_when_estimating_cote)
    return RegistrationSolution(
        valid=valid,
        scale=scale,
        rotation=row_shape(rotation),
        translation=row_shape(translation),
        max_clique_mask=clique_mask,
        final_inlier_mask=row_shape(final_mask),
        num_rotation_inliers=row_shape(num_rot_inliers),
        gnc_iterations=gnc.iterations,
        gnc_cost=gnc.cost,
    )


def _solver_inputs(src, tgt, mask, prior_ryrx, device):
    """The inputs as contiguous f32 / bool tensors on the device with a
    pair axis (added for one pair: the flag says so), and the prior
    (identity when none is given)."""
    dev = resolve_device(device)
    src = to_tensor(src, torch.float32, dev)
    tgt = to_tensor(tgt, torch.float32, dev)
    mask = to_tensor(mask, torch.bool, dev)
    one = src.dim() == 2
    if one:
        src, tgt, mask = src[None], tgt[None], mask[None]
    prior = (torch.eye(3, dtype=src.dtype, device=dev) if prior_ryrx is None
             else to_tensor(prior_ryrx, torch.float32, dev))
    return src.contiguous(), tgt.contiguous(), mask, prior, one


def register_correspondences(
        src, tgt, mask, config: SolverConfig = SolverConfig(),
        prior_ryrx: Optional[torch.Tensor] = None, device=None,
        timer: Optional[Callable[[str], None]] = None
        ) -> RegistrationSolution:
    """Solve the robust registration problem on matched correspondences.

    src, tgt: (N, 3) matched keypoints (padded; numpy or tensors), or a
    batch of B pairs (B, N, 3), solved together with a leading B on every
    field of the result; mask: (N,) or (B, N) validity. prior_ryrx:
    optional IMU roll/pitch rotation (3, 3), or one per pair (B, 3, 3);
    the estimated yaw is composed as Rz @ RyRx and COTE sees RyRx @ src
    (reference: include/quatro.hpp:276-279,419-426,892). device: None
    means "cuda" (RuntimeError without a card); tests pass "cpu".
    """
    timer = timer or _noop
    src, tgt, mask, prior, one = _solver_inputs(src, tgt, mask, prior_ryrx,
                                                device)
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
    return drop_axis(sol) if one else sol


def register_batch(src, tgt, mask, config: SolverConfig = SolverConfig(),
                   device=None) -> RegistrationSolution:
    """The solver over a leading batch of B pairs (the JAX package's
    ``register_batch``, a vmap of ``register_correspondences``): src, tgt
    (B, N, 3), mask (B, N). Each pair's failure is masked by its own
    ``valid``; a junk pair changes no other pair's result."""
    if len(src.shape) != 3:
        raise ValueError(f"register_batch takes (B, N, 3) pairs, got "
                         f"{tuple(src.shape)}")
    return register_correspondences(src, tgt, mask, config, device=device)


def register_hypotheses(
        src, tgt, mask, config: SolverConfig = SolverConfig(), k: int = 4,
        prior_ryrx: Optional[torch.Tensor] = None, device=None,
        timer: Optional[Callable[[str], None]] = None
        ) -> RegistrationSolution:
    """Multi-hypothesis solve: the K largest mutually distinct cliques of
    the consistency graph, then ``config.num_vote_hypotheses`` vote
    hypotheses (solver/vote.py). Returns a RegistrationSolution with a
    leading axis of K + num_vote_hypotheses, clique hypotheses first (after
    the pair axis B for a batch (B, N, 3)); the caller arbitrates
    (solver/verify.py).

    Hypothesis 0 is exactly register_correspondences' selection, so more
    hypotheses only add candidates. A clique hypothesis is valid when it
    has more than one vertex, a vote hypothesis from two supporters on
    (the cyclic chain TIM is estimable from two). The B x (K + votes)
    hypotheses are polished in one batched solve, as the JAX package vmaps
    them; each one's GNC stops on its own test.
    """
    timer = timer or _noop
    src, tgt, mask, prior, one = _solver_inputs(src, tgt, mask, prior_ryrx,
                                                device)
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
        scores, packed = clique_mod.clique_seed_scores_and_bits(adj, mask)
        grown = clique_mod.grow_greedy_cliques(
            adj, scores, mask, num_seeds=config.clique_num_seeds,
            max_size=config.max_clique_size, packed=packed)
        grown = clique_mod.improve_top_cliques(
            adj, grown, mask, top=top, rounds=config.clique_swap_rounds,
            packed=packed)
    cliques, sizes = clique_mod.top_distinct_cliques(
        torch.cat([sel0[:, None], grown], 1), k, force_first=True)
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
        cliques = torch.cat([cliques, vmasks], 1)
        valid_k = torch.cat([valid_k, vsizes >= 2], 1)
        timer("vote")

    sols = _solve_from_inliers(
        src, tgt, cliques, valid_k,
        scale[:, None].expand(valid_k.shape).contiguous(), config, prior,
        prior_ryrx is not None)
    timer("polish")
    return drop_axis(sols) if one else sols
