"""Inlier selection on the consistency graph: the max-clique replacement.

PyTorch counterpart of ``quatro_tpu/solver/clique.py`` in all four modes:
k-core peeling (PMC's bound and KCORE_HEU mode, reference
src/graph.cc:59-82), lock-step greedy clique growth with (1,2)-swap
improvement, the exact branch-and-bound of PMC_EXACT, and the K largest
distinct cliques of the multi-hypothesis solver.

Every function takes one graph (N, N) or a batch of pairs (B, N, N).
The JAX package's ``lax.while_loop``s and ``lax.fori_loop``s of the
k-core search, the growth, the swaps and the distinct greedy are the four
wrappers of ``ops/cliques.py``: on the card one kernel launch each for
every pair of a batch (csrc/cliques.cu, on the adjacency packed to bits
once), on the CPU their plain versions, device loops (utils/loops.py) with
the JAX package's bounds and exit tests, run as vmap runs them. On the card
the k-core search packs the graph (``clique_seed_scores_and_bits``) and the
growth and swaps take its bits (``packed``); given none, they get them from
one more k-core search. The exact branch-and-bound is one search of all
pairs (``ops.kernels.exact_clique``: a kernel launch on the card). Ties
are broken as in the JAX package: ``lax.top_k`` keeps the lower index
(stable sorts here), argmax / argmin take the first extreme.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops import kernels
from quatro_tpu_torch.ops.cliques import (PackedGraph, _take_rows,
                                          _top_k_indices, distinct_cliques,
                                          grow_cliques, kcore_search,
                                          swap_cliques)
from quatro_tpu_torch.utils.batch import drop_axis


def _bits(adj: torch.Tensor, mask: torch.Tensor,
          packed: PackedGraph | None) -> PackedGraph | None:
    """The bits of a (B, N, N) graph for the growth and the swaps: the
    ones given, else (on the card) those of one ``kcore_search`` call."""
    if packed is None and adj.device.type == "cuda":
        packed = kcore_search(adj.contiguous(), mask.contiguous())[3]
    return packed


def max_kcore(adj: torch.Tensor, mask: torch.Tensor):
    """Largest k with a non-empty k-core, plus that core's membership mask
    (binary search over k, each probe peeling from the best core so far to
    its fixed point), for adj (N, N) or a batch (B, N, N): (k () or (B,)
    int64, core mask). One ``ops.cliques.kcore_search`` call (a kernel
    launch on the card, the JAX package's nested loops as one flat device
    loop on the CPU)."""
    if adj.dim() == 2:
        return drop_axis(max_kcore(adj[None], mask[None]))
    lo, core, _, _ = kcore_search(adj.contiguous(), mask.contiguous())
    return lo, core


def grow_greedy_cliques(adj: torch.Tensor, seed_scores: torch.Tensor,
                        mask: torch.Tensor, num_seeds: int = 16,
                        max_size: int = 512, phase1_rounds: int = 8,
                        survivors: int = 16,
                        packed: PackedGraph | None = None) -> torch.Tensor:
    """Grow S greedy cliques in lock-step; (S, N) bool clique masks, or
    (B, S, N) for a batch (B, N, N). Each round adds, per seed, the
    candidate of highest degree within that seed's candidate set
    (two-phase schedule as in the JAX package,
    quatro_tpu/solver/clique.py:102-193). One ``ops.cliques.grow_cliques``
    call: a kernel launch on the card on ``packed`` (the graph's bits with
    a pair axis, from ``clique_seed_scores_and_bits``), device loops on
    the CPU."""
    if adj.dim() == 2:
        return drop_axis(grow_greedy_cliques(
            adj[None], seed_scores[None], mask[None], num_seeds, max_size,
            phase1_rounds, survivors, packed))
    return grow_cliques(adj.contiguous(), seed_scores.contiguous(),
                        mask.contiguous(), num_seeds, max_size,
                        phase1_rounds, survivors, _bits(adj, mask, packed))


def improve_cliques_1swap(adj: torch.Tensor, cliques: torch.Tensor,
                          mask: torch.Tensor, rounds: int = 4,
                          packed: PackedGraph | None = None) -> torch.Tensor:
    """(1,2)-swap local improvement of (K, N) clique masks, or (B, K, N)
    for a batch (B, N, N): per round, add an outside vertex adjacent to
    every member, else drop one member u and add two adjacent outside
    vertices that miss only u; a clique with neither stops there, as the
    JAX package's ``lax.while_loop`` does under vmap
    (quatro_tpu/solver/clique.py:266). One ``ops.cliques.swap_cliques``
    call over every clique (on ``packed``, as ``grow_greedy_cliques``)."""
    if rounds <= 0:
        return cliques
    if adj.dim() == 2:
        return drop_axis(improve_cliques_1swap(adj[None], cliques[None],
                                               mask[None], rounds, packed))
    return swap_cliques(adj.contiguous(), cliques.contiguous(),
                        mask.contiguous(), top=cliques.shape[-2],
                        rounds=rounds, packed=_bits(adj, mask, packed))


def improve_top_cliques(adj: torch.Tensor, cliques: torch.Tensor,
                        mask: torch.Tensor, top: int = 8,
                        rounds: int = 4,
                        packed: PackedGraph | None = None) -> torch.Tensor:
    """The 1-swap improvement applied to the `top` largest cliques (of
    each pair, for a batch; on ``packed``, as ``grow_greedy_cliques``)."""
    if rounds <= 0:
        return cliques
    if adj.dim() == 2:
        return drop_axis(improve_top_cliques(adj[None], cliques[None],
                                             mask[None], top, rounds,
                                             packed))
    return swap_cliques(adj.contiguous(), cliques.contiguous(),
                        mask.contiguous(), top=top, rounds=rounds,
                        packed=_bits(adj, mask, packed))


def _largest(cliques: torch.Tensor) -> torch.Tensor:
    """The first largest of (..., S, N) clique masks: (..., N)."""
    return _take_rows(cliques, torch.argmax(cliques.sum(-1), -1,
                                            keepdim=True))[..., 0, :]


def greedy_cliques(adj: torch.Tensor, seed_scores: torch.Tensor,
                   mask: torch.Tensor, num_seeds: int = 16,
                   max_size: int = 512, swap_rounds: int = 0,
                   packed: PackedGraph | None = None) -> torch.Tensor:
    """The largest clique of the lock-step greedy growth, after the 1-swap
    improvement of the top candidates (first largest on ties); the growth
    and the swaps on one ``packed`` (as ``grow_greedy_cliques``)."""
    if packed is None:
        one = adj.dim() == 2
        packed = _bits(adj[None] if one else adj,
                       mask[None] if one else mask, None)
    cliques = grow_greedy_cliques(adj, seed_scores, mask,
                                  num_seeds=num_seeds, max_size=max_size,
                                  packed=packed)
    cliques = improve_top_cliques(adj, cliques, mask, rounds=swap_rounds,
                                  packed=packed)
    return _largest(cliques)


def exact_max_clique_bb(adj: torch.Tensor, mask: torch.Tensor,
                        incumbent: torch.Tensor | None = None,
                        cap: int = 64, max_steps: int = 20000,
                        seed_scores: torch.Tensor | None = None):
    """Exact branch-and-bound max clique (PMC_EXACT parity; reference
    src/graph.cc:106-127): the JAX package's iterative Carraghan-Pardalos
    DFS over the ``cap`` highest-scored vertices (max-core membership,
    then degree), with the |C| + |P| bound and the greedy incumbent as
    warm start, at most ``max_steps`` steps; for adj (N, N) or a batch of
    pairs (B, N, N). ``seed_scores``: ``clique_seed_scores(adj, mask)``
    where the caller has them already.

    The restriction, its k-core check and the incumbent are batched torch
    operations; the search of all pairs is one call of
    ``ops.kernels.exact_clique`` (one kernel launch on the card, the JAX
    loop's body as a device loop on the CPU). Nothing is read back.

    Returns (clique mask (..., N) bool, completed (...) bool: the search
    ended before max_steps, restricted (...) bool: the cap cut into the
    max k-core, steps (...) int32: the search steps taken, which the JAX
    package does not report).
    """
    if adj.dim() == 2:
        return drop_axis(exact_max_clique_bb(
            adj[None], mask[None],
            None if incumbent is None else incumbent[None], cap, max_steps,
            None if seed_scores is None else seed_scores[None]))
    n = adj.shape[-1]
    dev = adj.device
    cap = min(cap, n)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    adj_b = adj & mask[..., :, None] & mask[..., None, :] & ~eye
    if seed_scores is None:
        seed_scores = clique_seed_scores(adj, mask)
    scores = torch.where(mask, seed_scores, float("-inf"))
    vsel = _top_k_indices(scores, cap)                       # (B, cap)
    vvalid = mask.gather(-1, vsel) & (scores.gather(-1, vsel)
                                      > float("-inf"))
    sub = _take_rows(adj_b, vsel).gather(
        -1, vsel[:, None, :].expand(-1, cap, -1))
    sub = sub & vvalid[..., :, None] & vvalid[..., None, :]
    _, core_mask = max_kcore(adj_b, mask)
    core_in = core_mask & mask
    restricted = core_in.sum(-1) > (core_in.gather(-1, vsel) & vvalid).sum(-1)
    if incumbent is not None:
        inc_sub = incumbent.gather(-1, vsel) & vvalid
        # usable only if the whole incumbent lies inside the restriction
        inc_ok = inc_sub.sum(-1) == (incumbent & mask).sum(-1)
        best0 = inc_sub & inc_ok[..., None]
    else:
        best0 = torch.zeros_like(vvalid)
    best, completed, steps = kernels.exact_clique(
        sub.contiguous(), vvalid.contiguous(), best0.contiguous(), max_steps)
    out = torch.zeros_like(mask).scatter(-1, vsel, best)
    return out, completed, restricted, steps


def clique_seed_scores(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Seed attractiveness: max-core membership dominates, degree breaks
    ties (the k-core and the degrees of one ``kcore_search`` call)."""
    return clique_seed_scores_and_bits(adj, mask)[0]


def clique_seed_scores_and_bits(adj: torch.Tensor, mask: torch.Tensor):
    """``clique_seed_scores`` and the graph's bits that its k-core search
    packed on the card (None on the CPU), always with a pair axis: the
    ``packed`` of the growth and the swaps on the same graph."""
    if adj.dim() == 2:
        scores, packed = clique_seed_scores_and_bits(adj[None], mask[None])
        return scores[0], packed
    _, core, deg, packed = kcore_search(adj.contiguous(), mask.contiguous())
    return core.to(torch.float32) * 1e6 + deg, packed


def top_distinct_cliques(cliques: torch.Tensor, k: int,
                         min_distinct_frac: float = 0.5,
                         force_first: bool = False):
    """The K largest pairwise-distinct cliques of (S, N) masks: ((K, N)
    bool masks, (K,) f32 sizes), or of each pair's (B, S, N). Two cliques
    are the same hypothesis when their intersection covers >=
    min_distinct_frac of the smaller one; singletons are never taken; with
    force_first, row 0 is taken first whatever its size. Unfilled slots
    hold the first untaken rows with size 0. k is clamped to S.

    The JAX package's greedy ``fori_loop`` over the S sorted rows
    (quatro_tpu/solver/clique.py:433-442) is one
    ``ops.cliques.distinct_cliques`` call for every pair at once, with
    nothing copied to the host; the comparison is the same single f32
    product and compare.
    """
    if cliques.dim() == 2:
        return drop_axis(top_distinct_cliques(cliques[None], k,
                                              min_distinct_frac, force_first))
    return distinct_cliques(cliques.contiguous(), k, min_distinct_frac,
                            force_first)


def select_inliers_with_candidates(adj: torch.Tensor, mask: torch.Tensor,
                                   kcore_threshold: float = 0.5,
                                   num_seeds: int = 16, max_size: int = 512,
                                   swap_rounds: int = 0, top: int = 8):
    """select_inliers(mode="clique") and the improved grown candidates,
    with the k-core, seed scores, growth and swaps computed once. Returns
    (sel (N,), valid (), grown (S, N)), with a leading pair axis for a
    batch; the selection equals select_inliers' for top == 8."""
    if adj.dim() == 2:
        return drop_axis(select_inliers_with_candidates(
            adj[None], mask[None], kcore_threshold, num_seeds, max_size,
            swap_rounds, top))
    # the graph is packed to bits once, for the three kernels on the card
    adj, mask = adj.contiguous(), mask.contiguous()
    max_core, kcore_mask, deg, packed = kcore_search(adj, mask)
    scores = kcore_mask.to(torch.float32) * 1e6 + deg
    grown = grow_cliques(adj, scores, mask, num_seeds=num_seeds,
                         max_size=max_size, packed=packed)
    if swap_rounds > 0:
        grown = swap_cliques(adj, grown, mask, top=top, rounds=swap_rounds,
                             packed=packed)
    clique_sel = _largest(grown) & mask
    # an edgeless graph's largest core is the 0-core: select nothing
    kcore_sel = kcore_mask & mask & (max_core >= 1)[..., None]
    # the threshold in float64, as the Python float of the per-pair code
    n_valid = mask.sum(-1).to(torch.float64)
    use_kcore = (max_core >= 1) & (max_core >= kcore_threshold * n_valid)
    sel = torch.where(use_kcore[..., None], kcore_sel, clique_sel)
    return sel, sel.sum(-1) > 1, grown


def select_inliers(adj: torch.Tensor, mask: torch.Tensor, mode: str = "clique",
                   kcore_threshold: float = 0.5, num_seeds: int = 16,
                   max_size: int = 512, swap_rounds: int = 0,
                   exact_cap: int = 64, exact_max_steps: int = 20000):
    """Dispatch over the inlier-selection modes of Quatro::Params
    (include/quatro.hpp:184-189,248). Returns (inlier_mask (N,) bool,
    valid () bool), with a leading pair axis for a batch (B, N, N); valid
    is False when <= 1 vertex is selected (the reference aborts there,
    include/quatro.hpp:809-813). The exact search takes every pair in
    one call."""
    if mode == "exact":
        scores, packed = clique_seed_scores_and_bits(adj, mask)
        greedy = greedy_cliques(adj, scores, mask, num_seeds=num_seeds,
                                max_size=max_size, swap_rounds=swap_rounds,
                                packed=packed) & mask
        bb = exact_max_clique_bb(adj, mask, incumbent=greedy, cap=exact_cap,
                                 max_steps=exact_max_steps,
                                 seed_scores=scores)[0]
        # seeded with the greedy incumbent, the search can only match or
        # beat it; the max guards the truncated case
        sel = torch.where((bb.sum(-1) >= greedy.sum(-1))[..., None], bb,
                          greedy)
        return sel, sel.sum(-1) > 1
    if mode == "clique":
        sel, valid, _ = select_inliers_with_candidates(
            adj, mask, kcore_threshold=kcore_threshold, num_seeds=num_seeds,
            max_size=max_size, swap_rounds=swap_rounds)
        return sel, valid
    if mode == "none":
        sel = mask
    else:
        max_core, kcore_mask = max_kcore(adj, mask)
        sel = kcore_mask & mask & (max_core >= 1)[..., None]
    return sel, sel.sum(-1) > 1
