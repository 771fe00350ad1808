"""Inlier selection on the consistency graph: the max-clique replacement.

PyTorch counterpart of ``quatro_tpu/solver/clique.py`` in all four modes:
k-core peeling (PMC's bound and KCORE_HEU mode, reference
src/graph.cc:59-82), lock-step greedy clique growth with (1,2)-swap
improvement, the exact branch-and-bound of PMC_EXACT, and the K largest
distinct cliques of the multi-hypothesis solver.

Every function takes one graph (N, N) or a batch of pairs (B, N, N).
The JAX package's ``lax.while_loop``s and ``lax.fori_loop``s are device
loops here (utils/loops.py: CUDA graphs on the card) with the same bounds
and exit tests, run as vmap runs them: the loop goes on while any pair is
live, and each pair keeps its state from the round its own test ended it
(by ``torch.where``, or because that state is a fixed point of the
round), so the rounds a chunk runs past that change none of its bits. A
``while_loop`` reads one flag back per chunk of rounds, whatever B is; a
``fori_loop`` reads nothing. The exact branch-and-bound is one search of
all pairs (``ops.kernels.exact_clique``: a kernel launch on the card).
Ties are broken as in the JAX package: ``lax.top_k`` keeps the lower
index (stable sorts here), argmax / argmin take the first extreme.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops import kernels
from quatro_tpu_torch.utils import loops
from quatro_tpu_torch.utils.batch import drop_axis

KCORE_CHUNK = 8         # peel rounds per flag read
GROW_CHUNK = 8          # growth rounds per flag read
TOP_CHUNK = 32          # rows of top_distinct_cliques' greedy per graph


def _count_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Counting matmul over 0/1 operands: f32 products of 0/1 values give
    exact integer counts (below 2**24; TF32 is never enabled)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _count_mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``_count_mm`` of (..., N, N) matrices and (..., N) vectors."""
    return _count_mm(a, v[..., None])[..., 0]


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties toward
    the lower index (lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i], :] of (B, S, N) rows by (B, K) indices."""
    return x.gather(-2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _put_rows(x: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """x with rows idx[b, i] replaced by rows[b, i] (distinct indices)."""
    return x.scatter(-2, idx[..., None].expand(*idx.shape, x.shape[-1]),
                     rows)


def _kcore_round(consts, state):
    """One peel round of every pair's current probe of the binary search.
    A pair whose peel did not change this round has reached its probe's
    fixed point: it resolves the probe (lo or hi, and the best core when
    the core is non-empty) and starts its next probe from its best core.
    A pair whose search has ended probes k = 0, which peels nothing, so
    its state is a fixed point of the round."""
    (adj_f,) = consts
    lo, hi, best, alive = state
    act = lo < hi
    mid = (lo + hi + 1) // 2
    k = torch.where(act, mid, 0).to(torch.float32)
    deg = _count_mv(adj_f, alive)
    peeled = alive * (deg >= k[..., None]).to(alive.dtype)
    done = ~(peeled != alive).any(-1)
    nonempty = act & done & (peeled.sum(-1) > 0)
    lo = torch.where(nonempty, mid, lo)
    hi = torch.where(act & done & ~nonempty, mid - 1, hi)
    best = torch.where(nonempty[..., None], peeled, best)
    alive = torch.where(done[..., None], best, peeled)
    return lo, hi, best, alive


def _searching(state):
    return (state[0] < state[1]).any()


def max_kcore(adj: torch.Tensor, mask: torch.Tensor):
    """Largest k with a non-empty k-core, plus that core's membership mask
    (binary search over k, each probe peeling from the best core so far to
    its fixed point), for adj (N, N) or a batch (B, N, N): (k () or (B,)
    int64, core mask).

    The JAX package nests the peel's ``lax.while_loop`` in the search's
    (quatro_tpu/solver/clique.py:61, :97). Here both are one flat device
    loop of peel rounds (utils/loops.py), a flag read per KCORE_CHUNK
    rounds: each pair resolves its own probe in the round its peel stops
    changing and starts its next probe in the next, so the pairs' probes
    interleave instead of each probe waiting for every pair's peel. A
    k-core peel's fixed point is unique and the degrees are exact counts,
    so each pair's (lo, best core) is the nested loops' bit for bit. Each
    probe removes at most N vertices, a round at least one until it ends,
    and there are at most bit_length(N) + 1 probes: that bounds the
    rounds."""
    if adj.dim() == 2:
        return drop_axis(max_kcore(adj[None], mask[None]))
    n = adj.shape[-1]
    adj_f = adj.to(torch.float32)
    alive0 = mask.to(torch.float32)
    deg0 = _count_mv(adj_f, alive0)
    lo = torch.zeros(mask.shape[:-1], dtype=torch.int64, device=adj.device)
    hi = torch.where(mask, deg0, 0.0).amax(-1).to(torch.int64)
    (lo, _, best_core, _), _ = loops.while_chunks(
        "max_kcore", _kcore_round, _searching, (adj_f,),
        (lo, hi, alive0, alive0), (n + 1) * (n.bit_length() + 1),
        KCORE_CHUNK)
    return lo, best_core > 0


def _grow_round(consts, state, max_size: int, n: int):
    """One lock-step growth round of every seed (see
    ``grow_greedy_cliques``); a seed with no candidate left is a fixed
    point."""
    adj_f, tiebreak = consts
    clique, cand = state
    deg = _count_mm(cand, adj_f) * cand
    # early completion: a candidate set that is itself a clique is
    # absorbed whole (never past max_size)
    csz = cand.sum(-1)
    esum = deg.sum(-1)
    room = clique.sum(-1) + csz <= float(max_size)
    whole = ((esum == csz * (csz - 1.0)) & (csz > 0) & room
             ).to(torch.float32)[..., None]
    clique = clique + cand * whole
    cand = cand * (1.0 - whole)
    score = torch.where(cand > 0, deg + tiebreak, float("-inf"))
    pick = torch.argmax(score, dim=-1)
    pick_oh = torch.nn.functional.one_hot(pick, n).to(torch.float32)
    has_cand = ((cand.sum(-1) > 0) & (clique.sum(-1) < float(max_size))
                )[..., None].to(torch.float32)
    clique = clique + pick_oh * has_cand
    cand = cand * _count_mm(pick_oh, adj_f) * has_cand
    cand = cand * (1.0 - clique)
    return clique, cand


def _has_candidates(state):
    return (state[1].sum(-1) > 0).any()


def grow_greedy_cliques(adj: torch.Tensor, seed_scores: torch.Tensor,
                        mask: torch.Tensor, num_seeds: int = 16,
                        max_size: int = 512, phase1_rounds: int = 8,
                        survivors: int = 16) -> torch.Tensor:
    """Grow S greedy cliques in lock-step; (S, N) bool clique masks, or
    (B, S, N) for a batch (B, N, N). Each round adds, per seed, the
    candidate of highest degree within that seed's candidate set
    (two-phase schedule as in the JAX package). The JAX package's
    ``lax.while_loop``s (quatro_tpu/solver/clique.py:177-190) are device
    loops here (utils/loops.py) that read their flag, whether any seed of
    any pair has candidates, once per GROW_CHUNK rounds; a seed with no
    candidate left is a fixed point of a round, and a chunk never passes
    its phase's limit."""
    if adj.dim() == 2:
        return drop_axis(grow_greedy_cliques(
            adj[None], seed_scores[None], mask[None], num_seeds, max_size,
            phase1_rounds, survivors))
    n = adj.shape[-1]
    dev = adj.device
    num_seeds = min(num_seeds, n)
    adj_f = adj.to(torch.float32)
    scores = torch.where(mask, seed_scores, float("-inf"))
    seeds = _top_k_indices(scores, num_seeds)               # (B, S)
    clique = torch.nn.functional.one_hot(seeds, n).to(torch.float32)
    cand = _take_rows(adj_f, seeds) * mask.to(torch.float32)[..., None, :]
    tiebreak = -torch.arange(n, dtype=torch.float32, device=dev) * 1e-6

    def body(consts, state):
        return _grow_round(consts, state, max_size, n)

    def run(clique, cand, rounds, limit):
        (clique, cand), trips = loops.while_chunks(
            "grow_cliques", body, _has_candidates, (adj_f, tiebreak),
            (clique, cand), limit - rounds, GROW_CHUNK)
        return clique, cand, rounds + trips

    if num_seeds <= survivors or phase1_rounds >= max_size:
        clique, _, _ = run(clique, cand, 0, max_size - 1)
        return clique > 0
    # phase 1 ends at its limit (r1 = phase1_rounds however it is
    # chunked) or with no candidates left in any pair, and then phase 2
    # is a fixed point whatever its round count
    clique, cand, r1 = run(clique, cand, 0, phase1_rounds)
    keep = _top_k_indices(cand.sum(-1), survivors)
    c2, _, _ = run(_take_rows(clique, keep), _take_rows(cand, keep), r1,
                   max_size - 1)
    return _put_rows(clique, keep, c2) > 0


def _swap_round(consts, state, k_cand: int):
    """One (1,2)-swap round of every clique (see
    ``improve_cliques_1swap``); a clique that is no longer live keeps its
    members."""
    adj_b, adj_t, mask, iota = consts
    x, live = state
    bsz, kq, n = x.shape
    xf = x.to(torch.float32)
    s = xf.sum(-1, keepdim=True)
    cnt = xf @ adj_t                       # neighbours inside the clique
    outside = ~x & mask[:, None, :]
    addable = (cnt == s) & outside
    can_add = addable.any(-1)
    add_idx = torch.argmax(addable.to(torch.uint8), -1, keepdim=True)
    x_add = x.scatter(-1, add_idx, True)
    miss1 = (cnt == s - 1.0) & outside
    sel_key = torch.where(miss1, iota, n)
    idx = torch.sort(sel_key, dim=-1, stable=True).indices[..., :k_cand]
    vsel = sel_key.gather(-1, idx) < n                    # (B, K, C)
    rows_b = _take_rows(adj_b, idx.reshape(bsz, -1)).reshape(
        bsz, kq, k_cand, n)                               # (B, K, C, N)
    asub = rows_b.gather(-1, idx[..., None, :].expand(
        bsz, kq, k_cand, k_cand))
    # the first member each selected vertex is not adjacent to
    uidx = torch.argmax((~rows_b & x[..., None, :]).to(torch.uint8), -1)
    pairs = (asub & vsel[..., :, None] & vsel[..., None, :]
             & (uidx[..., :, None] == uidx[..., None, :]))
    flat = pairs.reshape(bsz, kq, -1)
    pidx = torch.argmax(flat.to(torch.uint8), -1, keepdim=True)
    can_swap = flat.gather(-1, pidx)[..., 0]
    p_row, p_col = pidx // k_cand, pidx % k_cand
    x_swap = (x.scatter(-1, uidx.gather(-1, p_row), False)
              .scatter(-1, idx.gather(-1, p_row), True)
              .scatter(-1, idx.gather(-1, p_col), True))
    moved = can_add | can_swap
    new = torch.where(can_add[..., None], x_add, x_swap)
    x = torch.where((live & moved)[..., None], new, x)
    return x, live & moved


def improve_cliques_1swap(adj: torch.Tensor, cliques: torch.Tensor,
                          mask: torch.Tensor, rounds: int = 4) -> torch.Tensor:
    """(1,2)-swap local improvement of (K, N) clique masks, or (B, K, N)
    for a batch (B, N, N): per round, add an outside vertex adjacent to
    every member, else drop one member u and add two adjacent outside
    vertices that miss only u; a clique with neither stops there, as the
    JAX package's ``lax.while_loop`` does under vmap
    (quatro_tpu/solver/clique.py:266). Every clique of every pair takes
    each round together, all ``rounds`` of them as a device loop that
    reads nothing back (utils/loops.py): a clique that stopped is frozen
    by its live mask."""
    if rounds <= 0:
        return cliques
    if adj.dim() == 2:
        return drop_axis(improve_cliques_1swap(adj[None], cliques[None],
                                               mask[None], rounds))
    bsz, kq, n = cliques.shape
    dev = adj.device
    adj_b = adj.to(torch.bool)
    adj_t = adj_b.to(torch.float32).transpose(-1, -2)
    k_cand = min(128, n)
    iota = torch.arange(n, device=dev)
    live = torch.ones((bsz, kq), dtype=torch.bool, device=dev)

    def body(consts, state):
        return _swap_round(consts, state, k_cand)

    x, _ = loops.fori("swap_cliques", body, (adj_b, adj_t, mask, iota),
                      (cliques, live), rounds, rounds)
    return x


def improve_top_cliques(adj: torch.Tensor, cliques: torch.Tensor,
                        mask: torch.Tensor, top: int = 8,
                        rounds: int = 4) -> torch.Tensor:
    """The 1-swap improvement applied to the `top` largest cliques (of
    each pair, for a batch)."""
    if rounds <= 0:
        return cliques
    if adj.dim() == 2:
        return drop_axis(improve_top_cliques(adj[None], cliques[None],
                                             mask[None], top, rounds))
    top = min(top, cliques.shape[-2])
    idx = _top_k_indices(cliques.sum(-1), top)
    return _put_rows(cliques, idx, improve_cliques_1swap(
        adj, _take_rows(cliques, idx), mask, rounds=rounds))


def _largest(cliques: torch.Tensor) -> torch.Tensor:
    """The first largest of (..., S, N) clique masks: (..., N)."""
    return _take_rows(cliques, torch.argmax(cliques.sum(-1), -1,
                                            keepdim=True))[..., 0, :]


def greedy_cliques(adj: torch.Tensor, seed_scores: torch.Tensor,
                   mask: torch.Tensor, num_seeds: int = 16,
                   max_size: int = 512, swap_rounds: int = 0) -> torch.Tensor:
    """The largest clique of the lock-step greedy growth, after the 1-swap
    improvement of the top candidates (first largest on ties)."""
    cliques = grow_greedy_cliques(adj, seed_scores, mask,
                                  num_seeds=num_seeds, max_size=max_size)
    cliques = improve_top_cliques(adj, cliques, mask, rounds=swap_rounds)
    return _largest(cliques)


def exact_max_clique_bb(adj: torch.Tensor, mask: torch.Tensor,
                        incumbent: torch.Tensor | None = None,
                        cap: int = 64, max_steps: int = 20000):
    """Exact branch-and-bound max clique (PMC_EXACT parity; reference
    src/graph.cc:106-127): the JAX package's iterative Carraghan-Pardalos
    DFS over the ``cap`` highest-scored vertices (max-core membership,
    then degree), with the |C| + |P| bound and the greedy incumbent as
    warm start, at most ``max_steps`` steps; for adj (N, N) or a batch of
    pairs (B, N, N).

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
            None if incumbent is None else incumbent[None], cap, max_steps))
    n = adj.shape[-1]
    dev = adj.device
    cap = min(cap, n)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    adj_b = adj & mask[..., :, None] & mask[..., None, :] & ~eye
    scores = torch.where(mask, clique_seed_scores(adj, mask), float("-inf"))
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
    ties."""
    _, kcore_mask = max_kcore(adj, mask)
    return kcore_mask.to(torch.float32) * 1e6 + _count_mv(adj, mask)


def _distinct_round(consts, state, k: int, frac: float):
    """Row i of the greedy over the sorted rows, for every pair: taken
    when fewer than k are taken, no taken row covers min_distinct_frac of
    the smaller of the two, and it is no singleton."""
    inter, sizes, iota = consts
    taken, count, i = state
    row = inter.index_select(-2, i)[..., 0, :]            # (B, S)
    size_i = sizes.index_select(-1, i)                    # (B, 1)
    min_sz = torch.minimum(sizes, size_i)
    conflict = taken & (row >= frac * torch.clamp(min_sz, min=1.0))
    # singletons (isolated seeds) carry no hypothesis: the reference
    # aborts on cliques <= 1 (include/quatro.hpp:809-813)
    ok = (count < k) & ~conflict.any(-1) & (size_i[..., 0] > 1)
    taken = taken | ((iota == i)[None, :] & ok[:, None])
    return taken, count + ok.to(count.dtype), i + 1


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
    (quatro_tpu/solver/clique.py:433-442) is a device loop here, for every
    pair at once (utils/loops.py, TOP_CHUNK rows a graph), with nothing
    copied to the host; the comparison is the same single f32 product and
    compare.
    """
    if cliques.dim() == 2:
        return drop_axis(top_distinct_cliques(cliques[None], k,
                                              min_distinct_frac, force_first))
    bsz, s = cliques.shape[:2]
    k = min(k, s)
    dev = cliques.device
    cf = cliques.to(torch.float32)
    sizes = cf.sum(-1)
    sort_key = sizes
    if force_first:
        bump = torch.zeros_like(sizes)
        bump[..., 0] = 1e9
        sort_key = sizes + bump
    order = torch.sort(-sort_key, dim=-1, stable=True).indices
    cf = _take_rows(cf, order)
    sizes = sizes.gather(-1, order)
    inter = _count_mm(cf, cf.transpose(-1, -2))          # (B, S, S)
    iota = torch.arange(s, device=dev)

    def body(consts, state):
        return _distinct_round(consts, state, k, min_distinct_frac)

    taken, count, _ = loops.fori(
        "top_distinct", body, (inter, sizes, iota),
        (torch.zeros((bsz, s), dtype=torch.bool, device=dev),
         torch.zeros(bsz, dtype=torch.int64, device=dev),
         torch.zeros(1, dtype=torch.int64, device=dev)), s, TOP_CHUNK)
    pick = torch.sort(torch.where(taken, iota, s + iota), dim=-1,
                      stable=True).indices[:, :k]
    filled = torch.arange(k, device=dev)[None, :] < count[:, None]
    picked_sizes = torch.where(filled, sizes.gather(-1, pick), 0.0)
    return _take_rows(cf, pick) > 0, picked_sizes


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
    max_core, kcore_mask = max_kcore(adj, mask)
    scores = kcore_mask.to(torch.float32) * 1e6 + _count_mv(adj, mask)
    grown = grow_greedy_cliques(adj, scores, mask, num_seeds=num_seeds,
                                max_size=max_size)
    grown = improve_top_cliques(adj, grown, mask, top=top,
                                rounds=swap_rounds)
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
        greedy = greedy_cliques(adj, clique_seed_scores(adj, mask), mask,
                                num_seeds=num_seeds, max_size=max_size,
                                swap_rounds=swap_rounds) & mask
        bb = exact_max_clique_bb(adj, mask, incumbent=greedy, cap=exact_cap,
                                 max_steps=exact_max_steps)[0]
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
