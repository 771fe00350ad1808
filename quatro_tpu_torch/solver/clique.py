"""Inlier selection on the consistency graph: the max-clique replacement.

PyTorch counterpart of ``quatro_tpu/solver/clique.py`` in modes "clique",
"kcore" and "none" ("exact" is not ported yet): k-core peeling (PMC's
bound and KCORE_HEU mode, reference src/graph.cc:59-82), lock-step greedy
clique growth with (1,2)-swap improvement, and the K largest distinct
cliques of the multi-hypothesis solver.

The JAX package's ``lax.while_loop``s are bounded Python loops here with
the same bounds and exit tests; each exit test reads one value back from
the device. Ties are broken as in the JAX package: ``lax.top_k`` keeps the
lower index (stable sorts here), argmax / argmin take the first extreme.
"""

from __future__ import annotations

import numpy as np
import torch


def _count_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Counting matmul over 0/1 operands: f32 products of 0/1 values give
    exact integer counts (below 2**24; TF32 is never enabled)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties toward
    the lower index (lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _peel_to_kcore(adj_f: torch.Tensor, alive: torch.Tensor, k) -> torch.Tensor:
    """Fixed point of 'remove alive vertices with < k alive neighbours'."""
    while True:
        deg = _count_mm(adj_f, alive)
        new_alive = alive * (deg >= k).to(alive.dtype)
        if not bool((new_alive != alive).any()):
            return new_alive
        alive = new_alive


def max_kcore(adj: torch.Tensor, mask: torch.Tensor):
    """Largest k with a non-empty k-core, plus that core's membership mask
    (binary search over k, each probe peeling from the best core so far)."""
    adj_f = adj.to(torch.float32)
    alive0 = mask.to(torch.float32)
    deg0 = _count_mm(adj_f, alive0)
    lo, hi = 0, int(torch.where(mask, deg0, 0.0).max())
    best_core = alive0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        core = _peel_to_kcore(adj_f, best_core, float(mid))
        if bool(core.sum() > 0):
            lo, best_core = mid, core
        else:
            hi = mid - 1
    return lo, best_core > 0


def grow_greedy_cliques(adj: torch.Tensor, seed_scores: torch.Tensor,
                        mask: torch.Tensor, num_seeds: int = 16,
                        max_size: int = 512, phase1_rounds: int = 8,
                        survivors: int = 16) -> torch.Tensor:
    """Grow S greedy cliques in lock-step; (S, N) bool clique masks. Each
    round adds, per seed, the candidate of highest degree within that
    seed's candidate set (two-phase schedule as in the JAX package)."""
    n = adj.shape[0]
    dev = adj.device
    num_seeds = min(num_seeds, n)
    adj_f = adj.to(torch.float32)
    scores = torch.where(mask, seed_scores, float("-inf"))
    seeds = _top_k_indices(scores, num_seeds)
    clique = torch.nn.functional.one_hot(seeds, n).to(torch.float32)
    cand = adj_f[seeds] * mask.to(torch.float32)
    tiebreak = -torch.arange(n, dtype=torch.float32, device=dev) * 1e-6

    def body(clique, cand):
        deg = _count_mm(cand, adj_f) * cand
        # early completion: a candidate set that is itself a clique is
        # absorbed whole (never past max_size)
        csz = cand.sum(1)
        esum = deg.sum(1)
        room = clique.sum(1) + csz <= float(max_size)
        whole = ((esum == csz * (csz - 1.0)) & (csz > 0) & room
                 ).to(torch.float32)[:, None]
        clique = clique + cand * whole
        cand = cand * (1.0 - whole)
        score = torch.where(cand > 0, deg + tiebreak, float("-inf"))
        pick = torch.argmax(score, dim=1)
        pick_oh = torch.nn.functional.one_hot(pick, n).to(torch.float32)
        has_cand = ((cand.sum(1) > 0) & (clique.sum(1) < float(max_size))
                    )[:, None].to(torch.float32)
        clique = clique + pick_oh * has_cand
        cand = cand * _count_mm(pick_oh, adj_f) * has_cand
        cand = cand * (1.0 - clique)
        return clique, cand

    def run(clique, cand, rounds, limit):
        while rounds < limit and bool((cand.sum(1) > 0).any()):
            clique, cand = body(clique, cand)
            rounds += 1
        return clique, cand, rounds

    if num_seeds <= survivors or phase1_rounds >= max_size:
        clique, _, _ = run(clique, cand, 0, max_size - 1)
        return clique > 0
    clique, cand, r1 = run(clique, cand, 0, phase1_rounds)
    keep = _top_k_indices(cand.sum(1), survivors)
    c2, _, _ = run(clique[keep], cand[keep], r1, max_size - 1)
    clique[keep] = c2
    return clique > 0


def improve_cliques_1swap(adj: torch.Tensor, cliques: torch.Tensor,
                          mask: torch.Tensor, rounds: int = 4) -> torch.Tensor:
    """(1,2)-swap local improvement of (K, N) clique masks: per round, add
    an outside vertex adjacent to every member, else drop one member u
    and add two adjacent outside vertices that miss only u."""
    if rounds <= 0:
        return cliques
    n = adj.shape[0]
    dev = adj.device
    adj_b = adj.to(torch.bool)
    adj_f = adj_b.to(torch.float32)
    k_cand = min(128, n)
    iota = torch.arange(n, device=dev)
    out = []
    for x in cliques:
        x = x.clone()
        for _ in range(rounds):
            xf = x.to(torch.float32)
            s = xf.sum()
            cnt = adj_f @ xf
            outside = ~x & mask
            addable = (cnt == s) & outside
            if bool(addable.any()):
                x[torch.argmax(addable.to(torch.uint8))] = True
                continue
            miss1 = (cnt == s - 1.0) & outside
            sel_key = torch.where(miss1, iota, n)
            idx = torch.sort(sel_key, stable=True).indices[:k_cand]
            vsel = sel_key[idx] < n
            rows_b = adj_b[idx]
            asub = rows_b[:, idx]
            non_nbr = (1.0 - rows_b.to(torch.float32)) * xf[None, :]
            uidx = torch.argmax(non_nbr, dim=1)
            pairs = (asub & vsel[:, None] & vsel[None, :]
                     & (uidx[:, None] == uidx[None, :]))
            flat = pairs.reshape(-1)
            pidx = int(torch.argmax(flat.to(torch.uint8)))
            if not bool(flat[pidx]):
                break
            x[uidx[pidx // k_cand]] = False
            x[idx[pidx // k_cand]] = True
            x[idx[pidx % k_cand]] = True
        out.append(x)
    return torch.stack(out)


def improve_top_cliques(adj: torch.Tensor, cliques: torch.Tensor,
                        mask: torch.Tensor, top: int = 8,
                        rounds: int = 4) -> torch.Tensor:
    """The 1-swap improvement applied to the `top` largest cliques."""
    if rounds <= 0:
        return cliques
    top = min(top, cliques.shape[0])
    idx = _top_k_indices(cliques.sum(1), top)
    cliques = cliques.clone()
    cliques[idx] = improve_cliques_1swap(adj, cliques[idx], mask,
                                         rounds=rounds)
    return cliques


def clique_seed_scores(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Seed attractiveness: max-core membership dominates, degree breaks
    ties."""
    _, kcore_mask = max_kcore(adj, mask)
    return kcore_mask.to(torch.float32) * 1e6 + _count_mm(adj, mask)


def top_distinct_cliques(cliques: torch.Tensor, k: int,
                         min_distinct_frac: float = 0.5,
                         force_first: bool = False):
    """The K largest pairwise-distinct cliques of (S, N) masks: ((K, N)
    bool masks, (K,) f32 sizes). Two cliques are the same hypothesis when
    their intersection covers >= min_distinct_frac of the smaller one;
    singletons are never taken; with force_first, row 0 is taken first
    whatever its size. Unfilled slots hold the first untaken rows with
    size 0. k is clamped to S.

    The JAX package's greedy ``fori_loop`` over the S rows runs on the
    host here: the (S, S) intersection counts and the sizes come back in
    one copy, the O(S^2) greedy runs in numpy, and the picked rows are
    gathered on the device.
    """
    s = cliques.shape[0]
    k = min(k, s)
    cf = cliques.to(torch.float32)
    sizes = cf.sum(1)
    sort_key = sizes
    if force_first:
        bump = torch.zeros_like(sizes)
        bump[0] = 1e9
        sort_key = sizes + bump
    order = torch.sort(-sort_key, stable=True).indices
    cf = cf[order]
    sizes = sizes[order]
    inter = _count_mm(cf, cf.T)                          # (S, S)
    host = torch.cat([inter, sizes[None]]).cpu().numpy()
    inter_h, sizes_h = host[:s], host[s]
    min_sz = np.minimum(sizes_h[:, None], sizes_h[None, :])
    frac = np.float32(min_distinct_frac)
    taken = np.zeros(s, bool)
    count = 0
    for i in range(s):
        conflict = taken & (inter_h[i] >= frac * np.maximum(min_sz[i],
                                                            np.float32(1.0)))
        # singletons (isolated seeds) carry no hypothesis: the reference
        # aborts on cliques <= 1 (include/quatro.hpp:809-813)
        ok = count < k and not conflict.any() and sizes_h[i] > 1
        taken[i] = ok
        count += int(ok)
    iota = np.arange(s)
    pick = np.argsort(np.where(taken, iota, s + iota), kind="stable")[:k]
    pick_order = torch.from_numpy(pick).to(cf.device)
    picked_sizes = torch.where(
        torch.arange(k, device=cf.device) < count, sizes[pick_order], 0.0)
    return cf[pick_order] > 0, picked_sizes


def select_inliers_with_candidates(adj: torch.Tensor, mask: torch.Tensor,
                                   kcore_threshold: float = 0.5,
                                   num_seeds: int = 16, max_size: int = 512,
                                   swap_rounds: int = 0, top: int = 8):
    """select_inliers(mode="clique") and the improved grown candidates,
    with the k-core, seed scores, growth and swaps computed once. Returns
    (sel (N,), valid (), grown (S, N)); the selection equals
    select_inliers' for top == 8."""
    max_core, kcore_mask = max_kcore(adj, mask)
    scores = kcore_mask.to(torch.float32) * 1e6 + _count_mm(adj, mask)
    grown = grow_greedy_cliques(adj, scores, mask, num_seeds=num_seeds,
                                max_size=max_size)
    grown = improve_top_cliques(adj, grown, mask, top=top,
                                rounds=swap_rounds)
    clique_sel = grown[torch.argmax(grown.sum(1))] & mask
    # an edgeless graph's largest core is the 0-core: select nothing
    kcore_sel = kcore_mask & mask & (max_core >= 1)
    n_valid = float(mask.sum())
    use_kcore = max_core >= 1 and max_core >= kcore_threshold * n_valid
    sel = kcore_sel if use_kcore else clique_sel
    return sel, sel.sum() > 1, grown


def select_inliers(adj: torch.Tensor, mask: torch.Tensor, mode: str = "clique",
                   kcore_threshold: float = 0.5, num_seeds: int = 16,
                   max_size: int = 512, swap_rounds: int = 0,
                   exact_cap: int = 64, exact_max_steps: int = 20000):
    """Dispatch over the inlier-selection modes of Quatro::Params
    (include/quatro.hpp:184-189,248). Returns (inlier_mask (N,) bool,
    valid () bool); valid is False when <= 1 vertex is selected (the
    reference aborts there, include/quatro.hpp:809-813)."""
    if mode == "exact":
        raise NotImplementedError(
            "inlier_selection_mode='exact' (branch-and-bound) is not "
            "ported yet")
    if mode == "clique":
        sel, valid, _ = select_inliers_with_candidates(
            adj, mask, kcore_threshold=kcore_threshold, num_seeds=num_seeds,
            max_size=max_size, swap_rounds=swap_rounds)
        return sel, valid
    if mode == "none":
        sel = mask
    else:
        max_core, kcore_mask = max_kcore(adj, mask)
        sel = kcore_mask & mask & (max_core >= 1)
    return sel, sel.sum() > 1
