"""The graphs and clique rows that the clique stage's kernels
(quatro_tpu_torch/ops/cliques.py, csrc/cliques.cu) are held on: against
the JAX package and the host walks on the CPU (tests/test_torch_cliques.py)
and against their plain versions on the card
(tests/test_torch_kernels_gpu.py). Imports no JAX."""

import contextlib

import numpy as np
import torch

from quatro_tpu_torch.io.synthetic import make_correspondences
from quatro_tpu_torch.solver.scale import tim_consistency_graph


def planted(n, p, k, seed, diag=False, sym=True):
    """A random graph of edge density p with a planted clique of k."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(n, n)) < p
    if sym:
        a = np.triu(a, 1)
        a = a | a.T
    idx = rng.choice(n, k, replace=False)
    a[np.ix_(idx, idx)] = True
    np.fill_diagonal(a, diag)
    return a


def consistency_batch():
    """Three pairs of 100 correspondences: 30 inliers, uniform junk, 10
    inliers; the last five slots masked off."""
    rng = np.random.default_rng(5)
    cases = []
    for seed, n_in in ((0, 30), (1, 0), (2, 10)):
        if n_in:
            src, tgt, _, _ = make_correspondences(
                seed=seed, n_inliers=n_in, n_outliers=100 - n_in,
                yaw_deg=30.0 + seed, translation=(2.0, -1.0, 0.2))
        else:
            src, tgt = (rng.uniform(-20, 20, (100, 3)).astype(np.float32)
                        for _ in range(2))
        cases.append((src, tgt))
    src, tgt = (torch.from_numpy(np.stack(a)) for a in zip(*cases))
    mask = torch.from_numpy(np.arange(100) < 95).expand(3, -1).contiguous()
    return tim_consistency_graph(src, tgt, mask, 0.3, 1.0).numpy(), \
        mask.numpy()


def graph_case(name):
    """(adj (B, N, N), mask (B, N)) numpy bool."""
    rng = np.random.default_rng(11)
    if name == "junk_batch":
        return consistency_batch()
    if name == "n1":
        adj, mask = np.zeros((1, 1), bool), np.ones(1, bool)
    elif name == "n33":
        adj, mask = planted(33, 0.3, 8, 1), rng.uniform(size=33) < 0.9
    elif name == "n100":
        adj, mask = planted(100, 0.1, 20, 2), rng.uniform(size=100) < 0.9
    elif name == "mask_off":
        adj, mask = planted(40, 0.3, 10, 3), np.zeros(40, bool)
    elif name == "edgeless":
        adj, mask = np.zeros((40, 40), bool), np.ones(40, bool)
    elif name == "complete":
        adj, mask = ~np.eye(40, dtype=bool), np.ones(40, bool)
    elif name == "loops":
        adj, mask = planted(50, 0.2, 12, 4, diag=True), np.ones(50, bool)
    elif name == "asym":
        adj, mask = planted(48, 0.35, 9, 6, sym=False), np.ones(48, bool)
    else:
        raise KeyError(name)
    return adj[None], mask[None]


GRAPHS = ["n1", "n33", "n100", "mask_off", "edgeless", "complete", "loops",
          "asym", "junk_batch"]


GROW = {"one_phase": dict(num_seeds=16, max_size=512, phase1_rounds=8,
                          survivors=16),
        "two_phase": dict(num_seeds=32, max_size=512, phase1_rounds=2,
                          survivors=4),
        "cap5": dict(num_seeds=32, max_size=5, phase1_rounds=2, survivors=4),
        "shipping": dict(num_seeds=128, max_size=512, phase1_rounds=8,
                         survivors=16)}


def miss_one_batch():
    """Two graphs of 200 vertices: a clique {0..4}; every other vertex j
    adjacent to the clique but member j % 5; among those only one edge,
    (150, 155) in graph 0 (both miss member 0, past the first 128 miss-one
    vertices: no swap), (150, 155) and (10, 15) in graph 1 (a swap)."""
    n = 200
    adj = np.zeros((2, n, n), bool)
    for g in range(2):
        a = adj[g]
        a[:5, :5] = True
        for j in range(5, n):
            for m in range(5):
                a[j, m] = a[m, j] = m != j % 5
        for u, v in ((150, 155),) + (((10, 15),) if g else ()):
            a[u, v] = a[v, u] = True
        np.fill_diagonal(a, False)
    cliques = np.zeros((2, 3, n), bool)
    cliques[:, 0, :5] = True
    cliques[:, 1, 5] = True
    cliques[:, 2, [150, 155]] = True
    return adj, np.ones((2, n), bool), cliques


def clique_rows(seed, s=24, n=70):
    """Random clique masks with size ties, singletons, an empty row and
    overlaps on both sides of min_distinct_frac."""
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(s, n)) < rng.uniform(0.05, 0.4, (s, 1))
    masks[3] = masks[1]
    masks[5] = np.roll(masks[1], 7)
    masks[7] = masks[2] | masks[9]
    masks[[10, 11]] = False
    masks[10, 4] = masks[11, 40] = True
    masks[12] = False
    return masks


def distinct_case(name):
    if name == "random":
        return np.stack([clique_rows(s) for s in range(3)])
    if name == "singletons":                    # every row one vertex
        return np.eye(9, 33, dtype=bool)[None]
    if name == "all_false":                     # the vote's empty rows
        rows = np.zeros((2, 6, 33), bool)
        rows[1, 2, :5] = True
        return rows
    raise KeyError(name)


def wide_graphs(bsz, n, dev, seed=0):
    """bsz consistency graphs of n correspondences on ``dev`` (the main
    path's width at n = 1024): pair b has 10 + (37 b) % 90 inliers among
    outliers, every fourth pair pure junk, the last 1 + b % 7 slots masked
    off. Returns (adj (B, n, n), mask (B, n)) bool, contiguous."""
    rng = np.random.default_rng(seed)
    src = np.empty((bsz, n, 3), np.float32)
    tgt = np.empty((bsz, n, 3), np.float32)
    for b in range(bsz):
        n_in = 0 if b % 4 == 3 else 10 + (37 * b) % 90
        if n_in:
            s, t, _, _ = make_correspondences(
                seed=seed + b, n_inliers=n_in, n_outliers=n - n_in,
                yaw_deg=10.0 + b, translation=(2.0, -1.0, 0.1))
        else:
            s, t = (rng.uniform(-30, 30, (n, 3)) for _ in range(2))
        src[b], tgt[b] = s, t
    mask = np.arange(n)[None, :] < n - 1 - np.arange(bsz)[:, None] % 7
    src, tgt, mask = (torch.from_numpy(a).to(dev) for a in (src, tgt, mask))
    return (tim_consistency_graph(src, tgt, mask, 0.3, 1.0).contiguous(),
            mask.contiguous())


def clique_stage_calls(adj, mask, tcl, kernels):
    """The clique stage's wrapper calls on one batch, each on the outputs
    of the ones before: the k-core search, the growth under
    recommended() (128 seeds, 8 phase-1 rounds, 16 survivors, max 512) on
    the k-core search's packed graph, one phase (16 seeds), capped at 8
    vertices (room to swap), the swaps (2 rounds on the top 8, 4 rounds on
    the capped cliques) and the distinct greedy (K = 4 with force_first; 8
    without). ``kernels`` False: the plain versions on the same inputs.
    Returns {call: outputs}."""
    out = {}
    if kernels:
        lo, core, deg, packed = tcl.kcore_search(adj, mask)
        kw = {"packed": packed}
    else:
        lo, core, deg = tcl.kcore_search_plain(adj, mask)
        kw = {}
    out["kcore_search"] = (lo, core, deg)
    scores = core.to(torch.float32) * 1e6 + deg
    grow = tcl.grow_cliques if kernels else tcl.grow_cliques_plain
    swap = tcl.swap_cliques if kernels else tcl.swap_cliques_plain
    distinct = tcl.distinct_cliques if kernels else tcl.distinct_cliques_plain
    out["grow"] = (grow(adj, scores, mask, 128, 512, 8, 16, **kw),)
    out["grow_one_phase"] = (grow(adj, scores, mask, 16, 512, 8, 16, **kw),)
    out["grow_cap8"] = (grow(adj, scores, mask, 32, 8, 2, 4, **kw),)
    out["swap"] = (swap(adj, out["grow"][0], mask, 8, 2, **kw),)
    out["swap_cap8"] = (swap(adj, out["grow_cap8"][0], mask, 8, 4, **kw),)
    rows = torch.cat([out["swap"][0][:, -1:], out["swap"][0]], 1)
    out["distinct"] = distinct(rows.contiguous(), 4, 0.5, True)
    out["distinct_k8"] = distinct(out["swap_cap8"][0], 8)
    return out


@contextlib.contextmanager
def plain_clique_route():
    """``solver/clique.py`` through the plain versions of its four
    wrappers (ops/cliques.py) whatever the tensors' device: the route the
    kernels replace, for holding them against it on the card."""
    from quatro_tpu_torch.ops import cliques as tcl
    from quatro_tpu_torch.solver import clique

    names = ("kcore_search", "grow_cliques", "swap_cliques",
             "distinct_cliques")
    saved = {k: getattr(clique, k) for k in names}

    def kcore(adj, mask):
        return (*tcl.kcore_search_plain(adj, mask), None)

    def grow(adj, scores, mask, num_seeds=16, max_size=512,
             phase1_rounds=8, survivors=16, packed=None):
        return tcl.grow_cliques_plain(adj, scores, mask, num_seeds,
                                      max_size, phase1_rounds, survivors)

    def swap(adj, cliques, mask, top=8, rounds=4, packed=None):
        return tcl.swap_cliques_plain(adj, cliques, mask, top, rounds)

    def distinct(cliques, k, min_distinct_frac=0.5, force_first=False):
        return tcl.distinct_cliques_plain(cliques, k, min_distinct_frac,
                                          force_first)

    for k, fn in zip(names, (kcore, grow, swap, distinct)):
        setattr(clique, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(clique, k, fn)
