"""The clique stage's four wrappers (quatro_tpu_torch/ops/cliques.py:
``kcore_search``, ``grow_cliques``, ``swap_cliques``,
``distinct_cliques``) on the CPU, where each runs its plain version,
through the public functions of ``solver/clique.py``: against the JAX
package's functions (quatro_tpu/solver/clique.py) per pair, and against
tests/torch_clique_oracle.py's host walks of the kernels
(csrc/cliques.cu), which take each pair and each seed to its own exit.
Exactly: k, masks, indices and sizes.

The graphs: N = 1, 33 and 100 (not multiples of 32), an all-False mask,
an edgeless graph, a complete graph (the growth's early completion), a
graph with self loops (a seed counted twice), an asymmetric graph (a
degree down a column), a batch of three consistency graphs with a junk
pair, and for the swap a clique with 195 miss-one vertices whose only
swap pair lies past the first 128 (truncated) or inside them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quatro_tpu.solver import clique as jclique

from quatro_tpu_torch.ops import cliques as tcl
from quatro_tpu_torch.ops import launch
from quatro_tpu_torch.solver import clique

from torch_clique_cases import (GRAPHS, GROW, distinct_case, graph_case,
                                miss_one_batch)
from torch_clique_oracle import host_distinct, host_grow, host_kcore, host_swap


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("name", GRAPHS)
def test_max_kcore_and_degrees(name):
    adj, mask = graph_case(name)
    k, core = clique.max_kcore(_t(adj), _t(mask))
    lo, core2, deg, packed = tcl.kcore_search(_t(adj), _t(mask))
    assert packed is None                       # the CPU's plain route
    assert torch.equal(lo, k) and torch.equal(core2, core)
    assert lo.dtype == torch.int64 and deg.dtype == torch.float32
    for b in range(len(adj)):
        jk, jcore = jclique.max_kcore(_j(adj[b]), _j(mask[b]))
        hk, hcore, hdeg = host_kcore(adj[b], mask[b])
        assert int(k[b]) == int(jk) == hk
        np.testing.assert_array_equal(core[b].numpy(), np.asarray(jcore))
        np.testing.assert_array_equal(core[b].numpy(), hcore)
        np.testing.assert_array_equal(deg[b].numpy(), hdeg.astype(np.float32))
    if name == "junk_batch":
        assert int(k[0]) > int(k[1])


@pytest.mark.parametrize("name,cfg", [
    ("n1", "one_phase"), ("n33", "two_phase"), ("n100", "two_phase"),
    ("mask_off", "two_phase"), ("edgeless", "one_phase"),
    ("complete", "one_phase"), ("complete", "cap5"), ("n100", "cap5"),
    ("loops", "two_phase"), ("asym", "two_phase"),
    ("junk_batch", "shipping")])
def test_grow_greedy_cliques(name, cfg):
    """Seeds from the port's seed scores; one phase where num_seeds <=
    survivors; the complete graph absorbed whole in round one (or, at
    max_size 5, grown to the cap one vertex a round)."""
    adj, mask = graph_case(name)
    kw = GROW[cfg]
    scores = clique.clique_seed_scores(_t(adj), _t(mask))
    grown = clique.grow_greedy_cliques(_t(adj), scores, _t(mask), **kw)
    n = adj.shape[-1]
    assert grown.shape == (len(adj), min(kw["num_seeds"], n), n)
    tiebreak = tcl._tiebreak(n, torch.device("cpu")).numpy()
    for b in range(len(adj)):
        ref = jclique.grow_greedy_cliques(_j(adj[b]), _j(scores[b].numpy()),
                                          _j(mask[b]), **kw)
        np.testing.assert_array_equal(grown[b].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(grown[b].numpy(), host_grow(
            adj[b], scores[b].numpy(), mask[b], tiebreak=tiebreak, **kw))
    sizes = grown.sum(-1)
    if name == "complete":
        assert int(sizes.max()) == (5 if cfg == "cap5" else 40)
    if cfg == "cap5":
        assert int(sizes.max()) <= 5
    if name == "mask_off":                      # seeds only, no growth
        assert torch.equal(sizes, torch.ones_like(sizes))


@pytest.mark.parametrize("name", ["n1", "n33", "n100", "loops", "asym",
                                  "junk_batch", "miss_one"])
def test_improve_top_cliques(name):
    """The swap on the top 8 of each pair's grown cliques (grown to at most
    eight vertices, so that there is room), or on the miss-one graphs'
    three rows; 4 rounds."""
    if name == "miss_one":
        adj, mask, start = miss_one_batch()
        start = _t(start)
    else:
        adj, mask = graph_case(name)
        start = clique.grow_greedy_cliques(
            _t(adj), clique.clique_seed_scores(_t(adj), _t(mask)), _t(mask),
            num_seeds=16, max_size=8)
    out = clique.improve_top_cliques(_t(adj), start, _t(mask), top=8,
                                     rounds=4)
    for b in range(len(adj)):
        ref = jclique.improve_top_cliques(_j(adj[b]), _j(start[b].numpy()),
                                          _j(mask[b]), top=8, rounds=4)
        np.testing.assert_array_equal(out[b].numpy(), np.asarray(ref))
        np.testing.assert_array_equal(out[b].numpy(), host_swap(
            adj[b], start[b].numpy(), mask[b], 8, 4))
    if name == "miss_one":
        # graph 0: the pair lies past the truncation, so nothing moves;
        # graph 1: (10, 15) replaces member 0, the clique grows by one
        assert torch.equal(out[0, 0], start[0, 0])
        assert out[1, 0].nonzero().flatten().tolist() == [1, 2, 3, 4, 10, 15]


@pytest.mark.parametrize("name,k", [("random", 4), ("random", 8),
                                    ("singletons", 4), ("all_false", 4)])
@pytest.mark.parametrize("force_first", [False, True])
def test_top_distinct_cliques(name, k, force_first):
    rows = distinct_case(name)
    masks, sizes = clique.top_distinct_cliques(_t(rows), k,
                                               force_first=force_first)
    for b in range(len(rows)):
        jm, js = jclique.top_distinct_cliques(_j(rows[b]), k,
                                              force_first=force_first)
        hm, hs = host_distinct(rows[b], k, 0.5, force_first)
        np.testing.assert_array_equal(masks[b].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(sizes[b].numpy(), np.asarray(js))
        np.testing.assert_array_equal(masks[b].numpy(), hm)
        np.testing.assert_array_equal(sizes[b].numpy(), hs)
    if name == "singletons":                    # nothing taken, row 0 first
        assert not sizes.any()
        assert bool(masks[0, 0, 0]) == force_first or not force_first


@pytest.mark.parametrize("name", ["n33", "junk_batch"])
def test_greedy_and_exact_on_shared_seed_scores(name):
    """``clique_seed_scores_and_bits``: the seed scores (no bits on the
    CPU) for one graph and for the batch; the greedy clique on them
    against the JAX package's per pair, and the exact search given them
    equal to the one that computes its own."""
    adj, mask = (_t(a) for a in graph_case(name))
    scores, packed = clique.clique_seed_scores_and_bits(adj, mask)
    assert packed is None
    assert torch.equal(scores, clique.clique_seed_scores(adj, mask))
    greedy = clique.greedy_cliques(adj, scores, mask, swap_rounds=2,
                                   packed=packed)
    for b in range(len(adj)):
        one, none = clique.clique_seed_scores_and_bits(adj[b], mask[b])
        assert none is None and torch.equal(one, scores[b])
        ref = jclique.greedy_cliques(_j(adj[b]), _j(scores[b].numpy()),
                                     _j(mask[b]), swap_rounds=2)
        np.testing.assert_array_equal(greedy[b].numpy(), np.asarray(ref))
    given = clique.exact_max_clique_bb(adj, mask, incumbent=greedy,
                                       seed_scores=scores)
    own = clique.exact_max_clique_bb(adj, mask, incumbent=greedy)
    assert all(torch.equal(g, o) for g, o in zip(given, own))


@pytest.mark.parametrize("name", ["n1", "mask_off", "edgeless", "complete",
                                  "junk_batch"])
def test_select_inliers_with_candidates(name):
    adj, mask = graph_case(name)
    seeds = 128 if name == "junk_batch" else 16
    sel, valid, grown = clique.select_inliers_with_candidates(
        _t(adj), _t(mask), num_seeds=seeds, swap_rounds=2, top=8)
    for b in range(len(adj)):
        js, jv, jg = jclique.select_inliers_with_candidates(
            _j(adj[b]), _j(mask[b]), num_seeds=seeds, swap_rounds=2, top=8)
        np.testing.assert_array_equal(sel[b].numpy(), np.asarray(js))
        assert bool(valid[b]) == bool(jv)
        np.testing.assert_array_equal(grown[b].numpy(), np.asarray(jg))
    if name in ("mask_off", "edgeless", "n1"):
        assert not valid.any()
    if name == "complete":
        assert int(sel.sum()) == 40


def test_wrappers_check_their_inputs_and_count_no_cpu_launch():
    """Shapes, dtypes and contiguity are checked before the route is
    chosen; the CPU's plain route launches nothing."""
    adj, mask = (_t(a) for a in graph_case("n33"))
    scores = clique.clique_seed_scores(adj, mask)
    launch.reset_launches()
    with pytest.raises(ValueError):
        tcl.kcore_search(adj[0], mask[0])
    with pytest.raises(ValueError):
        tcl.kcore_search(adj.transpose(-1, -2), mask)
    with pytest.raises(TypeError):
        tcl.grow_cliques(adj, scores.double(), mask)
    with pytest.raises(ValueError):
        tcl.swap_cliques(adj, adj[:, :3, :2], mask)
    with pytest.raises(TypeError):
        tcl.distinct_cliques(adj.float(), 4)
    tcl.grow_cliques(adj, scores, mask)
    tcl.distinct_cliques(adj, 4)
    assert all(launch.LAUNCHES[k] == 0 for k in tcl.KIND)
