"""The device loops (quatro_tpu_torch/utils/loops.py) and the solver's and
pose graph's loops built on them, on the CPU.

A ``while_chunks`` loop reads its flag once per chunk of rounds and a
``fori`` loop reads nothing; the rounds a chunk runs past a row's exit
leave the row as it was. So every loop gives the same bits at chunk 1
(one flag read per round, as the loops ran before) and at chunks 2, 3, 8
and one longer than its bound (``eager_loops(chunk=c)``), at B = 1 and at
B = 3 with a junk pair and a pair whose growth phase 1 hits its limit;
the counters show ``ceil``-many reads. ``max_kcore``, the growth, the
swaps and ``top_distinct_cliques`` are held against the JAX package's
functions exactly (integer counts and stable sorts on both sides), the
pose graph within 1e-5 where CG has converged (64 CG steps), as
tests/test_torch_sequence.py holds it. The CUDA-graph route is held
against ``eager_loops()`` on the card (tests/test_torch_kernels_gpu.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quatro_tpu.parallel import posegraph as jpg
from quatro_tpu.solver import clique as jclique

from quatro_tpu_torch.io.synthetic import make_correspondences
from quatro_tpu_torch.parallel import diagnostics
from quatro_tpu_torch.parallel import posegraph as tpg
from quatro_tpu_torch.parallel.diagnostics import collective_profile
from quatro_tpu_torch.solver import clique, rotation
from quatro_tpu_torch.solver.scale import tim_consistency_graph
from quatro_tpu_torch.utils import loops

N = 256                       # VLP-16's correspondence width
CHUNKS = (2, 3, 8)
GNC_BOUND = 50                # config.rotation_max_iterations


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(fn, chunk):
    """fn() under ``eager_loops(chunk)`` with fresh counters: (out, LOOPS)."""
    loops.reset_loops()
    with loops.eager_loops(chunk=chunk):
        out = fn()
    return out, {k: dict(v) for k, v in loops.LOOPS.items()}


def _assert_same(a, b, what):
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), what
        return
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        _assert_same(x, y, what)


def _chunk_reads(rounds: int, bound: int, chunk: int):
    """(reads, rounds run) of a while_chunks loop whose flag turns False
    after ``rounds`` rounds."""
    trips = reads = 0
    while trips < bound:
        reads += 1
        if trips >= rounds:
            break
        trips += min(chunk, bound - trips)
    return reads, trips


def _across_chunks(fn, bound):
    """fn's bits at chunks 2, 3, 8 and bound + 1 against chunk 1's, and
    each chunk's counters; returns (chunk 1's output, its counters)."""
    ref, count1 = _run(fn, 1)
    for chunk in (*CHUNKS, bound + 1):
        got, count = _run(fn, chunk)
        _assert_same(got, ref, chunk)
        for name, c in count.items():
            assert c["captures"] == c["replays"] == 0
            assert c["reads"] <= count1[name]["reads"], (name, chunk)
    return ref, count1


# ------------------------------------------------------------ the helper --

@pytest.mark.parametrize("chunk", [1, 2, 3, 8, 21])
@pytest.mark.parametrize("bound", [20, 5])
def test_while_chunks_reads_once_per_chunk(chunk, bound):
    """Rows counting down to 0 and stopping there: the flag is read before
    each chunk, a chunk never passes the bound, and the rounds past a
    row's exit keep it."""
    def body(consts, state):
        (step,) = consts
        x, live = state
        x = torch.where(live, x - step, x)
        return x, x > 0

    x0 = torch.tensor([0, 3, 7])
    loops.reset_loops()
    (x, live), trips = loops.while_chunks(
        "toy", body, lambda s: s[1].any(), (torch.tensor(1),),
        (x0, x0 > 0), bound, chunk)
    reads, want_trips = _chunk_reads(7, bound, chunk)
    assert trips == want_trips
    assert loops.LOOPS["toy"] == {"rounds": trips, "reads": reads,
                                  "captures": 0, "replays": 0}
    assert x.tolist() == [0, max(0, 3 - bound), max(0, 7 - bound)]
    assert x0.tolist() == [0, 3, 7]                 # inputs left alone


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_fori_reads_nothing(chunk):
    loops.reset_loops()
    (x,) = loops.fori("toy", lambda c, s: (s[0] * c[0],),
                      (torch.tensor(2),), (torch.tensor(1),), 7, chunk)
    assert int(x) == 2 ** 7
    assert loops.LOOPS["toy"] == {"rounds": 7, "reads": 0, "captures": 0,
                                  "replays": 0}


def test_a_body_closing_over_a_tensor_raises():
    """Its graph would read that tensor's memory on every later call."""
    t = torch.ones(3)
    with pytest.raises(TypeError, match="closes over a tensor"):
        loops.fori("toy", lambda c, s: (s[0] + t,), (), (torch.zeros(3),),
                   2, 1)
    with pytest.raises(TypeError, match="closes over a tensor"):
        loops.while_chunks("toy", lambda c, s: (s[0] + 1,),
                           lambda s: (s[0] < t).any(), (),
                           (torch.zeros(3),), 4, 2)


def test_collective_profiles_nest():
    """A capture profiles its own collectives inside the caller's profile
    (replays add them to every active one): the inner profile leaves the
    outer one active, though their counters compare equal."""
    seen = []

    def outer():
        collective_profile(lambda: None)
        seen.append(list(diagnostics.ACTIVE))

    counts = collective_profile(outer)
    assert len(seen[0]) == 1 and seen[0][0] is counts
    assert diagnostics.ACTIVE == []


def test_results_are_copied_out():
    """A second call with other inputs leaves the first call's result as
    it was (on the card the loops' static buffers are overwritten)."""
    src, dst, mask = _gnc_rows(1)
    src, dst = src[..., :2], dst[..., :2]
    first = rotation.gnc_rotation_2d(src, dst, mask, 0.3)
    kept = [t.clone() for t in first]
    second = rotation.gnc_rotation_2d(dst, src, mask, 0.3)
    _assert_same(list(first), kept, "first result")
    assert not torch.equal(first.rotation, second.rotation)


# ------------------------------------------------------------- fixtures --

def _pair(seed, n_in):
    src, tgt, _, _ = make_correspondences(
        seed=seed, n_inliers=n_in, n_outliers=N - n_in, yaw_deg=40.0 + seed,
        translation=(3.0, -1.5, 0.3))
    mask = np.ones(N, bool)
    mask[-5:] = False
    return src, tgt, mask


def _junk(seed):
    """Uniform junk: no rigid structure, small cliques only."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    tgt = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    return src, tgt, rng.uniform(size=N) < 0.6


def _batch(b):
    """b = 1: a pair of 60 inliers (its clique grows past phase 1's 8
    rounds); b = 3: that pair, uniform junk, and a pair of 12 inliers."""
    cases = [_pair(0, 60), _junk(1), _pair(2, 12)][:b]
    return tuple(torch.from_numpy(np.stack(a)) for a in zip(*cases))


def _graphs(b):
    src, tgt, mask = _batch(b)
    return tim_consistency_graph(src, tgt, mask, 0.3, 1.0), mask


def _gnc_rows(b):
    """The pairs of ``_batch`` as GNC rows, and at b = 3 a fourth row
    with no valid correspondence (stops at iteration 0)."""
    src, tgt, mask = _batch(b)
    if b > 1:
        src = torch.cat([src, src[:1]])
        tgt = torch.cat([tgt, tgt[:1]])
        mask = torch.cat([mask, torch.zeros_like(mask[:1])])
    return src, tgt, mask


# ------------------------------------------------------------- rotation --

@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("algorithm,dims", [("GNC_TLS", 2), ("FGR", 2),
                                            ("GNC_TLS", 3)])
def test_gnc_bits_across_chunks(algorithm, dims, b):
    src, tgt, mask = _gnc_rows(b)
    fn = rotation.gnc_rotation_2d if dims == 2 else rotation.gnc_rotation_3d
    name = "gnc_tls" if algorithm == "GNC_TLS" else "fgr_gm"

    def solve():
        return fn(src[..., :dims], tgt[..., :dims], mask, 0.3,
                  algorithm=algorithm)

    ref, count1 = _across_chunks(solve, GNC_BOUND - 1)
    rounds = count1[name]["rounds"]
    assert rounds == int(ref.iterations.max()) - 1
    assert count1[name]["reads"] == _chunk_reads(rounds, GNC_BOUND - 1, 1)[0]
    for chunk in (*CHUNKS, GNC_BOUND):
        _, count = _run(solve, chunk)
        assert (count[name]["reads"], count[name]["rounds"]) == \
            _chunk_reads(rounds, GNC_BOUND - 1, chunk), chunk
    if b > 1:
        # no valid correspondence: TLS stops at iteration 0, GM at 1
        assert int(ref.iterations[-1]) == 1 + (algorithm == "FGR")
        one, _ = _run(lambda: fn(src[:1, :, :dims], tgt[:1, :, :dims],
                                 mask[:1], 0.3, algorithm=algorithm), 1)
        _assert_same([t[:1] for t in ref], list(one), "row 0")


# -------------------------------------------------------------- cliques --

@pytest.mark.parametrize("b", [1, 3])
def test_max_kcore_bits_across_chunks_and_jax(b):
    adj, mask = _graphs(b)
    (k, core), count1 = _across_chunks(lambda: clique.max_kcore(adj, mask),
                                       100000)
    assert count1["max_kcore"]["reads"] == count1["max_kcore"]["rounds"] + 1
    for p in range(b):
        jk, jcore = jclique.max_kcore(jnp.asarray(adj[p].numpy()),
                                      jnp.asarray(mask[p].numpy()))
        assert int(k[p]) == int(jk)
        np.testing.assert_array_equal(core[p].numpy(), np.asarray(jcore))
    if b > 1:
        assert int(k[0]) > int(k[1])                # the junk pair's core


@pytest.mark.parametrize("seeds", [128, 16])
@pytest.mark.parametrize("b", [1, 3])
def test_grow_greedy_cliques_bits_across_chunks_and_jax(b, seeds):
    """128 seeds: both phases, the 60-inlier pair's phase 1 at its limit;
    16 seeds: one phase."""
    adj, mask = _graphs(b)
    scores = clique.clique_seed_scores(adj, mask)

    def grow():
        return clique.grow_greedy_cliques(adj, scores, mask,
                                          num_seeds=seeds, max_size=512)

    grown, _ = _across_chunks(grow, 511)
    largest = grown.sum(-1).amax(-1)
    assert int(largest[0]) > 9                      # past phase 1's 8 rounds
    for p in range(b):
        ref = jclique.grow_greedy_cliques(
            jnp.asarray(adj[p].numpy()), jnp.asarray(scores[p].numpy()),
            jnp.asarray(mask[p].numpy()), num_seeds=seeds, max_size=512)
        np.testing.assert_array_equal(grown[p].numpy(), np.asarray(ref))


def test_grow_greedy_cliques_phase_one_ending_early():
    """On the junk pair alone no seed has candidates after a few rounds:
    phase 1 ends before its limit, at another round count under each
    chunk, and phase 2 is a fixed point."""
    src, tgt, mask = (torch.from_numpy(a)[None] for a in _junk(1))
    adj = tim_consistency_graph(src, tgt, mask, 0.3, 1.0)
    scores = clique.clique_seed_scores(adj, mask)
    grown, count1 = _across_chunks(lambda: clique.grow_greedy_cliques(
        adj, scores, mask, num_seeds=128, max_size=512), 511)
    assert count1["grow_cliques"]["rounds"] < 8
    assert int(grown.sum(-1).max()) >= 2


@pytest.mark.parametrize("b", [1, 3])
def test_improve_cliques_1swap_across_chunks_and_jax(b):
    adj, mask = _graphs(b)
    start = clique.grow_greedy_cliques(adj, clique.clique_seed_scores(
        adj, mask), mask, num_seeds=16, max_size=8)      # room to improve
    out, count1 = _across_chunks(
        lambda: clique.improve_cliques_1swap(adj, start, mask, rounds=4), 4)
    assert count1["swap_cliques"] == {"rounds": 4, "reads": 0,
                                      "captures": 0, "replays": 0}
    assert int(out.sum(-1).max()) > int(start.sum(-1).max())
    for p in range(b):
        ref = jclique.improve_cliques_1swap(
            jnp.asarray(adj[p].numpy()), jnp.asarray(start[p].numpy()),
            jnp.asarray(mask[p].numpy()), rounds=4)
        np.testing.assert_array_equal(out[p].numpy(), np.asarray(ref))


def _clique_masks(seed, s=24, n=64):
    """Random clique masks with size ties (repeated rows), singletons, an
    empty row, and overlaps on both sides of min_distinct_frac."""
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(s, n)) < rng.uniform(0.05, 0.4, (s, 1))
    masks[3] = masks[1]                               # a tie, the same set
    masks[5] = np.roll(masks[1], 7)                   # a tie, another set
    masks[7] = masks[2] | masks[9]                    # overlaps
    masks[[10, 11]] = False
    masks[10, 4] = masks[11, 40] = True               # singletons
    masks[12] = False                                 # empty
    return masks


@pytest.mark.parametrize("k", [4, 8, 30])
@pytest.mark.parametrize("force_first", [False, True])
def test_top_distinct_cliques_against_jax(force_first, k):
    """Three pairs in one call: each pair's indices and sizes exactly the
    JAX package's, at every chunk; no copy to the host in between."""
    masks = np.stack([_clique_masks(s) for s in range(3)])
    batch = torch.from_numpy(masks)
    (picked, sizes), count1 = _across_chunks(
        lambda: clique.top_distinct_cliques(batch, k,
                                            force_first=force_first), 24)
    assert count1["top_distinct"]["reads"] == 0
    for p in range(3):
        ref_m, ref_s = jclique.top_distinct_cliques(
            jnp.asarray(masks[p]), k, force_first=force_first)
        np.testing.assert_array_equal(picked[p].numpy(), np.asarray(ref_m))
        np.testing.assert_array_equal(sizes[p].numpy(), np.asarray(ref_s))


# ----------------------------------------------------------- pose graph --

def _pose_graph(m=12, seed=7):
    """A 12-pose loop with four closures, noisy measurements and initial
    poses; the two edges at pose 4 masked (a component of its own)."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(m) / m
    gt = np.stack([6 * np.cos(ang) - 6, 6 * np.sin(ang), 0.1 * np.arange(m),
                   np.arctan2(np.cos(ang), -np.sin(ang))], 1)
    ei = np.int32(list(range(m - 1)) + [0, 2, 7, 8])
    ej = np.int32(list(range(1, m)) + [11, 9, 10, 11])
    c, s = np.cos(gt[ei, 3]), np.sin(gt[ei, 3])
    d = gt[ej, :3] - gt[ei, :3]
    t = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                  d[:, 2]], 1) + rng.normal(0, 0.05, (len(ei), 3))
    dy = gt[ej, 3] - gt[ei, 3]
    y = np.arctan2(np.sin(dy), np.cos(dy)) + rng.normal(0, 0.01, len(ei))
    mask = np.ones(len(ei), bool)
    mask[[3, 4]] = False
    arrays = (ei, ej, t.astype(np.float32), y.astype(np.float32),
              rng.uniform(5, 100, len(ei)).astype(np.float32), mask)
    p0 = (gt + rng.normal(0, 0.3, gt.shape)).astype(np.float32)
    p0[0] = gt[0]
    return (p0, jpg.PoseGraphEdges(*(jnp.asarray(a) for a in arrays)),
            tpg.PoseGraphEdges(*(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in arrays)))


@pytest.mark.parametrize("gn,cg,tol", [(8, 64, 1e-5), (10, 40, 1e-3)])
def test_optimize_pose_graph_across_chunks_and_jax(gn, cg, tol):
    p0, je, te = _pose_graph()
    got, count1 = _across_chunks(lambda: tpg.optimize_pose_graph(
        torch.from_numpy(p0), te, 12, gn_iters=gn, cg_iters=cg), gn)
    assert count1["pose_graph"] == {"rounds": gn, "reads": 0,
                                    "captures": 0, "replays": 0}
    ref = np.asarray(jpg.optimize_pose_graph(jnp.asarray(p0), je, 12,
                                             gn_iters=gn, cg_iters=cg))
    np.testing.assert_allclose(got.numpy(), ref, atol=tol)
    np.testing.assert_array_equal(got.numpy()[[0, 4]], p0[[0, 4]])
    assert math.isfinite(float(got.abs().max()))
