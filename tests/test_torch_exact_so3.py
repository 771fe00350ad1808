"""The exact clique search and the SO(3) GNC as the JAX package runs them,
on the CPU: the port against the JAX package on the same numpy inputs.

- The exact search (``exact_max_clique_bb``: the restriction in batched
  torch operations, then ``ops.kernels.exact_clique``, whose CPU route is
  ``exact_clique_search_plain``, the JAX loop's body over the pair axis)
  against the JAX package's on tests/test_torch_reference_modes.py's
  fixtures, full and truncated: masks, ``completed`` and ``restricted``
  equal, and ``steps`` equal to ``host_dfs`` (tests/torch_clique_oracle.py),
  an independent Python-int walk of the same tree (a list as the stack). Also
  at caps of 150 and 256 (three and four 64-bit words in the kernel).
- The pair axis: B = 3 (the 40-inlier fixture, and uniform junk and the
  15-inlier fixture both truncated) in one call, each row equal to
  ``jax.vmap`` of the JAX function and to the call on that row alone;
  ``select_inliers(mode="exact")`` at B = 3 equal to its per-pair calls;
  the plain search's bits the same at loop chunks 1, 3 and its default.
- ``svd_rot3d`` (ops/kabsch.py's plain version here) bit for bit the JAX
  package's on random, planar, reflected, one- to three-point and
  zero-weight sets (within 1e-5 is the bar), det within 1e-5 of 1,
  exactly the identity at zero weight; each row of a batch equal to its
  own call. Its parts: the SVD's rotation of 1204 hard H against LAPACK's
  under the JAX package, and H against XLA's dot, bit for bit.
- The SO(3) GNC (GNC-TLS and FGR) at loop chunks 1, 2, 3 and 8 bit-equal,
  B = 3 rows plus a row with no valid correspondence; and bit for bit the
  JAX package's on the reference-modes fixtures and two one-ulp variants
  of each, where its FGR run on the 15-inlier fixture ends on an
  ill-conditioned H.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quatro_tpu.io.synthetic import make_correspondences
from quatro_tpu.solver import clique as jclique
from quatro_tpu.solver import rotation as jrot
from quatro_tpu.solver import scale as jscale
from quatro_tpu.utils.se3 import rotation_from_rpy as jax_rpy

from quatro_tpu_torch.ops import kabsch, kernels
from quatro_tpu_torch.solver import clique as tclique
from quatro_tpu_torch.solver import rotation as trot
from quatro_tpu_torch.utils import loops
from torch_clique_oracle import host_dfs

N = 500
FIXTURES = [(0, 100), (1, 40), (2, 15)]     # test_torch_reference_modes.py's
GNC_BOUND = 50


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _fixture(seed, n_in):
    """tests/test_torch_reference_modes.py's correspondences: n_in inliers
    of N, the last 7 slots padded."""
    src, tgt, _, _ = make_correspondences(
        seed=seed, n_inliers=n_in, n_outliers=N - n_in, yaw_deg=63.0,
        translation=(4.0, -2.5, 0.4))
    mask = np.ones(N, bool)
    mask[-7:] = False
    return src, tgt, mask


def _junk(seed=3):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    tgt = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    return src, tgt, rng.uniform(size=N) < 0.8


def _graph(src, tgt, mask):
    """The JAX package's consistency graph and greedy incumbent (numpy)."""
    adj = jscale.tim_consistency_graph(jnp.asarray(src), jnp.asarray(tgt),
                                       jnp.asarray(mask), 0.3,
                                       use_pallas=False)
    jm = jnp.asarray(mask)
    inc = jclique.greedy_cliques(adj, jclique.clique_seed_scores(adj, jm), jm)
    return np.asarray(adj), np.asarray(inc)


def _recorded_search(monkeypatch):
    """Record the restrictions ``exact_max_clique_bb`` hands the search."""
    calls = []
    real = kernels.exact_clique

    def rec(sub, vvalid, best0, max_steps):
        out = real(sub, vvalid, best0, max_steps)
        calls.append((sub.numpy(), vvalid.numpy(), best0.numpy(), max_steps,
                      [o.numpy() for o in out]))
        return out

    monkeypatch.setattr(kernels, "exact_clique", rec)
    return calls


def _assert_oracle(calls):
    """Every recorded search's rows against ``host_dfs``."""
    assert calls
    for sub, vvalid, best0, max_steps, (best, completed, steps) in calls:
        for b in range(sub.shape[0]):
            o_best, o_done, o_steps = host_dfs(sub[b], vvalid[b], best0[b],
                                                max_steps)
            np.testing.assert_array_equal(best[b], o_best)
            assert bool(completed[b]) == o_done
            assert int(steps[b]) == o_steps


# --------------------------------------------------------- exact search --

@pytest.mark.parametrize("cap,max_steps", [(64, 20000), (64, 40),
                                           (150, 20000), (256, 300)],
                         ids=["full", "truncated", "cap150", "cap256"])
@pytest.mark.parametrize("seed,n_in", FIXTURES)
def test_exact_search_matches_jax(seed, n_in, cap, max_steps, monkeypatch):
    src, tgt, mask = _fixture(seed, n_in)
    adj, inc = _graph(src, tgt, mask)
    ref = jclique.exact_max_clique_bb(jnp.asarray(adj), jnp.asarray(mask),
                                      incumbent=jnp.asarray(inc), cap=cap,
                                      max_steps=max_steps)
    calls = _recorded_search(monkeypatch)
    got, completed, restricted, steps = tclique.exact_max_clique_bb(
        _t(adj), _t(mask), incumbent=_t(inc), cap=cap, max_steps=max_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref[0]))
    assert bool(completed) == bool(ref[1])
    assert bool(restricted) == bool(ref[2])
    assert steps.dtype == torch.int32 and steps.shape == ()
    assert 0 < int(steps) <= max_steps
    _assert_oracle(calls)
    if not bool(completed):
        assert int(steps) == max_steps


def _three_pairs():
    """(adj, mask, incumbent) numpy stacks of the 40-inlier fixture,
    uniform junk and the 15-inlier fixture."""
    cases = [_fixture(1, 40), _junk(), _fixture(2, 15)]
    graphs = [_graph(*c) for c in cases]
    return (np.stack([g[0] for g in graphs]),
            np.stack([c[2] for c in cases]),
            np.stack([g[1] for g in graphs]))


# 59, 245 and 121 steps complete the three pairs: at 100 the 40-inlier
# fixture completes, the junk pair and the 15-inlier fixture are truncated
PAIR_MAX_STEPS = 100


def test_exact_search_pair_axis(monkeypatch):
    adj, mask, inc = _three_pairs()
    ref = jax.vmap(lambda a, m, i: jclique.exact_max_clique_bb(
        a, m, incumbent=i, max_steps=PAIR_MAX_STEPS))(
        jnp.asarray(adj), jnp.asarray(mask), jnp.asarray(inc))
    calls = _recorded_search(monkeypatch)
    got = tclique.exact_max_clique_bb(_t(adj), _t(mask), incumbent=_t(inc),
                                      max_steps=PAIR_MAX_STEPS)
    assert len(calls) == 1 and calls[0][0].shape[0] == 3   # one search
    for g, r in zip(got[:3], ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[1].tolist() == [True, False, False]
    assert got[3].tolist() == [59, PAIR_MAX_STEPS, PAIR_MAX_STEPS]
    _assert_oracle(calls)
    for b in range(3):
        one = tclique.exact_max_clique_bb(_t(adj[b]), _t(mask[b]),
                                          incumbent=_t(inc[b]),
                                          max_steps=PAIR_MAX_STEPS)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o), b


@pytest.mark.parametrize("chunk", [1, 3, None], ids=["1", "3", "default"])
def test_exact_search_bits_across_chunks(chunk):
    """The plain search at loop chunks 1 and 3 and its default
    (EXACT_CHUNK): the same bits, and one flag read per chunk."""
    adj, mask, inc = _three_pairs()
    args = (_t(adj), _t(mask))
    kw = dict(incumbent=_t(inc), max_steps=PAIR_MAX_STEPS)
    loops.reset_loops()
    with loops.eager_loops(chunk=1):
        ref = tclique.exact_max_clique_bb(*args, **kw)
    assert loops.LOOPS["exact_clique"]["reads"] == PAIR_MAX_STEPS
    loops.reset_loops()
    if chunk is None:
        got = tclique.exact_max_clique_bb(*args, **kw)
    else:
        with loops.eager_loops(chunk=chunk):
            got = tclique.exact_max_clique_bb(*args, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    # two pairs search to the bound: a read before each chunk, none after
    c = loops.LOOPS["exact_clique"]
    assert c["reads"] == -(-PAIR_MAX_STEPS // (chunk or kernels.EXACT_CHUNK))
    assert c["captures"] == c["replays"] == 0


def test_select_inliers_exact_pair_axis():
    src, tgt, mask = (np.stack(a) for a in zip(
        _fixture(1, 40), _junk(), _fixture(2, 15)))
    adj = np.stack([_graph(s, t, m)[0] for s, t, m in zip(src, tgt, mask)])
    sel, valid = tclique.select_inliers(_t(adj), _t(mask), mode="exact",
                                        exact_max_steps=PAIR_MAX_STEPS)
    assert sel.shape == (3, N) and valid.shape == (3,)
    for b in range(3):
        one_sel, one_valid = tclique.select_inliers(
            _t(adj[b]), _t(mask[b]), mode="exact",
            exact_max_steps=PAIR_MAX_STEPS)
        assert torch.equal(sel[b], one_sel) and bool(valid[b]) == bool(
            one_valid)
        ref_sel, ref_valid = jclique.select_inliers(
            jnp.asarray(adj[b]), jnp.asarray(mask[b]), mode="exact",
            exact_max_steps=PAIR_MAX_STEPS)
        np.testing.assert_array_equal(one_sel.numpy(), np.asarray(ref_sel))
        assert bool(one_valid) == bool(ref_valid)


def test_exact_clique_checks_its_inputs():
    sub = torch.zeros(2, 8, 8, dtype=torch.bool)
    vvalid = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(TypeError):
        kernels.exact_clique(sub.to(torch.uint8), vvalid, vvalid, 10)
    with pytest.raises(ValueError):
        kernels.exact_clique(sub, vvalid[:, :4], vvalid, 10)
    best, completed, steps = kernels.exact_clique(sub, vvalid, ~vvalid, 100)
    # an edgeless restriction: each single vertex is a clique, found first
    assert best.sum(-1).tolist() == [1, 1] and completed.all()
    assert steps.dtype == torch.int32


# ---------------------------------------------------------------- Kabsch --

def _kabsch_case(kind, seed):
    rng = np.random.default_rng(seed)
    src = rng.normal(0, 10, (200, 3)).astype(np.float32)
    if kind == "planar":
        src[:, 2] = 0.0
    rot = np.asarray(jax_rpy(0.3 * seed, -0.2, 1.0 + seed), np.float32)
    dst = (src @ rot.T + rng.normal(0, 0.05, (200, 3))).astype(np.float32)
    if kind == "reflected":
        dst[:, 2] *= -1.0
    w = rng.uniform(0, 1, 200).astype(np.float32)
    if kind == "few":                    # one, two or three weighted points
        w[1 + seed % 3:] = 0.0
    if kind == "zero":
        w[:] = 0.0
    return src, dst, w


def _trace(r, src, dst, w):
    """tr(R H), the objective the Kabsch rotation maximises, in f64."""
    h = (src * w[:, None]).astype(np.float64).T @ dst.astype(np.float64)
    return float(np.trace(r.astype(np.float64) @ h))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["random", "planar", "reflected", "few",
                                  "zero"])
def test_svd_rot3d_cases(kind, seed):
    """The JAX package's rotation bit for bit (within 1e-5 is the bar; the
    port repeats its rounding, ops/kabsch.py), det within 1e-5 of 1, the
    optimum's value of tr(R H), exactly the identity at zero weight. With
    one or two weighted points H is rank-deficient in f32, and the
    rotation is the one the SVD's rounding picks."""
    src, dst, w = _kabsch_case(kind, seed)
    ref = np.asarray(jrot.svd_rot3d(jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(w)))
    got = trot.svd_rot3d(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_array_equal(got, ref)
    assert abs(np.linalg.det(got.astype(np.float64)) - 1.0) < 1e-5
    best = _trace(ref, src, dst, w)
    assert abs(_trace(got, src, dst, w) - best) <= 1e-5 * max(abs(best), 1.0)
    if kind == "zero":
        np.testing.assert_array_equal(got, np.eye(3, dtype=np.float32))


def test_svd_rot3d_rows_are_their_own():
    cases = [_kabsch_case(k, s) for k in ("random", "planar", "reflected",
                                          "few", "zero") for s in (0, 1)]
    src, dst, w = (_t(np.stack(a)) for a in zip(*cases))
    batch = trot.svd_rot3d(src, dst, w)
    for b in range(len(cases)):
        assert torch.equal(batch[b], trot.svd_rot3d(src[b], dst[b], w[b]))


def _lapack_rotation(h):
    """The JAX package's rotation of H (its ``svd_rot3d`` after the
    product): jnp.linalg.svd, the determinant fix, V U^T."""
    u, _, vt = jnp.linalg.svd(h)
    v = vt.T
    det = jnp.linalg.det(u) * jnp.linalg.det(v)
    return v.at[:, 2].multiply(jnp.where(det < 0, -1.0, 1.0)) @ u.T


def _hard_h(count, seed):
    """3 x 3 H of the kinds where the SVD's rounding decides the rotation:
    random, near rank 2, rank 1, the FGR fixture's conditioning (singular
    values 572, 0.7, 0.2), diagonal, negated, graded (singular values
    spread over 1e-8..1), a zero row; then zero, I, -I, diag(1, 1, -1)."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(count):
        k = t % 8
        h = rng.normal(0, 100, (3, 3))
        if k == 1:
            h[:, 2] = h[:, 0] * 0.5 + h[:, 1] * 1e-4
        elif k == 2:
            h = np.outer(rng.normal(size=3), rng.normal(size=3)) * 50
        elif k == 3:
            h = np.diag([572.0, 0.7, 0.2]) @ np.linalg.qr(
                rng.normal(size=(3, 3)))[0]
        elif k == 4:
            h = np.diag(rng.normal(size=3))
        elif k == 5:
            h = -h
        elif k == 6:
            h = np.diag(rng.uniform(0, 1, 3) ** 8) @ np.linalg.qr(
                rng.normal(size=(3, 3)))[0] * 1e4
        elif k == 7:
            h[rng.integers(0, 3)] = 0.0
        out.append(h)
    out += [np.zeros((3, 3)), np.eye(3), -np.eye(3), np.diag([1, 1, -1])]
    return np.stack(out).astype(np.float32)


def test_svd_rotation_matches_lapack():
    """The SVD's rotation of 1204 H, one call for all rows, bit for bit
    the JAX package's (LAPACK's sgesdd): sbdsqr's sweeps run to 3 and more
    visits on some rows while others split at once."""
    h = _hard_h(1200, 5)
    ref = np.asarray(jax.jit(jax.vmap(_lapack_rotation))(jnp.asarray(h)))
    loops.reset_loops()
    got = kabsch.svd_rotation_plain(_t(h)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert loops.LOOPS["kabsch_sweeps"]["rounds"] >= 3


@pytest.mark.parametrize("n", [1, 2, 7, 500, 2000])
def test_weighted_cross_matches_xla_dot(n):
    """H as the JAX package's compiled dot forms it: fused multiply-adds
    in point order, per row and under vmap."""
    rng = np.random.default_rng(n)
    src, dst = (rng.normal(0, 10, (3, n, 3)).astype(np.float32)
                for _ in range(2))
    w = rng.uniform(0, 1, (3, n)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda s, d, ww: (s * ww[:, None]).T @ d))(src, dst, w))
    got = kabsch.weighted_cross_plain(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_kabsch_rotation_checks_its_inputs():
    src = torch.zeros(2, 5, 3)
    with pytest.raises(TypeError):
        kabsch.kabsch_rotation(src.double(), src.double(), torch.ones(2, 5))
    with pytest.raises(ValueError):
        kabsch.kabsch_rotation(src, src[:, :4], torch.ones(2, 5))
    with pytest.raises(ValueError):
        kabsch.kabsch_rotation(src, src, torch.ones(2, 4))
    assert kabsch.kabsch_rotation(src[:0], src[:0],
                                  torch.ones(0, 5)).shape == (0, 3, 3)
    eye = kabsch.kabsch_rotation(src, src, torch.zeros(2, 5))
    assert torch.equal(eye, torch.eye(3).expand(2, 3, 3))


# -------------------------------------------------------------- SO(3) GNC --

def _gnc_rows():
    """The 40- and 15-inlier fixtures, uniform junk, and a row with no
    valid correspondence (it stops at iteration 0, or 1 under FGR)."""
    cases = [_fixture(1, 40), _fixture(2, 15), _junk()]
    src, tgt, mask = (np.stack(a) for a in zip(*cases))
    src = np.concatenate([src, src[:1]])
    tgt = np.concatenate([tgt, tgt[:1]])
    mask = np.concatenate([mask, np.zeros_like(mask[:1])])
    return _t(src), _t(tgt), _t(mask)


@pytest.mark.parametrize("algorithm", ["GNC_TLS", "FGR"])
def test_so3_gnc_bits_across_chunks(algorithm):
    src, tgt, mask = _gnc_rows()
    name = "gnc_tls" if algorithm == "GNC_TLS" else "fgr_gm"
    out = {}
    for chunk in (1, 2, 3, 8):
        loops.reset_loops()
        with loops.eager_loops(chunk=chunk):
            out[chunk] = trot.gnc_rotation_3d(src, tgt, mask, 0.3,
                                              algorithm=algorithm)
        c = loops.LOOPS[name]
        assert c["rounds"] >= int(out[chunk].iterations.max()) - 1
        assert c["reads"] <= -(-(GNC_BOUND - 1) // chunk) + 1
    for chunk in (2, 3, 8):
        for a, b in zip(out[chunk], out[1]):
            assert torch.equal(a, b), chunk
    assert int(out[1].iterations[-1]) == 1 + (algorithm == "FGR")
    one = trot.gnc_rotation_3d(src[:1], tgt[:1], mask[:1], 0.3,
                               algorithm=algorithm)
    for a, b in zip(one, out[1]):
        assert torch.equal(a, b[:1])


def _one_ulp_variant(src, variant):
    """Variant 0: the fixture; 1, 2: one ulp flipped in five source
    coordinates, which moves the JAX package's FGR rotation on the
    15-inlier fixture by 8e-6 to 2.6e-5 (its last H has singular values
    572, 0.70 and 0.20)."""
    if variant == 0:
        return src
    rng = np.random.default_rng(variant)
    src = src.copy()
    idx = rng.integers(0, len(src), 5)
    up = np.sign(rng.normal(size=(5, 3))).astype(np.float32)
    src[idx] = np.nextafter(src[idx], np.float32(np.inf) * up)
    return src


@pytest.mark.parametrize("variant", [0, 1, 2])
@pytest.mark.parametrize("algorithm", ["GNC_TLS", "FGR"])
@pytest.mark.parametrize("seed,n_in", FIXTURES)
def test_so3_gnc_matches_jax_bit_for_bit(seed, n_in, algorithm, variant):
    """test_torch_reference_modes.py's rotation problem (no translation,
    roll and pitch), whose FGR run on the 15-inlier fixture ends on an
    ill-conditioned H: the rotation, the weights, the inliers and the
    iterations are the JAX package's bit for bit."""
    src, tgt, _, _ = make_correspondences(
        seed=seed, n_inliers=n_in, n_outliers=N - n_in, yaw_deg=63.0,
        translation=(0.0, 0.0, 0.0), roll_pitch=(0.03, -0.02))
    mask = np.ones(N, bool)
    mask[-7:] = False
    src = _one_ulp_variant(src, variant)
    ref = jrot.gnc_rotation_3d(jnp.asarray(src), jnp.asarray(tgt),
                               jnp.asarray(mask), 0.6, algorithm=algorithm)
    got = trot.gnc_rotation_3d(_t(src), _t(tgt), _t(mask), 0.6,
                               algorithm=algorithm)
    for name in ("rotation", "weights", "inlier_mask", "iterations"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
