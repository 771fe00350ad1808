"""The reference matcher's 1-NN branches and the solver modes off the
shipping path: the port against the JAX package on the same numpy inputs.

- B6, ``nearest_neighbors``: its plain version against the JAX package's
  Pallas kernel (``interpret=True``) and its XLA 1-NN, on descriptors on a
  1/8 grid (every product and partial sum is then an exact f32, so the
  distances are exact in any summation order, ROADMAP C "Descriptor
  distances"), with planted ties, masked rows and columns and an
  all-invalid B: indices equal, d2 equal (within 0). A valid row with no
  valid column gets index 0 and a big d2 everywhere: f32 max in the port
  and the XLA path, the Pallas kernel's initial 3.4e38 there. The plain
  version equals the first slot of the top-2 plain version bit for bit
  on any descriptors.
- ``match_features`` with ``crosscheck_min_matches=0`` (the reference's
  crosscheck and tuple test) and with ``use_crosscheck=False`` (its
  one-directional union), on grid descriptors: the same correspondences
  slot for slot, found without the top-2 search.
- FGR (2-D and 3-D), ``gnc_rotation_3d``, ``svd_rot3d``: rotations within
  1e-5; ``solve_scale_tls``: scale within 1e-6 relative, adjacency equal
  but for pairs within 1e-6 of their bound; ``exact_max_clique_bb``:
  masks, ``completed`` and ``restricted`` equal (also when truncated).
- ``register_correspondences`` under each mode: validity equal, poses
  within the 3 deg / 1.5 m drift band (tests/golden_specs.py; measured
  within 1.3e-5 of each other) and clique masks equal;
  ``register_hypotheses`` under "exact": hypothesis 0 equal.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io.synthetic import make_correspondences
from quatro_tpu.ops import matching as jmatch
from quatro_tpu.ops import pallas_frontend as jpf
from quatro_tpu.solver import clique as jclique
from quatro_tpu.solver import rotation as jrot
from quatro_tpu.solver import scale as jscale
from quatro_tpu.solver.quatro import register_correspondences as jax_solve
from quatro_tpu.solver.quatro import register_hypotheses as jax_hypotheses
from quatro_tpu.utils.se3 import rotation_from_rpy as jax_rpy

import quatro_tpu_torch.config as tcfg
from quatro_tpu_torch.ops import frontend as tf
from quatro_tpu_torch.ops import matching as tmatch
from quatro_tpu_torch.solver import clique as tclique
from quatro_tpu_torch.solver import rotation as trot
from quatro_tpu_torch.solver import scale as tscale
from quatro_tpu_torch.solver.quatro import (register_correspondences,
                                            register_hypotheses)
from quatro_tpu_torch.utils.se3 import rotation_geodesic_error

FLT_MAX = np.finfo(np.float32).max
ROT_BAND_DEG, TRANS_BAND_M = 3.0, 1.5
N = 500
FIXTURES = [(0, 100), (1, 40), (2, 15)]
MODES = {
    "teaser": dict(reg_name="TEASER"),
    "fgr": dict(rotation_estimation_algorithm="FGR"),
    "teaser_fgr": dict(reg_name="TEASER", rotation_estimation_algorithm="FGR"),
    "tls_scale": dict(estimate_scaling=True),
    "exact": dict(inlier_selection_mode="exact"),
}


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))          # a copy: may be read-only


# ------------------------------------------------------------------ B6 ---

def _grid_descriptors(na, nb, seed):
    """33-D descriptors on a 1/8 grid in [0, 12) (|a|^2 < 2^24 / 64, so
    the expansion is exact), with planted ties: B columns 101 and (where
    Nb allows) 3000 copy column 100, A rows 0..19 copy it, A rows 20..29
    copy column 7; 10 % of rows and columns masked."""
    rng = np.random.default_rng(seed)
    da = (rng.integers(0, 96, (na, 33)) / 8.0).astype(np.float32)
    db = (rng.integers(0, 96, (nb, 33)) / 8.0).astype(np.float32)
    db[101] = db[100]
    if nb > 3000:
        db[3000] = db[100]
    da[:20] = db[100]
    da[20:30] = db[7]
    ma = rng.uniform(size=na) > 0.1
    mb = rng.uniform(size=nb) > 0.1
    ma[:30] = True
    mb[[7, 100, 101]] = True
    return da, db, ma, mb


@pytest.mark.parametrize("na,nb", [(512, 4096), (256, 2048), (512, 1000)],
                         ids=["two_chunks", "one_chunk", "ragged"])
def test_nearest_neighbors_matches_pallas(na, nb):
    da, db, ma, mb = _grid_descriptors(na, nb, seed=nb)
    pal_i, pal_d = (np.asarray(x) for x in jpf.nearest_neighbors_pallas(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
        interpret=True))
    xla_i, xla_d = (np.asarray(x) for x in jmatch._nearest_neighbors(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb)))
    idx, d2 = (x[0].numpy() for x in tf.nearest_neighbors(
        _t(da)[None], _t(db)[None], _t(ma)[None], _t(mb)[None]))
    np.testing.assert_array_equal(idx, pal_i)
    np.testing.assert_array_equal(idx, xla_i)
    np.testing.assert_array_equal(d2, pal_d)
    np.testing.assert_array_equal(d2, xla_d)
    # ties: the first minimum (column 100 before its copies 101 and 3000)
    assert (idx[:20] == 100).all() and (d2[:20] == 0).all()
    assert (idx[20:30] == 7).all()
    assert (idx[~ma] == 0).all() and (d2[~ma] == FLT_MAX).all()


def test_nearest_neighbors_no_valid_column():
    """An all-invalid B: index 0 for every row; d2 f32 max in the port and
    the XLA path, the Pallas kernel's initial 3.4e38 there."""
    da, db, ma, _ = _grid_descriptors(256, 2048, seed=3)
    mb = np.zeros(2048, bool)
    pal_i, pal_d = (np.asarray(x) for x in jpf.nearest_neighbors_pallas(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
        interpret=True))
    xla_i, xla_d = (np.asarray(x) for x in jmatch._nearest_neighbors(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb)))
    idx, d2 = (x[0].numpy() for x in tf.nearest_neighbors(
        _t(da)[None], _t(db)[None], _t(ma)[None], _t(mb)[None]))
    assert (idx == 0).all() and (pal_i == 0).all() and (xla_i == 0).all()
    np.testing.assert_array_equal(d2, xla_d)
    assert (d2 == FLT_MAX).all()
    assert (pal_d[ma] == np.float32(3.4e38)).all()


@pytest.mark.parametrize("nb", [4096, 3072])
def test_nearest_neighbors_plain_is_top2_first_slot(nb):
    """On raw (off-grid) descriptors the 1-NN plain version and the first
    slot of the top-2 plain version are the same bits: both take their
    distances from one function and the first minimum."""
    rng = np.random.default_rng(nb)
    da = _t(rng.uniform(0, 100, (2, 512, 33)).astype(np.float32))
    db = _t(rng.uniform(0, 100, (2, nb, 33)).astype(np.float32))
    db[:, 2500] = db[:, 10]
    da[:, :5] = db[:, 10:11]
    ma = _t(rng.uniform(size=(2, 512)) > 0.1)
    mb = _t(rng.uniform(size=(2, nb)) > 0.1)
    ma[:, :5] = True
    mb[:, [10, 2500]] = True
    idx, d2 = tf.nearest_neighbors(da, db, ma, mb)
    i1, d1, _, _ = tf.nearest_neighbors2(da, db, ma, mb)
    assert torch.equal(idx, i1) and torch.equal(d2, d1)
    assert (idx[:, :5] == 10).all()


def test_nearest_neighbors_rejects_bad_inputs():
    d = torch.zeros(1, 256, 33)
    m = torch.ones(1, 256, dtype=torch.bool)
    with pytest.raises(ValueError):
        tf.nearest_neighbors(d, d, m, torch.ones(1, 128, dtype=torch.bool))
    with pytest.raises(TypeError):
        tf.nearest_neighbors(d.double(), d, m, m)
    before = dict(tf.LAUNCHES)
    tf.nearest_neighbors(d, d, m, m)
    assert tf.LAUNCHES == before        # the plain version launches nothing


# ------------------------------------------------------------- matcher ---

@pytest.fixture(scope="module")
def grid_features():
    """512 source and 640 target keypoints; 300 targets are the rotated
    and shifted sources, their descriptors the sources' with a few
    components moved by one grid step (so nearest neighbours and mutual
    pairs are not trivial); the rest random. Descriptors on the 1/8
    grid, 5 % of keypoints masked."""
    rng = np.random.default_rng(21)
    na, nb, m = 512, 640, 300
    src = rng.uniform(-30, 30, (na, 3)).astype(np.float32)
    rot = np.asarray(jax_rpy(0.0, 0.0, 0.6), np.float32)
    tgt = rng.uniform(-30, 30, (nb, 3)).astype(np.float32)
    tgt[:m] = src[:m] @ rot.T + np.float32([2.0, -1.0, 0.1])
    sd = (rng.integers(0, 96, (na, 33)) / 8.0).astype(np.float32)
    td = (rng.integers(0, 96, (nb, 33)) / 8.0).astype(np.float32)
    jitter = rng.integers(-1, 2, (m, 33)) * (rng.uniform(size=(m, 33)) < 0.2)
    td[:m] = np.clip(sd[:m] + jitter / 8.0, 0, 11.875)
    sm = rng.uniform(size=na) > 0.05
    tm = rng.uniform(size=nb) > 0.05
    return src, tgt, sd, td, sm, tm


@pytest.mark.parametrize("kw", [dict(crosscheck_min_matches=0),
                                dict(use_crosscheck=False)],
                         ids=["reference_crosscheck", "no_crosscheck"])
def test_match_features_one_nn_branches(grid_features, kw, monkeypatch):
    ref = jmatch.match_features(*(jnp.asarray(x) for x in grid_features),
                                capacity=256, **kw)

    def no_top2(*args):
        raise AssertionError("the 1-NN branches must not run the top-2 "
                             "search")

    monkeypatch.setattr(tmatch, "nearest_neighbors2", no_top2)
    got = tmatch.match_features(*grid_features, capacity=256, device="cpu",
                                **kw)
    assert int(np.asarray(ref.mask).sum()) >= 50
    for name in ("mask", "src_idx", "tgt_idx", "src_xyz", "tgt_xyz"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)


# -------------------------------------------------------------- solver ---

def _fixture(seed, n_in, translation=(4.0, -2.5, 0.4), roll_pitch=(0.0, 0.0)):
    src, tgt, gt, _ = make_correspondences(
        seed=seed, n_inliers=n_in, n_outliers=N - n_in, yaw_deg=63.0,
        translation=translation, roll_pitch=roll_pitch)
    mask = np.ones(N, bool)
    mask[-7:] = False                 # padded slots
    return src, tgt, mask, gt


@pytest.mark.parametrize("algorithm", ["FGR", "GNC_TLS"])
@pytest.mark.parametrize("seed,n_in", FIXTURES)
def test_rotation_solvers_match(seed, n_in, algorithm):
    """Yaw (FGR only: GNC-TLS yaw is tests/test_torch_solver.py's) and
    full SO(3), with no translation, so the rotation problem is the
    fixture's own; rotations within 1e-5, iteration counts equal."""
    src, tgt, mask, _ = _fixture(seed, n_in, translation=(0.0, 0.0, 0.0),
                                 roll_pitch=(0.03, -0.02))
    cases = [(jrot.gnc_rotation_3d, trot.gnc_rotation_3d, src, tgt)]
    if algorithm == "FGR":
        cases.append((jrot.gnc_rotation_2d, trot.gnc_rotation_2d,
                      src[:, :2], tgt[:, :2]))
    for jfn, tfn, s, t in cases:
        ref = jfn(jnp.asarray(s), jnp.asarray(t), jnp.asarray(mask), 0.6,
                  algorithm=algorithm)
        got = tfn(_t(s), _t(t), _t(mask), 0.6, algorithm=algorithm)
        np.testing.assert_allclose(got.rotation.numpy(),
                                   np.asarray(ref.rotation), atol=1e-5)
        assert int(got.iterations) == int(ref.iterations)
        np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                      np.asarray(ref.inlier_mask))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_svd_rot3d_matches(seed):
    """Weighted Kabsch on noisy rotated points with random weights: the
    rotation is unique for distinct singular values, so rotations are
    compared, not the SVD factors."""
    rng = np.random.default_rng(seed)
    src = rng.normal(0, 10, (200, 3)).astype(np.float32)
    rot = np.asarray(jax_rpy(0.3 * seed, -0.2, 1.0 + seed), np.float32)
    dst = (src @ rot.T + rng.normal(0, 0.05, (200, 3))).astype(np.float32)
    w = rng.uniform(0, 1, 200).astype(np.float32)
    ref = np.asarray(jrot.svd_rot3d(jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(w)))
    got = trot.svd_rot3d(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, rot, atol=2e-3)
    assert abs(np.linalg.det(got) - 1.0) < 1e-5


@pytest.mark.parametrize("seed,n_in", FIXTURES)
def test_solve_scale_tls_matches(seed, n_in):
    src, tgt, mask, _ = _fixture(seed, n_in)
    ref_s, ref_adj = jscale.solve_scale_tls(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), 0.3)
    got_s, got_adj = tscale.solve_scale_tls(_t(src), _t(tgt), _t(mask), 0.3)
    assert abs(float(got_s) / float(ref_s) - 1.0) <= 1e-6
    assert abs(float(got_s) - 1.0) < 0.02
    # pairs within 1e-6 of their bound may go either way
    s64, t64 = src.astype(np.float64), tgt.astype(np.float64)
    ds = np.maximum(np.linalg.norm(s64[:, None] - s64[None], axis=-1), 1e-6)
    dt = np.linalg.norm(t64[:, None] - t64[None], axis=-1)
    edge = np.abs(np.abs(dt / ds - float(ref_s)) - 0.6 / ds) < 1e-6
    differ = (got_adj.numpy() != np.asarray(ref_adj)) & ~edge
    assert not differ.any(), int(differ.sum())
    assert got_adj.sum() > 0


def _graph(src, tgt, mask):
    return jscale.tim_consistency_graph(jnp.asarray(src), jnp.asarray(tgt),
                                        jnp.asarray(mask), 0.3,
                                        use_pallas=False)


@pytest.mark.parametrize("max_steps", [20000, 40], ids=["full", "truncated"])
@pytest.mark.parametrize("seed,n_in", FIXTURES)
def test_exact_max_clique_bb_matches(seed, n_in, max_steps):
    src, tgt, mask, _ = _fixture(seed, n_in)
    adj = _graph(src, tgt, mask)
    jm = jnp.asarray(mask)
    inc = jclique.greedy_cliques(adj, jclique.clique_seed_scores(adj, jm), jm)
    ref = jclique.exact_max_clique_bb(adj, jm, incumbent=inc,
                                      max_steps=max_steps)
    tadj, tm = _t(np.asarray(adj)), _t(mask)
    tinc = tclique.greedy_cliques(tadj, tclique.clique_seed_scores(tadj, tm),
                                  tm)
    np.testing.assert_array_equal(tinc.numpy(), np.asarray(inc))
    got, completed, restricted, steps = tclique.exact_max_clique_bb(
        tadj, tm, incumbent=tinc, max_steps=max_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref[0]))
    assert bool(completed) == bool(ref[1])
    assert bool(restricted) == bool(ref[2])
    assert 0 < steps <= max_steps
    if not bool(completed):
        assert steps == max_steps


def _solver_configs(**kw):
    j = jcfg.SolverConfig(use_pallas_graph=False, **kw)
    return j, tcfg.config_from_dict({"solver": dataclasses.asdict(j)}).solver


def _band(ref_rot, ref_t, got):
    drot = math.degrees(float(rotation_geodesic_error(
        torch.tensor(np.asarray(ref_rot)), got.rotation)))
    dtr = float(np.linalg.norm(np.asarray(ref_t) - got.translation.numpy()))
    return drot, dtr


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("seed,n_in", FIXTURES[:2])
def test_register_correspondences_modes(seed, n_in, mode):
    src, tgt, mask, gt = _fixture(seed, n_in)
    jc, tc = _solver_configs(**MODES[mode])
    ref = jax_solve(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), jc)
    got = register_correspondences(src, tgt, mask, tc, device="cpu")
    assert bool(got.valid) == bool(ref.valid)
    drot, dtr = _band(ref.rotation, ref.translation, got)
    assert drot < ROT_BAND_DEG and dtr < TRANS_BAND_M, (drot, dtr)
    np.testing.assert_array_equal(got.max_clique_mask.numpy(),
                                  np.asarray(ref.max_clique_mask))
    np.testing.assert_allclose(got.transform().numpy(), gt, atol=0.1)
    assert abs(float(got.scale) - float(ref.scale)) <= 1e-6


def test_register_hypotheses_exact():
    """register_hypotheses under "exact": hypothesis 0 is the exact
    selection, in both packages."""
    src, tgt, mask, _ = _fixture(1, 40)
    jc, tc = _solver_configs(inlier_selection_mode="exact", num_hypotheses=4)
    ref = jax_hypotheses(jnp.asarray(src), jnp.asarray(tgt),
                         jnp.asarray(mask), jc, k=4)
    got = register_hypotheses(src, tgt, mask, tc, k=4, device="cpu")
    np.testing.assert_array_equal(got.max_clique_mask[0].numpy(),
                                  np.asarray(ref.max_clique_mask[0]))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    drot, dtr = _band(ref.rotation[0], ref.translation[0],
                      got.take(0))
    assert drot < ROT_BAND_DEG and dtr < TRANS_BAND_M, (drot, dtr)
