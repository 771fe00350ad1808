"""The Quatro solver: the port against the JAX package on the same
correspondences (io/synthetic.make_correspondences fixtures).

The consistency graph is exact except for pairs within 1e-6 of beta; the
clique, k-core and no-selection masks are exact (integer counts in f32);
the pose follows within 1e-4 (rotation) and 1e-3 (translation).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io.synthetic import make_correspondences
from quatro_tpu.solver.quatro import register_correspondences as jax_solve
from quatro_tpu.solver.scale import tim_consistency_graph as jax_graph

import quatro_tpu_torch.config as tcfg
from quatro_tpu_torch.solver.clique import select_inliers
from quatro_tpu_torch.solver.quatro import register_correspondences
from quatro_tpu_torch.solver.scale import tim_consistency_graph

N = 500
# (seed, inliers of N): outlier shares 80% .. 99%
FIXTURES = [(0, 100), (1, 40), (2, 15), (3, 5)]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fixture(seed, n_in, roll_pitch=(0.0, 0.0)):
    src, tgt, gt, _ = make_correspondences(
        seed=seed, n_inliers=n_in, n_outliers=N - n_in, yaw_deg=63.0,
        translation=(4.0, -2.5, 0.4), roll_pitch=roll_pitch)
    mask = np.ones(N, bool)
    mask[-7:] = False                 # padded slots
    return src, tgt, mask, gt


def _configs(**kw):
    j = jcfg.SolverConfig(use_pallas_graph=False, **kw)
    return j, tcfg.config_from_dict(
        {"solver": dataclasses.asdict(j)}).solver


def _solve_both(src, tgt, mask, prior=None, **kw):
    jc, tc = _configs(**kw)
    ref = jax_solve(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), jc,
                    prior_ryrx=None if prior is None else jnp.asarray(prior))
    got = register_correspondences(src, tgt, mask, tc, prior_ryrx=prior,
                                   device="cpu")
    return ref, got


def _assert_same_solution(ref, got):
    assert bool(got.valid) == bool(ref.valid)
    np.testing.assert_array_equal(got.max_clique_mask.numpy(),
                                  np.asarray(ref.max_clique_mask))
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(ref.rotation),
                               atol=1e-4)
    np.testing.assert_allclose(got.translation.numpy(),
                               np.asarray(ref.translation), atol=1e-3)
    assert int(got.num_rotation_inliers) == int(ref.num_rotation_inliers)


@pytest.mark.parametrize("seed,n_in", FIXTURES)
def test_consistency_graph_exact(seed, n_in):
    src, tgt, mask, _ = _fixture(seed, n_in)
    noise = 0.3
    ref = np.asarray(jax_graph(jnp.asarray(src), jnp.asarray(tgt),
                               jnp.asarray(mask), noise, 1.0,
                               use_pallas=False))
    got = tim_consistency_graph(torch.from_numpy(src), torch.from_numpy(tgt),
                                torch.from_numpy(mask), noise, 1.0).numpy()
    # Pairs whose residual lies within f32 rounding of beta may go either
    # way: 1e-6 plus four f32 ulps of the longer length (each length is an
    # f32 sqrt of an f32 sum, ~4e-6 at the fixtures' ~90 m).
    s64, t64 = src.astype(np.float64), tgt.astype(np.float64)
    ds = np.linalg.norm(s64[:, None] - s64[None], axis=-1)
    dt = np.linalg.norm(t64[:, None] - t64[None], axis=-1)
    gap = np.abs(np.abs(dt - ds) - 2.0 * noise)
    edge = gap < 1e-6 + 4 * np.finfo(np.float32).eps * np.maximum(ds, dt)
    differ = (got != ref) & ~edge
    assert not differ.any(), (
        f"{int(differ.sum())} pairs differ, nearest to beta by "
        f"{gap[differ].min():.3g}")
    assert got.sum() > 0


@pytest.mark.parametrize("seed,n_in", FIXTURES)
def test_register_correspondences_matches(seed, n_in):
    src, tgt, mask, gt = _fixture(seed, n_in)
    ref, got = _solve_both(src, tgt, mask)
    _assert_same_solution(ref, got)
    if n_in >= 15:                    # enough inliers: both recover the pose
        np.testing.assert_allclose(got.transform().numpy(), gt, atol=0.1)


def test_register_correspondences_imu_prior():
    """A tilted platform with its roll/pitch known: the source is levelled
    by the prior before the yaw solve, in both packages."""
    roll, pitch = 0.04, -0.03
    src, tgt, mask, gt = _fixture(5, 40, roll_pitch=(roll, pitch))
    rx = np.array([[1, 0, 0], [0, np.cos(roll), -np.sin(roll)],
                   [0, np.sin(roll), np.cos(roll)]])
    ry = np.array([[np.cos(pitch), 0, np.sin(pitch)], [0, 1, 0],
                   [-np.sin(pitch), 0, np.cos(pitch)]])
    prior = (ry @ rx).astype(np.float32)
    ref, got = _solve_both(src, tgt, mask, prior=prior)
    _assert_same_solution(ref, got)
    np.testing.assert_allclose(got.transform().numpy(), gt, atol=0.1)


@pytest.mark.parametrize("mode", ["kcore", "none"])
def test_other_selection_modes_match(mode):
    src, tgt, mask, _ = _fixture(1, 40)
    ref, got = _solve_both(src, tgt, mask, inlier_selection_mode=mode)
    _assert_same_solution(ref, got)


def test_unported_options_raise():
    """The solver modes that raised NotImplementedError before they were
    ported now run: exact selection on an edgeless graph selects nothing,
    and the TLS scale, TEASER and FGR solve the fixture (their agreement
    with the JAX package is tests/test_torch_reference_modes.py's). What
    still raises: device=None without a card."""
    src, tgt, mask, gt = _fixture(0, 100)
    adj = torch.zeros((N, N), dtype=torch.bool)
    sel, valid = select_inliers(adj, torch.from_numpy(mask), mode="exact")
    assert not bool(valid) and int(sel.sum()) <= 1
    for kw in (dict(estimate_scaling=True), dict(reg_name="TEASER"),
               dict(rotation_estimation_algorithm="FGR")):
        sol = register_correspondences(src, tgt, mask, _configs(**kw)[1],
                                       device="cpu")
        assert bool(sol.valid), kw
        np.testing.assert_allclose(sol.transform().numpy(), gt, atol=0.1)
    with pytest.raises(RuntimeError):      # no card here: device=None fails
        if torch.cuda.is_available():
            raise RuntimeError("a card is present")
        register_correspondences(src, tgt, mask)
