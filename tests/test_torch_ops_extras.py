"""The port's small public ops against the JAX package's, on the same
numpy inputs: utils/linalg, descriptor_distances, solve_scale and the
re-exported pairwise_distances, rotation_to_yaw, the K-capped FPFH over
neighbour lists (pair_features, compute_spfh, compute_fpfh), the
top-level exports, and utils/profiling.

Tolerances: linalg, distances and angles within 1e-5 (f32 arithmetic,
the same formulas); SPFH and FPFH within 1e-3 on values up to 100 (f32
summation order over the K neighbours), with equal neighbour counts;
integer and boolean outputs exactly.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu
from quatro_tpu.ops import fpfh as jfpfh
from quatro_tpu.ops.matching import descriptor_distances as j_desc_dist
from quatro_tpu.ops.neighbors import radius_neighbors as j_radius_neighbors
from quatro_tpu.ops.normals import estimate_normals as j_estimate_normals
from quatro_tpu.solver import scale as jscale
from quatro_tpu.utils import linalg as jlinalg
from quatro_tpu.utils.se3 import rotation_to_yaw as j_rotation_to_yaw

import quatro_tpu_torch
from quatro_tpu_torch.ops import fpfh as tfpfh
from quatro_tpu_torch.ops.kernels import pairwise_distances
from quatro_tpu_torch.ops.matching import descriptor_distances
from quatro_tpu_torch.ops.neighbors import NeighborLists
from quatro_tpu_torch.solver import scale as tscale
from quatro_tpu_torch.utils import linalg as tlinalg
from quatro_tpu_torch.utils.profiling import StageTimer, trace
from quatro_tpu_torch.utils.se3 import rotation_to_yaw, yaw_to_rotation

TOL = 1e-5
FPFH_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_top_level_exports_match_the_jax_package():
    assert quatro_tpu_torch.__version__ == quatro_tpu.__version__
    for name in ("DEFAULT_CONFIG", "PatchworkConfig", "ProjectionConfig",
                 "replace", "__version__"):
        assert name in quatro_tpu_torch.__all__
        assert hasattr(quatro_tpu_torch, name)
    assert quatro_tpu_torch.DEFAULT_CONFIG == quatro_tpu_torch.PipelineConfig()
    cfg = quatro_tpu_torch.replace(quatro_tpu_torch.DEFAULT_CONFIG,
                                   voxel_size=0.5)
    assert cfg.voxel_size == 0.5
    assert quatro_tpu_torch.PatchworkConfig().sensor_height == \
        quatro_tpu.PatchworkConfig().sensor_height
    assert quatro_tpu_torch.ProjectionConfig().neighbor_mode == \
        quatro_tpu.ProjectionConfig().neighbor_mode


# ----------------------------------------------------------------- linalg --

def test_hatmap_and_vector_kron(rng):
    v = rng.normal(size=(5, 3)).astype(np.float32)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    h = tlinalg.hatmap(_t(v)).numpy()
    np.testing.assert_allclose(h, np.asarray(jlinalg.hatmap(jnp.asarray(v))),
                               atol=TOL)
    for i in range(5):                 # tests/test_parity_extras.py:54-61
        np.testing.assert_allclose(h[i] @ w[i], np.cross(v[i], w[i]),
                                   atol=TOL)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(4, 2)).astype(np.float32)
    k = tlinalg.vector_kron(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(
        k, np.asarray(jlinalg.vector_kron(jnp.asarray(a), jnp.asarray(b))),
        atol=TOL)
    for i in range(4):
        np.testing.assert_allclose(k[i], np.kron(a[i], b[i]), atol=TOL)


def test_nearest_psd(rng):
    a = rng.normal(size=(3, 3)).astype(np.float32)
    a = (a + a.T) / 2 - 1.0 * np.eye(3, dtype=np.float32)
    p = tlinalg.nearest_psd(_t(a)).numpy()
    np.testing.assert_allclose(
        p, np.asarray(jlinalg.nearest_psd(jnp.asarray(a))), atol=TOL)
    assert (np.linalg.eigvalsh(p) >= -TOL).all()


def test_diameter_and_mask_helpers(rng):
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    mask = rng.random(10) > 0.3
    got = float(tlinalg.calculate_diameter(_t(pts), _t(mask)))
    want = float(jlinalg.calculate_diameter(jnp.asarray(pts),
                                            jnp.asarray(mask)))
    assert abs(got - want) <= TOL * max(1.0, want)

    m = np.array([False, True, False, True, True])
    for fill in (-1, 7):
        np.testing.assert_array_equal(
            tlinalg.mask_indices(_t(m), fill).numpy(),
            np.asarray(jlinalg.mask_indices(jnp.asarray(m), fill)))


@pytest.mark.parametrize("num_samples", [0, 2, 3, 9])
def test_random_sample_mask(num_samples):
    """A sample of min(num_samples, set bits) set bits, from the
    generator's stream (jax's key stream draws other bits)."""
    m = torch.tensor([False, True, False, True, True, True, False, True])
    g = torch.Generator().manual_seed(3)
    sel = tlinalg.random_sample_mask(g, m, num_samples)
    assert int(sel.sum()) == min(num_samples, int(m.sum()))
    assert not (sel & ~m).any()
    again = tlinalg.random_sample_mask(torch.Generator().manual_seed(3), m,
                                       num_samples)
    assert torch.equal(sel, again)
    jsel = np.asarray(jlinalg.random_sample_mask(
        jax.random.PRNGKey(0), jnp.asarray(m.numpy()), num_samples))
    assert jsel.sum() == int(sel.sum())


# ------------------------------------------------------------- small ops --

def test_descriptor_distances(rng):
    a = rng.normal(size=(37, 33)).astype(np.float32)
    b = rng.normal(size=(21, 33)).astype(np.float32)
    ma = rng.random(37) > 0.2
    mb = rng.random(21) > 0.2
    got = descriptor_distances(_t(a), _t(b), _t(ma), _t(mb)).numpy()
    want = np.asarray(j_desc_dist(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(ma), jnp.asarray(mb)))
    both = ma[:, None] & mb[None, :]
    np.testing.assert_array_equal(got[~both], want[~both])
    np.testing.assert_allclose(got[both], want[both], rtol=TOL, atol=1e-3)


def test_solve_scale_and_pairwise_distances(rng):
    src = rng.uniform(-20, 20, (50, 3)).astype(np.float32)
    s = tscale.solve_scale(_t(src), _t(src))
    assert s.dtype == torch.float32 and s.shape == () and float(s) == \
        float(jscale.solve_scale(jnp.asarray(src), jnp.asarray(src)))
    assert tscale.pairwise_distances is pairwise_distances   # re-export
    np.testing.assert_allclose(
        tscale.pairwise_distances(_t(src)).numpy(),
        np.asarray(jscale.pairwise_distances(jnp.asarray(src))),
        rtol=TOL, atol=TOL)


def test_rotation_to_yaw(rng):
    yaws = rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
    rots = yaw_to_rotation(_t(yaws))
    got = rotation_to_yaw(rots).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_rotation_to_yaw(jnp.asarray(rots.numpy()))),
        atol=TOL)
    np.testing.assert_allclose(got, yaws, atol=TOL)


# ------------------------------------------------------ K-capped FPFH ----

def _soa(a):
    return tuple(a[:, c] for c in range(3))


def test_pair_features_match(rng):
    p1, p2, n1, n2 = (rng.normal(size=(100, 3)).astype(np.float32)
                      for _ in range(4))
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=1, keepdims=True)
    p2[:3] = p1[:3]                    # coincident points: not valid
    got = tfpfh.pair_features(*(_soa(_t(a)) for a in (p1, n1, p2, n2)))
    want = jfpfh.pair_features(*(_soa(jnp.asarray(a))
                                 for a in (p1, n1, p2, n2)))
    ok = want[3]
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ok))
    assert not got[3][:3].any()
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy()[ok], np.asarray(w)[ok],
                                   atol=TOL)
    assert (np.abs(got[0].numpy()[ok]) <= np.pi + TOL).all()


def _cloud(rng, n, lo, hi):
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-5:] = False
    return pts, mask


@pytest.mark.parametrize("radius,k,with_valid",
                         [(1.5, 16, False), (1.2, 24, True)])
def test_spfh_fpfh_match(rng, radius, k, with_valid):
    """compute_spfh / compute_fpfh on the JAX package's own neighbour
    lists and normals: equal neighbour counts, descriptors within
    FPFH_ATOL; each normalised block sums to 100."""
    n = 128
    pts, mask = _cloud(rng, n, 0.0, 3.0)
    nb = j_radius_neighbors(jnp.asarray(pts), jnp.asarray(mask), radius, k,
                            tile=64)
    nrm = j_estimate_normals(jnp.asarray(pts), nb)
    valid = np.asarray(nrm.valid) & mask if with_valid else None
    t_nb = NeighborLists(_t(nb.idx), _t(nb.valid), _t(nb.dist2))
    t_args = (_t(pts), _t(nrm.normals), t_nb,
              None if valid is None else _t(valid))
    j_args = (jnp.asarray(pts), nrm.normals, nb,
              None if valid is None else jnp.asarray(valid))
    assert int(t_nb.valid.sum()) == int(np.asarray(nb.valid).sum())
    spfh = tfpfh.compute_spfh(*t_args).numpy()
    np.testing.assert_allclose(spfh, np.asarray(jfpfh.compute_spfh(*j_args)),
                               atol=FPFH_ATOL)
    desc = tfpfh.compute_fpfh(*t_args).numpy()
    np.testing.assert_allclose(desc, np.asarray(jfpfh.compute_fpfh(*j_args)),
                               atol=FPFH_ATOL)
    assert desc.shape == (n, 33)
    live = desc.reshape(n, 3, 11).sum(-1)
    np.testing.assert_allclose(live[live.max(1) > 0], 100.0, atol=1e-2)


# -------------------------------------------------------------- profiling --

def test_stage_timer_and_trace(tmp_path):
    timer = StageTimer()
    x = torch.ones(8)
    with timer.stage("a", sync=x):
        time.sleep(0.01)
    with timer.stage("b", sync="cpu"):
        pass
    timer.record("c", 0.5)
    assert [n for n, _ in timer.spans] == ["a", "b", "c"]
    assert timer.spans[0][1] >= 0.01 and timer.total() >= 0.51
    table = timer.table()
    assert "a" in table and "total" in table and "ms" in table
    with trace(str(tmp_path / "tr")) as log_dir:
        (x * 2).sum()
    assert log_dir == str(tmp_path / "tr")
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
