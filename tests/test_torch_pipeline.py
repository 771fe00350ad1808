"""The slices end to end: ``register_features`` of the port against the JAX
package's, on the VLP-16 pair of golden spec ``level_a``, with the
single-hypothesis solver and with the shipping multi-hypothesis solver of
``PipelineConfig.recommended()`` (4 clique + 2 vote hypotheses arbitrated
by overlap).

Seed 101, yaw 38 deg, t = (2.5, -1.2, 0.04); ``for_lidar("VLP-16",
max_voxels=2048)`` with 512 correspondences and the plain consistency
graph; the crude ground strip of tests/test_pipeline.py at capacity 32768.
Both packages run on the CPU (the port's plain versions, the JAX package's
dense front end).

Measured on this input: the JAX package lands 0.189 deg / 0.068 m from the
ground truth with 106 correspondences, the port 0.018 deg / 0.007 m with
89, and the two poses are 0.207 deg / 0.072 m apart. The voxel masks are
identical and the centroids agree to 1e-5 m; the correspondence sets
differ because FPFH sums and the
descriptor distances round differently in the two libraries and the
matcher is knife-edge (tests/test_torch_matching.py holds the matcher
itself exactly).

With the recommended solver the winning hypothesis is knife-edge on this
pair (several hypotheses score within a few thousandths of each other in
overlap), so poses are held to the bands, never the winner's index.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io.synthetic import make_scan_pair as jax_scan_pair
from quatro_tpu.pipeline import register_features as jax_register
from quatro_tpu.types import PointBatch as JaxPointBatch

import quatro_tpu_torch as qt
from quatro_tpu_torch.io.synthetic import make_scan_pair
from quatro_tpu_torch.utils.se3 import rotation_geodesic_error

# tests/golden_specs.py: the ground-truth floor and the per-pair drift band
GT_ROT_MAX_DEG, GT_TRANS_MAX_M = 5.0, 2.0
ROT_BAND_DEG, TRANS_BAND_M = 3.0, 1.5
PAIR = dict(seed=101, yaw_deg=38.0, translation=(2.5, -1.2, 0.04))
CAPACITY = 32768


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nonground(xyz, sensor_height=1.723, margin=0.3):
    return xyz[xyz[:, 2] > -sensor_height + margin]


def _jax_config():
    cfg = jcfg.PipelineConfig.for_lidar("VLP-16", max_voxels=2048)
    return dataclasses.replace(
        cfg, fpfh=dataclasses.replace(cfg.fpfh, max_correspondences=512),
        solver=jcfg.SolverConfig(use_pallas_graph=False))


def _run_both(jc):
    src, tgt, gt = jax_scan_pair(lidar=jcfg.LidarConfig.preset("VLP-16"),
                                 **PAIR)
    ref = jax_register(
        JaxPointBatch.from_numpy(_nonground(src), CAPACITY),
        JaxPointBatch.from_numpy(_nonground(tgt), CAPACITY), jc)
    tc = qt.config_from_dict(dataclasses.asdict(jc))
    tsrc, ttgt, tgt_gt = make_scan_pair(
        lidar=qt.LidarConfig.preset("VLP-16"), **PAIR)
    np.testing.assert_array_equal(tgt_gt, gt)
    got = qt.register_features(
        qt.PointBatch.from_numpy(_nonground(tsrc), CAPACITY),
        qt.PointBatch.from_numpy(_nonground(ttgt), CAPACITY), tc,
        device="cpu")
    return ref, got, gt


@pytest.fixture(scope="module")
def results():
    return _run_both(_jax_config())


@pytest.fixture(scope="module")
def results_recommended():
    return _run_both(dataclasses.replace(
        _jax_config(), solver=jcfg.SolverConfig(num_hypotheses=4,
                                                num_vote_hypotheses=2)))


def _errors(rot, trans, gt):
    rerr = math.degrees(float(rotation_geodesic_error(
        torch.tensor(gt[:3, :3]), torch.tensor(np.asarray(rot)))))
    return rerr, float(np.linalg.norm(np.asarray(trans) - gt[:3, 3]))


def test_register_features_within_ground_truth(results):
    ref, got, gt = results
    for name, sol in (("jax", ref.solution), ("port", got.solution)):
        assert bool(np.asarray(sol.valid)), name
        rerr, terr = _errors(np.asarray(sol.rotation),
                             np.asarray(sol.translation), gt)
        assert rerr < GT_ROT_MAX_DEG and terr < GT_TRANS_MAX_M, \
            (name, rerr, terr)
    assert int(got.correspondences.mask.sum()) >= 10


def test_register_features_within_drift_band_of_jax(results):
    ref, got, _ = results
    drot = math.degrees(float(rotation_geodesic_error(
        torch.tensor(np.asarray(ref.solution.rotation)),
        got.solution.rotation)))
    dtr = float(np.linalg.norm(np.asarray(ref.solution.translation)
                               - got.solution.translation.numpy()))
    assert drot < ROT_BAND_DEG and dtr < TRANS_BAND_M, (drot, dtr)


def test_voxel_clouds_match(results):
    ref, got, _ = results
    for jv, tv in ((ref.src_voxels, got.src_voxels),
                   (ref.tgt_voxels, got.tgt_voxels)):
        np.testing.assert_array_equal(tv.mask.numpy(), np.asarray(jv.mask))
        np.testing.assert_allclose(tv.points.numpy(), np.asarray(jv.points),
                                   rtol=0, atol=1e-5)


def test_recommended_within_ground_truth(results_recommended):
    ref, got, gt = results_recommended
    for name, sol in (("jax", ref.solution), ("port", got.solution)):
        assert bool(np.asarray(sol.valid)), name
        rerr, terr = _errors(np.asarray(sol.rotation),
                             np.asarray(sol.translation), gt)
        assert rerr < GT_ROT_MAX_DEG and terr < GT_TRANS_MAX_M, \
            (name, rerr, terr)
    assert got.hypotheses.rotation.shape == (6, 3, 3)
    assert got.overlaps.shape == (6,)
    assert bool(((got.overlaps >= 0) & (got.overlaps <= 1)).all())


def test_recommended_within_drift_band_of_jax(results_recommended):
    ref, got, _ = results_recommended
    drot = math.degrees(float(rotation_geodesic_error(
        torch.tensor(np.asarray(ref.solution.rotation)),
        got.solution.rotation)))
    dtr = float(np.linalg.norm(np.asarray(ref.solution.translation)
                               - got.solution.translation.numpy()))
    assert drot < ROT_BAND_DEG and dtr < TRANS_BAND_M, (drot, dtr)


def test_unported_branches_raise():
    """What raised NotImplementedError before it was ported (ICP, the FGR
    and TEASER rotation solvers, the TLS scale, exact clique selection)
    now runs: on a junk pair (eight points at the origin) every such
    configuration returns an invalid solution with a finite pose. What
    still raises: device=None without a card."""
    pb = qt.PointBatch.from_numpy(np.zeros((8, 3), np.float32), 512)
    solver = qt.SolverConfig()
    for cfg in (qt.config_from_dict({"icp": {"enabled": True}}),
                qt.PipelineConfig(solver=dataclasses.replace(
                    solver, rotation_estimation_algorithm="FGR")),
                qt.PipelineConfig(solver=dataclasses.replace(solver,
                                                    reg_name="TEASER")),
                qt.PipelineConfig(solver=dataclasses.replace(solver,
                                                    estimate_scaling=True)),
                qt.PipelineConfig(solver=dataclasses.replace(
                    solver, inlier_selection_mode="exact")),
                qt.PipelineConfig.recommended(solver=dataclasses.replace(
                    solver, num_hypotheses=4, num_vote_hypotheses=2,
                    inlier_selection_mode="exact"))):
        res = qt.register_features(pb, pb, cfg, device="cpu")
        assert not bool(res.solution.valid)
        assert bool(torch.isfinite(res.solution.transform()).all())
        assert (res.icp is not None) == cfg.icp.enabled
    if not torch.cuda.is_available():        # device=None means the card
        with pytest.raises(RuntimeError):
            qt.register_features(pb, pb, qt.PipelineConfig())


def test_plain_graph_refused_on_the_card():
    """use_pallas_graph=False is the plain graph, CPU only: on a CUDA
    tensor it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from quatro_tpu_torch.solver.scale import tim_consistency_graph
    pts = torch.zeros((16, 3), device="cuda")
    with pytest.raises(ValueError, match="CPU only"):
        tim_consistency_graph(pts, pts, torch.ones(16, dtype=torch.bool,
                                                   device="cuda"), 0.3,
                              use_pallas=False)
