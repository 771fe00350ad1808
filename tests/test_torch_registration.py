"""The reference-idiom object API (``QuatroRegistration``) and the scan
metadata (``compute_scan_metadata``) of the port against the JAX package on
the CPU.

Tolerances, and what was measured on these inputs:
- ``QuatroRegistration`` on ``make_correspondences`` fixtures: the 4x4
  transform within 1e-4 of the JAX package's and the clique and final
  inlier indices equal (measured: transforms within 2.4e-7, indices equal);
  the JAX package's own API tests (tests/test_registration_api.py) with
  their ground-truth bands;
- ``compute_scan_metadata`` on the level_a VLP-16 scan in both ground
  modes: every integer and flag exact, ranges and orientations within
  1e-5 (the projections agree on every point, ROADMAP C).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quatro_tpu.config import SolverConfig as JaxSolverConfig
from quatro_tpu.io.synthetic import make_correspondences
from quatro_tpu.preprocessing import projection as jpr
from quatro_tpu.preprocessing.metadata import \
    compute_scan_metadata as jax_metadata
from quatro_tpu.registration import QuatroRegistration as JaxRegistration

import quatro_tpu_torch as qt
from quatro_tpu_torch.preprocessing import projection as tpr
from quatro_tpu_torch.preprocessing.metadata import (ScanMetadata,
                                                     compute_scan_metadata)
from quatro_tpu_torch.utils.se3 import rotation_from_rpy

from golden_specs import GOLDEN_SPECS, RAW_CAPACITY, build_config, build_pair


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port(**kw):
    return qt.QuatroRegistration(device="cpu", **kw)


# --------------------------------------------------- QuatroRegistration ---

@pytest.mark.parametrize("case", [
    dict(seed=42, n_inliers=40, n_outliers=360, yaw_deg=63.0,
         translation=(4.0, -2.5, 0.4)),
    dict(seed=11),
    dict(seed=15, roll_pitch=(0.07, -0.04), yaw_deg=30.0, n_inliers=80,
         n_outliers=120)], ids=["seed42", "seed11", "prior"])
def test_quatro_registration_matches_jax(case):
    src, tgt, gt, _ = make_correspondences(**case)
    ref, got = JaxRegistration(JaxSolverConfig()), _port()
    for api in (ref, got):
        api.set_input_source(src)
        api.set_input_target(tgt)
        if "roll_pitch" in case:
            api.set_pre_estimated_ryrx(
                rotation_from_rpy(*case["roll_pitch"], 0.0).numpy())
    t_ref, t_got = ref.compute_transformation(), got.compute_transformation()
    assert isinstance(t_got, np.ndarray) and t_got.shape == (4, 4)
    np.testing.assert_allclose(t_got, t_ref, atol=1e-4)
    assert got.is_valid() == ref.is_valid() is True
    np.testing.assert_array_equal(got.get_final_inliers_indices(),
                                  ref.get_final_inliers_indices())
    np.testing.assert_array_equal(got.get_max_cliques(),
                                  ref.get_max_cliques())
    np.testing.assert_array_equal(got.get_final_inliers(),
                                  ref.get_final_inliers())
    np.testing.assert_allclose(t_got[:3, :3], gt[:3, :3], atol=0.03)


def test_quatro_registration_api_contract():
    """tests/test_registration_api.py's contract: inputs before the solve,
    a solution before the results, reset and reuse, inputs of different
    padded lengths."""
    quatro = _port()
    with pytest.raises(RuntimeError):
        quatro.compute_transformation()
    with pytest.raises(RuntimeError):
        _ = quatro.solution
    src, tgt, _, _ = make_correspondences(seed=12)
    quatro.set_input_source(src)
    quatro.set_input_target(torch.from_numpy(tgt))
    t1 = quatro.compute_transformation()
    quatro.reset(qt.SolverConfig(noise_bound=0.3))
    assert quatro.params.noise_bound == 0.3
    with pytest.raises(RuntimeError):
        _ = quatro.solution
    src2, tgt2, gt2, _ = make_correspondences(seed=13, yaw_deg=-70.0)
    quatro.set_input_source(src2)
    quatro.set_input_target(tgt2)
    t2 = quatro.compute_transformation()
    np.testing.assert_allclose(t2[:3, :3], gt2[:3, :3], atol=0.02)
    assert not np.allclose(t1, t2)

    src3, tgt3, gt3, _ = make_correspondences(seed=14, n_inliers=50,
                                              n_outliers=100)
    padded = np.concatenate([tgt3, np.zeros((200, 3), np.float32)])
    ref = JaxRegistration()
    quatro.reset(qt.SolverConfig())
    for api in (ref, quatro):
        api.set_input_source(src3)
        api.set_input_target(padded)     # mask intersection: 150 slots
    t3 = quatro.compute_transformation()
    np.testing.assert_allclose(t3, ref.compute_transformation(), atol=1e-4)
    np.testing.assert_allclose(t3[:3, :3], gt3[:3, :3], atol=0.02)


def test_quatro_registration_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qt.QuatroRegistration()


# -------------------------------------------------------- scan metadata ---

@pytest.fixture(scope="module")
def level_a_source():
    """The level_a VLP-16 source scan at the golden specs' raw capacity,
    with the JAX configuration and the port's."""
    spec = next(s for s in GOLDEN_SPECS if s["name"] == "level_a")
    src, _, _ = build_pair(spec)
    pts = np.zeros((RAW_CAPACITY, 3), np.float32)
    pts[:len(src)] = src
    mask = np.arange(RAW_CAPACITY) < len(src)
    jc = build_config(spec)
    return pts, mask, jc, qt.config_from_dict(dataclasses.asdict(jc))


@pytest.mark.parametrize("mode", ["LeGO-LOAM", "Patchwork"])
def test_scan_metadata_matches(level_a_source, mode):
    pts, mask, jc, tc = level_a_source
    if mode == "Patchwork":       # the non-ground points of a crude strip
        mask = mask & (pts[:, 2] > -1.723 + 0.3)
    jproj = jpr.segment_cloud(jnp.asarray(pts), jnp.asarray(mask), jc.lidar,
                              jc.projection, ground_mode=mode)
    ref = jax_metadata(jnp.asarray(pts), jnp.asarray(mask), jproj, jc.lidar)
    tpts, tmask = torch.from_numpy(pts), torch.from_numpy(mask)
    tproj = tpr.segment_cloud(tpts, tmask, tc.lidar, tc.projection,
                              ground_mode=mode)
    got = compute_scan_metadata(tpts, tmask, tproj, tc.lidar)
    assert isinstance(got, ScanMetadata)
    for name in ("start_ring_index", "end_ring_index",
                 "segmented_ground_flag", "segmented_col_ind"):
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    for name in ("segmented_range", "start_orientation", "end_orientation",
                 "orientation_diff"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-5,
                                   err_msg=name)
    rng = got.segmented_range.numpy()
    assert (rng > 0).sum() > 1000 and (rng[rng > 0] < 100).all()
    assert np.pi < float(got.orientation_diff) < 3 * np.pi
    assert got.segmented_ground_flag.any() == (mode == "LeGO-LOAM")
