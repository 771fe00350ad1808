"""The pair axis: the port's batched calls against its own per-pair calls
and against the JAX package's ``vmap``.

- ``register_scan_pair`` at B = 3 on three distinct VLP-16 pairs, one of
  them junk (its target is another seed's scan, so nothing registers):
  every row equals the unbatched call on that pair. Exactly for the
  voxel and correspondence slots, the clique and inlier masks, ``valid``,
  GNC iteration counts, the hypotheses' masks, the arbitration winner and
  ICP's inlier count; rotation within 1e-5 rad and translation within
  1e-4 m (a batched reduction may add in another order). Under the
  shipping configuration with ground alignment and ICP, and under the
  single-hypothesis solver.
- ``register_batch`` against ``quatro_tpu.solver.register_batch`` on
  ``make_correspondences`` seeds 0-3 (tests/test_solver_e2e.py:133-146):
  masks exact, poses within 1e-4 rad / 1e-3 m; ``transform()`` of the
  batch (tests/test_pipeline.py:135-150).
- ``register_features`` at B = 2 (golden specs level_a and level_b after
  the crude ground strip) against ``jax.jit(jax.vmap(register_features))``
  within the drift band of tests/golden_specs.py (3 deg / 1.5 m), in
  tests/test_torch_pipeline.py's configuration.
- ``vote_hypotheses`` and ``refine_icp`` over pairs against ``jax.vmap`` of
  the JAX package's (tests/test_vote.py:137, tests/test_icp.py:148).
- B1's and B2's plain versions at a pair axis equal their per-pair calls
  bit for bit (B1 at N = 1001, where a pair's rows start inside a 16-byte
  piece of the kernel's output).
- ``run_sequence`` registers only the real edges of its last chunk, with
  the SequenceResult of the padded per-pair loop it replaced.

Torch threads are capped at 2, as in the other port tests.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io.synthetic import make_correspondences
from quatro_tpu.pipeline import register_features as jax_register
from quatro_tpu.solver import register_batch as jax_register_batch
from quatro_tpu.solver.icp import refine_icp as jax_icp
from quatro_tpu.solver.vote import vote_hypotheses as jax_vote
from quatro_tpu.types import PointBatch as JaxPointBatch

import quatro_tpu_torch as qt
from quatro_tpu_torch import odometry, sequence
from quatro_tpu_torch.io.synthetic import make_scan_pair
from quatro_tpu_torch.ops import kernels, segment
from quatro_tpu_torch.pipeline import register_scan_pair
from quatro_tpu_torch.solver.icp import refine_icp
from quatro_tpu_torch.solver.quatro import (register_batch,
                                            register_correspondences)
from quatro_tpu_torch.solver.scale import tim_consistency_graph
from quatro_tpu_torch.solver.vote import pair_segment_sums, vote_hypotheses
from quatro_tpu_torch.utils.se3 import exp_so3, rotation_geodesic_error

from golden_specs import GOLDEN_SPECS, ROT_BAND_DEG, TRANS_BAND_M

RAW = 32768
VLP16 = qt.LidarConfig.preset("VLP-16")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _stack(batches):
    return qt.PointBatch(torch.stack([b.points for b in batches]),
                         torch.stack([b.mask for b in batches]))


def _same_pose(got, ref):
    """Rotation within 1e-5 rad, translation within 1e-4 m."""
    drot = float(rotation_geodesic_error(ref.rotation, got.rotation))
    dtr = float((got.translation - ref.translation).abs().max())
    assert drot <= 1e-5 and dtr <= 1e-4, (drot, dtr)


EXACT = ("valid", "max_clique_mask", "final_inlier_mask",
         "num_rotation_inliers", "gnc_iterations")


def _same_solution(got, ref):
    for name in EXACT:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    _same_pose(got, ref)


# ------------------------------------------------ batched = the loop ----

def _scan_cfg(shipping):
    fpfh = dataclasses.replace(qt.FPFHConfig.for_lidar(VLP16),
                               max_correspondences=512)
    if shipping:
        return qt.PipelineConfig.for_lidar(
            "VLP-16", max_voxels=2048, max_raw_points=RAW, fpfh=fpfh,
            solver=qt.SolverConfig(num_hypotheses=4, num_vote_hypotheses=2),
            ground_alignment=qt.GroundAlignmentConfig(enabled=True),
            icp=qt.IcpConfig(enabled=True))
    return qt.PipelineConfig.for_lidar("VLP-16", max_voxels=2048,
                                       max_raw_points=RAW, fpfh=fpfh)


@pytest.fixture(scope="module")
def scan_pairs():
    """Three raw VLP-16 pairs; the third's target is seed 7's scan."""
    pairs = [make_scan_pair(lidar=VLP16, seed=s, yaw_deg=20.0 + 5 * s,
                            translation=(2.0, 1.0, 0.05))
             for s in (101, 102, 103)]
    junk = make_scan_pair(lidar=VLP16, seed=7, yaw_deg=0.0,
                          translation=(0.0, 0.0, 0.0))[0]
    pairs[2] = (pairs[2][0], junk, None)
    return [(qt.PointBatch.from_numpy(a, RAW),
             qt.PointBatch.from_numpy(b, RAW)) for a, b, _ in pairs], \
        [gt for _, _, gt in pairs[:2]]


@pytest.mark.parametrize("shipping", [True, False],
                         ids=["recommended_ground_icp", "single"])
def test_register_scan_pair_batch_is_the_loop(scan_pairs, shipping):
    scan_pairs, gts = scan_pairs
    cfg = _scan_cfg(shipping)
    batch = register_scan_pair(_stack([s for s, _ in scan_pairs]),
                               _stack([t for _, t in scan_pairs]), cfg,
                               device="cpu")
    assert batch.solution.transform().shape == (3, 4, 4)
    for b, (src, tgt) in enumerate(scan_pairs):
        one = register_scan_pair(src, tgt, cfg, device="cpu")
        row = batch.row(b)
        for got, ref in ((row.src_voxels, one.src_voxels),
                         (row.tgt_voxels, one.tgt_voxels)):
            assert torch.equal(got.mask, ref.mask)
            assert torch.equal(got.points, ref.points)
        for got, ref in zip(row.correspondences, one.correspondences):
            assert torch.equal(got, ref)
        _same_solution(row.solution, one.solution)
        if shipping:
            for name in EXACT:
                assert torch.equal(getattr(row.hypotheses, name),
                                   getattr(one.hypotheses, name)), name
            win = [int(torch.argmax(torch.where(r.hypotheses.valid,
                                                r.overlaps, -1.0)))
                   for r in (row, one)]
            assert win[0] == win[1]
            np.testing.assert_allclose(row.overlaps.numpy(),
                                       one.overlaps.numpy(), atol=1e-6)
            assert int(row.icp.num_inliers) == int(one.icp.num_inliers)
            assert bool(row.icp.converged) == bool(one.icp.converged)
    # beside the junk pair, the real ones register (tests/golden_specs.py's
    # ground-truth floor, 5 deg / 2 m)
    for b, gt in enumerate(gts):
        assert bool(batch.solution.valid[b])
        rerr = math.degrees(float(rotation_geodesic_error(
            torch.from_numpy(gt[:3, :3].astype(np.float32)),
            batch.solution.rotation[b])))
        terr = float(np.linalg.norm(batch.solution.translation[b].numpy()
                                    - gt[:3, 3]))
        assert rerr < 5.0 and terr < 2.0, (b, rerr, terr)


# ------------------------------------------------- against the JAX one --

def test_register_batch_matches_jax():
    pairs = [make_correspondences(seed=s) for s in range(4)]
    src = np.stack([p[0] for p in pairs])
    tgt = np.stack([p[1] for p in pairs])
    mask = np.ones(src.shape[:2], bool)
    ref = jax_register_batch(jnp.asarray(src), jnp.asarray(tgt),
                             jnp.asarray(mask))
    got = register_batch(src, tgt, mask, qt.SolverConfig(), device="cpu")
    for name in ("valid", "max_clique_mask", "final_inlier_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    transform = got.transform().numpy()
    assert transform.shape == (4, 4, 4)
    np.testing.assert_array_equal(transform[:, 3],
                                  np.tile([0, 0, 0, 1], (4, 1)))
    for b, p in enumerate(pairs):
        drot = float(rotation_geodesic_error(
            torch.from_numpy(np.array(ref.rotation[b])), got.rotation[b]))
        assert drot < 1e-4, drot
        np.testing.assert_allclose(got.translation[b].numpy(),
                                   np.asarray(ref.translation[b]), atol=1e-3)
        np.testing.assert_allclose(transform[b], p[2], atol=0.05)
        _same_solution(got.row(b), register_correspondences(
            src[b], tgt[b], mask[b], qt.SolverConfig(), device="cpu"))


def test_register_features_batch_matches_jax_vmap():
    specs = [s for s in GOLDEN_SPECS if s["name"] in ("level_a", "level_b")]
    jc = jcfg.PipelineConfig.for_lidar("VLP-16", max_voxels=2048)
    jc = dataclasses.replace(
        jc, fpfh=dataclasses.replace(jc.fpfh, max_correspondences=512),
        solver=jcfg.SolverConfig(use_pallas_graph=False))
    clouds = []
    for spec in specs:
        src, tgt, _ = make_scan_pair(
            lidar=VLP16, seed=spec["seed"], yaw_deg=spec["yaw_deg"],
            translation=spec["translation"])
        clouds.append([qt.PointBatch.from_numpy(
            xyz[xyz[:, 2] > -1.723 + 0.3], RAW) for xyz in (src, tgt)])
    src_b = _stack([c[0] for c in clouds])
    tgt_b = _stack([c[1] for c in clouds])

    def jax_batch(b):
        return JaxPointBatch(jnp.asarray(b.points.numpy()),
                             jnp.asarray(b.mask.numpy()))

    ref = jax.jit(jax.vmap(lambda s, t: jax_register(s, t, jc)))(
        jax_batch(src_b), jax_batch(tgt_b))
    got = qt.register_features(src_b, tgt_b,
                               qt.config_from_dict(dataclasses.asdict(jc)),
                               device="cpu")
    for b in range(len(specs)):
        assert bool(got.solution.valid[b])
        drot = math.degrees(float(rotation_geodesic_error(
            torch.from_numpy(np.array(ref.solution.rotation[b])),
            got.solution.rotation[b])))
        dtr = float(np.linalg.norm(np.asarray(ref.solution.translation[b])
                                   - got.solution.translation[b].numpy()))
        assert drot < ROT_BAND_DEG and dtr < TRANS_BAND_M, (b, drot, dtr)


# ------------------------------------------------------ per module ------

def test_vote_hypotheses_batch_matches_jax_vmap():
    pairs = [make_correspondences(seed=s, n_inliers=40, n_outliers=200)
             for s in (3, 4)]
    src = np.stack([p[0] for p in pairs])
    tgt = np.stack([p[1] for p in pairs])
    mask = np.ones(src.shape[:2], bool)
    mask[1, 200:] = False
    adj = tim_consistency_graph(torch.from_numpy(src), torch.from_numpy(tgt),
                                torch.from_numpy(mask), 0.1)
    masks, sizes = vote_hypotheses(
        torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(mask),
        adj, torch.ones(2), num_hyps=2, bin_m=0.75)
    ref_masks, ref_sizes = jax.vmap(
        lambda s, d, m, a: jax_vote(s, d, m, a, jnp.asarray(1.0),
                                    num_hyps=2, bin_m=0.75))(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
        jnp.asarray(adj.numpy()))
    assert masks.shape == (2, 2, src.shape[1])
    np.testing.assert_array_equal(masks.numpy(), np.asarray(ref_masks))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(ref_sizes))
    assert int(sizes[0].max()) >= 20


def _corner_scene(n_per_face=400, seed=0):
    """Points on three orthogonal planes with exact normals
    (tests/test_icp.py's scene)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 10, (n_per_face, 2)).astype(np.float32)
    zero = np.zeros(n_per_face)
    pts = np.concatenate([np.stack([u[:, 0], u[:, 1], zero], 1),
                          np.stack([zero, u[:, 0], 0.5 * u[:, 1]], 1),
                          np.stack([u[:, 0], zero, 0.5 * u[:, 1]], 1)])
    nrm = np.concatenate([np.tile(v, (n_per_face, 1)) for v in
                          ([0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0])])
    return pts.astype(np.float32), nrm.astype(np.float32)


def test_refine_icp_batch_matches_jax_vmap():
    tgt, nrm = _corner_scene(seed=4)
    srcs = []
    for axis, deg, trans in (([0, 0, 1.0], 2.0, [0.1, 0, 0]),
                             ([0.3, -0.2, 1.0], 3.0, [0.2, -0.1, 0.05]),
                             ([1.0, 0, 0], 1.0, [0, 0.15, -0.1])):
        rot = exp_so3(torch.tensor(axis, dtype=torch.float32)
                      / float(np.linalg.norm(axis))
                      * math.radians(deg)).numpy()
        srcs.append(((tgt - np.float32(trans)) @ rot).astype(np.float32))
    src = np.stack(srcs)
    n = tgt.shape[0]
    mask = np.ones((3, n), bool)
    mask[2, ::3] = False
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (3, 3, 3))
    zero = np.zeros((3, 3), np.float32)
    tgt_b = np.broadcast_to(tgt, (3, n, 3))
    nrm_b = np.broadcast_to(nrm, (3, n, 3))
    ones = np.ones((3, n), bool)
    jc = jcfg.IcpConfig(iterations=6, max_source_points=512)
    tc = qt.IcpConfig(iterations=6, max_source_points=512)
    ref = jax.vmap(lambda s, m: jax_icp(
        s, m, jnp.asarray(tgt), jnp.ones(n, bool), jnp.asarray(nrm),
        jnp.ones(n, bool), jnp.eye(3), jnp.zeros(3), jc))(
        jnp.asarray(src), jnp.asarray(mask))
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (src, mask, tgt_b, ones, nrm_b, ones, eye, zero)]
    got = refine_icp(*args, tc)
    assert got.rotation.shape == (3, 3, 3)
    assert bool(got.converged.all())
    np.testing.assert_array_equal(got.num_inliers.numpy(),
                                  np.asarray(ref.num_inliers))
    for b in range(3):
        drot = float(rotation_geodesic_error(
            torch.from_numpy(np.array(ref.rotation[b])), got.rotation[b]))
        assert drot < 1e-5, drot
        np.testing.assert_allclose(got.translation[b].numpy(),
                                   np.asarray(ref.translation[b]), atol=1e-4)
        one = refine_icp(*(a[b] for a in args), tc)
        assert int(one.num_inliers) == int(got.num_inliers[b])
        drot = float(rotation_geodesic_error(one.rotation, got.rotation[b]))
        assert drot <= 1e-5
        assert float((one.translation - got.translation[b]).abs().max()) \
            <= 1e-4


@pytest.mark.parametrize("n", [1000, 1001, 1024])
def test_consistency_graph_plain_pair_axis_is_per_pair(n):
    rng = np.random.default_rng(n)
    src = rng.uniform(-30, 30, (3, n, 3)).astype(np.float32)
    tgt = (src + rng.normal(0, 0.5, src.shape)).astype(np.float32)
    src, tgt = torch.from_numpy(src), torch.from_numpy(tgt)
    got = kernels.consistency_graph(src, tgt, 0.2)
    assert got.shape == (3, n, n)
    for b in range(3):
        assert torch.equal(got[b], kernels.consistency_graph(src[b], tgt[b],
                                                             0.2))


@pytest.mark.parametrize("e", [1500, 2048, 65536])
def test_pair_segment_sums_is_per_pair(e):
    """One B2 call over three pairs' entries (padded to a chunk boundary
    where e is not a multiple of 1024) equals each pair's own call bit
    for bit, dropped ids (num_bins and beyond) included."""
    rng = np.random.default_rng(e)
    bins = 256
    ids = torch.from_numpy(rng.integers(0, bins + 2, (3, e)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(0, 3, (3, 3, e)).astype(np.float32))
    got = pair_segment_sums(ids, vals, bins)
    for b in range(3):
        assert torch.equal(got[b], segment.segment_sums(
            ids[b].contiguous(), vals[b].contiguous(), bins))


# ---------------------------------------------------------- sequence ----

def test_run_sequence_registers_only_real_edges(monkeypatch):
    """Three edges in a chunk of 4: the batched call registers the three,
    and the SequenceResult equals the one of the per-pair loop over the
    chunk padded to 4 (what the sequence did before)."""
    cfg = qt.PipelineConfig(lidar=VLP16, max_voxels=2048,
                            fpfh=qt.FPFHConfig(max_correspondences=512))
    scans, gt = sequence.make_synthetic_sequence(
        num_poses=4, seed=5, radius=6.0, config=cfg, raw_capacity=RAW)
    kw = dict(gt_poses=gt, loop_candidates=[], batch_size=4, device="cpu")
    Runner = odometry.OdometryRunner
    orig = Runner.register_pairs
    rows = []

    def counting(self, src, tgt):
        rows.append(src.voxels.shape[0])
        return orig(self, src, tgt)

    monkeypatch.setattr(Runner, "register_pairs", counting)
    res = sequence.run_sequence(scans, cfg, **kw)
    assert rows == [3] and res.edges_total == 3

    def padded_loop(self, src, tgt):
        pad = [src.voxels.shape[0] - 1] * (4 - src.voxels.shape[0])
        out = [self._register_verify_impl(
            odometry.FrameFeatures.stack([src.row(k)]),
            odometry.FrameFeatures.stack([tgt.row(k)]))
               for k in list(range(src.voxels.shape[0])) + pad]
        return (qt.RegistrationSolution.stack([s.row(0) for s, _ in out]),
                torch.cat([o for _, o in out]))

    monkeypatch.setattr(Runner, "register_pairs", padded_loop)
    ref = sequence.run_sequence(scans, cfg, **kw)
    np.testing.assert_array_equal(res.edges_i, ref.edges_i)
    np.testing.assert_array_equal(res.edges_j, ref.edges_j)
    np.testing.assert_array_equal(res.edge_mask, ref.edge_mask)
    assert res.edges_valid == ref.edges_valid
    np.testing.assert_allclose(res.poses, ref.poses, atol=1e-5)
    assert abs(res.ate_before - ref.ate_before) <= 1e-5
    assert abs(res.ate_after - ref.ate_after) <= 1e-5
