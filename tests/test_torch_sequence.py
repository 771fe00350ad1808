"""Loop closing: the pose graph, Scan Context, odometry and run_sequence of
the port against the JAX package on the CPU, at VLP-16 scale.

Inputs: numpy from seeds, handed to both packages. The sequences are
``make_synthetic_sequence`` loops (VLP-16, radius 6 m, 32768 raw points);
the Scan Context scans are those of tests/test_scancontext.py.

Tolerances, and what was measured on these inputs:
- pose graph: residuals and both Jacobian applies within 1e-5 (measured
  3e-8); ``optimize_pose_graph`` within 1e-5 once CG has converged (64 CG
  iterations; measured 1e-6), and within 1e-3 at run_sequence's 10 x 40,
  where f32 CG on this graph is not yet converged and both packages lie
  within 4.5e-4 of an f64 solve (measured 2.3e-4 apart); the disconnected
  pose stays where it started in both;
- Scan Context: every cell equal (the ring and sector rounding follows
  the JAX package's compiled arithmetic, ops/scancontext.py), ring keys
  exact, ``sc_distance`` within 1e-6, loop candidates equal;
- ``make_synthetic_sequence``: scans bit-identical, ground truth equal;
  the checkpoint fingerprints equal the JAX package's hex digests;
- ``FrameFeatures`` with ground alignment and ICP on, in the bands of
  tests/test_torch_refine.py: leveling within 1e-5 and its gate equal;
  raw-scan voxels within 1e-5, normal validity equal and normals within
  1e-3 on well-conditioned rows; voxel and descriptor masks equal. The
  leveled voxels lie within 1e-3 m (measured 2e-4): the leveled points
  differ from the JAX package's matrix product by an ulp, which moves
  points on a voxel face, and FPFH of those voxels differs accordingly
  (measured mean |diff| 0.13-0.18 per bin, 10 % of rows off by > 1 in a
  bin; on equal voxels tests/test_torch_frontend.py holds 0.02);
- ``register_pair``: within 3 deg / 1.5 m of the JAX pose
  (tests/golden_specs.py's drift band);
- ``run_sequence``: the JAX test's bands on its own 12-frame loop
  (tests/test_sequence.py:10-24; on the 8-frame seed-5 loop, whose 45 deg
  steps leave pairs with 2-8 final inliers of ~300 correspondences, the
  JAX package keeps 7 of 8 edges and the port 5 at any thread count:
  tests/torch_threads_loop.py, ROADMAP C); checkpoint,
  kill and resume on the 8-frame loop as tests/test_sequence.py:28-84;
  the windowed runner equal to ``step`` within 1e-5 rad / 1e-4 m
  (tests/test_sequence.py:154-191).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu import sequence as jseq
from quatro_tpu.io.synthetic import make_scene as jax_scene
from quatro_tpu.io.synthetic import raycast_scan as jax_raycast
from quatro_tpu.odometry import FrameFeatures as JaxFeatures
from quatro_tpu.odometry import OdometryRunner as JaxRunner
from quatro_tpu.odometry import load_frame_features as jax_load
from quatro_tpu.odometry import save_frame_features as jax_save
from quatro_tpu.ops import scancontext as jsc
from quatro_tpu.parallel import posegraph as jpg

import quatro_tpu_torch as qt
from quatro_tpu_torch import odometry, sequence
from quatro_tpu_torch.io.kitti import load_kitti_bin, save_kitti_bin
from quatro_tpu_torch.ops import scancontext as tsc
from quatro_tpu_torch.parallel import posegraph as tpg
from quatro_tpu_torch.utils.se3 import rotation_geodesic_error

from golden_specs import ROT_BAND_DEG, TRANS_BAND_M

RAW = 32768
VLP16 = jcfg.LidarConfig.preset("VLP-16")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_cfg(jc):
    return qt.config_from_dict(dataclasses.asdict(jc))


# the sequence tests' configuration (tests/test_sequence.py)
SEQ_JCFG = jcfg.PipelineConfig(lidar=VLP16, max_voxels=2048,
                               fpfh=jcfg.FPFHConfig(max_correspondences=512))
# the odometry tests': path A's at VLP-16 scale, recommended solver with
# ground alignment and ICP
ODO_JCFG = jcfg.PipelineConfig.for_lidar(
    "VLP-16", max_voxels=2048, max_raw_points=RAW,
    fpfh=dataclasses.replace(jcfg.FPFHConfig.for_lidar(VLP16),
                             max_correspondences=512),
    solver=jcfg.SolverConfig(num_hypotheses=4, num_vote_hypotheses=2),
    ground_alignment=jcfg.GroundAlignmentConfig(enabled=True),
    icp=jcfg.IcpConfig(enabled=True))


@pytest.fixture(scope="module")
def seq8():
    """The 8-pose seed-5 loop of tests/test_sequence.py, from both
    packages."""
    tscans, tgt = sequence.make_synthetic_sequence(
        num_poses=8, seed=5, radius=6.0, config=_port_cfg(SEQ_JCFG),
        raw_capacity=RAW)
    jscans, jgt = jseq.make_synthetic_sequence(
        num_poses=8, seed=5, radius=6.0, config=SEQ_JCFG, raw_capacity=RAW)
    return tscans, tgt, jscans, jgt


def test_make_synthetic_sequence_matches(seq8):
    tscans, tgt, jscans, jgt = seq8
    for t, j in zip(tscans, jscans):
        np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(tgt, jgt)
    assert tgt.dtype == np.float32 and tgt.shape == (8, 4)


@pytest.mark.parametrize("cfg", [
    jcfg.PipelineConfig(), SEQ_JCFG, ODO_JCFG,
    jcfg.PipelineConfig.recommended(max_voxels=8192)],
    ids=["default", "sequence", "odometry", "recommended"])
def test_fingerprints_match(cfg):
    """Both digests equal the JAX package's (both hash the dataclass
    reprs), and are scoped as its own (tests/test_sequence.py:87-107)."""
    tc = _port_cfg(cfg)
    assert sequence._feature_fingerprint(tc) == jseq._feature_fingerprint(cfg)
    for gate in ((2, 0.35), (5, 0.0)):
        assert sequence._edge_fingerprint(tc, *gate) == \
            jseq._edge_fingerprint(cfg, *gate)
    solver_changed = dataclasses.replace(tc, solver=qt.SolverConfig(
        noise_bound=0.5))
    extract_changed = dataclasses.replace(tc, voxel_size=0.4)
    fp = sequence._feature_fingerprint
    assert fp(tc) == fp(solver_changed) != fp(extract_changed)
    ep = sequence._edge_fingerprint
    assert ep(tc, 5, 0.35) != ep(solver_changed, 5, 0.35)
    assert ep(tc, 5, 0.35) != ep(tc, 50, 0.35) != ep(tc, 50, 0.0)


# ------------------------------------------------------------ pose graph --

def _graph(rng, m=12):
    """A 12-pose loop with four closures, noisy measurements and initial
    poses, random weights; the two edges at pose 4 masked, so pose 4 is a
    component of its own with no path to pose 0."""
    gt = np.zeros((m, 4))
    for k in range(m):
        a = 2 * np.pi * k / m
        gt[k] = [6 * np.cos(a) - 6, 6 * np.sin(a), 0.1 * k,
                 math.atan2(math.sin(a + np.pi / 2), math.cos(a + np.pi / 2))]
    ei = list(range(m - 1)) + [0, 2, 7, 8]
    ej = list(range(1, m)) + [11, 9, 10, 11]
    t, y = [], []
    for i, j in zip(ei, ej):
        c, s = np.cos(gt[i, 3]), np.sin(gt[i, 3])
        d = gt[j, :3] - gt[i, :3]
        t.append([c * d[0] + s * d[1], -s * d[0] + c * d[1], d[2]])
        y.append(math.atan2(math.sin(gt[j, 3] - gt[i, 3]),
                            math.cos(gt[j, 3] - gt[i, 3])))
    e = len(ei)
    mask = np.ones(e, bool)
    mask[[3, 4]] = False
    arrays = (np.int32(ei), np.int32(ej),
              (np.array(t) + rng.normal(0, 0.05, (e, 3))).astype(np.float32),
              (np.array(y) + rng.normal(0, 0.01, e)).astype(np.float32),
              rng.uniform(5, 100, e).astype(np.float32), mask)
    p0 = (gt + rng.normal(0, 0.3, gt.shape)).astype(np.float32)
    p0[0] = gt[0]
    return (p0, jpg.PoseGraphEdges(*(jnp.asarray(a) for a in arrays)),
            tpg.PoseGraphEdges(*(torch.from_numpy(a) for a in arrays)))


def test_pose_graph_applies_match():
    rng = np.random.default_rng(7)
    p0, je, te = _graph(rng)
    jp, tp = jnp.asarray(p0), torch.from_numpy(p0)
    for ref, got in zip(jpg._edge_residuals(jp, je),
                        tpg._edge_residuals(tp, te)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    v = rng.normal(size=p0.shape).astype(np.float32)
    u = rng.normal(size=(je.i.shape[0], 4)).astype(np.float32)
    np.testing.assert_allclose(
        tpg._edge_jacobian_apply(tp, te, torch.from_numpy(v)).numpy(),
        np.asarray(jpg._edge_jacobian_apply(jp, je, jnp.asarray(v))),
        atol=1e-5)
    np.testing.assert_allclose(
        tpg._edge_jacobian_transpose_apply(tp, te, torch.from_numpy(u),
                                           12).numpy(),
        np.asarray(jpg._edge_jacobian_transpose_apply(jp, je,
                                                      jnp.asarray(u), 12)),
        atol=1e-5)
    rot = torch.tensor([[0.6, -0.8, 0.0], [0.8, 0.6, 0.0],
                        [0.0, 0.0, 1.0]]).expand(2, 3, 3)
    _, yaw = tpg.solution_to_edge(torch.zeros(2, 3), rot)
    np.testing.assert_allclose(yaw.numpy(), math.atan2(0.8, 0.6), atol=1e-6)


def test_optimize_pose_graph_matches():
    p0, je, te = _graph(np.random.default_rng(7))
    for gn, cg, tol in ((8, 64, 1e-5), (10, 40, 1e-3)):
        ref = np.asarray(jpg.optimize_pose_graph(jnp.asarray(p0), je, 12,
                                                 gn_iters=gn, cg_iters=cg))
        got = tpg.optimize_pose_graph(torch.from_numpy(p0), te, 12,
                                      gn_iters=gn, cg_iters=cg).numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=tol, err_msg=(gn, cg))
        np.testing.assert_array_equal(got[[0, 4]], p0[[0, 4]])
        assert np.abs(got - p0).max() > 0.1              # it moved
    empty = tpg.PoseGraphEdges(*(x[:0] for x in te))
    np.testing.assert_allclose(tpg.optimize_pose_graph(
        torch.from_numpy(p0), empty, 12).numpy(), p0, atol=1e-6)


# ----------------------------------------------------------- Scan Context --

@pytest.fixture(scope="module")
def spot_scans():
    """tests/test_scancontext.py:62-67's seven spots in the seed-3 scene,
    VLP-16, heading 40 deg more at each."""
    scene = jax_scene(seed=3)
    spots = [[0, 0], [8, 0], [16, 4], [24, 12], [16, 20], [8, 14],
             [0.5, 0.6]]
    return [jax_raycast(scene, np.asarray([x, y, 1.7], float),
                        np.deg2rad(40.0 * k), lidar=VLP16, seed=10 + k)
            for k, (x, y) in enumerate(spots)]


def test_scan_context_matches(spot_scans):
    """Every cell of every descriptor equal to the compiled JAX
    scan_context's, with a padded tail masked out; ring keys exact and the
    distances within 1e-6."""
    jd, td = [], []
    for xyz in spot_scans:
        pts = np.zeros((RAW, 3), np.float32)
        pts[:len(xyz)] = xyz
        pts[len(xyz):] = 5.0                      # masked out
        mask = np.arange(RAW) < len(xyz)
        jd.append(np.asarray(jsc.scan_context(jnp.asarray(pts),
                                              jnp.asarray(mask))))
        got = tsc.scan_context(torch.from_numpy(pts), torch.from_numpy(mask))
        assert got.shape == (20, 120) and got.dtype == torch.float32
        td.append(got)
        np.testing.assert_array_equal(got.numpy(), jd[-1])
        assert (jd[-1] > 0).sum() > 100
    tds = torch.stack(td)
    np.testing.assert_array_equal(tsc.ring_key(tds).numpy(),
                                  np.asarray(jsc.ring_key(jnp.asarray(
                                      np.stack(jd)))))
    for a, b in ((0, 6), (0, 1), (3, 5), (2, 2)):
        np.testing.assert_allclose(
            float(tsc.sc_distance(tds[a], tds[b])),
            float(jsc.sc_distance(jnp.asarray(jd[a]), jnp.asarray(jd[b]))),
            atol=1e-6)
    rolled = torch.roll(tds[0], 17, dims=-1)
    assert torch.equal(tsc.ring_key(rolled), tsc.ring_key(tds[0]))
    assert float(tsc.sc_distance(rolled, tds[0])) < 1e-6


def test_detect_loop_candidates_matches(spot_scans):
    """On the JAX package's descriptors both packages list the same
    candidates, the revisit (0, 6) among them."""
    descs = np.stack([np.asarray(jsc.scan_context(
        jnp.asarray(x), jnp.ones(len(x), bool))) for x in spot_scans])
    for kw in ({"min_gap": 3}, {"min_gap": 1, "ring_prune": 2},
               {"min_gap": 2, "max_distance": 0.8}):
        ref = jsc.detect_loop_candidates(jnp.asarray(descs), **kw)
        got = tsc.detect_loop_candidates(torch.from_numpy(descs), **kw)
        assert got == ref, kw
    assert (0, 6) in tsc.detect_loop_candidates(torch.from_numpy(descs))


# -------------------------------------------------------------- odometry --

@pytest.fixture(scope="module")
def odo_frames(seq8):
    """Frames 0 and 1 of the sequence through both packages' extraction
    under the odometry configuration."""
    tscans, _, jscans, _ = seq8
    jr = JaxRunner(ODO_JCFG)
    tr = odometry.OdometryRunner(_port_cfg(ODO_JCFG), device="cpu")
    return ([jr.extract(s) for s in jscans[:2]],
            [tr.extract(s) for s in tscans[:2]], jr, tr)


def test_frame_features_match(odo_frames):
    jf, tf, _, _ = odo_frames
    for ref, got in zip(jf, tf):
        for name in ("voxel_mask", "desc_mask", "ground_ok",
                     "raw_voxel_mask", "raw_normal_valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
        assert bool(got.ground_ok)
        for name in ("level", "ground_height", "raw_voxels"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got.voxels.numpy(),
                                   np.asarray(ref.voxels), atol=1e-3)
        valid = np.asarray(ref.raw_normal_valid)
        dn = np.abs(got.raw_normals.numpy() - np.asarray(ref.raw_normals))
        # up to sign and ill-conditioned rows: > 85 % of the valid rows
        # within 1e-3 (measured 89-91 %)
        close = (dn.max(1) <= 1e-3)[valid]
        assert close.mean() > 0.85, close.mean()
        dm = np.asarray(ref.desc_mask)
        dd = np.abs(got.descriptors.numpy()
                    - np.asarray(ref.descriptors))[dm]
        assert dd.mean() < 0.5 and (dd.max(1) > 1.0).mean() < 0.25
        assert dm.sum() > 1000 and valid.sum() > 1000


def test_register_pair_within_drift_band(odo_frames):
    jf, tf, jr, tr = odo_frames
    ref = jr.register_pair(jf[0], jf[1])
    got = tr.register_pair(tf[0], tf[1])
    assert bool(ref.valid) and bool(got.valid)
    drot = math.degrees(float(rotation_geodesic_error(
        torch.from_numpy(np.array(ref.rotation)), got.rotation)))
    dt = float(np.linalg.norm(got.translation.numpy()
                              - np.asarray(ref.translation)))
    assert drot < ROT_BAND_DEG and dt < TRANS_BAND_M, (drot, dt)
    # 45 deg of yaw between consecutive poses of the 8-pose loop
    yaw = math.degrees(math.atan2(float(got.rotation[1, 0]),
                                  float(got.rotation[0, 0])))
    assert abs(abs(yaw) - 45.0) < 5.0, yaw


def test_frame_feature_caches_cross_load(odo_frames, tmp_path):
    """An .npz written by either package loads in the other, every field
    equal."""
    jf, tf, _, _ = odo_frames
    odometry.save_frame_features(str(tmp_path / "port.npz"), tf[0])
    jax_save(str(tmp_path / "jax.npz"), jf[0])
    from_port = jax_load(str(tmp_path / "port.npz"))
    from_jax = odometry.load_frame_features(str(tmp_path / "jax.npz"))
    for f in dataclasses.fields(JaxFeatures):
        np.testing.assert_array_equal(np.asarray(getattr(from_port, f.name)),
                                      getattr(tf[0], f.name).numpy())
        got = getattr(from_jax, f.name)
        assert got.dtype == getattr(tf[0], f.name).dtype, f.name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jf[0], f.name)))
    with pytest.raises(FileNotFoundError):
        odometry.load_frame_features(str(tmp_path / "missing.npz"))


def test_windowed_odometry_matches_step(seq8, tmp_path):
    """run_odometry_windowed (window=3 over 4 frames: a full window and a
    tail of one) equals the frame-by-frame OdometryRunner.step, and so do
    run_odometry_files and run_odometry_files_windowed (window=2) on
    KITTI .bin files of the same frames."""
    tscans = seq8[0][:4]
    cfg = _port_cfg(ODO_JCFG)
    runner = odometry.OdometryRunner(cfg, device="cpu")
    ref = [runner.step(s) for s in tscans]
    stats = {}
    out = {i: s for i, s, _ in odometry.run_odometry_windowed(
        ((s.points.numpy(), s.mask.numpy()) for s in tscans), cfg, window=3,
        stats=stats, device="cpu")}
    assert ref[0] is None and out[0] is None and sorted(out) == [0, 1, 2, 3]
    assert stats["dispatch_s"] > 0 and stats["fetch_s"] >= 0
    paths = []
    for k, s in enumerate(tscans):
        paths.append(str(tmp_path / f"{k:06d}.bin"))
        save_kitti_bin(paths[-1], s.to_numpy())
        np.testing.assert_array_equal(load_kitti_bin(paths[-1]), s.to_numpy())
    files = dict(odometry.run_odometry_files(paths, cfg, capacity=RAW,
                                             device="cpu"))
    files_w = {i: s for i, s, _ in odometry.run_odometry_files_windowed(
        paths, cfg, window=2, capacity=RAW, device="cpu")}
    assert files[0] is None and files_w[0] is None
    for k in range(1, 4):
        for b in (out[k], files[k], files_w[k]):
            assert bool(ref[k].valid) == bool(b.valid)
            np.testing.assert_allclose(b.rotation.numpy(),
                                       ref[k].rotation.numpy(), atol=1e-5)
            np.testing.assert_allclose(b.translation.numpy(),
                                       ref[k].translation.numpy(), atol=1e-4)


# -------------------------------------------------------------- sequence --

SEQ_KW = dict(loop_radius=5.0, checkpoint_every=2, batch_size=2)


def test_run_sequence_bands():
    """tests/test_sequence.py:10-24 on its own inputs (12 poses, seed 1:
    30 deg and 3.1 m between frames), with its bands: 11 odometry edges
    and the (0, 11) closure, >= 70 % of the edges valid, ATE after the
    closure below 1 m and no worse than before by more than 5 cm."""
    cfg = _port_cfg(SEQ_JCFG)
    scans, gt = sequence.make_synthetic_sequence(
        num_poses=12, seed=1, radius=6.0, config=cfg, raw_capacity=RAW)
    res = sequence.run_sequence(scans, cfg, gt_poses=gt, loop_radius=5.0,
                                batch_size=4, device="cpu")
    assert res.edges_total == 12 and (0, 11) in zip(res.edges_i, res.edges_j)
    assert res.edges_valid >= res.edges_total * 0.7, \
        f"{res.edges_valid}/{res.edges_total} edges valid"
    assert np.isfinite(res.poses).all() and res.poses.dtype == np.float32
    assert res.ate_after < 1.0, res.ate_after
    assert res.ate_after <= res.ate_before + 0.05, \
        (res.ate_before, res.ate_after)


def test_run_sequence_checkpoint_resume(seq8, tmp_path, monkeypatch):
    """tests/test_sequence.py:28-84 on the 8-pose seed-5 loop: kill a
    checkpointed run after 2 batches of 2 edges; the resumed run loads the
    features, skips the 4 registered edges and equals an uncheckpointed
    run; a checkpoint of another plan is ignored."""
    tscans, gt, _, _ = seq8
    cfg = _port_cfg(SEQ_JCFG)
    ckpt = str(tmp_path / "ckpt")
    Runner = odometry.OdometryRunner
    orig = Runner.register_pairs
    calls = {"n": 0}

    def dying(self, src, tgt):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt("simulated kill")
        return orig(self, src, tgt)

    monkeypatch.setattr(Runner, "register_pairs", dying)
    with pytest.raises(KeyboardInterrupt):
        sequence.run_sequence(tscans, cfg, gt_poses=gt, checkpoint_dir=ckpt,
                              device="cpu", **SEQ_KW)
    resumed = {"n": 0}

    def counting(self, src, tgt):
        resumed["n"] += 1
        return orig(self, src, tgt)

    monkeypatch.setattr(Runner, "register_pairs", counting)
    monkeypatch.setattr(Runner, "extract",
                        lambda self, s: pytest.fail("re-extracted features"))
    res = sequence.run_sequence(tscans, cfg, gt_poses=gt,
                                checkpoint_dir=ckpt, device="cpu", **SEQ_KW)
    assert resumed["n"] == -(-(res.edges_total - 4) // 2)
    monkeypatch.undo()
    fresh = sequence.run_sequence(tscans, cfg, gt_poses=gt, device="cpu",
                                  **SEQ_KW)
    assert fresh.edges_total == 8
    np.testing.assert_allclose(res.poses, fresh.poses, atol=1e-5)
    assert res.edges_valid == fresh.edges_valid
    res2 = sequence.run_sequence(tscans[:6], cfg, gt_poses=gt[:6],
                                 loop_radius=5.0, checkpoint_dir=ckpt,
                                 checkpoint_every=2, device="cpu")
    assert res2.edges_total < res.edges_total


def test_entry_points_need_a_card_by_default(seq8):
    """OdometryRunner and run_sequence run on the card unless the caller
    asks for the CPU; without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _port_cfg(SEQ_JCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        odometry.OdometryRunner(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sequence.run_sequence(seq8[0][:2], cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(odometry.run_odometry_windowed(iter([]), cfg))
