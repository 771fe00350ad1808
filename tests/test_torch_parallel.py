"""parallel/ of the port (the pairs mesh over torch.distributed, sharded
registration, the loop-closing and raw-scan steps, the pose graph's J^T
all-reduce, the collective profile) against the JAX package's on the CPU.

Inputs are numpy from seeds (tests/test_parallel.py's fixtures), handed to
both packages; the JAX functions run on tests/conftest.py's 8-device
virtual CPU mesh, the port on ``device="cpu"``, without a process group
or on a one-rank gloo group formed through a file store (so that test
workers never race for a TCP port). Tolerances:
- on a mesh of one, every sharded function equals the unsharded
  composition bit for bit (registration, the pose graph with and without
  ``psum_axis``, both steps);
- the port's sharded registration against the JAX package's: rotation
  within 1e-4, translation within 1e-3 (tests/test_parallel.py:33-36);
- the loop-closing step's poses against the JAX step's within 1e-5 m /
  rad (STEP_TOL; measured 8.3e-7: f32 CG at 6 x 24 on the two packages'
  own solutions, which lie 2.4e-6 m apart);
- two ranks (tests/torch_mp_worker.py): rows exactly or within 1e-5 rad /
  1e-4 m, all-reduced poses within 1e-4 of the one-rank solve (measured 0
  on the ring: each pose's J^T sum has two terms, which add the same in
  any order).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import quatro_tpu.parallel as jpar
from quatro_tpu.io.synthetic import make_correspondences

import quatro_tpu_torch as qt
import quatro_tpu_torch.eval as teval
import quatro_tpu_torch.parallel as tpar
from quatro_tpu_torch.io.synthetic import make_scan_pair
from quatro_tpu_torch.parallel import posegraph as tpg
from quatro_tpu_torch.parallel.diagnostics import collective_profile
from quatro_tpu_torch.parallel.distributed import (global_pairs_mesh,
                                                   initialize_multihost,
                                                   local_batch_slice)
from quatro_tpu_torch.parallel.mesh import PairsMesh, RowBlock
from quatro_tpu_torch.pipeline import register_scan_pair
from quatro_tpu_torch.solver.quatro import register_batch

WORKER = os.path.join(os.path.dirname(__file__), "torch_mp_worker.py")
sys.path.insert(0, os.path.dirname(__file__))
from torch_mp_worker import ring  # noqa: E402

CPU = torch.device("cpu")
GN, CG = 6, 24
STEP_TOL = 1e-5
FIELDS = [f.name for f in dataclasses.fields(qt.RegistrationSolution)]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo group for the test's duration."""
    initialize_multihost(f"file://{tmp_path}/store", num_processes=1,
                         process_id=0, backend="gloo")
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _mesh(kind):
    """A mesh of one: without a process group, or on the one-rank group."""
    mesh = tpar.make_pairs_mesh(devices="cpu")
    assert (mesh.group is None) == (kind == "none")
    return mesh


def _same(got, ref):
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def _composed(sols, ei, ej, poses0):
    """The unsharded composition's tail: edges from the solutions
    (weight max(final inliers, 1), mask valid), then the pose graph with
    no psum axis at the steps' trip counts."""
    t_meas, yaw = tpg.solution_to_edge(sols.translation, sols.rotation)
    weight = torch.clamp_min(sols.final_inlier_mask.sum(-1).float(), 1.0)
    edges = tpg.PoseGraphEdges(torch.from_numpy(ei), torch.from_numpy(ej),
                               t_meas, yaw, weight, sols.valid)
    return tpar.optimize_pose_graph(torch.from_numpy(poses0), edges,
                                    poses0.shape[0], gn_iters=GN,
                                    cg_iters=CG)


# ---------------------------------------------------------------- mesh ----

def test_mesh_without_a_group():
    assert tpar.PAIRS_AXIS == jpar.PAIRS_AXIS == "pairs"
    assert tpar.__all__ == jpar.__all__
    assert not dist.is_initialized()
    for mesh in (tpar.make_pairs_mesh(devices="cpu"),
                 tpar.make_pairs_mesh(1, devices="cpu"),
                 global_pairs_mesh(devices="cpu")):
        assert mesh == PairsMesh(None, 1, 0, CPU)
        assert tpar.pairs_sharding(mesh).rows(8) == slice(0, 8)
        assert tpar.replicated(mesh).rows(8) == slice(0, 8)
    with pytest.raises(ValueError, match="initialize_multihost"):
        tpar.make_pairs_mesh(2, devices="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_pairs_mesh()              # the card, by default
    assert local_batch_slice(8) == slice(0, 8)
    assert RowBlock(1, 2).rows(8) == slice(4, 8)
    assert RowBlock(2, 3).rows(9) == slice(6, 9)
    with pytest.raises(ValueError, match="not divisible"):
        RowBlock(0, 3).rows(8)


def test_mesh_on_a_group(group):
    mesh = tpar.make_pairs_mesh(devices="cpu")
    assert mesh == PairsMesh(group, 1, 0, CPU) == global_pairs_mesh("cpu")
    assert local_batch_slice(8) == slice(0, 8)
    with pytest.raises(ValueError, match="world of 1"):
        tpar.make_pairs_mesh(2, devices="cpu")


def test_collective_profile_counts_calls(group):
    """Counts every collective a call issues, by the JAX package's names,
    and puts torch.distributed's functions back, also when it raises."""
    originals = (dist.all_reduce, dist.broadcast)

    def fn(x):
        dist.all_reduce(x)
        dist.all_reduce(x, group=group)
        dist.broadcast(x, src=0)

    x = torch.ones(3)
    assert collective_profile(fn, x) == {"all-reduce": 2,
                                         "collective-broadcast": 1}
    assert torch.equal(x, torch.ones(3))
    assert (dist.all_reduce, dist.broadcast) == originals

    def bad():
        dist.all_reduce(x)
        raise KeyError("out")

    with pytest.raises(KeyError):
        collective_profile(bad)
    assert (dist.all_reduce, dist.broadcast) == originals
    assert collective_profile(lambda: None) == {}


# -------------------------------------------------------- registration ----

@pytest.fixture(scope="module")
def corr8():
    """tests/test_parallel.py:21-36's 8 pairs, and the JAX package's
    sharded registration of them on its 8-device mesh."""
    pairs = [make_correspondences(seed=s, n_inliers=50, n_outliers=150)
             for s in range(8)]
    src = np.stack([p[0] for p in pairs]).astype(np.float32)
    tgt = np.stack([p[1] for p in pairs]).astype(np.float32)
    mask = np.ones(src.shape[:2], bool)
    jsol = jpar.sharded_register_batch(jpar.make_pairs_mesh())(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
    return src, tgt, mask, jsol


@pytest.mark.parametrize("kind", ["none", "group"])
def test_sharded_register_batch_mesh_of_one(corr8, kind, request):
    if kind == "group":
        request.getfixturevalue("group")
    src, tgt, mask, jsol = corr8
    mesh = _mesh(kind)
    fn = tpar.sharded_register_batch(mesh)
    out = []
    assert collective_profile(lambda: out.append(fn(src, tgt, mask))) == {}
    sols, = out
    _same(sols, register_batch(src, tgt, mask, device="cpu"))
    assert bool(sols.valid.all())
    np.testing.assert_allclose(sols.rotation.numpy(),
                               np.asarray(jsol.rotation), atol=1e-4)
    np.testing.assert_allclose(sols.translation.numpy(),
                               np.asarray(jsol.translation), atol=1e-3)


# ---------------------------------------------------------- pose graph ----

def _loop_graph(num_poses=9, seed=0, noise=0.01, drift=0.15):
    """tests/test_parallel.py:40-78's loop as numpy: ground truth, initial
    poses and the edge arrays (odometry plus one closure)."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((num_poses, 4))
    for k in range(1, num_poses):
        gt[k, 3] = gt[k - 1, 3] + 2 * np.pi / num_poses
        c, s = np.cos(gt[k - 1, 3]), np.sin(gt[k - 1, 3])
        gt[k, :3] = gt[k - 1, :3] + np.array(
            [c * 2.0 - s * 0.3, s * 2.0 + c * 0.3, 0.02])
    ei, ej, t, y = [], [], [], []
    for i, j in [(k, k + 1) for k in range(num_poses - 1)] + [
            (num_poses - 1, 0)]:
        c, s = np.cos(gt[i, 3]), np.sin(gt[i, 3])
        dt = gt[j, :3] - gt[i, :3]
        ei.append(i)
        ej.append(j)
        t.append(np.array([c * dt[0] + s * dt[1], -s * dt[0] + c * dt[1],
                           dt[2]]) + rng.normal(0, noise, 3))
        y.append(gt[j, 3] - gt[i, 3] + rng.normal(0, noise))
    e = len(ei)
    arrays = (np.int32(ei), np.int32(ej), np.float32(t), np.float32(y),
              np.ones(e, np.float32), np.ones(e, bool))
    init = gt + np.concatenate(
        [np.zeros((1, 4)), rng.normal(0, drift, (num_poses - 1, 4))])
    init[0] = gt[0]
    return gt, init.astype(np.float32), arrays


def _chain_graph():
    """tests/test_parallel.py:148-177's chain with edge (1, 2) masked."""
    init = np.array([[0, 0, 0, 0], [1.0, 0, 0, 0], [2.0, 0.3, 0, 0],
                     [3.0, 0.3, 0, 0], [4.0, 0.3, 0, 0.2]], np.float32)
    arrays = (np.int32([0, 1, 2, 3]), np.int32([1, 2, 3, 4]),
              np.float32([[1, 0, 0]] * 4), np.zeros(4, np.float32),
              np.full(4, 30.0, np.float32),
              np.array([True, False, True, True]))
    return None, init, arrays


def _no_edges():
    _, init, arrays = _chain_graph()
    return None, init, tuple(a[:0] for a in arrays)


GRAPHS = {"closes_loop": (_loop_graph, 10, 40),
          "anchor": (lambda: _loop_graph(seed=3), 8, 32),
          "disconnected": (_chain_graph, 8, 32),
          "no_edges": (_no_edges, 8, 32)}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_pose_graph_psum_axis_one_rank(group, name):
    """psum_axis on a one-rank group: the same bits as psum_axis=None, one
    all-reduce per J^T apply (also with no edges: the rank takes part),
    and the JAX tests' bands on the result."""
    make, gn, cg = GRAPHS[name]
    gt, init, arrays = make()
    edges = tpg.PoseGraphEdges(*(torch.from_numpy(a) for a in arrays))
    m = init.shape[0]
    ref = tpar.optimize_pose_graph(torch.from_numpy(init), edges, m,
                                   gn_iters=gn, cg_iters=cg)
    mesh = _mesh("group")
    for axis in (mesh, group):
        out = []
        prof = collective_profile(lambda: out.append(tpar.optimize_pose_graph(
            torch.from_numpy(init), edges, m, gn_iters=gn, cg_iters=cg,
            psum_axis=axis)))
        assert prof == {"all-reduce": gn * (cg + 1)}
        assert torch.equal(out[0], ref)
    out = ref.numpy()
    assert np.isfinite(out).all()
    if name == "closes_loop":                 # test_parallel.py:81-90
        err_t = np.linalg.norm(out[:, :3] - gt[:, :3], axis=1)
        err_y = np.abs(tpar.wrap_angle(
            torch.from_numpy(out[:, 3] - gt[:, 3])).numpy())
        init_err = np.linalg.norm(init[:, :3] - gt[:, :3], axis=1)
        assert err_t.max() < 0.1 and err_y.max() < 0.05, (err_t, err_y)
        assert err_t.mean() < 0.5 * max(init_err.mean(), 1e-6)
    elif name == "anchor":                    # :93-97
        np.testing.assert_allclose(out[0], gt[0], atol=1e-3)
    elif name == "disconnected":              # :170-177
        np.testing.assert_allclose(out[1], [1, 0, 0, 0], atol=1e-3)
        np.testing.assert_allclose(out[3, :3] - out[2, :3], [1, 0, 0],
                                   atol=0.06)
        assert np.linalg.norm(out[2] - init[2]) < 1.0
    else:
        np.testing.assert_array_equal(out, init)


# --------------------------------------------------------------- steps ----

@pytest.fixture(scope="module")
def ring8():
    """The 8-pose ring and the JAX package's loop-closing step on it."""
    src, tgt, ei, ej, init, gt = ring()
    mask = np.ones(src.shape[:2], bool)
    jposes, jsols = jpar.make_loop_closing_step(jpar.make_pairs_mesh(), 8)(
        *(jnp.asarray(a) for a in (src, tgt, mask, ei, ej, init)))
    return (src, tgt, mask, ei, ej, init, gt), (np.asarray(jposes),
                                                np.asarray(jsols.valid))


@pytest.mark.parametrize("kind", ["none", "group"])
def test_loop_closing_step_ring(ring8, kind, request):
    """tests/test_parallel.py:101-145 on a mesh of one: the unsharded
    composition's bits, within 0.25 m of the truth and STEP_TOL of the JAX
    step; all-reduces only, one per J^T apply on a group."""
    if kind == "group":
        request.getfixturevalue("group")
    (src, tgt, mask, ei, ej, init, gt), (jposes, jvalid) = ring8
    step = tpar.make_loop_closing_step(_mesh(kind), 8)
    out = []
    prof = collective_profile(lambda: out.append(
        step(src, tgt, mask, ei, ej, init)))
    assert prof == ({} if kind == "none" else {"all-reduce": GN * (CG + 1)})
    (poses, sols), = out
    ref_sols = register_batch(src, tgt, mask, device="cpu")
    _same(sols, ref_sols)
    assert torch.equal(poses, _composed(ref_sols, ei, ej, init))
    assert bool(sols.valid.all()) and jvalid.all()
    err = np.linalg.norm(poses[:, :3].numpy() - gt[:, :3], axis=1)
    assert err.max() < 0.25, err
    np.testing.assert_allclose(poses.numpy(), jposes, atol=STEP_TOL)


def test_full_pipeline_step_vlp16(group):
    """The raw-scan step at VLP-16 scale (B = 2 pairs of 32768 raw points,
    2048 voxels, 128 correspondences) on a one-rank group: the bits of
    ``register_scan_pair`` at B = 2 followed by ``optimize_pose_graph``;
    the front end issues no collective."""
    raw = 32768
    cfg = qt.PipelineConfig.for_lidar(
        "VLP-16", max_voxels=2048, max_raw_points=raw,
        fpfh=dataclasses.replace(
            qt.FPFHConfig.for_lidar(qt.LidarConfig.preset("VLP-16")),
            max_correspondences=128))
    pairs = [make_scan_pair(seed=k, yaw_deg=8.0 + 3 * k,
                            translation=(1.5, 0.5, 0.0), lidar=cfg.lidar)
             for k in range(2)]
    clouds = [[qt.PointBatch.from_numpy(xyz, raw) for xyz in pair[:2]]
              for pair in pairs]
    src_pts, src_mask, tgt_pts, tgt_mask = (
        torch.stack([getattr(c[side], field) for c in clouds])
        for side in (0, 1) for field in ("points", "mask"))
    ei, ej = np.int32([0, 1]), np.int32([1, 0])
    poses0 = np.zeros((2, 4), np.float32)
    step = tpar.make_full_pipeline_step(_mesh("group"), 2, cfg)
    out = []
    prof = collective_profile(lambda: out.append(step(
        src_pts, src_mask, tgt_pts, tgt_mask, ei, ej, poses0)))
    assert prof == {"all-reduce": GN * (CG + 1)}
    (poses, sols), = out

    ref = register_scan_pair(qt.PointBatch(src_pts, src_mask),
                             qt.PointBatch(tgt_pts, tgt_mask), cfg,
                             device="cpu").solution
    _same(sols, ref)
    assert torch.equal(poses, _composed(ref, ei, ej, poses0))
    assert int(sols.valid.sum()) == 2 and bool(torch.isfinite(poses).all())


def test_two_process_gloo(tmp_path):
    """Two ranks over gloo, each on its local_batch_slice of the ring's 8
    pairs (tests/torch_mp_worker.py holds the checks); a hang fails the
    test after 120 s instead of eating the suite's clock."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(tmp_path / "store")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    deadline = time.monotonic() + 120
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail("the two gloo ranks timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    gaps = []
    for r, out in enumerate(outs):
        line, = [x for x in out.splitlines() if x.startswith(f"rank {r}: OK")]
        gaps.append(json.loads(line.split("OK ", 1)[1]))
    assert [g["rows"] for g in gaps] == [[0, 4], [4, 8]]
    assert gaps[0]["pose_gap"] == gaps[1]["pose_gap"] <= 1e-4
    assert gaps[0]["scaling"] == gaps[1]["scaling"]


# -------------------------------------------------------------- scaling ----

def test_evaluate_scaling_through_the_mesh(group, monkeypatch):
    """evaluate_scaling at a count of 1 on the one-rank group, through
    ``sharded_register_batch``; a count above the world size raises."""
    meshes = []
    sharded = teval.sharded_register_batch

    def spy(mesh, config):
        meshes.append(mesh)
        return sharded(mesh, config)

    monkeypatch.setattr(teval, "sharded_register_batch", spy)
    res = teval.evaluate_scaling(batch_per_device=2, n_corr=64, iters=1,
                                 device="cpu")
    assert set(res) == {1} and res[1]["pairs_per_s"] > 0
    assert res[1]["efficiency"] == 1.0
    assert meshes == [PairsMesh(group, 1, 0, CPU)]
    with pytest.raises(ValueError, match="world size 1"):
        teval.evaluate_scaling(device_counts=[1, 2], device="cpu")
