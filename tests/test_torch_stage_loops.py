"""The stages that run as device loops or one batched call since the
voxel grid, ICP, labelling, Patchwork's fits and overlap arbitration took
the JAX package's execution model, on the CPU at VLP-16 scale.

- The voxel grid of a batch of clouds in one call gives each cloud the
  bits of its own call (every operation works along a cloud's row), at 1,
  3 and 8 clouds of different valid counts (one empty), with and without
  ``active_cap``.
- ``refine_icp`` (a ``fori`` over its passes), ``label_components`` (a
  ``while_chunks`` over its rounds, the CPU's route; one kernel launch on
  the card) and ``estimate_ground`` (a ``fori``
  over its bf16 plane fits) give the same bits under
  ``eager_loops(chunk=1)`` (a flag read per round) and at their default
  chunk, and agree with the JAX package's functions on the same numpy
  inputs within the tolerances of tests/test_torch_refine.py and
  tests/test_torch_preprocessing.py; ICP and Patchwork read no flag, and
  labelling at most ceil(rounds / chunk) + 1.
- ``alignment_overlap`` over fixed blocks (a ``fori``) at B = 1, 8 and 64
  pairs of K = 3 poses equals the per-pair call on every pose: the share
  is an integer count over the blocks.

The CUDA-graph route of each loop is held against ``eager_loops()`` on
the card (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.preprocessing import patchwork as jpw
from quatro_tpu.preprocessing import projection as jpr
from quatro_tpu.solver.icp import refine_icp as jax_icp

import quatro_tpu_torch as qt
import quatro_tpu_torch.config as tcfg
from quatro_tpu_torch.io.synthetic import make_scan_pair
from quatro_tpu_torch.ops.labels import CC_CHUNK
from quatro_tpu_torch.ops.voxel import voxel_downsample
from quatro_tpu_torch.pipeline import raw_scan_normals, raw_scan_voxels
from quatro_tpu_torch.preprocessing import patchwork as tpw
from quatro_tpu_torch.preprocessing import projection as tpr
from quatro_tpu_torch.solver.icp import refine_icp
from quatro_tpu_torch.solver.verify import alignment_overlap
from quatro_tpu_torch.utils import loops
from quatro_tpu_torch.utils.se3 import (rotation_from_rpy,
                                        rotation_geodesic_error)

from golden_specs import GOLDEN_SPECS, RAW_CAPACITY, build_config, build_pair

ICP_PAIR = dict(seed=9, yaw_deg=20.0, translation=(2.5, 1.0, 0.0))
MASK_AGREE = 0.999            # tests/test_torch_preprocessing.py


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pad(xyz, n=RAW_CAPACITY):
    pts = np.zeros((n, 3), np.float32)
    mask = np.zeros(n, bool)
    pts[:len(xyz)], mask[:len(xyz)] = xyz, True
    return pts, mask


def _same(got, ref, what):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref), what
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), what


def _routes(fn):
    """fn() under ``eager_loops(chunk=1)`` and at its default chunk (both
    uncaptured on the CPU): (chunk-1 result, default result, default
    route's loop counters)."""
    with loops.eager_loops(chunk=1):
        one = fn()
    loops.reset_loops()
    out = fn()
    return one, out, {k: dict(v) for k, v in loops.LOOPS.items()}


@pytest.fixture(scope="module")
def vlp16_pair():
    """The raw seed-9 VLP-16 pair padded to 32768 points (numpy) and its
    ground truth."""
    src, tgt, gt = make_scan_pair(lidar=tcfg.LidarConfig.preset("VLP-16"),
                                  **ICP_PAIR)
    return _pad(src), _pad(tgt), gt


# ---------------------------------------------------------- voxel grid --

@pytest.mark.parametrize("active_cap", [None, 6000])
@pytest.mark.parametrize("clouds", [1, 3, 8])
def test_voxel_grid_batched_equals_per_cloud(vlp16_pair, clouds,
                                             active_cap):
    """Each cloud of one batched call equals its own call bit for bit;
    the clouds keep seeded shares of the scans' points (the second
    empty), so their valid counts differ."""
    (ps, ms), (pt, mt), _ = vlp16_pair
    rng = np.random.default_rng(16 + clouds)
    pts, masks = [], []
    for c in range(clouds):
        p, m = (ps, ms) if c % 2 == 0 else (pt, mt)
        keep = 0.0 if c == 1 else rng.uniform(0.2, 1.0)
        pts.append(p)
        masks.append(m & (rng.random(m.shape) < keep))
    pts, masks = _t(np.stack(pts)), _t(np.stack(masks))
    cfg = tcfg.PipelineConfig.for_lidar("VLP-16", max_voxels=2048)
    vox, vmask = voxel_downsample(pts, masks, cfg.voxel_size,
                                  cfg.max_voxels, active_cap=active_cap)
    assert vox.shape == (clouds, cfg.max_voxels, 3)
    for c in range(clouds):
        one = voxel_downsample(pts[c], masks[c], cfg.voxel_size,
                               cfg.max_voxels, active_cap=active_cap)
        _same((vox[c], vmask[c]), one, f"cloud {c}")
    counts = vmask.sum(-1).tolist()
    if clouds > 1:
        assert counts[1] == 0 and min(counts[:1] + counts[2:]) > 0


# ----------------------------------------------------------------- ICP --

@pytest.mark.parametrize("yaw_only", [False, True])
def test_refine_icp_loop_routes_and_jax(vlp16_pair, yaw_only):
    """ICP's passes as a ``fori``: chunk 1 and the default chunk equal,
    no flag read, and the JAX package's ``refine_icp`` on the same voxels
    and normals within tests/test_torch_refine.py's tolerances (1e-4 rad,
    1e-3 m, inliers within 1 %), from the ground truth degraded by 1 deg
    of yaw and (0.2, -0.15, 0.05) m."""
    (ps, ms), (pt, mt), gt = vlp16_pair
    cfg = tcfg.PipelineConfig.for_lidar("VLP-16", max_voxels=2048)
    vs, vms = raw_scan_voxels(_t(ps), _t(ms), cfg)
    vt, vmt = raw_scan_voxels(_t(pt), _t(mt), cfg)
    nrm = raw_scan_normals(vt, vmt, cfg)
    r0 = (rotation_from_rpy(0.0, 0.0, math.radians(1.0)).numpy()
          @ gt[:3, :3]).astype(np.float32)
    t0 = (gt[:3, 3] + [0.2, -0.15, 0.05]).astype(np.float32)
    tc = tcfg.IcpConfig(enabled=True, yaw_only=yaw_only)
    args = (vs, vms, vt, vmt, nrm.normals, nrm.valid, _t(r0), _t(t0), tc)
    one, got, counts = _routes(lambda: refine_icp(*args))
    _same(tuple(got), tuple(one), "chunk 1 against the default chunk")
    assert counts["icp"]["rounds"] == tc.iterations
    assert counts["icp"]["reads"] == 0
    ref = jax_icp(*(jnp.asarray(a.numpy()) for a in args[:6]),
                  jnp.asarray(r0), jnp.asarray(t0),
                  jcfg.IcpConfig(enabled=True, yaw_only=yaw_only))
    drot = float(rotation_geodesic_error(_t(np.asarray(ref.rotation)),
                                         got.rotation))
    assert drot < 1e-4
    np.testing.assert_allclose(got.translation.numpy(),
                               np.asarray(ref.translation), atol=1e-3)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= \
        0.01 * int(ref.num_inliers)
    assert bool(got.converged) == bool(ref.converged) is True


# ---------------------------------------------------------- labelling --

def _blob_scene(seed, lidar):
    """tests/test_preprocessing.py's brute-force scene: 120 blobs at
    random offsets of a range image (numpy)."""
    rng = np.random.default_rng(seed)
    rows, cols = lidar.n_scan, lidar.horizon_scan
    rimg = np.full((rows, cols), np.inf, np.float32)
    valid = np.zeros((rows, cols), bool)
    for k in range(120):
        r0, c0 = rng.integers(0, rows - 6), rng.integers(0, cols - 8)
        h, w = rng.integers(1, 6), rng.integers(1, 8)
        rimg[r0:r0 + h, c0:c0 + w] = 10.0 + 0.001 * k
        valid[r0:r0 + h, c0:c0 + w] = True
    return rimg, valid


@pytest.mark.parametrize("mode", ["4CrossNeighbor", "4Neighbor",
                                  "8Neighbor"])
def test_label_components_loop_routes_and_jax(mode):
    """Labelling as a ``while_chunks`` on two scenes at once: chunk 1
    (a flag read per round) and the default chunk equal, at most
    ceil(rounds / chunk) + 1 reads, and labels and feasibility equal to
    the JAX package's on each scene (exact on these scenes, as in
    tests/test_torch_preprocessing.py)."""
    lidar_j, lidar_t = jcfg.LidarConfig(), qt.LidarConfig()
    cfg_j = dataclasses.replace(jcfg.ProjectionConfig(), neighbor_mode=mode)
    cfg_t = dataclasses.replace(tcfg.ProjectionConfig(), neighbor_mode=mode)
    scenes = [_blob_scene(seed, lidar_j) for seed in (1234, 16)]
    rimg = _t(np.stack([s[0] for s in scenes]))
    valid = _t(np.stack([s[1] for s in scenes]))
    one, got, counts = _routes(
        lambda: tpr.label_components(rimg, valid, lidar_t, cfg_t))
    _same(got, one, "chunk 1 against the default chunk")
    c = counts["label_components"]
    with loops.eager_loops(chunk=1):
        loops.reset_loops()
        tpr.label_components(rimg, valid, lidar_t, cfg_t)
        rounds = loops.LOOPS["label_components"]["rounds"]
    assert c["reads"] <= -(-rounds // CC_CHUNK) + 1
    assert c["rounds"] >= rounds
    for b, (r, v) in enumerate(scenes):
        ref = [np.asarray(a) for a in jpr.label_components(
            jnp.asarray(r), jnp.asarray(v), lidar_j, cfg_j)]
        for g, want in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), want)


# ----------------------------------------------------------- Patchwork --

def test_estimate_ground_loop_routes_and_jax():
    """Patchwork's bf16 fits as a ``fori`` on the golden spec level_a's
    pair as one batch: chunk 1 and the default chunk equal, no flag read,
    and ground / non-ground agreeing with the JAX package's compiled
    function on >= 99.9 % of the valid points, ``dropped`` and the
    accepted patches exact (tests/test_torch_preprocessing.py)."""
    spec = next(s for s in GOLDEN_SPECS if s["name"] == "level_a")
    jc = build_config(spec)
    tc = qt.config_from_dict(dataclasses.asdict(jc))
    pts, masks = zip(*(_pad(xyz) for xyz in build_pair(spec)[:2]))
    pts, masks = np.stack(pts), np.stack(masks)
    one, got, counts = _routes(
        lambda: tpw.estimate_ground(_t(pts), _t(masks), tc.patchwork))
    _same(tuple(got), tuple(one), "chunk 1 against the default chunk")
    assert counts["patchwork_fit"]["rounds"] == tc.patchwork.num_iter - 1
    assert counts["patchwork_fit"]["reads"] == 0
    for b in range(2):
        ref = jpw.estimate_ground(jnp.asarray(pts[b]), jnp.asarray(masks[b]),
                                  jc.patchwork)
        np.testing.assert_array_equal(got.dropped[b].numpy(),
                                      np.asarray(ref.dropped))
        np.testing.assert_array_equal(got.patch_accepted[b].numpy(),
                                      np.asarray(ref.patch_accepted))
        for field in ("ground", "nonground"):
            differ = ((getattr(got, field)[b].numpy()
                       != np.asarray(getattr(ref, field))) & masks[b])
            assert 1.0 - differ.sum() / masks[b].sum() >= MASK_AGREE


# --------------------------------------------------------- arbitration --

@pytest.mark.parametrize("bsz", [1, 8, 64])
def test_alignment_overlap_batched_equals_per_pair(bsz):
    """Overlaps of K = 3 seeded poses on B pairs of small seeded clouds
    (300 source, 400 target points, a fifth of each masked out) in one
    call, the source padded to whole blocks of 2048 // (3 B) rows, equal
    to each pair's and pose's own call, which takes one block; no flag
    read."""
    rng = np.random.default_rng(bsz)
    k, ns, nt = 3, 300, 400
    tgt = rng.uniform(-10, 10, (bsz, 1, nt, 3)).astype(np.float32)
    src = (tgt[:, :, :ns] + rng.normal(0, 0.2, (bsz, 1, ns, 3))).astype(
        np.float32)
    smask = rng.random((bsz, 1, ns)) > 0.2
    tmask = rng.random((bsz, 1, nt)) > 0.2
    rot = torch.stack([rotation_from_rpy(0.0, 0.0, float(a)) for a in
                       rng.uniform(-0.1, 0.1, bsz * k)]).reshape(bsz, k, 3, 3)
    trans = _t(rng.normal(0, 0.3, (bsz, k, 3)).astype(np.float32))
    loops.reset_loops()
    got = alignment_overlap(_t(src), _t(smask), _t(tgt), _t(tmask), rot,
                            trans, 0.6)
    assert got.shape == (bsz, k)
    rows = max(1, 2048 // (bsz * k))
    assert loops.LOOPS["overlap"]["rounds"] == -(-ns // rows)
    assert loops.LOOPS["overlap"]["reads"] == 0
    for b in range(bsz):
        for h in range(k):
            one = alignment_overlap(_t(src[b, 0]), _t(smask[b, 0]),
                                    _t(tgt[b, 0]), _t(tmask[b, 0]),
                                    rot[b, h], trans[b, h], 0.6)
            assert torch.equal(got[b, h], one), (b, h)
    assert float(got.max()) > 0.2
