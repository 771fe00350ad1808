"""Ground alignment and the ICP polish: the port against the JAX package on
the same numpy inputs, stage by stage and end to end at VLP-16 scale.

Inputs: the VLP-16 pair of tests/test_icp.py's pipeline test (seed 9, yaw
20 deg, t = (2.5, 1.0, 0), 32768 raw points), voxelised by the JAX
package at 2048 voxels, and the golden spec ``tilt_ground_align``
(tests/golden_specs.py: seed 106, 5 deg of tilt on each scan).

Tolerances, and what was measured on these inputs:
- ``radius_neighbors``: the K-capped neighbour index sets equal on every
  row where no tie (in f64) straddles the K-th place or the radius
  (measured: 99.6 % of rows have identical index lists);
- ``estimate_normals`` on the same neighbour lists: validity equal,
  curvature within 1e-3 (as tests/test_torch_frontend.py; measured:
  1.2e-4 on one row where the two smallest eigenvalues nearly repeat),
  normals within 1e-3 on well-conditioned rows (ROADMAP C "Normals on
  ill-conditioned rows"; measured: 99 % of all rows within 4e-5);
- ``fit_ground_plane``, ``align_ground``, ``compose_leveled_solution``
  within 1e-5 on the same masks, gates equal (measured: 6e-7);
- ``refine_icp`` from the same coarse pose, clouds and normals: pose
  within 1e-4 rad / 1e-3 m, ``num_inliers`` within 1 %, ``converged``
  equal, with ``yaw_only`` both ways (measured: 2e-7 / 1e-6, counts
  equal);
- ``register_scan_pair`` with ICP on and with ground alignment on:
  each pose within 5 deg / 2 m of the ground truth and the two packages'
  within 3 deg / 1.5 m of each other (tests/golden_specs.py).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io.synthetic import make_scan_pair as jax_scan_pair
from quatro_tpu.ops.neighbors import radius_neighbors as jax_neighbors
from quatro_tpu.ops.normals import estimate_normals as jax_normals
from quatro_tpu.ops.voxel import voxel_downsample as jax_voxel
from quatro_tpu.pipeline import register_scan_pair as jax_register
from quatro_tpu.solver import ground as jground
from quatro_tpu.solver.icp import refine_icp as jax_icp
from quatro_tpu.types import PointBatch as JaxPointBatch
from quatro_tpu.utils import se3 as jax_se3
from quatro_tpu.utils.se3 import rotation_from_rpy as jax_rpy

import quatro_tpu_torch as qt
import quatro_tpu_torch.config as tcfg
from quatro_tpu_torch.ops.neighbors import NeighborLists, radius_neighbors
from quatro_tpu_torch.ops.normals import estimate_normals
from quatro_tpu_torch.solver import ground as tground
from quatro_tpu_torch.solver.icp import refine_icp
from quatro_tpu_torch.utils.se3 import (apply_transform, exp_so3,
                                        make_transform, rotation_from_rpy,
                                        rotation_geodesic_error)

from golden_specs import (GOLDEN_SPECS, GT_ROT_MAX_DEG, GT_TRANS_MAX_M,
                          RAW_CAPACITY, ROT_BAND_DEG, TRANS_BAND_M,
                          build_config, build_pair)

ICP_PAIR = dict(seed=9, yaw_deg=20.0, translation=(2.5, 1.0, 0.0))
V = 2048


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))          # a copy: may be read-only


def _pad(xyz, n=RAW_CAPACITY):
    pts = np.zeros((n, 3), np.float32)
    mask = np.zeros(n, bool)
    pts[:len(xyz)], mask[:len(xyz)] = xyz, True
    return pts, mask


@pytest.fixture(scope="module")
def icp_pair():
    """The raw seed-9 VLP-16 pair (padded to 32768), its ground truth, and
    both clouds voxelised by the JAX package at 2048 voxels."""
    src, tgt, gt = jax_scan_pair(lidar=jcfg.LidarConfig.preset("VLP-16"),
                                 **ICP_PAIR)
    vox = jax.jit(lambda p, m: jax_voxel(p, m, 0.3, V))
    raw, voxels = [], []
    for xyz in (src, tgt):
        p, m = _pad(xyz)
        raw.append((p, m))
        voxels.append(tuple(np.asarray(x) for x in vox(p, m)))
    return raw, voxels, gt


@pytest.fixture(scope="module")
def target_normals(icp_pair):
    """The target voxels' K-capped neighbour lists and normals, JAX's."""
    _, (_, (vt, mt)), _ = icp_pair
    f = jcfg.PipelineConfig.for_lidar("VLP-16", max_voxels=V).fpfh
    nbrs = jax_neighbors(jnp.asarray(vt), jnp.asarray(mt), f.normal_radius,
                         f.max_neighbors_normal)
    return nbrs, jax_normals(jnp.asarray(vt), nbrs), f


def test_radius_neighbors_matches(icp_pair, target_normals):
    _, (_, (vt, mt)), _ = icp_pair
    ref, _, f = target_normals
    k, r = f.max_neighbors_normal, f.normal_radius
    got = radius_neighbors(_t(vt), _t(mt), r, k)
    assert got.idx.shape == (V, k) and got.idx.dtype == torch.int32
    # f64 distances: where does a tie straddle the K-th place or the radius
    p = vt.astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    d2[:, ~mt] = np.inf
    srt = np.sort(d2, axis=1)
    r2 = float(np.float32(r * r))
    clear = (mt & (srt[:, k] - srt[:, k - 1] > 1e-4 * (1.0 + srt[:, k]))
             & (np.abs(d2 - r2) > 1e-4).all(1))
    assert clear.mean() > 0.9
    ri, rv = np.asarray(ref.idx), np.asarray(ref.valid)
    gi, gv = got.idx.numpy(), got.valid.numpy()
    for row in np.nonzero(clear)[0]:
        assert set(gi[row]) == set(ri[row]), row
        assert set(gi[row][gv[row]]) == set(ri[row][rv[row]]), row
    np.testing.assert_array_equal(gv.sum(1), rv.sum(1))
    assert (gi[mt, 0] == np.nonzero(mt)[0]).all()      # self first


def _well_conditioned(vt, nbrs):
    """Rows whose normal is a well-posed function of their neighbour list:
    from an f64 PCA, the two smallest eigenvalues apart by > 1 % of the
    largest and the point off the tangent plane through the viewpoint by
    > 0.1 % of its range."""
    p = vt.astype(np.float64)
    idx, w = np.asarray(nbrs.idx), np.asarray(nbrs.valid).astype(np.float64)
    q = p[idx]                                       # (V, K, 3)
    cnt = np.maximum(w.sum(1), 1.0)[:, None]
    mean = (w[..., None] * q).sum(1) / cnt
    d = (q - mean[:, None]) * np.sqrt(w)[..., None]
    cov = np.einsum("nki,nkj->nij", d, d) / cnt[..., None]
    lam, vec = np.linalg.eigh(cov)
    gap = (lam[:, 1] - lam[:, 0]) / np.maximum(lam[:, 2], 1e-30)
    side = np.abs((vec[:, :, 0] * p).sum(1)) / np.maximum(
        np.linalg.norm(p, axis=1), 1e-9)
    return (w.sum(1) >= 3) & (gap > 1e-2) & (side > 1e-3)


def test_estimate_normals_matches(icp_pair, target_normals):
    _, (_, (vt, _)), _ = icp_pair
    nbrs, ref, _ = target_normals
    got = estimate_normals(_t(vt), NeighborLists(
        *(_t(np.asarray(x)) for x in nbrs)))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.curvature.numpy()[valid],
                               np.asarray(ref.curvature)[valid], atol=1e-3)
    cond = _well_conditioned(vt, nbrs)
    assert cond.mean() > 0.6
    np.testing.assert_allclose(got.normals.numpy()[cond],
                               np.asarray(ref.normals)[cond], atol=1e-3)
    # rows with < 3 neighbours: 0 in the port (the JAX package's
    # flush-to-zero arithmetic leaves NaN there); no caller reads them
    assert (got.normals.numpy()[~valid] == 0).all()


# ---------------------------------------------------- ground alignment ---

def _tilted(icp_pair):
    """The pair's raw clouds tilted as tests/test_ground.py tilts its pair,
    and ground masks from the untilted height."""
    (sp, sm), (tp, tm) = icp_pair[0]
    a = np.asarray(jax_rpy(0.07, -0.05, 0.0), np.float32)
    b = np.asarray(jax_rpy(-0.04, 0.06, 0.0), np.float32)
    return (sp @ a.T, sm & (sp[:, 2] < -1.5), tp @ b.T,
            tm & (tp[:, 2] < -1.5))


def _assert_alignment_close(got, ref):
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-5, err_msg=name)


def test_fit_ground_plane_matches(icp_pair):
    s2, gs, _, _ = _tilted(icp_pair)
    ref = jground.fit_ground_plane(jnp.asarray(s2), jnp.asarray(gs))
    got = tground.fit_ground_plane(_t(s2), _t(gs))
    _assert_alignment_close(got, ref)
    assert int(got.count) == int(gs.sum()) > 1000
    assert float(got.normal[2]) > 0.99


def test_align_ground_and_compose_match(icp_pair):
    s2, gs, t2, gt_ = _tilted(icp_pair)
    jc = jcfg.GroundAlignmentConfig(enabled=True)
    tc = tcfg.GroundAlignmentConfig(enabled=True)
    ref = jground.align_ground(jnp.asarray(s2), jnp.asarray(gs),
                               jnp.asarray(t2), jnp.asarray(gt_), jc)
    got = tground.align_ground(_t(s2), _t(gs), _t(t2), _t(gt_), tc)
    _assert_alignment_close(got, ref)
    assert bool(got.valid)
    # a yaw-only leveled solve, and a tilted one the z override skips
    for rpy in ((0.0, 0.0, 0.35), (0.05, 0.0, 0.35)):
        rot = np.asarray(jax_rpy(*rpy), np.float32)
        t = np.float32([0.4, -0.3, 0.2])
        for use_z in (True, False):
            rr, rt = jground.compose_leveled_solution(
                jnp.asarray(rot), jnp.asarray(t), ref, use_ground_z=use_z)
            gr, gtr = tground.compose_leveled_solution(_t(rot), _t(t), got,
                                                       use_ground_z=use_z)
            np.testing.assert_allclose(gr.numpy(), np.asarray(rr), atol=1e-5)
            np.testing.assert_allclose(gtr.numpy(), np.asarray(rt),
                                       atol=1e-5)


@pytest.mark.parametrize("case", ["wall", "few_points", "curved"])
def test_ground_gates_match(case):
    """A wall (tilt gate), 100 points (count gate) and a bowl (flatness
    gate) each fail in both packages: identity leveling, zero heights."""
    rng = np.random.default_rng(4)
    u = rng.uniform(-10, 10, (2000, 2)).astype(np.float32)
    if case == "wall":
        pts = np.stack([np.full(2000, 5.0), u[:, 0], u[:, 1]], 1)
    elif case == "curved":
        pts = np.stack([u[:, 0], u[:, 1], 0.05 * (u ** 2).sum(1)], 1)
    else:
        pts = np.stack([u[:, 0], u[:, 1], np.full(2000, -1.7)], 1)
    pts = pts.astype(np.float32)
    mask = np.ones(2000, bool)
    if case == "few_points":
        mask[100:] = False
    jc = jcfg.GroundAlignmentConfig(enabled=True)
    tc = tcfg.GroundAlignmentConfig(enabled=True)
    ref = jground.align_ground(jnp.asarray(pts), jnp.asarray(mask),
                               jnp.asarray(pts), jnp.asarray(mask), jc)
    got = tground.align_ground(_t(pts), _t(mask), _t(pts), _t(mask), tc)
    assert not bool(ref.valid) and not bool(got.valid)
    _assert_alignment_close(got, ref)
    np.testing.assert_array_equal(got.src_level.numpy(), np.eye(3))


def test_rotation_from_rpy_matches():
    for rpy in ((0.07, -0.05, 0.0), (-0.04, 0.06, 0.0), (0.3, 0.2, 2.5)):
        np.testing.assert_allclose(rotation_from_rpy(*rpy).numpy(),
                                   np.asarray(jax_rpy(*rpy)), atol=1e-6)


@pytest.mark.parametrize("w", [(0.1, -0.2, 0.3), (2e-5, -1e-5, 3e-5),
                               (0.0, 0.0, 0.0)],
                         ids=["rodrigues", "series", "zero"])
def test_se3_helpers_match(w):
    """exp_so3 on both sides of its 1e-4 rad series switch, and the 4x4
    transform helpers, within 1e-6 of the JAX package's."""
    w = np.float32(w)
    rot = np.asarray(jax_se3.exp_so3(jnp.asarray(w)))
    np.testing.assert_allclose(exp_so3(_t(w)).numpy(), rot, atol=1e-6)
    t = np.float32([1.5, -2.0, 0.25])
    ref_tf = np.asarray(jax_se3.make_transform(jnp.asarray(rot),
                                               jnp.asarray(t)))
    tf = make_transform(_t(rot), _t(t))
    np.testing.assert_allclose(tf.numpy(), ref_tf, atol=1e-6)
    pts = np.random.default_rng(0).normal(0, 20, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        apply_transform(tf, _t(pts)).numpy(),
        np.asarray(jax_se3.apply_transform(jnp.asarray(ref_tf),
                                           jnp.asarray(pts))), atol=1e-5)


# ------------------------------------------------------------------ ICP ---

@pytest.mark.parametrize("yaw_only", [False, True])
def test_refine_icp_matches(icp_pair, target_normals, yaw_only):
    """From the ground truth degraded by 1 deg of yaw and (0.2, -0.15,
    0.05) m, on the same voxels and normals."""
    _, ((vs, ms), (vt, mt)), gt = icp_pair
    _, normals, _ = target_normals
    r0 = (np.asarray(jax_rpy(0.0, 0.0, math.radians(1.0)), np.float32)
          @ gt[:3, :3]).astype(np.float32)
    t0 = (gt[:3, 3] + [0.2, -0.15, 0.05]).astype(np.float32)
    nrm, nvalid = np.asarray(normals.normals), np.asarray(normals.valid)
    jc = jcfg.IcpConfig(enabled=True, yaw_only=yaw_only)
    tc = tcfg.IcpConfig(enabled=True, yaw_only=yaw_only)
    ref = jax_icp(jnp.asarray(vs), jnp.asarray(ms), jnp.asarray(vt),
                  jnp.asarray(mt), jnp.asarray(nrm), jnp.asarray(nvalid),
                  jnp.asarray(r0), jnp.asarray(t0), jc)
    got = refine_icp(_t(vs), _t(ms), _t(vt), _t(mt), _t(nrm), _t(nvalid),
                     _t(r0), _t(t0), tc)
    drot = float(rotation_geodesic_error(_t(np.asarray(ref.rotation)),
                                         got.rotation))
    assert drot < 1e-4
    np.testing.assert_allclose(got.translation.numpy(),
                               np.asarray(ref.translation), atol=1e-3)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= \
        0.01 * int(ref.num_inliers)
    assert bool(got.converged) == bool(ref.converged) is True
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-3)
    # it polished: within 2 cm of the ground truth
    assert np.linalg.norm(got.translation.numpy() - gt[:3, 3]) < 0.02
    if yaw_only:                       # roll and pitch as they started
        rel = got.rotation.numpy() @ r0.T
        assert abs(rel[2, 2] - 1.0) < 1e-6


def test_refine_icp_invalid_coarse_passes_through(icp_pair, target_normals):
    _, ((vs, ms), (vt, mt)), _ = icp_pair
    _, normals, _ = target_normals
    r0, t0 = np.eye(3, dtype=np.float32), np.float32([1.0, 2.0, 3.0])
    got = refine_icp(_t(vs), _t(ms), _t(vt), _t(mt),
                     _t(np.asarray(normals.normals)),
                     _t(np.asarray(normals.valid)), _t(r0), _t(t0),
                     tcfg.IcpConfig(enabled=True),
                     valid=torch.tensor(False))
    assert torch.equal(got.rotation, _t(r0))
    assert torch.equal(got.translation, _t(t0))
    assert not bool(got.converged)


# ----------------------------------------------------------- end to end ---

def _errors(rot, trans, gt):
    rerr = math.degrees(float(rotation_geodesic_error(
        torch.tensor(np.asarray(gt)[:3, :3], dtype=torch.float32),
        torch.tensor(np.asarray(rot)))))
    return rerr, float(np.linalg.norm(np.asarray(trans)
                                      - np.asarray(gt)[:3, 3]))


def _run_both(src, tgt, jc):
    ref = jax_register(JaxPointBatch.from_numpy(src, RAW_CAPACITY),
                       JaxPointBatch.from_numpy(tgt, RAW_CAPACITY), jc)
    got = qt.register_scan_pair(qt.PointBatch.from_numpy(src, RAW_CAPACITY),
                                qt.PointBatch.from_numpy(tgt, RAW_CAPACITY),
                                qt.config_from_dict(dataclasses.asdict(jc)),
                                device="cpu")
    return ref, got


def _assert_bands(ref, got, gt, name):
    for who, sol in (("jax", ref.solution), ("port", got.solution)):
        assert bool(np.asarray(sol.valid)), who
        rerr, terr = _errors(sol.rotation, sol.translation, gt)
        print(f"{name} {who}: {rerr:.4f} deg, {terr:.4f} m")
        assert rerr < GT_ROT_MAX_DEG and terr < GT_TRANS_MAX_M, (who, rerr,
                                                                 terr)
    ref_t = np.eye(4)
    ref_t[:3, :3] = np.asarray(ref.solution.rotation)
    ref_t[:3, 3] = np.asarray(ref.solution.translation)
    drot, dtr = _errors(got.solution.rotation, got.solution.translation,
                        ref_t)
    assert drot < ROT_BAND_DEG and dtr < TRANS_BAND_M, (drot, dtr)


def test_register_scan_pair_with_icp():
    """tests/test_icp.py's pipeline fixture (seed 9, 2048 voxels, 256
    correspondences, 4 hypotheses) with ICP on: the coarse solve without
    ICP, then the polish on the raw clouds."""
    lidar = jcfg.LidarConfig.preset("VLP-16")
    jc = jcfg.PipelineConfig(
        lidar=lidar, max_raw_points=RAW_CAPACITY, max_nonground_points=16384,
        max_segment_points=8192, max_voxels=V,
        fpfh=jcfg.FPFHConfig(max_correspondences=256),
        solver=jcfg.SolverConfig(num_hypotheses=4, use_pallas_graph=False),
        icp=jcfg.IcpConfig(enabled=True))
    src, tgt, gt = jax_scan_pair(lidar=lidar, **ICP_PAIR)
    ref, got = _run_both(src, tgt, jc)
    _assert_bands(ref, got, gt, "icp")
    assert bool(ref.icp.converged) and bool(got.icp.converged)
    assert abs(int(got.icp.num_inliers) - int(ref.icp.num_inliers)) <= \
        0.05 * int(ref.icp.num_inliers)


def test_register_scan_pair_with_ground_alignment():
    """The golden spec tilt_ground_align (each scan tilted by 5 deg) with
    ground alignment on: leveled by the fitted ground planes, solved
    yaw-only, composed back with the ground-height z."""
    spec = next(s for s in GOLDEN_SPECS if s["name"] == "tilt_ground_align")
    src, tgt, gt = build_pair(spec)
    jc = build_config(spec)
    jc = dataclasses.replace(jc, solver=dataclasses.replace(
        jc.solver, use_pallas_graph=False))
    assert jc.ground_alignment.enabled
    ref, got = _run_both(src, tgt, jc)
    _assert_bands(ref, got, gt, "ground alignment")
    assert got.icp is None
