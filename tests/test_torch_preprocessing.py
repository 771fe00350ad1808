"""Preprocessing of raw scans, the port against the JAX package on the same
numpy inputs: Patchwork ground segmentation (``estimate_ground``), the
range-image projection and sub-clustering (``segment_cloud``),
``preprocess`` and ``register_scan_pair``.

The scans are the golden spec level_a's VLP-16 pair (seed 101, 32768 raw
points); the port runs both clouds as one batch of two on the CPU, the JAX
package one cloud at a time, compiled as its pipeline runs it.

Tolerances, and what was measured on these inputs:
- the static CZM tables are equal; patch ids exact but for points within
  1e-5 (relative) of a ring or sector edge (none here);
- stage by stage, on the JAX package's own tables: the plane-fit membership
  and the classification codes exact, the bf16-rounded moment channels
  exact, the moment sums within 1e-5 of the sum of their terms' sizes
  (summation order; patches whose moments cancel rule out an rtol);
- end to end, ground and non-ground agree on >= 99.9 % of the valid points
  (measured: all of them), every disagreeing point within 5 mm of its
  patch threshold under the JAX package's final plane, ``dropped`` exact;
- rows, columns, pixel ids, owners and range images exact but for points
  within 1e-4 deg of a row or column edge (measured: all exact; every ring
  of the synthetic scans lies on a row edge, so this needs the JAX
  package's single-rounding multiply-adds, utils/fused.py);
- labels and feasibility exact but for pixel pairs whose angle lies within
  1e-6 rad of segment_theta_deg (measured: all exact);
- segment masks equal on >= 99.9 % of points (measured: all);
- ``register_scan_pair`` within 5 deg / 2 m of the ground truth and 3 deg /
  1.5 m of the JAX package's pose (tests/golden_specs.py); the winning
  hypothesis' index is never compared.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.ops import segment_matmul as jsm
from quatro_tpu.pipeline import preprocess as jax_preprocess
from quatro_tpu.pipeline import register_scan_pair as jax_register
from quatro_tpu.preprocessing import patchwork as jpw
from quatro_tpu.preprocessing import projection as jpr
from quatro_tpu.types import PointBatch as JaxPointBatch

import quatro_tpu_torch as qt
from quatro_tpu_torch.config import ProjectionConfig
from quatro_tpu_torch.ops import segment
from quatro_tpu_torch.pipeline import preprocess
from quatro_tpu_torch.preprocessing import patchwork as tpw
from quatro_tpu_torch.preprocessing import projection as tpr
from quatro_tpu_torch.utils.se3 import rotation_geodesic_error

from golden_specs import (GOLDEN_SPECS, GT_ROT_MAX_DEG, GT_TRANS_MAX_M,
                          RAW_CAPACITY, ROT_BAND_DEG, TRANS_BAND_M,
                          build_config, build_pair)

MASK_AGREE = 0.999
NEAR_PLANE_M = 0.005
SUM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _spec(name):
    return next(s for s in GOLDEN_SPECS if s["name"] == name)


@pytest.fixture(scope="module")
def level_a():
    """(points (2, N, 3), masks (2, N), JAX config, port config) of the
    level_a pair at the golden specs' raw capacity."""
    spec = _spec("level_a")
    src, tgt, _ = build_pair(spec)
    pts = np.zeros((2, RAW_CAPACITY, 3), np.float32)
    masks = np.zeros((2, RAW_CAPACITY), bool)
    for b, xyz in enumerate((src, tgt)):
        pts[b, :len(xyz)], masks[b, :len(xyz)] = xyz, True
    jc = build_config(spec)
    return pts, masks, jc, qt.config_from_dict(dataclasses.asdict(jc))


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ Patchwork --

def test_patch_tables_equal():
    jc, tc = jcfg.PatchworkConfig(), qt.PipelineConfig().patchwork
    for a, b in zip(jpw._patch_metadata(jc), tpw._patch_metadata(tc)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jpw._patch_centers(jc), tpw._patch_centers(tc)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # 2*16 + 4*32 + 4*54 + 4*32 = 504 patches, padded with the dump slot
    assert tc.num_patches == 504 and tpw._pad128(505) == 512


def _near_czm_edge(xyz, cfg, rel=1e-5):
    """Points within `rel` (relative) of a CZM ring or sector edge, in f64."""
    x, y = xyz[:, 0].astype(np.float64), xyz[:, 1].astype(np.float64)
    r = np.hypot(x, y)
    th = np.mod(np.arctan2(y, x), 2 * np.pi)
    bounds = cfg.ring_boundaries
    near = np.zeros(len(r), bool)
    for k in range(cfg.num_zones):
        edges = np.linspace(bounds[k], bounds[k + 1],
                            cfg.num_rings_each_zone[k] + 1)
        near |= (np.abs(r[:, None] - edges[None]) <= rel * edges).any(1)
        sect = np.linspace(0, 2 * np.pi, cfg.num_sectors_each_zone[k] + 1)
        near |= (np.abs(th[:, None] - sect[None]) <= rel * 2 * np.pi).any(1)
    return near


def test_czm_bin_matches(level_a):
    pts, masks, jc, tc = level_a
    hand = np.array([[3, 0, 0], [0, 3, 0], [15, 0, 0], [30, 0, 0],
                     [60, 0, 0], [1, 0, 0], [100, 0, 0]], np.float32)
    xyz = np.concatenate([pts[0], hand])
    mask = np.concatenate([masks[0], np.ones(7, bool)])
    ref_id, ref_in = jax.jit(jpw.czm_bin, static_argnums=2)(
        jnp.asarray(xyz), jnp.asarray(mask), jc.patchwork)
    got_id, got_in = tpw.czm_bin(_t(xyz), _t(mask), tc.patchwork)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(ref_in))
    differ = got_id.numpy() != np.asarray(ref_id)
    near = _near_czm_edge(xyz, tc.patchwork)
    print(f"czm_bin: {int(differ.sum())} patch ids differ, "
          f"{int((near & mask).sum())} valid points near an edge")
    assert not (differ & ~near).any()
    assert got_id[-7:].tolist()[:2] == [15, 4]


def _jax_ground_recorded(monkeypatch, xyz, mask, cfg):
    """The JAX package's estimate_ground run op by op, with the arguments
    and outputs of its plane-fit and classification calls recorded."""
    calls = []
    for name in ("fit_iteration_moments", "classify_points"):
        orig = getattr(jsm, name)

        def rec(*args, _orig=orig, _name=name, **kw):
            out = _orig(*args, **kw)
            calls.append((_name, args, kw, np.asarray(out)))
            return out
        monkeypatch.setattr(jsm, name, rec)
    with jax.disable_jit():
        res = jpw.estimate_ground(jnp.asarray(xyz), jnp.asarray(mask), cfg)
    monkeypatch.undo()
    return res, calls


def test_estimate_ground_stage_by_stage(level_a, monkeypatch):
    """On the JAX package's own tables: the port's plane-fit membership,
    counts and bf16 channels exact, sums within 1e-5 of the sum of their
    terms' sizes, the classification codes exact."""
    pts, masks, jc, _ = level_a
    _, calls = _jax_ground_recorded(monkeypatch, pts[0], masks[0],
                                    jc.patchwork)
    assert [c[0] for c in calls] == ["fit_iteration_moments"] * 3 + [
        "classify_points"]
    for name, (ids, chan, tab, p_pad, p_cnt), kw, ref in calls:
        assert p_pad == 512 and p_cnt == 504
        targs = (_t(ids)[None], _t(chan)[None], _t(tab)[None], p_pad, p_cnt)
        if name == "classify_points":
            got = segment.classify_points(*targs)[0].numpy()
            np.testing.assert_array_equal(got, ref)
            assert (got & 1).sum() > 0 and (got & 2).sum() > 0
            continue
        exact = kw["exact"]
        vals = jsm.table_lookup(ids, tab)
        proj = vals[0] * chan[0] + vals[1] * chan[1] + vals[2] * chan[2]
        member = (ids < p_cnt) & (proj < vals[3])
        mom = segment.fit_moment_channels(*targs[:3], p_cnt, exact)[0]
        np.testing.assert_array_equal(mom[0].numpy() > 0, np.asarray(member))
        if not exact:
            ref_mom = (jsm._moment_rows(chan) * member).astype(
                jnp.bfloat16).astype(jnp.float32)
            np.testing.assert_array_equal(mom.numpy(), np.asarray(ref_mom))
        got = segment.fit_iteration_moments(*targs, exact=exact)[0].numpy()
        np.testing.assert_array_equal(got[:, 0], ref[:, 0])
        # the summation-order bound: rtol of the sum of the terms' sizes
        scale = segment.segment_sums_plain(targs[0][0], mom.abs(),
                                           p_pad).numpy()
        assert (np.abs(got - ref) <= SUM_RTOL * scale + 1e-6).all()


def test_estimate_ground_end_to_end(level_a, monkeypatch):
    """Both clouds as one batch against the compiled JAX function per
    cloud."""
    pts, masks, jc, tc = level_a
    got = tpw.estimate_ground(_t(pts), _t(masks), tc.patchwork)
    for b in range(2):
        ref = jpw.estimate_ground(jnp.asarray(pts[b]), jnp.asarray(masks[b]),
                                  jc.patchwork)
        np.testing.assert_array_equal(got.dropped[b].numpy(),
                                      np.asarray(ref.dropped))
        valid = masks[b]
        for field in ("ground", "nonground"):
            g = getattr(got, field)[b].numpy()
            r = np.asarray(getattr(ref, field))
            differ = (g != r) & valid
            share = 1.0 - differ.sum() / valid.sum()
            print(f"estimate_ground cloud {b} {field}: {r.sum()} points, "
                  f"agree on {share:.6f} of {valid.sum()} valid points")
            assert share >= MASK_AGREE
            if differ.any():
                _, calls = _jax_ground_recorded(monkeypatch, pts[b],
                                                masks[b], jc.patchwork)
                _, (ids, chan, tab, _, _), _, _ = calls[-1]
                row = np.asarray(tab)[np.asarray(ids)[differ]]
                proj = (row[:, :3] * np.asarray(chan)[:3, differ].T).sum(1)
                assert np.abs(proj - row[:, 3]).max() < NEAR_PLANE_M
        # the accepted patches' planes: the closed-form eigensolver turns a
        # flat patch's normal by up to a few degrees on f32 noise (its two
        # in-plane eigenvalues nearly repeat), so 0.1 catches only a wrong
        # plane or sign
        live = np.asarray(ref.patch_accepted)
        np.testing.assert_array_equal(got.patch_accepted[b].numpy(), live)
        np.testing.assert_allclose(got.patch_normal[b].numpy()[live],
                                   np.asarray(ref.patch_normal)[live],
                                   atol=0.1)


# ------------------------------------------------------------ projection --

def _near_row_col_edge(xyz, lidar, tol_deg=1e-4):
    """Points within tol_deg of a range-image row or column edge (f64)."""
    x, y, z = (xyz[:, k].astype(np.float64) for k in range(3))
    vert = np.degrees(np.arctan2(z, np.hypot(x, y)))
    u = (vert + lidar.ang_bottom) / lidar.ang_res_y
    horiz = (np.degrees(np.arctan2(x, y)) - 90.0) / lidar.ang_res_x
    return ((np.abs(u - np.round(u)) * lidar.ang_res_y <= tol_deg)
            | (np.abs(np.abs(horiz - np.floor(horiz)) - 0.5)
               * lidar.ang_res_x <= tol_deg))


def test_project_to_range_image_matches(level_a):
    pts, masks, jc, tc = level_a
    got = tpr.project_to_range_image(_t(pts), _t(masks), tc.lidar,
                                     max_points=20000)
    proj = jax.jit(lambda p, m: jpr.project_to_range_image(
        p, m, jc.lidar, max_points=20000))
    for b in range(2):
        ref = [np.asarray(a) for a in proj(jnp.asarray(pts[b]),
                                           jnp.asarray(masks[b]))]
        near = _near_row_col_edge(pts[b], tc.lidar) & masks[b]
        point_diff = np.zeros(RAW_CAPACITY, bool)
        for name, k in (("row", 0), ("col", 1), ("in_image", 3),
                        ("flat", 4)):
            point_diff |= got[k][b].numpy() != ref[k]
        touched = np.zeros(tc.lidar.n_scan * tc.lidar.horizon_scan, bool)
        npix = touched.size
        for flat in (got[4][b].numpy(), ref[4]):
            f = flat[point_diff]
            touched[f[f < npix]] = True
        print(f"projection cloud {b}: {int(point_diff.sum())} points "
              f"differ, {int(near.sum())} within 1e-4 deg of an edge")
        assert not (point_diff & ~near).any()
        np.testing.assert_array_equal(got[2][b].numpy(), ref[2])
        for k in (5, 6):
            g, r = got[k][b].numpy().reshape(-1), ref[k].reshape(-1)
            assert not ((g != r) & ~touched).any()


def _knife_edge_pixels(rimg, valid, lidar, cfg, tol=1e-6):
    """Pixels in a valid neighbour pair whose angle lies within tol of
    segment_theta_deg (f64)."""
    theta = np.deg2rad(cfg.segment_theta_deg)
    out = np.zeros(valid.shape, bool)
    rows = rimg.shape[0]
    for dr, dc in cfg.neighbor_offsets:
        sh = np.roll(rimg, (-dr, -dc), axis=(0, 1)).astype(np.float64)
        sv = np.roll(valid, (-dr, -dc), axis=(0, 1))
        ridx = np.arange(rows)[:, None]
        sv &= (ridx + dr >= 0) & (ridx + dr < rows)
        d1 = np.maximum(rimg, sh)
        d2 = np.minimum(rimg, sh)
        a = np.deg2rad(lidar.ang_res_x if dr == 0 else lidar.ang_res_y)
        ang = np.arctan2(d2 * np.sin(a), d1 - d2 * np.cos(a))
        edge = valid & sv & (np.abs(ang - theta) <= tol)
        out |= edge | np.roll(edge, (dr, dc), axis=(0, 1))
    return out


@pytest.mark.parametrize("mode", ["4CrossNeighbor", "4Neighbor",
                                  "8Neighbor"])
def test_label_components_matches(level_a, mode):
    """On the JAX package's range images and valid masks (the non-ground
    points of both clouds)."""
    pts, masks, jc, tc = level_a
    cfg_j = dataclasses.replace(jc.projection, neighbor_mode=mode)
    cfg_t = dataclasses.replace(tc.projection, neighbor_mode=mode)
    rimgs, valids = [], []
    for b in range(2):
        ng = masks[b] & (pts[b, :, 2] > -1.723 + 0.3)
        _, _, _, _, _, rimg, owner = jax.jit(
            lambda p, m: jpr.project_to_range_image(p, m, jc.lidar))(
            jnp.asarray(pts[b]), jnp.asarray(ng))
        rimgs.append(np.asarray(rimg))
        valids.append(np.asarray(owner) >= 0)
    labels, feasible, pixf = tpr.label_components(
        _t(np.stack(rimgs)), _t(np.stack(valids)), tc.lidar, cfg_t)
    for b in range(2):
        ref_l, ref_f, ref_p = (np.asarray(a) for a in jpr.label_components(
            jnp.asarray(rimgs[b]), jnp.asarray(valids[b]), jc.lidar, cfg_j))
        got_l = labels[b].numpy()
        knife = _knife_edge_pixels(rimgs[b], valids[b], tc.lidar, cfg_t)
        # components touching a knife-edge pair may merge or split
        skip = np.isin(got_l, got_l[knife]) | np.isin(ref_l, ref_l[knife])
        print(f"label_components {mode} cloud {b}: "
              f"{len(np.unique(ref_l)) - 1} components, "
              f"{int(knife.sum())} knife-edge pixels")
        keep = ~skip
        np.testing.assert_array_equal(got_l[keep], ref_l[keep])
        np.testing.assert_array_equal(pixf[b].numpy()[keep], ref_p[keep])
        ids = np.unique(ref_l[keep & (ref_l >= 0)])
        np.testing.assert_array_equal(feasible[b].numpy()[ids], ref_f[ids])
        assert ref_f.sum() > 0


def test_label_component_stats_vs_jax():
    """Many blobs at random row offsets (tests/test_preprocessing.py's
    brute-force scene): labels and feasibility exact."""
    rng = np.random.default_rng(1234)
    lidar, cfg = jcfg.LidarConfig(), jcfg.ProjectionConfig()
    rows, cols = lidar.n_scan, lidar.horizon_scan
    rimg = np.full((rows, cols), np.inf, np.float32)
    valid = np.zeros((rows, cols), bool)
    for k in range(120):
        r0, c0 = rng.integers(0, rows - 6), rng.integers(0, cols - 8)
        h, w = rng.integers(1, 6), rng.integers(1, 8)
        rimg[r0:r0 + h, c0:c0 + w] = 10.0 + 0.001 * k
        valid[r0:r0 + h, c0:c0 + w] = True
    ref = [np.asarray(a) for a in jpr.label_components(
        jnp.asarray(rimg), jnp.asarray(valid), lidar, cfg)]
    got = tpr.label_components(_t(rimg)[None], _t(valid)[None],
                               qt.LidarConfig(), ProjectionConfig())
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), r)


def _agree(got, ref, what):
    share = float((got == ref).mean())
    print(f"{what}: {int(ref.sum())} points, agree on {share:.6f}")
    assert share >= MASK_AGREE, what


@pytest.mark.parametrize("mode", ["Patchwork", "LeGO-LOAM"])
def test_segment_cloud_matches(level_a, mode):
    pts, masks, jc, tc = level_a
    if mode == "Patchwork":       # the non-ground points of a crude strip
        masks = masks & (pts[..., 2] > -1.723 + 0.3)
    got = tpr.segment_cloud(_t(pts), _t(masks), tc.lidar, tc.projection,
                            ground_mode=mode)
    for b in range(2):
        ref = jpr.segment_cloud(jnp.asarray(pts[b]), jnp.asarray(masks[b]),
                                jc.lidar, jc.projection, ground_mode=mode)
        for field in ("valid_segments", "outliers", "ground"):
            _agree(getattr(got, field)[b].numpy(),
                   np.asarray(getattr(ref, field)), f"{mode} {field} {b}")


@pytest.mark.parametrize("subclustering", [True, False])
def test_preprocess_matches(level_a, subclustering):
    """pipeline.preprocess, sub-clustering on and off
    (tests/test_pipeline.py:75-94): off keeps Patchwork's non-ground set,
    on can only shrink it."""
    pts, masks, jc, tc = level_a
    jc = dataclasses.replace(jc, use_subclustering=subclustering)
    tc = dataclasses.replace(tc, use_subclustering=subclustering)
    seg, ground = preprocess(pts, masks, tc, device="cpu")
    for b in range(2):
        rseg, rground = jax_preprocess(jnp.asarray(pts[b]),
                                       jnp.asarray(masks[b]), jc)
        _agree(seg[b].numpy(), np.asarray(rseg), f"segments {b}")
        _agree(ground[b].numpy(), np.asarray(rground), f"ground {b}")
        assert 0 < int(seg[b].sum()) < int(masks[b].sum())


# -------------------------------------------------- register_scan_pair ---

def _errors(rot, trans, gt):
    rerr = math.degrees(float(rotation_geodesic_error(
        torch.tensor(gt[:3, :3], dtype=torch.float32),
        torch.tensor(np.asarray(rot)))))
    return rerr, float(np.linalg.norm(np.asarray(trans) - gt[:3, 3]))


@pytest.mark.parametrize("name,recommended", [("level_a", False),
                                              ("level_a", True),
                                              ("level_hyp4", False)])
def test_register_scan_pair_within_bands(name, recommended):
    spec = _spec(name)
    src, tgt, gt = build_pair(spec)
    jc = build_config(spec)
    if recommended:     # the shipping solver: 4 clique + 2 vote hypotheses
        jc = dataclasses.replace(jc, solver=dataclasses.replace(
            jc.solver, num_hypotheses=4, num_vote_hypotheses=2))
    ref = jax_register(JaxPointBatch.from_numpy(src, RAW_CAPACITY),
                       JaxPointBatch.from_numpy(tgt, RAW_CAPACITY), jc)
    got = qt.register_scan_pair(
        qt.PointBatch.from_numpy(src, RAW_CAPACITY),
        qt.PointBatch.from_numpy(tgt, RAW_CAPACITY),
        qt.config_from_dict(dataclasses.asdict(jc)), device="cpu")
    for who, sol in (("jax", ref.solution), ("port", got.solution)):
        assert bool(np.asarray(sol.valid)), who
        rerr, terr = _errors(sol.rotation, sol.translation, gt)
        print(f"{name} recommended={recommended} {who}: {rerr:.4f} deg, "
              f"{terr:.4f} m")
        assert rerr < GT_ROT_MAX_DEG and terr < GT_TRANS_MAX_M, (who, rerr,
                                                                 terr)
    drot, dtr = _errors(got.solution.rotation, got.solution.translation,
                        np.block([[np.asarray(ref.solution.rotation),
                                   np.asarray(ref.solution.translation
                                              )[:, None]],
                                  [np.zeros((1, 3)), np.ones((1, 1))]]))
    assert drot < ROT_BAND_DEG and dtr < TRANS_BAND_M, (drot, dtr)
    np.testing.assert_array_equal(got.src_voxels.mask.numpy(),
                                  np.asarray(ref.src_voxels.mask))


def test_register_scan_pair_refusals():
    """Ground alignment and ICP are not ported (NotImplementedError);
    oversized captures and images raise ValueError; device=None means the
    card and raises without one."""
    pb = qt.PointBatch.from_numpy(np.ones((8, 3), np.float32), 512)
    for cfg in (qt.config_from_dict({"ground_alignment": {"enabled": True}}),
                qt.config_from_dict({"icp": {"enabled": True}})):
        with pytest.raises(NotImplementedError):
            qt.register_scan_pair(pb, pb, cfg, device="cpu")
    big = torch.zeros((1, (1 << 17) + 1, 3))
    with pytest.raises(ValueError, match="owner packing"):
        tpr.project_to_range_image(big, torch.ones(big.shape[:2], dtype=bool),
                                   qt.LidarConfig())
    dense = dataclasses.replace(qt.LidarConfig(), n_scan=128,
                                horizon_scan=2048)
    with pytest.raises(ValueError, match="overflows"):
        tpr.project_to_range_image(torch.zeros((1, 16, 3)),
                                   torch.ones((1, 16), dtype=torch.bool),
                                   dense)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            qt.register_scan_pair(pb, pb, qt.PipelineConfig())
