"""The twelve CUDA kernels against their plain PyTorch versions, on the card,
and the loop-closing path's device code (pose graph, Scan Context).

Every test here is marked ``gpu`` and skips without a CUDA device. The
machine with the card has no JAX, so this file imports only the port, and
runs without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

The plain versions are themselves held against the JAX package's Pallas
kernels on the CPU (tests/test_torch_frontend.py); the tolerances are
those of chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from quatro_tpu_torch.config import (LidarConfig, PipelineConfig,
                                     SolverConfig, replace)
from quatro_tpu_torch.io.synthetic import make_scan_pair
from quatro_tpu_torch.ops import frontend as tf
from quatro_tpu_torch.ops import kernels, segment
from quatro_tpu_torch.ops.voxel import voxel_downsample
from quatro_tpu_torch.pipeline import extract_features, register_features
from quatro_tpu_torch.solver import vote
from quatro_tpu_torch.solver.scale import tim_consistency_graph
from quatro_tpu_torch.types import PointBatch

pytestmark = pytest.mark.gpu

V = 2048
CFG = PipelineConfig.for_lidar("VLP-16", max_voxels=V)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scans():
    """The level_a VLP-16 pair after the crude ground strip, as (2, 32768,
    3) points and (2, 32768) masks on the CPU."""
    pair = make_scan_pair(seed=101, yaw_deg=38.0,
                          translation=(2.5, -1.2, 0.04),
                          lidar=LidarConfig.preset("VLP-16"))
    pts = torch.zeros(2, 32768, 3)
    masks = torch.zeros(2, 32768, dtype=torch.bool)
    for b, xyz in enumerate(pair[:2]):
        xyz = xyz[xyz[:, 2] > -1.723 + 0.3]
        pts[b, :len(xyz)], masks[b, :len(xyz)] = torch.from_numpy(xyz), True
    return pts, masks


@pytest.fixture(scope="module")
def cloud(dev, scans):
    """A batch of two voxelised VLP-16 scans (the level_a pair), (2, V, 3)
    and (2, V), on the card."""
    vox = [voxel_downsample(p.to(dev), m.to(dev), CFG.voxel_size, V,
                            active_cap=CFG.max_segment_points)
           for p, m in zip(*scans)]
    return (torch.stack([v[0] for v in vox]).contiguous(),
            torch.stack([v[1] for v in vox]).contiguous())


def test_extract_features_any_width_runs_the_kernels(dev, scans):
    """At V = 2000, not a multiple of 512, the card still runs the three
    front-end kernels once each (the CPU's dispatch would take the dense
    path there). The moment sums equal the plain version's on CPU copies
    bit for bit (a ragged last tile of 16 rows), and on the card's own
    normals (an ulp turns the normal of an ill-conditioned row freely) the
    descriptors agree with the plain versions on the CPU within the bounds
    of chip_smoke.py."""
    cfg = PipelineConfig.for_lidar("VLP-16", max_voxels=2000)
    tf.reset_launches()
    vox, desc, dmask, normals = extract_features(*scans, cfg, device=dev)
    assert {k: tf.LAUNCHES[k] for k in ("moment_sums", "spfh", "fpfh")} == \
        {"moment_sums": 1, "spfh": 1, "fpfh": 1}
    assert desc.shape == (2, 2000, 33) and bool(torch.isfinite(desc).all())
    pts, mask = vox.points, vox.mask
    maskf = mask.float().contiguous()
    r = cfg.fpfh.normal_radius
    assert torch.equal(tf.moment_sums(pts, maskf, r).cpu(),
                       tf.moment_sums_plain(pts.cpu(), maskf.cpu(), r))
    assert torch.equal(dmask, mask & normals.valid)
    ref = tf.frontend_fpfh(pts.cpu(), normals.normals.cpu(),
                           normals.valid.cpu(), mask.cpu(),
                           cfg.fpfh.fpfh_radius)
    diff = (desc.cpu() - ref).abs()
    assert float(diff.mean()) < 0.02
    assert float((diff.amax(-1) > 1.0).float().mean()) < 0.02


def test_dense_front_end_refused_on_the_card(dev, scans):
    cfg = PipelineConfig.for_lidar("VLP-16", max_voxels=2048)
    cfg = replace(cfg, fpfh=replace(cfg.fpfh, use_pallas_frontend=False))
    with pytest.raises(ValueError, match="CPU only"):
        extract_features(*scans, cfg, device=dev)


def _moment_sums_bit_equal(pts, maskf, r):
    """B3 against its plain version on CPU copies and across two launches,
    bit for bit, its pre-pass's tile AABBs and active limit equal to
    tile_bounds and active_limit; returns the kernel's output."""
    before = tf.LAUNCHES["moment_sums"]
    got, bounds, lim = tf.moment_sums_launch(pts, maskf, r)
    assert tf.LAUNCHES["moment_sums"] == before + 1
    assert torch.equal(got, tf.moment_sums(pts, maskf, r))
    pc, mc = pts.cpu(), maskf.cpu()
    assert torch.equal(got.cpu(), tf.moment_sums_plain(pc, mc, r))
    assert torch.equal(bounds.cpu(), tf.tile_bounds(pc, mc))
    assert torch.equal(lim.cpu(), tf.active_limit(mc > 0))
    return got


def test_moment_sums_kernel(cloud):
    pts, mask = cloud
    got = _moment_sums_bit_equal(pts, mask.float().contiguous(),
                                 CFG.fpfh.normal_radius)
    assert float(got[..., 0].max()) > 5


def _boundary_pairs(radius, n_pairs, rng):
    """Point pairs at r and r +- a few ulps, each pair across a tile edge
    (slot 31 of one tile, slot 0 of the next), one pair per two tiles,
    the other slots masked: (points (1, 64 n_pairs, 3), maskf)."""
    t = tf.PAIR_TILE
    pts = np.zeros((2 * n_pairs * t, 3), np.float32)
    maskf = np.zeros(2 * n_pairs * t, np.float32)
    for k in range(n_pairs):
        a = rng.uniform(-6, 6, 3)
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        b = a + radius * (1 + rng.integers(-3, 4) * 6e-8) * u
        i = 2 * k * t + t - 1
        pts[i], pts[i + 1] = a, b
        maskf[i] = maskf[i + 1] = 1.0
    return torch.from_numpy(pts)[None], torch.from_numpy(maskf)[None]


@pytest.mark.parametrize("case", ["ragged", "one_row", "all_masked",
                                  "boundary", "holes_first"])
def test_moment_sums_kernel_cases(dev, case):
    """B3 bit-equal to its plain version on CPU copies on what its active
    limit and tile culling find hardest: V = 2000 with a ragged last tile;
    one valid row; every row masked (zeros, limit 0); pairs at the radius
    (d2 == r^2 and a few ulps either side) across tile edges; and valid
    points that are not packed first, so that masked holes and empty
    tiles fall before the limit."""
    rng = np.random.default_rng(41)
    r = 0.5
    v = 2000
    pts = (rng.uniform(-3, 3, (2, v, 3))).astype(np.float32)
    maskf = (rng.uniform(size=(2, v)) > 0.3).astype(np.float32)
    if case == "one_row":
        maskf[:] = 0.0
        maskf[:, 777] = 1.0
    elif case == "all_masked":
        maskf[:] = 0.0
    elif case == "holes_first":
        maskf[:, :1500] = 0.0
        maskf[:, 1500:] = rng.uniform(size=(2, 500)) > 0.5
        maskf[:, 1600:1664] = 0.0               # two empty tiles
        maskf[:, ::7] = 1.0                     # scattered valid points
    if case == "boundary":
        pts, maskf = _boundary_pairs(r, 40, rng)
    else:
        pts, maskf = torch.from_numpy(pts), torch.from_numpy(maskf)
    got = _moment_sums_bit_equal(pts.to(dev).contiguous(),
                                 maskf.to(dev).contiguous(), r).cpu()
    if case == "all_masked":
        assert not bool(got.any())
    elif case == "boundary":
        assert float(got[..., 0].max()) == 2.0   # some pairs at r are in
    else:
        assert float(got[..., 0].max()) >= 1.0


def _spfh_fpfh_bit_equal(pts, nrm, pmf, r):
    """B4's counts and bins equal to its plain version run on the card
    (the same rsqrtf and atan2f) and across two launches, its pre-pass's
    tile AABBs and active limit equal to tile_bounds and active_limit; B5
    on B4's rows bit-equal to its plain version on CPU copies, alone and
    on B4's tile table (as frontend_fpfh launches it). Returns B4's and
    B5's outputs on the CPU."""
    before = {k: tf.LAUNCHES[k] for k in ("spfh", "fpfh")}
    hist, cnt, bounds, lim = tf.spfh_launch(pts, nrm, pmf, r)
    again = tf.spfh(pts, nrm, pmf, r)
    assert torch.equal(hist, again[0]) and torch.equal(cnt, again[1])
    rhist, rcnt = tf.spfh_plain(pts, nrm, pmf, r)
    assert torch.equal(cnt, rcnt)
    assert torch.equal(hist, rhist)
    pc, mc = pts.cpu(), pmf.cpu()
    assert torch.equal(bounds.cpu(), tf.tile_bounds(pc, mc))
    assert torch.equal(lim.cpu(), tf.active_limit(mc > 0))
    rows = (hist * (100.0 / torch.clamp(cnt, min=1.0))[..., None])
    rows = rows.contiguous()
    got = tf.fpfh_sums(pts, rows, pmf, r)
    assert torch.equal(got, tf.fpfh_sums_launch(pts, rows, pmf, r,
                                                (bounds, lim)))
    assert torch.equal(got.cpu(), tf.fpfh_sums_plain(pc, rows.cpu(), mc, r))
    assert {k: tf.LAUNCHES[k] - before[k] for k in before} == \
        {"spfh": 2, "fpfh": 2}
    return hist.cpu(), cnt.cpu(), got.cpu()


def test_spfh_and_fpfh_kernels(cloud):
    pts, mask = cloud
    normals = tf.frontend_normals(pts, mask, CFG.fpfh.normal_radius)
    nrm = normals.normals.contiguous()
    pmf = (mask & normals.valid).float().contiguous()
    _, cnt, _ = _spfh_fpfh_bit_equal(pts, nrm, pmf, CFG.fpfh.fpfh_radius)
    assert float(cnt.max()) > 5


@pytest.mark.parametrize("case", ["ragged", "one_row", "all_masked",
                                  "boundary", "holes_first"])
def test_spfh_fpfh_kernel_cases(dev, case):
    """B4 and B5 on B3's hard cases at the FPFH radius (0.75 m), with
    random unit normals: V = 2000 with a ragged last tile; one valid row
    (no pair: zeros); every row masked (zeros, limit 0); pairs at the
    radius (d2 == r^2 and a few ulps either side) across tile edges; valid
    points after masked holes and empty tiles."""
    rng = np.random.default_rng(43)
    r = 0.75
    v = 2000
    pts = (rng.uniform(-3, 3, (2, v, 3))).astype(np.float32)
    maskf = (rng.uniform(size=(2, v)) > 0.3).astype(np.float32)
    if case == "one_row":
        maskf[:] = 0.0
        maskf[:, 777] = 1.0
    elif case == "all_masked":
        maskf[:] = 0.0
    elif case == "holes_first":
        maskf[:, :1500] = 0.0
        maskf[:, 1500:] = rng.uniform(size=(2, 500)) > 0.5
        maskf[:, 1600:1664] = 0.0
        maskf[:, ::7] = 1.0
    if case == "boundary":
        pts, maskf = _boundary_pairs(r, 40, rng)
    else:
        pts, maskf = torch.from_numpy(pts), torch.from_numpy(maskf)
    nrm = rng.normal(size=tuple(pts.shape)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    hist, cnt, sums = _spfh_fpfh_bit_equal(
        pts.to(dev).contiguous(), torch.from_numpy(nrm).to(dev),
        maskf.to(dev).contiguous(), r)
    if case in ("one_row", "all_masked"):
        assert not bool(cnt.any()) and not bool(sums.any())
    else:
        assert float(cnt.max()) >= 1.0            # some pairs at r are in


def _nn2_bit_equal(a, b, ma, mb):
    """The top-2 kernel's four outputs against the plain version run on
    the CPU with the card's own |a|^2 and |b|^2 (the wrapper's reduction),
    bit for bit; returns the kernel's outputs on the CPU."""
    got = [x.cpu() for x in tf.nearest_neighbors2(a, b, ma, mb)]
    sq_a, sq_b = ((x * x).sum(-1).cpu() for x in (a, b))
    ref = tf._fill_empty(*tf.nearest_neighbors2_plain(
        a.cpu(), b.cpu(), ma.float().cpu(), mb.float().cpu(), sq_a, sq_b),
        ma.cpu())
    for name, g, r in zip(("i1", "d1", "i2", "d2"), got, ref):
        assert torch.equal(g, r), name
    return got


# Nb = 4096: two column chunks, and the strict-less merge hands the second
# slot to the later chunk's tied copy (3000); Nb = 3072: one chunk, ties go
# to the lower index (101).
@pytest.mark.parametrize("nb,second", [(4096, 3000), (3072, 101)])
def test_nearest_neighbors2_kernel(dev, nb, second):
    """Random descriptors at Na = 512 with exact duplicates across and
    inside a chunk: all four outputs bit-equal to the plain version on the
    CPU, and the planted ties decided as the Pallas kernel decides them."""
    rng = np.random.default_rng(5)
    da = rng.uniform(0, 100, (512, 33)).astype(np.float32)
    db = rng.uniform(0, 100, (nb, 33)).astype(np.float32)
    db[3000] = db[100]
    db[101] = db[100]
    da[:20] = db[100]
    ma = rng.uniform(size=512) > 0.1
    mb = rng.uniform(size=nb) > 0.1
    ma[:20] = True
    mb[[100, 101, 3000]] = True
    a, b = (torch.from_numpy(x)[None].to(dev) for x in (da, db))
    ma_t, mb_t = (torch.from_numpy(x)[None].to(dev) for x in (ma, mb))
    i1, _, i2, _ = (x[0] for x in _nn2_bit_equal(a, b, ma_t, mb_t))
    assert (i1[:20] == 100).all() and (i2[:20] == second).all()


# Column 100 has copies in another lane of its tile (101: lanes take every
# 8th column), in its own lane (108), in its lane of the next chunk (2148)
# and in another lane of the next chunk (2149); Na = 1001 is no multiple of
# the kernel's 16 rows per block.
@pytest.mark.parametrize("case", ["lanes", "batch", "five_columns", "ragged"])
def test_nearest_neighbors2_kernel_cases(dev, case):
    """The redesigned top-2 kernel (8 lanes per row, merged at each chunk
    end, active limits) against the plain version on the CPU, all four
    outputs bit for bit: duplicate columns in different lanes and in one
    lane of a chunk and across a chunk edge; a batch of 2 whose entries
    end their valid rows and columns at different places; every column
    invalid past index 5; Na = 1001 against Nb = 3000 (one chunk, a
    ragged last tile)."""
    rng = np.random.default_rng(17)
    na, nb, bsz = {"lanes": (512, 4096, 1), "batch": (1024, 4096, 2),
                   "five_columns": (600, 2048, 1),
                   "ragged": (1001, 3000, 1)}[case]
    da = rng.uniform(0, 12, (bsz, na, 33)).astype(np.float32)
    db = rng.uniform(0, 12, (bsz, nb, 33)).astype(np.float32)
    ma = rng.uniform(size=(bsz, na)) > 0.1
    mb = rng.uniform(size=(bsz, nb)) > 0.1
    if case == "lanes":
        for j in (101, 108, 2148, 2149):
            db[0, j] = db[0, 100]
        mb[0, [100, 101, 108, 2148, 2149]] = True
        da[0, :16] = db[0, 100]
        ma[0, :16] = True
    elif case == "batch":
        ma[0, 700:], mb[0, 1500:] = False, False
        ma[1, 333:], mb[1, 3900:] = False, False
    elif case == "five_columns":
        mb[0, 6:] = False
    a, b = (torch.from_numpy(x).to(dev) for x in (da, db))
    ma_t, mb_t = (torch.from_numpy(x).to(dev) for x in (ma, mb))
    lim = tf.nn_active_limits(ma_t, mb_t).cpu()
    for k in range(bsz):
        assert lim[k].tolist() == [int(np.nonzero(ma[k])[0][-1]) + 1,
                                   int(np.nonzero(mb[k])[0][-1]) + 1]
    before = tf.LAUNCHES["nearest_neighbors2"]
    i1, d1, i2, d2 = _nn2_bit_equal(a, b, ma_t, mb_t)
    assert tf.LAUNCHES["nearest_neighbors2"] == before + 1
    again = tf.nearest_neighbors2(a, b, ma_t, mb_t)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(again,
                                                       (i1, d1, i2, d2)))
    if case == "lanes":
        # the first slot to the lowest copy; the strict-less merge hands
        # the second to the later chunk's first copy, as for Nb = 4096
        assert (i1[0, :16] == 100).all() and (i2[0, :16] == 2148).all()
    if case == "five_columns":
        live = torch.from_numpy(ma)
        assert bool((i1[live] < 6).all()) and bool((i2[live] < 6).all())


@pytest.mark.parametrize("v", [2000, 8192])
def test_nearest_neighbors_kernel(dev, v):
    """B6 at V = 2000 and 8192 (D = 33): one launch per call; the same
    bits as the first slot of the top-2 kernel (the same per-pair
    arithmetic); against the plain version distances within rtol 1e-5
    plus 1e-6 of the norm scale and the index equal wherever the gap to
    the second neighbour is clear; on descriptors rounded to a 1/8 grid
    (exact distances) index and d2 equal bit for bit. Ties go to the first
    minimum; invalid rows and an all-invalid B give index 0 / f32 max."""
    rng = np.random.default_rng(v)
    da = rng.uniform(0, 12, (v, 33)).astype(np.float32)
    db = rng.uniform(0, 12, (v, 33)).astype(np.float32)
    db[v - 1] = db[100]
    db[101] = db[100]
    da[:20] = db[100]
    ma = rng.uniform(size=v) > 0.1
    mb = rng.uniform(size=v) > 0.1
    ma[:20] = True
    mb[[100, 101, v - 1]] = True
    a, b = (torch.from_numpy(x)[None].to(dev) for x in (da, db))
    ma_t, mb_t = (torch.from_numpy(x)[None].to(dev) for x in (ma, mb))
    before = tf.LAUNCHES["nearest_neighbors"]
    idx, d2 = tf.nearest_neighbors(a, b, ma_t, mb_t)
    assert tf.LAUNCHES["nearest_neighbors"] == before + 1
    i1, d1, _, _ = tf.nearest_neighbors2(a, b, ma_t, mb_t)
    assert torch.equal(idx, i1) and torch.equal(d2, d1)

    def plain(x, y, mask_y):
        ri, rd = tf.nearest_neighbors_plain(x, y, ma_t.float(),
                                            mask_y.float(), (x * x).sum(-1),
                                            (y * y).sum(-1))
        empty = ~ma_t | (rd >= tf.FLT_MAX)
        return torch.where(empty, 0, ri), torch.where(empty, tf.FLT_MAX, rd)

    ridx, rd2 = plain(a, b, mb_t)
    _, _, _, second = tf._fill_empty(*tf.nearest_neighbors2_plain(
        a, b, ma_t.float(), mb_t.float(), (a * a).sum(-1), (b * b).sum(-1)),
        ma_t)
    scale = float((a * a).sum(-1).max() + (b * b).sum(-1).max())
    assert bool(((d2 - rd2).abs() <= 1e-5 * rd2 + 1e-6 * scale).all())
    clear = ma_t & (second - rd2 > 1e-4 * rd2)
    assert torch.equal(idx[clear], ridx[clear])
    assert (idx[0, :20] == 100).all()
    assert (idx[~ma_t] == 0).all() and (d2[~ma_t] == tf.FLT_MAX).all()
    ga, gb = (torch.round(x * 8.0) / 8.0 for x in (a, b))
    assert all(torch.equal(g, r) for g, r in zip(
        tf.nearest_neighbors(ga, gb, ma_t, mb_t), plain(ga, gb, mb_t)))
    none = torch.zeros_like(mb_t)
    idx0, d0 = tf.nearest_neighbors(a, b, ma_t, none)
    assert (idx0 == 0).all() and (d0 == tf.FLT_MAX).all()


@pytest.mark.parametrize("path",
                         ["ground_alignment_icp", "reference_matcher"])
def test_register_scan_pair_paths(dev, path):
    """The level_a VLP-16 pair through two more configurations: ground
    alignment and ICP under the shipping solver
    (top-2 NN twice, 1-NN never), and the reference matcher
    (crosscheck_min_matches=0: 1-NN twice, top-2 never, no vote)."""
    from quatro_tpu_torch.config import GroundAlignmentConfig, IcpConfig
    from quatro_tpu_torch.pipeline import register_scan_pair
    base = replace(CFG, max_raw_points=32768)
    if path == "ground_alignment_icp":
        cfg = replace(base, solver=SolverConfig(num_hypotheses=4,
                                                num_vote_hypotheses=2),
                      ground_alignment=GroundAlignmentConfig(enabled=True),
                      icp=IcpConfig(enabled=True))
        nn1, nn2, seg = 0, 2, 1
    else:
        cfg = replace(base, fpfh=replace(base.fpfh,
                                         crosscheck_min_matches=0))
        nn1, nn2, seg = 2, 0, 0
    pair = make_scan_pair(seed=101, yaw_deg=38.0,
                          translation=(2.5, -1.2, 0.04),
                          lidar=LidarConfig.preset("VLP-16"))
    src, tgt = (PointBatch.from_numpy(xyz, 32768) for xyz in pair[:2])
    register_scan_pair(src, tgt, cfg, device=dev)
    tf.reset_launches()
    res = register_scan_pair(src, tgt, cfg, device=dev)
    torch.cuda.synchronize()
    assert (tf.LAUNCHES["nearest_neighbors"],
            tf.LAUNCHES["nearest_neighbors2"],
            tf.LAUNCHES["segment_sums"]) == (nn1, nn2, seg)
    assert tf.LAUNCHES["consistency_graph"] == 1
    assert bool(res.solution.valid)
    assert res.solution.rotation.device.type == "cuda"
    if cfg.icp.enabled:
        assert bool(res.icp.converged)


@pytest.fixture(scope="module")
def recommended(dev, scans):
    """One register_features run of the shipping multi-hypothesis solver
    on the level_a pair at V = 2048, with its launch counts."""
    cfg = replace(CFG, solver=SolverConfig(num_hypotheses=4,
                                           num_vote_hypotheses=2))
    pts, masks = scans
    src, tgt = (PointBatch(pts[b], masks[b]) for b in (0, 1))
    register_features(src, tgt, cfg, device=dev)         # builds the kernels
    tf.reset_launches()
    res = register_features(src, tgt, cfg, device=dev)
    torch.cuda.synchronize()
    return res, dict(tf.LAUNCHES), cfg


def test_recommended_runs_all_six_kernels(recommended):
    res, launches, _ = recommended
    assert launches == {"moment_sums": 1, "spfh": 1, "fpfh": 1,
                        "nearest_neighbors": 0,
                        "nearest_neighbors2": 2, "consistency_graph": 1,
                        "segment_sums": 1, "cross_histogram": 0,
                        "fit_iteration_moments": 0, "classify_points": 0,
                        "image_lookup": 0, "table_lookup": 0}
    assert bool(res.solution.valid)
    assert res.hypotheses.rotation.shape[0] == 6
    for name in ("valid", "rotation", "translation", "max_clique_mask",
                 "final_inlier_mask", "num_rotation_inliers",
                 "gnc_iterations", "gnc_cost", "scale"):
        assert getattr(res.solution, name).device.type == "cuda", name
        assert getattr(res.hypotheses, name).device.type == "cuda", name


def test_consistency_graph_kernel(recommended):
    """B1 equals its plain version bit for bit on the pair's own
    correspondences."""
    corr = recommended[0].correspondences
    before = tf.LAUNCHES["consistency_graph"]
    got = kernels.consistency_graph(corr.src_xyz, corr.tgt_xyz, 0.6)
    assert tf.LAUNCHES["consistency_graph"] == before + 1
    ref = kernels.consistency_graph_plain(corr.src_xyz, corr.tgt_xyz, 0.6)
    assert torch.equal(got, ref)
    odd = kernels.consistency_graph(corr.src_xyz[:1000].contiguous(),
                                    corr.tgt_xyz[:1000].contiguous(), 0.6)
    assert torch.equal(odd, ref[:1000, :1000])


def test_segment_sums_kernel(recommended):
    """B2 on the vote's own entries: its plain version's bits on CPU
    copies (the kernel's order: index order within each SEG_CHUNK chunk,
    then chunk order), and the same bits on a second launch; and at 131072
    entries, 10 channels and an arbitrary 640 bins with ids out of
    range."""
    res, _, cfg = recommended
    corr = res.correspondences
    adj = tim_consistency_graph(corr.src_xyz, corr.tgt_xyz, corr.mask,
                                cfg.solver.noise_bound, cfg.solver.cbar2)
    ids, vals = vote.yaw_vote_entries(corr.src_xyz, corr.tgt_xyz, corr.mask,
                                      adj)
    rng = np.random.default_rng(3)
    big_ids = torch.from_numpy(rng.integers(-5, 645, 131072).astype(
        np.int32)).to(ids.device)
    big_vals = torch.from_numpy(rng.uniform(0, 1, (10, 131072)).astype(
        np.float32)).to(ids.device)
    for i, v, p in ((ids, vals, 256), (big_ids, big_vals, 640)):
        got = segment.segment_sums(i, v, p)
        again = segment.segment_sums(i, v, p)
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), segment.segment_sums_plain(
            i.cpu(), v.cpu(), p, segment.SEG_CHUNK))


def _segment_sums_bit_equal(ids, vals, p_pad):
    """B2 against its plain version on CPU copies and across two launches,
    bit for bit, with one launch per call and the last block's ticket back
    at 0."""
    before = tf.LAUNCHES["segment_sums"]
    got = segment.segment_sums(ids, vals, p_pad)
    again = segment.segment_sums(ids, vals, p_pad)
    assert tf.LAUNCHES["segment_sums"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), segment.segment_sums_plain(
        ids.cpu(), vals.cpu(), p_pad, segment.SEG_CHUNK))
    for ticket, _ in segment._SEG_SCRATCH.values():
        assert int(ticket.item()) == 0


def _segment_case(dev, n, k, lo, hi, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(lo, hi, n).astype(np.int32)
    vals = rng.normal(0, 10, (k, n)).astype(np.float32)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)


# N around one chunk (1024) and the pose graph's 38; p_pad 12 (the pose
# graph's) and 300 (two blocks of 256 bins); ids out of range both sides
@pytest.mark.parametrize("p_pad", [12, 300])
@pytest.mark.parametrize("k", [3, 4, 10])
@pytest.mark.parametrize("n", [1, 38, 1023, 1024, 1025, 65536 + 7])
def test_segment_sums_kernel_shapes(dev, n, k, p_pad):
    _segment_sums_bit_equal(*_segment_case(dev, n, k, -3, p_pad + 3,
                                           n + k + p_pad), p_pad)


@pytest.mark.parametrize("case", ["one_bin", "out_of_range", "empty"])
def test_segment_sums_kernel_cases(dev, case):
    """Every entry in one bin (each chunk's run is all of it: the vote's
    true yaw at its worst), every id out of range (zeros), and N = 0."""
    n = {"empty": 0}.get(case, 65536 + 7)
    lo, hi = {"one_bin": (77, 78), "out_of_range": (256, 300)}.get(
        case, (0, 256))
    ids, vals = _segment_case(dev, n, 3, lo, hi, 5)
    _segment_sums_bit_equal(ids, vals, 256)
    if case != "one_bin":
        assert not segment.segment_sums(ids, vals, 256).any()


def test_consistency_graph_sqrt_is_ieee(dev):
    """B1's branch-free square root (``sqrt_rn`` in
    csrc/consistency_graph.cu) gives __fsqrt_rn's bits on every
    non-negative float from 0 to +inf."""
    assert kernels.sqrt_rn_mismatches(dev) == 0


@pytest.mark.parametrize("n", [1, 17, 1000, 1024, 2048])
def test_consistency_graph_kernel_sizes(dev, n):
    """B1 at sizes that are and are not multiples of 16 (rows that start
    inside a 16-byte piece): equal to its plain version, and symmetric."""
    rng = np.random.default_rng(n)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = src + rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    src, tgt = (torch.from_numpy(a).to(dev) for a in (src, tgt))
    before = tf.LAUNCHES["consistency_graph"]
    got = kernels.consistency_graph(src, tgt, 0.6)
    assert tf.LAUNCHES["consistency_graph"] == before + 1
    assert torch.equal(got, kernels.consistency_graph_plain(src, tgt, 0.6))
    assert torch.equal(got, got.T)
    assert 0 < int(got.sum()) < n * n or n == 1


def test_plain_graph_refused_on_the_card(dev, recommended):
    corr = recommended[0].correspondences
    with pytest.raises(ValueError, match="CPU only"):
        tim_consistency_graph(corr.src_xyz, corr.tgt_xyz, corr.mask, 0.3,
                              use_pallas=False)


# ------------------------------------------------- preprocessing, B8-B11 --

# the main path's shapes (B = 2 clouds of 131072 points, 504 patches padded
# to 512, 128 z-bins, a 64 x 1800 image) and an odd N, not a multiple of
# 1024 (nor of the kernels' chunks)
@pytest.fixture(scope="module", params=[131072, 100001], ids=["main", "odd"])
def prep_inputs(dev, request):
    """Random kernel inputs on the card: ids with some out of range on
    both sides, patch-table rows with real normals and flags."""
    n = request.param
    rng = np.random.default_rng(n)
    p_pad, p_cnt = 512, 504
    ids = rng.integers(-3, p_pad + 3, (2, n)).astype(np.int32)
    zb = rng.integers(-2, 130, (2, n)).astype(np.int32)
    w = np.stack([rng.uniform(size=(2, n)) > 0.2,
                  rng.normal(-1.7, 0.5, (2, n))], 1).astype(np.float32)
    chan = rng.normal(0, 5, (2, 5, n)).astype(np.float32)
    nrm = rng.normal(0, 0.1, (2, p_pad, 3)) + [0, 0, 1]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tab = np.concatenate([nrm, rng.normal(0, 2, (2, p_pad, 1)),
                          rng.integers(0, 16, (2, p_pad, 1))], -1)
    tab[:, p_cnt:] = 0.0
    flat = rng.integers(-5, 64 * 1800 + 5, (2, n)).astype(np.int32)
    img = rng.integers(-1, 1 << 19, (2, 64, 1800)).astype(np.int32)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in
         dict(ids=ids, zb=zb, w=w, chan=chan, tab=tab.astype(np.float32),
              flat=flat, img=img).items()}
    return t, p_pad, p_cnt


def _cross_histogram_bit_equal(ids_a, ids_b, w, a_pad, b_pad):
    """B8 against its plain version on CPU copies, bit for bit, and the
    same bits on a second launch; returns the kernel's output."""
    before = tf.LAUNCHES["cross_histogram"]
    got = segment.cross_histogram(ids_a, ids_b, w, a_pad, b_pad)
    assert tf.LAUNCHES["cross_histogram"] == before + 1
    assert torch.equal(got, segment.cross_histogram(ids_a, ids_b, w, a_pad,
                                                    b_pad))
    ref = segment.cross_histogram_plain(ids_a.cpu(), ids_b.cpu(), w.cpu(),
                                        a_pad, b_pad)
    assert torch.equal(got.cpu(), ref)
    return got


def test_cross_histogram_kernel(prep_inputs):
    """B8: the same bits on a second launch and the plain version's bits
    (the kernel keeps its order of additions: index order within each
    8192-point chunk, then chunk order)."""
    t, p_pad, _ = prep_inputs
    _cross_histogram_bit_equal(t["ids"], t["zb"], t["w"], p_pad, 128)


@pytest.mark.parametrize("case", ["one_row", "one_chunk", "out_of_range",
                                  "four_channels"])
def test_cross_histogram_kernel_cases(dev, case):
    """B8 on the inputs its compaction finds hardest, bit-equal to the
    plain version on CPU copies: every point in one histogram row (one
    block keeps every point), every point in one chunk (N = 5000), ids out
    of range on both axes (a third of them), and K = 4 weight channels at
    an a_pad of 200 (no multiple of the block's 32 rows)."""
    rng = np.random.default_rng(23)
    n, k, a_pad, b_pad = {"one_row": (40000, 2, 512, 128),
                          "one_chunk": (5000, 2, 512, 128),
                          "out_of_range": (50000, 2, 512, 128),
                          "four_channels": (30000, 4, 200, 96)}[case]
    ids_a = rng.integers(0, a_pad, (2, n))
    ids_b = rng.integers(0, b_pad, (2, n))
    if case == "one_row":
        ids_a[:] = 37
    if case == "out_of_range":
        ids_a = rng.integers(-a_pad // 2, a_pad + a_pad // 2, (2, n))
        ids_b = rng.integers(-b_pad // 2, b_pad + b_pad // 2, (2, n))
    w = rng.normal(0, 3, (2, k, n)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
            (ids_a.astype(np.int32), ids_b.astype(np.int32), w)]
    got = _cross_histogram_bit_equal(*args, a_pad, b_pad)
    assert int((got[:, 0] != 0).sum()) > 0


def _fit_bit_equal(ids, chan, tab, p_pad, p_cnt, exact):
    """B9 against its plain version on CPU copies and across two launches,
    bit for bit, its pre-pass's limit equal to fit_active_limit; returns
    the kernel's output."""
    before = tf.LAUNCHES["fit_iteration_moments"]
    got, lim = segment.fit_iteration_moments_launch(ids, chan, tab, p_pad,
                                                    p_cnt, exact)
    assert tf.LAUNCHES["fit_iteration_moments"] == before + 1
    assert torch.equal(got, segment.fit_iteration_moments(
        ids, chan, tab, p_pad, p_cnt, exact=exact))
    ref = segment.fit_iteration_moments_plain(
        ids.cpu(), chan.cpu(), tab.cpu(), p_pad, p_cnt, exact=exact)
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(lim.cpu(), segment.fit_active_limit(ids.cpu(), p_pad,
                                                           p_cnt))
    return got


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", ["one_patch_chunk", "out_of_range",
                                  "ragged"])
def test_fit_iteration_moments_kernel_cases(dev, case, exact):
    """B9 bit-equal to its plain version on CPU copies under both flags:
    one patch holding whole chunks (and the dump patch p_cnt the tail, as
    Patchwork's padding does); a third of the ids at or past p_cnt or
    below 0; and N = 9001, no multiple of the chunk, at an odd p_pad of
    640 with runs of one patch as scan order gives them."""
    rng = np.random.default_rng(57)
    n, p_pad, p_cnt = {"one_patch_chunk": (3 * segment.FIT_CHUNK, 512, 504),
                       "out_of_range": (50000, 512, 504),
                       "ragged": (9001, 640, 600)}[case]
    if case == "one_patch_chunk":
        ids = np.full((2, n), 37)
        ids[:, segment.FIT_CHUNK // 2:] = 300
        ids[:, -700:] = p_cnt
    elif case == "out_of_range":
        ids = rng.integers(-p_pad // 4, p_cnt + p_pad // 4, (2, n))
    else:
        ids = np.repeat(rng.integers(0, p_cnt, n), rng.integers(1, 90, n))
        ids = ids[:2 * n].reshape(2, n)
    chan = rng.normal(0, 5, (2, 5, n)).astype(np.float32)
    nrm = rng.normal(0, 0.1, (2, p_pad, 3)) + [0, 0, 1]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tab = np.concatenate([nrm, rng.normal(0, 3, (2, p_pad, 2))], -1)
    tab[:, p_cnt:] = 0.0
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
            (ids.astype(np.int32), chan, tab.astype(np.float32))]
    got = _fit_bit_equal(*args, p_pad, p_cnt, exact)
    assert float(got[..., 0].sum()) > 0
    assert not bool(got[:, p_cnt:].any())


@pytest.mark.parametrize("exact", [False, True])
def test_fit_iteration_moments_kernel(prep_inputs, exact):
    """B9: the same bits on a second launch and the plain version's bits
    on CPU copies (bf16 channels when not exact; the kernel's order: index
    order within each FIT_CHUNK chunk, then chunk order)."""
    t, p_pad, p_cnt = prep_inputs
    got = _fit_bit_equal(t["ids"], t["chan"], t["tab"], p_pad, p_cnt, exact)
    assert float(got[..., 0].sum()) > 0


def test_classify_points_and_image_lookup_kernels(prep_inputs):
    """B10 and B11 equal their plain versions bit for bit."""
    t, p_pad, p_cnt = prep_inputs
    args = (t["ids"], t["chan"], t["tab"], p_pad, p_cnt)
    code = segment.classify_points(*args)
    assert torch.equal(code, segment.classify_points_plain(*args))
    assert len(torch.unique(code)) > 3
    got = segment.image_lookup(t["flat"], t["img"], 64, 1800)
    assert torch.equal(got, segment.image_lookup_plain(t["flat"], t["img"],
                                                       64, 1800))


def test_register_scan_pair_runs_all_ten_kernels(dev):
    """register_scan_pair on the raw level_a VLP-16 pair under the shipping
    solver: every kernel launched, the preprocessing ones once per batch
    of two (three plane fits)."""
    from quatro_tpu_torch.pipeline import register_scan_pair
    cfg = replace(CFG, max_raw_points=32768,
                  solver=SolverConfig(num_hypotheses=4,
                                      num_vote_hypotheses=2))
    pair = make_scan_pair(seed=101, yaw_deg=38.0,
                          translation=(2.5, -1.2, 0.04),
                          lidar=LidarConfig.preset("VLP-16"))
    src, tgt = (PointBatch.from_numpy(xyz, 32768) for xyz in pair[:2])
    register_scan_pair(src, tgt, cfg, device=dev)
    tf.reset_launches()
    res = register_scan_pair(src, tgt, cfg, device=dev)
    torch.cuda.synchronize()
    assert dict(tf.LAUNCHES) == {
        "moment_sums": 1, "spfh": 1, "fpfh": 1, "nearest_neighbors": 0,
        "nearest_neighbors2": 2,
        "consistency_graph": 1, "segment_sums": 1, "cross_histogram": 1,
        "fit_iteration_moments": 3, "classify_points": 1, "image_lookup": 1,
        "table_lookup": 0}
    assert bool(res.solution.valid)


def test_table_lookup_kernel(prep_inputs):
    """B12 equals its plain version bit for bit (it only copies), zeros
    for the out-of-range ids included, at the main path's N and the odd
    N, with the Patchwork table (K = 5) and a wider one (K = 10)."""
    t, p_pad, _ = prep_inputs
    wide = torch.cat([t["tab"], t["tab"] * 2.0], -1).contiguous()
    for tab in (t["tab"], wide):
        before = tf.LAUNCHES["table_lookup"]
        got = segment.table_lookup(t["ids"], tab)
        assert tf.LAUNCHES["table_lookup"] == before + 1
        assert torch.equal(got, segment.table_lookup_plain(t["ids"], tab))
        oor = (t["ids"] < 0) | (t["ids"] >= p_pad)
        assert bool(oor.any()) and bool((got.transpose(1, 2)[oor] == 0).all())
    with pytest.raises(ValueError, match="shared memory"):
        segment.table_lookup(t["ids"], torch.zeros(
            (2, 65536, 1), device=t["ids"].device))


def _pose_graph(dev, m=12):
    """A 12-pose loop with four closures and noisy measurements, the two
    edges at pose 4 masked (a component of its own), as in
    tests/test_torch_sequence.py."""
    from quatro_tpu_torch.parallel.posegraph import PoseGraphEdges
    rng = np.random.default_rng(7)
    ang = 2 * np.pi * np.arange(m) / m
    gt = np.stack([6 * np.cos(ang) - 6, 6 * np.sin(ang), 0.1 * np.arange(m),
                   np.arctan2(np.cos(ang), -np.sin(ang))], 1)
    ei = np.int32(list(range(m - 1)) + [0, 2, 7, 8])
    ej = np.int32(list(range(1, m)) + [11, 9, 10, 11])
    c, s = np.cos(gt[ei, 3]), np.sin(gt[ei, 3])
    d = gt[ej, :3] - gt[ei, :3]
    t = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                  d[:, 2]], 1) + rng.normal(0, 0.05, (len(ei), 3))
    dy = gt[ej, 3] - gt[ei, 3]
    y = np.arctan2(np.sin(dy), np.cos(dy)) + rng.normal(0, 0.01, len(ei))
    mask = np.ones(len(ei), bool)
    mask[[3, 4]] = False
    edges = PoseGraphEdges(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                             for a in (ei, ej, t.astype(np.float32),
                                       y.astype(np.float32),
                                       rng.uniform(5, 100, len(ei)).astype(
                                           np.float32), mask)))
    p0 = (gt + rng.normal(0, 0.3, gt.shape)).astype(np.float32)
    p0[0] = gt[0]
    return torch.from_numpy(p0).to(dev), edges


def test_optimize_pose_graph_repeats_on_the_card(dev):
    """Two solves of one graph on the card give the same bits (the J^T
    scatter goes through B2, one launch per apply); the result is finite,
    the disconnected pose stays put, and it lies within 1e-3 of the CPU
    solve (f32 CG at 10 x 40 is not converged on this graph)."""
    from quatro_tpu_torch.parallel.posegraph import optimize_pose_graph
    p0, edges = _pose_graph(dev)
    before = tf.LAUNCHES["segment_sums"]
    a = optimize_pose_graph(p0, edges, 12, gn_iters=10, cg_iters=40)
    assert tf.LAUNCHES["segment_sums"] == before + 10 * 41
    b = optimize_pose_graph(p0, edges, 12, gn_iters=10, cg_iters=40)
    assert a.device.type == "cuda" and torch.equal(a, b)
    assert bool(torch.isfinite(a).all())
    assert torch.equal(a[4], p0[4])
    cpu = optimize_pose_graph(p0.cpu(), type(edges)(*(x.cpu() for x in edges)),
                              12, gn_iters=10, cg_iters=40)
    torch.testing.assert_close(a.cpu(), cpu, rtol=0, atol=1e-3)


def test_scan_context_on_the_card(dev):
    """scan_context of the level_a scans on the card against the CPU: every
    point in the same cell and every descriptor cell equal (the arctangent
    is utils/fused.atan2 on both devices; CUDA's own moved 126 / 130 points
    on sector edges, every 15th column of the synthetic lidar), and so the
    pair's distance equal too."""
    from quatro_tpu_torch.ops.scancontext import (scan_context,
                                                  scan_context_cells,
                                                  sc_distance)
    pair = make_scan_pair(seed=101, yaw_deg=38.0,
                          translation=(2.5, -1.2, 0.04),
                          lidar=LidarConfig.preset("VLP-16"))
    descs = []
    for xyz in pair[:2]:
        pb = PointBatch.from_numpy(xyz, 32768)
        got = scan_context(pb.points.to(dev), pb.mask.to(dev)).cpu()
        ref = scan_context(pb.points, pb.mask)
        cell = scan_context_cells(pb.points.to(dev), pb.mask.to(dev)).cpu()
        cell_ref = scan_context_cells(pb.points, pb.mask)
        moved = int((cell != cell_ref).sum())
        differ = int((got != ref).sum())
        print(f"scan_context: {moved} points moved a cell, {differ} of "
              f"{int((ref > 0).sum())} occupied cells differ between the "
              "card and the CPU")
        assert moved == 0 and differ == 0
        descs.append((got, ref))
    assert float(sc_distance(descs[0][0], descs[1][0])) == float(
        sc_distance(descs[0][1], descs[1][1]))


def test_fused_atan2_on_the_card(dev):
    """utils/fused.atan2 gives the same bits on the card as on the CPU, on
    random legs over many scales and on the axes."""
    from quatro_tpu_torch.utils import fused
    rng = np.random.default_rng(29)
    v = (rng.normal(0, 1, (2, 400000))
         * np.exp(rng.uniform(-20, 20, (2, 400000)))).astype(np.float32)
    v[:, :8] = [[0.0, -0.0, 1.0, -1.0, 0.0, 3.0, -0.0, 2.0],
                [1.0, 1.0, 0.0, 0.0, -2.0, -0.0, -0.0, 2.0]]
    y, x = torch.from_numpy(v[0]), torch.from_numpy(v[1])
    got = fused.atan2(y.to(dev), x.to(dev)).cpu()
    assert torch.equal(got.view(torch.int32), fused.atan2(y, x).view(
        torch.int32))


@pytest.mark.parametrize("lidar", ["VLP-16", "Velodyne-64-HDE"])
def test_angle_bins_on_the_card(dev, lidar):
    """The synthetic scans put points on angle edges (rings on range-image
    row edges, every 15th column on a sector edge): Patchwork's CZM patch
    ids and every output of the range-image projection on the card equal
    the CPU's, which equal the JAX package's (utils/fused.atan2 on both
    devices; CUDA's own arctangent is an ulp off on some edge points,
    ROADMAP C 12)."""
    from quatro_tpu_torch.preprocessing import patchwork, projection
    cfg = PipelineConfig.for_lidar(lidar)
    pair = make_scan_pair(seed=11, yaw_deg=20.0, translation=(2.5, 1.0, 0.05),
                          lidar=LidarConfig.preset(lidar))
    for xyz in pair[:2]:
        pb = PointBatch.from_numpy(xyz, 131072)
        pts, mask = pb.points[None], pb.mask[None]
        for got, ref in zip(
                patchwork.czm_bin(pts.to(dev), mask.to(dev), cfg.patchwork),
                patchwork.czm_bin(pts, mask, cfg.patchwork)):
            assert torch.equal(got.cpu(), ref)
        for got, ref in zip(
                projection.project_to_range_image(pts.to(dev), mask.to(dev),
                                                  cfg.lidar),
                projection.project_to_range_image(pts, mask, cfg.lidar)):
            assert torch.equal(got.cpu(), ref)


def test_teaser_on_jax_path_b_correspondences_on_the_card(dev):
    """The card's TEASER and default solve on the JAX package's own path B
    correspondences (tests/torch_teaser_path_b.npz, its recipe in
    tests/test_torch_repeatability.py): valid, and within the CPU's band
    of the JAX package's poses, 1.3e-5 in every entry of the 4x4
    transform."""
    import dataclasses
    from pathlib import Path

    from quatro_tpu_torch.solver.quatro import register_correspondences
    z = np.load(Path(__file__).resolve().parent / "torch_teaser_path_b.npz")
    solver = PipelineConfig(max_voxels=8192).solver
    for name, sc in (("teaser_pose",
                      dataclasses.replace(solver, reg_name="TEASER")),
                     ("default_pose", solver)):
        sol = register_correspondences(z["src_xyz"], z["tgt_xyz"], z["mask"],
                                       sc, device=dev)
        assert bool(sol.valid)
        err = float(np.abs(sol.transform().cpu().numpy() - z[name]).max())
        print(f"{name}: the card's pose within {err:.3g} of the JAX "
              "package's")
        assert err <= 1.3e-5, (name, err)
