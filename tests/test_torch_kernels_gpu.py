"""The thirty-two CUDA kernels against their plain PyTorch versions, on the card,
and the loop-closing path's device code (pose graph, Scan Context).

Every test here is marked ``gpu`` and skips without a CUDA device. The
machine with the card has no JAX, so this file imports only the port, and
runs without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

The plain versions are themselves held against the JAX package's Pallas
kernels on the CPU (tests/test_torch_frontend.py); the tolerances are
those of chip_smoke.py.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from quatro_tpu_torch.config import (LidarConfig, PipelineConfig,
                                     SolverConfig, replace)
from quatro_tpu_torch.io.synthetic import make_scan_pair
from quatro_tpu_torch.ops import frontend as tf
from quatro_tpu_torch.ops import kernels, launch, segment
from quatro_tpu_torch.ops.voxel import voxel_downsample
from quatro_tpu_torch.pipeline import extract_features, register_features
from quatro_tpu_torch.solver import vote
from quatro_tpu_torch.solver.quatro import register_correspondences
from quatro_tpu_torch.solver.scale import tim_consistency_graph
from quatro_tpu_torch.types import PointBatch

from torch_clique_cases import (GRAPHS, clique_stage_calls, distinct_case,
                                graph_case, miss_one_batch,
                                plain_clique_route, wide_graphs)
from torch_czm_cases import CZM_CONFIGS, czm_specials

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
    """B6 at V = 2000 and 8192 (D = 33): one launch per call, two launches
    the same bits; the same bits as the first slot of the top-2 kernel
    (the same per-pair
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
    again = tf.nearest_neighbors(a, b, ma_t, mb_t)
    assert torch.equal(idx, again[0]) and torch.equal(d2, again[1])
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


def _packed(rng, n, region, valid):
    """(n,) bool: ``valid`` True among the first ``region`` entries, the
    last of them True, the invalid ones scattered among them: the voxel
    grid's packing."""
    m = np.zeros(n, bool)
    m[rng.choice(region - 1, valid - 1, replace=False)] = True
    m[region - 1] = True
    return m


# Columns 255 and 256 (either side of the first split boundary at 256
# columns a split) and 511 copy column 100's descriptor; A rows 0-15 copy
# it, so the first minimum is column 100, and once column 100 is masked it
# is 255, the lower side of the boundary. Split 3 (columns 768-1023) is
# masked whole.
@pytest.mark.parametrize("case", ["packed", "batch", "na_gt_nb", "na_lt_nb",
                                  "split_ties", "one_split", "no_valid_row"])
def test_nearest_neighbors_kernel_cases(dev, case):
    """The redesigned 1-NN kernel (active limits, column splits merged by
    the last block of a row tile, 4 x 4 register tiles) against the plain
    version on the CPU with the card's |a|^2 and |b|^2, index and d2 bit
    for bit, and against the top-2 kernel's first slot: masks packed at
    the front as the voxel grid leaves them (~30 % valid, path B's
    occupancy); a batch of 2 with different limits per entry and Na = 6000
    (a ragged row tile); Na above and below Nb; equal minima on both sides
    of a split boundary with a split masked whole; Nb within one split (no
    merge); no valid A row (limit 0). One launch per call, two launches
    the same bits, and every ticket back at 0."""
    rng = np.random.default_rng(23)
    bsz, na, nb = {"packed": (1, 8192, 8192), "batch": (2, 6000, 6000),
                   "na_gt_nb": (1, 3000, 1000), "na_lt_nb": (1, 1000, 3000),
                   "split_ties": (1, 512, 2048), "one_split": (1, 777, 200),
                   "no_valid_row": (1, 2048, 2048)}[case]
    da = rng.uniform(0, 12, (bsz, na, 33)).astype(np.float32)
    db = rng.uniform(0, 12, (bsz, nb, 33)).astype(np.float32)
    ma = rng.uniform(size=(bsz, na)) > 0.1
    mb = rng.uniform(size=(bsz, nb)) > 0.1
    if case == "packed":
        ma[0], mb[0] = _packed(rng, na, 2600, 2429), _packed(rng, nb, 2330,
                                                            2172)
    elif case == "batch":
        ma[0], mb[0] = _packed(rng, na, 3001, 2500), _packed(rng, nb, 1500,
                                                            1400)
        ma[1], mb[1] = _packed(rng, na, 700, 650), _packed(rng, nb, 5999,
                                                          5000)
    elif case == "split_ties":
        for j in (255, 256, 511):
            db[0, j] = db[0, 100]
        da[0, :16] = db[0, 100]
        ma[0, :16] = True
        mb[0, [100, 255, 256, 511]] = True
        mb[0, 768:1024] = False
    elif case == "no_valid_row":
        ma[:] = False
    a, b = (torch.from_numpy(x).to(dev) for x in (da, db))
    ma_t, mb_t = (torch.from_numpy(x).to(dev) for x in (ma, mb))
    sq_a, sq_b = ((x * x).sum(-1).cpu() for x in (a, b))

    def plain(col_mask):
        ri, rd = tf.nearest_neighbors_plain(a.cpu(), b.cpu(),
                                            ma_t.float().cpu(),
                                            col_mask.float().cpu(), sq_a,
                                            sq_b)
        empty = ~ma_t.cpu() | (rd >= tf.FLT_MAX)
        return torch.where(empty, 0, ri), torch.where(empty, tf.FLT_MAX, rd)

    before = tf.LAUNCHES["nearest_neighbors"]
    idx, d2 = tf.nearest_neighbors(a, b, ma_t, mb_t)
    assert tf.LAUNCHES["nearest_neighbors"] == before + 1
    again = tf.nearest_neighbors(a, b, ma_t, mb_t)
    assert torch.equal(idx, again[0]) and torch.equal(d2, again[1])
    ridx, rd2 = plain(mb_t)
    assert torch.equal(idx.cpu(), ridx) and torch.equal(d2.cpu(), rd2)
    i1, d1, _, _ = tf.nearest_neighbors2(a, b, ma_t, mb_t)
    assert torch.equal(idx, i1) and torch.equal(d2, d1)
    if case == "split_ties":
        assert (idx[0, :16] == 100).all() and (d2[0, :16] == 0).all()
        cut = mb_t.clone()
        cut[0, 100] = False
        idx_cut, _ = tf.nearest_neighbors(a, b, ma_t, cut)
        assert (idx_cut[0, :16] == 255).all()
        assert torch.equal(idx_cut.cpu(), plain(cut)[0])
    if case == "no_valid_row":
        assert (idx == 0).all() and (d2 == tf.FLT_MAX).all()
    for ticket, _ in launch._SCRATCH.values():
        assert int(ticket.abs().sum()) == 0


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
                        "image_lookup": 0, "table_lookup": 0,
                        "exact_clique": 0, "kabsch": 0, "label_sweep": 0,
                        "overlap_hits": 1, "range_image": 0,
                        "edge_masks": 0, "component_stats": 0,
                        "czm_points": 0, "seed_heights": 0, "plane_fit": 0,
                        "kcore_search": 1, "grow_cliques": 1,
                        "swap_cliques": 1, "distinct_cliques": 2,
                        "radius_knn": 0, "neighbor_normals": 0,
                        "icp_correspond": 0, "icp_update": 0,
                        "match_candidates": 1, "tuple_compact": 1}
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
    for ticket, _ in launch._SCRATCH.values():
        assert int(ticket.abs().sum()) == 0


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


@pytest.mark.parametrize("n", [1000, 1001, 1024])
@pytest.mark.parametrize("bsz", [1, 3, 8])
def test_consistency_graph_pair_axis(dev, bsz, n):
    """B1 over a pair axis (B, N, 3) -> (B, N, N) in one launch, bit for
    bit its plain version on CPU copies; at N = 1001 a pair's first row
    starts inside a 16-byte piece (1001 * 1001 % 16 = 1), at N = 1000 on
    a piece boundary but not its rows."""
    rng = np.random.default_rng(bsz * 7919 + n)
    src = rng.uniform(-30, 30, (bsz, n, 3)).astype(np.float32)
    tgt = (src + rng.normal(0, 0.5, src.shape)).astype(np.float32)
    src, tgt = torch.from_numpy(src), torch.from_numpy(tgt)
    before = tf.LAUNCHES["consistency_graph"]
    got = kernels.consistency_graph(src.to(dev), tgt.to(dev), 0.6)
    assert tf.LAUNCHES["consistency_graph"] == before + 1
    assert got.shape == (bsz, n, n)
    assert torch.equal(got.cpu(), kernels.consistency_graph_plain(src, tgt,
                                                                  0.6))


def test_batched_pipeline_launches_do_not_depend_on_batch(dev):
    """register_scan_pair under the shipping configuration with ground
    alignment and ICP at VLP-16 scale launches each kernel as often for
    B = 4 pairs as for B = 1: the pair axis adds no launch. The overlap
    kernel and the labelling kernel launch once a call, whatever the
    rounds each image's labelling runs, and the labelling runs no device
    loop on the card."""
    from quatro_tpu_torch.config import (FPFHConfig, GroundAlignmentConfig,
                                         IcpConfig)
    from quatro_tpu_torch.pipeline import register_scan_pair
    from quatro_tpu_torch.utils import loops

    lidar = LidarConfig.preset("VLP-16")
    cfg = PipelineConfig.for_lidar(
        "VLP-16", max_voxels=V, max_raw_points=32768,
        fpfh=replace(FPFHConfig.for_lidar(lidar), max_correspondences=512),
        solver=SolverConfig(num_hypotheses=4, num_vote_hypotheses=2),
        ground_alignment=GroundAlignmentConfig(enabled=True),
        icp=IcpConfig(enabled=True))
    scans = [make_scan_pair(lidar=lidar, seed=s, yaw_deg=20.0 + 5 * s,
                            translation=(2.0, 1.0, 0.05))[:2]
             for s in (101, 102, 103, 104)]

    def launches(bsz):
        src, tgt = (PointBatch(
            torch.stack([PointBatch.from_numpy(p[k], 32768).points
                         for p in scans[:bsz]]),
            torch.stack([PointBatch.from_numpy(p[k], 32768).mask
                         for p in scans[:bsz]])) for k in (0, 1))
        register_scan_pair(src, tgt, cfg, device=dev)
        torch.cuda.synchronize()
        launch.reset_launches()
        loops.reset_loops()
        res = register_scan_pair(src, tgt, cfg, device=dev)
        torch.cuda.synchronize()
        assert res.solution.rotation.shape == (bsz, 3, 3)
        assert "label_components" not in loops.LOOPS
        return dict(launch.LAUNCHES)

    one = launches(1)
    assert launches(4) == one
    assert one == {"moment_sums": 1, "spfh": 1, "fpfh": 1,
                   "nearest_neighbors": 0, "nearest_neighbors2": 2,
                   "consistency_graph": 1, "segment_sums": 1,
                   "cross_histogram": 1, "fit_iteration_moments": 3,
                   "classify_points": 1, "image_lookup": 1,
                   "table_lookup": 0, "exact_clique": 0, "kabsch": 0,
                   "label_sweep": 1, "overlap_hits": 1, "range_image": 1,
                   "edge_masks": 1, "component_stats": 1, "czm_points": 1,
                   "seed_heights": 1, "plane_fit": 3, "kcore_search": 1,
                   "grow_cliques": 1, "swap_cliques": 1,
                   "distinct_cliques": 2, "radius_knn": 1,
                   "neighbor_normals": 1, "icp_correspond": 13,
                   "icp_update": 12, "match_candidates": 1,
                   "tuple_compact": 1}


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
    of two (three plane fits), the labelling kernel once (no device loop),
    the overlap kernel once."""
    from quatro_tpu_torch.pipeline import register_scan_pair
    from quatro_tpu_torch.utils import loops
    cfg = replace(CFG, max_raw_points=32768,
                  solver=SolverConfig(num_hypotheses=4,
                                      num_vote_hypotheses=2))
    pair = make_scan_pair(seed=101, yaw_deg=38.0,
                          translation=(2.5, -1.2, 0.04),
                          lidar=LidarConfig.preset("VLP-16"))
    src, tgt = (PointBatch.from_numpy(xyz, 32768) for xyz in pair[:2])
    register_scan_pair(src, tgt, cfg, device=dev)
    tf.reset_launches()
    loops.reset_loops()
    res = register_scan_pair(src, tgt, cfg, device=dev)
    torch.cuda.synchronize()
    assert "label_components" not in loops.LOOPS
    assert dict(tf.LAUNCHES) == {
        "moment_sums": 1, "spfh": 1, "fpfh": 1, "nearest_neighbors": 0,
        "nearest_neighbors2": 2,
        "consistency_graph": 1, "segment_sums": 1, "cross_histogram": 1,
        "fit_iteration_moments": 3, "classify_points": 1, "image_lookup": 1,
        "table_lookup": 0, "exact_clique": 0, "kabsch": 0,
        "label_sweep": 1, "overlap_hits": 1, "range_image": 1,
        "edge_masks": 1, "component_stats": 1, "czm_points": 1,
        "seed_heights": 1, "plane_fit": 3, "kcore_search": 1,
        "grow_cliques": 1, "swap_cliques": 1, "distinct_cliques": 2,
        "radius_knn": 0, "neighbor_normals": 0, "icp_correspond": 0,
        "icp_update": 0, "match_candidates": 1, "tuple_compact": 1}
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


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("n", [131072, 131071, 5])
def test_table_lookup_kernel_shapes(dev, n, k):
    """B12 at every N and K the kernel's alignment cases reach: N a
    multiple of 4 (16-byte loads and stores), N = 131071 (output rows
    start at every 4-byte offset, a ragged last thread), N = 5 (one full
    thread and a ragged one); K 1, 5 (Patchwork's) and 8; ids out of range
    on both sides, and ids in a view 4 bytes past a 16-byte boundary.
    Bit-equal to the plain version, one launch per call."""
    rng = np.random.default_rng(n + k)
    p_pad = 512
    flat = torch.from_numpy(rng.integers(-4, p_pad + 4, 2 * n + 1).astype(
        np.int32)).to(dev)
    tab = torch.from_numpy(rng.normal(0, 1, (2, p_pad, k)).astype(
        np.float32)).to(dev)
    for ids in (flat[:2 * n].reshape(2, n), flat[1:].reshape(2, n)):
        before = tf.LAUNCHES["table_lookup"]
        got = segment.table_lookup(ids, tab)
        assert tf.LAUNCHES["table_lookup"] == before + 1
        assert torch.equal(got.cpu(), segment.table_lookup_plain(ids.cpu(),
                                                                 tab.cpu()))
        oor = ((ids < 0) | (ids >= p_pad)).cpu()
        assert bool(oor.any()) or n == 5
        assert bool((got.cpu().transpose(1, 2)[oor] == 0).all())


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
    from quatro_tpu_torch.utils import loops
    p0, edges = _pose_graph(dev)
    loops.reset_loops()
    before = tf.LAUNCHES["segment_sums"]
    a = optimize_pose_graph(p0, edges, 12, gn_iters=10, cg_iters=40)
    assert tf.LAUNCHES["segment_sums"] == before + 10 * 41
    b = optimize_pose_graph(p0, edges, 12, gn_iters=10, cg_iters=40)
    assert tf.LAUNCHES["segment_sums"] == before + 2 * 10 * 41
    # the graph route: one Gauss-Newton trip a CUDA graph, the second
    # solve all replays
    assert loops.LOOPS["pose_graph"]["replays"] >= 19
    assert a.device.type == "cuda" and torch.equal(a, b)
    assert bool(torch.isfinite(a).all())
    assert torch.equal(a[4], p0[4])
    cpu = optimize_pose_graph(p0.cpu(), type(edges)(*(x.cpu() for x in edges)),
                              12, gn_iters=10, cg_iters=40)
    torch.testing.assert_close(a.cpu(), cpu, rtol=0, atol=1e-3)


def _loop_cases(dev):
    """Each converted loop on the card, as a function of nothing: the GNC
    (both losses) and the clique selection on three VLP-16-width pairs
    (60 inliers, uniform junk, 12 inliers) and the pose graph of
    ``_pose_graph``."""
    from quatro_tpu_torch.io.synthetic import make_correspondences
    from quatro_tpu_torch.parallel.posegraph import optimize_pose_graph
    from quatro_tpu_torch.solver import clique, rotation
    rng = np.random.default_rng(1)
    cases = []
    for seed, n_in in ((0, 60), (1, 0), (2, 12)):
        if n_in:
            src, tgt, _, _ = make_correspondences(
                seed=seed, n_inliers=n_in, n_outliers=256 - n_in,
                yaw_deg=40.0 + seed, translation=(3.0, -1.5, 0.3))
        else:
            src, tgt = (rng.uniform(-20, 20, (256, 3)).astype(np.float32)
                        for _ in range(2))
        cases.append((src, tgt, np.arange(256) < 251))
    src, tgt, mask = (torch.from_numpy(np.stack(a)).to(dev)
                      for a in zip(*cases))
    adj = tim_consistency_graph(src, tgt, mask, 0.3, 1.0)
    p0, edges = _pose_graph(dev)

    from pathlib import Path
    z = np.load(Path(__file__).resolve().parent / "torch_teaser_path_b.npz")
    solver = PipelineConfig(max_voxels=8192).solver

    def solve(**kw):
        """The JAX package's path B correspondences (the synthetic pairs'
        cliques are noise-free, so TEASER's GNC stops at iteration 0)."""
        sol = register_correspondences(
            z["src_xyz"], z["tgt_xyz"], z["mask"],
            dataclasses.replace(solver, **kw), device=dev)
        return [getattr(sol, f.name) for f in dataclasses.fields(sol)]

    return {
        "gnc_tls": lambda: rotation.gnc_rotation_2d(
            src[..., :2], tgt[..., :2], mask, 0.3),
        "fgr_gm": lambda: rotation.gnc_rotation_2d(
            src[..., :2], tgt[..., :2], mask, 0.3, algorithm="FGR"),
        "gnc_tls_3d": lambda: rotation.gnc_rotation_3d(src, tgt, mask, 0.3),
        "fgr_gm_3d": lambda: rotation.gnc_rotation_3d(src, tgt, mask, 0.3,
                                                      algorithm="FGR"),
        "teaser": lambda: solve(reg_name="TEASER"),
        "teaser_fgr": lambda: solve(reg_name="TEASER",
                                    rotation_estimation_algorithm="FGR"),
        "cliques": lambda: clique.select_inliers_with_candidates(
            adj, mask, num_seeds=128, swap_rounds=2),
        "top_distinct": lambda: clique.top_distinct_cliques(
            clique.select_inliers_with_candidates(
                adj, mask, num_seeds=128, swap_rounds=2)[2], 4,
            force_first=True),
        "pose_graph": lambda: optimize_pose_graph(p0, edges, 12,
                                                  gn_iters=10, cg_iters=40),
    }


CLIQUE_LOOPS = ("max_kcore", "grow_cliques", "swap_cliques", "top_distinct")


def _clique_routes(fn):
    """fn (the clique selection, or the distinct greedy after it) on the
    kernel route: no device loop of the clique stage runs, each kernel's
    wrapper launches once; its bits equal the plain route's on the
    CUDA-graph route (twice: capture, then replays) and eager."""
    from quatro_tpu_torch.utils import loops
    loops.reset_loops()
    launch.reset_launches()
    got = _flat(fn())
    torch.cuda.synchronize()
    assert not set(CLIQUE_LOOPS) & set(loops.LOOPS), dict(loops.LOOPS)
    want = {"kcore_search": 1, "grow_cliques": 1, "swap_cliques": 1}
    assert all(launch.LAUNCHES[k] == v for k, v in want.items()), \
        dict(launch.LAUNCHES)
    assert launch.LAUNCHES["distinct_cliques"] == (len(got) == 2)
    loops.reset_loops()
    for route in ("graph", "graph_again", "eager"):
        mode = (loops.eager_loops() if route == "eager"
                else contextlib.nullcontext())
        with plain_clique_route(), mode:
            ref = _flat(fn())
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), route
    counts = [loops.LOOPS[k] for k in CLIQUE_LOOPS if k in loops.LOOPS]
    assert sum(c["captures"] for c in counts) >= 1
    assert sum(c["replays"] for c in counts) >= 1


def _flat(out):
    return [out] if torch.is_tensor(out) else [t for o in out
                                               for t in _flat(o)]


# the GNC loop that each SO(3) case must capture and replay
SO3_LOOP = {"gnc_tls_3d": "gnc_tls", "fgr_gm_3d": "fgr_gm",
            "teaser": "gnc_tls", "teaser_fgr": "fgr_gm"}


@pytest.mark.parametrize("case", ["gnc_tls", "fgr_gm", "gnc_tls_3d",
                                  "fgr_gm_3d", "teaser", "teaser_fgr",
                                  "cliques", "top_distinct", "pose_graph"])
def test_device_loops_graph_equals_eager_on_the_card(dev, case):
    """A loop's CUDA-graph route (first call: its first chunk uncaptured,
    then the capture; second call: replays only) gives the bits of
    ``eager_loops()``, and the same kernel launches in ``LAUNCHES``. The
    SO(3) GNC (TEASER, the 3-D FGR) captures and replays like the yaw
    loop. The clique stage's loops run on the card only on its plain
    route since its kernels (csrc/cliques.cu): there the kernel route is
    held against the plain route, graph and eager (``_clique_routes``)."""
    from quatro_tpu_torch.utils import loops
    fn = _loop_cases(dev)[case]
    loops.clear_graphs()
    if case in ("cliques", "top_distinct"):
        _clique_routes(fn)
        return
    launch.reset_launches()
    with loops.eager_loops():
        ref = _flat(fn())
    eager_launches = dict(launch.LAUNCHES)
    loops.reset_loops()
    for call in ("capture", "replay"):
        launch.reset_launches()
        got = _flat(fn())
        assert launch.LAUNCHES == eager_launches, call
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), call
    counts = loops.LOOPS.values()
    print(case, dict(loops.LOOPS))
    assert sum(c["captures"] for c in counts) >= 1
    assert sum(c["replays"] for c in counts) >= 1
    if case in SO3_LOOP:
        c = loops.LOOPS[SO3_LOOP[case]]
        assert c["captures"] >= 1 and c["replays"] >= 1
        assert c["graph_bytes"] >= 0
        assert eager_launches["kabsch"] >= 1
        held = loops.held()
        assert 1 <= held["graphs"] <= loops.MAX_GRAPHS and held["bytes"] >= 0


def _stage_loop_cases(dev):
    """The stages that became device loops, on the card at VLP-16 width:
    Patchwork's bf16 fits, the labelling and the whole projection of the
    level_a pair's raw scans as one batch of two, ICP on their raw-scan
    voxels (both orders, as a batch of two pairs) and the overlaps of
    K = 3 poses on that batch."""
    from quatro_tpu_torch.pipeline import raw_scan_normals, raw_scan_voxels
    from quatro_tpu_torch.preprocessing.patchwork import estimate_ground
    from quatro_tpu_torch.preprocessing.projection import segment_cloud
    from quatro_tpu_torch.solver.icp import refine_icp
    from quatro_tpu_torch.solver.verify import alignment_overlap
    from quatro_tpu_torch.utils.se3 import rotation_from_rpy
    src, tgt, gt = make_scan_pair(seed=101, yaw_deg=38.0,
                                  translation=(2.5, -1.2, 0.04),
                                  lidar=LidarConfig.preset("VLP-16"))
    pts = torch.zeros(2, 32768, 3)
    masks = torch.zeros(2, 32768, dtype=torch.bool)
    for b, xyz in enumerate((src, tgt)):
        pts[b, :len(xyz)], masks[b, :len(xyz)] = torch.from_numpy(xyz), True
    pts, masks = pts.to(dev), masks.to(dev)
    cfg = PipelineConfig.for_lidar("VLP-16", max_voxels=V)
    ground = estimate_ground(pts, masks, cfg.patchwork).ground
    vox, vmask = raw_scan_voxels(pts, masks, cfg)
    nrm = raw_scan_normals(vox, vmask, cfg)
    flip = [1, 0]
    rot = torch.from_numpy(gt[:3, :3].astype(np.float32)).to(dev)
    rot = torch.stack([rot, rot.T])
    trans = torch.from_numpy(gt[:3, 3].astype(np.float32)).to(dev)
    trans = torch.stack([trans, -(rot[1] @ trans)]) + 0.1
    poses = torch.stack([rotation_from_rpy(0.0, 0.0, a) for a in
                         (0.0, 0.02, -0.05)]).to(dev)
    return {
        "patchwork_fit": lambda: estimate_ground(pts, masks, cfg.patchwork),
        "label_components": lambda: segment_cloud(
            pts, masks & ~ground, cfg.lidar, cfg.projection,
            max_points=cfg.max_nonground_points),
        "icp": lambda: refine_icp(
            vox, vmask, vox[flip], vmask[flip], nrm.normals[flip],
            nrm.valid[flip], rot, trans, replace(cfg.icp, enabled=True)),
        "overlap": lambda: alignment_overlap(
            vox[:, None], vmask[:, None], vox[flip][:, None],
            vmask[flip][:, None], poses @ rot[:, None], trans[:, None]
            .expand(2, 3, 3), 2.0 * cfg.voxel_size),
    }


@pytest.mark.parametrize("case", ["patchwork_fit", "label_components",
                                  "icp", "overlap"])
def test_stage_loops_graph_equals_eager_on_the_card(dev, case):
    """Each stage's device loop on the CUDA-graph route (first call: its
    first chunk uncaptured, then the capture; second call: replays only)
    gives the bits of ``eager_loops()`` and of ``eager_loops(chunk=1)``,
    with the same kernel launches (Patchwork's B8-B10, the projection's
    B11 and labelling kernel; B9 counted at each replay), and the loop
    reads no flag. The labelling and the overlaps are one kernel launch
    each on the card (no loop): the same bits on every call."""
    from quatro_tpu_torch.utils import loops
    fn = _stage_loop_cases(dev)[case]
    loops.clear_graphs()
    refs = []
    for chunk in (1, None):
        loops.reset_loops()
        launch.reset_launches()
        with loops.eager_loops(chunk=chunk):
            refs.append(_flat(fn()))
    eager_launches = dict(launch.LAUNCHES)
    for got in refs[:1]:
        assert all(torch.equal(g, r) for g, r in zip(got, refs[1]))
    for call in ("capture", "replay"):
        loops.reset_loops()
        launch.reset_launches()
        got = _flat(fn())
        assert launch.LAUNCHES == eager_launches, call
        assert len(got) == len(refs[1])
        for g, r in zip(got, refs[1]):
            assert torch.equal(g, r), call
        if case in ("overlap", "label_components"):
            # one kernel launch on the card: no device loop there
            assert case not in loops.LOOPS
            assert launch.LAUNCHES["overlap_hits" if case == "overlap"
                                   else "label_sweep"] == 1
            continue
        c = loops.LOOPS[case]
        print(case, call, c)
        assert c["captures" if call == "capture" else "replays"] >= 1
        assert c["reads"] == 0


def test_voxel_grid_batched_on_the_card(dev):
    """The voxel grid of the level_a pair's two raw clouds (and of those
    clouds four times over, with ``active_cap``) in one call equals each
    cloud's own call on the card, bit for bit."""
    src, tgt, _ = make_scan_pair(seed=101, yaw_deg=38.0,
                                 translation=(2.5, -1.2, 0.04),
                                 lidar=LidarConfig.preset("VLP-16"))
    pts = torch.zeros(8, 32768, 3)
    masks = torch.zeros(8, 32768, dtype=torch.bool)
    rng = np.random.default_rng(8)
    for b in range(8):
        xyz = (src, tgt)[b % 2]
        pts[b, :len(xyz)] = torch.from_numpy(xyz)
        masks[b, :len(xyz)] = torch.from_numpy(
            rng.random(len(xyz)) < (1.0 if b < 2 else 0.5))
    masks[3] = False
    pts, masks = pts.to(dev), masks.to(dev)
    for cap in (None, CFG.max_segment_points):
        vox, vmask = voxel_downsample(pts, masks, CFG.voxel_size, V,
                                      active_cap=cap)
        for b in range(8):
            one = voxel_downsample(pts[b], masks[b], CFG.voxel_size, V,
                                   active_cap=cap)
            assert torch.equal(vox[b], one[0]) and torch.equal(vmask[b],
                                                               one[1])
        assert int(vmask[3].sum()) == 0 and int(vmask[0].sum()) > 0


def test_device_loops_copy_out_on_the_card(dev):
    """Two replays of one graph with other inputs: the first result's
    tensors are left as they were (they are copies of the static
    buffers, not the buffers)."""
    from quatro_tpu_torch.solver import rotation
    from quatro_tpu_torch.utils import loops
    g = torch.Generator().manual_seed(3)
    src = 10 * torch.randn(6, 256, 2, generator=g)
    rot = torch.tensor([[0.6, -0.8], [0.8, 0.6]])
    dst = src @ rot.T + 0.01 * torch.randn(6, 256, 2, generator=g)
    dst[:, 64:] = 10 * torch.randn(6, 192, 2, generator=g)   # outliers
    src, dst = src.to(dev), dst.to(dev)
    mask = torch.ones(6, 256, dtype=torch.bool, device=dev)
    loops.clear_graphs()
    loops.reset_loops()
    rotation.gnc_rotation_2d(src, dst, mask, 0.1)        # captures
    first = rotation.gnc_rotation_2d(src, dst, mask, 0.1)
    kept = [t.clone() for t in first]
    second = rotation.gnc_rotation_2d(dst, src, mask, 0.1)
    assert loops.LOOPS["gnc_tls"]["replays"] >= 2
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert not torch.equal(first.rotation, second.rotation)
    with loops.eager_loops():
        ref = rotation.gnc_rotation_2d(src, dst, mask, 0.1)
    for a, b in zip(first, ref):
        assert torch.equal(a, b)


def _exact_restrictions(cap, max_steps):
    """The restricted graphs, validity and incumbents that
    ``exact_max_clique_bb`` hands ``ops.kernels.exact_clique`` for the
    three pairs of ``_loop_cases`` (60 inliers, junk, 12 inliers) on the
    CPU, with the greedy incumbent: [(sub, vvalid, best0)] (B = 3)."""
    from quatro_tpu_torch.io.synthetic import make_correspondences
    from quatro_tpu_torch.solver import clique
    rng = np.random.default_rng(1)
    cases = []
    for seed, n_in in ((0, 60), (1, 0), (2, 12)):
        if n_in:
            src, tgt, _, _ = make_correspondences(
                seed=seed, n_inliers=n_in, n_outliers=256 - n_in,
                yaw_deg=40.0 + seed, translation=(3.0, -1.5, 0.3))
        else:
            src, tgt = (rng.uniform(-20, 20, (256, 3)).astype(np.float32)
                        for _ in range(2))
        cases.append((src, tgt, np.arange(256) < 251))
    src, tgt, mask = (torch.from_numpy(np.stack(a)) for a in zip(*cases))
    adj = tim_consistency_graph(src, tgt, mask, 0.3, 1.0)
    inc = clique.greedy_cliques(adj, clique.clique_seed_scores(adj, mask),
                                mask) & mask
    seen = []
    real = kernels.exact_clique

    def rec(*args):
        seen.append(args[:3])
        return real(*args)

    kernels.exact_clique = rec
    try:
        clique.exact_max_clique_bb(adj, mask, incumbent=inc, cap=cap,
                                   max_steps=max_steps)
    finally:
        kernels.exact_clique = real
    return seen[0], (adj, mask, inc)


@pytest.mark.parametrize("bsz,cap,max_steps", [
    (1, 64, 20000), (3, 64, 20000), (3, 64, 40), (3, 150, 20000),
    (3, 256, 2000)], ids=["b1", "b3", "truncated", "cap150", "cap256"])
def test_exact_clique_kernel(dev, bsz, cap, max_steps):
    """The exact search's kernel against its plain version on CPU copies,
    bit for bit (best set, completed, steps), in one launch for the
    pairs; 64-bit words 1, 3 and 4 a bitset. Then exact_max_clique_bb on
    the card against the CPU: every output equal, one launch."""
    from quatro_tpu_torch.solver import clique
    (sub, vvalid, best0), (adj, mask, inc) = _exact_restrictions(
        cap, max_steps)
    sub, vvalid, best0 = sub[:bsz], vvalid[:bsz], best0[:bsz]
    ref = kernels.exact_clique_search_plain(sub, vvalid, best0, max_steps)
    launch.reset_launches()
    got = kernels.exact_clique(*(t.to(dev).contiguous()
                                 for t in (sub, vvalid, best0)), max_steps)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["exact_clique"] == 1
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    print(f"B {bsz} cap {cap}: steps {ref[2].tolist()}, completed "
          f"{ref[1].tolist()}")
    cpu = clique.exact_max_clique_bb(adj[:bsz], mask[:bsz],
                                     incumbent=inc[:bsz], cap=cap,
                                     max_steps=max_steps)
    launch.reset_launches()
    card = clique.exact_max_clique_bb(adj[:bsz].to(dev), mask[:bsz].to(dev),
                                      incumbent=inc[:bsz].to(dev), cap=cap,
                                      max_steps=max_steps)
    assert launch.LAUNCHES["exact_clique"] == 1
    for g, r in zip(card, cpu):
        assert torch.equal(g.cpu(), r)


def _kabsch_inputs(rows, n, seed):
    """src, dst (rows, n, 3) and w (rows, n): random rows, then a zero-
    weight row, a planar and a reflected set, and rows whose H is a hard
    3 x 3 matrix (src the unit vectors, w 1, so H = dst exactly): rank 1,
    near rank 2, singular values 572, 0.7 and 0.2, diagonal, -I."""
    rng = np.random.default_rng(seed)
    src = rng.normal(0, 10, (rows, n, 3)).astype(np.float32)
    dst = rng.normal(0, 10, (rows, n, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (rows, n)).astype(np.float32)
    hard = [np.outer(rng.normal(size=3), rng.normal(size=3)) * 50,
            np.array([[1.0, 2.0, 1.0 + 1e-4], [0.5, -1.0, 0.25],
                      [3.0, 0.0, 1.5]]) * 100,
            np.diag([572.0, 0.7, 0.2]) @ np.linalg.qr(
                rng.normal(size=(3, 3)))[0],
            np.diag(rng.normal(size=3)), -np.eye(3)]
    if rows >= 3 + len(hard) and n >= 3:
        w[0] = 0.0
        src[1, :, 2] = dst[1, :, 2] = 0.0
        dst[2] = src[2] * np.float32([1.0, 1.0, -1.0])
        for k, h in enumerate(hard):
            src[3 + k], dst[3 + k], w[3 + k] = 0.0, 0.0, 0.0
            src[3 + k, :3], dst[3 + k, :3], w[3 + k, :3] = np.eye(3), h, 1.0
    return (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(w))


@pytest.mark.parametrize("rows,n", [(1, 3), (5, 1), (8, 256), (48, 512),
                                    (8, 2000), (384, 600)])
def test_kabsch_kernel(dev, rows, n):
    """The Kabsch kernel against its plain version on CPU copies and on
    the card, bit for bit, one launch for the rows; the rows of a batch
    equal to their own calls."""
    from quatro_tpu_torch.ops import kabsch
    src, dst, w = _kabsch_inputs(rows, n, rows + n)
    ref = kabsch.kabsch_rotation_plain(src, dst, w)
    src, dst, w = src.to(dev), dst.to(dev), w.to(dev)
    launch.reset_launches()
    got = kabsch.kabsch_rotation(src, dst, w)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["kabsch"] == 1
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(got, kabsch.kabsch_rotation_plain(src, dst, w))
    for b in (0, rows - 1):
        assert torch.equal(got[b], kabsch.kabsch_rotation(src[b], dst[b],
                                                          w[b]))


def _sweep_images(bsz, rows, cols, seed, edge_share=0.93):
    """bsz images of labels (some past npix) and edges: random edges with
    long runs, a full ring row, a ring row broken at one column, a full
    column and a gap of rows (tests/test_torch_label_overlap.py)."""
    rng = np.random.default_rng(seed)
    npix = rows * cols
    labels = rng.integers(0, npix + 64, (bsz, rows, cols)).astype(np.int32)
    edges = rng.random((bsz, rows, cols)) < edge_share
    edges[:, rows // 2] = True
    edges[1::2, rows // 3] = True
    edges[1::2, rows // 3, cols // 5] = False
    edges[::2, :, cols // 7] = True
    edges[1::2, 1:3] = False
    return torch.from_numpy(labels), torch.from_numpy(edges), npix


def _labelling_bit_equal(dev, labels, edges, npix, sched, max_iters,
                         valid_share=0.85):
    """The labelling kernel on ``sched`` (one mask a sweep: the edges
    rolled a column a sweep), some pixels invalid, against its plain route
    on CPU copies and on the card (uncaptured): labels and each image's
    rounds bit for bit, one launch. Returns the rounds."""
    from quatro_tpu_torch.ops.labels import label_sweeps, label_sweeps_plain
    from quatro_tpu_torch.utils import loops
    rng = np.random.default_rng(labels.shape[1] + len(sched))
    valid = torch.from_numpy(rng.random(tuple(labels.shape)) < valid_share)
    masks = [torch.roll(edges, k, dims=-1).contiguous()
             for k in range(len(sched))]
    args = (labels, valid, masks, sched, max_iters, npix)
    ref = label_sweeps_plain(*args)
    on_dev = (labels.to(dev), valid.to(dev), [m.to(dev) for m in masks],
              sched, max_iters, npix)
    launch.reset_launches()
    loops.reset_loops()
    got = label_sweeps(*on_dev)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["label_sweep"] == 1
    assert "label_components" not in loops.LOOPS
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(),
                                                              ref[1])
    with loops.eager_loops():
        plain = label_sweeps_plain(*on_dev)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert int(got[1].max()) <= max_iters
    return got[1].tolist()


@pytest.mark.parametrize("mode", ["4CrossNeighbor", "4Neighbor",
                                  "8Neighbor"])
@pytest.mark.parametrize("shape", [(16, 1800), (32, 1800), (64, 1800),
                                   (16, 1024), (64, 1024)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_label_sweep_kernel(dev, shape, mode):
    """The labelling kernel on the mode's sweeps at every lidar preset's
    shape (row scans for dr = 0, DSMEM walks otherwise), to the images'
    own exits and capped at 2 rounds, bit for bit its plain route:
    wrapped full rows, broken chains, labels past npix."""
    from quatro_tpu_torch.config import ProjectionConfig
    from quatro_tpu_torch.preprocessing.projection import sweep_schedule
    rows, cols = shape
    cfg = dataclasses.replace(ProjectionConfig(), neighbor_mode=mode)
    labels, edges, npix = _sweep_images(3, rows, cols, rows + cols)
    sched = sweep_schedule(rows, cols, cfg)
    rounds = _labelling_bit_equal(dev, labels, edges, npix, sched, 48)
    capped = _labelling_bit_equal(dev, labels, edges, npix, sched, 2)
    assert capped == [min(r, 2) for r in rounds]


def test_label_sweep_kernel_path_p_batch(dev):
    """The 4CrossNeighbor labelling on path P's B = 64 batch shape: 128
    images of 64 x 1800 in one launch, bit for bit."""
    from quatro_tpu_torch.config import ProjectionConfig
    from quatro_tpu_torch.preprocessing.projection import sweep_schedule
    labels, edges, npix = _sweep_images(128, 64, 1800, 64)
    _labelling_bit_equal(dev, labels, edges, npix,
                         sweep_schedule(64, 1800, ProjectionConfig()), 48)


@pytest.mark.parametrize("share", [0.93, 1.0])
@pytest.mark.parametrize("steps", [1, 2, 3, 6, 12])
@pytest.mark.parametrize("offset", [(0, 1), (0, -2), (1, 1), (-2, 0),
                                    (1, 0), (-1, -1)])
def test_label_sweep_kernel_steps(dev, offset, steps, share):
    """A one-sweep labelling at each doubling depth on 16 x 64 images,
    reach shorter and longer than the chains and than the cycle (share
    1.0: every edge holds, across the row boundary too), for 1 and 3
    rounds, bit for bit the plain route."""
    labels, edges, npix = _sweep_images(2, 16, 64, steps, share)
    if share == 1.0:
        edges[:] = True
    for max_iters in (1, 3):
        _labelling_bit_equal(dev, labels, edges, npix, [(*offset, steps)],
                             max_iters)


@pytest.mark.parametrize("offset", [(0, 16), (0, 32), (0, -8), (0, 64)])
def test_label_sweep_kernel_row_cycles(dev, offset):
    """dr = 0 sweeps whose reach covers rows of many cycles (period 4, 2,
    8 and 1 on 64 x 64 images: a CTA's rows hold more cycles than it has
    warps, so each warp scans several in turn), alone and after a
    diagonal sweep, bit for bit the plain route."""
    labels, edges, npix = _sweep_images(3, 64, 64, 7)
    for sched in ([(*offset, 6)], [(1, 1, 3), (*offset, 6)]):
        for max_iters in (1, 48):
            _labelling_bit_equal(dev, labels, edges, npix, sched, max_iters)


def test_label_sweep_kernel_refuses_oversized(dev):
    """An image that no cluster's shared memory holds raises ValueError
    naming the limit; the largest preset's fits."""
    from quatro_tpu_torch.ops.labels import label_layout, label_sweeps
    labels = torch.zeros(1, 16, 30000, dtype=torch.int32, device=dev)
    valid = torch.ones_like(labels, dtype=torch.bool)
    with pytest.raises(ValueError, match="limit"):
        label_sweeps(labels, valid, [valid], [(0, 1, 3)], 4, 16 * 30000)
    for bsz in (2, 128):
        lay = label_layout(bsz, 64, 1800)
        assert lay["cluster"] in (8, 16) and lay["resident_clusters"] >= 1
        print(bsz, lay)


@pytest.mark.parametrize("mode", ["4CrossNeighbor", "4Neighbor",
                                  "8Neighbor"])
@pytest.mark.parametrize("lidar", ["VLP-16", "Ouster-OS1-64", "HDL-32E"])
def test_label_components_kernel_modes(dev, lidar, mode, monkeypatch):
    """label_components on the range images of a raw pair of each preset,
    as one batch: labels, feasibility, pixel feasibility and each image's
    rounds on the card equal to the CPU's; one labelling launch and no
    device loop on the card."""
    from quatro_tpu_torch.config import ProjectionConfig
    from quatro_tpu_torch.preprocessing import projection
    from quatro_tpu_torch.utils import loops
    lid = LidarConfig.preset(lidar)
    cfg = dataclasses.replace(ProjectionConfig(), neighbor_mode=mode)
    pair = make_scan_pair(seed=101, yaw_deg=38.0,
                          translation=(2.5, -1.2, 0.04), lidar=lid)
    pts = torch.zeros(2, 65536, 3)
    masks = torch.zeros(2, 65536, dtype=torch.bool)
    for b, xyz in enumerate(pair[:2]):
        xyz = xyz[xyz[:, 2] > -1.723 + 0.3][:65536]
        pts[b, :len(xyz)], masks[b, :len(xyz)] = torch.from_numpy(xyz), True
    *_, rimg, owner = projection.project_to_range_image(pts, masks, lid)
    valid = owner >= 0
    rounds = []
    real = projection.label_sweeps

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        rounds.append(out[1].cpu())
        return out

    monkeypatch.setattr(projection, "label_sweeps", spy)
    ref = projection.label_components(rimg, valid, lid, cfg)
    loops.reset_loops()
    launch.reset_launches()
    got = projection.label_components(rimg.to(dev), valid.to(dev), lid, cfg)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert torch.equal(rounds[0], rounds[1]) and int(rounds[1].min()) > 0
    assert launch.LAUNCHES["label_sweep"] == 1
    assert "label_components" not in loops.LOOPS
    assert int(ref[1].sum()) > 0


def _overlap_case(lead, special, seed=3, k=4, ns=300, nt=420, bsz=3):
    """Clouds and poses for a leading shape (tests/test_torch_label_overlap
    .py): "one" pose on one pair, "edges" B poses on B pairs, "hypotheses"
    (B, K) poses on (B, 1, N, 3) clouds; ``special`` a NaN or an inf in a
    valid target point (a NaN also in a masked one and a valid source
    row). Returns (p posed, pm, tgt, tgt_mask) on the CPU."""
    from quatro_tpu_torch.utils.se3 import rotate_points, rotation_from_rpy
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-12, 12, (bsz, nt, 3)).astype(np.float32)
    src = (tgt[:, :ns] + rng.normal(0, 0.25, (bsz, ns, 3))).astype(
        np.float32)
    smask = rng.random((bsz, ns)) > 0.15
    tmask = rng.random((bsz, nt)) > 0.15
    if special != "finite":
        tmask[:, 5] = True
        tgt[:, 5, 1] = np.nan if special == "nan" else np.inf
        tmask[:, 6] = False
        tgt[:, 6] = np.nan
        smask[:, 9] = True
        src[:, 9, 0] = np.nan
    yaws = rng.uniform(-0.08, 0.08, (bsz, k))
    trans = torch.from_numpy(rng.normal(0, 0.2, (bsz, k, 3)).astype(
        np.float32))
    rot = torch.stack([rotation_from_rpy(0.0, 0.0, float(a))
                       for a in yaws.ravel()]).reshape(bsz, k, 3, 3)
    src, smask, tgt, tmask = (torch.from_numpy(a) for a in
                              (src, smask, tgt, tmask))
    if lead == "one":
        src, smask, tgt, tmask = src[0], smask[0], tgt[0], tmask[0]
        rot, trans = rot[0, 0], trans[0, 0]
    elif lead == "edges":
        rot, trans = rot[:, 0], trans[:, 0]
    else:
        src, smask, tgt, tmask = (a[:, None] for a in
                                  (src, smask, tgt, tmask))
    p = rotate_points(src, rot) + trans[..., None, :]
    return p, smask, tgt, tmask


@pytest.mark.parametrize("special", ["finite", "nan", "inf"])
@pytest.mark.parametrize("lead", ["one", "edges", "hypotheses"])
def test_overlap_hits_kernel(dev, lead, special):
    """The overlap kernel on each leading shape alignment_overlap serves,
    with a NaN or an inf in a valid target point: one launch, the hits
    bit for bit its plain version on CPU copies and on the card."""
    from quatro_tpu_torch.ops.overlap import overlap_hits, overlap_hits_plain
    p, pm, tgt, tm = _overlap_case(lead, special)
    r2 = torch.full((), 0.6) ** 2
    ref = overlap_hits_plain(p, pm, tgt, tm, r2)
    args = [t.to(dev) for t in (p, pm, tgt, tm, r2)]
    launch.reset_launches()
    got = overlap_hits(*args)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["overlap_hits"] == 1
    assert got.dtype == torch.int64 and got.shape == ref.shape
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(got, overlap_hits_plain(*args))
    if special == "nan":
        assert int(ref.max()) == 0
    else:
        assert int(ref.min()) > 0


@pytest.mark.parametrize("bsz,k,ns,nt", [(64, 6, 2048, 8192),
                                         (1, 6, 2048, 8192),
                                         (2, 3, 1, 1), (5, 1, 129, 1025)])
def test_overlap_hits_kernel_shapes(dev, bsz, k, ns, nt):
    """The overlap kernel at path P's B = 64 shape (384 poses, 2048
    source rows, 8192 targets: eight rows a thread, eight tiles), path A's
    (6 poses: one row a thread) and ragged ones, bit for bit the plain
    version on the card, one launch."""
    from quatro_tpu_torch.ops.overlap import overlap_hits, overlap_hits_plain
    p, pm, tgt, tm = (t.to(dev) for t in _overlap_case(
        "hypotheses", "finite", seed=bsz + nt, k=k, ns=ns, nt=nt, bsz=bsz))
    r2 = torch.full((), 0.6, device=dev) ** 2
    launch.reset_launches()
    got = overlap_hits(p, pm, tgt, tm, r2)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["overlap_hits"] == 1
    assert torch.equal(got, overlap_hits_plain(p, pm, tgt, tm, r2))


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


# --------------------------------------- the range image's three kernels --

def _same_bits(a, b):
    """Equal values, bit for bit where not NaN, NaN at the same places
    (torch.equal is false on any NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


@functools.lru_cache(maxsize=None)
def _ray_cast(lidar, seed):
    return make_scan_pair(seed=seed, yaw_deg=20.0,
                          translation=(2.5, 1.0, 0.05),
                          lidar=LidarConfig.preset(lidar))


def _raw_pair(lidar, n=131072, seed=11):
    """The raw synthetic pair of a preset (tests/test_pipeline.py's seed-11
    recipe) as (2, n, 3) points and (2, n) masks on the CPU."""
    pair = _ray_cast(lidar, seed)
    pts = torch.zeros(2, n, 3)
    mask = torch.zeros(2, n, dtype=torch.bool)
    for b, xyz in enumerate(pair[:2]):
        xyz = xyz[:n]
        pts[b, :len(xyz)], mask[b, :len(xyz)] = torch.from_numpy(xyz), True
    return pts, mask


def _with_specials(pts, mask):
    """NaN and inf coordinates in valid and masked points, and the mask's
    last point a return at the far end of the range quantisation."""
    pts, mask = pts.clone(), mask.clone()
    pts[0, 3, 1] = float("nan")
    pts[1, 5] = float("nan")
    mask[1, 5] = False
    pts[0, 7, 0] = float("inf")
    pts[1, 9, 2] = -float("inf")
    pts[0, 11] = torch.tensor([float("inf"), float("inf"), 1.0])
    pts[1, -1] = torch.tensor([125.0, 0.4, 0.0])
    mask[1, -1] = True
    return pts, mask


@pytest.mark.parametrize("case", ["plain", "specials", "prefix"])
@pytest.mark.parametrize("lidar", ["Velodyne-64-HDE", "VLP-16",
                                   "Ouster-OS1-64", "HDL-32E"])
def test_range_image_kernel(dev, lidar, case):
    """The keys kernel, the sort and the owner kernel on a raw pair of each
    preset (131072 points a cloud), with NaN and inf points, and with a
    max_points prefix: every output bit for bit the plain version on the
    card and on the CPU (there but a NaN point's row and column), one
    counted launch a call."""
    from quatro_tpu_torch.ops.range_image import range_image, range_image_plain
    lid = LidarConfig.preset(lidar)
    pts, mask = _raw_pair(lidar)
    if case == "specials":
        pts, mask = _with_specials(pts, mask)
    cap = 40000 if case == "prefix" else None
    ref = range_image_plain(pts, mask, lid, 0.1, cap)
    launch.reset_launches()
    got = range_image(pts.to(dev), mask.to(dev), lid, 0.1, cap)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["range_image"] == 1
    plain = range_image_plain(pts.to(dev), mask.to(dev), lid, 0.1, cap)
    # a NaN point's row and column differ between the CPU's torch chain
    # and the card's (x86 makes a negative default NaN, the card a
    # positive one, and fused.atan2 branches on the sign): it is never in
    # the image on either
    nan = torch.isnan(pts).any(-1)
    for name, g, p, r in zip(("row", "col", "rng", "ok", "flat", "img",
                              "owner"), got, plain, ref):
        assert _same_bits(g, p), name
        g = g.cpu()
        if name in ("row", "col"):
            g, r = g[~nan], r[~nan]
        assert _same_bits(g, r), name
    assert not bool(got[3].cpu()[nan].any())
    assert int((got[6] >= 0).sum()) > 0


def test_range_image_kernel_small_shapes(dev):
    """Clouds of 0, 1 and 33 points, an all-masked cloud, max_points 0 and
    5, and a point whose packed word is the sentinel: equal to the plain
    version on the card."""
    from quatro_tpu_torch.ops.range_image import range_image, range_image_plain
    lid = LidarConfig.preset("VLP-16")
    rng = np.random.default_rng(5)
    for n, cap, share in ((0, None, 1.0), (1, None, 1.0), (33, None, 0.7),
                          (33, None, 0.0), (33, 0, 1.0), (33, 5, 1.0)):
        pts = torch.from_numpy(rng.uniform(-30, 30, (2, n, 3)).astype(
            np.float32)).to(dev)
        mask = torch.from_numpy(rng.random((2, n)) < share).to(dev)
        got = range_image(pts, mask, lid, 0.1, cap)
        for g, p in zip(got, range_image_plain(pts, mask, lid, 0.1, cap)):
            assert _same_bits(g, p), (n, cap, share)
    # the last of 131072 points alone in its pixel at the end of the range
    # quantisation: its packed word is the sentinel, the pixel stays empty
    pts = torch.zeros(1, 1 << 17, 3, device=dev)
    mask = torch.zeros(1, 1 << 17, dtype=torch.bool, device=dev)
    pts[0, -1] = torch.tensor([125.0, 0.4, 0.0])
    mask[0, -1] = True
    got = range_image(pts, mask, lid)
    for g, p in zip(got, range_image_plain(pts, mask, lid)):
        assert _same_bits(g, p)
    assert bool(got[3][0, -1]) and int(got[6].max()) == -1


def _images(dev, lidar, n=65536):
    """Range images and valid masks of the preset's raw pair, ground
    stripped as chip_smoke.py's nonground strips it, on the card."""
    from quatro_tpu_torch.preprocessing import projection
    lid = LidarConfig.preset(lidar)
    pts, mask = _raw_pair(lidar, n)
    mask &= pts[..., 2] > -1.723 + 0.3
    *_, rimg, owner = projection.project_to_range_image(pts.to(dev),
                                                        mask.to(dev), lid)
    return rimg, owner >= 0, lid


@pytest.mark.parametrize("mode", ["4CrossNeighbor", "4Neighbor",
                                  "8Neighbor"])
@pytest.mark.parametrize("lidar", ["Velodyne-64-HDE", "VLP-16",
                                   "Ouster-OS1-64", "HDL-32E"])
def test_edge_masks_kernel(dev, lidar, mode):
    """Every edge mask of a labelling call in one launch, on each preset's
    images under each mode, bit for bit the plain version on the card and
    on the CPU."""
    from quatro_tpu_torch.config import ProjectionConfig
    from quatro_tpu_torch.ops.range_image import edge_masks, edge_masks_plain
    from quatro_tpu_torch.preprocessing import projection as pr
    rimg, valid, lid = _images(dev, lidar)
    cfg = dataclasses.replace(ProjectionConfig(), neighbor_mode=mode)
    args = (cfg.neighbor_offsets, pr._sin_cos(pr._deg2rad(lid.ang_res_x)),
            pr._sin_cos(pr._deg2rad(lid.ang_res_y)),
            pr._deg2rad(cfg.segment_theta_deg))
    launch.reset_launches()
    got = edge_masks(rimg, valid, *args)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["edge_masks"] == 1
    assert got.shape[0] == 8 if mode != "4Neighbor" else got.shape[0] == 4
    assert torch.equal(got, edge_masks_plain(rimg, valid, *args))
    assert torch.equal(got.cpu(), edge_masks_plain(rimg.cpu(), valid.cpu(),
                                                   *args))
    assert int(got.sum()) > 0


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (5, 37), (17, 65),
                                   (33, 130)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_edge_masks_kernel_wrapping(dev, shape):
    """Images smaller and a little larger than a tile (16 x 64), where the
    halo wraps onto the tile itself, random ranges with ties and every
    pixel valid on a whole row and a whole column: bit for bit the plain
    version under each mode."""
    from quatro_tpu_torch.config import ProjectionConfig
    from quatro_tpu_torch.ops.range_image import edge_masks, edge_masks_plain
    rows, cols = shape
    rng = np.random.default_rng(rows * cols)
    rimg = rng.choice([4.0, 4.01, 4.5, 9.0, 30.0],
                      (2, rows, cols)).astype(np.float32)
    valid = rng.random((2, rows, cols)) < 0.8
    valid[:, rows // 2] = True
    valid[:, :, cols // 3] = True
    rimg, valid = torch.from_numpy(rimg).to(dev), torch.from_numpy(valid).to(
        dev)
    for mode in ("4CrossNeighbor", "4Neighbor", "8Neighbor"):
        cfg = dataclasses.replace(ProjectionConfig(), neighbor_mode=mode)
        args = (cfg.neighbor_offsets, (0.0034906, 0.99999392),
                (0.0348995, 0.99939083), 0.17453292)
        assert torch.equal(edge_masks(rimg, valid, *args),
                           edge_masks_plain(rimg, valid, *args)), mode


def _random_labels(bsz, rows, cols, seed):
    """Label images of the labelling's form and past it: components of
    single pixels, full-height columns, blobs, valid pixels at the npix
    sentinel, invalid pixels with any label."""
    rng = np.random.default_rng(seed)
    npix = rows * cols
    flat = np.arange(npix).reshape(rows, cols)
    labels = np.full((bsz, rows, cols), npix, np.int32)
    valid = rng.random((bsz, rows, cols)) < 0.6
    for b in range(bsz):
        labels[b] = np.where(valid[b], flat, npix)          # singles
        for c in rng.choice(cols, 6, replace=False):        # full height
            labels[b, :, c] = c
            valid[b, :, c] = True
        for _ in range(40):                                  # blobs
            r0, c0 = rng.integers(0, rows), rng.integers(0, cols)
            h, w = rng.integers(1, 8), rng.integers(1, 40)
            labels[b, r0:r0 + h, c0:c0 + w] = r0 * cols + c0
            valid[b, r0:r0 + h, c0:c0 + w] = True
        sent = rng.random((rows, cols)) < 0.02
        labels[b][sent] = npix
        valid[b][sent] = True
        junk = ~valid[b] & (rng.random((rows, cols)) < 0.3)
        labels[b][junk] = rng.integers(0, npix, int(junk.sum()))
    return torch.from_numpy(labels), torch.from_numpy(valid)


@pytest.mark.parametrize("shape", [(64, 1800), (16, 1800), (64, 1024),
                                   (3, 7)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_component_stats_kernel(dev, shape):
    """The stats on random label images (singles, full-height components,
    blobs, npix sentinels) and on the labelling's own labels of an HDL-64E
    pair, under two gates: bit for bit the plain version on the card and
    on the CPU, across two launches, one counted launch a call."""
    from quatro_tpu_torch.ops.range_image import (component_stats,
                                                  component_stats_plain)
    labels, valid = _random_labels(3, *shape, seed=sum(shape))
    cases = [(labels, valid)]
    if shape == (64, 1800):
        from quatro_tpu_torch.config import ProjectionConfig
        from quatro_tpu_torch.preprocessing import projection
        rimg, v, lid = _images(dev, "Velodyne-64-HDE")
        lab, _, _ = projection.label_components(rimg, v, lid,
                                                ProjectionConfig())
        npix = lab.shape[1] * lab.shape[2]
        cases.append((torch.where(v, lab, npix).to(torch.int32).cpu(),
                      v.cpu()))
    feasible = 0
    for lab, v in cases:
        for gate in ((30, 5, 3), (1000, 2, 2)):
            ref = component_stats_plain(lab, v, *gate)
            d_lab, d_v = lab.to(dev), v.to(dev)
            launch.reset_launches()
            got = component_stats(d_lab, d_v, *gate)
            again = component_stats(d_lab, d_v, *gate)
            torch.cuda.synchronize()
            assert launch.LAUNCHES["component_stats"] == 2
            for g, a, p, r in zip(got, again,
                                  component_stats_plain(d_lab, d_v, *gate),
                                  ref):
                assert torch.equal(g, a) and torch.equal(g, p)
                assert torch.equal(g.cpu(), r)
            feasible += int(got[1].sum())
    assert feasible > 0


@pytest.mark.parametrize("mode", ["Patchwork", "LeGO-LOAM"])
def test_segment_cloud_runs_the_range_image_kernels(dev, mode, monkeypatch):
    """segment_cloud on an HDL-64E pair on the card: each of the three
    kernels launched once, no utils/fused.atan2 torch chain on the
    projection's path in Patchwork mode (the LeGO-LOAM ground test keeps
    one), every field equal to the CPU's."""
    from quatro_tpu_torch.preprocessing import projection
    from quatro_tpu_torch.utils import fused
    lid = LidarConfig.preset("Velodyne-64-HDE")
    pts, mask = _raw_pair("Velodyne-64-HDE")
    if mode == "Patchwork":
        mask &= pts[..., 2] > -1.723 + 0.3
    ref = projection.segment_cloud(pts, mask, lid, ground_mode=mode)
    calls = []
    real = fused.atan2

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(fused, "atan2", spy)
    launch.reset_launches()
    got = projection.segment_cloud(pts.to(dev), mask.to(dev), lid,
                                   ground_mode=mode)
    torch.cuda.synchronize()
    assert {k: launch.LAUNCHES[k] for k in ("range_image", "edge_masks",
                                            "component_stats")} == {
        "range_image": 1, "edge_masks": 1, "component_stats": 1}
    assert len(calls) == (0 if mode == "Patchwork" else 1)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


# --------------------------------------------- Patchwork's CZM and planes --

def _czm_case(lidar, case):
    """A raw pair of a preset with ``czm_specials``' points and empty third
    cloud, as (3, N, 3) and (3, N) on the CPU, with the configuration
    ``case`` of ``CZM_CONFIGS``."""
    cfg = PipelineConfig.for_lidar(lidar).patchwork
    cfg = dataclasses.replace(cfg, **CZM_CONFIGS[case])
    return (*czm_specials(*_raw_pair(lidar), cfg), cfg)


@pytest.mark.parametrize("case", list(CZM_CONFIGS))
@pytest.mark.parametrize("lidar", ["Velodyne-64-HDE", "VLP-16",
                                   "Ouster-OS1-64"])
def test_czm_kernels(dev, lidar, case):
    """czm_points, seed_heights and plane_fit (each fit, bf16 trips and
    the exact last one) on a raw pair of each preset with special points
    and an empty cloud, under each configuration: every output bit for bit
    the plain version on the card (NaN where NaN), equal across two
    launches, one counted launch a call."""
    from quatro_tpu_torch.ops import czm
    pts, mask, cfg = _czm_case(lidar, case)
    pts, mask = pts.to(dev), mask.to(dev)
    p_cnt = cfg.num_patches
    p_pad = czm._pad128(p_cnt + 1)
    launch.reset_launches()
    got = czm.czm_points(pts, mask, cfg)
    again = czm.czm_points(pts, mask, cfg)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["czm_points"] == 2
    ref = czm.czm_points_plain(pts, mask, cfg)
    for name, g, a, r in zip(("pid", "zb", "chan", "weights", "b0"), got,
                             again, ref):
        assert _same_bits(g, a) and _same_bits(g, r), name
    pid, zb, chan, weights, b0 = got
    assert int((pid < p_cnt).sum()) > 1000 and b0[2] == 0
    hist = segment.cross_histogram(pid, zb, weights, p_pad, czm.Z_BINS)
    seeds = czm.seed_heights(hist, b0, cfg)
    for name, g, r in zip(("lpr_h", "live", "tab"), seeds,
                          czm.seed_heights_plain(hist, b0, cfg)):
        assert _same_bits(g, r), name
    assert launch.LAUNCHES["seed_heights"] == 1
    _, live, tab = seeds
    ptab = czm._patch_tables(cfg, pts.device)
    for trip in range(cfg.num_iter):
        final = trip + 1 == cfg.num_iter
        sums = segment.fit_iteration_moments(pid, chan, tab, p_pad, p_cnt,
                                             exact=final)
        out = czm.plane_fit(sums, ptab, cfg, final=final, patch_live=live)
        ref = czm.plane_fit_plain(sums, ptab, cfg, final=final,
                                  patch_live=live)
        outs = out if final else (out,)
        refs = ref if final else (ref,)
        for g, r in zip(outs, refs):
            assert _same_bits(g, r), (trip, final)
        tab = outs[-2] if final else out
    assert launch.LAUNCHES["plane_fit"] == cfg.num_iter
    assert int(outs[-1].sum()) > 0


def test_czm_points_refuses_too_many_zones(dev):
    from quatro_tpu_torch.ops import czm
    cfg = PipelineConfig().patchwork
    k = czm.MAX_ZONES + 1
    cfg = dataclasses.replace(
        cfg, num_zones=k, num_sectors_each_zone=(8,) * k,
        num_rings_each_zone=(1,) * k,
        min_ranges_each_zone=tuple(2.7 + 8.0 * i for i in range(k)))
    pts, mask = _raw_pair("VLP-16", n=4096)
    with pytest.raises(ValueError, match="zones"):
        czm.czm_points(pts.to(dev), mask.to(dev), cfg)


def test_plane_fit_kernel_in_a_cuda_graph(dev):
    """The bf16 trip's plane_fit captured in a CUDA graph with B9 (as the
    patchwork_fit fori captures it): the replay gives the eager bits."""
    from quatro_tpu_torch.ops import czm
    pts, mask, cfg = _czm_case("Velodyne-64-HDE", "default")
    pts, mask = pts.to(dev), mask.to(dev)
    p_cnt = cfg.num_patches
    p_pad = czm._pad128(p_cnt + 1)
    pid, zb, chan, weights, b0 = czm.czm_points(pts, mask, cfg)
    _, _, tab = czm.seed_heights(segment.cross_histogram(
        pid, zb, weights, p_pad, czm.Z_BINS), b0, cfg)
    ptab = czm._patch_tables(cfg, pts.device)

    def trip():
        return czm.plane_fit(segment.fit_iteration_moments(
            pid, chan, tab, p_pad, p_cnt, exact=False), ptab, cfg)

    want = trip()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trip()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = trip()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("num_iter", [1, 3])
def test_estimate_ground_runs_the_czm_kernels(dev, num_iter, monkeypatch):
    """estimate_ground on an HDL-64E pair on the card: czm_points and
    seed_heights launched once, plane_fit num_iter times (the bf16 trips
    inside the patchwork_fit graph), no utils/fused.atan2 or hypot and no
    smallest_eigenpair_sym3 torch chain, and every field equal to the
    plain route's on the card (the three wrappers swapped for their plain
    versions)."""
    from quatro_tpu_torch.ops import czm
    from quatro_tpu_torch.preprocessing import patchwork
    from quatro_tpu_torch.utils import fused
    cfg = dataclasses.replace(PipelineConfig().patchwork, num_iter=num_iter)
    pts, mask = (t.to(dev) for t in _raw_pair("Velodyne-64-HDE"))
    patchwork.estimate_ground(pts, mask, cfg)       # the fits' graph
    calls = []

    def spy(real):
        def call(*args):
            calls.append(real)
            return real(*args)
        return call

    monkeypatch.setattr(fused, "atan2", spy(fused.atan2))
    monkeypatch.setattr(fused, "hypot", spy(fused.hypot))
    monkeypatch.setattr(czm, "smallest_eigenpair_sym3",
                        spy(czm.smallest_eigenpair_sym3))
    launch.reset_launches()
    got = patchwork.estimate_ground(pts, mask, cfg)
    torch.cuda.synchronize()
    assert {k: launch.LAUNCHES[k] for k in ("czm_points", "seed_heights",
                                            "plane_fit")} == {
        "czm_points": 1, "seed_heights": 1, "plane_fit": num_iter}
    assert not calls
    monkeypatch.undo()
    for name in ("czm_points", "seed_heights", "plane_fit"):
        monkeypatch.setattr(patchwork, name, getattr(czm, f"{name}_plain"))
    from quatro_tpu_torch.utils import loops
    with loops.eager_loops():
        ref = patchwork.estimate_ground(pts, mask, cfg)
    for name, g, r in zip(got._fields, got, ref):
        assert torch.equal(g, r), name
    assert int(got.ground.sum()) > 10000


# -------------------------------------------------------- clique stage --

CLIQUE_CASES = [*GRAPHS, "miss_one", "wide_1024_1", "wide_1024_64",
                "wide_2048_2"]


def _clique_graph(name, dev):
    """A case of tests/torch_clique_cases.py on the card: (adj, mask)."""
    if name.startswith("wide"):
        _, n, b = name.split("_")
        return wide_graphs(int(b), int(n), dev)
    adj, mask = (miss_one_batch()[:2] if name == "miss_one"
                 else graph_case(name))
    return (torch.from_numpy(adj).to(dev).contiguous(),
            torch.from_numpy(mask).to(dev).contiguous())


@pytest.mark.parametrize("name", CLIQUE_CASES)
def test_clique_kernels(dev, name):
    """Each of the clique stage's four kernels against its plain version
    on the card (and on CPU copies below N = 1024) on the same inputs, bit
    for bit: every output of the k-core search, three growths, two swaps,
    two distinct greedies; the launches counted; the packed rows staged in
    shared memory up to N = 1024 and read through L2 at N = 2048."""
    from quatro_tpu_torch.ops import cliques as tcl
    from quatro_tpu_torch.utils import loops
    adj, mask = _clique_graph(name, dev)
    n = adj.shape[-1]
    tcl.reset_routes()
    launch.reset_launches()
    got = clique_stage_calls(adj, mask, tcl, True)
    torch.cuda.synchronize()
    assert {k: launch.LAUNCHES[k] for k in tcl.KIND} == {
        "kcore_search": 1, "grow_cliques": 3, "swap_cliques": 2,
        "distinct_cliques": 2}
    with loops.eager_loops():
        ref = clique_stage_calls(adj, mask, tcl, False)
    refs = [ref]
    if n < 1024:
        refs.append(clique_stage_calls(adj.cpu(), mask.cpu(), tcl, False))
    for r in refs:
        for call, outs in got.items():
            assert len(outs) == len(r[call])
            for k, (g, want) in enumerate(zip(outs, r[call])):
                assert g.dtype == want.dtype and g.shape == want.shape
                assert torch.equal(g.cpu(), want.cpu()), (call, k)
    staged = "global" if n > 1024 else "shared"
    for k in ("kcore_search", "grow_cliques", "swap_cliques"):
        assert tcl.ROUTES[k][staged] == launch.LAUNCHES[k], (k, tcl.ROUTES)
    print(name, {k: v.sum().item() for k, v in zip(
        ("k", "core"), got["kcore_search"][:2])},
        "largest", int(got["swap"][0].sum(-1).max()), dict(tcl.ROUTES))


def _distinct_rows(name):
    if name == "wide":          # 1000 rows of 2048: the packed rows in L2
        rng = np.random.default_rng(3)
        rows = rng.uniform(size=(2, 1000, 2048)) < rng.uniform(
            0.001, 0.05, (2, 1000, 1))
        rows[:, 1::3] = rows[:, ::3][:, :rows[:, 1::3].shape[1]]
        return rows
    return distinct_case(name)


@pytest.mark.parametrize("name,k", [("random", 4), ("random", 8),
                                    ("singletons", 4), ("all_false", 4),
                                    ("wide", 4), ("wide", 16)])
@pytest.mark.parametrize("force_first", [False, True])
def test_distinct_cliques_kernel(dev, name, k, force_first):
    """The distinct greedy's kernel against its plain version on the card
    and on CPU copies, bit for bit, one launch; at 1000 rows of 2048 its
    packed rows read through L2."""
    from quatro_tpu_torch.ops import cliques as tcl
    rows = torch.from_numpy(_distinct_rows(name))
    tcl.reset_routes()
    launch.reset_launches()
    got = tcl.distinct_cliques(rows.to(dev), k, force_first=force_first)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["distinct_cliques"] == 1
    for ref in (tcl.distinct_cliques_plain(rows.to(dev), k,
                                           force_first=force_first),
                tcl.distinct_cliques_plain(rows, k, force_first=force_first)):
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r.cpu())
    assert tcl.ROUTES["distinct_cliques"][
        "global" if name == "wide" else "shared"] == 1


@pytest.mark.parametrize("mode", ["clique", "kcore", "exact"])
def test_select_inliers_runs_the_clique_kernels(dev, mode):
    """select_inliers in each mode, greedy_cliques, clique_seed_scores and
    top_distinct_cliques on three VLP-16-width pairs on the card: the
    kernels' route, with no device loop of the clique stage, equal to the
    plain route bit for bit; the launches per call."""
    from quatro_tpu_torch.solver import clique
    from quatro_tpu_torch.utils import loops
    adj, mask = wide_graphs(3, 256, dev)

    def stage():
        sel = clique.select_inliers(adj, mask, mode=mode, num_seeds=128,
                                    swap_rounds=2)
        scores, packed = clique.clique_seed_scores_and_bits(adj, mask)
        greedy = clique.greedy_cliques(adj, scores, mask, packed=packed,
                                       num_seeds=16,
                                       swap_rounds=1)
        grown = clique.select_inliers_with_candidates(
            adj, mask, num_seeds=128, swap_rounds=2)[2]
        picked = clique.top_distinct_cliques(grown, 4)
        return _flat((sel, scores, greedy, grown, picked))

    loops.reset_loops()
    launch.reset_launches()
    got = stage()
    torch.cuda.synchronize()
    assert not set(CLIQUE_LOOPS) & set(loops.LOOPS)
    # k-core searches: the mode's (1; exact: the seed scores, which the
    # greedy and the restriction share, and the restriction's k-core, 2),
    # then the seed scores' (whose bits the greedy takes) and the
    # selection's; growths: the mode's (none for kcore), the greedy's and
    # the selection's
    kcore = {"clique": 3, "kcore": 3, "exact": 4}[mode]
    grow = {"clique": 3, "kcore": 2, "exact": 3}[mode]
    assert launch.LAUNCHES["kcore_search"] == kcore, dict(launch.LAUNCHES)
    assert launch.LAUNCHES["grow_cliques"] == grow
    assert launch.LAUNCHES["distinct_cliques"] == 1
    with plain_clique_route(), loops.eager_loops():
        ref = stage()
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_grow_cliques_at_the_exact_sum_limit(dev):
    """The growth's early completion at the edge of the range where the
    plain route's f32 sums are exact (ops.cliques.GROW_EXACT): on a
    complete graph of GROW_EXACT + 1 vertices with max_size GROW_EXACT +
    1, every seed absorbs its GROW_EXACT candidates whole, bit for bit the
    plain version on the card; a max_size one larger is refused
    (ValueError), as the plain route would test it on rounded sums."""
    from quatro_tpu_torch.ops import cliques as tcl
    n = tcl.GROW_EXACT + 1
    adj = ~torch.eye(n, dtype=torch.bool, device=dev)[None]
    mask = torch.ones((1, n), dtype=torch.bool, device=dev)
    _, core, deg, packed = tcl.kcore_search(adj, mask)
    scores = core.to(torch.float32) * 1e6 + deg
    got = tcl.grow_cliques(adj, scores, mask, 16, n, 8, 16, packed)
    ref = tcl.grow_cliques_plain(adj, scores, mask, 16, n, 8, 16)
    assert torch.equal(got, ref)
    assert bool(got.all())
    with pytest.raises(ValueError):
        tcl.grow_cliques(adj, scores, mask, 16, n + 1, 8, 16, packed)


# ------------------------------------------------------------------ ICP --

def _bits(a, b):
    """Equal bit for bit (float tensors through their int32 views, so NaN
    and -0.0 count)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def icp_card(dev):
    """tests/torch_icp_cases.py's clouds on the card, with the target's
    lists and normals from the plain versions there."""
    from quatro_tpu_torch.ops.neighbors import radius_neighbors_plain
    from quatro_tpu_torch.ops.normals import estimate_normals_plain
    from torch_icp_cases import icp_clouds
    vox, vmask, gt, cfg = icp_clouds(dev)
    f = cfg.fpfh
    nbrs = radius_neighbors_plain(vox[1], vmask[1], f.normal_radius,
                                  f.max_neighbors_normal)
    return vox, vmask, gt, cfg, estimate_normals_plain(vox[1], nbrs)


@pytest.mark.parametrize("k", [48, 1, 32, 33, 64])
@pytest.mark.parametrize("case", ["as_is", "few_valid", "all_masked"])
def test_radius_knn_kernel(dev, icp_card, case, k):
    """csrc/knn.cu on a batch of two clouds, one launch, every output bit
    for bit the plain version on the card; the unbatched call too."""
    from quatro_tpu_torch.ops.neighbors import (radius_neighbors,
                                                radius_neighbors_plain)
    from torch_icp_cases import list_masks
    vox, vmask, _, cfg, _ = icp_card
    mask = list_masks(vmask)[case]
    r = cfg.fpfh.normal_radius
    launch.reset_launches()
    got = radius_neighbors(vox, mask, r, k)
    assert launch.LAUNCHES["radius_knn"] == 1
    ref = radius_neighbors_plain(vox, mask, r, k)
    assert all(_bits(g, e) for g, e in zip(got, ref))
    one = radius_neighbors(vox[1], mask[1], r, k)
    assert all(_bits(g, e[1]) for g, e in zip(one, ref))


def test_radius_knn_kernel_odd_shapes(dev):
    """Clouds whose sizes are no multiple of a block's rows or of a staged
    chunk (N = 5, 517, 1500), points on a coarse grid (equal distances:
    the lower index wins), K up to N."""
    from quatro_tpu_torch.ops.neighbors import (radius_neighbors,
                                                radius_neighbors_plain)
    rng = np.random.default_rng(23)
    for n in (5, 517, 1500):
        pts = torch.from_numpy(rng.integers(-4, 5, (3, n, 3)).astype(
            np.float32) * 0.25).to(dev)
        mask = torch.from_numpy(rng.random((3, n)) < 0.8).to(dev)
        for k in sorted({1, min(n, 48), min(n, 64)}):
            got = radius_neighbors(pts, mask, 0.6, k)
            ref = radius_neighbors_plain(pts, mask, 0.6, k)
            assert all(_bits(g, e) for g, e in zip(got, ref)), (n, k)


@pytest.mark.parametrize("k", [48, 1, 16, 33, 64])
@pytest.mark.parametrize("case", ["as_is", "few_valid"])
def test_neighbor_normals_kernel(dev, icp_card, case, k):
    """csrc/neighbor_normals.cu on both clouds' lists (one launch), bit for
    bit the plain version on the card; a viewpoint off the origin too."""
    from quatro_tpu_torch.ops.neighbors import radius_neighbors
    from quatro_tpu_torch.ops.normals import (estimate_normals,
                                              estimate_normals_plain)
    from torch_icp_cases import list_masks
    vox, vmask, _, cfg, _ = icp_card
    lists = radius_neighbors(vox, list_masks(vmask)[case],
                             cfg.fpfh.normal_radius, k)
    for vp in ((0.0, 0.0, 0.0), (1.5, -2.0, 0.3)):
        launch.reset_launches()
        got = estimate_normals(vox, lists, vp)
        assert launch.LAUNCHES["neighbor_normals"] == 1
        ref = estimate_normals_plain(vox, lists, vp)
        assert all(_bits(g, e) for g, e in zip(got, ref)), vp


@pytest.mark.parametrize("case", ["as_is", "all_masked"])
def test_icp_correspond_kernel(dev, icp_card, case):
    """csrc/icp.cu's correspondences for a batch of two pairs at each gate
    of the schedule, bit for bit the plain version on the card."""
    from quatro_tpu_torch.ops import icp as ticp
    from torch_icp_cases import correspond_args
    vox, vmask, gt, cfg, nrm = icp_card
    args = correspond_args(vox, vmask, nrm.normals, nrm.valid, gt, cfg,
                           case, dev)
    for s in range(len(args[-1])):
        step = torch.tensor([s], device=dev)
        launch.reset_launches()
        got = ticp.icp_correspond(*args, step, cfg.icp.huber_delta)
        assert launch.LAUNCHES["icp_correspond"] == 1
        ref = ticp.icp_correspond_plain(*args, step, cfg.icp.huber_delta)
        assert all(_bits(g, e) for g, e in zip(got, ref)), s
    if case == "all_masked":
        assert not bool(got[1][1].any())


@pytest.mark.parametrize("rows_kept", [2048, 1200, 1, 5000])
@pytest.mark.parametrize("yaw_only", [False, True])
def test_icp_update_kernel(dev, icp_card, yaw_only, rows_kept):
    """csrc/icp.cu's update on the correspondences' rows (the first
    ``rows_kept``, or the rows tiled to 5000: a tree of 8192 leaves),
    with the min_correspondences gate passed and failed, bit for bit the
    plain version on the card."""
    from quatro_tpu_torch.ops import icp as ticp
    from torch_icp_cases import correspond_args, dof_of
    vox, vmask, gt, cfg, nrm = icp_card
    args = correspond_args(vox, vmask, nrm.normals, nrm.valid, gt, cfg,
                           "as_is", dev)
    step = torch.tensor([3], device=dev)
    rows, ok = ticp.icp_correspond(*args, step, cfg.icp.huber_delta)
    if rows_kept > rows.shape[1]:
        reps = -(-rows_kept // rows.shape[1])
        rows = rows.repeat(1, reps, 1)[:, :rows_kept].contiguous()
        ok = ok.repeat(1, reps)[:, :rows_kept].contiguous()
    else:
        rows = rows[:, :rows_kept].contiguous()
        ok = ok[:, :rows_kept].contiguous()
    dof = dof_of(yaw_only).to(dev)
    for min_corr in (cfg.icp.min_correspondences, rows_kept + 1):
        launch.reset_launches()
        got = ticp.icp_update(rows, ok, args[2], args[3], step, dof,
                              cfg.icp.damping, min_corr)
        assert launch.LAUNCHES["icp_update"] == 1
        ref = ticp.icp_update_plain(rows, ok, args[2], args[3], step, dof,
                                    cfg.icp.damping, min_corr)
        assert all(_bits(g, e) for g, e in zip(got, ref)), min_corr


@pytest.mark.parametrize("yaw_only", [False, True])
def test_refine_icp_runs_the_icp_kernels(dev, icp_card, yaw_only,
                                         monkeypatch):
    """raw_scan_normals and refine_icp on the card: K1 and K2 once, the
    correspondences iterations + 1 times and the update iterations times
    (counted inside the loop's graph at its replays), every field bit for
    bit the plain route on the card (the wrappers swapped for their plain
    versions, the loop eager); on the graph route twice."""
    from quatro_tpu_torch import pipeline
    from quatro_tpu_torch.ops import icp as ticp
    from quatro_tpu_torch.ops import neighbors, normals
    from quatro_tpu_torch.solver import icp as sicp
    from quatro_tpu_torch.utils import loops
    from torch_icp_cases import init_poses
    vox, vmask, gt, cfg, _ = icp_card
    ic = replace(cfg.icp, enabled=True, yaw_only=yaw_only)
    rot, trans = init_poses(gt, dev)

    def run():
        nrm = pipeline.raw_scan_normals(vox[1:], vmask[1:], cfg)
        res = sicp.refine_icp(vox[:1], vmask[:1], vox[1:], vmask[1:],
                              nrm.normals, nrm.valid, rot[:1], trans[:1],
                              ic)
        return (*nrm, *res)

    loops.clear_graphs()
    launch.reset_launches()
    got = run()
    torch.cuda.synchronize()
    counts = {k: launch.LAUNCHES[k] for k in ("radius_knn",
                                              "neighbor_normals",
                                              "icp_correspond", "icp_update")}
    assert counts == {"radius_knn": 1, "neighbor_normals": 1,
                      "icp_correspond": ic.iterations + 1,
                      "icp_update": ic.iterations}, counts
    again = run()
    assert all(_bits(g, e) for g, e in zip(again, got))
    monkeypatch.setattr(pipeline, "radius_neighbors",
                        neighbors.radius_neighbors_plain)
    monkeypatch.setattr(pipeline, "estimate_normals",
                        normals.estimate_normals_plain)
    monkeypatch.setattr(sicp, "icp_correspond", ticp.icp_correspond_plain)
    monkeypatch.setattr(sicp, "icp_update", ticp.icp_update_plain)
    launch.reset_launches()
    with loops.eager_loops():
        ref = run()
    assert not any(launch.LAUNCHES[k] for k in counts)
    assert all(_bits(g, e) for g, e in zip(got, ref))


# ------------------------------------ the matcher's kernels, B2's pair axis --

def _seg_pair_case(dev, bsz, n, seed):
    from torch_match_cases import segment_case
    ids, vals = segment_case(seed, bsz, n, 3, 256,
                             dead=(bsz - 1,) if bsz > 1 else ())
    return torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)


# the vote's shape at B = 1 and 64, rows past one chunk that end inside
# one, and the pose graph's N (one chunk: no partials) at a pair axis
@pytest.mark.parametrize("bsz,n", [(1, 65536), (3, 2 * 8192 + 5), (5, 38),
                                   (64, 65536)])
def test_segment_sums_pair_axis_kernel(dev, bsz, n):
    """B2 with its pair axis: one launch a call, bit for bit across two
    launches, its plain version on CPU copies and each row's own one-row
    call (a dead row all zeros), every ticket back at 0."""
    ids, vals = _seg_pair_case(dev, bsz, n, bsz + n)
    before = tf.LAUNCHES["segment_sums"]
    got = segment.segment_sums(ids, vals, 256)
    again = segment.segment_sums(ids, vals, 256)
    assert tf.LAUNCHES["segment_sums"] == before + 2
    assert got.shape == (bsz, 256, 3) and torch.equal(got, again)
    assert torch.equal(got.cpu(), segment.segment_sums_plain(
        ids.cpu(), vals.cpu(), 256, segment.SEG_CHUNK))
    for b in range(bsz):
        assert torch.equal(got[b], segment.segment_sums(ids[b], vals[b], 256))
    if bsz > 1:
        assert not got[-1].any()
    for ticket, _ in launch._SCRATCH.values():
        assert int(ticket.abs().sum()) == 0


def test_vote_histograms_one_pair_axis_call(dev):
    """``pair_segment_sums`` is one B2 call with the pair axis, no id
    offsets: bit for bit the former flat route (ids offset by b * bins,
    each pair padded to a chunk boundary, one problem of B * bins)."""
    ids, vals = _seg_pair_case(dev, 8, 65536 - 100, 8)
    before = tf.LAUNCHES["segment_sums"]
    got = vote.pair_segment_sums(ids, vals, 256)
    assert tf.LAUNCHES["segment_sums"] == before + 1
    e = ids.shape[1]
    ep = -(-e // segment.SEG_CHUNK) * segment.SEG_CHUNK
    off = torch.arange(8, dtype=torch.int32, device=dev)[:, None] * 256
    flat = torch.where((ids >= 0) & (ids < 256), ids + off, -1)
    flat = torch.nn.functional.pad(flat, (0, ep - e), value=-1)
    fv = torch.nn.functional.pad(vals, (0, ep - e))
    ref = segment.segment_sums(flat.reshape(-1).contiguous(),
                               fv.transpose(0, 1).reshape(3, -1).contiguous(),
                               8 * 256).reshape(8, 256, 3)
    assert torch.equal(got, ref)


def _neighbors_on(dev, mode, bsz=3, na=700, nb=650, seed=0):
    from quatro_tpu_torch.ops import match_kernels as mk
    from torch_match_cases import neighbor_case
    case = neighbor_case(seed, bsz, na, nb, mutual=(400, 20, 0)[:bsz],
                         second=mode == mk.FALLBACK)
    return [None if x is None else torch.from_numpy(x).to(dev)
            for x in case]


@pytest.mark.parametrize("mode", [0, 1, 2],
                         ids=["fallback", "crosscheck", "union"])
@pytest.mark.parametrize("size", ["small", "full"])
def test_match_candidates_kernel(dev, mode, size):
    """The candidate keys and counts on the card bit for bit their plain
    version there, under each branch (the fallback's pairs: one with its
    mutual pairs, one starving, one with none), at 700 x 650 and at the
    main path's 8192 x 8192; one launch a call."""
    from quatro_tpu_torch.ops import match_kernels as mk
    shape = dict(small=dict(), full=dict(na=8192, nb=8192))[size]
    t = _neighbors_on(dev, mode, seed=mode, **shape)
    before = tf.LAUNCHES["match_candidates"]
    got = mk.match_candidates(*t, mode, 64)
    assert tf.LAUNCHES["match_candidates"] == before + 1
    ref = mk.match_candidates_plain(*t, mode, 64)
    assert all(_bits(g, r) for g, r in zip(got, ref))
    assert int(got[1].min()) >= 0


def _tuple_on(dev, case, n_cand_min=0):
    from torch_match_cases import TUPLE_CASES, tuple_case
    tt, cap, ncorr, share, use_tuple, min_keep = TUPLE_CASES[case]
    n_cand = max(tt, 2 * max(ncorr), n_cand_min)
    keys, nc, src, tgt = tuple_case(len(case), 2, n_cand, 900, 800, ncorr,
                                    share)
    return ([torch.from_numpy(x).to(dev) for x in (keys, nc, src, tgt)],
            (tt, cap, use_tuple, 0.95, 100, 0, min_keep))


@pytest.mark.parametrize("case", ["ncorr_below_tt", "collapse",
                                  "tt_below_capacity", "no_tuple_test"])
def test_tuple_compact_kernel(dev, case):
    """The tuple test and compaction on the card bit for bit their plain
    version there (the card's a / scale: the product with the f32
    reciprocal), under each of the shared cases; one launch a call."""
    from quatro_tpu_torch.ops import match_kernels as mk
    args, kw = _tuple_on(dev, case)
    before = tf.LAUNCHES["tuple_compact"]
    got = mk.tuple_compact(*args, *kw)
    assert tf.LAUNCHES["tuple_compact"] == before + 1
    ref = mk.tuple_compact_plain(*args, *kw)
    assert all(_bits(g, r) for g, r in zip(got, ref))


def test_tuple_compact_kernel_workspace(dev):
    """A prefix of 8192 candidates (237 KB a pair: past the block's shared
    memory, so the pair's slice of a device workspace) and 64 pairs of the
    main path's shape (tt 2048 of 32768 keys) against the plain version
    on the card."""
    from quatro_tpu_torch.ops import match_kernels as mk
    from torch_match_cases import tuple_case
    assert mk.tuple_workspace(8192) > mk.TUPLE_SMEM_MAX
    for bsz, n_cand, tt, ncorr in ((2, 16384, 8192, (8000, 3000)),
                                   (64, 32768, 2048, [1900] * 32 + [700] * 32)):
        keys, nc, src, tgt = tuple_case(tt, bsz, n_cand, 8192, 8192, ncorr,
                                        [0.3] * bsz)
        args = [torch.from_numpy(x).to(dev) for x in (keys, nc, src, tgt)]
        got = mk.tuple_compact(*args, tt, 1024)
        ref = mk.tuple_compact_plain(*args, tt, 1024)
        assert all(_bits(g, r) for g, r in zip(got, ref)), (bsz, tt)


@pytest.mark.parametrize("branch", ["fallback", "crosscheck", "union"])
def test_match_features_kernels_equal_plain_route(dev, scans, branch,
                                                  monkeypatch):
    """``match_features`` on the card's own descriptors of the level_a
    pair and of the pair with its target cut to 40 valid voxels (which
    starves under the fallback), as one batch: the two kernels once each,
    every output bit for bit the plain route on the card (the wrappers
    swapped for their plain versions)."""
    from quatro_tpu_torch.ops import match_kernels as mk
    from quatro_tpu_torch.ops import matching
    kw = dict(fallback=dict(crosscheck_min_matches=64),
              crosscheck=dict(crosscheck_min_matches=0),
              union=dict(use_crosscheck=False))[branch]
    vox, desc, dmask, _ = extract_features(*scans, CFG, device=dev)
    starved = dmask[1] & (torch.cumsum(dmask[1].int(), 0) <= 40)
    args = (torch.stack([vox.points[0]] * 2), torch.stack([vox.points[1]] * 2),
            torch.stack([desc[0]] * 2), torch.stack([desc[1]] * 2),
            torch.stack([dmask[0]] * 2), torch.stack([dmask[1], starved]))
    tf.reset_launches()
    got = matching.match_features(*args, capacity=1024, device=dev, **kw)
    assert (tf.LAUNCHES["match_candidates"], tf.LAUNCHES["tuple_compact"]) \
        == (1, 1)
    monkeypatch.setattr(matching, "match_candidates",
                        mk.match_candidates_plain)
    monkeypatch.setattr(matching, "tuple_compact", mk.tuple_compact_plain)
    ref = matching.match_features(*args, capacity=1024, device=dev, **kw)
    assert all(_bits(g, r) for g, r in zip(got, ref))
    assert int(got.mask[0].sum()) >= 10
