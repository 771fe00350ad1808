"""The ten CUDA kernels against their plain PyTorch versions, on the card.

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
    path there). The moment sums and, on the card's own normals (an ulp
    turns the normal of an ill-conditioned row freely), the descriptors
    agree with the plain versions on the CPU within the bounds of
    chip_smoke.py."""
    cfg = PipelineConfig.for_lidar("VLP-16", max_voxels=2000)
    tf.reset_launches()
    vox, desc, dmask, normals = extract_features(*scans, cfg, device=dev)
    assert {k: tf.LAUNCHES[k] for k in ("moment_sums", "spfh", "fpfh")} == \
        {"moment_sums": 1, "spfh": 1, "fpfh": 1}
    assert desc.shape == (2, 2000, 33) and bool(torch.isfinite(desc).all())
    pts, mask = vox.points, vox.mask
    maskf = mask.float().contiguous()
    r = cfg.fpfh.normal_radius
    torch.testing.assert_close(tf.moment_sums(pts, maskf, r).cpu(),
                               tf.moment_sums_plain(pts.cpu(), maskf.cpu(), r),
                               rtol=1e-5, atol=1e-4)
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


def test_moment_sums_kernel(cloud):
    pts, mask = cloud
    maskf = mask.float().contiguous()
    r = CFG.fpfh.normal_radius
    before = tf.LAUNCHES["moment_sums"]
    got = tf.moment_sums(pts, maskf, r)
    assert tf.LAUNCHES["moment_sums"] == before + 1
    torch.testing.assert_close(got, tf.moment_sums_plain(pts, maskf, r),
                               rtol=1e-5, atol=1e-4)


def test_spfh_and_fpfh_kernels(cloud):
    pts, mask = cloud
    normals = tf.frontend_normals(pts, mask, CFG.fpfh.normal_radius)
    nrm = normals.normals.contiguous()
    pmf = (mask & normals.valid).float().contiguous()
    r = CFG.fpfh.fpfh_radius
    hist, cnt = tf.spfh(pts, nrm, pmf, r)
    rhist, rcnt = tf.spfh_plain(pts, nrm, pmf, r)
    assert torch.equal(cnt, rcnt)
    flipped = float((hist != rhist).any(-1).float().mean())
    assert flipped < 0.005, f"bin-edge flips on {flipped:.2%} of rows"
    rows = (rhist * (100.0 / torch.clamp(rcnt, min=1.0))[..., None])
    rows = rows.contiguous()
    torch.testing.assert_close(tf.fpfh_sums(pts, rows, pmf, r),
                               tf.fpfh_sums_plain(pts, rows, pmf, r),
                               rtol=1e-4, atol=1e-3)


# Nb = 4096: two column chunks, and the strict-less merge hands the second
# slot to the later chunk's tied copy (3000); Nb = 3072: one chunk, ties go
# to the lower index (101).
@pytest.mark.parametrize("nb,second", [(4096, 3000), (3072, 101)])
def test_nearest_neighbors2_kernel(dev, nb, second):
    """Random descriptors at Na = 512 with exact duplicates across and
    inside a chunk: both slots' indices equal the plain version's on the
    duplicated rows, i1 wherever the top-2 gap is clear, distances within
    rtol 1e-5 plus 1e-6 of the norm scale."""
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
    i1, d1, i2, d2 = (x[0] for x in tf.nearest_neighbors2(a, b, ma_t, mb_t))
    sq_a, sq_b = (a * a).sum(-1), (b * b).sum(-1)
    ri1, rd1, ri2, rd2 = (x[0] for x in tf._fill_empty(
        *tf.nearest_neighbors2_plain(a, b, ma_t.float(), mb_t.float(), sq_a,
                                     sq_b), ma_t))
    scale = float(sq_a.max() + sq_b.max())
    for got, ref in ((d1, rd1), (d2, rd2)):
        assert bool(((got - ref).abs() <= 1e-5 * ref + 1e-6 * scale).all())
    clear = (rd2 - rd1 > 1e-4 * rd1)
    assert torch.equal(i1[clear], ri1[clear])
    assert (i1[:20] == 100).all() and (i2[:20] == second).all()
    assert torch.equal(i2[:20], ri2[:20])


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
                        "nearest_neighbors2": 2, "consistency_graph": 1,
                        "segment_sums": 1, "cross_histogram": 0,
                        "fit_iteration_moments": 0, "classify_points": 0,
                        "image_lookup": 0}
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
    """B2 on the vote's own entries: within rtol 1e-5 / atol 1e-4 of its
    plain version, and the same bits on a second launch; and at 131072
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
        torch.testing.assert_close(got, segment.segment_sums_plain(i, v, p),
                                   rtol=1e-5, atol=1e-4)


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


def test_cross_histogram_kernel(prep_inputs):
    """B8: the same bits on a second launch, counts equal to the plain
    version's, sums within rtol 1e-5 / atol 1e-4."""
    t, p_pad, _ = prep_inputs
    before = tf.LAUNCHES["cross_histogram"]
    got = segment.cross_histogram(t["ids"], t["zb"], t["w"], p_pad, 128)
    assert tf.LAUNCHES["cross_histogram"] == before + 1
    assert torch.equal(got, segment.cross_histogram(t["ids"], t["zb"],
                                                    t["w"], p_pad, 128))
    ref = segment.cross_histogram_plain(t["ids"], t["zb"], t["w"], p_pad, 128)
    assert torch.equal(got[:, 0], ref[:, 0])
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("exact", [False, True])
def test_fit_iteration_moments_kernel(prep_inputs, exact):
    """B9: the same bits on a second launch, membership counts equal to
    the plain version's, moment sums within rtol 1e-5 / atol 1e-4 (bf16
    channels when not exact)."""
    t, p_pad, p_cnt = prep_inputs
    args = (t["ids"], t["chan"], t["tab"], p_pad, p_cnt)
    got = segment.fit_iteration_moments(*args, exact=exact)
    assert torch.equal(got, segment.fit_iteration_moments(*args, exact=exact))
    ref = segment.fit_iteration_moments_plain(*args, exact=exact)
    assert torch.equal(got[..., 0], ref[..., 0])
    assert float(got[..., 0].sum()) > 0
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


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
        "moment_sums": 1, "spfh": 1, "fpfh": 1, "nearest_neighbors2": 2,
        "consistency_graph": 1, "segment_sums": 1, "cross_histogram": 1,
        "fit_iteration_moments": 3, "classify_points": 1, "image_lookup": 1}
    assert bool(res.solution.valid)
