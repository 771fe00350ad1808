"""The port's CPU results do not depend on torch's thread count, and the
card's TEASER question has a fixture of its own.

- Thread counts: the descriptor distances of both NN plain versions
  (``ops/frontend.py::_ordered_dot``: one multiply and one add per
  component, in component order, as csrc/nn1.cu and csrc/nn2.cu take
  them) and the FPFH weighted sums (``fpfh_sums_plain``: column order)
  no longer go through a matrix product, whose summation order followed
  the BLAS blocking and thread count: through matrix products the level_a
  pair at 1024 voxels kept 194, 9 and 12 correspondences at 1, 2 and 6
  threads. Now the descriptors and the correspondence set are identical at
  all three. ``ops/neighbors.py::pairwise_sq_dists`` (3-D points, a
  K = 3 matrix product) gave the same bits at 1, 2 and 6 threads on every
  shape tried, so it keeps its matrix product.
- The segment sums' plain versions (B2's ``segment_sums_plain``, B9's
  ``fit_iteration_moments_plain``; the vote's histogram and Patchwork's
  plane fits take them) add through ``index_add_`` in the kernels' chunk
  order, where a one-hot matrix product's order followed the thread count,
  and B3's ``moment_sums_plain`` adds each row's terms in column order,
  where a row sum took the order of its vectorised tree: all give the
  same bits at 1, 2 and 6 threads, and so does Patchwork's ground mask.
- The ordered dot product equals an independent numpy evaluation in the
  same order bit for bit, so the plain top-2 is the kernels' arithmetic.
- ``utils/fused.atan2``, the arctangent both devices evaluate in the same
  torch operations, equals the JAX package's compiled CPU arctan2 (the C
  library's atan2f) bit for bit, over many scales and on the axes.
- TEASER on the JAX package's own path B correspondences
  (tests/torch_teaser_path_b.npz): the port's pose within 1.3e-5 of the
  JAX package's (measured 1.5e-6), at every thread count.

The fixture's recipe, on the CPU with the JAX package: the seed-11
HDL-64E pair of tests/test_pipeline.py (``make_scan_pair(seed=11,
yaw_deg=20.0, translation=(2.5, 1.0, 0.05))``, capacity 131072) through
``quatro_tpu.pipeline.register_scan_pair`` under
``PipelineConfig(max_voxels=8192,
fpfh=FPFHConfig(crosscheck_min_matches=0))`` (chip_smoke.py's path B);
its correspondences' ``src_xyz``, ``tgt_xyz`` and ``mask`` (711 valid of
1024), the solution's ``transform()`` as ``default_pose``, and
``register_correspondences`` on the correspondences under the solver
config with ``reg_name="TEASER"``, its ``transform()`` as ``teaser_pose``;
saved with ``np.savez_compressed``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quatro_tpu.io.synthetic import make_correspondences
from quatro_tpu.ops import pallas_frontend as jpf

from quatro_tpu_torch.config import LidarConfig, PipelineConfig
from quatro_tpu_torch.io.synthetic import make_scan_pair
from quatro_tpu_torch.ops import frontend as tf
from quatro_tpu_torch.ops import segment
from quatro_tpu_torch.ops.matching import match_features
from quatro_tpu_torch.ops.voxel import voxel_downsample
from quatro_tpu_torch.preprocessing.patchwork import estimate_ground
from quatro_tpu_torch.solver import vote
from quatro_tpu_torch.solver.scale import tim_consistency_graph
from quatro_tpu_torch.pipeline import extract_features
from quatro_tpu_torch.solver.quatro import register_correspondences
from quatro_tpu_torch.utils import fused

THREADS = (1, 2, 6)
FIXTURE = Path(__file__).resolve().parent / "torch_teaser_path_b.npz"


@pytest.fixture(autouse=True)
def _restore_threads():
    prev = torch.get_num_threads()
    yield
    torch.set_num_threads(prev)


def _at_each_thread_count(fn):
    out = []
    for t in THREADS:
        torch.set_num_threads(t)
        out.append(fn())
    return out


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def level_a_scans():
    """The level_a VLP-16 pair after the crude ground strip, as (2, 32768,
    3) points and (2, 32768) masks."""
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
def level_a_raw():
    """The raw level_a VLP-16 pair (no ground strip), as (2, 32768, 3)
    points and (2, 32768) masks."""
    pair = make_scan_pair(seed=101, yaw_deg=38.0,
                          translation=(2.5, -1.2, 0.04),
                          lidar=LidarConfig.preset("VLP-16"))
    pts = torch.zeros(2, 32768, 3)
    masks = torch.zeros(2, 32768, dtype=torch.bool)
    for b, xyz in enumerate(pair[:2]):
        pts[b, :len(xyz)], masks[b, :len(xyz)] = torch.from_numpy(xyz), True
    return pts, masks


def test_correspondences_repeat_across_thread_counts(level_a_scans):
    """extract_features and match_features on the level_a pair at 1024
    voxels: descriptors and the correspondence set identical at 1, 2 and
    6 threads."""
    cfg = PipelineConfig.for_lidar("VLP-16", max_voxels=1024)

    def run():
        vox, desc, dmask, _ = extract_features(*level_a_scans, cfg,
                                               device="cpu")
        corr = match_features(vox.points[0], vox.points[1], desc[0], desc[1],
                              dmask[0], dmask[1],
                              capacity=cfg.fpfh.max_correspondences,
                              device="cpu")
        return desc, corr

    (d1, c1), *rest = _at_each_thread_count(run)
    assert int(c1.mask.sum()) >= 100
    for desc, corr in rest:
        assert torch.equal(desc, d1)
        assert _same(corr, c1)


@pytest.mark.parametrize("nb", [4096, 3000])
def test_nearest_neighbors_repeat_across_thread_counts(nb):
    """Both NN wrappers on random 33-D descriptors (two column chunks, and
    one ragged chunk): identical outputs at 1, 2 and 6 threads, and the
    1-NN equal to the top-2's first slot."""
    rng = np.random.default_rng(nb)
    da = torch.from_numpy(rng.uniform(0, 12, (2, 700, 33)).astype(np.float32))
    db = torch.from_numpy(rng.uniform(0, 12, (2, nb, 33)).astype(np.float32))
    ma = torch.from_numpy(rng.uniform(size=(2, 700)) > 0.1)
    mb = torch.from_numpy(rng.uniform(size=(2, nb)) > 0.1)

    def run():
        return (tf.nearest_neighbors2(da, db, ma, mb),
                tf.nearest_neighbors(da, db, ma, mb))

    (top2, nn1), *rest = _at_each_thread_count(run)
    for t2, n1 in rest:
        assert _same(t2, top2) and _same(n1, nn1)
    assert torch.equal(nn1[0], top2[0]) and torch.equal(nn1[1], top2[1])


def test_ordered_dot_is_the_kernels_arithmetic():
    """_ordered_dot equals a numpy f32 evaluation from 0 with one multiply
    and one add per component in component order, bit for bit, and
    _chunk_d2 the expansion max((|a|^2 - 2 dot) + |b|^2, 0) on top."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 12, (300, 33)).astype(np.float32)
    b = rng.uniform(0, 12, (500, 33)).astype(np.float32)
    dot = np.zeros((300, 500), np.float32)
    for k in range(33):
        dot = dot + a[:, k, None] * b[None, :, k]
    got = tf._ordered_dot(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), dot)
    sq_a = (a * a).sum(1, dtype=np.float32)
    sq_b = (b * b).sum(1, dtype=np.float32)
    ones_a = np.ones((1, 300), np.float32)
    ones_b = np.ones((1, 500), np.float32)
    d2 = tf._chunk_d2(*(torch.from_numpy(x) for x in (
        a[None], b[None], ones_a, ones_b, sq_a[None], sq_b[None])), 0, 0, 500,
        (300, 500))
    ref = np.maximum((sq_a[:, None] - np.float32(2) * dot) + sq_b[None, :],
                     np.float32(0))
    np.testing.assert_array_equal(d2.numpy(), ref)


def test_teaser_on_jax_path_b_correspondences():
    """The port's TEASER (and its default solver) on the JAX package's own
    path B correspondences: valid, and within 1.3e-5 of the JAX package's
    poses in every entry of the 4x4 transform, at 1, 2 and 6 threads."""
    z = np.load(FIXTURE)
    assert int(z["mask"].sum()) == 711
    solver = PipelineConfig(max_voxels=8192).solver
    args = (z["src_xyz"], z["tgt_xyz"], z["mask"])
    for name, sc in (("teaser_pose",
                      dataclasses.replace(solver, reg_name="TEASER")),
                     ("default_pose", solver)):
        for sol in _at_each_thread_count(
                lambda: register_correspondences(*args, sc, device="cpu")):
            assert bool(sol.valid)
            err = float(np.abs(sol.transform().numpy() - z[name]).max())
            assert err <= 1.3e-5, (name, err)


def test_fused_atan2_is_the_jax_packages_arctan2():
    """fused.atan2 against the JAX package's compiled arctan2 on the CPU,
    bit for bit: 1.2 M random legs over 36 decades, the signed zeros, the
    axes, and ratios at fdlibm's reduction thresholds (7/16, 11/16, 19/16,
    39/16, 2**25) and their neighbours."""
    rng = np.random.default_rng(31)
    y, x = (rng.normal(0, 1, (2, 1_200_000))
            * np.exp(rng.uniform(-40, 40, (2, 1_200_000)))).astype(np.float32)
    axes = np.float32([0.0, -0.0, 1.0, -1.0, 2.5, -3.0, 1e-30, -1e30])
    ya, xa = (g.ravel() for g in np.meshgrid(axes, axes))
    ratios = np.float32([7 / 16, 11 / 16, 19 / 16, 39 / 16, 2.0 ** 25])
    ratios = np.concatenate([np.nextafter(ratios, np.float32(0)), ratios,
                             np.nextafter(ratios, np.float32(1e9))])
    base = rng.uniform(0.5, 2.0, 2000).astype(np.float32)
    yr = np.concatenate([base * r for r in ratios]
                        + [-base * r for r in ratios])
    xr = np.concatenate([base] * len(ratios) + [-base] * len(ratios))
    y = np.concatenate([y, ya, yr])
    x = np.concatenate([x, xa, xr])
    ref = np.asarray(jax.jit(jnp.arctan2)(jnp.asarray(y), jnp.asarray(x)))
    got = fused.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def _patchwork_like(seed, n=131072, p_pad=512, p_cnt=504):
    """B9's shape on two clouds: ids in runs of one patch (as scan order
    gives them), a dump patch p_cnt filling the tail, a few ids out of
    range on both sides; channels and a table with real normals."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 200, n)
    ids = np.repeat(rng.integers(-2, p_pad + 2, n), runs)[:2 * n]
    ids = ids.reshape(2, n).astype(np.int32)
    ids[:, -20000:] = p_cnt
    chan = rng.normal(0, 8, (2, 5, n)).astype(np.float32)
    nrm = rng.normal(0, 0.1, (2, p_pad, 3)) + [0, 0, 1]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tab = np.concatenate([nrm, rng.normal(0, 4, (2, p_pad, 2))], -1)
    tab[:, p_cnt:] = 0.0
    return (torch.from_numpy(ids), torch.from_numpy(chan),
            torch.from_numpy(tab.astype(np.float32)), p_pad, p_cnt)


def test_segment_sums_repeat_across_thread_counts():
    """At B9's shape (131072 ids, 512 patches, 10 channels): B2's plain
    sums, B9's plain moments under both flags, and the vote's histogram and
    yaw on a correspondence set, identical at 1, 2 and 6 threads."""
    ids, chan, tab, p_pad, p_cnt = _patchwork_like(5)
    vals = torch.from_numpy(np.random.default_rng(6).normal(
        0, 10, (10, ids.shape[1])).astype(np.float32))
    src, tgt, _, _ = make_correspondences(seed=2, n_inliers=200,
                                          n_outliers=824)
    src, tgt = torch.from_numpy(src), torch.from_numpy(tgt)
    mask = torch.ones(src.shape[0], dtype=torch.bool)
    adj = tim_consistency_graph(src, tgt, mask, 0.3, 1.0)

    def run():
        v_ids, v_vals = vote.yaw_vote_entries(src, tgt, mask, adj)
        return (segment.segment_sums_plain(ids[0], vals, p_pad,
                                           segment.FIT_CHUNK),
                segment.fit_iteration_moments_plain(ids, chan, tab, p_pad,
                                                    p_cnt, exact=True),
                segment.fit_iteration_moments_plain(ids, chan, tab, p_pad,
                                                    p_cnt, exact=False),
                segment.segment_sums(v_ids, v_vals, 256),
                vote.yaw_vote(src, tgt, mask, adj, num_modes=2))

    first, *rest = _at_each_thread_count(run)
    assert float(first[1][..., 0].sum()) > 0 and float(first[3].sum()) > 0
    for other in rest:
        assert _same(other, first)


def test_patchwork_ground_repeats_across_thread_counts(level_a_raw):
    """estimate_ground on the raw level_a pair: the ground, non-ground and
    dropped masks identical at 1 and 6 threads."""
    cfg = PipelineConfig.for_lidar("VLP-16").patchwork
    results = []
    for t in (1, 6):
        torch.set_num_threads(t)
        results.append(estimate_ground(*level_a_raw, cfg))
    a, b = results
    assert int(a.ground.sum()) > 0
    for field in ("ground", "nonground", "dropped"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_moment_sums_repeat_across_thread_counts(level_a_scans):
    """moment_sums_plain on the level_a voxels at V = 2048 (with holes):
    the same bits at 1, 2 and 6 threads, and within the f32
    summation-order bound of tests/test_torch_frontend.py (rtol 1e-5, atol
    1e-4) of the JAX package's moment_sums_pallas (interpret)."""
    cfg = PipelineConfig.for_lidar("VLP-16", max_voxels=2048)
    vox = [voxel_downsample(p, m, cfg.voxel_size, 2048,
                            active_cap=cfg.max_segment_points)
           for p, m in zip(*level_a_scans)]
    pts = torch.stack([v[0] for v in vox]).contiguous()
    maskf = torch.stack([v[1] for v in vox]).float()
    maskf[:, ::89] = 0.0
    r = cfg.fpfh.normal_radius
    first, *rest = _at_each_thread_count(
        lambda: tf.moment_sums_plain(pts, maskf, r))
    for other in rest:
        assert torch.equal(other, first)
    for b in range(2):
        ref = np.asarray(jpf.moment_sums_pallas(
            jnp.asarray(pts[b].numpy()), jnp.asarray(maskf[b].numpy()), r,
            interpret=True))[:, :10]
        np.testing.assert_allclose(first[b].numpy(), ref, rtol=1e-5,
                                   atol=1e-4)
    assert float(first[..., 0].max()) > 5
