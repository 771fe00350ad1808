"""The front end's four kernels: the port against the JAX package's Pallas
kernels, run in interpret mode as the JAX package's own tests run them.

Inputs are the voxelised VLP-16 source scan of golden spec ``level_a`` at
V = 2048 (a 4 x 2 grid of the Pallas 512 x 1024 tiles, so the tile skips
are exercised) and random 33-D descriptors at Na = 512, Nb = 4096 (a 2 x 2
grid of the top-2 kernel). On the CPU the port's wrappers run their plain
versions (the CUDA kernels are held against those plain versions on the
card by tests/test_torch_kernels_gpu.py).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io import synthetic as jsyn
from quatro_tpu.ops import pallas_frontend as jpf
from quatro_tpu.ops.dense_features import dense_fpfh as jax_dense_fpfh
from quatro_tpu.ops.dense_features import dense_normals as jax_dense_normals
from quatro_tpu.ops.voxel import voxel_downsample as jax_voxel

from quatro_tpu_torch.ops import frontend as tf
from quatro_tpu_torch.ops.dense_features import dense_fpfh, dense_normals

V = 2048
CFG = jcfg.PipelineConfig.for_lidar("VLP-16", max_voxels=V)
NORMAL_R = CFG.fpfh.normal_radius
FPFH_R = CFG.fpfh.fpfh_radius


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cloud():
    """(V, 3) voxel centroids and (V,) mask of the level_a source scan."""
    src, _, _ = jsyn.make_scan_pair(
        seed=101, yaw_deg=38.0, translation=(2.5, -1.2, 0.04),
        lidar=jcfg.LidarConfig.preset("VLP-16"))
    src = src[src[:, 2] > -1.723 + 0.3]
    pts = np.zeros((32768, 3), np.float32)
    mask = np.zeros(32768, bool)
    pts[:len(src)], mask[:len(src)] = src, True
    vp, vm = jax_voxel(jnp.asarray(pts), jnp.asarray(mask), CFG.voxel_size, V,
                       active_cap=CFG.max_segment_points)
    vp, vm = np.array(vp), np.array(vm)
    # Keep 1000 slots and a few holes: the empty tail makes the Pallas
    # kernels skip row tiles and column chunks past the last valid slot.
    vm[1000:] = False
    vm[::97] = False
    vp[~vm] = 0.0
    return vp, vm


@pytest.fixture(scope="module")
def jax_normals(cloud):
    vp, vm = cloud
    n = jpf.frontend_normals(jnp.asarray(vp), jnp.asarray(vm), NORMAL_R,
                             interpret=True)
    return tuple(np.asarray(t) for t in n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_moments_close(got, ref):
    # f32 sums in another order: rtol 1e-5, atol 1e-4
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def _assert_spfh_close(hist, cnt, ref_hist, ref_cnt):
    """Pair counts equal; bins equal except f1 bin-edge flips (the Pallas
    kernel bins f1 by sector tests, the port by atan2) on < 0.5% of rows."""
    np.testing.assert_array_equal(cnt, ref_cnt)
    flipped = (hist != ref_hist).any(axis=1).mean()
    assert flipped < 0.005, f"bin-edge flips on {flipped:.2%} of rows"


def _assert_fpfh_close(got, ref):
    """The bounds of tests/test_pallas_frontend.py: mean |diff| < 0.02 and
    < 2% of rows off by more than 1.0 in some bin."""
    diff = np.abs(got - ref)
    assert diff.mean() < 0.02, f"mean descriptor diff {diff.mean()}"
    affected = (diff.max(axis=1) > 1.0).mean()
    assert affected < 0.02, f"bin-edge flips touched {affected:.1%} of rows"


def _assert_nn2_close(got, ref, scale, planted=()):
    """i1 equal wherever the top-2 gap is clear (d2 - d1 > 1e-4 d1) and
    distances within rtol 1e-5, plus an absolute 1e-6 of ``scale`` (the
    largest |a|^2 + |b|^2): the expansion |a|^2 - 2a.b + |b|^2 carries a
    rounding error of a few ulps of that, which is all there is of a
    distance between equal descriptors. The planted exact duplicates pin
    both slots' indices (the tie rule)."""
    i1, d1, i2, d2 = got
    ri1, rd1, ri2, rd2 = ref
    np.testing.assert_allclose(d1, rd1, rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(d2, rd2, rtol=1e-5, atol=1e-6 * scale)
    clear = rd2 - rd1 > 1e-4 * rd1
    np.testing.assert_array_equal(i1[clear], ri1[clear])
    for row in planted:
        assert (i1[row], i2[row]) == (ri1[row], ri2[row]), row


def test_moment_sums_match_pallas(cloud):
    vp, vm = cloud
    maskf = vm.astype(np.float32)
    ref = np.asarray(jpf.moment_sums_pallas(jnp.asarray(vp),
                                            jnp.asarray(maskf), NORMAL_R,
                                            interpret=True))[:, :10]
    got = tf.moment_sums(_t(vp)[None], _t(maskf)[None], NORMAL_R)[0].numpy()
    _assert_moments_close(got, ref)


def _well_conditioned(vp, vm, radius):
    """Rows whose normal is a well-posed function of the points, from a
    float64 PCA of each radius neighbourhood: the two smallest eigenvalues
    apart by > 1% of the largest, and the point off the tangent plane
    through the viewpoint by > 0.1% of its range (else the orientation
    flip is decided by rounding). Elsewhere (three nearly collinear
    neighbours are common in sparse VLP-16 voxels) an ulp in the moments
    or in acos/cos turns the normal freely, and the JAX package's two
    front ends agree there only because they share one eigensolver."""
    p = vp.astype(np.float64)
    d = p[:, None, :] - p[None, :, :]
    a = ((d * d).sum(-1) <= np.float32(radius * radius)) & vm[:, None] \
        & vm[None, :]
    cnt = np.maximum(a.sum(1), 1)[:, None, None]
    mean = np.einsum("ij,ijk->ik", a, d)[:, :, None] / cnt
    cov = np.einsum("ij,ijk,ijl->ikl", a, d, d) / cnt - mean * mean.transpose(
        0, 2, 1)
    lam, vec = np.linalg.eigh(cov)
    gap = (lam[:, 1] - lam[:, 0]) / np.maximum(lam[:, 2], 1e-30)
    side = np.abs((vec[:, :, 0] * p).sum(1)) / np.maximum(
        np.linalg.norm(p, axis=1), 1e-9)
    return vm & (gap > 1e-2) & (side > 1e-3)


def _assert_normals_close(got, ref, cond):
    """Same validity; curvature within 1e-3 everywhere; normals within
    1e-4 on the well-conditioned rows, which must be most rows."""
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_allclose(got.curvature, ref.curvature, atol=1e-3)
    cond = cond & ref.valid
    assert cond.sum() > 0.6 * ref.valid.sum()
    np.testing.assert_allclose(got.normals[cond], ref.normals[cond], atol=1e-4)


def _np(normals):
    """(normals, curvature, valid) as numpy arrays under those names."""
    return SimpleNamespace(**{k: np.asarray(t) for k, t in zip(
        ("normals", "curvature", "valid"), normals)})


def test_frontend_normals_match_pallas(cloud, jax_normals):
    vp, vm = cloud
    got = tf.frontend_normals(_t(vp)[None], _t(vm)[None], NORMAL_R)
    _assert_normals_close(_np([t[0] for t in got]), _np(jax_normals),
                          _well_conditioned(vp, vm, NORMAL_R))


def test_spfh_matches_pallas(cloud, jax_normals):
    vp, vm = cloud
    nrm, _, nvalid = jax_normals
    pmf = (vm & nvalid).astype(np.float32)
    ref_h, ref_c = jpf.spfh_pallas(jnp.asarray(vp), jnp.asarray(nrm),
                                   jnp.asarray(pmf), FPFH_R, interpret=True)
    hist, cnt = tf.spfh(_t(vp)[None], _t(nrm)[None], _t(pmf)[None], FPFH_R)
    assert np.asarray(ref_c).sum() > 10 * V      # dense enough to matter
    _assert_spfh_close(hist[0].numpy(), cnt[0].numpy(), np.asarray(ref_h),
                       np.asarray(ref_c))


def test_frontend_fpfh_matches_pallas(cloud, jax_normals):
    vp, vm = cloud
    nrm, _, nvalid = jax_normals
    ref = jpf.frontend_fpfh(jnp.asarray(vp), jnp.asarray(nrm),
                            jnp.asarray(nvalid), jnp.asarray(vm), FPFH_R,
                            interpret=True)
    got = tf.frontend_fpfh(_t(vp)[None], _t(nrm)[None], _t(nvalid)[None],
                           _t(vm)[None], FPFH_R)
    _assert_fpfh_close(got[0].numpy(), np.asarray(ref))


def test_dense_path_matches_jax_dense(cloud):
    vp, vm = cloud
    ref_n = jax_dense_normals(jnp.asarray(vp), jnp.asarray(vm), NORMAL_R)
    got_n = dense_normals(_t(vp), _t(vm), NORMAL_R)
    _assert_normals_close(_np(got_n), _np(ref_n),
                          _well_conditioned(vp, vm, NORMAL_R))
    nrm, nvalid = np.asarray(ref_n.normals), np.asarray(ref_n.valid)
    ref = jax_dense_fpfh(jnp.asarray(vp), jnp.asarray(nrm),
                         jnp.asarray(nvalid), jnp.asarray(vm), FPFH_R)
    got = dense_fpfh(_t(vp), _t(nrm), _t(nvalid), _t(vm), FPFH_R)
    _assert_fpfh_close(got.numpy(), np.asarray(ref))


def test_dense_path_refuses_tensors_off_the_cpu():
    """The dense path is plain PyTorch and CPU-only; the meta device stands
    in for the card here."""
    pts = torch.zeros(1, 64, 3, device="meta")
    msk = torch.ones(1, 64, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CPU only"):
        dense_normals(pts, msk, NORMAL_R)
    with pytest.raises(ValueError, match="CPU only"):
        dense_fpfh(pts, pts, msk, msk, FPFH_R)


def _descriptors(na=512, nb=4096, seed=5):
    """Random descriptors with planted exact duplicates: B column 3000
    copies column 100 (a tie across chunks) and column 101 copies column
    100 (a tie inside a chunk); A rows 0..19 copy column 100 (both slots
    tied), rows 20..29 copy column 7 (one match, then the nearest other)."""
    rng = np.random.default_rng(seed)
    da = rng.uniform(0, 100, (na, 33)).astype(np.float32)
    db = rng.uniform(0, 100, (nb, 33)).astype(np.float32)
    db[3000] = db[100]
    db[101] = db[100]
    da[:20] = db[100]
    da[20:30] = db[7]
    ma = rng.uniform(size=na) > 0.1
    mb = rng.uniform(size=nb) > 0.1
    ma[:30] = True
    mb[[7, 100, 101, 3000]] = True
    return da, db, ma, mb


def _scale(da, db):
    return float((da * da).sum(1).max() + (db * db).sum(1).max())


def test_nearest_neighbors2_matches_pallas():
    da, db, ma, mb = _descriptors()
    ref = [np.asarray(x) for x in jpf.nearest_neighbors2_pallas(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
        interpret=True)]
    got = [x[0].numpy() for x in tf.nearest_neighbors2(
        _t(da)[None], _t(db)[None], _t(ma)[None], _t(mb)[None])]
    _assert_nn2_close(got, ref, _scale(da, db), planted=range(30))
    # Three equal columns 100, 101 (chunk 0) and 3000 (chunk 1): the first
    # slot stays with the earliest, but the strict-less merge of the Pallas
    # kernel hands the second slot to the later chunk's tied loser.
    assert (got[0][:20] == 100).all() and (got[2][:20] == 3000).all()
    # invalid rows: index 0 / f32 max on both slots
    assert (got[0][~ma] == 0).all()
    assert (got[1][~ma] == np.finfo(np.float32).max).all()


def test_nearest_neighbors2_one_valid_column():
    """With a single valid column the second slot is index 0 / f32 max."""
    rng = np.random.default_rng(9)
    da = rng.uniform(0, 100, (256, 33)).astype(np.float32)
    db = rng.uniform(0, 100, (2048, 33)).astype(np.float32)
    ma = rng.uniform(size=256) > 0.1
    mb = np.arange(2048) == 5
    i1, d1, i2, d2 = (x[0].numpy() for x in tf.nearest_neighbors2(
        _t(da)[None], _t(db)[None], _t(ma)[None], _t(mb)[None]))
    assert (i1[ma] == 5).all() and (d1[ma] < np.finfo(np.float32).max).all()
    assert (i2 == 0).all() and (d2 == np.finfo(np.float32).max).all()


def test_wrappers_reject_bad_inputs():
    pts = torch.zeros(1, 512, 3)
    with pytest.raises(TypeError):
        tf.moment_sums(pts.double(), torch.ones(1, 512), 1.0)
    with pytest.raises(ValueError):
        tf.moment_sums(pts, torch.ones(1, 256), 1.0)
    with pytest.raises(ValueError):
        tf.moment_sums(pts.transpose(1, 2).contiguous().transpose(1, 2),
                       torch.ones(1, 512), 1.0)
    d = torch.zeros(1, 256, 33)
    m = torch.ones(1, 256, dtype=torch.bool)
    with pytest.raises(ValueError):     # masks of another length
        tf.nearest_neighbors2(d, d, m, torch.ones(1, 128, dtype=torch.bool))
    before = dict(tf.LAUNCHES)
    tf.nearest_neighbors2(d, d, m, m)
    assert tf.LAUNCHES == before        # the plain version launches nothing


def test_nearest_neighbors2_ragged_columns_take_one_chunk():
    """Nb = 3072 is no multiple of 2048: the JAX package then takes its XLA
    top-2 (lax.top_k over all columns, ties to the lower index), and so
    does the port, as one chunk. With integer descriptors below 100 the
    distances are exact f32 integers, so the order is (distance, index)."""
    da, db, ma, mb = _descriptors(na=256, nb=3072, seed=11)
    da, db = np.round(da), np.round(db)
    db[2500] = db[100]                  # a tie 2400 columns apart
    da[:5] = db[100]
    i1, d1, i2, d2 = (x[0].numpy() for x in tf.nearest_neighbors2(
        _t(da)[None], _t(db)[None], _t(ma)[None], _t(mb)[None]))
    exact = ((da[:, None, :].astype(np.float64) - db[None]) ** 2).sum(-1)
    exact[:, ~mb] = np.inf
    order = np.argsort(exact, axis=1, kind="stable")
    rows = np.nonzero(ma)[0]
    np.testing.assert_array_equal(i1[rows], order[rows, 0])
    np.testing.assert_array_equal(i2[rows], order[rows, 1])
    assert (i1[:5] == 100).all() and (i2[:5] == 101).all()
