"""Synthetic scenes, prefix sums and voxel downsampling: the port against
the JAX package on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io import synthetic as jsyn
from quatro_tpu.ops.neighbors import pairwise_sq_dists as jax_sq_dists
from quatro_tpu.ops.voxel import voxel_downsample as jax_voxel
from quatro_tpu.utils import se3 as jse3

import quatro_tpu_torch.config as tcfg
from quatro_tpu_torch.io import synthetic as tsyn
from quatro_tpu_torch.ops.neighbors import pairwise_sq_dists
from quatro_tpu_torch.ops.voxel import voxel_downsample as torch_voxel
from quatro_tpu_torch.utils import se3 as tse3
from quatro_tpu_torch.utils.scan import prefix_sum


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


PAIR = dict(seed=101, yaw_deg=38.0, translation=(2.5, -1.2, 0.04))


@pytest.fixture(scope="module")
def vlp16_pair():
    return jsyn.make_scan_pair(lidar=jcfg.LidarConfig.preset("VLP-16"),
                               **PAIR)


def test_make_scan_pair_bit_identical(vlp16_pair):
    mine = tsyn.make_scan_pair(lidar=tcfg.LidarConfig.preset("VLP-16"),
                               **PAIR)
    for a, b in zip(vlp16_pair, mine):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
def test_make_correspondences_bit_identical(seed):
    kw = dict(seed=seed, n_inliers=40, n_outliers=360, yaw_deg=63.0,
              translation=(4.0, -2.5, 0.4), roll_pitch=(0.02, -0.03))
    for a, b in zip(jsyn.make_correspondences(**kw),
                    tsyn.make_correspondences(**kw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [5, 17, 4999, 32768])
def test_prefix_sum_matches_jax_cumsum_bits(n):
    x = np.random.default_rng(n).uniform(0, 1, (3, n)).astype(np.float32)
    np.testing.assert_array_equal(
        prefix_sum(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))


def _packed(xyz, cap):
    pts = np.zeros((cap, 3), np.float32)
    mask = np.zeros(cap, bool)
    k = min(len(xyz), cap)
    pts[:k], mask[:k] = xyz[:k], True
    return pts, mask


# (input capacity, voxel capacity, active_cap): the second binds both
# the active-point cap and the voxel capacity.
@pytest.mark.parametrize("cap,vcap,active", [(32768, 4096, 32768),
                                             (32768, 1024, 4096)])
def test_voxel_downsample_matches(vlp16_pair, cap, vcap, active):
    src = vlp16_pair[0]
    src = src[src[:, 2] > -1.723 + 0.3]
    pts, mask = _packed(src, cap)
    jp, jm = jax_voxel(jnp.asarray(pts), jnp.asarray(mask), 0.3, vcap,
                       active_cap=active)
    tp, tm = torch_voxel(torch.from_numpy(pts), torch.from_numpy(mask), 0.3,
                         vcap, active_cap=active)
    jm = np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    if active < int(mask.sum()):
        assert jm.all()                # the capacity cut binds
    # same slot order, centroids equal to f32 rounding at ~30 m
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)


def test_voxel_guard_raises():
    with pytest.raises(ValueError):
        torch_voxel(torch.zeros((1 << 17) + 1, 3),
                    torch.zeros((1 << 17) + 1, dtype=torch.bool), 0.3, 64)


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(4)
    theta = rng.uniform(-np.pi, np.pi, 8).astype(np.float32)
    rots = [np.array(jse3.yaw_to_rotation(jnp.asarray(t))) for t in theta]
    for t, ref in zip(theta, rots):
        np.testing.assert_allclose(
            tse3.yaw_to_rotation(torch.tensor(t)).numpy(), ref, atol=1e-7)
    pts = rng.uniform(-80, 80, (500, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.rotate_points(torch.from_numpy(pts),
                           torch.from_numpy(rots[0])).numpy(),
        np.asarray(jse3.rotate_points(jnp.asarray(pts),
                                      jnp.asarray(rots[0]))),
        rtol=0, atol=1e-5)
    for r1, r2 in zip(rots, rots[1:]):
        np.testing.assert_allclose(
            float(tse3.rotation_geodesic_error(torch.from_numpy(r1),
                                               torch.from_numpy(r2))),
            float(jse3.rotation_geodesic_error(jnp.asarray(r1),
                                               jnp.asarray(r2))),
            rtol=1e-5, atol=1e-6)


def test_pairwise_sq_dists_matches_jax():
    """The Gram-identity distances: equal up to the expansion's rounding,
    a few ulps of |a|^2 + |b|^2."""
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 30, (300, 33)).astype(np.float32)
    b = rng.uniform(0, 30, (200, 33)).astype(np.float32)
    b[:10] = a[:10]                     # exact duplicates: d2 clamps at 0
    got = pairwise_sq_dists(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_sq_dists(jnp.asarray(a), jnp.asarray(b)))
    scale = (a * a).sum(1).max() + (b * b).sum(1).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)
    assert (got >= 0).all()
