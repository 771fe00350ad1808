"""Stages of the port that take the JAX package's compiled arithmetic on the
CPU, bit for bit (ROADMAP C 12 and the covariances; where the sequence
loop still rounds apart, tests/torch_sequence_stages.py says):

- ``utils/fused.xla_sum``: XLA:CPU's order of a long sum (windows of 32
  added one after the other, repeated), against ``jnp.sum``;
- the covariances that the dense normals hand their eigen solve
  (``dense_moment_sums``, ``centered_covariance``), against the ones the
  JAX package's dense_normals, compiled as it stands, hands its own
  (recorded from inside the compiled code);
- Patchwork's CZM sectors, the range image's rows and columns and the scan
  metadata's orientations on points placed a few ulps either side of their
  angle edges: ``utils/fused.atan2`` is the JAX package's arctangent.

Every comparison is exact: no tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.ops.dense_features as jdf
from quatro_tpu.preprocessing import metadata as jmd
from quatro_tpu.preprocessing import patchwork as jpw
from quatro_tpu.preprocessing import projection as jpr

import quatro_tpu_torch as qt
import quatro_tpu_torch.ops.normals as tnm
from quatro_tpu_torch.ops.dense_features import dense_normals
from quatro_tpu_torch.ops.voxel import voxel_downsample
from quatro_tpu_torch.preprocessing import metadata as tmd
from quatro_tpu_torch.preprocessing import patchwork as tpw
from quatro_tpu_torch.preprocessing import projection as tpr
from quatro_tpu_torch.utils import fused

from golden_specs import GOLDEN_SPECS, RAW_CAPACITY, build_config, build_pair


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def level_a():
    """(points (2, N, 3), crude-strip masks (2, N), JAX config, port
    config) of the level_a VLP-16 pair."""
    spec = next(s for s in GOLDEN_SPECS if s["name"] == "level_a")
    pts = np.zeros((2, RAW_CAPACITY, 3), np.float32)
    masks = np.zeros((2, RAW_CAPACITY), bool)
    for b, xyz in enumerate(build_pair(spec)[:2]):
        pts[b, :len(xyz)] = xyz
        masks[b, :len(xyz)] = xyz[:, 2] > -1.723 + 0.3
    jc = build_config(spec)
    return pts, masks, jc, qt.config_from_dict(dataclasses.asdict(jc))


def _t(x):
    return torch.from_numpy(np.array(x))


def _same_bits(got, ref):
    """Equal values; f32 arrays equal bit for bit."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if ref.dtype == np.float32:
        assert got.dtype == np.float32
        got, ref = got.view(np.int32), ref.view(np.int32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [1, 31, 32, 64, 1024, 2048, 8192])
def test_xla_sum_is_the_jax_packages_sum(n):
    """Terms of mixed sign over eight decades, where every order of the
    additions gives other bits: equal to the compiled ``jnp.sum`` over the
    last axis, at the lengths whose levels are multiples of 32 or at most
    32 (the docstring of ``xla_sum``)."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(7, n)) * 10.0 ** rng.integers(-4, 4, (7, n))
         ).astype(np.float32)
    ref = jax.jit(lambda a: jnp.sum(a, axis=-1))(jnp.asarray(x))
    _same_bits(fused.xla_sum(_t(x)).numpy(), ref)


def _eigen_inputs(monkeypatch, module, jax_side):
    """Record the six covariance entries that each call of ``module``'s
    smallest_eigenpair_sym3 gets (the JAX package's through a host
    callback inside its compiled code), in call order."""
    seen = []
    orig = module.smallest_eigenpair_sym3

    def spy(*cov):
        if jax_side:
            jax.debug.callback(
                lambda *c: seen.append([np.asarray(x) for x in c]), *cov)
        else:
            seen.append([x.numpy() for x in cov])
        return orig(*cov)
    monkeypatch.setattr(module, "smallest_eigenpair_sym3", spy)
    return seen


def test_dense_normals_eigen_inputs_are_the_jax_packages(level_a,
                                                         monkeypatch):
    """The covariances that the port's dense_normals hands its eigen solve
    equal the ones that quatro_tpu/ops/dense_features.py::dense_normals,
    compiled as it stands (its moment sums in lax.map over 256-row tiles,
    then the covariance), hands its own, on the valid level_a voxels (2048,
    radius 0.5 m): the moment sums (``dense_moment_sums``) and the
    covariance (``centered_covariance``) take the package's arithmetic,
    and what the normals still differ by is the eigen solve's.

    JAX caches a trace by the Python function it traces, so a jit of
    ``dense_normals.__wrapped__`` itself reuses any trace of
    ``dense_normals`` made earlier in the process at the same shapes (as
    tests/test_torch_frontend.py makes one), and the spy is never traced.
    The JAX side therefore traces a fresh closure, which no earlier trace
    can serve."""
    pts, masks, jc, tc = level_a
    vp, vm = voxel_downsample(_t(pts[0]), _t(masks[0]), tc.voxel_size, 2048,
                              active_cap=tc.max_segment_points)
    radius = tc.fpfh.normal_radius
    ref = _eigen_inputs(monkeypatch, jdf, True)
    got = _eigen_inputs(monkeypatch, tnm, False)
    # a function object of its own, traced anew, so that the spy is traced in
    jax.jit(lambda p, m: jdf.dense_normals.__wrapped__(p, m, radius))(
        jnp.asarray(vp.numpy()), jnp.asarray(vm.numpy()))
    jax.effects_barrier()
    dense_normals(vp, vm, radius)
    assert len(ref) == 1 and len(got) == 1
    assert int(vm.sum()) > 1000
    for g, r in zip(got[0], ref[0]):
        _same_bits(g.reshape(-1), r)


def _edge_angles(edges_rad, ulps=4):
    """f32 angles 0, 1, ..., ``ulps`` f32 ulps either side of each edge
    (the ulps of 1e-3 rad around 0: XLA's CPU code flushes subnormal
    numbers to zero, and no scan holds coordinates of 1e-44 m)."""
    e = np.asarray(edges_rad, np.float32)[:, None]
    steps = np.arange(-ulps, ulps + 1, dtype=np.float32)
    ulp = np.spacing(np.maximum(np.abs(e), np.float32(1e-3)))
    return (e + steps * ulp).reshape(-1).astype(np.float64)


def _on_angle_edges(edges_rad, radius, z):
    """(N, 3) f32 points at ``radius`` and height ``z`` whose azimuths lie
    a few ulps either side of each edge angle."""
    t = _edge_angles(edges_rad)
    return np.stack([radius * np.cos(t), radius * np.sin(t),
                     np.full_like(t, z)], -1).astype(np.float32)


def test_czm_sectors_at_their_edges(level_a):
    """Points a few ulps either side of every CZM sector edge of every
    zone (C 12): every patch id and in-CZM flag equal to the JAX
    package's."""
    _, _, jc, tc = level_a
    cfg = tc.patchwork
    pts = []
    for k in range(cfg.num_zones):
        lo, hi = cfg.ring_boundaries[k], cfg.ring_boundaries[k + 1]
        n = cfg.num_sectors_each_zone[k]
        edges = 2 * np.pi * np.arange(n) / n
        edges = np.where(edges > np.pi, edges - 2 * np.pi, edges)
        pts.append(_on_angle_edges(edges, 0.5 * (lo + hi), -1.5))
    xyz = np.concatenate(pts)
    mask = np.ones(len(xyz), bool)
    ref = jax.jit(jpw.czm_bin, static_argnums=2)(jnp.asarray(xyz),
                                                 jnp.asarray(mask),
                                                 jc.patchwork)
    got = tpw.czm_bin(_t(xyz), _t(mask), cfg)
    assert len(xyz) > 1000
    for g, r in zip(got, ref):
        _same_bits(g.numpy(), r)


def test_range_image_at_its_angle_edges(level_a):
    """Points a few ulps either side of every column edge and of every row
    edge of the VLP-16 range image (C 12): rows, columns, ranges, pixels,
    the range image and owners equal to the compiled projection's."""
    _, _, jc, tc = level_a
    lidar = tc.lidar
    deg = np.pi / 180.0
    # column edges: -round((atan2(x, y) - 90 deg) / res_x) changes at half
    # steps, so at azimuth atan2(y, x) = -(k + 1/2) res_x
    cols = -(np.arange(0, lidar.horizon_scan, 37) + 0.5) * lidar.ang_res_x
    ring = _on_angle_edges(np.deg2rad(cols), 8.0, 0.3)
    # row edges: elevation = k res_y - ang_bottom at azimuth 10 degrees
    elev = (np.arange(lidar.n_scan) * lidar.ang_res_y - lidar.ang_bottom)
    t = _edge_angles(elev * deg)
    rows = np.stack([9.0 * np.cos(t) * np.cos(10 * deg),
                     9.0 * np.cos(t) * np.sin(10 * deg), 9.0 * np.sin(t)],
                    -1).astype(np.float32)
    xyz = np.concatenate([ring, rows])
    mask = np.ones(len(xyz), bool)
    ref = jax.jit(lambda p, m: jpr.project_to_range_image(p, m, jc.lidar))(
        jnp.asarray(xyz), jnp.asarray(mask))
    got = tpr.project_to_range_image(_t(xyz)[None], _t(mask)[None], lidar)
    ref = [np.asarray(a) for a in ref]
    ref[5] = np.where(np.isinf(ref[5]), np.finfo(np.float32).max, ref[5])
    for g, r in zip(got, ref):
        _same_bits(g[0].numpy(), r)


@pytest.mark.parametrize("yaw_deg", [0.0, 33.0, 90.0, 181.0, 270.0])
def test_scan_metadata_orientations_are_the_jax_packages(level_a, yaw_deg):
    """The level_a source turned about z: the start and end orientations
    (and their difference) equal the JAX package's bit for bit (C 12)."""
    pts, masks, jc, tc = level_a
    c, s = np.cos(np.deg2rad(yaw_deg)), np.sin(np.deg2rad(yaw_deg))
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    xyz = (pts[0] @ rot.T).astype(np.float32)
    mask = masks[0]
    jproj = jpr.segment_cloud(jnp.asarray(xyz), jnp.asarray(mask), jc.lidar,
                              jc.projection, ground_mode="Patchwork")
    ref = jmd.compute_scan_metadata(jnp.asarray(xyz), jnp.asarray(mask),
                                    jproj, jc.lidar)
    tproj = tpr.segment_cloud(_t(xyz), _t(mask), tc.lidar, tc.projection,
                              ground_mode="Patchwork")
    got = tmd.compute_scan_metadata(_t(xyz), _t(mask), tproj, tc.lidar)
    for name in ("start_orientation", "end_orientation",
                 "orientation_diff"):
        _same_bits(getattr(got, name).numpy(), getattr(ref, name))
