"""The range-image projection's three kernels' plain versions
(ops/range_image.py: ``range_image``, ``edge_masks``, ``component_stats``)
on the CPU, against the JAX package and against models of the kernels'
own formulations.

- ``range_image`` (keys, one stable sort, owners) bit for bit the JAX
  package's compiled ``project_to_range_image`` on the seed-11 HDL-64E
  pair at capacity 131072 (every ring on a row edge), whole and with
  ``max_points`` prefixes; the kernel route's formulation (the int32 key
  less 2^31, owners written at run starts from the key and the sorted
  index, the sentinel word left empty) modelled in torch equals the plain
  version on the same pair, with NaN and inf points.
- ``edge_masks`` against the JAX package's ``_neighbor_edges`` and its
  composed 4CrossNeighbor masks under each neighbour mode, on the JAX
  package's range images of the HDL-64E and VLP-16 pairs: exact but on
  pixels next to a pair whose angle lies within 1e-6 rad of
  segment_theta_deg (``_knife_edge_pixels``; measured: none).
- ``component_stats`` against the JAX package's stats on its own labels
  (``label_components``), exactly, and against a numpy per-label oracle of
  the kernel's atomic formulation (np.bincount, np.maximum.at of R - row
  and of row + 1) on random label images with single-pixel components,
  full-height components, blobs and npix sentinels.
- the wrappers' input checks, and no launch counted on the CPU.

The kernels themselves are held against these plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io.synthetic import make_scan_pair as jax_scan_pair
from quatro_tpu.preprocessing import projection as jpr
from quatro_tpu.types import PointBatch as JaxPointBatch

import quatro_tpu_torch as qt
import quatro_tpu_torch.config as tcfg
from quatro_tpu_torch.ops import range_image as ri
from quatro_tpu_torch.ops.launch import LAUNCHES
from quatro_tpu_torch.preprocessing import projection as tpr

from test_torch_preprocessing import _knife_edge_pixels

MODES = ["4CrossNeighbor", "4Neighbor", "8Neighbor"]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hdl64():
    """The seed-11 HDL-64E pair of tests/test_pipeline.py at capacity
    131072, as numpy (2, N, 3) points and (2, N) masks."""
    clouds = [JaxPointBatch.from_numpy(xyz, capacity=131072) for xyz in
              jax_scan_pair(seed=11, yaw_deg=20.0,
                            translation=(2.5, 1.0, 0.05))[:2]]
    return (np.stack([np.asarray(c.points) for c in clouds]),
            np.stack([np.asarray(c.mask) for c in clouds]))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    nan = torch.isnan(a) if a.is_floating_point() else torch.zeros_like(
        a, dtype=torch.bool)
    return (a.dtype == b.dtype and torch.equal(nan, torch.isnan(b) if
                                               b.is_floating_point() else nan)
            and torch.equal(torch.where(nan, 0, a), torch.where(nan, 0, b)))


# ------------------------------------------------------------ projection --

@pytest.mark.parametrize("max_points", [None, 90000, 40000])
def test_range_image_plain_hdl64_bit_equal(hdl64, max_points):
    """Every output of the plain route (both clouds as one batch) equal to
    the JAX package's compiled projection of each cloud, with the owner
    scan over a max_points prefix (40000 drops pixels)."""
    pts, masks = hdl64
    lidar_j = jcfg.PipelineConfig().lidar
    proj = jax.jit(lambda p, m: jpr.project_to_range_image(
        p, m, lidar_j, max_points=max_points))
    got = ri.range_image_plain(torch.from_numpy(pts),
                               torch.from_numpy(masks),
                               qt.PipelineConfig().lidar, 0.1, max_points)
    for b in range(2):
        ref = [np.asarray(a) for a in proj(jnp.asarray(pts[b]),
                                           jnp.asarray(masks[b]))]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), r)
    print(f"max_points {max_points}: {int((got[6] >= 0).sum())} owned "
          "pixels")


def _specials(pts, masks):
    """NaN and inf coordinates in valid and masked points, and the last
    point of cloud 1 alone at the end of the range quantisation."""
    pts, masks = pts.copy(), masks.copy()
    pts[0, 3, 1] = np.nan
    pts[1, 5] = np.nan
    masks[1, 5] = False
    pts[0, 7, 0] = np.inf
    pts[1, 9, 2] = -np.inf
    pts[0, 11] = (np.inf, np.inf, 1.0)
    pts[1, -1] = (125.0, 0.4, 0.0)
    masks[1, -1] = True
    return torch.from_numpy(pts), torch.from_numpy(masks)


def _kernel_route_model(points, mask, lidar, max_points):
    """csrc/range_image.cu's formulation in torch: the keys as int32 less
    2^31 sorted (stable), and at each run start of the sorted prefix with
    a pixel in the image the owner and range rebuilt from the key's range
    bits and the sorted index, unless that word is the sentinel."""
    row, col, rng, ok, flat, key, _ = ri.range_keys_plain(points, mask,
                                                          lidar, 0.1)
    key32 = (key - (1 << 31)).to(torch.int32)
    key_s, order = torch.sort(key32, dim=-1, stable=True)
    bsz, n = mask.shape
    npix = lidar.n_scan * lidar.horizon_scan
    img = torch.full((bsz, npix), ri.F32_MAX)
    owner = torch.full((bsz, npix), -1, dtype=torch.int64)
    ac = ri._prefix(n, max_points)
    u = key_s[:, :ac].to(torch.int64) + (1 << 31)
    f = u >> ri.RBITS
    start = torch.ones_like(f, dtype=torch.bool)
    start[:, 1:] = f[:, 1:] != f[:, :-1]
    word = ((u & ((1 << ri.RBITS) - 1)) << ri.IBITS) + order[:, :ac]
    hit = start & (f < npix) & (word != ri.SENTINEL)
    for b in range(bsz):
        fb, wb = f[b][hit[b]], word[b][hit[b]]
        owner[b, fb] = wb & ((1 << ri.IBITS) - 1)
        img[b, fb] = ((wb >> ri.IBITS).to(torch.float32) + 0.5) * \
            np.float32(ri.RMAX / (1 << ri.RBITS))
    shape = (bsz, lidar.n_scan, lidar.horizon_scan)
    return (row, col, rng, ok, flat, img.reshape(shape),
            owner.reshape(shape))


@pytest.mark.parametrize("max_points", [None, 40000])
def test_range_image_kernel_formulation(hdl64, max_points):
    """The kernel route's int32 keys, run starts and rebuilt words (a torch
    model) equal the plain version on the HDL-64E pair with NaN and inf
    points; the point whose word is the sentinel keys but owns nothing."""
    pts, masks = _specials(*hdl64)
    lidar = qt.PipelineConfig().lidar
    got = _kernel_route_model(pts, masks, lidar, max_points)
    ref = ri.range_image_plain(pts, masks, lidar, 0.1, max_points)
    for name, g, r in zip(("row", "col", "rng", "ok", "flat", "img",
                           "owner"), got, ref):
        assert _same_bits(g, r), name
    assert bool(torch.isnan(ref[2][0, 3])) and not bool(ref[3][0, 3])
    assert bool(ref[3][0, 11]) and bool(ref[3][1, -1])
    lone = torch.zeros(1, 1 << 17, 3)
    lone[0, -1] = torch.tensor([125.0, 0.4, 0.0])
    one = torch.zeros(1, 1 << 17, dtype=torch.bool)
    one[0, -1] = True
    lone_ref = ri.range_image(lone, one, lidar)
    assert bool(lone_ref[3][0, -1]) and int(lone_ref[6].max()) == -1
    for g, r in zip(_kernel_route_model(lone, one, lidar, None), lone_ref):
        assert _same_bits(g, r)


# ------------------------------------------------------------ edge masks --

def _jax_images(pts, masks, lidar_j):
    """The JAX package's range images and valid masks of the non-ground
    points (a crude strip) of each cloud."""
    rimgs, valids = [], []
    proj = jax.jit(lambda p, m: jpr.project_to_range_image(p, m, lidar_j))
    for b in range(pts.shape[0]):
        ng = masks[b] & (pts[b, :, 2] > -1.723 + 0.3)
        *_, rimg, owner = proj(jnp.asarray(pts[b]), jnp.asarray(ng))
        rimgs.append(np.asarray(rimg))
        valids.append(np.asarray(owner) >= 0)
    return np.stack(rimgs), np.stack(valids)


@pytest.fixture(scope="module")
def vlp16():
    """The level_a VLP-16 pair (seed 101) at capacity 32768, numpy."""
    lidar = jcfg.LidarConfig.preset("VLP-16")
    clouds = [JaxPointBatch.from_numpy(xyz, capacity=32768) for xyz in
              jax_scan_pair(seed=101, yaw_deg=38.0,
                            translation=(2.5, -1.2, 0.04), lidar=lidar)[:2]]
    return (np.stack([np.asarray(c.points) for c in clouds]),
            np.stack([np.asarray(c.mask) for c in clouds]))


def _jax_edge_masks(rimg, valid, lidar_j, cfg_j):
    """The JAX package's edge masks in the port's order: _neighbor_edges
    of each offset, then under 4CrossNeighbor label_components' composed
    masks (projection.py:231-244), compiled."""
    theta = jnp.deg2rad(cfg_j.segment_theta_deg)

    @jax.jit
    def run(r, v):
        e = {o: jpr._neighbor_edges(r, v, *o, lidar_j, theta)
             for o in cfg_j.neighbor_offsets}
        out = [e[o] for o in cfg_j.neighbor_offsets]
        if ri.is_4cross(cfg_j.neighbor_offsets):
            out += [(e[a] & jnp.roll(e[b], (-a[0], -a[1]), axis=(0, 1)))
                    | (e[b] & jnp.roll(e[a], (-b[0], -b[1]), axis=(0, 1)))
                    for a, b in ri.COMPOSED]
        return jnp.stack(out)

    return np.asarray(run(jnp.asarray(rimg), jnp.asarray(valid)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scan", ["hdl64", "vlp16"])
def test_edge_masks_plain_vs_jax(scan, mode, request):
    """Each mask of the mode (and the wrapper's CPU route, one stacked
    tensor) equal to the JAX package's, but on pixels within one pixel of a
    knife-edge pair."""
    pts, masks = request.getfixturevalue(scan)
    name = "VLP-16" if scan == "vlp16" else "Velodyne-64-HDE"
    lidar_j, lidar_t = (jcfg.LidarConfig.preset(name),
                        tcfg.LidarConfig.preset(name))
    cfg_j = dataclasses.replace(jcfg.ProjectionConfig(), neighbor_mode=mode)
    cfg_t = dataclasses.replace(tcfg.ProjectionConfig(), neighbor_mode=mode)
    rimgs, valids = _jax_images(pts, masks, lidar_j)
    args = (cfg_t.neighbor_offsets,
            tpr._sin_cos(tpr._deg2rad(lidar_t.ang_res_x)),
            tpr._sin_cos(tpr._deg2rad(lidar_t.ang_res_y)),
            tpr._deg2rad(cfg_t.segment_theta_deg))
    got = ri.edge_masks(torch.from_numpy(rimgs), torch.from_numpy(valids),
                        *args)
    plain = ri.edge_masks_plain(torch.from_numpy(rimgs),
                                torch.from_numpy(valids), *args)
    assert torch.equal(got, plain)
    assert got.shape[0] == (4 if mode == "4Neighbor" else 8)
    for b in range(2):
        ref = _jax_edge_masks(rimgs[b], valids[b], lidar_j, cfg_j)
        knife = _knife_edge_pixels(rimgs[b], valids[b], lidar_t, cfg_t)
        near = knife.copy()
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                near |= np.roll(knife, (dr, dc), axis=(0, 1))
        print(f"{scan} {mode} cloud {b}: {int(ref.sum())} edges, "
              f"{int(knife.sum())} knife-edge pixels")
        for s in range(ref.shape[0]):
            g = got[s, b].numpy()
            np.testing.assert_array_equal(g[~near], ref[s][~near])
        assert ref.sum() > 0


# ------------------------------------------------------- component stats --

def _blob_scene(rows, cols, seed, n_blobs=150):
    """Blobs at random offsets (tests/test_preprocessing.py's brute-force
    scene) plus a full-height column and single pixels."""
    rng = np.random.default_rng(seed)
    rimg = np.full((rows, cols), np.inf, np.float32)
    valid = np.zeros((rows, cols), bool)
    for k in range(n_blobs):
        r0, c0 = rng.integers(0, rows - 1), rng.integers(0, cols - 8)
        h, w = rng.integers(1, 7), rng.integers(1, 9)
        rimg[r0:r0 + h, c0:c0 + w] = 10.0 + 0.001 * k
        valid[r0:r0 + h, c0:c0 + w] = True
    rimg[:, cols // 3] = 20.0
    valid[:, cols // 3] = True
    lone = rng.random((rows, cols)) < 0.01
    rimg[lone & ~valid] = 50.0
    valid |= lone
    return rimg, valid


@pytest.mark.parametrize("mode", MODES)
def test_component_stats_plain_vs_jax(hdl64, mode):
    """On the JAX package's own labels (its label_components on its range
    images of the HDL-64E pair, and on a blob scene), the plain stats'
    labels, feasibility and pixel feasibility equal the JAX package's,
    exactly."""
    lidar_j = jcfg.PipelineConfig().lidar
    cfg_j = dataclasses.replace(jcfg.ProjectionConfig(), neighbor_mode=mode)
    cfg_t = dataclasses.replace(tcfg.ProjectionConfig(), neighbor_mode=mode)
    rimgs, valids = _jax_images(*hdl64, lidar_j)
    blob = _blob_scene(lidar_j.n_scan, lidar_j.horizon_scan, 1234)
    cases = [(rimgs[b], valids[b]) for b in range(2)] + [blob]
    npix = lidar_j.n_scan * lidar_j.horizon_scan
    feasible = 0
    for rimg, valid in cases:
        ref = [np.asarray(a) for a in jpr.label_components(
            jnp.asarray(rimg), jnp.asarray(valid), lidar_j, cfg_j)]
        labels = torch.from_numpy(np.where(valid, ref[0], npix).astype(
            np.int32))[None]
        got = ri.component_stats(labels, torch.from_numpy(valid)[None],
                                 cfg_t.min_pts_for_subcluster,
                                 cfg_t.segment_valid_point_num,
                                 cfg_t.segment_valid_line_num)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[0].numpy(), r)
        feasible += int(ref[1].sum())
    assert feasible > 0


def _random_labels(bsz, rows, cols, seed):
    """Label images of the labelling's form and past it: single pixels,
    full-height columns, blobs labelled by their first pixel, valid pixels
    at the npix sentinel, invalid pixels holding any label."""
    rng = np.random.default_rng(seed)
    npix = rows * cols
    flat = np.arange(npix).reshape(rows, cols)
    valid = rng.random((bsz, rows, cols)) < 0.6
    labels = np.where(valid, flat, npix).astype(np.int32)
    for b in range(bsz):
        for c in rng.choice(cols, min(cols, 6), replace=False):
            labels[b, :, c] = c
            valid[b, :, c] = True
        for _ in range(40):
            r0, c0 = rng.integers(0, rows), rng.integers(0, cols)
            h, w = rng.integers(1, 8), rng.integers(1, 40)
            labels[b, r0:r0 + h, c0:c0 + w] = r0 * cols + c0
            valid[b, r0:r0 + h, c0:c0 + w] = True
        sent = rng.random((rows, cols)) < 0.02
        labels[b][sent] = npix
        valid[b][sent] = True
        junk = ~valid[b] & (rng.random((rows, cols)) < 0.3)
        labels[b][junk] = rng.integers(0, npix + 5, int(junk.sum()))
    return labels, valid


def _atomic_oracle(labels, valid, min_pts, valid_num, valid_lines):
    """csrc/component_stats.cu's formulation in numpy: per label a count,
    a max of R - row and a max of row + 1 over the valid pixels with a
    label in [0, npix), all zero-initialised; then each valid pixel's
    gate, and the root pixels'."""
    bsz, rows, cols = labels.shape
    npix = rows * cols
    row = np.repeat(np.arange(rows), cols)
    out_lab = np.where(valid, labels, -1).astype(np.int64)
    feasible = np.zeros((bsz, npix), bool)
    pix = np.zeros((bsz, npix), bool)
    for b in range(bsz):
        lab, v = labels[b].reshape(-1), valid[b].reshape(-1)
        take = v & (lab >= 0) & (lab < npix)
        count = np.bincount(lab[take], minlength=npix)
        top = np.zeros(npix, np.int64)
        bottom = np.zeros(npix, np.int64)
        np.maximum.at(top, lab[take], rows - row[take])
        np.maximum.at(bottom, lab[take], row[take] + 1)
        size = np.where(take, count[np.where(take, lab, 0)], 0)
        lines = np.where(take, bottom[np.where(take, lab, 0)]
                         + top[np.where(take, lab, 0)] - rows, 0)
        feas = take & ((size >= min_pts)
                       | ((size >= valid_num) & (lines >= valid_lines)))
        pix[b] = feas
        feasible[b] = feas & (lab == np.arange(npix))
    return out_lab, feasible, pix.reshape(bsz, rows, cols)


@pytest.mark.parametrize("gate", [(30, 5, 3), (1000, 2, 2), (1, 1, 64)])
@pytest.mark.parametrize("shape", [(64, 1800), (16, 1800), (64, 1024),
                                   (3, 7), (1, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_component_stats_atomic_oracle(shape, gate):
    """The plain sort-scan stats equal the atomic formulation's oracle on
    random label images (three images a batch)."""
    labels, valid = _random_labels(3, *shape, seed=sum(shape))
    got = ri.component_stats(torch.from_numpy(labels),
                             torch.from_numpy(valid), *gate)
    for g, r in zip(got, _atomic_oracle(labels, valid, *gate)):
        np.testing.assert_array_equal(g.numpy(), r)


# -------------------------------------------------------------- wrappers --

def test_wrappers_check_inputs():
    """Shapes, types, contiguity, offsets and the key's widths are checked
    before either route; the CPU route counts no launch."""
    lidar = qt.LidarConfig.preset("VLP-16")
    pts = torch.zeros(2, 16, 3)
    mask = torch.ones(2, 16, dtype=torch.bool)
    before = dict(LAUNCHES)
    ri.range_image(pts, mask, lidar)
    with pytest.raises(ValueError, match="expected"):
        ri.range_image(pts[..., :2].contiguous(), mask, lidar)
    with pytest.raises(ValueError, match="shape"):
        ri.range_image(pts, mask[:, :8], lidar)
    with pytest.raises(TypeError):
        ri.range_image(pts, mask.float(), lidar)
    with pytest.raises(ValueError, match="contiguous"):
        ri.range_image(pts.transpose(0, 1).contiguous().transpose(0, 1),
                       mask, lidar)
    with pytest.raises(ValueError, match="owner packing"):
        ri.range_image(torch.zeros(1, (1 << 17) + 1, 3),
                       torch.ones(1, (1 << 17) + 1, dtype=torch.bool), lidar)
    with pytest.raises(ValueError, match="overflows"):
        ri.range_image(pts, mask, dataclasses.replace(lidar, n_scan=128,
                                                      horizon_scan=2048))

    rimg = torch.full((2, 16, 32), 5.0)
    valid = torch.ones(2, 16, 32, dtype=torch.bool)
    sc = ((0.0034906585, 0.99999392), (0.034899496, 0.99939084))
    cross = tcfg.ProjectionConfig().neighbor_offsets
    assert ri.edge_masks(rimg, valid, cross, *sc, 0.17).shape == (
        8, 2, 16, 32)
    eight = dataclasses.replace(tcfg.ProjectionConfig(),
                                neighbor_mode="8Neighbor").neighbor_offsets
    with pytest.raises(ValueError, match="masks"):
        ri.edge_masks(rimg, valid, eight + ((0, 1),), *sc, 0.17)
    with pytest.raises(ValueError, match="masks"):
        ri.edge_masks(rimg, valid, (), *sc, 0.17)
    with pytest.raises(ValueError, match="within one pixel"):
        ri.edge_masks(rimg, valid, ((0, 2),), *sc, 0.17)
    with pytest.raises(ValueError, match="shape"):
        ri.edge_masks(rimg, valid[:, :8], cross, *sc, 0.17)
    with pytest.raises(TypeError):
        ri.edge_masks(rimg.double(), valid, cross, *sc, 0.17)
    with pytest.raises(ValueError, match="expected"):
        ri.edge_masks(rimg[0], valid[0], cross, *sc, 0.17)

    labels = torch.zeros(2, 16, 32, dtype=torch.int32)
    ri.component_stats(labels, valid, 30, 5, 3)
    with pytest.raises(TypeError):
        ri.component_stats(labels.long(), valid, 30, 5, 3)
    with pytest.raises(ValueError, match="shape"):
        ri.component_stats(labels, valid[:1], 30, 5, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ri.component_stats(labels.transpose(1, 2).contiguous().transpose(
            1, 2), valid, 30, 5, 3)
    assert dict(LAUNCHES) == before


def test_label_components_runs_the_wrappers(monkeypatch):
    """label_components and segment_cloud go through the three wrappers,
    each called once a call, and so does the edge masks' own route: the
    same masks as the per-offset ``_neighbor_edges`` and compositions."""
    lidar = qt.LidarConfig.preset("VLP-16")
    calls = {}
    for name in ("range_image", "edge_masks", "component_stats"):
        real = getattr(tpr, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(tpr, name, spy)
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-20, 20, (2, 4096, 3)).astype(
        np.float32))
    mask = torch.ones(2, 4096, dtype=torch.bool)
    res = tpr.segment_cloud(pts, mask, lidar)
    assert calls == {"range_image": 1, "edge_masks": 1,
                     "component_stats": 1}
    assert res.label_image.dtype == torch.int64
    cfg = tcfg.ProjectionConfig()
    theta = tpr._deg2rad(cfg.segment_theta_deg)
    valid = res.owner >= 0
    masks = ri.edge_masks(res.range_image, valid, cfg.neighbor_offsets,
                          tpr._sin_cos(tpr._deg2rad(lidar.ang_res_x)),
                          tpr._sin_cos(tpr._deg2rad(lidar.ang_res_y)),
                          theta)
    e = {o: tpr._neighbor_edges(res.range_image, valid, *o, lidar, theta)
         for o in cfg.neighbor_offsets}
    want = [e[o] for o in cfg.neighbor_offsets] + [
        ri.compose_edges(e[a], e[b], a, b) for a, b in tpr._COMPOSED]
    assert torch.equal(masks, torch.stack(want))
