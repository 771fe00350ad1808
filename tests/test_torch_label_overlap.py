"""The labelling's sweep and the overlap's hit counts, the two stages that
run as one hand-written kernel each on the card (csrc/label_sweep.cu,
csrc/overlap_hits.cu), on the CPU against the JAX package and an oracle.

- ``label_sweep_plain`` (the CPU route; the kernel's plain version) on
  every sweep of every neighbour mode's round, at 16, 32 and 64 rows and
  1024 and 1800 columns, equal to a numpy walk of the sweep's contract:
  the min of the labels along the chain of holding edges from each pixel,
  at most 2^(steps - 1) steps, both axes wrapping, and npix where the
  chain breaks before 2^(steps - 1) - 1 edges. The images hold full
  wrapped row runs (a wall round the whole ring) and broken chains; the
  labels run past npix, so the npix term shows.
- ``label_components`` exact against the JAX package's under all three
  modes at the Ouster OS1-64 (64 x 1024) and HDL-32E (32 x 1800) widths,
  on blob scenes with a two-ring wall round the sensor and a tall wall.
- ``alignment_overlap`` against the JAX package's for each leading shape
  it serves (one pose on one pair, B edges, B pairs x K hypotheses), with
  a NaN or an inf in a valid target point (both packages' mins propagate
  the NaN, so no row hits); the kernel's operands (``kernel_operands``)
  fed to a torch model of the kernel equal the plain route.

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
from quatro_tpu.preprocessing import projection as jpr
from quatro_tpu.solver.verify import alignment_overlap as jax_overlap

import quatro_tpu_torch as qt
import quatro_tpu_torch.config as tcfg
from quatro_tpu_torch.ops import labels as tlab
from quatro_tpu_torch.ops import overlap as tov
from quatro_tpu_torch.ops.launch import LAUNCHES
from quatro_tpu_torch.preprocessing import projection as tpr
from quatro_tpu_torch.solver.verify import alignment_overlap
from quatro_tpu_torch.utils.se3 import rotation_from_rpy

MODES = ["4CrossNeighbor", "4Neighbor", "8Neighbor"]
SHAPES = [(16, 1800), (32, 1800), (64, 1800), (16, 1024), (64, 1024)]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ the sweep --

def _chain_oracle(labels, edges, dr, dc, steps, npix):
    """The sweep's contract, walked in numpy for every pixel at once:
    min(labels[i + k d], k = 0 .. min(K, m(i))), K = 2^(steps - 1), m(i)
    the holding edges from i (positions wrapping on both axes), and npix
    where steps >= 2 and the chain broke after m(i) <= K - 2 edges."""
    bsz, rows, cols = labels.shape
    lab = labels.reshape(bsz, -1).astype(np.int64)
    e = edges.reshape(bsz, -1)
    b, p = np.nonzero(np.ones_like(e))
    r, c = p // cols, p % cols
    out = lab[b, p].copy()
    reach = 1 << (steps - 1)
    # a walk round the whole cycle has seen all it can reach
    period = np.lcm(rows // np.gcd(dr % rows, rows),
                    cols // np.gcd(dc % cols, cols))
    limit = min(reach, int(period))
    m = np.zeros_like(out)
    alive = np.arange(len(out))
    for _ in range(limit):
        hold = e[b[alive], r[alive] * cols + c[alive]]
        alive = alive[hold]
        if not len(alive):
            break
        r[alive] = (r[alive] + dr) % rows
        c[alive] = (c[alive] + dc) % cols
        out[alive] = np.minimum(out[alive],
                                lab[b[alive], r[alive] * cols + c[alive]])
        m[alive] += 1
    broke = (m < limit) & (m <= reach - 2)
    if steps >= 2:
        out[broke] = np.minimum(out[broke], npix)
    return out.reshape(bsz, rows, cols).astype(np.int32)


def _sweep_images(rows, cols, seed):
    """Two images of labels (some past npix) and edges: random edges with
    long runs, one full ring row, one ring row broken at a single column,
    a full column, and the row boundary's edges left as they fall."""
    rng = np.random.default_rng(seed)
    npix = rows * cols
    labels = rng.integers(0, npix + 64, (2, rows, cols)).astype(np.int32)
    edges = rng.random((2, rows, cols)) < 0.93
    edges[0, rows // 2] = True                      # a wall round the ring
    edges[1, rows // 3] = True
    edges[1, rows // 3, cols // 5] = False          # the ring, broken once
    edges[0, :, cols // 7] = True                   # a full column
    edges[1, 1:3] = False                           # a gap of rows
    return labels, edges, npix


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_label_sweep_plain_is_the_chain_min(shape, mode):
    """Every sweep of the mode's round (sweep_schedule), in order on the
    sweep's own output, equal to the chain oracle."""
    rows, cols = shape
    cfg = dataclasses.replace(tcfg.ProjectionConfig(), neighbor_mode=mode)
    labels, edges, npix = _sweep_images(rows, cols, rows * cols)
    sched = tpr.sweep_schedule(rows, cols, cfg)
    assert len(sched) == (8 if mode != "4Neighbor" else 4)
    cur = labels
    for k, (dr, dc, steps) in enumerate(sched):
        e = np.roll(edges, k, axis=-1)              # other edges a sweep
        got = tlab.label_sweep_plain(_t(cur), _t(e), dr, dc, steps,
                                     npix).numpy()
        want = _chain_oracle(cur, e, dr, dc, steps, npix)
        np.testing.assert_array_equal(got, want, err_msg=str((dr, dc)))
        cur = got


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("offset", [(0, 1), (0, -2), (1, 1), (-1, 0),
                                    (2, 0), (-1, -1)])
def test_label_sweep_plain_steps(offset, steps):
    """One sweep at each doubling depth on a 16 x 64 image (chains longer
    and shorter than the reach), against the oracle."""
    dr, dc = offset
    labels, edges, npix = _sweep_images(16, 64, 7 * steps)
    got = tlab.label_sweep_plain(_t(labels), _t(edges), dr, dc, steps, npix)
    np.testing.assert_array_equal(
        got.numpy(), _chain_oracle(labels, edges, dr, dc, steps, npix))


def _host_rounds(labels, valid, masks, sweeps, max_iters, npix):
    """The labelling's loop for each image alone, on the host: rounds of
    the chain oracle's sweeps and where(valid, out, npix), counted as the
    JAX package's cond / body count them. Returns (labels, rounds)."""
    outs, counts = [], []
    for b in range(labels.shape[0]):
        cur, it, changed = labels[b:b + 1], 0, True
        while changed and it < max_iters:
            out = cur
            for e, (dr, dc, steps) in zip(masks, sweeps):
                out = _chain_oracle(out, e[b:b + 1], dr, dc, steps, npix)
            out = np.where(valid[b:b + 1], out, npix).astype(np.int32)
            changed, cur, it = bool((out != cur).any()), out, it + 1
        outs.append(cur[0])
        counts.append(it)
    return np.stack(outs), np.array(counts, np.int32)


@pytest.mark.parametrize("max_iters", [0, 1, 3, 48])
@pytest.mark.parametrize("mode", MODES)
def test_label_sweeps_on_cpu_is_the_plain_route(mode, max_iters):
    """The labelling op's wrapper on CPU tensors: the plain route, no
    launch, each image's labels and rounds those of the host loop of the
    chain oracle's sweeps (random edges, labels past npix, one image with
    no valid pixel)."""
    rows, cols = 16, 64
    cfg = dataclasses.replace(tcfg.ProjectionConfig(), neighbor_mode=mode)
    sweeps = tpr.sweep_schedule(rows, cols, cfg)
    labels, edges, npix = _sweep_images(rows, cols, 11)
    valid = np.random.default_rng(12).random(labels.shape) < 0.8
    valid[1] = False
    labels = np.where(valid, labels, npix).astype(np.int32)
    masks = [np.roll(edges, k, axis=-1) for k in range(len(sweeps))]
    before = dict(LAUNCHES)
    got, rounds = tlab.label_sweeps(_t(labels), _t(valid),
                                    [_t(e) for e in masks], sweeps,
                                    max_iters, npix)
    assert LAUNCHES == before
    assert rounds.dtype == torch.int32 and got.dtype == torch.int32
    want, want_rounds = _host_rounds(labels, valid, masks, sweeps,
                                     max_iters, npix)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rounds.numpy(), want_rounds)
    assert int(want_rounds[1]) == min(1, max_iters)


def test_label_sweep_checks_its_inputs():
    """The labelling op's wrapper refuses what its kernel does not take."""
    labels = torch.zeros(2, 4, 8, dtype=torch.int32)
    valid = torch.ones(2, 4, 8, dtype=torch.bool)
    edges = torch.ones(2, 4, 8, dtype=torch.bool)
    sweeps = [(0, 1, 3)]
    with pytest.raises(TypeError):
        tlab.label_sweeps(labels.long(), valid, [edges], sweeps, 4, 32)
    with pytest.raises(TypeError):
        tlab.label_sweeps(labels, valid.int(), [edges], sweeps, 4, 32)
    with pytest.raises(ValueError):
        tlab.label_sweeps(labels, valid, [edges[:, :3]], sweeps, 4, 32)
    with pytest.raises(ValueError):
        tlab.label_sweeps(labels[0], valid[0], [edges[0]], sweeps, 4, 32)
    with pytest.raises(ValueError):
        tlab.label_sweeps(labels, valid, [edges], [(0, 1, 0)], 4, 32)
    with pytest.raises(ValueError):
        tlab.label_sweeps(labels, valid, [edges, edges], sweeps, 4, 32)
    with pytest.raises(ValueError):
        tlab.label_sweeps(labels, valid, [edges] * 9, sweeps * 9, 4, 32)
    with pytest.raises(ValueError):
        tlab.label_sweeps(labels, valid, [edges], sweeps, -1, 32)
    with pytest.raises(ValueError):
        tlab.label_sweeps(labels, valid, [edges.transpose(1, 2)
                                          .contiguous().transpose(1, 2)],
                          sweeps, 4, 32)


def _wall_scene(seed, lidar):
    """tests/test_torch_stage_loops.py's blob scene plus a two-ring wall
    round the sensor (every column of two adjacent rows, one range) and a
    tall wall (a band of columns over the rows above it)."""
    rng = np.random.default_rng(seed)
    rows, cols = lidar.n_scan, lidar.horizon_scan
    rimg = np.full((rows, cols), np.inf, np.float32)
    valid = np.zeros((rows, cols), bool)
    for k in range(120):
        r0, c0 = rng.integers(0, rows - 6), rng.integers(0, cols - 8)
        h, w = rng.integers(1, 6), rng.integers(1, 8)
        rimg[r0:r0 + h, c0:c0 + w] = 10.0 + 0.001 * k
        valid[r0:r0 + h, c0:c0 + w] = True
    ring = rows // 2
    rimg[ring:ring + 2] = 7.5
    valid[ring:ring + 2] = True
    c0 = cols // 3
    rimg[1:ring - 1, c0:c0 + 5] = 20.0
    valid[1:ring - 1, c0:c0 + 5] = True
    return rimg, valid


def _narrow_scene(rows, cols, seed):
    """A range image of few rows and many columns: runs of equal range
    (walls) broken at random columns, some rows' runs joined, invalid
    gaps."""
    rng = np.random.default_rng(seed)
    rimg = np.full((rows, cols), np.inf, np.float32)
    valid = np.zeros((rows, cols), bool)
    starts = np.sort(rng.choice(cols, 400, replace=False))
    for k, (c0, c1) in enumerate(zip(starts[:-1], starts[1:])):
        r0 = rng.integers(0, rows)
        r1 = min(rows, r0 + rng.integers(1, 4))
        rimg[r0:r1, c0:c1 - rng.integers(0, 3)] = 5.0 + 0.01 * (k % 7)
        valid[r0:r1, c0:c1] = np.isfinite(rimg[r0:r1, c0:c1])
    return rimg, valid


@pytest.mark.parametrize("rows,cols", [(4, 32767), (11, 11915)])
def test_label_components_matches_jax_on_narrow_wide_images(rows, cols):
    """label_components on images of few rows and many columns (those the
    card labels in a global workspace): labels, feasibility and pixel
    feasibility exactly the JAX package's under 4CrossNeighbor."""
    lidar_j = dataclasses.replace(jcfg.LidarConfig(), n_scan=rows,
                                  horizon_scan=cols, ang_res_x=360.0 / cols,
                                  ang_res_y=2.0, ground_scan_ind=0)
    lidar_t = dataclasses.replace(qt.LidarConfig(), n_scan=rows,
                                  horizon_scan=cols, ang_res_x=360.0 / cols,
                                  ang_res_y=2.0, ground_scan_ind=0)
    cfg_j, cfg_t = jcfg.ProjectionConfig(), tcfg.ProjectionConfig()
    rimg, valid = _narrow_scene(rows, cols, rows)
    got = tpr.label_components(_t(rimg[None]), _t(valid[None]), lidar_t,
                               cfg_t)
    ref = jax.jit(lambda r, v: jpr.label_components(r, v, lidar_j, cfg_j))(
        jnp.asarray(rimg), jnp.asarray(valid))
    for g, want in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(ref[0])[valid])) > 50


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lidar", ["Ouster-OS1-64", "HDL-32E"])
def test_label_components_matches_jax_at_other_widths(lidar, mode):
    """label_components on two wall scenes as one batch: labels,
    feasibility and pixel feasibility exactly the JAX package's on each."""
    lidar_j = jcfg.LidarConfig.preset(lidar)
    lidar_t = qt.LidarConfig.preset(lidar)
    cfg_j = dataclasses.replace(jcfg.ProjectionConfig(), neighbor_mode=mode)
    cfg_t = dataclasses.replace(tcfg.ProjectionConfig(), neighbor_mode=mode)
    scenes = [_wall_scene(seed, lidar_j) for seed in (5, 6)]
    got = tpr.label_components(_t(np.stack([s[0] for s in scenes])),
                               _t(np.stack([s[1] for s in scenes])),
                               lidar_t, cfg_t)
    fn = jax.jit(lambda r, v: jpr.label_components(r, v, lidar_j, cfg_j))
    for b, (r, v) in enumerate(scenes):
        ref = [np.asarray(a) for a in fn(jnp.asarray(r), jnp.asarray(v))]
        for g, want in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), want)
        # the ring wraps round the sensor as one component rooted at its
        # first pixel (4CrossNeighbor: two, one per parity of r + c)
        ring, cols = lidar_j.n_scan // 2, lidar_j.horizon_scan
        root = ring * cols
        if mode == "4CrossNeighbor":
            root = root + (np.add.outer(np.arange(2), np.arange(cols)) % 2)
        assert (ref[0][ring:ring + 2] == root).all()


def _jax_labelling(rimg, valid, lidar, cfg, monkeypatch):
    """The JAX package's label_components on one image, and its
    while_loop's round count: a spy on ``jax.lax.while_loop`` traced into
    a fresh jit of the function's ``__wrapped__``."""
    seen = []
    real = jax.lax.while_loop

    def spy(cond, body, init):
        out = real(cond, body, init)
        jax.debug.callback(lambda it: seen.append(int(it)), out[-1])
        return out

    monkeypatch.setattr(jax.lax, "while_loop", spy)
    fn = jax.jit(lambda r, v: jpr.label_components.__wrapped__(
        r, v, lidar, cfg))
    got = [np.asarray(a) for a in fn(jnp.asarray(rimg), jnp.asarray(valid))]
    jax.effects_barrier()
    monkeypatch.setattr(jax.lax, "while_loop", real)
    assert len(seen) == 1
    return got, seen[0]


@pytest.mark.parametrize("max_iters", [1, 2, 3, 48])
@pytest.mark.parametrize("mode", MODES)
def test_label_rounds_match_jax(mode, max_iters, monkeypatch):
    """Each image's rounds in the plain route (one batched call on two
    VLP-16 wall scenes) equal the JAX package's while_loop count on that
    image alone, and so do the labels, feasibility and pixel feasibility,
    at caps below and above the images' own exits."""
    lidar_j = jcfg.LidarConfig.preset("VLP-16")
    lidar_t = qt.LidarConfig.preset("VLP-16")
    cfg_j = dataclasses.replace(jcfg.ProjectionConfig(), neighbor_mode=mode,
                                max_cc_iters=max_iters)
    cfg_t = dataclasses.replace(tcfg.ProjectionConfig(), neighbor_mode=mode,
                                max_cc_iters=max_iters)
    scenes = [_wall_scene(seed, lidar_j) for seed in (5, 6)]
    calls = []
    real = tpr.label_sweeps

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(tpr, "label_sweeps", spy)
    got = tpr.label_components(_t(np.stack([s[0] for s in scenes])),
                               _t(np.stack([s[1] for s in scenes])),
                               lidar_t, cfg_t)
    monkeypatch.setattr(tpr, "label_sweeps", real)
    (_, rounds), = calls
    for b, (r, v) in enumerate(scenes):
        ref, it = _jax_labelling(r, v, lidar_j, cfg_j, monkeypatch)
        assert int(rounds[b]) == it, (b, int(rounds[b]), it)
        for g, want in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), want)
    assert int(rounds.max()) <= max_iters
    if max_iters == 1:
        assert rounds.tolist() == [1, 1]


def test_label_sweeps_images_stop_on_their_own():
    """A batch whose images converge at different rounds (a wall scene, an
    image with no valid pixel, a lone blob): each image's labels and
    rounds in the batched plain route are those of its own call."""
    lidar = jcfg.LidarConfig.preset("VLP-16")
    rows, cols = lidar.n_scan, lidar.horizon_scan
    cfg = tcfg.ProjectionConfig()
    rimg, valid = _wall_scene(5, lidar)
    blob = np.zeros_like(valid)
    blob[3:6, 40:52] = True
    rimgs = np.stack([rimg, rimg, np.where(blob, 9.0, np.inf)]).astype(
        np.float32)
    valids = np.stack([valid, np.zeros_like(valid), blob])
    lid = qt.LidarConfig.preset("VLP-16")
    theta = tpr._deg2rad(cfg.segment_theta_deg)
    sweeps = tpr.sweep_schedule(rows, cols, cfg)
    npix = rows * cols

    def operands(sl):
        r, v = _t(rimgs[sl]), _t(valids[sl])
        edges = {(dr, dc): tpr._neighbor_edges(r, v, dr, dc, lid, theta)
                 for dr, dc in cfg.neighbor_offsets}
        masks = [edges[o] for o in cfg.neighbor_offsets] + [
            (edges[a] & tlab.roll_image(edges[b], *a))
            | (edges[b] & tlab.roll_image(edges[a], *b))
            for a, b in tpr._COMPOSED]
        iota = torch.arange(npix, dtype=torch.int32).reshape(rows, cols)
        return torch.where(v, iota, npix), v, masks

    got, rounds = tlab.label_sweeps_plain(*operands(slice(0, 3)), sweeps,
                                          48, npix)
    assert len(set(rounds.tolist())) == 3, rounds.tolist()
    for b in range(3):
        one, n = tlab.label_sweeps_plain(*operands(slice(b, b + 1)), sweeps,
                                         48, npix)
        assert torch.equal(got[b:b + 1], one) and int(rounds[b]) == int(n[0])


# ---------------------------------------------------------- the overlap --

def _overlap_case(lead, special, seed=3):
    """Numpy clouds for a leading shape: "one" (N, 3) / (M, 3) and one
    pose, "edges" (B, N, 3) with B poses, "hypotheses" (B, 1, N, 3) with
    (B, K) poses; ``special`` puts a NaN or an inf into a valid target
    point (and a NaN into a masked one and a valid source row)."""
    rng = np.random.default_rng(seed)
    bsz, k, ns, nt = 3, 4, 300, 420
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
    trans = rng.normal(0, 0.2, (bsz, k, 3)).astype(np.float32)
    if lead == "one":
        return (src[0], smask[0], tgt[0], tmask[0], yaws[0, 0], trans[0, 0])
    if lead == "edges":
        return src, smask, tgt, tmask, yaws[:, 0], trans[:, 0]
    return (src[:, None], smask[:, None], tgt[:, None], tmask[:, None],
            yaws, trans)


def _jax_overlap(src, smask, tgt, tmask, rot, trans, radius):
    fn = lambda s, sm, t, tm, r, tr: jax_overlap(s, sm, t, tm, r, tr,  # noqa: E731
                                                 radius)
    for _ in range(rot.ndim - 2):
        fn = jax.vmap(fn, in_axes=(0, 0, 0, 0, 0, 0))
    # the clouds' K axis (size 1) broadcast to the poses' as vmap needs it
    shape = rot.shape[:-2]
    args = [np.broadcast_to(a, shape + a.shape[len(shape):])
            for a in (src, smask, tgt, tmask)]
    return np.asarray(fn(*(jnp.asarray(a) for a in args),
                         jnp.asarray(rot), jnp.asarray(trans)))


@pytest.mark.parametrize("special", ["finite", "nan", "inf"])
@pytest.mark.parametrize("lead", ["one", "edges", "hypotheses"])
def test_alignment_overlap_matches_jax(lead, special):
    """alignment_overlap against the JAX package's (under jax.vmap for the
    B and (B, K) shapes) on the same numpy clouds and poses: the shares
    exactly equal. A NaN in a valid target point leaves every row of its
    pair without a hit in both."""
    src, smask, tgt, tmask, yaws, trans = _overlap_case(lead, special)
    rot = torch.stack([rotation_from_rpy(0.0, 0.0, float(a))
                       for a in np.ravel(yaws)]).reshape(
        np.shape(yaws) + (3, 3))
    got = alignment_overlap(_t(src), _t(smask), _t(tgt), _t(tmask), rot,
                            _t(trans), 0.6)
    want = _jax_overlap(src, smask, tgt, tmask, rot.numpy(), trans, 0.6)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if special == "nan":
        assert float(np.abs(want).max()) == 0.0
    else:
        assert float(np.min(want)) > 0.1


@pytest.mark.parametrize("masks", ["sparse", "no_target", "one_target",
                                   "nan_first", "nan_last"])
def test_alignment_overlap_masks_match_jax(masks):
    """alignment_overlap on B = 3 pairs x K = 4 poses against the JAX
    package's, exactly, at the masks the kernel's compaction meets: 5 % of
    the points valid, a pair whose target has no valid point, a target
    with one valid point, and a NaN in the first or the last valid target
    point (every row of that pair without a hit)."""
    src, smask, tgt, tmask, yaws, trans = _overlap_case("hypotheses",
                                                        "finite", seed=8)
    rng = np.random.default_rng(9)
    if masks == "sparse":
        smask = rng.random(smask.shape) < 0.05
        tmask = rng.random(tmask.shape) < 0.05
    elif masks == "no_target":
        tmask[1] = False
    elif masks == "one_target":
        tmask[:] = False
        tmask[:, :, 17] = True
        smask[:, :, 17] = True
    else:
        k = 0 if masks == "nan_first" else tmask.shape[-1] - 1
        tmask[:, :, k] = True
        tgt[:, :, k, 2] = np.nan
    rot = torch.stack([rotation_from_rpy(0.0, 0.0, float(a))
                       for a in np.ravel(yaws)]).reshape(
        np.shape(yaws) + (3, 3))
    got = alignment_overlap(_t(src), _t(smask), _t(tgt), _t(tmask), rot,
                            _t(trans), 0.6)
    want = _jax_overlap(src, smask, tgt, tmask, rot.numpy(), trans, 0.6)
    np.testing.assert_array_equal(got.numpy(), want)
    if masks == "no_target":
        assert float(np.abs(want[1]).max()) == 0.0 < float(want[0].min())
    elif masks.startswith("nan"):
        assert float(np.abs(want).max()) == 0.0
    else:
        assert float(want.max()) > 0.0


def _kernel_model(p, pm, tgt, tm, r2, pack, idx):
    """The kernel's contract on its operands, in torch: for each leading
    entry l, the rows of p[idx[0, l]] valid in pm[idx[1, l]] whose
    NaN-propagating min over the valid points of its target combination
    c = idx[2, l] (tgt[pack[0, c]] where tm[pack[1, c]]; +inf if none) of
    ((dx dx) + (dy dy)) + (dz dz) is <= r2."""
    out = []
    for ip, ipm, c in idx.T.tolist():
        it, itm = pack[:, c].tolist()
        t = tgt[it][tm[itm]]
        d = p[ip][:, None, :] - t[None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        d2 = torch.cat([d2, torch.full((d2.shape[0], 1), float("inf"))], 1)
        out.append(int(((d2.amin(-1) <= r2) & pm[ipm]).sum()))
    return torch.tensor(out, dtype=torch.int64)


@pytest.mark.parametrize("special", ["finite", "nan"])
@pytest.mark.parametrize("lead", ["one", "edges", "hypotheses"])
def test_overlap_kernel_operands(lead, special):
    """The operands the wrapper hands csrc/overlap_hits.cu (each cloud
    flattened over its own leading axes, the (2, Ct) target combinations
    and the (3, L) row map of the broadcast; the (B, 1, M, 3) target
    packed once, not K times), run through a torch model of the kernel
    over the valid targets only, give the plain route's hits; the plan's
    rows a thread, tiles and splits at path A's and B = 64's shapes; the
    wrapper on CPU tensors is the plain route and launches nothing."""
    src, smask, tgt, tmask, yaws, trans = _overlap_case(lead, special)
    rot = torch.stack([rotation_from_rpy(0.0, 0.0, float(a))
                       for a in np.ravel(yaws)]).reshape(
        np.shape(yaws) + (3, 3))
    p = qt.utils.se3.rotate_points(_t(src), rot) + _t(trans)[..., None, :]
    pm, tg, tm = _t(smask), _t(tgt), _t(tmask)
    r2 = torch.full((), 0.6) ** 2
    lead_shape = torch.broadcast_shapes(p.shape[:-2], tg.shape[:-2],
                                        pm.shape[:-1], tm.shape[:-1])
    ops = tov.kernel_operands(p, pm, tg, tm, lead_shape)
    assert ops[2].shape[0] == (1 if lead == "one" else 3)
    assert all(t.is_contiguous() for t in ops)
    before = dict(LAUNCHES)
    plain = tov.overlap_hits(p, pm, tg, tm, r2)
    assert LAUNCHES == before
    assert torch.equal(plain, tov.overlap_hits_plain(p, pm, tg, tm, r2, 64))
    assert ops[4].shape == (2, 1 if lead == "one" else 3)
    assert tov.overlap_plan(6, 2048, 8192) == (1, 16, 3)
    assert tov.overlap_plan(384, 2048, 8192) == (4, 4, 1)
    model = _kernel_model(*ops[:4], r2, *ops[4:]).reshape(lead_shape)
    assert torch.equal(model, plain)


def test_overlap_hits_checks_its_inputs():
    p = torch.zeros(4, 3)
    pm = torch.ones(4, dtype=torch.bool)
    r2 = torch.full((), 0.25)
    with pytest.raises(TypeError):
        tov.overlap_hits(p.double(), pm, p, pm, r2)
    with pytest.raises(TypeError):
        tov.overlap_hits(p, pm.float(), p, pm, r2)
    with pytest.raises(TypeError):
        tov.overlap_hits(p, pm, p, pm, r2[None])


def test_overlap_index_operands_kept_by_shape():
    """The target combinations and row map of kernel_operands depend on
    the leading shapes alone: a second call at the same shapes, with other
    values, hands back the same index tensors; another shape gets its
    own, equal to a fresh build."""
    rng = np.random.default_rng(5)

    def operands(lead_p, lead_t, n=7, m=9):
        p = _t(rng.normal(size=lead_p + (n, 3)).astype(np.float32))
        tgt = _t(rng.normal(size=lead_t + (m, 3)).astype(np.float32))
        pm = _t(rng.random(lead_p + (n,)) < 0.7)
        tm = _t(rng.random(lead_t + (m,)) < 0.7)
        lead = torch.broadcast_shapes(lead_p, lead_t)
        return p, pm, tgt, tm, lead

    first = tov.kernel_operands(*operands((2, 3), (2, 1)))
    again = operands((2, 3), (2, 1))
    second = tov.kernel_operands(*again)
    assert second[4] is first[4] and second[5] is first[5]
    assert torch.equal(second[0], again[0].reshape(-1, 7, 3))
    other = operands((4,), (4,))
    got = tov.kernel_operands(*other)
    fresh = tov._index_operands(*other)
    assert got[4] is not first[4]
    assert torch.equal(got[4], fresh[0]) and torch.equal(got[5], fresh[1])
