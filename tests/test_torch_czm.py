"""Patchwork's three kernels' plain versions (ops/czm.py: ``czm_points``,
``seed_heights``, ``plane_fit``) on the CPU, against the JAX package and
against models of the kernels' own formulations.

The JAX side is one ``estimate_ground`` run a cloud, op by op, with the
operands and results of its three Pallas kernels' calls recorded (the
golden spec level_a's first VLP-16 cloud at 32768 points, and the seed-11
HDL-64E pair's first cloud at 131072). Tolerances, and what was measured
on these inputs:

- ``czm_points_plain`` against the operands the JAX package hands B8 and
  B9: patch ids and z-bins exact but for points within 1e-5 (relative) of
  a CZM ring or sector edge (measured: none), B8's weights and the x, y, z
  channels exact, the patch-relative x and y within 2e-5 m (a few f32
  ulps of the 80 m range: torch's and XLA's cosines of the patch-centre
  angle; measured 7.6e-6);
- ``seed_heights_plain`` on the JAX package's own histogram: the first
  table exact but for the seed heights, within 2e-6 m (the shares' sum
  order, now ``fused.pairwise_sum``'s; measured 4.8e-7), and the live
  patches exact;
- ``plane_fit_plain`` on the JAX package's own B9 sums of every fit: on
  the live patches the flags exact, the normals within 1e-3 (measured
  3.6e-5: the eigen solve's cosines) and the plane offsets within twice
  the normals' difference times the patch mean plus 1e-4 m (measured at
  most 0.95 of the bound without its factor 2).

The models (``_model_*``) write each kernel's formulation in torch (the
z range folded from per-chunk partials, each zone's numbers gathered by
index from the table the kernel gets, the patch centres gathered from one
table, wrapping int32 sums; the seed stage's lanes of four bins, their
prefixes and the pairwise tree as the warp adds them) and equal the plain
versions bit for bit, with NaN and inf points, an empty cloud, points on
the CZM's inner and outer edges, a kept point at +inf height
(tests/torch_czm_cases.py), and under sensor_height 0,
using_global_elevation, num_iter 1 and a three-zone table (the same
configurations as on the card). The kernels themselves are held
against the plain versions on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io.synthetic import make_scan_pair as jax_scan_pair
from quatro_tpu.ops import segment_matmul as jsm
from quatro_tpu.preprocessing import patchwork as jpw
from quatro_tpu.types import PointBatch as JaxPointBatch

import quatro_tpu_torch as qt
from quatro_tpu_torch.ops import czm
from quatro_tpu_torch.ops.launch import LAUNCHES
from quatro_tpu_torch.ops.segment import (classify_points_plain,
                                          cross_histogram_plain,
                                          fit_iteration_moments_plain)
from quatro_tpu_torch.preprocessing import patchwork as tpw
from quatro_tpu_torch.utils import fused

from golden_specs import GOLDEN_SPECS, RAW_CAPACITY, build_config, build_pair
from test_torch_preprocessing import _near_czm_edge
from torch_czm_cases import CZM_CONFIGS, czm_specials

CHAN_ATOL = 2e-5
SEED_ATOL = 2e-6
NORMAL_ATOL = 1e-3
OFFSET_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(name):
    """(points (N, 3), mask (N,) numpy, JAX and port Patchwork configs) of
    a case's first cloud."""
    if name == "level_a":
        spec = next(s for s in GOLDEN_SPECS if s["name"] == "level_a")
        xyz = build_pair(spec)[0]
        jc = build_config(spec)
        pts = np.zeros((RAW_CAPACITY, 3), np.float32)
        mask = np.zeros(RAW_CAPACITY, bool)
        pts[:len(xyz)], mask[:len(xyz)] = xyz, True
        return (pts, mask, jc.patchwork,
                qt.config_from_dict(dataclasses.asdict(jc)).patchwork)
    cloud = JaxPointBatch.from_numpy(
        jax_scan_pair(seed=11, yaw_deg=20.0, translation=(2.5, 1.0, 0.05))[0],
        capacity=131072)
    return (np.asarray(cloud.points), np.asarray(cloud.mask),
            jcfg.PipelineConfig().patchwork, qt.PipelineConfig().patchwork)


@pytest.fixture(scope="module", params=["level_a", "hdl64"])
def recorded(request):
    """A case's cloud, its configs, and the JAX package's estimate_ground
    run op by op on it, with each call of its three Pallas kernels'
    functions recorded as (arguments, keyword arguments, result)."""
    pts, mask, jc, tc = _cloud(request.param)
    calls = {}
    names = ("cross_histogram", "fit_iteration_moments", "classify_points")
    saved = {k: getattr(jsm, k) for k in names}

    def recorder(name, fn):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            calls.setdefault(name, []).append(
                ([np.asarray(a) if hasattr(a, "shape") else a for a in args],
                 kw, np.asarray(out)))
            return out
        return rec

    try:
        for k, fn in saved.items():
            setattr(jsm, k, recorder(k, fn))
        with jax.disable_jit():
            jpw.estimate_ground(jnp.asarray(pts), jnp.asarray(mask), jc)
    finally:
        for k, fn in saved.items():
            setattr(jsm, k, fn)
    assert [len(calls[k]) for k in names] == [1, tc.num_iter, 1]
    return pts, mask, tc, calls


def _jax_live(calls, p_cnt):
    """The JAX package's live patches: bit 8 of its classification table's
    flags."""
    flags = calls["classify_points"][0][0][2][:p_cnt, 4]
    return (flags.astype(np.int32) & 8) > 0


# ------------------------------------------------- against the JAX package --

def test_czm_points_plain_against_jax(recorded):
    pts, mask, tc, calls = recorded
    pid, zb, chan, weights, b0 = czm.czm_points_plain(_t(pts)[None],
                                                      _t(mask)[None], tc)
    (jid, jzb, jw, p_pad, zbins), _, _ = calls["cross_histogram"][0]
    jchan = calls["fit_iteration_moments"][0][0][1]
    assert (p_pad, zbins) == (czm._pad128(tc.num_patches + 1), czm.Z_BINS)
    near = _near_czm_edge(pts, tc) & mask
    differ = (pid[0].numpy() != jid) | (zb[0].numpy() != jzb)
    print(f"czm_points: {int(differ.sum())} ids or z-bins differ, "
          f"{int(near.sum())} valid points near an edge, b0 {b0.tolist()}")
    assert not (differ & ~near).any()
    assert (jid < tc.num_patches).sum() > 1000
    same = ~differ
    np.testing.assert_array_equal(weights[0].numpy()[:, same], jw[:, same])
    np.testing.assert_array_equal(chan[0].numpy()[:3, same],
                                  jchan[:3, same])
    np.testing.assert_allclose(chan[0].numpy()[3:, same], jchan[3:, same],
                               rtol=0, atol=CHAN_ATOL)


def test_seed_heights_plain_against_jax(recorded):
    pts, mask, tc, calls = recorded
    p_cnt = tc.num_patches
    _, _, _, _, b0 = czm.czm_points_plain(_t(pts)[None], _t(mask)[None], tc)
    hist = _t(calls["cross_histogram"][0][2])[None].contiguous()
    lpr_h, live, tab = czm.seed_heights_plain(hist, b0, tc)
    jtab = calls["fit_iteration_moments"][0][0][2]
    np.testing.assert_array_equal(live[0].numpy(), _jax_live(calls, p_cnt))
    np.testing.assert_array_equal(tab[0].numpy()[:, [0, 1, 2, 4]],
                                  jtab[:, [0, 1, 2, 4]])
    np.testing.assert_array_equal(tab[0, :, 3].numpy()[p_cnt:], 0.0)
    np.testing.assert_allclose(tab[0, :p_cnt, 3].numpy(), jtab[:p_cnt, 3],
                               rtol=0, atol=SEED_ATOL)
    np.testing.assert_array_equal(
        (lpr_h + tc.th_seeds)[0].numpy(), tab[0, :p_cnt, 3].numpy())
    assert int(live.sum()) > 20


def test_plane_fit_plain_against_jax(recorded):
    """Every fit on the JAX package's own sums against its next table (the
    last against its classification table, flags included)."""
    _, _, tc, calls = recorded
    p_cnt = tc.num_patches
    live = _jax_live(calls, p_cnt)
    ptab = czm._patch_tables(tc, torch.device("cpu"))
    fits = calls["fit_iteration_moments"]
    for k, (_, kw, sums) in enumerate(fits):
        final = k + 1 == len(fits)
        ref = (calls["classify_points"][0][0][2] if final
               else fits[k + 1][0][2])
        out = czm.plane_fit_plain(_t(sums)[None].contiguous(), ptab, tc,
                                  final=final, patch_live=_t(live)[None])
        got = (out[6] if final else out)[0].numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got[p_cnt:], 0.0)
        np.testing.assert_array_equal(got[:, 4], ref[:, 4])
        got, ref = got[:p_cnt][live], ref[:p_cnt][live]
        dn = np.abs(got[:, :3] - ref[:, :3])
        assert dn.max() <= NORMAL_ATOL
        cnt = np.maximum(sums[:p_cnt, 0], 1.0)[live]
        mean_w = np.abs(np.stack([
            sums[:p_cnt, 1][live] / cnt + ptab[0].numpy()[live],
            sums[:p_cnt, 2][live] / cnt + ptab[1].numpy()[live],
            sums[:p_cnt, 3][live] / cnt], 1))
        bound = 2 * (dn * mean_w).sum(1) + OFFSET_ATOL
        assert (np.abs(got[:, 3] - ref[:, 3]) <= bound).all()
        if final:
            n1, n2, n3, th, sv, elev, tab, accepted = out
            jflags = calls["classify_points"][0][0][2][:p_cnt, 4]
            np.testing.assert_array_equal(
                accepted[0].numpy(), (jflags.astype(np.int32) & 1) > 0)
            np.testing.assert_array_equal(
                torch.stack([n1, n2, n3, th], -1)[0].numpy(),
                tab[0, :p_cnt, :4].numpy())
            assert torch.isfinite(sv).all() and torch.isfinite(elev).all()


# ------------------------------------------------- models of the kernels --

def _model_czm_points(points, mask, cfg):
    """csrc/czm_points.cu's formulation in torch: the kept heights' range
    folded from per-chunk partials, each zone's numbers gathered by index
    from the kernel's own zone table (``_zone_args``), the patch centre
    gathered from ``point_centers``, the int32 sums wrapped, the Python
    scalars rounded to f32 as the wrapper hands them over."""
    zf, zi = czm._zone_args(cfg)
    p_cnt = cfg.num_patches
    bsz, n = mask.shape
    x, y, z = points.unbind(-1)
    keep = mask & (z >= fused.f32(-1.8 * cfg.sensor_height))
    chunks = -(-n // czm.ZRANGE_CHUNK)
    pad = chunks * czm.ZRANGE_CHUNK - n

    def fold(fill, op):
        v = torch.nn.functional.pad(torch.where(keep, z, fill), (0, pad),
                                    value=fill)
        return op(op(v.reshape(bsz, chunks, -1), -1), -1)

    zmin = fold(math.inf, torch.amin)
    zmax = fold(-math.inf, torch.amax)
    r = fused.hypot(x, y)
    theta = fused.atan2(y, x)
    theta = torch.where(theta > 0, theta, theta + fused.f32(2 * math.pi))
    in_czm = (r > fused.f32(cfg.min_r)) & (r <= fused.f32(cfg.max_r)) & keep
    zone = sum((r >= zf[0, k]).long() for k in range(cfg.num_zones - 1))
    zone = torch.as_tensor(zone).expand(r.shape)
    ring = torch.minimum(((r - zf[1][zone]) / zf[2][zone]).to(torch.int32),
                         zi[0][zone] - 1)
    sector = torch.minimum((theta / zf[3][zone]).to(torch.int32),
                           zi[1][zone] - 1)
    ring = torch.clamp(ring, min=0)
    patch = (zi[2][zone].long() + ring.long() * zi[1][zone].long()
             + sector.long())
    patch = ((patch + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
    pid0 = torch.where(in_czm, patch, p_cnt)
    cx, cy = czm.point_centers(cfg, points.device)[
        :, torch.clamp(pid0, 0, p_cnt - 1).long()]
    ok = in_czm & torch.isfinite(points).all(-1)
    zero = torch.zeros_like(x)
    chan = torch.stack([torch.where(ok, x, zero), torch.where(ok, y, zero),
                        torch.where(ok, z, zero),
                        torch.where(ok, x - cx, zero),
                        torch.where(ok, y - cy, zero)], 1)
    binw = torch.clamp(zmax - zmin, min=fused.f32(1e-6)) * fused.f32(1 / 128)
    margin = fused.f32(czm._margin(cfg))
    b0 = torch.clamp(torch.ceil((margin - zmin) / binw), 0,
                     czm.Z_BINS).to(torch.int32)
    zq = torch.floor((chan[:, 2] - margin) / binw[:, None]).to(torch.int32)
    zb = torch.clamp(((zq.long() + b0[:, None].long() + 2 ** 31) % 2 ** 32
                      - 2 ** 31), 0, czm.Z_BINS - 1).to(torch.int32)
    okf = ok.to(torch.float32)
    return (torch.where(ok, pid0, p_cnt).to(torch.int32), zb, chan,
            torch.stack([okf, chan[:, 2] * okf], 1), b0)


def _model_seed_heights(hist, b0, cfg):
    """csrc/plane_fit.cu's seed kernel in torch: lane l of a patch's warp
    holds bins l, l + 32, l + 64 and l + 96; the eligible counts'
    inclusive prefix by lanes within each group of 32 plus the groups
    before; the shares added as (s0 + s2) + (s1 + s3) on each lane, then
    lanes l and l + 16, 8, 4, 2, 1."""
    p_cnt = cfg.num_patches
    bsz, _, p_pad, _ = hist.shape
    cnt = hist[:, 0, :p_cnt].reshape(bsz, p_cnt, 4, 32)
    zsum = hist[:, 1, :p_cnt].reshape(bsz, p_cnt, 4, 32)
    j = torch.arange(128).reshape(4, 32)
    zone0_end = cfg.num_rings_each_zone[0] * cfg.num_sectors_each_zone[0]
    elig = ~((torch.arange(p_cnt) < zone0_end)[None, :, None, None]
             & (j[None, None] < b0[:, None, None, None]))
    cnt_e = cnt * elig.to(torch.float32)
    zsum_e = zsum * elig.to(torch.float32)
    totals = cnt_e.sum(-1)
    incl = torch.cumsum(cnt_e, -1) + (torch.cumsum(totals, -1)
                                      - totals)[..., None]
    need = torch.clamp(totals.sum(-1), max=float(cfg.num_lpr))
    take = torch.minimum(torch.clamp(need[..., None, None] - (incl - cnt_e),
                                     min=0.0), cnt_e)
    share = take * zsum_e / torch.clamp(cnt_e, min=1.0)
    acc = (share[:, :, 0] + share[:, :, 2]) + (share[:, :, 1]
                                               + share[:, :, 3])
    for s in (16, 8, 4, 2, 1):
        acc = acc[..., :s] + acc[..., s:2 * s]
    lpr = torch.where(need > 0, acc[..., 0] / torch.clamp(need, min=1.0),
                      0.0)
    live = cnt.sum((-2, -1)) > cfg.num_min_pts
    tab = torch.zeros((bsz, p_pad, 5))
    tab[:, :p_cnt, 2] = 1.0
    tab[:, :p_cnt, 3] = lpr + fused.f32(cfg.th_seeds)
    return lpr, live, tab


@pytest.fixture(scope="module")
def level_a_cloud():
    return _cloud("level_a")


@pytest.mark.parametrize("case", list(CZM_CONFIGS))
def test_kernel_models_equal_the_plain_versions(level_a_cloud, case):
    """The three kernels' formulations (models above; the plane kernel
    computes the plain version's operations in its order) bit for bit the
    plain versions, and ``estimate_ground`` composed of them bit for bit
    the plain route, on the cloud and its mirror image with
    ``czm_specials``' points and empty cloud, under each configuration."""
    pts, mask, _, tc = level_a_cloud
    cfg = dataclasses.replace(tc, **CZM_CONFIGS[case])
    a, m = _t(pts), _t(mask)
    mirrored = torch.cat([-a[:, :2], a[:, 2:]], 1)
    points, msk = czm_specials(torch.stack([a, mirrored]),
                               torch.stack([m, m]), cfg)
    got = _model_czm_points(points, msk, cfg)
    ref = czm.czm_points_plain(points, msk, cfg)
    for name, g, r in zip(("pid", "zb", "chan", "weights", "b0"), got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name
    pid, zb, chan, weights, b0 = ref
    assert b0[2] == 0 and (pid[2] == cfg.num_patches).all()
    assert pid[0, 13] == cfg.num_patches and pid[0, 15] < cfg.num_patches
    assert not torch.isnan(chan).any() and (pid[:2] < cfg.num_patches).any()

    p_pad = czm._pad128(cfg.num_patches + 1)
    hist = cross_histogram_plain(pid, zb, weights, p_pad,
                                 czm.Z_BINS).contiguous()
    seeds = czm.seed_heights_plain(hist, b0, cfg)
    for g, r in zip(_model_seed_heights(hist, b0, cfg), seeds):
        assert torch.equal(g, r)
    for b0_case in (torch.zeros_like(b0), torch.full_like(b0, czm.Z_BINS)):
        for g, r in zip(_model_seed_heights(hist, b0_case, cfg),
                        czm.seed_heights_plain(hist, b0_case, cfg)):
            assert torch.equal(g, r)

    # estimate_ground of the pieces against the plain route
    ptab = czm._patch_tables(cfg, torch.device("cpu"))
    _, live, tab = seeds
    for _ in range(cfg.num_iter - 1):
        tab = czm.plane_fit_plain(fit_iteration_moments_plain(
            pid, chan, tab, p_pad, cfg.num_patches, exact=False), ptab, cfg)
    sums = fit_iteration_moments_plain(pid, chan, tab, p_pad,
                                       cfg.num_patches)
    n1, n2, n3, _, sv, _, tab, accepted = czm.plane_fit_plain(
        sums, ptab, cfg, final=True, patch_live=live)
    assert torch.isfinite(torch.stack([n1, n2, n3, sv])).all()
    assert torch.equal(n3[2], torch.ones_like(n3[2]))     # the empty cloud
    code = classify_points_plain(pid, chan, tab, p_pad, cfg.num_patches)
    res = tpw.estimate_ground(points, msk, cfg)
    assert torch.equal(res.ground, (code & 1) > 0)
    assert torch.equal(res.patch_accepted, accepted)
    assert torch.equal(res.patch_normal, torch.stack([n1, n2, n3], -1))
    assert int(res.ground[:2].sum()) > 1000 and not res.ground[2].any()


def test_plane_fit_plain_sanitises_and_gates():
    """Empty, one-point, NaN and flat patches: finite normals (0, 0, 1)
    where the eigenpair is undefined, n_z >= 0, zero rows past P, the last
    fit's first four columns those of an intermediate fit, and the flags
    the gates' sum."""
    cfg = dataclasses.replace(qt.PipelineConfig().patchwork,
                              using_global_elevation=True)
    p_cnt, p_pad = cfg.num_patches, 512
    rng = np.random.default_rng(7)
    xyz = rng.normal(0, [2.0, 2.0, 0.02], (p_cnt, 64, 3)).astype(np.float32)
    xyz[..., 2] += rng.uniform(-2.5, 0.5, (p_cnt, 1)).astype(np.float32)
    px, py, pz = (_t(xyz[..., k]) for k in range(3))
    mom = torch.stack([torch.ones_like(px), px, py, pz, px * px, px * py,
                       px * pz, py * py, py * pz, pz * pz], -1).sum(1)
    mom[0] = 0.0                                   # empty
    mom[1] = mom[1] / mom[1, 0]                    # one point
    mom[2, 4] = float("nan")
    sums = torch.zeros((1, p_pad, 10))
    sums[0, :p_cnt] = mom
    ptab = czm._patch_tables(cfg, torch.device("cpu"))
    live = torch.ones((1, p_cnt), dtype=torch.bool)
    live[0, 5] = False
    tab = czm.plane_fit_plain(sums, ptab, cfg)
    n1, n2, n3, th, sv, elev, last, accepted = czm.plane_fit_plain(
        sums, ptab, cfg, final=True, patch_live=live)
    assert torch.equal(tab[..., :4], last[..., :4])
    assert torch.equal(tab[0, p_cnt:], torch.zeros(p_pad - p_cnt, 5))
    assert torch.equal(last[0, p_cnt:], torch.zeros(p_pad - p_cnt, 5))
    assert [n1[0, 0].item(), n2[0, 0].item(), n3[0, 0].item()] == [0.0, 0.0,
                                                                  1.0]
    assert (n3 >= 0).all() and torch.isfinite(n3).all()
    flags = last[0, :p_cnt, 4].to(torch.int32)
    assert torch.equal((flags & 1) > 0, accepted[0])
    assert torch.equal((flags & 8) > 0, live[0])
    assert not accepted[0, 5] and accepted[0].sum() > 100
    assert (elev[0, 3:] < 1.0).all() and torch.isfinite(sv[0, 3:]).all()


# ------------------------------------------------------------- wrappers --

def test_wrappers_check_inputs_and_count_no_cpu_launch(level_a_cloud):
    pts, mask, _, tc = level_a_cloud
    points, msk = _t(pts[:4096])[None], _t(mask[:4096])[None]
    before = dict(LAUNCHES)
    out = czm.czm_points(points, msk, tc)
    for g, r in zip(out, czm.czm_points_plain(points, msk, tc)):
        assert torch.equal(g, r)
    pid, zb, chan, weights, b0 = out
    hist = cross_histogram_plain(pid, zb, weights, 512, 128).contiguous()
    lpr, live, tab = czm.seed_heights(hist, b0, tc)
    sums = fit_iteration_moments_plain(pid, chan, tab, 512, tc.num_patches)
    ptab = czm._patch_tables(tc, torch.device("cpu"))
    assert torch.equal(czm.plane_fit(sums, ptab, tc),
                       czm.plane_fit_plain(sums, ptab, tc))
    czm.plane_fit(sums, ptab, tc, final=True, patch_live=live)
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError):
        czm.czm_points(points[0], msk[0], tc)
    with pytest.raises(ValueError):
        czm.czm_points(points, msk[:, :100], tc)
    with pytest.raises(TypeError):
        czm.czm_points(points.double(), msk, tc)
    with pytest.raises(ValueError):
        czm.czm_points(_t(pts[:8192])[None, ::2], _t(mask[:8192])[None, ::2],
                       tc)
    with pytest.raises(ValueError):
        czm.seed_heights(hist[:, :, :, :64].contiguous(), b0, tc)
    with pytest.raises(ValueError):
        czm.seed_heights(hist[:, :, :504].contiguous(), b0, tc)
    with pytest.raises(TypeError):
        czm.seed_heights(hist, b0.long(), tc)
    with pytest.raises(ValueError):
        czm.plane_fit(sums[..., :9].contiguous(), ptab, tc)
    with pytest.raises(ValueError):
        czm.plane_fit(sums, ptab[:, :100].contiguous(), tc)
    with pytest.raises(ValueError):
        czm.plane_fit(sums, ptab, tc, final=True)
    with pytest.raises(TypeError):
        czm.plane_fit(sums, ptab, tc, final=True, patch_live=live.float())
