"""Patchwork's per-point binning and per-patch plane algebra.

``preprocessing/patchwork.py::estimate_ground`` bins every point into its
Concentric Zone Model patch, derives the channels of the three Patchwork
kernels (B8-B10, ``ops/segment.py``), takes each patch's seed height from
B8's histogram and, after each plane-fit iteration (B9), each patch's plane
from its ten moment sums. The JAX package runs this arithmetic as XLA loop
fusions around its Pallas kernels (``quatro_tpu/preprocessing/
patchwork.py:119-186, 232-319, 328-387``; no Pallas kernel there); the
port runs it as three hand-written kernels, each behind a wrapper in
``ops/range_image.py``'s style:

- ``czm_points``: csrc/czm_points.cu, a z-range pass (per-chunk minima and
  maxima of the kept heights) and a point pass (the patch id, the patch
  centre gathered from ``point_centers``' table, the five channels, the
  z-bin and B8's weights), two launches;
- ``seed_heights``: csrc/plane_fit.cu, a warp a patch over B8's 128 z-bins
  (the seed table of the first plane fit);
- ``plane_fit``: csrc/plane_fit.cu, a thread a patch: covariance, the
  closed-form eigenpair (csrc/eig_sym3.cuh), the next delivery table and,
  on the last fit, the gates folded into its flags. Capturable: no host
  copy, its constants the cached ``_patch_tables``.

For CUDA tensors a wrapper checks its inputs (ValueError), launches and
counts the call in ``LAUNCHES``; for CPU tensors it runs its plain version
(``*_plain``, the torch operations Patchwork ran before the kernels).
There is no fallback between the two, and the kernels equal their plain
versions on the card bit for bit.

Every function takes a leading batch axis (the pipeline runs source and
target as one batch of two).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from quatro_tpu_torch.config import PatchworkConfig
from quatro_tpu_torch.ops.launch import (LAUNCHES, check, launch, same_device,
                                         size_route)
from quatro_tpu_torch.ops.normals import smallest_eigenpair_sym3
from quatro_tpu_torch.utils import fused

Z_BINS = 128            # seed-stage z bins per patch
MAX_ZONES = 8           # zones the point kernel's parameter table holds
ZRANGE_CHUNK = 4096     # points per z-range partial of czm_points
_PLANE_OUT = 6          # n1, n2, n3, th_dist_d, surface_var, elevation


def _pad128(k: int) -> int:
    return ((k + 127) // 128) * 128


# ------------------------------------------------------- static tables --

def _patch_metadata(cfg: PatchworkConfig):
    """Static per-patch (zone, ring, concentric index, elevation and
    flatness thresholds) tables, numpy."""
    zones, rings, conc = [], [], []
    concentric = 0
    for k in range(cfg.num_zones):
        for ring in range(cfg.num_rings_each_zone[k]):
            for _ in range(cfg.num_sectors_each_zone[k]):
                zones.append(k)
                rings.append(ring)
                conc.append(concentric)
            concentric += 1
    zones, rings, conc = np.array(zones), np.array(rings), np.array(conc)
    # threshold index = ring_idx + 2 * zone_idx (a quirk of the reference,
    # include/patchwork.hpp:407-408), only read where concentric < 4
    tidx = np.clip(rings + 2 * zones, 0, len(cfg.elevation_thresholds) - 1)
    elev_thr = np.asarray(cfg.elevation_thresholds)[tidx]
    flat_thr = np.asarray(cfg.flatness_thresholds)[tidx]
    return zones, rings, conc, elev_thr, flat_thr


def _patch_centers(cfg: PatchworkConfig):
    """Static (P,) xy CZM patch-centre tables, numpy f32."""
    bounds = list(cfg.ring_boundaries)
    cx, cy = [], []
    for k in range(cfg.num_zones):
        nrings = cfg.num_rings_each_zone[k]
        nsect = cfg.num_sectors_each_zone[k]
        ring_sz = (bounds[k + 1] - bounds[k]) / nrings
        sect_sz = 2 * np.pi / nsect
        for ring in range(nrings):
            r_c = bounds[k] + (ring + 0.5) * ring_sz
            for sector in range(nsect):
                th_c = (sector + 0.5) * sect_sz
                cx.append(r_c * np.cos(th_c))
                cy.append(r_c * np.sin(th_c))
    return np.asarray(cx, np.float32), np.asarray(cy, np.float32)


def _zone_tables(cfg: PatchworkConfig):
    """Per-zone ring and sector counts, ring and sector sizes, and patch
    offsets (Python numbers)."""
    nrings = list(cfg.num_rings_each_zone)
    nsect = list(cfg.num_sectors_each_zone)
    bounds = list(cfg.ring_boundaries)
    ring_sizes = [(bounds[k + 1] - bounds[k]) / nrings[k]
                  for k in range(cfg.num_zones)]
    sector_sizes = [2 * np.pi / s for s in nsect]
    offsets = [0] + [int(v) for v in np.cumsum(np.multiply(nrings, nsect))][:-1]
    return nrings, nsect, bounds, ring_sizes, sector_sizes, offsets


def _zone_select(zone: torch.Tensor, table, dtype) -> torch.Tensor:
    """Per-point zone-table lookup as a where-chain over the zones (the
    Python numbers round to dtype as they enter; no host-to-device
    copy)."""
    out = torch.full(zone.shape, table[-1], dtype=dtype, device=zone.device)
    for k in range(len(table) - 2, -1, -1):
        out = torch.where(zone == k, table[k], out)
    return out


@functools.lru_cache(maxsize=8)
def _patch_tables(cfg: PatchworkConfig, device: torch.device):
    """The static per-patch constants of the plane fits on ``device``, one
    (5, P) f32 tensor copied there once per configuration: centre x,
    centre y, elevation and flatness thresholds, concentric index."""
    center_x, center_y = _patch_centers(cfg)
    _, _, conc, elev, flat = _patch_metadata(cfg)
    return torch.as_tensor(np.stack([center_x, center_y, elev, flat, conc]),
                           dtype=torch.float32, device=device).contiguous()


@functools.lru_cache(maxsize=8)
def point_centers(cfg: PatchworkConfig, device: torch.device):
    """(2, P) f32: the patch-centre x and y that ``_patch_center_of_point``
    gives each patch id, evaluated once per configuration on ``device`` (so
    with that device's cos and sin); both routes of ``czm_points`` gather
    a point's centre from it."""
    pid = torch.arange(cfg.num_patches, dtype=torch.int32, device=device)
    return torch.stack(_patch_center_of_point(pid, cfg,
                                              torch.float32)).contiguous()


@functools.lru_cache(maxsize=8)
def _zone_args(cfg: PatchworkConfig):
    """The point kernel's zone table as host tensors: f32 (4, Z) rows
    [bounds[1:] (the zone edges; the last unused), min ranges, ring sizes,
    sector sizes] and int32 (3, Z) rows [ring counts, sector counts, patch
    offsets], each Python number rounded to f32 as ``_zone_select``
    rounds it."""
    nrings, nsect, bounds, ring_sizes, sector_sizes, offsets = \
        _zone_tables(cfg)
    f = torch.tensor([list(bounds[1:]), list(cfg.min_ranges_each_zone),
                      ring_sizes, sector_sizes], dtype=torch.float32)
    i = torch.tensor([nrings, nsect, offsets], dtype=torch.int32)
    return f.contiguous(), i.contiguous()


# ------------------------------------------------------------ per point --

def czm_bin(points: torch.Tensor, mask: torch.Tensor, cfg: PatchworkConfig):
    """Per-point CZM patch id (reference: include/patchwork.hpp:512-540).
    points (..., N, 3), mask (..., N). Returns (patch_id int32, in_czm
    bool); points outside get patch_id = num_patches (a dump slot)."""
    dtype = points.dtype
    nrings_l, nsect_l, bounds, ring_sizes, sector_sizes, offsets = \
        _zone_tables(cfg)
    x, y = points[..., 0], points[..., 1]
    r = fused.hypot(x, y)
    theta = fused.atan2(y, x)
    theta = torch.where(theta > 0, theta, theta + 2 * math.pi)

    in_czm = (r > cfg.min_r) & (r <= cfg.max_r) & mask
    zone = torch.zeros(r.shape, dtype=torch.int32, device=r.device)
    for b in bounds[1:-1]:
        zone = zone + (r >= b).to(torch.int32)

    min_rng = _zone_select(zone, list(cfg.min_ranges_each_zone), dtype)
    ring_sz = _zone_select(zone, ring_sizes, dtype)
    sect_sz = _zone_select(zone, sector_sizes, dtype)
    nrings = _zone_select(zone, nrings_l, torch.int32)
    nsect = _zone_select(zone, nsect_l, torch.int32)
    offs = _zone_select(zone, offsets, torch.int32)

    ring = torch.minimum(((r - min_rng) / ring_sz).to(torch.int32), nrings - 1)
    sector = torch.minimum((theta / sect_sz).to(torch.int32), nsect - 1)
    ring = torch.clamp(ring, min=0)
    patch = offs + ring * nsect + sector
    return (torch.where(in_czm, patch, cfg.num_patches).to(torch.int32),
            in_czm)


def _patch_center_of_point(pid: torch.Tensor, cfg: PatchworkConfig, dtype):
    """Per-point CZM patch-centre xy, elementwise from the patch id (the
    JAX package's gather-free mirror of the _patch_centers table)."""
    _, nsect_l, bounds, ring_sizes, sector_sizes, offsets = _zone_tables(cfg)
    zone = torch.zeros(pid.shape, dtype=torch.int32, device=pid.device)
    for off in offsets[1:]:
        zone = zone + (pid >= off).to(torch.int32)
    offs = _zone_select(zone, offsets, torch.int32)
    nsect = _zone_select(zone, nsect_l, torch.int32)
    ring_sz = _zone_select(zone, ring_sizes, dtype)
    sect_sz = _zone_select(zone, sector_sizes, dtype)
    min_rng = _zone_select(zone, [float(b) for b in bounds[:-1]], dtype)

    local = pid - offs
    ring = torch.div(local, torch.clamp(nsect, min=1), rounding_mode="floor")
    sector = local - ring * nsect
    r_c = min_rng + (ring.to(dtype) + 0.5) * ring_sz
    th_c = (sector.to(dtype) + 0.5) * sect_sz
    return r_c * torch.cos(th_c), r_c * torch.sin(th_c)


def _margin(cfg: PatchworkConfig) -> float:
    """The seed stage's height margin (-0.1 without a sensor height)."""
    return (cfg.adaptive_seed_selection_margin * cfg.sensor_height
            if cfg.sensor_height != 0.0 else -0.1)


def czm_points_plain(points: torch.Tensor, mask: torch.Tensor,
                     cfg: PatchworkConfig):
    """``czm_points``' plain version: the mirror-reflection cut, the CZM
    bins, each point's patch centre gathered from ``point_centers``, the
    sanitised channels, and the seed stage's margin-anchored z-bins over
    the kept heights' range."""
    p_cnt = cfg.num_patches
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    # mirror-reflection removal (include/patchwork.hpp:355-365)
    keep = mask & (z >= -1.8 * cfg.sensor_height)
    patch_id, in_czm = czm_bin(points, keep, cfg)
    pid = torch.where(in_czm, patch_id, p_cnt)

    # per-point channels, sanitised so that no NaN reaches a kernel's sums
    pcx, pcy = point_centers(cfg, points.device)[
        :, torch.clamp(pid, 0, p_cnt - 1).long()]
    ok = in_czm & torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)
    x_c = torch.where(ok, x, 0.0)
    y_c = torch.where(ok, y, 0.0)
    z_c = torch.where(ok, z, 0.0)
    px = torch.where(ok, x - pcx, 0.0)
    py = torch.where(ok, y - pcy, 0.0)
    chan = torch.stack([x_c, y_c, z_c, px, py], 1).to(torch.float32)
    pid = torch.where(ok, pid, p_cnt).to(torch.int32).contiguous()

    # the seed stage's margin-anchored z-bins
    zmin = torch.where(keep, z, math.inf).amin(-1)
    zmax = torch.where(keep, z, -math.inf).amax(-1)
    zspan = torch.clamp(zmax - zmin, min=1e-6)
    binw = zspan / Z_BINS
    margin = _margin(cfg)
    b0 = torch.clamp(torch.ceil((fused.f32(margin) - zmin) / binw), 0,
                     Z_BINS).to(torch.int32)
    zb = torch.clamp(torch.floor((z_c - margin) / binw[:, None]).to(torch.int32)
                     + b0[:, None], 0, Z_BINS - 1).to(torch.int32)
    okf = ok.to(torch.float32)
    weights = torch.stack([okf, z_c.to(torch.float32) * okf], 1)
    return pid, zb.contiguous(), chan.contiguous(), weights.contiguous(), b0


def czm_points(points: torch.Tensor, mask: torch.Tensor,
               cfg: PatchworkConfig):
    """Patchwork's per-point work on (B, N, 3) f32 points and (B, N) bool
    masks, both contiguous: (pid (B, N) int32, the patch id, P where a
    point is not in the CZM or not finite; zb (B, N) int32, the seed
    stage's z-bin; chan (B, 5, N) f32 [x, y, z, x - centre x, y - centre
    y], zero where the id is P; weights (B, 2, N) f32, B8's [1, z] where
    the id is below P; b0 (B,) int32, each cloud's margin bin). For CUDA
    tensors the z-range and point kernels of csrc/czm_points.cu (the zone
    table in the kernel's parameters up to MAX_ZONES zones, else copied to
    the card: the wide route, counted in ``SIZE_ROUTES``), bit for bit
    ``czm_points_plain``, which runs for CPU tensors."""
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points: expected (B, N, 3), got "
                         f"{tuple(points.shape)}")
    bsz, n = points.shape[:2]
    check("points", points, (bsz, n, 3))
    check("mask", mask, (bsz, n), torch.bool)
    if same_device(points, mask).type != "cuda":
        return czm_points_plain(points, mask, cfg)
    dev = points.device
    pid, zb = (torch.empty((bsz, n), dtype=torch.int32, device=dev)
               for _ in range(2))
    chan = torch.empty((bsz, 5, n), dtype=torch.float32, device=dev)
    weights = torch.empty((bsz, 2, n), dtype=torch.float32, device=dev)
    b0 = torch.empty((bsz,), dtype=torch.int32, device=dev)
    if bsz == 0 or n == 0:
        return pid, zb, chan, weights, b0
    chunks = -(-n // ZRANGE_CHUNK)
    zpart = torch.empty((bsz, chunks, 2), dtype=torch.float32, device=dev)
    zone_f, zone_i = _zone_args(cfg)
    past = cfg.num_zones > MAX_ZONES
    if past:        # the table as device arrays: the kernel's wide route
        zone_f, zone_i = zone_f.to(dev), zone_i.to(dev)
    launch("czm_points", points, mask, bsz, n, ZRANGE_CHUNK, zone_f, zone_i,
           cfg.num_zones, cfg.num_patches, fused.f32(cfg.min_r),
           fused.f32(cfg.max_r), fused.f32(-1.8 * cfg.sensor_height),
           fused.f32(2 * math.pi), fused.f32(_margin(cfg)),
           point_centers(cfg, dev), zpart, pid, zb, chan, weights, b0)
    LAUNCHES["czm_points"] += 1
    size_route("czm_points", past)
    return pid, zb, chan, weights, b0


# ------------------------------------------------------------ per patch --

def _plane_tab(n1, n2, n3, th, flags, p_pad: int) -> torch.Tensor:
    """(B, p_pad, 5) f32 delivery table [n1, n2, n3, th, flags], zero rows
    past the P patches."""
    t = torch.stack([n1, n2, n3, th, flags], -1).to(torch.float32)
    return torch.nn.functional.pad(t, (0, 0, 0, p_pad - t.shape[1])
                                   ).contiguous()


def _seed_heights(hist: torch.Tensor, b0: torch.Tensor,
                  cfg: PatchworkConfig) -> tuple:
    """Seed height per patch from the (B, 2, p_pad, Z) count / z-sum
    histogram: the mean z of the num_lpr lowest eligible points, the
    boundary bin's points taken at the bin's mean (zone 0 excludes the
    bins below the margin bin b0), the bins' shares added in
    ``fused.pairwise_sum``'s fixed order. Returns (lpr_h (B, P),
    patch_live)."""
    p_cnt = cfg.num_patches
    dev = hist.device
    cnt_h = hist[:, 0, :p_cnt]
    zsum_h = hist[:, 1, :p_cnt]
    counts = cnt_h.sum(-1)                         # integer counts: exact
    patch_live = counts > cfg.num_min_pts          # strict >, patchwork.hpp:386

    zone0_end = int(cfg.num_rings_each_zone[0] * cfg.num_sectors_each_zone[0])
    is_zone0 = torch.arange(p_cnt, device=dev) < zone0_end
    below = torch.arange(Z_BINS, device=dev)[None, :] < b0[:, None]   # (B, Z)
    elig = ~(is_zone0[None, :, None] & below[:, None, :])
    cnt_e = cnt_h * elig
    zsum_e = zsum_h * elig
    cc = torch.cumsum(cnt_e, -1)                   # integer counts: exact
    need = torch.clamp(cc[..., -1], max=float(cfg.num_lpr))
    take = torch.minimum(torch.clamp(need[..., None] - (cc - cnt_e), min=0.0),
                         cnt_e)
    lpr_sum = fused.pairwise_sum(take * zsum_e / torch.clamp(cnt_e, min=1.0))
    lpr_h = torch.where(need > 0, lpr_sum / torch.clamp(need, min=1.0), 0.0)
    return lpr_h, patch_live


def seed_heights_plain(hist: torch.Tensor, b0: torch.Tensor,
                       cfg: PatchworkConfig):
    """``seed_heights``' plain version: ``_seed_heights``, then the first
    plane fit's table (membership z < seed height + th_seeds)."""
    lpr_h, patch_live = _seed_heights(hist, b0, cfg)
    zeros_p = torch.zeros_like(lpr_h)
    tab = _plane_tab(zeros_p, zeros_p, torch.ones_like(lpr_h),
                     lpr_h + cfg.th_seeds, zeros_p, hist.shape[2])
    return lpr_h, patch_live, tab


def seed_heights(hist: torch.Tensor, b0: torch.Tensor, cfg: PatchworkConfig):
    """(lpr_h (B, P) f32 seed heights, patch_live (B, P) bool, the first
    plane fit's table (B, p_pad, 5) f32 [0, 0, 1, lpr_h + th_seeds, 0],
    zero rows past P) from B8's (B, 2, p_pad, Z_BINS) count / z-sum
    histogram and the margin bins b0 (B,) int32, contiguous. For CUDA
    tensors csrc/plane_fit.cu's seed kernel (a warp a patch, the bins'
    shares added in ``fused.pairwise_sum``'s tree), bit for bit
    ``seed_heights_plain``, which runs for CPU tensors."""
    if hist.dim() != 4 or hist.shape[1] != 2 or hist.shape[3] != Z_BINS:
        raise ValueError(f"hist: expected (B, 2, p_pad, {Z_BINS}), got "
                         f"{tuple(hist.shape)}")
    bsz, _, p_pad, _ = hist.shape
    p_cnt = cfg.num_patches
    if p_pad <= p_cnt:
        raise ValueError(f"hist: {p_pad} rows hold no dump row past "
                         f"{p_cnt} patches")
    check("hist", hist, tuple(hist.shape))
    check("b0", b0, (bsz,), torch.int32)
    if same_device(hist, b0).type != "cuda":
        return seed_heights_plain(hist, b0, cfg)
    dev = hist.device
    lpr_h = torch.empty((bsz, p_cnt), dtype=torch.float32, device=dev)
    live = torch.empty((bsz, p_cnt), dtype=torch.bool, device=dev)
    tab = torch.empty((bsz, p_pad, 5), dtype=torch.float32, device=dev)
    if bsz == 0:
        return lpr_h, live, tab
    zone0_end = int(cfg.num_rings_each_zone[0] * cfg.num_sectors_each_zone[0])
    launch("seed_heights", hist, b0, bsz, p_pad, p_cnt, zone0_end,
           int(cfg.num_lpr), int(cfg.num_min_pts), fused.f32(cfg.th_seeds),
           lpr_h, live, tab)
    LAUNCHES["seed_heights"] += 1
    return lpr_h, live, tab


def plane_covariance(s):
    """Patch means and covariances from the ten moment sums ``s`` (10, B,
    P) = [count, s_x, s_y, s_z, s_xx, s_xy, s_xz, s_yy, s_yz, s_zz]:
    ``((m_x, m_y, m_z), (c_xx, c_xy, c_xz, c_yy, c_yz, c_zz))``. Each
    entry s_ab / count - m_a m_b rounds its product and its difference
    apart, where XLA's CPU code rounds them once as
    ``ops/normals.py::centered_covariance`` does; ROADMAP C ("Standing
    divergences") says why the plane fit keeps two roundings."""
    cnt = torch.clamp(s[0], min=1.0)
    mx, my, mz = s[1] / cnt, s[2] / cnt, s[3] / cnt
    return (mx, my, mz), (s[4] / cnt - mx * mx, s[5] / cnt - mx * my,
                          s[6] / cnt - mx * mz, s[7] / cnt - my * my,
                          s[8] / cnt - my * mz, s[9] / cnt - mz * mz)


def plane_fit_plain(sums: torch.Tensor, ptab: torch.Tensor,
                    cfg: PatchworkConfig, final: bool = False,
                    patch_live=None):
    """``plane_fit``' plain version: each patch's covariance, its smallest
    eigenpair (``ops/normals.smallest_eigenpair_sym3``), the sanitised and
    upright normal, the plane offset and the surface variation; on the
    last fit the gates (include/patchwork.hpp:394-451) folded into the
    table's flags."""
    p_cnt = cfg.num_patches
    p_pad = sums.shape[1]
    s = sums[:, :p_cnt].permute(2, 0, 1)           # (10, B, P)
    (mx_r, my_r, mz_r), (cxx, cxy, cxz, cyy, cyz, czz) = plane_covariance(s)
    (n1, n2, n3), lam_min = smallest_eigenpair_sym3(cxx, cxy, cxz, cyy, cyz,
                                                    czz)
    # empty or degenerate patches can give NaN normals: sanitise them
    # before they reach a table (patchwork.py:340-347)
    okp = s[0] > 0.5
    n1 = torch.where(okp & torch.isfinite(n1), n1, 0.0)
    n2 = torch.where(okp & torch.isfinite(n2), n2, 0.0)
    n3 = torch.where(okp & torch.isfinite(n3), n3, 1.0)
    lam_min = torch.where(okp & torch.isfinite(lam_min), lam_min, 0.0)
    # deterministic sign: n_z >= 0, so "below plane + th_dist" is ground
    flip = n3 < 0
    n1 = torch.where(flip, -n1, n1)
    n2 = torch.where(flip, -n2, n2)
    n3 = torch.where(flip, -n3, n3)
    trace = cxx + cyy + czz
    mx_w = mx_r + ptab[0]                           # world-frame patch mean
    my_w = my_r + ptab[1]
    d = -(n1 * mx_w + n2 * my_w + n3 * mz_r)
    th_dist_d = cfg.th_dist - d
    zeros_p = torch.zeros_like(n1)
    if not final:
        return _plane_tab(n1, n2, n3, th_dist_d, zeros_p, p_pad)
    surface_var = lam_min / torch.clamp(trace, min=1e-30)
    elevation = mz_r
    # the gates (patchwork.hpp:394-451) and the revert / reject
    # bookkeeping (:410-426)
    upright = torch.abs(n3) >= cfg.uprightness_thr
    near = ptab[4] < cfg.num_rings_of_interest
    high = elevation > ptab[2]
    flat_ok = ptab[3] > surface_var
    near_accept = torch.where(high, flat_ok, True)
    if cfg.using_global_elevation:
        far_accept = ~(elevation > cfg.global_elevation_threshold)
    else:
        far_accept = torch.ones_like(upright)
    accepted = upright & torch.where(near, near_accept, far_accept) & patch_live
    revert_patch = patch_live & upright & near & high & flat_ok
    reject_patch = patch_live & upright & near & high & ~flat_ok
    flags_p = (accepted.to(torch.float32) + 2 * revert_patch.to(torch.float32)
               + 4 * reject_patch.to(torch.float32)
               + 8 * patch_live.to(torch.float32))
    return (n1, n2, n3, th_dist_d, surface_var, elevation,
            _plane_tab(n1, n2, n3, th_dist_d, flags_p, p_pad), accepted)


def plane_fit(sums: torch.Tensor, ptab: torch.Tensor, cfg: PatchworkConfig,
              final: bool = False, patch_live=None):
    """Each patch's plane from one fit's (B, p_pad, 10) f32 moment sums
    (B9's) under the (5, P) per-patch constants ``_patch_tables``, both
    contiguous: the next fit's delivery table (B, p_pad, 5) f32 [n1, n2,
    n3, th_dist_d, 0], zero rows past P; with ``final`` (and the (B, P)
    bool ``patch_live`` of ``seed_heights``) (n1, n2, n3, th_dist_d,
    surface_var, elevation, each (B, P) f32, the classification table
    with the gates' flags, accepted (B, P) bool). For CUDA tensors one
    launch of csrc/plane_fit.cu's plane kernel (a thread a patch, no host
    copy, so a CUDA graph captures it), bit for bit ``plane_fit_plain``,
    which runs for CPU tensors."""
    if sums.dim() != 3 or sums.shape[2] != 10:
        raise ValueError(f"sums: expected (B, p_pad, 10), got "
                         f"{tuple(sums.shape)}")
    bsz, p_pad, _ = sums.shape
    p_cnt = cfg.num_patches
    if p_pad < p_cnt:
        raise ValueError(f"sums: {p_pad} rows for {p_cnt} patches")
    check("sums", sums, (bsz, p_pad, 10))
    check("ptab", ptab, (5, p_cnt))
    tensors = [sums, ptab]
    if final:
        if patch_live is None:
            raise ValueError("plane_fit: the last fit needs patch_live")
        check("patch_live", patch_live, (bsz, p_cnt), torch.bool)
        tensors.append(patch_live)
    if same_device(*tensors).type != "cuda":
        return plane_fit_plain(sums, ptab, cfg, final, patch_live)
    dev = sums.device
    tab = torch.empty((bsz, p_pad, 5), dtype=torch.float32, device=dev)
    if final:
        out = torch.empty((_PLANE_OUT, bsz, p_cnt), dtype=torch.float32,
                          device=dev)
        accepted = torch.empty((bsz, p_cnt), dtype=torch.bool, device=dev)
    else:
        out = accepted = None
    if bsz > 0:
        launch("plane_fit", sums, ptab, patch_live if final else None, bsz,
               p_pad, p_cnt, int(final), fused.f32(cfg.th_dist),
               fused.f32(cfg.uprightness_thr),
               int(cfg.num_rings_of_interest),
               int(cfg.using_global_elevation),
               fused.f32(cfg.global_elevation_threshold), tab, out, accepted)
        LAUNCHES["plane_fit"] += 1
    if not final:
        return tab
    return (*out.unbind(0), tab, accepted)
