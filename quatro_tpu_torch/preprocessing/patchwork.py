"""Patchwork ground segmentation over the Concentric Zone Model.

PyTorch counterpart of ``quatro_tpu/preprocessing/patchwork.py`` (the
reference's ``PatchWork::estimate_ground``, include/patchwork.hpp:329-476):
per-point CZM patch ids, a (patch, z-bin) histogram for the seed heights,
``num_iter`` plane fits per patch (one fused kernel each), the
uprightness / elevation / flatness gates, and one classification pass.
The three N-sized passes are the kernels of ``ops/segment.py``:
``cross_histogram`` (B8), ``fit_iteration_moments`` (B9) and
``classify_points`` (B10); everything else is elementwise or on the
~500-patch axis.

Every function takes a leading batch axis (the pipeline runs source and
target as one batch of two); ``estimate_ground`` also takes one cloud.
Moments use patch-relative x/y (offsets from each patch's static CZM
centre) to keep the raw-moment covariance centred.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from quatro_tpu_torch.config import PatchworkConfig
from quatro_tpu_torch.ops.normals import smallest_eigenpair_sym3
from quatro_tpu_torch.ops.segment import (classify_points, cross_histogram,
                                          fit_iteration_moments)
from quatro_tpu_torch.utils import fused

Z_BINS = 128            # seed-stage z bins per patch


class PatchworkResult(NamedTuple):
    ground: torch.Tensor          # (B, N) bool
    nonground: torch.Tensor       # (B, N) bool
    dropped: torch.Tensor         # (B, N) bool: outside the CZM or a skipped patch
    patch_normal: torch.Tensor    # (B, P, 3) fitted plane normals
    patch_accepted: torch.Tensor  # (B, P) gate decision per patch
    reverted: torch.Tensor        # (B, N) bool, subset of ground
    rejected: torch.Tensor        # (B, N) bool, subset of nonground


def _pad128(k: int) -> int:
    return ((k + 127) // 128) * 128


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
    """The static per-patch tables on ``device``, copied there once per
    configuration: centre x, centre y, concentric index, elevation and
    flatness thresholds."""
    center_x, center_y = _patch_centers(cfg)
    _, _, conc, elev, flat = _patch_metadata(cfg)
    return (torch.as_tensor(center_x, device=device),
            torch.as_tensor(center_y, device=device),
            torch.as_tensor(conc, device=device),
            torch.as_tensor(elev, dtype=torch.float32, device=device),
            torch.as_tensor(flat, dtype=torch.float32, device=device))


def czm_bin(points: torch.Tensor, mask: torch.Tensor, cfg: PatchworkConfig):
    """Per-point CZM patch id (reference: include/patchwork.hpp:512-540).
    points (..., N, 3), mask (..., N). Returns (patch_id int32, in_czm
    bool); points outside get patch_id = num_patches (a dump slot)."""
    dtype = points.dtype
    nrings_l, nsect_l, bounds, ring_sizes, sector_sizes, offsets = \
        _zone_tables(cfg)
    x, y = points[..., 0], points[..., 1]
    r = fused.hypot(x, y)
    theta = torch.atan2(y, x)
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
    bins below the margin bin b0). Returns (lpr_h (B, P), patch_live)."""
    p_cnt = cfg.num_patches
    dev = hist.device
    cnt_h = hist[:, 0, :p_cnt]
    zsum_h = hist[:, 1, :p_cnt]
    counts = cnt_h.sum(-1)
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
    lpr_sum = (take * zsum_e / torch.clamp(cnt_e, min=1.0)).sum(-1)
    lpr_h = torch.where(need > 0, lpr_sum / torch.clamp(need, min=1.0), 0.0)
    return lpr_h, patch_live


def estimate_ground(points, mask, cfg: PatchworkConfig = PatchworkConfig()
                    ) -> PatchworkResult:
    """Full Patchwork pass on (B, N, 3) points and (B, N) masks (or one
    cloud (N, 3), (N,); the result then has no batch axis)."""
    batched = points.dim() == 3
    if not batched:
        points, mask = points[None], mask[None]
    dtype = points.dtype
    dev = points.device
    p_cnt = cfg.num_patches
    p_pad = _pad128(p_cnt + 1)

    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    # mirror-reflection removal (include/patchwork.hpp:355-365)
    keep = mask & (z >= -1.8 * cfg.sensor_height)
    patch_id, in_czm = czm_bin(points, keep, cfg)
    pid = torch.where(in_czm, patch_id, p_cnt)

    # per-point channels, sanitised so that no NaN reaches a kernel's sums
    pcx, pcy = _patch_center_of_point(torch.clamp(pid, max=p_cnt - 1), cfg,
                                      dtype)
    ok = in_czm & torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)
    x_c = torch.where(ok, x, 0.0)
    y_c = torch.where(ok, y, 0.0)
    z_c = torch.where(ok, z, 0.0)
    px = torch.where(ok, x - pcx, 0.0)
    py = torch.where(ok, y - pcy, 0.0)
    chan = torch.stack([x_c, y_c, z_c, px, py], 1).to(torch.float32)
    chan = chan.contiguous()
    pid = torch.where(ok, pid, p_cnt).to(torch.int32).contiguous()
    center_x, center_y, conc, elev_thr, flat_thr = _patch_tables(cfg, dev)

    # --- seed stage: margin-anchored (patch, z-bin) histogram (B8) --------
    zmin = torch.where(keep, z, math.inf).amin(-1)
    zmax = torch.where(keep, z, -math.inf).amax(-1)
    zspan = torch.clamp(zmax - zmin, min=1e-6)
    binw = zspan / Z_BINS
    margin = (cfg.adaptive_seed_selection_margin * cfg.sensor_height
              if cfg.sensor_height != 0.0 else -0.1)
    b0 = torch.clamp(torch.ceil((fused.f32(margin) - zmin) / binw), 0,
                     Z_BINS).to(torch.int32)
    zb = torch.clamp(torch.floor((z_c - margin) / binw[:, None]).to(torch.int32)
                     + b0[:, None], 0, Z_BINS - 1).to(torch.int32)
    okf = ok.to(torch.float32)
    hist = cross_histogram(pid, zb.contiguous(),
                           torch.stack([okf, z_c.to(torch.float32) * okf],
                                       1).contiguous(), p_pad, Z_BINS)
    lpr_h, patch_live = _seed_heights(hist, b0, cfg)

    zeros_p = torch.zeros_like(lpr_h)
    # seed membership: z < seed height + th_seeds
    tab = _plane_tab(zeros_p, zeros_p, torch.ones_like(lpr_h),
                     lpr_h + cfg.th_seeds, zeros_p, p_pad)

    # --- iterative plane fit: one fused kernel per iteration (B9) ---------
    # (include/patchwork.hpp:545-586; covariance on patch-relative offsets)
    for it in range(cfg.num_iter):
        # the intermediate iterations only decide the next membership:
        # bf16 moments; the last feeds the covariance gates and is exact
        s = fit_iteration_moments(pid, chan, tab, p_pad, p_cnt,
                                  exact=(it + 1 == cfg.num_iter))
        s = s[:, :p_cnt].permute(2, 0, 1)          # (10, B, P)
        cnt = torch.clamp(s[0], min=1.0)
        mx_r, my_r, mz_r = s[1] / cnt, s[2] / cnt, s[3] / cnt
        cxx = s[4] / cnt - mx_r * mx_r
        cxy = s[5] / cnt - mx_r * my_r
        cxz = s[6] / cnt - mx_r * mz_r
        cyy = s[7] / cnt - my_r * my_r
        cyz = s[8] / cnt - my_r * mz_r
        czz = s[9] / cnt - mz_r * mz_r
        (n1, n2, n3), lam_min = smallest_eigenpair_sym3(cxx, cxy, cxz, cyy,
                                                        cyz, czz)
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
        mx_w = mx_r + center_x                      # world-frame patch mean
        my_w = my_r + center_y
        d = -(n1 * mx_w + n2 * my_w + n3 * mz_r)
        th_dist_d = cfg.th_dist - d
        surface_var = lam_min / torch.clamp(trace, min=1e-30)
        elevation = mz_r
        if it + 1 < cfg.num_iter:
            tab = _plane_tab(n1, n2, n3, th_dist_d, zeros_p, p_pad)

    # --- gates, folded into the last table's flags (patchwork.hpp:394-451)
    upright = torch.abs(n3) >= cfg.uprightness_thr
    near = conc < cfg.num_rings_of_interest
    high = elevation > elev_thr
    flat_ok = flat_thr > surface_var
    near_accept = torch.where(high, flat_ok, True)
    if cfg.using_global_elevation:
        far_accept = ~(elevation > cfg.global_elevation_threshold)
    else:
        far_accept = torch.ones_like(upright)
    accepted = upright & torch.where(near, near_accept, far_accept) & patch_live
    # revert / reject bookkeeping (patchwork.hpp:410-426)
    revert_patch = patch_live & upright & near & high & flat_ok
    reject_patch = patch_live & upright & near & high & ~flat_ok
    flags_p = (accepted.to(torch.float32) + 2 * revert_patch.to(torch.float32)
               + 4 * reject_patch.to(torch.float32)
               + 8 * patch_live.to(torch.float32))
    tab = _plane_tab(n1, n2, n3, th_dist_d, flags_p, p_pad)

    # --- one int32 code per point (B10) ----------------------------------
    code = classify_points(pid, chan, tab, p_pad, p_cnt)
    ground = (code & 1) > 0
    nonground = (code & 2) > 0
    res = PatchworkResult(ground, nonground, mask & ~ground & ~nonground,
                          torch.stack([n1, n2, n3], -1), accepted,
                          (code & 4) > 0, (code & 8) > 0)
    if not batched:
        return PatchworkResult(*(t[0] for t in res))
    return res
