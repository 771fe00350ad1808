"""Range-image projection and angle-criterion sub-clustering.

PyTorch counterpart of ``quatro_tpu/preprocessing/projection.py`` (the
reference's LeGO-LOAM-derived ``ImageProjection``,
include/imageProjection.hpp): per-point spherical projection to an
(n_scan x horizon_scan) range image (:308-352), the optional LeGO-LOAM
ground test (:365-422), then sub-cluster labelling under the angle
criterion with a size / line-count gate (:424-581), as connected
components by roll-doubling min-label sweeps instead of a serial BFS.

Pixel ownership is deterministic: the closest return wins a pixel (ranges
quantised to ~3.7 mm), ties toward the lowest point index. The packed
uint32 words of the JAX package are int64 here with the same bit widths
and sentinels, sorted with ``torch.sort(stable=True)``.

Every function takes a leading batch axis (the pipeline runs source and
target as one batch of two); ``segment_cloud`` also takes one cloud.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from quatro_tpu_torch.config import LidarConfig, ProjectionConfig
from quatro_tpu_torch.ops.labels import label_sweeps, roll_image
from quatro_tpu_torch.ops.segment import image_lookup
from quatro_tpu_torch.utils import fused

# Range quantisation of the packed owner key: 15 bits over _RMAX metres
# (~3.7 mm buckets); 17 bits of point index.
_RBITS = 15
_RMAX = 120.0
_IBITS = 17
_SENTINEL = (1 << 32) - 1         # uint32 max of the JAX package's words
_INT32_MAX = (1 << 31) - 1
_F32_MAX = torch.finfo(torch.float32).max
_DEG = 180.0 / math.pi
# 4CrossNeighbor's composed offsets, as pairs of diagonal offsets: (0, 2),
# (0, -2), (2, 0), (-2, 0)
_COMPOSED = (((1, 1), (-1, 1)), ((1, -1), (-1, -1)), ((1, 1), (1, -1)),
             ((-1, 1), (-1, -1)))


class ProjectionResult(NamedTuple):
    valid_segments: torch.Tensor   # (B, N) bool: points in accepted sub-clusters
    outliers: torch.Tensor         # (B, N) bool: points in rejected sub-clusters
    ground: torch.Tensor           # (B, N) bool: LeGO-LOAM mode only
    range_image: torch.Tensor      # (B, R, C) f32, f32 max where empty
    label_image: torch.Tensor      # (B, R, C) int64 component ids, -1 invalid
    owner: torch.Tensor            # (B, R, C) int64 owning point index, -1 empty


def _deg2rad(deg: float) -> float:
    """jnp.deg2rad of a Python number: both factors and the product in
    f32 (a Python float holding the f32 value)."""
    return float(np.float32(deg) * np.float32(math.pi / 180.0))


def _sin_cos(rad: float):
    """f32 sine and cosine of an f32 angle, taken once on the host so
    that every device uses the same two constants."""
    a = torch.tensor(rad, dtype=torch.float32)
    return float(torch.sin(a)), float(torch.cos(a))


def project_to_range_image(points: torch.Tensor, mask: torch.Tensor,
                           lidar: LidarConfig, min_range: float = 0.1,
                           max_points: Optional[int] = None):
    """Spherical projection (reference: include/imageProjection.hpp:308-352)
    of (B, N, 3) points. Returns (rows (B, N), cols (B, N), ranges (B, N),
    in_image (B, N), flat (B, N) pixel index (R * C where not in the
    image), range_image (B, R, C), owner (B, R, C)).

    Ownership and the range image come from one stable sort of the
    (pixel, quantised range) key and a scatter of each pixel run's first
    packed (quantised range << 17 | point index) word. With ``max_points``
    only that prefix of the sorted points is scanned (the valid points sort
    first)."""
    rows_n, cols_n = lidar.n_scan, lidar.horizon_scan
    npix = rows_n * cols_n
    bsz, n = mask.shape
    if n > (1 << _IBITS):
        raise ValueError(f"owner packing supports up to {1 << _IBITS} points "
                         f"per cloud, got {n}")
    if npix >= (1 << (32 - _RBITS)):
        raise ValueError(f"range image {rows_n}x{cols_n} overflows the "
                         f"(pixel, range) key ({32 - _RBITS} pixel bits)")
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rxy = fused.hypot(x, y)
    rng = fused.sqrt(torch.clamp(fused.fma(z, z, fused.fma(x, x, y * y)),
                                 min=0.0))
    # degrees and the offset rounded once, and the quotients taken as XLA
    # takes them, by the f32 reciprocal (as CUDA divides by a scalar):
    # every synthetic ring lies on a row edge (utils/fused.py), where one
    # rounding moves a ring's row
    deg = fused.f32(_DEG)
    vert = fused.fma(fused.atan2(z, rxy), deg, fused.f32(lidar.ang_bottom))
    row = torch.floor(vert * fused.recip(lidar.ang_res_y)).to(torch.int64)
    horiz = fused.fma(fused.atan2(x, y), deg, -90.0)
    col = (-torch.round(horiz * fused.recip(lidar.ang_res_x))).to(
        torch.int64) + cols_n // 2
    col = torch.where(col >= cols_n, col - cols_n, col)

    ok = (mask & (row >= 0) & (row < rows_n) & (col >= 0) & (col < cols_n)
          & (rng >= min_range))
    flat = torch.where(ok, row * cols_n + col, npix)

    rq = torch.clamp(rng * fused.f32((1 << _RBITS) / _RMAX), 0,
                     (1 << _RBITS) - 1)
    rq = torch.where(ok, rq, 0.0).to(torch.int64)   # a NaN range never keys
    iota = torch.arange(n, device=points.device)
    packed = torch.where(ok, (rq << _IBITS) + iota, _SENTINEL)
    key_s, order = torch.sort((flat << _RBITS) + rq, dim=-1, stable=True)
    packed_s = torch.gather(packed, 1, order)
    # the valid points sort first: with a bound on their count only that
    # prefix is scanned (overflow drops the highest pixel ids)
    ac = n if (max_points is None or max_points >= n) else max_points
    key_s, packed_s = key_s[:, :ac], packed_s[:, :ac]
    flat_s = key_s >> _RBITS
    is_start = torch.ones_like(flat_s, dtype=torch.bool)
    is_start[:, 1:] = flat_s[:, 1:] != flat_s[:, :-1]
    pos = torch.arange(ac, device=points.device)
    scat = torch.where(is_start & (flat_s < npix), flat_s, npix + pos)
    owner_key = torch.full((bsz, npix + ac), _SENTINEL, dtype=torch.int64,
                           device=points.device)
    owner_key.scatter_(1, scat, packed_s)           # every index distinct
    owner_key = owner_key[:, :npix]
    empty = owner_key == _SENTINEL
    owner = torch.where(empty, -1, owner_key & ((1 << _IBITS) - 1))
    img = torch.where(empty, _F32_MAX,
                      ((owner_key >> _IBITS).to(torch.float32) + 0.5)
                      * fused.f32(_RMAX / (1 << _RBITS)))
    return (row, col, rng, ok, flat, img.reshape(bsz, rows_n, cols_n),
            owner.reshape(bsz, rows_n, cols_n))


def _neighbor_edges(rimg: torch.Tensor, valid: torch.Tensor, dr: int, dc: int,
                    lidar: LidarConfig, theta_rad: float):
    """Symmetric angle-criterion edge mask toward neighbour (dr, dc)
    (reference: include/imageProjection.hpp:526-541). Columns wrap, rows
    do not."""
    shifted = roll_image(rimg, dr, dc)
    svalid = roll_image(valid, dr, dc)
    if dr != 0:
        rows = rimg.shape[-2]
        ridx = torch.arange(rows, device=rimg.device)[:, None]
        svalid = svalid & (ridx + dr >= 0) & (ridx + dr < rows)
    d1 = torch.maximum(rimg, shifted)
    d2 = torch.minimum(rimg, shifted)
    sin_a, cos_a = _sin_cos(_deg2rad(lidar.ang_res_x if dr == 0
                                     else lidar.ang_res_y))
    angle = fused.atan2(d2 * sin_a, fused.fma(d2, -cos_a, d1))
    return valid & svalid & (angle > theta_rad)


def sweep_schedule(rows: int, cols: int, cfg: ProjectionConfig):
    """Each sweep's (dr, dc, doubling steps) in a labelling round's order:
    the neighbour offsets (2^(steps - 1) covers the image's extent along
    the offset; reach 4 under 4CrossNeighbor), then under 4CrossNeighbor
    the composed offsets (0, +-2) / (+-2, 0), reaching half the extent."""
    offsets = cfg.neighbor_offsets
    is_4cross = set(offsets) == {(-1, -1), (-1, 1), (1, 1), (1, -1)}
    sweeps = []
    for dr, dc in offsets:
        steps = ((rows if dr != 0 else cols) - 1).bit_length() + 1
        sweeps.append((dr, dc, min(steps, 3) if is_4cross else steps))
    if is_4cross:
        for a, b in _COMPOSED:
            dr = a[0] + b[0]
            reach = (rows if dr != 0 else cols) // 2
            sweeps.append((dr, a[1] + b[1], max(reach - 1, 1).bit_length()
                           + 1))
    return tuple(sweeps)


def label_components(rimg: torch.Tensor, valid: torch.Tensor,
                     lidar: LidarConfig, cfg: ProjectionConfig):
    """Connected components under the angle criterion, on (B, R, C) range
    images and valid masks.

    Returns (labels (B, R, C): min flat index of the component, -1 for
    invalid pixels; feasible (B, R * C) bool gate per label id;
    pix_feasible (B, R, C) bool). Labels spread by min-label sweeps along
    each neighbour offset (and, for 4CrossNeighbor, the composed zigzag
    offsets; ``sweep_schedule``) in rounds, until a round changes no label
    of the image or ``max_cc_iters`` rounds (the JAX package's
    ``lax.while_loop``): ``ops/labels.label_sweeps``, on the card one
    kernel launch for the batch, each image to its own exit and no flag
    read on the host; on the CPU a ``while_chunks`` device loop that reads
    its "some label changed" flag once per ``ops/labels.CC_CHUNK`` rounds,
    whose rounds past an image's exit change nothing (a round is a fixed
    point at convergence). Component size and line count come from one
    stable (label, row) sort: with |dr| <= 1 a component's rows are
    contiguous, so lines = rmax - rmin + 1."""
    bsz, rows, cols = rimg.shape
    npix = rows * cols
    dev = rimg.device
    if not all(abs(dr) <= 1 for dr, _ in cfg.neighbor_offsets):
        raise ValueError("line-count-as-row-span requires |dr| <= 1 "
                         "neighbour offsets")
    theta = _deg2rad(cfg.segment_theta_deg)
    edges = [(_neighbor_edges(rimg, valid, dr, dc, lidar, theta), dr, dc)
             for dr, dc in cfg.neighbor_offsets]

    # 4CrossNeighbor converges along zigzag paths: straight doubling stops
    # at reach 4 and the composed offsets (0, +-2) / (+-2, 0) are added
    # (projection.py:220-244 of the JAX package)
    is_4cross = set(cfg.neighbor_offsets) == {(-1, -1), (-1, 1), (1, 1),
                                              (1, -1)}
    comp = []
    if is_4cross:
        emap = {(dr, dc): e for e, dr, dc in edges}

        def compose(a, b):
            ea, eb = emap[a], emap[b]
            return (ea & roll_image(eb, *a)) | (eb & roll_image(ea, *b))

        for a, b in _COMPOSED:
            comp.append((compose(a, b), a[0] + b[0], a[1] + b[1]))

    sweeps = sweep_schedule(rows, cols, cfg)
    # int32 labels inside the loop, as the JAX package's label image
    flat_iota = torch.arange(npix, dtype=torch.int32,
                             device=dev).reshape(rows, cols)
    valid = valid.contiguous()
    labels, _ = label_sweeps(
        torch.where(valid, flat_iota, npix), valid,
        [e.contiguous() for e, _, _ in edges + comp], sweeps,
        cfg.max_cc_iters, npix)
    labels = labels.to(torch.int64)

    # --- per-component stats: one stable sort by (label, row), then scans
    row_of = torch.arange(rows, device=dev).repeat_interleave(cols)
    lab_flat = torch.where(valid, labels, npix).reshape(bsz, npix)
    key_s, pix_s = torch.sort(lab_flat * rows + row_of, dim=-1, stable=True)
    lab_s = key_s // rows
    row_s = key_s - lab_s * rows
    pos = torch.arange(npix, device=dev)
    new_lab = torch.ones_like(lab_s, dtype=torch.bool)
    new_lab[:, 1:] = lab_s[:, 1:] != lab_s[:, :-1]
    last_lab = torch.ones_like(new_lab)
    last_lab[:, :-1] = new_lab[:, 1:]

    def cummin_reverse(t):
        return torch.flip(torch.cummin(torch.flip(t, (-1,)), -1).values,
                          (-1,))

    start = torch.cummax(torch.where(new_lab, pos, 0), -1).values
    next_start = cummin_reverse(torch.where(last_lab, pos + 1, npix))
    size = next_start - start
    # first and last row of each run, carried under the position (a bare
    # cummax of rows would leak earlier runs' rows)
    rmin = torch.cummax(torch.where(new_lab, pos * rows + row_s, 0),
                        -1).values % rows
    rmax = (rows - 1) - cummin_reverse(
        torch.where(last_lab, pos * rows + (rows - 1 - row_s),
                    _INT32_MAX)) % rows
    lines = rmax - rmin + 1
    feas_s = (size >= cfg.min_pts_for_subcluster) | (
        (size >= cfg.segment_valid_point_num)
        & (lines >= cfg.segment_valid_line_num))
    feas_s = feas_s & (lab_s < npix)

    feas_img = torch.zeros_like(feas_s).scatter_(1, pix_s, feas_s)
    pix_feasible = feas_img.reshape(bsz, rows, cols) & valid
    # component l's root pixel is flat position l
    feasible = pix_feasible.reshape(bsz, npix) & (lab_flat == pos)
    return torch.where(valid, labels, -1), feasible, pix_feasible


def segment_cloud(points: torch.Tensor, mask: torch.Tensor,
                  lidar: LidarConfig = LidarConfig(),
                  cfg: ProjectionConfig = ProjectionConfig(),
                  ground_mode: str = "Patchwork",
                  max_points: Optional[int] = None) -> ProjectionResult:
    """ImageProjection::segmentCloud (reference:
    include/imageProjection.hpp:273-294) on (B, N, 3) points and (B, N)
    masks, or on one cloud.

    In "Patchwork" mode the mask is already non-ground; in "LeGO-LOAM"
    mode the vertical-angle test (:365-399) marks ground pixels before
    clustering. ``max_points`` bounds the valid point count (the pipeline
    passes max_nonground_points in Patchwork mode). The pixel classes go
    back to the points through one read of each point's packed pixel word
    (``image_lookup``, B11), kept only by the pixel's owner."""
    batched = points.dim() == 3
    if not batched:
        points, mask = points[None], mask[None]
    rows_n, cols_n = lidar.n_scan, lidar.horizon_scan
    _, _, _, ok, flat, rimg, owner = project_to_range_image(
        points, mask, lidar, cfg.min_range, max_points=max_points)
    occupied = owner >= 0

    if ground_mode == "LeGO-LOAM":
        bsz = points.shape[0]
        idx = torch.clamp(owner, min=0).reshape(bsz, -1, 1).expand(-1, -1, 3)
        pix_pts = torch.gather(points, 1, idx).reshape(bsz, rows_n, cols_n, 3)
        pix_pts = torch.where(occupied[..., None], pix_pts, 0.0)
        diff = torch.roll(pix_pts, -1, dims=1) - pix_pts
        upper_occ = torch.roll(occupied, -1, dims=1)
        angle = fused.atan2(diff[..., 2],
                            fused.hypot(diff[..., 0], diff[..., 1])) * _DEG
        ridx = torch.arange(rows_n, device=points.device)[:, None]
        gseed = ((torch.abs(angle) <= 10.0) & occupied & upper_occ
                 & (ridx < lidar.ground_scan_ind))
        ground_pix = gseed | torch.roll(gseed, 1, dims=1)
    else:
        ground_pix = torch.zeros_like(occupied)

    cluster_valid = occupied & ~ground_pix
    labels, _, pix_feasible = label_components(rimg, cluster_valid, lidar, cfg)

    code_pix = ((cluster_valid & pix_feasible).to(torch.int64)
                + 2 * (cluster_valid & ~pix_feasible).to(torch.int64)
                + 3 * ground_pix.to(torch.int64))
    packed_pix = torch.where(occupied, (code_pix << _IBITS) + owner, -1)
    got = image_lookup(flat.to(torch.int32).contiguous(),
                       packed_pix.to(torch.int32).contiguous(), rows_n, cols_n)
    iota = torch.arange(points.shape[1], device=points.device)
    is_owner = ok & ((got & ((1 << _IBITS) - 1)) == iota) & (got >= 0)
    codes = torch.where(is_owner, got >> _IBITS, 0)
    res = ProjectionResult(codes == 1, codes == 2, codes == 3, rimg, labels,
                           owner)
    if not batched:
        return ProjectionResult(*(t[0] for t in res))
    return res
