"""The range-image projection's arithmetic: point keys and pixel owners,
the labelling's edge masks, and the components' stats.

``preprocessing/projection.py`` projects each point to a pixel of an
(n_scan x horizon_scan) range image, keeps the closest return of each
pixel, derives the angle-criterion edge masks of every neighbour offset and
gates each labelled component by its size and line count. The JAX package
runs these as XLA loop fusions around its sorts
(``quatro_tpu/preprocessing/projection.py:72-98, 118-136, 141-158,
196-244, 279-318``; no Pallas kernel there); the port runs them as three
hand-written kernels, each behind a wrapper in ``ops/labels.py``'s style:

- ``range_image``: csrc/range_image.cu's keys kernel, the one stable sort
  (``torch.sort``, as the JAX package's ``lax.sort``), its owner kernel;
- ``edge_masks``: csrc/edge_masks.cu, every edge mask of a labelling call
  in one launch;
- ``component_stats``: csrc/component_stats.cu, per-label size and row span
  by integer atomics, then the feasibility.

For CUDA tensors a wrapper checks its inputs (ValueError), launches and
counts the call in ``LAUNCHES``; for CPU tensors it runs its plain version
(``*_plain``, the torch operations the projection ran before the kernels,
on the JAX package's arithmetic through utils/fused.py). There is no
fallback between the two, and the kernels equal their plain versions bit
for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from quatro_tpu_torch.config import LidarConfig
from quatro_tpu_torch.ops.labels import MAX_SWEEPS, roll_image
from quatro_tpu_torch.ops.launch import LAUNCHES, check, launch, same_device
from quatro_tpu_torch.utils import fused

# Range quantisation of the packed owner key: 15 bits over RMAX metres
# (~3.7 mm buckets); 17 bits of point index.
RBITS = 15
RMAX = 120.0
IBITS = 17
SENTINEL = (1 << 32) - 1          # uint32 max of the JAX package's words
F32_MAX = torch.finfo(torch.float32).max
DEG = 180.0 / math.pi
_INT32_MAX = (1 << 31) - 1
# 4CrossNeighbor's composed offsets, as pairs of diagonal offsets: (0, 2),
# (0, -2), (2, 0), (-2, 0)
COMPOSED = (((1, 1), (-1, 1)), ((1, -1), (-1, -1)), ((1, 1), (1, -1)),
            ((-1, 1), (-1, -1)))
_DIAGONALS = {(-1, -1), (-1, 1), (1, 1), (1, -1)}


def is_4cross(offsets) -> bool:
    """The four diagonal offsets of 4CrossNeighbor, whose labelling adds
    the composed masks."""
    return set(map(tuple, offsets)) == _DIAGONALS


# ------------------------------------------------------------ projection --

def _projection_constants(lidar: LidarConfig):
    """The f32 constants of the projection's arithmetic, shared by both
    routes: degrees a radian, the bottom angle, the angular resolutions'
    f32 reciprocals (XLA divides by a constant so) and the range's
    quantisation scale."""
    return (fused.f32(DEG), fused.f32(lidar.ang_bottom),
            fused.recip(lidar.ang_res_y), fused.recip(lidar.ang_res_x),
            fused.f32((1 << RBITS) / RMAX))


def range_keys_plain(points: torch.Tensor, mask: torch.Tensor,
                     lidar: LidarConfig, min_range: float):
    """Per point of (B, N, 3) points: (row, col, range, in_image, flat
    pixel (R * C where not in the image), sort key (flat << 15) + rq,
    packed word (rq << 17) + index, the sentinel where not in the image),
    rq the range quantised to 15 bits (0 where not in the image)."""
    rows_n, cols_n = lidar.n_scan, lidar.horizon_scan
    npix = rows_n * cols_n
    deg, bottom, recip_y, recip_x, rq_scale = _projection_constants(lidar)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rxy = fused.hypot(x, y)
    rng = fused.sqrt(torch.clamp(fused.fma(z, z, fused.fma(x, x, y * y)),
                                 min=0.0))
    # degrees and the offset rounded once, and the quotients taken as XLA
    # takes them, by the f32 reciprocal (as CUDA divides by a scalar):
    # every synthetic ring lies on a row edge (utils/fused.py), where one
    # rounding moves a ring's row
    vert = fused.fma(fused.atan2(z, rxy), deg, bottom)
    row = torch.floor(vert * recip_y).to(torch.int64)
    horiz = fused.fma(fused.atan2(x, y), deg, -90.0)
    col = (-torch.round(horiz * recip_x)).to(torch.int64) + cols_n // 2
    col = torch.where(col >= cols_n, col - cols_n, col)

    ok = (mask & (row >= 0) & (row < rows_n) & (col >= 0) & (col < cols_n)
          & (rng >= min_range))
    flat = torch.where(ok, row * cols_n + col, npix)

    rq = torch.clamp(rng * rq_scale, 0, (1 << RBITS) - 1)
    rq = torch.where(ok, rq, 0.0).to(torch.int64)   # a NaN range never keys
    iota = torch.arange(points.shape[-2], device=points.device)
    packed = torch.where(ok, (rq << IBITS) + iota, SENTINEL)
    return row, col, rng, ok, flat, (flat << RBITS) + rq, packed


def range_owner_plain(key_s: torch.Tensor, packed_s: torch.Tensor,
                      npix: int):
    """(img (B, npix) f32, owner (B, npix) int64) from the sorted keys and
    packed words (the prefix already cut): each pixel run's first word
    scattered to its pixel, the others to distinct slots past the image;
    f32 max and -1 where no word lands."""
    bsz, ac = key_s.shape
    flat_s = key_s >> RBITS
    is_start = torch.ones_like(flat_s, dtype=torch.bool)
    is_start[:, 1:] = flat_s[:, 1:] != flat_s[:, :-1]
    pos = torch.arange(ac, device=key_s.device)
    scat = torch.where(is_start & (flat_s < npix), flat_s, npix + pos)
    owner_key = torch.full((bsz, npix + ac), SENTINEL, dtype=torch.int64,
                           device=key_s.device)
    owner_key.scatter_(1, scat, packed_s)           # every index distinct
    owner_key = owner_key[:, :npix]
    empty = owner_key == SENTINEL
    owner = torch.where(empty, -1, owner_key & ((1 << IBITS) - 1))
    img = torch.where(empty, F32_MAX,
                      ((owner_key >> IBITS).to(torch.float32) + 0.5)
                      * fused.f32(RMAX / (1 << RBITS)))
    return img, owner


def _prefix(n: int, max_points: Optional[int]) -> int:
    return n if (max_points is None or max_points >= n) else max_points


def range_image_plain(points: torch.Tensor, mask: torch.Tensor,
                      lidar: LidarConfig, min_range: float = 0.1,
                      max_points: Optional[int] = None):
    """``range_image``'s plain version: the keys, one stable sort, the
    owners of the sorted prefix."""
    rows_n, cols_n = lidar.n_scan, lidar.horizon_scan
    bsz, n = mask.shape
    row, col, rng, ok, flat, key, packed = range_keys_plain(
        points, mask, lidar, min_range)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    packed_s = torch.gather(packed, 1, order)
    ac = _prefix(n, max_points)
    img, owner = range_owner_plain(key_s[:, :ac], packed_s[:, :ac],
                                   rows_n * cols_n)
    return (row, col, rng, ok, flat, img.reshape(bsz, rows_n, cols_n),
            owner.reshape(bsz, rows_n, cols_n))


def range_image(points: torch.Tensor, mask: torch.Tensor, lidar: LidarConfig,
                min_range: float = 0.1, max_points: Optional[int] = None):
    """The spherical projection of (B, N, 3) f32 points under a (B, N) bool
    mask, both contiguous: (rows (B, N) int64, cols (B, N) int64, ranges
    (B, N) f32, in_image (B, N) bool, flat (B, N) int64 pixel (R * C where
    not in the image), range_image (B, R, C) f32 (f32 max where empty),
    owner (B, R, C) int64 (-1 where empty)). A pixel's owner is its closest
    return (ranges quantised to ~3.7 mm), ties toward the lowest point
    index, from one stable sort of the (pixel, quantised range) keys; with
    ``max_points`` only that prefix of the sorted points is scanned (the
    valid points sort first; overflow drops the highest pixel ids). For
    CUDA tensors the keys kernel, the sort and the owner kernel of
    csrc/range_image.cu, bit for bit ``range_image_plain``, which runs for
    CPU tensors."""
    rows_n, cols_n = lidar.n_scan, lidar.horizon_scan
    npix = rows_n * cols_n
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points: expected (B, N, 3), got "
                         f"{tuple(points.shape)}")
    bsz, n = points.shape[:2]
    if n > (1 << IBITS):
        raise ValueError(f"owner packing supports up to {1 << IBITS} points "
                         f"per cloud, got {n}")
    if npix >= (1 << (32 - RBITS)):
        raise ValueError(f"range image {rows_n}x{cols_n} overflows the "
                         f"(pixel, range) key ({32 - RBITS} pixel bits)")
    check("points", points, (bsz, n, 3))
    check("mask", mask, (bsz, n), torch.bool)
    if same_device(points, mask).type != "cuda":
        return range_image_plain(points, mask, lidar, min_range, max_points)
    dev = points.device
    deg, bottom, recip_y, recip_x, rq_scale = _projection_constants(lidar)
    row, col, flat = (torch.empty((bsz, n), dtype=torch.int64, device=dev)
                      for _ in range(3))
    rng = torch.empty((bsz, n), dtype=torch.float32, device=dev)
    ok = torch.empty((bsz, n), dtype=torch.bool, device=dev)
    key = torch.empty((bsz, n), dtype=torch.int32, device=dev)
    img = torch.empty((bsz, rows_n, cols_n), dtype=torch.float32, device=dev)
    owner = torch.empty((bsz, rows_n, cols_n), dtype=torch.int64, device=dev)
    if bsz == 0:
        return row, col, rng, ok, flat, img, owner
    launch("range_image", points, mask, bsz, n, rows_n, cols_n, bottom,
           recip_y, recip_x, deg, fused.f32(min_range), rq_scale, row, col,
           rng, ok, flat, key, img, owner)
    # the int32 keys (the key less 2^31) order as the int64 keys do
    key_s, order = torch.sort(key, dim=-1, stable=True)
    launch("range_image_owner", key_s, order, bsz, n, _prefix(n, max_points),
           npix, img, owner)
    LAUNCHES["range_image"] += 1
    return row, col, rng, ok, flat, img, owner


# ------------------------------------------------------------ edge masks --

def neighbor_edges_plain(rimg: torch.Tensor, valid: torch.Tensor, dr: int,
                         dc: int, sin_a: float, cos_a: float,
                         theta_rad: float) -> torch.Tensor:
    """Symmetric angle-criterion edge mask toward neighbour (dr, dc)
    (reference: include/imageProjection.hpp:526-541) on (B, R, C) images,
    with the f32 sine and cosine of the offset's angular resolution.
    Columns wrap, rows do not."""
    shifted = roll_image(rimg, dr, dc)
    svalid = roll_image(valid, dr, dc)
    if dr != 0:
        rows = rimg.shape[-2]
        ridx = torch.arange(rows, device=rimg.device)[:, None]
        svalid = svalid & (ridx + dr >= 0) & (ridx + dr < rows)
    d1 = torch.maximum(rimg, shifted)
    d2 = torch.minimum(rimg, shifted)
    angle = fused.atan2(d2 * sin_a, fused.fma(d2, -cos_a, d1))
    return valid & svalid & (angle > theta_rad)


def compose_edges(ea: torch.Tensor, eb: torch.Tensor, a, b) -> torch.Tensor:
    """The composed mask of diagonal offsets a and b: an edge from p to
    p + a + b through p + a or through p + b."""
    return (ea & roll_image(eb, *a)) | (eb & roll_image(ea, *b))


def edge_masks_plain(rimg: torch.Tensor, valid: torch.Tensor, offsets,
                     sin_cos_x, sin_cos_y, theta_rad: float) -> torch.Tensor:
    """``edge_masks``' plain version: one ``neighbor_edges_plain`` a
    offset, then under 4CrossNeighbor the composed masks."""
    emap = {}
    for dr, dc in offsets:
        sin_a, cos_a = sin_cos_x if dr == 0 else sin_cos_y
        emap[(dr, dc)] = neighbor_edges_plain(rimg, valid, dr, dc, sin_a,
                                              cos_a, theta_rad)
    masks = [emap[tuple(o)] for o in offsets]
    if is_4cross(offsets):
        masks += [compose_edges(emap[a], emap[b], a, b) for a, b in COMPOSED]
    return torch.stack(masks)


def edge_masks(rimg: torch.Tensor, valid: torch.Tensor, offsets, sin_cos_x,
               sin_cos_y, theta_rad: float) -> torch.Tensor:
    """(S, B, R, C) bool, contiguous: the angle-criterion edge mask of each
    neighbour offset of ``offsets`` (at most MAX_SWEEPS, |dr|, |dc| <= 1),
    then under 4CrossNeighbor (the four diagonals) the four composed masks
    of ``COMPOSED``, in the order ``ops/labels.label_sweeps`` takes them;
    on (B, R, C) f32 range images and bool valid masks, contiguous. The
    sines and cosines ((sin, cos) of ang_res_x and of ang_res_y) and theta
    are the host's f32 values (rounded to f32 here), the same for both
    routes. For CUDA tensors
    one launch of csrc/edge_masks.cu, bit for bit ``edge_masks_plain``,
    which runs for CPU tensors."""
    if rimg.dim() != 3:
        raise ValueError(f"rimg: expected (B, R, C), got "
                         f"{tuple(rimg.shape)}")
    shape = tuple(rimg.shape)
    check("rimg", rimg, shape)
    check("valid", valid, shape, torch.bool)
    offsets = [tuple(int(v) for v in o) for o in offsets]
    sin_cos_x, sin_cos_y = (tuple(map(fused.f32, sc))
                            for sc in (sin_cos_x, sin_cos_y))
    theta_rad = fused.f32(theta_rad)
    compose = is_4cross(offsets)
    n_masks = len(offsets) + (len(COMPOSED) if compose else 0)
    if not offsets or n_masks > MAX_SWEEPS:
        raise ValueError(f"{len(offsets)} offsets give {n_masks} masks: "
                         f"expected 1 to {MAX_SWEEPS}")
    if any(abs(dr) > 1 or abs(dc) > 1 for dr, dc in offsets):
        raise ValueError(f"offsets must lie within one pixel, got {offsets}")
    if same_device(rimg, valid).type != "cuda":
        return edge_masks_plain(rimg, valid, offsets, sin_cos_x, sin_cos_y,
                                theta_rad)
    bsz, rows, cols = shape
    out = torch.empty((n_masks, *shape), dtype=torch.bool,
                      device=rimg.device)
    if rimg.numel() == 0:
        return out
    offs = torch.tensor(offsets, dtype=torch.int32)
    comp = (torch.tensor([[offsets.index(a), offsets.index(b)]
                          for a, b in COMPOSED], dtype=torch.int32)
            if compose else None)
    launch("edge_masks", rimg, valid, bsz, rows, cols, len(offsets), offs,
           int(compose), comp, *sin_cos_x, *sin_cos_y, theta_rad, out)
    LAUNCHES["edge_masks"] += 1
    return out


# ------------------------------------------------------- component stats --

def component_stats_plain(labels: torch.Tensor, valid: torch.Tensor,
                          min_pts: int, valid_num: int, valid_lines: int):
    """``component_stats``' plain version: one stable sort by (label,
    row), then run-length scans (the JAX package's sort-scan), and the
    per-run feasibility back in pixel order."""
    bsz, rows, cols = labels.shape
    npix = rows * cols
    dev = labels.device
    labels = labels.to(torch.int64)
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
    feas_s = (size >= min_pts) | ((size >= valid_num)
                                  & (lines >= valid_lines))
    feas_s = feas_s & (lab_s < npix)

    feas_img = torch.zeros_like(feas_s).scatter_(1, pix_s, feas_s)
    pix_feasible = feas_img.reshape(bsz, rows, cols) & valid
    # component l's root pixel is flat position l
    feasible = pix_feasible.reshape(bsz, npix) & (lab_flat == pos)
    return torch.where(valid, labels, -1), feasible, pix_feasible


def component_stats(labels: torch.Tensor, valid: torch.Tensor, min_pts: int,
                    valid_num: int, valid_lines: int):
    """(labels (B, R, C) int64, -1 where not valid; feasible (B, R * C)
    bool gate per label id, true at each feasible component's root pixel;
    pix_feasible (B, R, C) bool) of (B, R, C) int32 labels (a valid pixel's
    label in [0, R * C], R * C for none) and bool valid masks, contiguous.
    A component is feasible where its size >= ``min_pts``, or its size >=
    ``valid_num`` and its line count (rows spanned) >= ``valid_lines``. For
    CUDA tensors csrc/component_stats.cu (integer atomics, then a
    gather), bit for bit ``component_stats_plain``, which runs for CPU
    tensors."""
    if labels.dim() != 3:
        raise ValueError(f"labels: expected (B, R, C), got "
                         f"{tuple(labels.shape)}")
    shape = tuple(labels.shape)
    check("labels", labels, shape, torch.int32)
    check("valid", valid, shape, torch.bool)
    if same_device(labels, valid).type != "cuda":
        return component_stats_plain(labels, valid, min_pts, valid_num,
                                     valid_lines)
    bsz, rows, cols = shape
    dev = labels.device
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    feasible = torch.empty((bsz, rows * cols), dtype=torch.bool, device=dev)
    pix_feasible = torch.empty(shape, dtype=torch.bool, device=dev)
    if labels.numel() == 0:
        return out, feasible, pix_feasible
    scratch = torch.empty((3, *shape), dtype=torch.int32, device=dev)
    launch("component_stats", labels, valid, bsz, rows, cols, int(min_pts),
           int(valid_num), int(valid_lines), scratch, out, feasible,
           pix_feasible)
    LAUNCHES["component_stats"] += 1
    return out, feasible, pix_feasible
