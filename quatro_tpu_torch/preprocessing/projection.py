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

The arithmetic runs in ``ops/range_image.py``: the point keys and pixel
owners (``range_image``), every edge mask of a labelling call
(``edge_masks``) and the components' stats (``component_stats``), one
hand-written kernel each on the card and their plain versions on the CPU;
the labelling's rounds in ``ops/labels.label_sweeps``.

Every function takes a leading batch axis (the pipeline runs source and
target as one batch of two); ``segment_cloud`` also takes one cloud.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from quatro_tpu_torch.config import LidarConfig, ProjectionConfig
from quatro_tpu_torch.ops.labels import label_sweeps
from quatro_tpu_torch.ops.range_image import (COMPOSED, DEG, IBITS,
                                              component_stats, edge_masks,
                                              is_4cross, neighbor_edges_plain,
                                              range_image)
from quatro_tpu_torch.ops.segment import image_lookup
from quatro_tpu_torch.utils import fused

_COMPOSED = COMPOSED    # the composed offsets' pairs, as the tests name them


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
    return range_image(points.contiguous(), mask.contiguous(), lidar,
                       min_range, max_points)


def _neighbor_edges(rimg: torch.Tensor, valid: torch.Tensor, dr: int, dc: int,
                    lidar: LidarConfig, theta_rad: float):
    """Symmetric angle-criterion edge mask toward neighbour (dr, dc)
    (reference: include/imageProjection.hpp:526-541). Columns wrap, rows
    do not."""
    sin_a, cos_a = _sin_cos(_deg2rad(lidar.ang_res_x if dr == 0
                                     else lidar.ang_res_y))
    return neighbor_edges_plain(rimg, valid, dr, dc, sin_a, cos_a, theta_rad)


def sweep_schedule(rows: int, cols: int, cfg: ProjectionConfig):
    """Each sweep's (dr, dc, doubling steps) in a labelling round's order:
    the neighbour offsets (2^(steps - 1) covers the image's extent along
    the offset; reach 4 under 4CrossNeighbor), then under 4CrossNeighbor
    the composed offsets (0, +-2) / (+-2, 0), reaching half the extent."""
    offsets = cfg.neighbor_offsets
    cross = is_4cross(offsets)
    sweeps = []
    for dr, dc in offsets:
        steps = ((rows if dr != 0 else cols) - 1).bit_length() + 1
        sweeps.append((dr, dc, min(steps, 3) if cross else steps))
    if cross:
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
    pix_feasible (B, R, C) bool). The edge masks of every offset come from
    ``ops/range_image.edge_masks`` (one launch on the card). Labels spread
    by min-label sweeps along each neighbour offset (and, for 4CrossNeighbor, the composed zigzag
    offsets; ``sweep_schedule``) in rounds, until a round changes no label
    of the image or ``max_cc_iters`` rounds (the JAX package's
    ``lax.while_loop``): ``ops/labels.label_sweeps``, on the card one
    kernel launch for the batch, each image to its own exit and no flag
    read on the host; on the CPU a ``while_chunks`` device loop that reads
    its "some label changed" flag once per ``ops/labels.CC_CHUNK`` rounds,
    whose rounds past an image's exit change nothing (a round is a fixed
    point at convergence). Component size and line count come from
    ``ops/range_image.component_stats``: with |dr| <= 1 a component's rows
    are contiguous, so lines = rmax - rmin + 1."""
    bsz, rows, cols = rimg.shape
    npix = rows * cols
    if not all(abs(dr) <= 1 for dr, _ in cfg.neighbor_offsets):
        raise ValueError("line-count-as-row-span requires |dr| <= 1 "
                         "neighbour offsets")
    valid = valid.contiguous()
    # every edge mask, then under 4CrossNeighbor the composed offsets
    # (0, +-2) / (+-2, 0): it converges along zigzag paths, so straight
    # doubling stops at reach 4 (projection.py:220-244 of the JAX package)
    masks = edge_masks(rimg.contiguous(), valid, cfg.neighbor_offsets,
                       _sin_cos(_deg2rad(lidar.ang_res_x)),
                       _sin_cos(_deg2rad(lidar.ang_res_y)),
                       _deg2rad(cfg.segment_theta_deg))
    # int32 labels inside the loop, as the JAX package's label image
    flat_iota = torch.arange(npix, dtype=torch.int32,
                             device=rimg.device).reshape(rows, cols)
    labels, _ = label_sweeps(
        torch.where(valid, flat_iota, npix), valid, masks.unbind(0),
        sweep_schedule(rows, cols, cfg), cfg.max_cc_iters, npix)
    return component_stats(labels, valid, cfg.min_pts_for_subcluster,
                           cfg.segment_valid_point_num,
                           cfg.segment_valid_line_num)


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
                            fused.hypot(diff[..., 0], diff[..., 1])) * DEG
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
    packed_pix = torch.where(occupied, (code_pix << IBITS) + owner, -1)
    got = image_lookup(flat.to(torch.int32).contiguous(),
                       packed_pix.to(torch.int32).contiguous(), rows_n, cols_n)
    iota = torch.arange(points.shape[1], device=points.device)
    is_owner = ok & ((got & ((1 << IBITS) - 1)) == iota) & (got >= 0)
    codes = torch.where(is_owner, got >> IBITS, 0)
    res = ProjectionResult(codes == 1, codes == 2, codes == 3, rimg, labels,
                           owner)
    if not batched:
        return ProjectionResult(*(t[0] for t in res))
    return res
