"""Segmented-scan metadata: the ``quatro/cloud_info`` message equivalent.

PyTorch counterpart of ``quatro_tpu/preprocessing/metadata.py``. The
reference publishes per-scan segmentation metadata for downstream LiDAR
odometry (msg/cloud_info.msg:1-11, filled in
include/imageProjection.hpp:162-167,296-306,434-469): per-ring start and
end indices into the segmented cloud, per-pixel ground flags, column
indices and ranges, and the scan's start and end orientation. Here it is
computed from the port's projection result
(``preprocessing/projection.segment_cloud`` on one cloud), with no ROS.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from quatro_tpu_torch.config import LidarConfig
from quatro_tpu_torch.preprocessing.projection import ProjectionResult
from quatro_tpu_torch.utils import fused
from quatro_tpu_torch.utils.fused import f32


class ScanMetadata(NamedTuple):
    start_ring_index: torch.Tensor       # (R,) int32 first segmented rank per ring
    end_ring_index: torch.Tensor         # (R,) int32 last segmented rank per ring
    segmented_ground_flag: torch.Tensor  # (R, C) bool per pixel
    segmented_col_ind: torch.Tensor      # (R, C) int32 column index
    segmented_range: torch.Tensor        # (R, C) f32 range (0 where not segmented)
    start_orientation: torch.Tensor      # () f32
    end_orientation: torch.Tensor        # () f32
    orientation_diff: torch.Tensor       # () f32


def compute_scan_metadata(points: torch.Tensor, mask: torch.Tensor,
                          proj: ProjectionResult,
                          lidar: LidarConfig = LidarConfig()) -> ScanMetadata:
    """cloud_info-equivalent metadata of one scan (points (N, 3), mask
    (N,)) from its segmentation result.

    Segmented pixels are the pixels of ACCEPTED sub-clusters plus the
    ground pixels downsampled to every 5th column away from the image
    borders, as the reference's cloudSegmentation keeps them
    (include/imageProjection.hpp:434-452: ground enters segmentedCloud
    iff j % 5 == 0 or j <= 5 or j >= Horizon_SCAN - 5)."""
    rows, cols = proj.range_image.shape
    occupied = proj.owner >= 0
    own = torch.clamp(proj.owner, min=0)
    ground_pix = occupied & proj.ground[own]
    col_ind = torch.arange(cols, dtype=torch.int32,
                           device=points.device).expand(rows, cols)
    ground_ds = ground_pix & ((col_ind % 5 == 0) | (col_ind <= 5)
                              | (col_ind >= cols - 5))
    seg_pix = (occupied & proj.valid_segments[own]) | ground_ds

    per_row_count = seg_pix.sum(1)
    row_end = torch.cumsum(per_row_count, 0)
    row_start_rank = row_end - per_row_count
    # reference offsets: start = running - 1 + 5, end = running - 1 - 5
    start_ring = (row_start_rank - 1 + 5).to(torch.int32)
    end_ring = (row_end - 1 - 5).to(torch.int32)

    rng = torch.where(seg_pix, proj.range_image, 0.0)

    # start / end orientation (include/imageProjection.hpp:296-306): the
    # first and the last valid point of the scan
    n = points.shape[0]
    valid = mask.to(torch.int32)
    first = torch.argmax(valid)
    last = n - 1 - torch.argmax(valid.flip(0))
    two_pi = f32(2 * math.pi)
    start_o = -fused.atan2(points[first, 1], points[first, 0])
    end_o = -fused.atan2(points[last, 1], points[last, 0]) + two_pi
    diff = end_o - start_o
    end_o = torch.where(diff > f32(3 * math.pi), end_o - two_pi,
                        torch.where(diff < f32(math.pi), end_o + two_pi,
                                    end_o))
    return ScanMetadata(
        start_ring_index=start_ring,
        end_ring_index=end_ring,
        segmented_ground_flag=ground_ds,
        segmented_col_ind=torch.where(seg_pix, col_ind, 0),
        segmented_range=rng,
        start_orientation=start_o,
        end_orientation=end_o,
        orientation_diff=end_o - start_o)
