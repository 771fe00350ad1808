"""Ground-plane alignment: roll, pitch and z from the segmented ground.

PyTorch counterpart of ``quatro_tpu/solver/ground.py`` (the Quatro++
extension): fit the dominant ground plane of each scan (one masked 3x3
covariance and the closed-form eigensolver), level both scans by the
rotation taking each normal to +z, solve yaw on the leveled clouds, and
compose back,

    tgt = L_t^T R' L_s @ src + L_t^T t'      =>  R = L_t^T R' L_s,

with t'_z replaced by the ground-height difference (``use_ground_z``).
Every gate is a tensor under ``torch.where``: nothing is read back from
the device, and a fit that fails a gate degrades to identity leveling.
The functions take one cloud (N, 3) or a batch (..., N, 3). The fit, its
gates and the rotation of every cloud are one call of
``ops.ground.ground_fit`` (one kernel launch on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from quatro_tpu_torch.config import GroundAlignmentConfig
from quatro_tpu_torch.ops.ground import (  # noqa: F401 (re-exported)
    GroundPlane, _matmul3, fit_ground_plane, ground_fit, leveling_rotation)
from quatro_tpu_torch.utils.fused import f32
from quatro_tpu_torch.utils.se3 import rotate_points


class GroundAlignment(NamedTuple):
    """Leveling rotations and leveled ground heights of one scan pair (a
    batch of pairs adds a leading B to every field)."""

    src_level: torch.Tensor   # (3, 3) L_s
    tgt_level: torch.Tensor   # (3, 3) L_t
    src_height: torch.Tensor  # () f32: ground z in the leveled source frame
    tgt_height: torch.Tensor  # () f32
    valid: torch.Tensor       # () bool: both plane fits passed the gates


def frame_leveling(points: torch.Tensor, ground_mask: torch.Tensor,
                   config: GroundAlignmentConfig):
    """One scan's gated leveling: (level (3, 3), height (), ok ()), or one
    of each per scan of a batch (..., N, 3)."""
    lead = points.shape[:-2]
    level, height, ok = ground_fit(points, ground_mask, config)
    return (level.reshape(*lead, 3, 3), height.reshape(lead),
            ok.reshape(lead))


def align_ground(src_points: torch.Tensor, src_ground: torch.Tensor,
                 tgt_points: torch.Tensor, tgt_ground: torch.Tensor,
                 config: GroundAlignmentConfig = GroundAlignmentConfig()
                 ) -> GroundAlignment:
    """Fit both ground planes and build the pair's leveling rotations; the
    pair levels as a unit (both fits must pass, else identity and zero
    heights): one ``ground_fit`` call on the sources and the targets. A
    batch of pairs (B, N, 3) gives each field a leading B."""
    lead = src_points.shape[:-2]
    level, height, ok = ground_fit(src_points, src_ground, config,
                                   other=(tgt_points, tgt_ground))
    c = ok.shape[0] // 2
    return GroundAlignment(level[:c].reshape(*lead, 3, 3),
                           level[c:].reshape(*lead, 3, 3),
                           height[:c].reshape(lead), height[c:].reshape(lead),
                           ok[:c].reshape(lead))


def compose_leveled_solution(rotation: torch.Tensor,
                             translation: torch.Tensor, ga: GroundAlignment,
                             use_ground_z: bool = True):
    """Map a solve (R', t') on ``L_s @ src`` vs ``L_t @ tgt`` back to the
    raw frames: (R, t). With ``use_ground_z`` the leveled vertical
    translation becomes the ground-height difference, where the pair
    leveled and R' keeps e_z within 1 degree (r22 >= cos 1 deg: a
    full-SO(3) R' that re-tilts the leveled ground would bias it)."""
    tz = translation[..., 2]
    if use_ground_z:
        yaw_like = rotation[..., 2, 2] >= f32(math.cos(f32(math.radians(1.0))))
        tz = torch.where(ga.valid & yaw_like, ga.tgt_height - ga.src_height,
                         tz)
    t_leveled = torch.stack([translation[..., 0], translation[..., 1], tz],
                            -1)
    lt_t = ga.tgt_level.transpose(-1, -2)
    rot = _matmul3(_matmul3(lt_t, rotation), ga.src_level)
    t = rotate_points(t_leveled[..., None, :], lt_t)[..., 0, :]
    return rot, t
