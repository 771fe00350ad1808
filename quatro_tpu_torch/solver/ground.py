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
The functions take one cloud (N, 3) or a batch (..., N, 3).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from quatro_tpu_torch.config import GroundAlignmentConfig
from quatro_tpu_torch.ops.normals import smallest_eigenvector_3x3
from quatro_tpu_torch.utils.fused import f32, pairwise_sum
from quatro_tpu_torch.utils.se3 import rotate_points


class GroundPlane(NamedTuple):
    normal: torch.Tensor    # (3,) unit, oriented n_z > 0
    centroid: torch.Tensor  # (3,)
    count: torch.Tensor     # () int32: ground points used
    flatness: torch.Tensor  # () f32: lambda_min / trace (0 = perfect plane)


class GroundAlignment(NamedTuple):
    """Leveling rotations and leveled ground heights of one scan pair (a
    batch of pairs adds a leading B to every field)."""

    src_level: torch.Tensor   # (3, 3) L_s
    tgt_level: torch.Tensor   # (3, 3) L_t
    src_height: torch.Tensor  # () f32: ground z in the leveled source frame
    tgt_height: torch.Tensor  # () f32
    valid: torch.Tensor       # () bool: both plane fits passed the gates


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of (..., 3, 3) matrices in full f32."""
    return rotate_points(a, b.transpose(-1, -2))


def fit_ground_plane(points: torch.Tensor, mask: torch.Tensor) -> GroundPlane:
    """Least-squares plane through the masked points: masked centroid,
    3x3 scatter matrix (true f32 products summed in one fixed order,
    ``pairwise_sum``, so a cloud of a batch gives its own bits; never
    TF32), smallest eigenvector as the normal, oriented upward."""
    w = mask.to(points.dtype)
    count = mask.sum(-1).to(torch.int32)
    denom = torch.clamp(w.sum(-1), min=1.0)
    centroid = pairwise_sum(points * w[..., None], -2) / denom[..., None]
    d = (points - centroid[..., None, :]) * w[..., None]
    cov = (pairwise_sum(d[..., :, None] * d[..., None, :], -3)
           / denom[..., None, None])
    normal, lam_min = smallest_eigenvector_3x3(cov)
    normal = normal * torch.sign(normal[..., 2:3] + 1e-12)
    trace = cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]
    flatness = lam_min / torch.clamp(trace, min=1e-30)
    return GroundPlane(normal, centroid, count, flatness)


def leveling_rotation(normal: torch.Tensor) -> torch.Tensor:
    """Minimal rotation taking ``normal`` to +z (Rodrigues, closed form):
    with v = n x z and c = n.z, R = I + [v]x + [v]x^2 / (1 + c)."""
    n = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=-1,
                                                      keepdim=True),
                             min=1e-12)
    vx, vy, c = n[..., 1], -n[..., 0], n[..., 2]
    k = 1.0 / torch.clamp(1.0 + c, min=1e-6)
    z = torch.zeros_like(c)
    hat = torch.stack([torch.stack([z, z, vy], -1),
                       torch.stack([z, z, -vx], -1),
                       torch.stack([-vy, vx, z], -1)], -2)
    eye = torch.eye(3, dtype=normal.dtype, device=normal.device)
    return eye + hat + k[..., None, None] * _matmul3(hat, hat)


def _gated_leveling(plane: GroundPlane, cfg: GroundAlignmentConfig):
    """(L, height, ok): identity leveling where the fit fails the gates
    (count, tilt, flatness)."""
    min_cos = f32(math.cos(f32(math.radians(cfg.max_tilt_deg))))
    ok = ((plane.count >= cfg.min_points)
          & (plane.normal[..., 2] >= min_cos)
          & (plane.flatness <= f32(cfg.max_flatness)))
    eye = torch.eye(3, dtype=plane.normal.dtype, device=plane.normal.device)
    level = torch.where(ok[..., None, None], leveling_rotation(plane.normal),
                        eye)
    height = torch.where(ok, (level[..., 2, :] * plane.centroid).sum(-1), 0.0)
    return level, height, ok


def frame_leveling(points: torch.Tensor, ground_mask: torch.Tensor,
                   config: GroundAlignmentConfig):
    """One scan's gated leveling: (level (3, 3), height (), ok ())."""
    return _gated_leveling(fit_ground_plane(points, ground_mask), config)


def align_ground(src_points: torch.Tensor, src_ground: torch.Tensor,
                 tgt_points: torch.Tensor, tgt_ground: torch.Tensor,
                 config: GroundAlignmentConfig = GroundAlignmentConfig()
                 ) -> GroundAlignment:
    """Fit both ground planes and build the pair's leveling rotations; the
    pair levels as a unit (both fits must pass, else identity and zero
    heights). Clouds of one capacity are fitted as one batch of two; a
    batch of pairs (B, N, 3) gives each field a leading B."""
    if src_points.shape == tgt_points.shape:
        lv, h, ok = frame_leveling(torch.stack([src_points, tgt_points]),
                                   torch.stack([src_ground, tgt_ground]),
                                   config)
        (ls, lt), (hs, ht), (ok_s, ok_t) = lv, h, ok
    else:
        ls, hs, ok_s = frame_leveling(src_points, src_ground, config)
        lt, ht, ok_t = frame_leveling(tgt_points, tgt_ground, config)
    ok = ok_s & ok_t
    eye = torch.eye(3, dtype=src_points.dtype, device=src_points.device)
    okm = ok[..., None, None]
    return GroundAlignment(torch.where(okm, ls, eye),
                           torch.where(okm, lt, eye),
                           torch.where(ok, hs, 0.0), torch.where(ok, ht, 0.0),
                           ok)


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
