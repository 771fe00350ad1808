"""SE(3) / yaw-rotation helpers shared across solver and tests."""

from __future__ import annotations

import torch


def rotate_points(points: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """``points @ rotation.T`` in full f32.

    Every pose application goes through here. Written as three explicit
    products summed in f32 rather than a matmul, so no TF32 or reduced
    precision setting can reach it: at 40-120 m lidar ranges a 1e-3
    relative error is tens of centimetres, the order of every noise-bound
    threshold downstream.
    """
    rt = rotation.transpose(-1, -2)
    out = points[..., :, 0:1] * rt[..., 0:1, :]
    for k in range(1, points.shape[-1]):
        out = out + points[..., :, k:k + 1] * rt[..., k:k + 1, :]
    return out


def yaw_to_rotation(theta: torch.Tensor) -> torch.Tensor:
    """3x3 rotation about +z by angle theta (quasi-SO(3) embedding)."""
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, z], dim=-1),
        torch.stack([s, c, z], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def rotation_geodesic_error(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Angle in radians between two rotation matrices (atan2 form: the
    arccos-of-trace formula is ill-conditioned near zero in f32)."""
    rel = rotate_points(r1.T, r2.T)          # r1.T @ r2, full f32
    skew = torch.stack([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                        rel[1, 0] - rel[0, 1]])
    sin = torch.linalg.vector_norm(skew) / 2.0
    cos = (torch.trace(rel) - 1.0) / 2.0
    return torch.atan2(sin, cos)
