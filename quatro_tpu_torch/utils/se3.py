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


def rotation_to_yaw(rot: torch.Tensor) -> torch.Tensor:
    """Yaw angle of (yaw-only) rotation matrices (..., 3, 3)."""
    return torch.atan2(rot[..., 1, 0], rot[..., 0, 0])


def rotation_geodesic_error(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Angle in radians between two rotation matrices (atan2 form: the
    arccos-of-trace formula is ill-conditioned near zero in f32)."""
    rel = rotate_points(r1.T, r2.T)          # r1.T @ r2, full f32
    skew = torch.stack([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                        rel[1, 0] - rel[0, 1]])
    sin = torch.linalg.vector_norm(skew) / 2.0
    cos = (torch.trace(rel) - 1.0) / 2.0
    return torch.atan2(sin, cos)


def make_transform(rotation: torch.Tensor,
                   translation: torch.Tensor) -> torch.Tensor:
    """Compose a 4x4 homogeneous transform."""
    out = torch.eye(4, dtype=rotation.dtype, device=rotation.device)
    out[:3, :3] = rotation
    out[:3, 3] = translation.to(rotation.dtype)
    return out


def apply_transform(transform: torch.Tensor,
                    points: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) transform to (..., 3) points."""
    return rotate_points(points, transform[:3, :3]) + transform[:3, 3]


def _hat(w: torch.Tensor) -> torch.Tensor:
    """The skew matrices [w]x of (..., 3) vectors."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: (..., 3) axis-angle vectors -> (..., 3, 3)
    rotations, with the sinc / versine series below 1e-4 rad so an ICP
    update stays exact in f32 near convergence."""
    theta_sq = (w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1]
                + w[..., 2] * w[..., 2])
    theta = torch.sqrt(theta_sq)
    k = _hat(w)
    small = theta < 1e-4
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta_sq / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one,
                                                           theta_sq))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return (eye + a[..., None, None] * k
            + b[..., None, None] * rotate_points(k, k.transpose(-1, -2)))


def rotation_from_rpy(roll, pitch, yaw) -> torch.Tensor:
    """Rz(yaw) @ Ry(pitch) @ Rx(roll), in f32 (as the JAX package computes
    it from Python floats)."""
    cr, sr, cp, sp, cy, sy = (
        f(torch.tensor(v, dtype=torch.float32))
        for v in (roll, pitch, yaw) for f in (torch.cos, torch.sin))
    o, z = torch.ones(()), torch.zeros(())
    rx = torch.stack([torch.stack([o, z, z]), torch.stack([z, cr, -sr]),
                      torch.stack([z, sr, cr])])
    ry = torch.stack([torch.stack([cp, z, sp]), torch.stack([z, o, z]),
                      torch.stack([-sp, z, cp])])
    rz = torch.stack([torch.stack([cy, -sy, z]), torch.stack([sy, cy, z]),
                      torch.stack([z, z, o])])
    return rotate_points(rotate_points(rz, ry.T), rx.T)     # rz @ ry @ rx
