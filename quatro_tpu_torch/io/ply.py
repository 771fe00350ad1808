"""PLY export for rviz-free visual debugging.

Counterpart of ``quatro_tpu/io/ply.py``, numpy only, writing the same
bytes. The reference's observability surface is ~20 rviz topics
(examples/run_global_registration.cpp:57-82,320-354). Without ROS, the
equivalent artifacts are PLY files (clouds with per-point colors, and
correspondence line sets) viewable in Meshlab/CloudCompare/Open3D.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def save_ply(path: str, xyz: np.ndarray,
             color: Optional[Sequence[int]] = None,
             colors: Optional[np.ndarray] = None) -> None:
    """Write an (N, 3) cloud; `color` = one RGB for all, `colors` = (N, 3)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    if colors is None:
        colors = np.tile(np.asarray(color if color is not None
                                    else (200, 200, 200), np.uint8), (n, 1))
    with open(path, "wb") as f:
        f.write((
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n").encode())
        rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                 ("rgb", np.uint8, 3)])
        rec["xyz"] = xyz
        rec["rgb"] = np.asarray(colors, np.uint8)
        rec.tofile(f)


def save_trajectory_ply(path: str, poses: np.ndarray,
                        edges_i: Optional[np.ndarray] = None,
                        edges_j: Optional[np.ndarray] = None,
                        edge_mask: Optional[np.ndarray] = None) -> None:
    """Trajectory + pose-graph edges as one PLY line set (the rviz
    trajectory/constraint markers, without ROS): vertices = pose
    positions; consecutive-pose path segments white, loop edges green
    when accepted, red when rejected by the edge gate."""
    poses = np.asarray(poses, np.float32)
    xyz = poses[:, :3].reshape(-1, 3)
    m = xyz.shape[0]
    seg = [(k, k + 1, (230, 230, 230)) for k in range(m - 1)]
    if edges_i is not None:
        ei = np.asarray(edges_i, int)
        ej = np.asarray(edges_j, int)
        ok = (np.ones(len(ei), bool) if edge_mask is None
              else np.asarray(edge_mask, bool))
        for a, b, good in zip(ei, ej, ok):
            if b != a + 1:  # odometry segments already drawn
                seg.append((int(a), int(b),
                            (0, 230, 0) if good else (230, 0, 0)))
    with open(path, "wb") as f:
        f.write((
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {m}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element edge {len(seg)}\n"
            "property int vertex1\nproperty int vertex2\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n").encode())
        xyz.astype("<f4").tofile(f)
        rec = np.zeros(len(seg), dtype=[("v1", "<i4"), ("v2", "<i4"),
                                        ("rgb", np.uint8, 3)])
        for k, (a, b, c) in enumerate(seg):
            rec[k] = (a, b, c)
        rec.tofile(f)


def save_correspondences_ply(path: str, src_xyz: np.ndarray,
                             tgt_xyz: np.ndarray,
                             mask: Optional[np.ndarray] = None,
                             color=(0, 255, 0)) -> None:
    """Write correspondence line segments (the reference's rviz markers,
    include/utility.h:151-199) as a PLY edge set."""
    src_xyz = np.asarray(src_xyz, np.float32).reshape(-1, 3)
    tgt_xyz = np.asarray(tgt_xyz, np.float32).reshape(-1, 3)
    if mask is not None:
        src_xyz = src_xyz[np.asarray(mask, bool)]
        tgt_xyz = tgt_xyz[np.asarray(mask, bool)]
    n = src_xyz.shape[0]
    verts = np.concatenate([src_xyz, tgt_xyz])
    with open(path, "wb") as f:
        f.write((
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {2 * n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element edge {n}\n"
            "property int vertex1\nproperty int vertex2\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n").encode())
        verts.astype("<f4").tofile(f)
        rec = np.zeros(n, dtype=[("v1", "<i4"), ("v2", "<i4"),
                                 ("rgb", np.uint8, 3)])
        rec["v1"] = np.arange(n)
        rec["v2"] = np.arange(n) + n
        rec["rgb"] = np.asarray(color, np.uint8)
        rec.tofile(f)
