"""KITTI Velodyne ``.bin`` IO, numpy only.

Counterpart of ``quatro_tpu/io/kitti.py``: the reference reads float32
(x, y, z, intensity) quads with fread (examples/run_global_registration.cpp:
377-402) and discards intensity. Reading goes through ``np.fromfile``, the
JAX package's own path where its native loader is not built; the port has
no native loader yet.
"""

from __future__ import annotations

import os

import numpy as np


def load_kitti_bin(path: str, with_intensity: bool = False) -> np.ndarray:
    """Load a KITTI .bin scan -> (N, 3) or (N, 4) float32 array."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    arr = np.fromfile(path, dtype=np.float32)
    arr = arr[: (arr.size // 4) * 4].reshape(-1, 4)
    return arr if with_intensity else arr[:, :3]


def save_kitti_bin(path: str, xyz: np.ndarray,
                   intensity: np.ndarray | None = None) -> None:
    """Write an (N, 3) array (plus optional intensity) as a KITTI .bin."""
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    if intensity is None:
        intensity = np.zeros((xyz.shape[0],), dtype=np.float32)
    out = np.concatenate(
        [xyz, np.asarray(intensity, np.float32).reshape(-1, 1)], axis=1)
    out.astype(np.float32).tofile(path)
