"""KITTI Velodyne ``.bin`` IO.

Counterpart of ``quatro_tpu/io/kitti.py``: the reference reads float32
(x, y, z, intensity) quads with fread (examples/run_global_registration.cpp:
377-402) and discards intensity. Reading takes the native loader
(``quatro_tpu_torch/native``) when its library builds, else one
``np.fromfile``; both routes give equal arrays.
"""

from __future__ import annotations

import os

import numpy as np

from quatro_tpu_torch import native

_native_ok: bool | None = None      # unknown / usable / unavailable


def _native_ready() -> bool:
    """Probe the native library once (it builds at first use, so a missing
    toolchain shows then, not at import). Only a library that does not
    build or load turns the native route off; a per-file I/O error raises
    and leaves it on."""
    global _native_ok
    if _native_ok is None:
        _native_ok = native.available()
    return _native_ok


def load_kitti_bin(path: str, with_intensity: bool = False) -> np.ndarray:
    """Load a KITTI .bin scan -> (N, 3) or (N, 4) float32 array."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.getsize(path) == 0:
        # an empty scan is a 0-point cloud on both routes (the native mmap
        # cannot map 0 bytes)
        arr = np.zeros((0, 4), np.float32)
    elif _native_ready():
        arr = native.load_kitti_bin(path)
    else:
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
