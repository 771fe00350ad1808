"""PCD file IO and the reference's concatenated feature-pair cache.

Counterpart of ``quatro_tpu/io/pcd.py``, numpy only, reading and writing
the same bytes.

The reference caches each matched keypoint pair as ONE PCD file holding the
source keypoints followed by the target keypoints ("Source is the first!!!",
reference: include/fpfh_manager.hpp:179-232), named ``%06d_to_%06d.pcd``,
and splits it back at the midpoint on load. This module reproduces that
on-disk format exactly so caches are interchangeable with the reference,
and doubles as a general PCD reader/writer for PCL users (the reference's
native cloud format everywhere else).

Supported: PCD v0.7, ``ascii`` and ``binary`` DATA, fields x/y/z
(+ optional intensity and any extra scalar fields, which are ignored on
read). ``binary_compressed`` is not supported (the reference never writes
it; ``pcl::io::savePCDFile`` defaults to ascii/binary).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_DTYPES = {("F", 4): "<f4", ("F", 8): "<f8",
           ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4",
           ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4"}


def load_pcd(path: str) -> np.ndarray:
    """Read a PCD file; returns (N, 3) float32 xyz (extra fields dropped,
    non-finite points kept — callers mask, as the pipeline does)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"[pcd]: truncated header in {path}")
            text = line.decode("ascii", "replace").strip()
            if not text or text.startswith("#"):
                continue
            key, _, val = text.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header.get("FIELDS", "x y z").split()
        sizes = [int(s) for s in header.get(
            "SIZE", " ".join(["4"] * len(fields))).split()]
        types = header.get("TYPE", " ".join(["F"] * len(fields))).split()
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()]
        # POINTS is optional in the v0.7 spec; organized clouds carry the
        # count as WIDTH x HEIGHT.
        if "POINTS" in header:
            n = int(header["POINTS"])
        else:
            n = int(header.get("WIDTH", "0")) * int(header.get("HEIGHT", "1"))
        data = header["DATA"].split()[0].lower()

        if data == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
            cols = {}
            off = 0
            for name, cnt in zip(fields, counts):
                cols[name] = raw[:, off]
                off += cnt
        elif data == "binary":
            dtype = np.dtype([
                (name if name != "_" else f"_pad{i}",
                 _DTYPES[(t, s)], (cnt,) if cnt > 1 else ())
                for i, (name, s, t, cnt)
                in enumerate(zip(fields, sizes, types, counts))])
            rec = np.frombuffer(f.read(dtype.itemsize * n), dtype, count=n)
            cols = {name: rec[name] for name in rec.dtype.names
                    if not name.startswith("_pad")}
        else:
            raise ValueError(f"[pcd]: unsupported DATA '{data}' in {path}")

    missing = [a for a in ("x", "y", "z") if a not in cols]
    if missing:
        raise ValueError(f"[pcd]: missing fields {missing} in {path}")
    return np.stack([np.asarray(cols[a], np.float32).reshape(-1)
                     for a in ("x", "y", "z")], axis=1)


def save_pcd(path: str, xyz: np.ndarray,
             intensity: Optional[np.ndarray] = None,
             binary: bool = True) -> None:
    """Write an (N, 3) cloud (optionally + intensity) as PCD v0.7."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    fields, cols = ["x", "y", "z"], [xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    if intensity is not None:
        fields.append("intensity")
        cols.append(np.asarray(intensity, np.float32).reshape(-1))
    k = len(fields)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * k)}\n"
        f"TYPE {' '.join(['F'] * k)}\n"
        f"COUNT {' '.join(['1'] * k)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        stacked = np.stack(cols, axis=1).astype("<f4")
        if binary:
            stacked.tofile(f)
        else:
            np.savetxt(f, stacked, fmt="%.8g")


def feature_pair_path(directory: str, src_idx: int, tgt_idx: int) -> str:
    """The reference's cache naming: ``%06d_to_%06d.pcd``
    (fpfh_manager.hpp:183)."""
    return os.path.join(directory, f"{src_idx:06d}_to_{tgt_idx:06d}.pcd")


def save_feature_pair(directory: str, src_idx: int, tgt_idx: int,
                      src_kps: np.ndarray, tgt_kps: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> str:
    """Cache matched keypoints in the reference's concatenated-PCD layout
    (source first, fpfh_manager.hpp:189-194). Padded slots are dropped via
    `mask` so the file round-trips through the reference loader, which
    splits at the midpoint and so requires len(src) == len(tgt)."""
    src_kps = np.asarray(src_kps, np.float32).reshape(-1, 3)
    tgt_kps = np.asarray(tgt_kps, np.float32).reshape(-1, 3)
    if mask is not None:
        keep = np.asarray(mask, bool)
        src_kps, tgt_kps = src_kps[keep], tgt_kps[keep]
    if src_kps.shape[0] != tgt_kps.shape[0]:
        raise ValueError("[pcd]: matched pair must have equal src/tgt counts")
    if not directory:
        raise ValueError("[pcd]: save dir. is not set")  # hpp:181
    os.makedirs(directory, exist_ok=True)
    path = feature_pair_path(directory, src_idx, tgt_idx)
    save_pcd(path, np.concatenate([src_kps, tgt_kps], axis=0))
    return path


def load_feature_pair(directory: str, src_idx: int,
                      tgt_idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """Load a cached pair; splits at the midpoint exactly as the reference
    does (fpfh_manager.hpp:221-227). Returns (src_kps, tgt_kps)."""
    if not directory:
        raise ValueError("[pcd]: load dir. is not set")  # hpp:205
    path = feature_pair_path(directory, src_idx, tgt_idx)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"[pcd]: Load feature set failed: {path}")  # hpp:212
    merged = load_pcd(path)
    half = merged.shape[0] // 2
    return merged[:half], merged[half:2 * half]
