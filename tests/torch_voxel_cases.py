"""The clouds that the voxel grid's three kernels (ops/voxel.voxel_keys,
voxel_select, voxel_centroids) are held on: against the JAX package and
the grid's former torch route on the CPU
(tests/test_torch_voxel_kernels.py), and against their plain versions on
the card (tests/test_torch_kernels_gpu.py). Made from seeds with numpy
(the synthetic VLP-16 scans); imports no JAX.

Each case is (points (C, N, 3) f32, mask (C, N) bool, voxel capacity,
active_cap), N = 32768, the leaf VOXEL:
- "active_cap": a raw VLP-16 scan with an active prefix of 8192 points,
  fewer than it has valid (its highest Morton keys dropped);
- "ties": 1600 voxels of 3 points and 200 of 5, shuffled, under a
  capacity of 1000 and no active_cap: the cut falls inside the 3-point
  voxels (the last run takes the sentinels after it and is chosen first);
- "dense_voxel": 17000 points in one voxel (past the rank key's 16383)
  and most of a VLP-16 scan;
- "outside_grid": a VLP-16 scan and 500 valid points 400 m away, past the
  1024-cell grid;
- "all_masked": a scan under an all-False mask;
- "no_active_cap": a raw VLP-16 scan, the whole capacity scanned;
- "batch3": a scan, the ties cloud and an all-masked cloud in one call.
"""

import functools

import numpy as np

from quatro_tpu_torch.config import LidarConfig
from quatro_tpu_torch.io.synthetic import make_scan_pair

VOXEL = 0.3
N = 32768
DENSE = 17000
CASES = ("active_cap", "ties", "dense_voxel", "outside_grid", "all_masked",
         "no_active_cap", "batch3")


@functools.lru_cache(maxsize=None)
def _scan():
    src, _, _ = make_scan_pair(seed=101, yaw_deg=38.0,
                               translation=(2.5, -1.2, 0.04),
                               lidar=LidarConfig.preset("VLP-16"))
    return src.astype(np.float32)


def _ties(rng):
    """1600 voxels of 3 points and 200 of 5 on a lattice, each point in
    the middle third of its voxel, and one point at the origin (the grid's
    corner, a voxel of its own), in random order."""
    cells = np.stack(np.meshgrid(np.arange(1, 46), np.arange(1, 41), [1, 2],
                                 indexing="ij"), -1).reshape(-1, 3)
    cells = cells[rng.permutation(len(cells))[:1800]]
    reps = np.where(np.arange(1800) < 1600, 3, 5)
    xyz = (np.repeat(cells, reps, 0) + 0.34) * VOXEL + rng.uniform(
        0.0, 0.09, (int(reps.sum()), 3))
    xyz = np.concatenate([np.zeros((1, 3)), xyz])
    return xyz[rng.permutation(len(xyz))].astype(np.float32)


def _packed(clouds):
    pts = np.zeros((len(clouds), N, 3), np.float32)
    mask = np.zeros((len(clouds), N), bool)
    for c, xyz in enumerate(clouds):
        k = min(len(xyz), N)
        pts[c, :k], mask[c, :k] = xyz[:k], True
    return pts, mask


def voxel_case(name):
    """(points, mask, capacity, active_cap) of case ``name``, numpy."""
    rng = np.random.default_rng(CASES.index(name))
    scan = _scan()
    if name == "active_cap":
        return (*_packed([scan]), 2048, 8192)
    if name == "ties":
        return (*_packed([_ties(rng)]), 1000, None)
    if name == "dense_voxel":
        # the middle of the cell (40, 20, 10) from the scan's corner
        corner = scan.min(0).astype(np.float64)
        dense = (corner + (np.array([40, 20, 10]) + 0.4) * VOXEL
                 + rng.uniform(0.0, 0.06, (DENSE, 3))).astype(np.float32)
        both = np.concatenate([dense, scan[:N - DENSE]])
        return (*_packed([both[rng.permutation(len(both))]]), 2048, None)
    if name == "outside_grid":
        far = (np.array([400.0, 0.0, 0.0])
               + rng.uniform(-20.0, 20.0, (500, 3))).astype(np.float32)
        both = np.concatenate([scan[:20000], far, scan[20000:]])
        return (*_packed([both]), 2048, N)
    if name == "all_masked":
        pts, mask = _packed([scan])
        return pts, np.zeros_like(mask), 512, None
    if name == "no_active_cap":
        return (*_packed([scan]), 2048, None)
    if name == "batch3":
        pts, mask = _packed([scan, _ties(rng), scan[::-1]])
        mask[2] = False
        return pts, mask, 1024, 16384
    raise KeyError(name)
