"""The inputs that ICP's four kernels (ops/neighbors.radius_neighbors,
ops/normals.estimate_normals, ops/icp.icp_correspond and icp_update) are
held on: against the JAX package on the CPU
(tests/test_torch_icp_kernels.py) and against their plain versions on the
card (tests/test_torch_kernels_gpu.py). Made from seeds with numpy (the
synthetic scans); imports no JAX.

The clouds are tests/test_icp.py's VLP-16 pair (seed 9, yaw 20 deg, t =
(2.5, 1.0, 0)) as ICP's raw-scan voxels at 2048 voxels, source then target.
"""

import functools
import math

import numpy as np
import torch

from quatro_tpu_torch.config import LidarConfig, PipelineConfig
from quatro_tpu_torch.io.synthetic import make_scan_pair
from quatro_tpu_torch.pipeline import raw_scan_voxels
from quatro_tpu_torch.utils.se3 import rotation_from_rpy

V = 2048
RAW = 32768
PAIR = dict(seed=9, yaw_deg=20.0, translation=(2.5, 1.0, 0.0))
FEW_VALID = 20          # a cloud with fewer valid points than a list holds
# the list widths the kernels are held at besides the configured 48: one
# slot, a lane's slots exactly, one past them, the kernel's most
LIST_WIDTHS = (1, 32, 33, 64)
# the neighbour lists' edge cases (list_edge_case), three clouds each
LIST_EDGE_CASES = ("random_order", "duplicates", "specials", "huge", "tiny")


@functools.lru_cache(maxsize=None)
def _clouds():
    src, tgt, gt = make_scan_pair(lidar=LidarConfig.preset("VLP-16"),
                                  **PAIR)
    pts = np.zeros((2, RAW, 3), np.float32)
    mask = np.zeros((2, RAW), bool)
    for b, xyz in enumerate((src, tgt)):
        pts[b, :len(xyz)], mask[b, :len(xyz)] = xyz, True
    cfg = PipelineConfig.for_lidar("VLP-16", max_voxels=V)
    vox, vmask = raw_scan_voxels(torch.from_numpy(pts),
                                 torch.from_numpy(mask), cfg)
    return vox.numpy(), vmask.numpy(), gt.astype(np.float32)


def icp_clouds(device="cpu"):
    """(vox (2, V, 3), vmask (2, V), gt (4, 4) f32, cfg) on ``device``:
    the pair's raw-scan voxels, source then target."""
    vox, vmask, gt = _clouds()
    cfg = PipelineConfig.for_lidar("VLP-16", max_voxels=V)
    return (torch.from_numpy(vox).to(device),
            torch.from_numpy(vmask).to(device), gt, cfg)


def list_masks(vmask):
    """The neighbour lists' mask cases over the two clouds, (2, V) each:
    "as_is"; "few_valid" (cloud 1 keeps its first FEW_VALID valid points:
    its rows fill with masked columns in index order); "all_masked"
    (cloud 1 has none)."""
    few = vmask.clone()
    few[1, torch.nonzero(vmask[1])[FEW_VALID:, 0]] = False
    none = vmask.clone()
    none[1] = False
    return {"as_is": vmask, "few_valid": few, "all_masked": none}


def list_edge_case(name, device="cpu"):
    """(points (3, V, 3), mask (3, V)) on ``device``: three clouds made
    from the target's voxels (V = 2048), for the lists' f32 screen and
    tile culling (csrc/knn.cu):
    - "random_order": the voxels shuffled, the same scaled by 1e6 (large
      coordinates), and points uniform in a 40 m cube (no spatial order:
      culling rarely applies);
    - "duplicates": each voxel twice in a row, a coarse grid of spacing
      0.25 m, and one point repeated (ties: the lower index wins);
    - "specials": NaN and inf coordinates on valid and masked points, a
      row of NaN, and a cloud whose valid points are all inf or NaN;
    - "huge": a few points past 2^60 among the voxels, the voxels scaled
      by 2^50 (norms near the screen's 2^120 limit), and by 2^62 (past it);
    - "tiny": the voxels scaled by 1e-21 (squares below the normal range),
      by 1e-19, and mixed with points at 1e-21.
    Masks: the voxels' own, with a tenth of the points masked at random."""
    vox, vmask = (t.numpy() for t in icp_clouds()[:2])
    rng = np.random.default_rng(40 + LIST_EDGE_CASES.index(name))
    base, bmask = vox[1].astype(np.float32), vmask[1]
    v = base.shape[0]
    with np.errstate(all="ignore"):
        if name == "random_order":
            perm = rng.permutation(v)
            clouds = [base[perm], base[perm] * np.float32(1e6),
                      rng.uniform(-20.0, 20.0, (v, 3))]
        elif name == "duplicates":
            clouds = [np.repeat(base[: v // 2], 2, 0),
                      rng.integers(-4, 5, (v, 3)) * 0.25,
                      np.broadcast_to(base[7], (v, 3))]
        elif name == "specials":
            a = base.copy()
            a[rng.choice(v, 40, replace=False)] = np.nan
            a[rng.choice(v, 40, replace=False), rng.integers(0, 3, 40)] = \
                np.inf
            a[rng.choice(v, 10, replace=False), 2] = -np.inf
            b = base.copy()
            b[100] = np.nan
            c = np.full((v, 3), np.inf, np.float32)
            c[::3] = np.nan
            clouds = [a, b, c]
        elif name == "huge":
            a = base.copy()
            a[rng.choice(v, 30, replace=False)] = rng.uniform(
                2.0 ** 60, 2.0 ** 61, (30, 3))
            clouds = [a, base * np.float32(2.0 ** 50),
                      base * np.float32(2.0 ** 62)]
        elif name == "tiny":
            a = base.copy()
            a[rng.choice(v, 200, replace=False)] = rng.uniform(
                -1e-21, 1e-21, (200, 3))
            clouds = [base * np.float32(1e-21), base * np.float32(1e-19), a]
        else:
            raise KeyError(name)
    pts = np.stack([np.asarray(c, np.float32) for c in clouds])
    mask = np.stack([bmask] * 3) & (rng.random((3, v)) >= 0.1)
    if name == "duplicates":
        mask[1:] = rng.random((2, v)) >= 0.1
    if name == "specials":
        mask[2] = True
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(mask).to(device))


def init_poses(gt, device="cpu"):
    """Two coarse poses of the pair (2, 3, 3), (2, 3): the ground truth
    degraded by 1 deg of yaw and (0.2, -0.15, 0.05) m (tests/
    test_torch_refine.py's start), and by -3 deg and (-0.4, 0.3, 0.1) m."""
    rots, trans = [], []
    for deg, dt in ((1.0, (0.2, -0.15, 0.05)), (-3.0, (-0.4, 0.3, 0.1))):
        rots.append(rotation_from_rpy(0.0, 0.0, math.radians(deg)).numpy()
                    @ gt[:3, :3])
        trans.append(gt[:3, 3] + np.float32(dt))
    return (torch.from_numpy(np.stack(rots).astype(np.float32)).to(device),
            torch.from_numpy(np.stack(trans).astype(np.float32)).to(device))


def correspond_args(vox, vmask, normals, nvalid, gt, cfg, case="as_is",
                    device="cpu"):
    """``icp_correspond``'s arguments for a batch of two pairs, both the
    pair's source subsample against its target at ``init_poses``: case
    "as_is", or "all_masked" (pair 1's targets all masked: each of its
    rows matches target 0 and is not ok). Returns (src, smask, rot, trans,
    tgt, tgt_ok, normals, gates) on ``device``."""
    from quatro_tpu_torch.solver.icp import _gates, _subsample
    src, smask = _subsample(vox[:1], vmask[:1], cfg.icp.max_source_points)
    src, smask = src.expand(2, -1, -1), smask.expand(2, -1)
    tgt_ok = (vmask[1] & nvalid)[None].repeat(2, 1)
    if case == "all_masked":
        tgt_ok[1] = False
    rot, trans = init_poses(gt, device)
    gates = torch.tensor(_gates(cfg.icp), dtype=torch.float32)
    return tuple(t.to(device).contiguous() for t in (
        src, smask, rot, trans, vox[1:].expand(2, -1, -1),
        tgt_ok, normals[None].expand(2, -1, -1), gates))


def dof_of(yaw_only):
    """refine_icp's DoF mask [wx, wy, wz, tx, ty, tz]."""
    return torch.tensor([0.0, 0.0, 1.0, 1.0, 1.0, 1.0] if yaw_only
                        else [1.0] * 6)
