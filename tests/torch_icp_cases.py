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
