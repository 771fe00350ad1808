"""Dense front end: radius normals + FPFH in plain PyTorch.

Counterpart of ``quatro_tpu/ops/dense_features.py``, the
``use_pallas_frontend=False`` path: the same pair passes as the kernels of
ops/frontend.py, run as row-tiled tensor code. It differs from the kernel
path only where the JAX package's dense path differs from its Pallas one:
Darboux angles use sqrt and quotients instead of rsqrt and products
(PCL semantics, src/teaser_utils/fpfh.cc:44-75). It runs on the CPU only:
on the card the front end is the kernels.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.fpfh import normalize_blocks
from quatro_tpu_torch.ops.frontend import (fpfh_sums_plain, moment_sums_plain,
                                           spfh_plain)
from quatro_tpu_torch.ops.normals import Normals, normals_from_moments


def _cpu_only(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"the dense front end runs on the CPU only, got a "
                         f"tensor on {t.device}; use ops/frontend.py there")


def dense_normals(points: torch.Tensor, mask: torch.Tensor,
                  radius: float) -> Normals:
    """PCA normals over true radius neighbourhoods (self included, >= 3
    neighbours for validity). points (..., V, 3), mask (..., V)."""
    _cpu_only(points)
    pts, msk = points.reshape(-1, *points.shape[-2:]), mask.reshape(
        -1, mask.shape[-1])
    mom = moment_sums_plain(pts, msk.to(pts.dtype), radius)
    n = normals_from_moments(pts, msk, mom)
    return Normals(*(t.reshape(*mask.shape, *t.shape[2:]) for t in n))


def dense_fpfh(points: torch.Tensor, normals: torch.Tensor,
               normal_valid: torch.Tensor, mask: torch.Tensor,
               radius: float) -> torch.Tensor:
    """FPFH descriptors (..., V, 33) over true radius neighbourhoods: SPFH
    blocks scaled to 100 per pair count, 1/d2-weighted neighbour sum, each
    11-bin block normalised to 100."""
    _cpu_only(points)
    lead = mask.shape
    pts = points.reshape(-1, *points.shape[-2:])
    nrm = normals.reshape(-1, *normals.shape[-2:])
    pair_maskf = (mask & normal_valid).reshape(-1, lead[-1]).to(pts.dtype)
    raw, cnt = spfh_plain(pts, nrm, pair_maskf, radius, use_rsqrt=False)
    spfh_rows = raw * (100.0 / torch.clamp(cnt, min=1.0))[..., None]
    out = normalize_blocks(fpfh_sums_plain(pts, spfh_rows, pair_maskf, radius))
    return out.reshape(*lead, out.shape[-1])
