"""FPFH (Fast Point Feature Histogram) constants and binning.

PyTorch counterpart of the parts of ``quatro_tpu/ops/fpfh.py`` that the
dense and kernel front ends share: 3 Darboux angles x 11 bins = 33-D
descriptors (PCL's FPFHEstimation, src/teaser_utils/fpfh.cc:44-75).
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.utils.fused import recip

NUM_BINS = 11
FPFH_DIM = 3 * NUM_BINS


def _bin_index(f: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """floor(11 * (f - lo) / (hi - lo)) clipped to [0, 10], int32, the
    division taken as a multiplication by the f32 reciprocal of the width:
    the JAX package's compiled division by a constant, and the SPFH
    kernel's (csrc/spfh.cu), on the CPU and the card alike."""
    idx = torch.floor(NUM_BINS * (f - lo) * recip(hi - lo)).to(torch.int32)
    return torch.clamp(idx, 0, NUM_BINS - 1)


def normalize_blocks(fpfh: torch.Tensor) -> torch.Tensor:
    """Scale each 11-bin block of (..., 33) descriptors to sum 100 (PCL
    convention; an all-zero block stays zero)."""
    out = []
    for s in range(0, FPFH_DIM, NUM_BINS):
        block = fpfh[..., s:s + NUM_BINS]
        total = torch.clamp(block.sum(dim=-1, keepdim=True), min=1e-12)
        out.append(block * (100.0 / total))
    return torch.cat(out, dim=-1)
