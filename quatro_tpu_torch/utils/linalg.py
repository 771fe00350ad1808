"""Linear-algebra extras for API parity with teaser::linalg / teaser::utils.

PyTorch counterpart of ``quatro_tpu/utils/linalg.py``: hatmap, the
column-wise Kronecker product and the nearest-PSD projection
(include/teaser/linalg.h:24-99), and the sampling, diameter and masking
helpers (include/teaser/utils.h:33-200) on fixed capacity + mask pairs.
None is on Quatro's hot path. Each works on the device of its tensors.
"""

from __future__ import annotations

import torch


def hatmap(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrices of (..., 3) vectors
    (include/teaser/linalg.h:24-38)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def vector_kron(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Row-wise Kronecker product (..., d1) x (..., d2) -> (..., d1*d2)
    (the reference's OpenMP loop, include/teaser/linalg.h:40-70)."""
    return (v1[..., :, None] * v2[..., None, :]).reshape(
        *v1.shape[:-1], v1.shape[-1] * v2.shape[-1])


def nearest_psd(a: torch.Tensor) -> torch.Tensor:
    """Project symmetric (..., d, d) matrices onto the PSD cone by clipping
    their eigenvalues at 0 (include/teaser/linalg.h:72-99)."""
    w, v = torch.linalg.eigh((a + a.transpose(-1, -2)) / 2)
    w = torch.clamp(w, min=0.0)
    return (v * w[..., None, :]) @ v.transpose(-1, -2)


def calculate_diameter(points: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """2 * the largest distance of a valid point from the valid points'
    centroid (include/teaser/utils.h:109-114); points (N, 3), mask (N,)."""
    w = mask.to(points.dtype)[:, None]
    cog = (points * w).sum(0) / torch.clamp(w.sum(), min=1.0)
    d2 = ((points - cog) ** 2).sum(-1)
    return 2.0 * torch.sqrt(torch.where(mask, d2, 0.0).max())


def random_sample_mask(generator: torch.Generator, mask: torch.Tensor,
                       num_samples: int) -> torch.Tensor:
    """A uniform sample without replacement of ``num_samples`` set bits of
    ``mask`` (all of them if fewer are set), as a new mask: the
    reference's randomSample (include/teaser/utils.h:33-58) without its
    dynamic output vector. The draws come from ``generator``."""
    n = mask.shape[0]
    u = torch.rand(n, generator=generator, device=generator.device)
    scores = torch.where(mask, u.to(mask.device), -1.0)
    take = min(int(num_samples), int(mask.sum()))
    sel = torch.zeros(n, dtype=torch.bool, device=mask.device)
    sel[torch.argsort(scores, descending=True)[:take]] = True
    return sel & mask


def mask_indices(mask: torch.Tensor, fill: int = -1) -> torch.Tensor:
    """Indices of the set bits of (N,) ``mask`` in order, padded with
    ``fill`` to N: the static-shape findNonzero
    (include/teaser/utils.h:192-200)."""
    n = mask.shape[0]
    iota = torch.arange(n, device=mask.device)
    order = torch.argsort(torch.where(mask, iota, n + iota))
    return torch.where(iota < mask.sum(), order, fill)
