"""Pairwise squared distances (the part of ``quatro_tpu/ops/neighbors.py``
this slice reaches)."""

from __future__ import annotations

import torch


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor,
                      sq_a: torch.Tensor | None = None,
                      sq_b: torch.Tensor | None = None) -> torch.Tensor:
    """(Na, Nb) squared L2 distances via the Gram identity, clamped at 0,
    in full f32 (a matmul with TF32 off, the counterpart of HIGHEST)."""
    if sq_a is None:
        sq_a = (a * a).sum(-1)
    if sq_b is None:
        sq_b = (b * b).sum(-1)
    return torch.clamp(sq_a[:, None] + sq_b[None, :] - 2.0 * (a @ b.T),
                       min=0.0)
