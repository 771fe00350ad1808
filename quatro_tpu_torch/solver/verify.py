"""Registration verification by alignment overlap.

PyTorch counterpart of ``quatro_tpu/solver/verify.py``: apply a pose to
the source cloud and count the share of its points with a target point
within a small radius. Correct registrations score well above wrong ones
(0.68-0.81 vs 0.05-0.14 on the JAX package's ray-cast fixtures), so the
multi-hypothesis pipeline keeps the hypothesis with the largest overlap.

Distances are difference-first per coordinate, never the Gram identity
|a|^2 + |b|^2 - 2 a.b (``torch.cdist``'s default), whose f32 cancellation
at 40-80 m ranges reaches ~1e-2 m^2 and would corrupt the score near a
tight radius (ops/overlap.py).
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.overlap import overlap_hits
from quatro_tpu_torch.types import RegistrationSolution
from quatro_tpu_torch.utils.se3 import rotate_points


def alignment_overlap(src, src_mask, tgt, tgt_mask, rotation, translation,
                      radius: float, row_block: int = 2048) -> torch.Tensor:
    """Share of valid source points within ``radius`` of a valid target
    point after applying (rotation, translation): f32 in [0, 1], of the
    leading shape of the poses and clouds broadcast together (a 0-d
    tensor for one pose on one pair; (B, K) for K poses (B, K, 3, 3) on
    B pairs given as (B, 1, N, 3)). The hits are one call of
    ``ops/overlap.overlap_hits``: one kernel launch for every pose and
    pair on the card, the JAX package's blocks of ``row_block`` source
    rows (a ``fori`` device loop) on the CPU. The share is an integer
    count, so neither route changes it."""
    p = rotate_points(src, rotation) + translation[..., None, :]
    # f32 radius squared on the device (a fill, not a copy from the host)
    r2 = torch.full((), radius, dtype=p.dtype, device=p.device) ** 2
    hits = overlap_hits(p, src_mask, tgt, tgt_mask, r2, row_block)
    return hits.to(p.dtype) / torch.clamp(src_mask.sum(-1), min=1).to(p.dtype)


def arbitrate_hypotheses(sols: RegistrationSolution, src, src_mask, tgt,
                         tgt_mask, radius: float,
                         max_src_points: int | None = 2048):
    """The best of K hypotheses (a solution with a leading K axis, or
    (B, K) for B pairs with clouds (B, N, 3)) by overlap: (winning
    solution without the K axis, overlaps (K,) or (B, K)). Invalid
    hypotheses score -1; ties go to the first. The source side is
    thinned by a stride to at most ``max_src_points`` points (voxels are
    Morton-ordered, so a stride thins evenly); the target stays whole."""
    if max_src_points is not None and src.shape[-2] > max_src_points:
        stride = -(-src.shape[-2] // max_src_points)
        src = src[..., ::stride, :]
        src_mask = src_mask[..., ::stride]
    overlaps = alignment_overlap(
        src[..., None, :, :], src_mask[..., None, :], tgt[..., None, :, :],
        tgt_mask[..., None, :], sols.rotation, sols.translation, radius)
    score = torch.where(sols.valid, overlaps, -1.0)
    return sols.take(torch.argmax(score, -1)), overlaps
