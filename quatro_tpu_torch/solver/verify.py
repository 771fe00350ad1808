"""Registration verification by alignment overlap.

PyTorch counterpart of ``quatro_tpu/solver/verify.py``: apply a pose to
the source cloud and count the share of its points with a target point
within a small radius. Correct registrations score well above wrong ones
(0.68-0.81 vs 0.05-0.14 on the JAX package's ray-cast fixtures), so the
multi-hypothesis pipeline keeps the hypothesis with the largest overlap.

Distances are difference-first per coordinate, never the Gram identity
|a|^2 + |b|^2 - 2 a.b (``torch.cdist``'s default), whose f32 cancellation
at 40-80 m ranges reaches ~1e-2 m^2 and would corrupt the score near a
tight radius.
"""

from __future__ import annotations

import math

import torch

from quatro_tpu_torch.types import RegistrationSolution
from quatro_tpu_torch.utils import loops
from quatro_tpu_torch.utils.se3 import rotate_points


def _block_hits(consts, state, rows):
    """One block of ``alignment_overlap``'s device loop: the hits of the
    ``rows`` source rows from the device-side offset ``start`` on (a
    captured chunk replays for every later chunk, so no position may come
    from the host)."""
    p, pm, tgt, tgt_mask, r2, iota = consts
    hits, start = state
    idx = start + iota
    bp = p.index_select(-2, idx)
    dx = bp[..., :, 0:1] - tgt[..., None, :, 0]
    dy = bp[..., :, 1:2] - tgt[..., None, :, 1]
    dz = bp[..., :, 2:3] - tgt[..., None, :, 2]
    d2 = torch.where(tgt_mask[..., None, :], dx * dx + dy * dy + dz * dz,
                     float("inf"))
    hits = hits + ((d2.amin(-1) <= r2) & pm.index_select(-1, idx)).sum(-1)
    return hits, start + rows


def alignment_overlap(src, src_mask, tgt, tgt_mask, rotation, translation,
                      radius: float, row_block: int = 2048) -> torch.Tensor:
    """Share of valid source points within ``radius`` of a valid target
    point after applying (rotation, translation): f32 in [0, 1], of the
    leading shape of the poses and clouds broadcast together (a 0-d
    tensor for one pose on one pair; (B, K) for K poses (B, K, 3, 3) on
    B pairs given as (B, 1, N, 3)). The distances are taken in blocks of
    ``row_block`` source rows, split among the poses and pairs (at least
    one row a block): the source is padded to a whole number of blocks,
    the padding masked out (as the JAX package pads), and the blocks are
    a ``fori`` device loop (utils/loops.py, the JAX package's
    ``lax.map``; one CUDA graph on the card). The share is an integer
    count, so the blocking does not change it."""
    p = rotate_points(src, rotation) + translation[..., None, :]
    lead = torch.broadcast_shapes(p.shape[:-2], tgt.shape[:-2],
                                  src_mask.shape[:-1], tgt_mask.shape[:-1])
    rows = max(1, row_block // max(1, math.prod(lead)))
    n = p.shape[-2]
    blocks = -(-n // rows)
    pad = blocks * rows - n
    pm = torch.nn.functional.pad(src_mask, (0, pad))
    p = torch.nn.functional.pad(p, (0, 0, 0, pad))
    dev = p.device
    # f32 radius squared on the device (a fill, not a copy from the host)
    r2 = torch.full((), radius, dtype=p.dtype, device=dev) ** 2
    iota = torch.arange(rows, device=dev)

    def body(consts, state):
        return _block_hits(consts, state, rows)

    hits, _ = loops.fori(
        "overlap", body, (p, pm, tgt, tgt_mask, r2, iota),
        (torch.zeros(lead, dtype=torch.int64, device=dev),
         torch.zeros((), dtype=torch.int64, device=dev)), blocks, blocks)
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
