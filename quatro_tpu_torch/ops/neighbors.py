"""Pairwise squared distances and the fixed-radius K-capped neighbour
search (``quatro_tpu/ops/neighbors.py``): a tiled brute-force distance
matrix in place of the reference's kd-tree radius queries
(src/teaser_utils/fpfh.cc:58-72)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.utils.fused import f32

_FLT_MAX = torch.finfo(torch.float32).max
_TILE_ENTRIES = 1 << 25     # distances a tile of a batch holds at most


class NeighborLists(NamedTuple):
    # a batch of clouds adds a leading B
    idx: torch.Tensor    # (N, K) int32 neighbour indices (self first)
    valid: torch.Tensor  # (N, K) bool: inside the radius and a real point
    dist2: torch.Tensor  # (N, K) f32 squared distances


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor,
                      sq_a: torch.Tensor | None = None,
                      sq_b: torch.Tensor | None = None) -> torch.Tensor:
    """(..., Na, Nb) squared L2 distances via the Gram identity, clamped
    at 0, in full f32 (a matmul with TF32 off, the counterpart of
    HIGHEST)."""
    if sq_a is None:
        sq_a = (a * a).sum(-1)
    if sq_b is None:
        sq_b = (b * b).sum(-1)
    return torch.clamp(sq_a[..., :, None] + sq_b[..., None, :]
                       - 2.0 * (a @ b.transpose(-1, -2)), min=0.0)


def radius_neighbors(points: torch.Tensor, mask: torch.Tensor, radius: float,
                     k: int, tile: int = 512) -> NeighborLists:
    """The K nearest neighbours within ``radius`` of every point, against
    the cloud itself; points (N, 3), mask (N,), or a batch of clouds
    (B, N, 3), (B, N). Rows go in tiles of ``tile`` (a full 8192 x 8192
    f32 matrix is 256 MB), fewer for a large batch, so that a tile holds
    at most ``_TILE_ENTRIES`` distances in all. Ties go to the lower
    index, as ``lax.top_k``'s: the selection sorts one packed int64 key,
    (d2 bits << 32) | index, which is unique per row (d2 >= 0, so its f32
    bits order like the value)."""
    n = points.shape[-2]
    r2 = f32(radius * radius)
    sq = (points * points).sum(-1)
    iota = torch.arange(n, device=points.device)
    clouds = points[..., 0, 0].numel()
    tile = max(1, min(tile, _TILE_ENTRIES // max(1, clouds * n)))
    idx, valid, d2k = [], [], []
    for s in range(0, n, tile):
        d2 = pairwise_sq_dists(points[..., s:s + tile, :], points,
                               sq_a=sq[..., s:s + tile], sq_b=sq)
        d2 = torch.where(mask[..., None, :], d2, _FLT_MAX)
        key = (d2.contiguous().view(torch.int32).long() << 32) | iota
        sel = torch.topk(key, k, dim=-1, largest=False).values
        j = sel & 0xFFFFFFFF
        dk = d2.gather(-1, j)
        idx.append(j.to(torch.int32))
        d2k.append(dk)
        valid.append((dk <= r2) & mask[..., s:s + tile, None])
    return NeighborLists(torch.cat(idx, -2), torch.cat(valid, -2),
                         torch.cat(d2k, -2))
