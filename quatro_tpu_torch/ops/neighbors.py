"""Pairwise squared distances and the fixed-radius K-capped neighbour
search (``quatro_tpu/ops/neighbors.py``): a brute-force distance matrix in
place of the reference's kd-tree radius queries
(src/teaser_utils/fpfh.cc:58-72).

``radius_neighbors`` launches csrc/knn.cu for CUDA tensors (one call for
a batch of clouds, counted in ``LAUNCHES["radius_knn"]``: up to K = 256
a pre-pass and the list kernel, past it one block route)
and runs ``radius_neighbors_plain`` for CPU tensors; there is no fallback
between the two, and they agree bit for bit on the card. Both take their
distances in one stated arithmetic (``sq_norms``, ``ordered_sq_dists``):
the JAX package's compiled program forms |a|^2 and the Gram product's
three terms as fused multiply-adds (XLA's reduction and dot on the CPU),
and on the VLP-16 test pair every row's neighbour list then equals its
own. The kernel screens pairs in f32 and skips column tiles by their
boxes; ``knn_tiles_culled`` mirrors that predicate in torch.
``pairwise_sq_dists`` keeps the matrix product for the matcher.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.ops.launch import (LAUNCHES, check, launch, same_device,
                                         size_route)
from quatro_tpu_torch.utils.fused import f32, fma

_FLT_MAX = torch.finfo(torch.float32).max
_TILE_ENTRIES = 1 << 25     # distances a tile of a batch holds at most
KNN_MAX_K = 64              # SIZE_ROUTES' split only: past it, over two
# slots a lane (one kernel template serves every K to KNN_SLOTS_MAX_K)
KNN_SLOTS_MAX_K = 256       # the warp route's widest: eight slots a lane
KNN_TILE = 32               # columns a tile of the kernel's culling
KNN_SUPER = 8               # tiles a super tile
_SAFE_NORM = 2.0 ** 120     # the screen's norm limit (csrc/knn.cu)
_SLACK = 2.0 ** -20
_KNN_SORT_SMEM = 200 * 1024  # the block route's keys in shared memory
_KNN_SORT_WORK = 1 << 28     # bytes of its global workspace at most


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


def sq_norms(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 of (..., 3) points: x * x, then y * y and z * z each fused into
    the running sum (``fused.fma``)."""
    x, y, z = p.unbind(-1)
    return fma(z, z, fma(y, y, x * x))


def ordered_sq_dists(a: torch.Tensor, b: torch.Tensor, sq_a: torch.Tensor,
                     sq_b: torch.Tensor) -> torch.Tensor:
    """(..., Na, Nb) squared distances of (..., Na, 3) and (..., Nb, 3)
    points given their ``sq_norms``: the dot product a_x b_x, then a_y b_y
    and a_z b_z each fused into it, and max((|a|^2 + |b|^2) - 2 a.b, 0).
    Elementwise operations only, so the CPU and the card round alike,
    whatever the shapes; csrc/knn.cu and csrc/icp.cu repeat them."""
    ax, ay, az = (a[..., :, None, c] for c in range(3))
    bx, by, bz = (b[..., None, :, c] for c in range(3))
    dot = fma(az, bz, fma(ay, by, ax * bx))
    return torch.clamp((sq_a[..., :, None] + sq_b[..., None, :]) - 2.0 * dot,
                       min=0.0)


def radius_neighbors_plain(points: torch.Tensor, mask: torch.Tensor,
                           radius: float, k: int,
                           tile: int = 512) -> NeighborLists:
    """``radius_neighbors`` in torch operations: rows in tiles of ``tile``
    (a full 8192 x 8192 matrix is 256 MB), fewer for a large batch, so
    that a tile holds at most ``_TILE_ENTRIES`` distances in all. Ties go
    to the lower index, as ``lax.top_k``'s: the selection sorts one packed
    int64 key, (d2 bits << 32) | index, which is unique per row (d2 >= 0,
    so its f32 bits order like the value)."""
    n = points.shape[-2]
    r2 = f32(radius * radius)
    sq = sq_norms(points)
    iota = torch.arange(n, device=points.device)
    clouds = points[..., 0, 0].numel()
    tile = max(1, min(tile, _TILE_ENTRIES // max(1, clouds * n)))
    idx, valid, d2k = [], [], []
    for s in range(0, n, tile):
        d2 = ordered_sq_dists(points[..., s:s + tile, :], points,
                              sq[..., s:s + tile], sq)
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


def radius_neighbors(points: torch.Tensor, mask: torch.Tensor, radius: float,
                     k: int, tile: int = 512,
                     stats: torch.Tensor | None = None) -> NeighborLists:
    """The K nearest neighbours within ``radius`` of every point, against
    the cloud itself; points (N, 3), mask (N,), or a batch of clouds
    (B, N, 3), (B, N): the K least keys (d2 bits, column) of each row over
    all columns, masked columns at the f32 maximum (so a row with fewer
    than K valid columns fills with masked ones in index order), self
    first. For CUDA tensors one call of csrc/knn.cu: up to
    ``KNN_SLOTS_MAX_K`` the pre-pass (the columns, the tiles' bounds) and
    the list kernel (a warp a row, ceil(K / 32) slots a lane; calls past
    ``KNN_MAX_K`` counted "past" in ``SIZE_ROUTES``), then a block a row
    sorting the row's keys; ``stats`` (a CUDA int64 tensor of
    one element), where given, gets the (row, column tile) pairs the list
    kernel screened. For CPU tensors ``radius_neighbors_plain`` (``tile``
    is its row tile)."""
    n = points.shape[-2]
    if not 1 <= k <= n:
        raise ValueError(f"radius_neighbors: k = {k} of {n} points")
    if same_device(points, mask).type != "cuda":
        return radius_neighbors_plain(points, mask, radius, k, tile)
    lead = points.shape[:-2]
    bsz = points[..., 0, 0].numel()
    check("points", points, (*lead, n, 3))
    check("mask", mask, (*lead, n), torch.bool)
    dev = points.device
    if stats is not None:
        check("stats", stats, (1,), torch.int64)
        same_device(points, stats)
    idx = torch.empty((*lead, n, k), dtype=torch.int32, device=dev)
    valid = torch.empty((*lead, n, k), dtype=torch.bool, device=dev)
    d2 = torch.empty((*lead, n, k), dtype=torch.float32, device=dev)
    if bsz:
        work, blocks = knn_sort_plan(bsz * n, n, k, dev)
        cols = bounds = 0
        if k <= KNN_SLOTS_MAX_K:
            tiles = -(-n // KNN_TILE)
            cols = torch.empty((bsz, n, 4), dtype=torch.float32, device=dev)
            bounds = torch.empty((bsz, tiles + -(-tiles // KNN_SUPER), 8),
                                 dtype=torch.float32, device=dev)
        launch("knn", points, mask, bsz, n, k, f32(radius * radius), idx,
               valid, d2, work, blocks, cols, bounds,
               0 if stats is None else stats)
        LAUNCHES["radius_knn"] += 1
        size_route("radius_knn", k > KNN_MAX_K)
    return NeighborLists(idx, valid, d2)


def knn_tile_bounds(points: torch.Tensor, mask: torch.Tensor):
    """csrc/knn.cu's pre-pass in torch: for (..., N, 3) points and (..., N)
    masks, each tile of ``KNN_TILE`` columns' box of its valid points (lo
    +inf and hi -inf where none is), the largest ``sq_norms`` among them
    (0 where none) and whether one is unsafe (a norm past 2^120, an inf or
    a NaN): (lo (..., T, 3), hi (..., T, 3), qmax (..., T), unsafe (...,
    T))."""
    n = points.shape[-2]
    pad = -n % KNN_TILE
    tiles = (n + pad) // KNN_TILE
    m = torch.nn.functional.pad(mask, (0, pad)).reshape(
        *mask.shape[:-1], tiles, KNN_TILE)
    p = torch.nn.functional.pad(points, (0, 0, 0, pad)).reshape(
        *points.shape[:-2], tiles, KNN_TILE, 3)
    inf = torch.tensor(float("inf"), device=points.device)
    lo = torch.where(m[..., None], p, inf).amin(-2)
    hi = torch.where(m[..., None], p, -inf).amax(-2)
    sq = sq_norms(p)
    qmax = torch.where(m & ~sq.isnan(), sq, 0.0).amax(-1)
    unsafe = (m & ~(sq <= _SAFE_NORM)).any(-1)
    return lo, hi, qmax, unsafe


def knn_tiles_culled(points: torch.Tensor, mask: torch.Tensor,
                     kth_d2: torch.Tensor) -> torch.Tensor:
    """csrc/knn.cu's culling predicate in torch: (..., N, T) bool, True
    where row i may skip column tile t once the d2 of its list's K-th key
    is ``kth_d2[..., i]``. The row and the tile are safe (no norm past
    2^120, no inf or NaN), the K-th d2 is below the f32 maximum, and the
    gap2 from the row's point to the tile's box, sq3 of max(0, lo - p,
    p - hi) per axis, is above the screen's threshold (dK + 2^-20 (|p|^2
    + the tile's largest |q|^2)) (1 + 2^-20) + 2^-100, each operation
    rounded to f32 as the kernel rounds it."""
    lo, hi, qmax, unsafe = knn_tile_bounds(points, mask)
    p = points[..., :, None, :]
    g = torch.clamp(torch.maximum(lo[..., None, :, :] - p,
                                  p - hi[..., None, :, :]), min=0.0)
    gap2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) \
        + g[..., 2] * g[..., 2]
    sqp = sq_norms(points)
    one = torch.ones((), dtype=torch.float32, device=points.device)
    thr = ((kth_d2[..., None] + (_SLACK * one) * (sqp[..., None]
                                                  + qmax[..., None, :]))
           * ((1.0 + _SLACK) * one)) + (2.0 ** -100) * one
    safe_row = (sqp <= _SAFE_NORM)[..., None]
    return (safe_row & ~unsafe[..., None, :]
            & (kth_d2 < _FLT_MAX)[..., None] & (gap2 > thr))


def knn_sort_plan(rows: int, n: int, k: int, dev):
    """(workspace or 0, blocks) of csrc/knn.cu's block route (K >
    ``KNN_SLOTS_MAX_K``): a row's keys padded to a power of two in shared
    memory where they fit (no workspace), else a global workspace of
    at most ``_KNN_SORT_WORK`` bytes, a block's keys each; (0, 0) for the
    warp routes."""
    if k <= KNN_SLOTS_MAX_K:
        return 0, 0
    pn = 1 << max(n - 1, 0).bit_length()
    if pn * 8 <= _KNN_SORT_SMEM:
        return 0, min(rows, 1024)
    blocks = max(1, min(rows, _KNN_SORT_WORK // (pn * 8)))
    return torch.empty(blocks * pn, dtype=torch.int64, device=dev), blocks
