"""Voxel-grid downsampling (centroid per occupied voxel): point keys, the
occupancy cut and the centroids.

PyTorch counterpart of ``quatro_tpu/ops/voxel.py`` (the reference wraps
``pcl::VoxelGrid``, include/quatro.hpp:49-68). Same algorithm and the same
slot order, so every later stage can be compared index by index:

  1. one stable sort over a 30-bit Morton voxel key carrying the
     corner-relative fractional coordinates packed as 15-bit fixed point;
  2. run-length bookkeeping (per-voxel counts, run starts);
  3. the top-``capacity`` voxels by clamped count, descending, ties toward
     the lower position, in position (Morton) order;
  4. per-voxel centroid sums by prefix-sum differences at run
     boundaries, with the prefix sum taken in the JAX package's own
     addition order (``utils.scan.prefix_at``).

The JAX package runs all of it as one ``jax.jit``, XLA loop fusions around
two ``lax.sort``s (``quatro_tpu/ops/voxel.py:113-228``; no Pallas kernel
there); the port runs it as three hand-written kernels of csrc/voxel.cu
around one ``torch.sort`` of int32 keys (the Morton key has 30 bits and
its sentinel is int32's max):

- ``voxel_keys``: each cloud's corner (torch's ``amin`` over the valid
  points), then per point the key and the two int32 payload words, for a
  batch of clouds in one launch;
- ``voxel_select``: a block a cloud, from the sorted keys to the chosen
  runs' starts, counts and keys by a counting selection (the JAX
  package's two sorts of rank keys give the same integers);
- ``voxel_centroids``: two launches, the payload gathered through the
  sort's order and the blocked prefix's lower levels by spans of 2048
  positions (the level-0 running sums written at the run ends only),
  then the upper levels and the centroids by tiles of 256 slots.

For CUDA tensors a wrapper checks its inputs (ValueError), launches and
counts the call in ``LAUNCHES``; for CPU tensors it runs its plain version
(``*_plain``, the torch operations of the grid before the kernels, split
at the same seams). There is no fallback between the two, and the kernels
equal their plain versions bit for bit.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.launch import LAUNCHES, check, launch, same_device
from quatro_tpu_torch.utils import fused
from quatro_tpu_torch.utils.scan import BLOCK, prefix_at

# Cells per axis: 10 bits each, packed into one non-negative key.
_BITS = 10
_GRID = 1 << _BITS
_FBITS = 15                      # fraction fixed-point bits
_FSCALE = float(1 << _FBITS)
_CBITS = 14                      # clamped occupancy bits in the rank key
_PBITS = 17                      # position bits in the rank key
SENTINEL = (1 << 31) - 1         # int32 max: invalid entries sort last
_CENTROID_SMEM = 200 * 1024      # the centroid slots' level sums in shared memory


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so consecutive bits land 3 apart
    (Morton interleave component). int64: every mask is below 2**32, so
    the bits a uint32 shift would drop are cleared by the mask."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0xFF0000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact1by2(v: torch.Tensor) -> torch.Tensor:
    """Inverse of _part1by2."""
    v = v & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    v = (v | (v >> 16)) & 0x3FF
    return v


def _f32(v: float, dev) -> torch.Tensor:
    # a fill on the device, not a copy from the host
    return torch.full((), v, dtype=torch.float32, device=dev)


def cloud_corners(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(C, 3) f32: each cloud's minimum over its valid points (inf where it
    has none), the grid's corner. Both routes take it from torch."""
    return torch.where(mask[..., None], points, float("inf")).amin(dim=-2)


# ------------------------------------------------------------------ keys --

def voxel_keys_plain(points: torch.Tensor, mask: torch.Tensor,
                     voxel_size: float):
    """``voxel_keys``' plain version: (corner (C, 3) f32, key (C, N) int32,
    payload (C, N, 2) int32)."""
    dev = points.device
    inv = _f32(1.0 / voxel_size, dev)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    minb = cloud_corners(points, mask)
    mx, my, mz = minb[..., 0:1], minb[..., 1:2], minb[..., 2:3]
    cx = torch.floor((x - mx) * inv)
    cy = torch.floor((y - my) * inv)
    cz = torch.floor((z - mz) * inv)
    in_grid = (mask & (cx >= 0) & (cx < _GRID) & (cy >= 0) & (cy < _GRID)
               & (cz >= 0) & (cz < _GRID))
    zero = _f32(0.0, dev)
    cx = torch.where(in_grid, cx, zero)
    cy = torch.where(in_grid, cy, zero)
    cz = torch.where(in_grid, cz, zero)
    key = (_part1by2(cx.to(torch.int64))
           + (_part1by2(cy.to(torch.int64)) << 1)
           + (_part1by2(cz.to(torch.int64)) << 2))
    key = torch.where(in_grid, key, SENTINEL)

    fx = torch.where(in_grid, (x - mx) * inv - cx, zero)
    fy = torch.where(in_grid, (y - my) * inv - cy, zero)
    fz = torch.where(in_grid, (z - mz) * inv - cz, zero)
    fmax = float((1 << _FBITS) - 1)
    qx = torch.clamp(fx * _FSCALE, 0.0, fmax).to(torch.int64)
    qy = torch.clamp(fy * _FSCALE, 0.0, fmax).to(torch.int64)
    qz = torch.clamp(fz * _FSCALE, 0.0, fmax).to(torch.int64)
    payload = torch.stack([(qx << _FBITS) + qy, qz], -1)
    return minb, key.to(torch.int32), payload.to(torch.int32)


def voxel_keys(points: torch.Tensor, mask: torch.Tensor, voxel_size: float):
    """Per point of (C, N, 3) f32 points under a (C, N) bool mask, both
    contiguous: (corner (C, 3) f32, the minimum over each cloud's valid
    points; key (C, N) int32, the Morton key of the point's cell, or
    ``SENTINEL`` where the point is masked or outside the 1024-cell grid;
    payload (C, N, 2) int32, ((qx << 15) + qy, qz), the fractions inside
    the cell quantised to 15 bits, 0 where the key is the sentinel). For
    CUDA tensors torch's corner and one launch of csrc/voxel.cu's keys
    kernel, bit for bit ``voxel_keys_plain``, which runs for CPU
    tensors."""
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points: expected (C, N, 3), got "
                         f"{tuple(points.shape)}")
    clouds, n = points.shape[:2]
    check("points", points, (clouds, n, 3))
    check("mask", mask, (clouds, n), torch.bool)
    if same_device(points, mask).type != "cuda":
        return voxel_keys_plain(points, mask, voxel_size)
    dev = points.device
    minb = cloud_corners(points, mask)
    key = torch.empty((clouds, n), dtype=torch.int32, device=dev)
    payload = torch.empty((clouds, n, 2), dtype=torch.int32, device=dev)
    if points.numel() == 0:
        return minb, key, payload
    launch("voxel", points, mask, minb, clouds, n,
           fused.f32(1.0 / voxel_size), key, payload)
    LAUNCHES["voxel_keys"] += 1
    return minb, key, payload


# ------------------------------------------------------------- selection --

def run_lengths_plain(key_s: torch.Tensor):
    """(is_new, run_len) of sorted keys (C, n), as the JAX package counts
    them: a run starts at each valid position whose key differs from the
    previous one and lasts to the next start, or to n (the last run takes
    the sentinels after it); run_len is 0 off the starts. int64."""
    n = key_s.shape[-1]
    key_s = key_s.to(torch.int64)
    dev = key_s.device
    pos = torch.arange(n, device=dev)
    true1 = torch.ones(key_s.shape[:-1] + (1,), dtype=torch.bool, device=dev)
    is_new = torch.cat([true1, key_s[..., 1:] != key_s[..., :-1]],
                       -1) & (key_s != SENTINEL)
    start_pos = torch.where(is_new, pos, n)
    run_end = torch.where(torch.cat([is_new[..., 1:], true1], -1), pos + 1, n)
    next_start = torch.flip(
        torch.cummin(torch.flip(run_end, [-1]), -1).values, [-1])
    return is_new, torch.where(is_new, next_start - start_pos, 0)


def rank_keys_plain(is_new: torch.Tensor, run_len: torch.Tensor):
    """The JAX package's packed rank key of each position (int64):
    (16383 - min(run_len, 16383)) << 17 | position at a run start, the
    sentinel elsewhere. Ascending, it orders the runs by clamped count
    descending, ties toward the lower position."""
    cmax = (1 << _CBITS) - 1
    pos = torch.arange(is_new.shape[-1], device=is_new.device)
    return torch.where(
        is_new, ((cmax - torch.clamp(run_len, max=cmax)) << _PBITS) + pos,
        SENTINEL)


def voxel_select_plain(key_s: torch.Tensor, n: int, capacity: int):
    """``voxel_select``'s plain version: the run lengths, then the top k by
    one sort of the rank keys and the chosen positions back in order by a
    second."""
    key_s = key_s[..., :n].to(torch.int64)
    is_new, run_len = run_lengths_plain(key_s)
    k = min(capacity, n)
    rank_s = torch.sort(rank_keys_plain(is_new, run_len),
                        dim=-1).values[..., :k]
    # back to position (= Morton key) order: spatially ordered output
    sel_pos = torch.where(rank_s != SENTINEL,
                          rank_s & ((1 << _PBITS) - 1), n)
    sel_pos = torch.sort(sel_pos, dim=-1).values
    got = sel_pos < n
    starts_top = torch.where(got, sel_pos, 0)
    counts_top = torch.where(got, run_len.gather(-1, starts_top), 0)
    key_top = key_s.gather(-1, torch.clamp(starts_top, max=n - 1))
    pad = capacity - k
    if pad:
        starts_top = torch.nn.functional.pad(starts_top, (0, pad))
        counts_top = torch.nn.functional.pad(counts_top, (0, pad))
        key_top = torch.cat([key_top, key_s[..., :1].expand(
            *key_s.shape[:-1], pad)], -1)
    return (starts_top.to(torch.int32), counts_top.to(torch.int32),
            key_top.to(torch.int32))


def voxel_select(key_s: torch.Tensor, n: int, capacity: int):
    """The occupancy cut of (C, N) int32 keys sorted along each row
    (contiguous), on their first ``n`` (the active prefix): (starts_top,
    counts_top, key_top) (C, capacity) int32, the first position, the
    length (unclamped) and the key of each chosen run. The runs chosen are
    the top min(capacity, n) by length clamped to 16383, descending, ties
    toward the lower position; slots in position order, then 0, 0 and the
    row's first key where no run is left. For CUDA tensors one launch of
    csrc/voxel.cu's selection kernel (a block a cloud), bit for bit
    ``voxel_select_plain``, which runs for CPU tensors."""
    if key_s.dim() != 2:
        raise ValueError(f"key_s: expected (C, N), got {tuple(key_s.shape)}")
    clouds, stride = key_s.shape
    check("key_s", key_s, (clouds, stride), torch.int32)
    if not 0 < n <= stride:
        raise ValueError(f"active prefix {n} outside 1..{stride}")
    if capacity < 1:
        raise ValueError(f"capacity must be positive, got {capacity}")
    if key_s.device.type != "cuda":
        return voxel_select_plain(key_s, n, capacity)
    dev = key_s.device
    starts_top, counts_top, key_top = (
        torch.empty((clouds, capacity), dtype=torch.int32, device=dev)
        for _ in range(3))
    if clouds == 0:
        return starts_top, counts_top, key_top
    run_start = torch.empty((clouds, n + 1), dtype=torch.int32, device=dev)
    launch("voxel_select", key_s, clouds, stride, n, capacity, run_start,
           starts_top, counts_top, key_top)
    LAUNCHES["voxel_select"] += 1
    return starts_top, counts_top, key_top


# ------------------------------------------------------------- centroids --

def sorted_fractions(key_s: torch.Tensor, order: torch.Tensor,
                     payload: torch.Tensor, n: int) -> torch.Tensor:
    """(C, 3, n) f32: the fractions of the first n sorted points, (q +
    0.5) / 2^15 from the payload gathered through the sort's order, 0
    where the key is the sentinel."""
    order = order[..., :n]
    pf_xy = payload[..., 0].gather(-1, order).to(torch.int64)
    qz = payload[..., 1].gather(-1, order).to(torch.int64)
    vf = (key_s[..., :n] != SENTINEL).to(torch.float32)
    inv_fscale = _f32(1.0 / _FSCALE, key_s.device)
    fmask = (1 << _FBITS) - 1
    fx = ((pf_xy >> _FBITS).to(torch.float32) + 0.5) * inv_fscale * vf
    fy = ((pf_xy & fmask).to(torch.float32) + 0.5) * inv_fscale * vf
    fz = (qz.to(torch.float32) + 0.5) * inv_fscale * vf
    return torch.stack([fx, fy, fz], -2)


def voxel_centroids_plain(key_s, order, payload, minb, starts_top,
                          counts_top, key_top, n: int, voxel_size: float):
    """``voxel_centroids``' plain version: the fractions' blocked prefix
    at each slot's two run boundaries (``utils.scan.prefix_at``), then the
    centroid arithmetic."""
    dev = key_s.device
    frac = sorted_fractions(key_s, order, payload, n)
    starts = starts_top.to(torch.int64)
    counts = counts_top.to(torch.int64)
    ends = starts + counts                               # exclusive end

    def at(idx):
        return prefix_at(frac, idx[..., None, :].expand(
            *idx.shape[:-1], 3, idx.shape[-1]))

    zero = _f32(0.0, dev)
    hi3 = at(torch.clamp(ends - 1, 0, n - 1))
    lo3 = torch.where(starts[..., None, :] > 0,
                      at(torch.clamp(starts - 1, min=0)), zero)
    sums3 = hi3 - lo3

    out_mask = counts > 0
    cnt = torch.clamp(counts, min=1).to(torch.float32)
    kk = key_top.to(torch.int64)
    kx = _compact1by2(kk).to(torch.float32)
    ky = _compact1by2(kk >> 1).to(torch.float32)
    kz = _compact1by2(kk >> 2).to(torch.float32)
    leaf = _f32(voxel_size, dev)
    mx, my, mz = minb[..., 0:1], minb[..., 1:2], minb[..., 2:3]
    ox = mx + (kx + sums3[..., 0, :] / cnt) * leaf
    oy = my + (ky + sums3[..., 1, :] / cnt) * leaf
    oz = mz + (kz + sums3[..., 2, :] / cnt) * leaf
    out = torch.stack([ox, oy, oz], dim=-1)
    return torch.where(out_mask[..., None], out, zero), out_mask


def level_words(n: int) -> int:
    """The prefix's level words of one (cloud, axis): the block totals of
    each level, ceil(n / 16) + ceil(n / 256) + ..., down to a level of at
    most 16."""
    words, m = 0, -(-n // BLOCK)
    while True:
        words += m
        if m <= BLOCK:
            return words
        m = -(-m // BLOCK)


def voxel_centroids(key_s, order, payload, minb, starts_top, counts_top,
                    key_top, n: int, voxel_size: float):
    """The centroids of the chosen runs: (out (C, capacity, 3) f32, minb +
    (cell + mean fraction) * voxel_size, 0 where the slot is empty;
    out_mask (C, capacity) bool, count > 0), from the sorted keys (C, N)
    int32 and the sort's order (C, N) int64, the payload (C, N, 2) int32
    and corner (C, 3) f32 of ``voxel_keys``, the (C, capacity) int32
    outputs of ``voxel_select`` and the active prefix ``n``; all
    contiguous. Each run's fraction sum is the difference of the
    prefix sum (in ``utils.scan.prefix_sum``'s order) at its two
    boundaries, so ``starts_top`` and ``counts_top`` must be runs of the
    sorted keys, as ``voxel_select`` gives them. For CUDA tensors
    csrc/voxel.cu's levels and centroid kernels (one call; no state kept
    between calls), bit for bit ``voxel_centroids_plain``, which runs for
    CPU tensors; an active prefix past about 4.1 million points (level
    sums past 200 KB of shared memory) raises ValueError."""
    if key_s.dim() != 2:
        raise ValueError(f"key_s: expected (C, N), got {tuple(key_s.shape)}")
    clouds, stride = key_s.shape
    capacity = starts_top.shape[-1]
    check("key_s", key_s, (clouds, stride), torch.int32)
    check("order", order, (clouds, stride), torch.int64)
    check("payload", payload, (clouds, stride, 2), torch.int32)
    check("minb", minb, (clouds, 3))
    for name, t in (("starts_top", starts_top), ("counts_top", counts_top),
                    ("key_top", key_top)):
        check(name, t, (clouds, capacity), torch.int32)
    if not 0 < n <= stride:
        raise ValueError(f"active prefix {n} outside 1..{stride}")
    dev = same_device(key_s, order, payload, minb, starts_top, counts_top,
                      key_top)
    if dev.type != "cuda":
        return voxel_centroids_plain(key_s, order, payload, minb, starts_top,
                                     counts_top, key_top, n, voxel_size)
    out = torch.empty((clouds, capacity, 3), dtype=torch.float32, device=dev)
    out_mask = torch.empty((clouds, capacity), dtype=torch.bool, device=dev)
    if clouds == 0:
        return out, out_mask
    m1 = -(-n // BLOCK)
    m2 = -(-m1 // BLOCK)
    words2 = m2 + (level_words(m2) if m2 > BLOCK else 0)
    if 3 * words2 * 4 > _CENTROID_SMEM:
        raise ValueError(f"voxel_centroids: an active prefix of {n} points "
                         f"takes {3 * words2 * 4} bytes of level sums, past "
                         f"the slots kernel's {_CENTROID_SMEM}")
    w0 = torch.empty((clouds, n, 4), dtype=torch.float32, device=dev)
    w1 = torch.empty((clouds, m1, 4), dtype=torch.float32, device=dev)
    l2 = torch.empty((clouds, 3, m2), dtype=torch.float32, device=dev)
    launch("voxel_centroids", key_s, order, payload, minb, starts_top,
           counts_top, key_top, clouds, stride, n, capacity, words2,
           fused.f32(voxel_size), w0, w1, l2, out, out_mask)
    LAUNCHES["voxel_centroids"] += 1
    return out, out_mask


# ------------------------------------------------------------------ grid --

def voxel_downsample(points: torch.Tensor, mask: torch.Tensor,
                     voxel_size: float, capacity: int,
                     active_cap: int | None = None):
    """Centroid-per-voxel downsampling of one cloud or of a batch of
    clouds in one call (the JAX package's ``vmap``).

    points: (..., N, 3) f32; mask: (..., N) bool. Returns (out_points
    (..., capacity, 3), out_mask (..., capacity)). Every step works along
    a cloud's own row (the corner, the sort, the runs, the prefix), so
    each cloud of a batch gets the bits of its own call. On the card the
    three kernels (``voxel_keys``, ``voxel_select``, ``voxel_centroids``)
    and one ``torch.sort``; on the CPU their plain versions.

    Overflow policy: when more than `capacity` voxels are occupied, the
    voxels with the MOST points win (ties toward lower Morton key).
    active_cap: static bound on the number of VALID input points per
    cloud; post-sort work runs on that prefix only (excess valid points,
    the highest Morton keys, are dropped — as in the JAX package).
    """
    n = points.shape[-2]
    if n > (1 << _PBITS):
        raise ValueError(f"rank-key packing supports up to {1 << _PBITS} "
                         f"points, got {n}")
    lead = points.shape[:-2]
    pts = points.reshape(-1, n, 3).contiguous()
    msk = mask.reshape(-1, n).contiguous()
    minb, key, payload = voxel_keys(pts, msk, voxel_size)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    if active_cap is not None and active_cap < n:
        n = active_cap
    starts, counts, keys_top = voxel_select(key_s, n, capacity)
    out, out_mask = voxel_centroids(key_s, order, payload, minb, starts,
                                    counts, keys_top, n, voxel_size)
    return (out.reshape(*lead, capacity, 3),
            out_mask.reshape(*lead, capacity))
