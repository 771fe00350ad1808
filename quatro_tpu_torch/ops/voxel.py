"""Voxel-grid downsampling (centroid per occupied voxel).

PyTorch counterpart of ``quatro_tpu/ops/voxel.py`` (the reference wraps
``pcl::VoxelGrid``, include/quatro.hpp:49-68). Same algorithm and the same
slot order, so every later stage can be compared index by index:

  1. one stable sort over a 30-bit Morton voxel key carrying the
     corner-relative fractional coordinates packed as 15-bit fixed point;
  2. run-length bookkeeping (per-voxel counts, run starts) by compare /
     reverse cummin;
  3. per-voxel centroid sums by prefix-sum differences at run
     boundaries, with the prefix sum taken in the JAX package's own
     addition order (``utils.scan.prefix_sum``);
  4. occupancy ranking by one sort of a packed
     (clamped-count-descending << 17 | position) key;
  5. a re-sort of the selected voxels back to Morton order.

Keys are int64 (torch's uint32 support is thin); the masks and shifts
keep the JAX package's bit widths, so the orderings are the same.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.utils.scan import prefix_sum

# Cells per axis: 10 bits each, packed into one non-negative key.
_BITS = 10
_GRID = 1 << _BITS
_FBITS = 15                      # fraction fixed-point bits
_FSCALE = float(1 << _FBITS)
_CBITS = 14                      # clamped occupancy bits in the rank key
_PBITS = 17                      # position bits in the rank key
_SENTINEL = (1 << 31) - 1        # int32 max: invalid entries sort last


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


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor,
                     voxel_size: float, capacity: int,
                     active_cap: int | None = None):
    """Centroid-per-voxel downsampling of one cloud or of a batch of
    clouds in one call (the JAX package's ``vmap``).

    points: (..., N, 3) f32; mask: (..., N) bool. Returns (out_points
    (..., capacity, 3), out_mask (..., capacity)). Every operation works
    along a cloud's own row (sorts, gathers, scans, the bounding box), so
    each cloud of a batch gets the bits of its own call.

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
    dev = points.device
    dtype = points.dtype

    def f32(v):
        # a fill on the device, not a copy from the host
        return torch.full((), v, dtype=dtype, device=dev)

    inv = f32(1.0 / voxel_size)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    minb = torch.where(mask[..., None], points,
                       f32(float("inf"))).amin(dim=-2)       # (..., 3)
    mx, my, mz = minb[..., 0:1], minb[..., 1:2], minb[..., 2:3]
    cx = torch.floor((x - mx) * inv)
    cy = torch.floor((y - my) * inv)
    cz = torch.floor((z - mz) * inv)
    in_grid = (mask & (cx >= 0) & (cx < _GRID) & (cy >= 0) & (cy < _GRID)
               & (cz >= 0) & (cz < _GRID))
    zero = f32(0.0)
    cx = torch.where(in_grid, cx, zero)
    cy = torch.where(in_grid, cy, zero)
    cz = torch.where(in_grid, cz, zero)
    key = (_part1by2(cx.to(torch.int64))
           + (_part1by2(cy.to(torch.int64)) << 1)
           + (_part1by2(cz.to(torch.int64)) << 2))
    key = torch.where(in_grid, key, _SENTINEL)

    fx = torch.where(in_grid, (x - mx) * inv - cx, zero)
    fy = torch.where(in_grid, (y - my) * inv - cy, zero)
    fz = torch.where(in_grid, (z - mz) * inv - cz, zero)
    fmax = float((1 << _FBITS) - 1)
    qx = torch.clamp(fx * _FSCALE, 0.0, fmax).to(torch.int64)
    qy = torch.clamp(fy * _FSCALE, 0.0, fmax).to(torch.int64)
    qz = torch.clamp(fz * _FSCALE, 0.0, fmax).to(torch.int64)
    pf_xy = (qx << _FBITS) + qy

    key_s, order = torch.sort(key, dim=-1, stable=True)
    pfxy_s = pf_xy.gather(-1, order)
    qz_s = qz.gather(-1, order)
    if active_cap is not None and active_cap < n:
        key_s = key_s[..., :active_cap]
        pfxy_s = pfxy_s[..., :active_cap]
        qz_s = qz_s[..., :active_cap]
        n = active_cap
    valid_b = key_s != _SENTINEL
    inv_fscale = f32(1.0 / _FSCALE)
    fmask = (1 << _FBITS) - 1
    vf = valid_b.to(dtype)
    fx_s = ((pfxy_s >> _FBITS).to(dtype) + 0.5) * inv_fscale * vf
    fy_s = ((pfxy_s & fmask).to(dtype) + 0.5) * inv_fscale * vf
    fz_s = (qz_s.to(dtype) + 0.5) * inv_fscale * vf

    pos = torch.arange(n, device=dev)
    true1 = torch.ones(key_s.shape[:-1] + (1,), dtype=torch.bool, device=dev)
    is_new = torch.cat([true1, key_s[..., 1:] != key_s[..., :-1]],
                       -1) & valid_b
    start_pos = torch.where(is_new, pos, n)
    run_end = torch.where(torch.cat([is_new[..., 1:], true1], -1), pos + 1, n)
    next_start = torch.flip(
        torch.cummin(torch.flip(run_end, [-1]), -1).values, [-1])
    run_len = torch.where(is_new, next_start - start_pos, 0)

    # top-`capacity` voxels by occupancy via one packed sort: ascending
    # (clamped-count complement << 17 | position) == count descending,
    # ties toward lower position.
    k = min(capacity, n)
    cmax = (1 << _CBITS) - 1
    rank_key = torch.where(
        is_new, ((cmax - torch.clamp(run_len, max=cmax)) << _PBITS) + pos,
        _SENTINEL)
    rank_s = torch.sort(rank_key, dim=-1).values[..., :k]
    # back to position (= Morton key) order: spatially ordered output
    sel_pos = torch.where(rank_s != _SENTINEL,
                          rank_s & ((1 << _PBITS) - 1), n)
    sel_pos = torch.sort(sel_pos, dim=-1).values
    got = sel_pos < n
    starts_top = torch.where(got, sel_pos, 0)
    counts_top = torch.where(got, run_len.gather(-1, starts_top), 0)

    cs3 = prefix_sum(torch.stack([fx_s, fy_s, fz_s], -2))     # (..., 3, n)

    def at(idx):
        return cs3.gather(-1, idx[..., None, :].expand(
            *idx.shape[:-1], 3, idx.shape[-1]))

    ends = starts_top + counts_top                       # exclusive end
    hi3 = at(torch.clamp(ends - 1, 0, n - 1))
    lo3 = torch.where(starts_top[..., None, :] > 0,
                      at(torch.clamp(starts_top - 1, min=0)), zero)
    sums3 = hi3 - lo3

    out_mask = counts_top > 0
    cnt = torch.clamp(counts_top, min=1).to(dtype)
    kk = key_s.gather(-1, torch.clamp(starts_top, max=n - 1))
    kx = _compact1by2(kk).to(dtype)
    ky = _compact1by2(kk >> 1).to(dtype)
    kz = _compact1by2(kk >> 2).to(dtype)
    leaf = f32(voxel_size)
    ox = mx + (kx + sums3[..., 0, :] / cnt) * leaf
    oy = my + (ky + sums3[..., 1, :] / cnt) * leaf
    oz = mz + (kz + sums3[..., 2, :] / cnt) * leaf

    out = torch.stack([ox, oy, oz], dim=-1)
    out = torch.where(out_mask[..., None], out, zero)
    if k < capacity:
        pad = capacity - k
        out = torch.nn.functional.pad(out, (0, 0, 0, pad))
        out_mask = torch.nn.functional.pad(out_mask, (0, pad))
    return out, out_mask
