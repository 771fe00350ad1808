"""The front end's five kernels: moment sums, SPFH, FPFH, 1-NN and top-2
NN.

Counterpart of ``quatro_tpu/ops/pallas_frontend.py``. Each kernel has

* a wrapper (``moment_sums``, ``spfh``, ``fpfh_sums``,
  ``nearest_neighbors``, ``nearest_neighbors2``) that checks its inputs,
  allocates the outputs
  and, for CUDA tensors, launches the hand-written kernel from
  ``quatro_tpu_torch/csrc`` on the current stream and adds one to its
  count in ``LAUNCHES``. For CPU tensors it runs the plain version; there
  is no fallback between the two;
* a plain PyTorch version (``*_plain``) of the same function with the
  same decisions (radius tests, bins, chunked tie rule), used by the CPU
  tests and by the comparisons on the card.

Every kernel takes a leading batch axis: the pipeline runs the source and
target clouds as one batch of two, as the JAX package stacks them.
"""

from __future__ import annotations

import math

import torch

from quatro_tpu_torch.ops.fpfh import (FPFH_DIM, NUM_BINS, _bin_index,
                                      darboux_features, normalize_blocks)
from quatro_tpu_torch.ops.launch import (LAUNCHES, active_limit,  # noqa: F401
                                         check, launch, reset_launches,
                                         same_device, stream_scratch)
from quatro_tpu_torch.ops.normals import Normals, moment_normals

FLT_MAX = torch.finfo(torch.float32).max
NN_CHUNK = 2048          # column chunk of the top-2 tie rule
NN1_ROWS = 64            # A rows per work item of B6's kernel
NN1_SPLIT = 256          # B columns per work item of B6's kernel
PAIR_TILE = 32           # points per AABB tile of the radius-pair kernels
_ROW_TILE = 512          # rows per step of the plain versions (memory)


def _r2(radius: float, like: torch.Tensor) -> torch.Tensor:
    """radius^2 rounded to f32 once, as the kernels receive it."""
    return torch.tensor(radius * radius, dtype=torch.float32,
                        device=like.device)


def _pair_geometry(pr: torch.Tensor, pc: torch.Tensor):
    """(T, C) offsets dx = x_i - x_j and d2 = (dx*dx + dy*dy) + dz*dz."""
    dx = pr[:, 0:1] - pc[None, :, 0]
    dy = pr[:, 1:2] - pc[None, :, 1]
    dz = pr[:, 2:3] - pc[None, :, 2]
    return (dx, dy, dz), dx * dx + dy * dy + dz * dz


# ----------------------------------------------------------------- B3 ----

def tile_bounds(points: torch.Tensor, maskf: torch.Tensor) -> torch.Tensor:
    """(B, ceil(V / PAIR_TILE), 8) per-tile AABBs of the valid points
    (maskf > 0): [min x, y, z, 0, max x, y, z, 0]; an empty tile gets
    [+inf, -inf]. NaN coordinates are left out per coordinate, as fminf /
    fmaxf leave them. The radius-pair kernels' pre-pass (csrc/tiles.cuh)
    writes the same table: min and max are exact, so any order gives
    these bits. Replaces pallas_frontend.py::_tile_bounds."""
    bsz, v = points.shape[:2]
    tiles = -(-v // PAIR_TILE)
    pad = tiles * PAIR_TILE - v
    ok = (maskf > 0)[..., None] & ~torch.isnan(points)
    lo = torch.where(ok, points, math.inf)
    hi = torch.where(ok, points, -math.inf)
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=math.inf)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-math.inf)
    lo = lo.reshape(bsz, tiles, PAIR_TILE, 3).amin(2)
    hi = hi.reshape(bsz, tiles, PAIR_TILE, 3).amax(2)
    zero = lo.new_zeros((bsz, tiles, 1))
    return torch.cat([lo, zero, hi, zero], -1)


def tiles_in_radius(row_bounds: torch.Tensor, col_bounds: torch.Tensor,
                    radius: float) -> torch.Tensor:
    """(B, R, C) bool: False only where no pair of the two tiles lies
    within ``radius``. The gap per dimension is max(0, lo_r - hi_c, lo_c -
    hi_r), summed in squares as ``_pair_geometry`` sums d2, so that gap2
    <= d2 of every valid pair of the two tiles (the argument in
    csrc/tiles.cuh) and a skip is exact. Replaces
    pallas_frontend.py::_bbox_in_radius."""
    rb, cb = row_bounds[:, :, None], col_bounds[:, None, :]
    g = [torch.fmax(torch.fmax(rb[..., d] - cb[..., 4 + d],
                               cb[..., d] - rb[..., 4 + d]),
                    torch.zeros((), dtype=rb.dtype)) for d in range(3)]
    return g[0] * g[0] + g[1] * g[1] + g[2] * g[2] <= _r2(radius, rb)


def _in_radius_columns(ok: torch.Tensor):
    """(T, kmax) int64 columns of each row's True entries of ``ok`` in
    ascending order (slot k holds the k-th) and their (T, kmax) liveness;
    dead slots hold column V - 1."""
    v = ok.shape[1]
    kmax = int(ok.sum(1).max()) if ok.numel() else 0
    # the other columns go to a dump slot, dropped
    slot = torch.where(ok, ok.cumsum(1) - 1, kmax)
    cols = torch.full((ok.shape[0], kmax + 1), v, dtype=torch.int64,
                      device=ok.device)
    cols.scatter_(1, slot, torch.arange(v, device=ok.device).expand(
        ok.shape[0], v))
    cols = cols[:, :kmax]
    return cols.clamp(max=v - 1), cols < v


def moment_sums_plain(points: torch.Tensor, maskf: torch.Tensor,
                      radius: float) -> torch.Tensor:
    """(B, V, 10): [count, s_dx, s_dy, s_dz, s_dxdx, s_dxdy, s_dxdz,
    s_dydy, s_dydz, s_dzdz] over valid in-radius pairs, self included,
    dx = x_i - x_j. Masked rows are zero. Each row adds its terms in
    ascending column order from 0, every product and sum rounded once, as
    the kernel adds them (slot k of a row holds its k-th in-radius
    column, and the slots are added one after the other): a row sum of
    torch's would take the order of its vectorised tree."""
    r2 = _r2(radius, points)
    out = points.new_zeros((*points.shape[:2], 10))
    for b in range(points.shape[0]):
        p, m = points[b], maskf[b] > 0
        for s in range(0, p.shape[0], _ROW_TILE):
            pr = p[s:s + _ROW_TILE]
            _, d2 = _pair_geometry(pr, p)
            cols, live = _in_radius_columns(
                (d2 <= r2) & m[None, :] & m[s:s + _ROW_TILE, None])
            if cols.shape[1] == 0:
                continue
            dx, dy, dz = (pr[:, k:k + 1] - p[cols, k] for k in range(3))
            terms = torch.stack([torch.ones_like(dx), dx, dy, dz, dx * dx,
                                 dx * dy, dx * dz, dy * dy, dy * dz,
                                 dz * dz], -1)
            terms = torch.where(live[..., None], terms, 0.0)
            acc = out[b, s:s + _ROW_TILE]
            for k in range(cols.shape[1]):
                acc = acc + terms[:, k]
            out[b, s:s + _ROW_TILE] = acc
    return out


def moment_sums(points: torch.Tensor, maskf: torch.Tensor,
                radius: float) -> torch.Tensor:
    """Ten centred neighbourhood moment sums per point, (B, V, 10) f32.
    points (B, V, 3) f32, maskf (B, V) f32 0/1. Replaces
    pallas_frontend.py::moment_sums_pallas (csrc/moment_sums.cu), which
    skips the points past ``active_limit`` and the tile pairs
    ``tiles_in_radius`` rejects, and equals the plain version bit for
    bit."""
    bsz, v = points.shape[:2]
    check("points", points, (bsz, v, 3))
    check("maskf", maskf, (bsz, v))
    if same_device(points, maskf).type != "cuda":
        return moment_sums_plain(points, maskf, radius)
    return moment_sums_launch(points, maskf, radius)[0]


def moment_sums_launch(points: torch.Tensor, maskf: torch.Tensor,
                       radius: float):
    """The kernel's launch on CUDA tensors checked by ``moment_sums``:
    (out, bounds, lim), the last two the pre-pass's scratch, equal to
    ``tile_bounds`` and ``active_limit`` (for the checks on the card)."""
    bsz, v = points.shape[:2]
    dev = points.device
    out = torch.empty((bsz, v, 10), dtype=torch.float32, device=dev)
    bounds = torch.empty((bsz, -(-v // PAIR_TILE), 8), dtype=torch.float32,
                         device=dev)
    lim = torch.empty((bsz,), dtype=torch.int32, device=dev)
    launch("moment_sums", points, maskf, bsz, v, float(radius * radius),
           bounds, lim, out)
    LAUNCHES["moment_sums"] += 1
    return out, bounds, lim


def frontend_normals(points: torch.Tensor, mask: torch.Tensor,
                     radius: float) -> Normals:
    """PCA normals over true radius neighbourhoods from the moment kernel;
    points (B, V, 3), mask (B, V) bool. On the card two launches: B3 and
    the normals' kernel (``ops/normals.moment_normals``)."""
    mom = moment_sums(points, mask.to(points.dtype).contiguous(), radius)
    return moment_normals(points, mask, mom)


# ----------------------------------------------------------------- B4 ----

def darboux_bins(d, d2, n_i, n_j, use_rsqrt: bool):
    """Darboux features of pairs binned (``ops/fpfh.darboux_features``):
    d = p_j - p_i components, d2 = |d|^2, n_i / n_j normal components.
    Returns (b1, b2, b3) int32 bins and the frame-valid mask
    (v_norm2 > 1e-20). use_rsqrt: the kernel form (rsqrt, products) of
    pallas_frontend.py:_spfh_body; else the dense form (sqrt, quotients)
    of dense_features.py."""
    f1, f2, f3, frame_ok = darboux_features(d, d2, n_i, n_j, use_rsqrt)
    return (_bin_index(f1, -math.pi, math.pi), _bin_index(f2, -1.0, 1.0),
            _bin_index(f3, -1.0, 1.0), frame_ok)


def _bin_counts(bins, af):
    """11 column sums of af per bin value: (T, 11)."""
    return torch.stack([torch.where(bins == k, af, 0.0).sum(1)
                        for k in range(NUM_BINS)], -1)


def spfh_plain(points: torch.Tensor, normals: torch.Tensor,
               pair_maskf: torch.Tensor, radius: float,
               use_rsqrt: bool = True):
    """Raw SPFH bin counts (B, V, 33) and pair counts (B, V) over valid
    pairs with 1e-12 < d2 <= r^2 and a non-degenerate Darboux frame.
    use_rsqrt=False gives the dense path's arithmetic (darboux_bins)."""
    r2 = _r2(radius, points)
    bsz, v = points.shape[:2]
    hist = points.new_zeros((bsz, v, FPFH_DIM))
    cnt = points.new_zeros((bsz, v))
    for b in range(bsz):
        p, nrm, m = points[b], normals[b], pair_maskf[b] > 0
        n_j = tuple(nrm[None, :, k] for k in range(3))
        for s in range(0, v, _ROW_TILE):
            e = min(s + _ROW_TILE, v)
            (dx, dy, dz), d2 = _pair_geometry(p[s:e], p)
            ok = (m[s:e, None] & m[None, :] & (d2 <= r2) & (d2 > 1e-12))
            n_i = tuple(nrm[s:e, k:k + 1] for k in range(3))
            b1, b2, b3, frame_ok = darboux_bins((-dx, -dy, -dz), d2, n_i,
                                                n_j, use_rsqrt)
            af = (ok & frame_ok).to(p.dtype)
            hist[b, s:e] = torch.cat([_bin_counts(b1, af),
                                      _bin_counts(b2, af),
                                      _bin_counts(b3, af)], -1)
            cnt[b, s:e] = af.sum(1)
    return hist, cnt


def _check_spfh(points, normals, pair_maskf) -> torch.device:
    bsz, v = points.shape[:2]
    check("points", points, (bsz, v, 3))
    check("normals", normals, (bsz, v, 3))
    check("pair_maskf", pair_maskf, (bsz, v))
    return same_device(points, normals, pair_maskf)


def spfh(points: torch.Tensor, normals: torch.Tensor,
         pair_maskf: torch.Tensor, radius: float):
    """Raw SPFH bin counts (B, V, 33) f32 and pair counts (B, V) f32.
    Replaces pallas_frontend.py::spfh_pallas (csrc/spfh.cu), which skips
    the points past ``active_limit`` and the tile pairs
    ``tiles_in_radius`` rejects, and takes the bins of the plain version
    run on the card."""
    if _check_spfh(points, normals, pair_maskf).type != "cuda":
        return spfh_plain(points, normals, pair_maskf, radius)
    return spfh_launch(points, normals, pair_maskf, radius)[:2]


def spfh_launch(points: torch.Tensor, normals: torch.Tensor,
                pair_maskf: torch.Tensor, radius: float):
    """The kernel's launch on CUDA tensors checked by ``spfh``: (hist,
    cnt, bounds, lim), the last two the pre-pass's tile AABBs and active
    limits of the pair mask, which ``fpfh_sums_launch`` can take."""
    bsz, v = points.shape[:2]
    dev = points.device
    hist = torch.empty((bsz, v, FPFH_DIM), dtype=torch.float32, device=dev)
    cnt = torch.empty((bsz, v), dtype=torch.float32, device=dev)
    bounds = torch.empty((bsz, -(-v // PAIR_TILE), 8), dtype=torch.float32,
                         device=dev)
    lim = torch.empty((bsz,), dtype=torch.int32, device=dev)
    launch("spfh", points, normals, pair_maskf, bsz, v,
           float(radius * radius), bounds, lim, hist, cnt)
    LAUNCHES["spfh"] += 1
    return hist, cnt, bounds, lim


# ----------------------------------------------------------------- B5 ----

def fpfh_sums_plain(points: torch.Tensor, spfh_rows: torch.Tensor,
                    pair_maskf: torch.Tensor, radius: float) -> torch.Tensor:
    """(B, V, 33): sum_j SPFH_j / max(d2_ij, 1e-12) over valid pairs with
    1e-12 < d2 <= r^2, each row's terms added in column order from 0 as
    the kernel adds them, the weight, each product and each sum rounded
    once: slot k of a row holds its k-th in-radius column, and the slots
    are added one after the other. A matrix product would sum in the
    library's order, which follows the thread count."""
    r2 = _r2(radius, points)
    out = torch.zeros_like(spfh_rows)
    v = points.shape[1]
    for b in range(points.shape[0]):
        p, m = points[b], pair_maskf[b] > 0
        for s in range(0, v, _ROW_TILE):
            _, d2 = _pair_geometry(p[s:s + _ROW_TILE], p)
            ok = (m[s:s + _ROW_TILE, None] & m[None, :] & (d2 <= r2)
                  & (d2 > 1e-12))
            cols, live = _in_radius_columns(ok)
            if cols.shape[1] == 0:
                continue
            w = torch.where(ok, 1.0 / torch.clamp(d2, min=1e-12), 0.0)
            terms = (torch.where(live, w.gather(1, cols), 0.0)[..., None]
                     * spfh_rows[b][cols])
            acc = out[b, s:s + _ROW_TILE]
            for k in range(cols.shape[1]):
                acc = acc + terms[:, k]
            out[b, s:s + _ROW_TILE] = acc
    return out


def fpfh_sums(points: torch.Tensor, spfh_rows: torch.Tensor,
              pair_maskf: torch.Tensor, radius: float) -> torch.Tensor:
    """Unnormalised FPFH weighted sums (B, V, 33) f32. Replaces the pair
    pass of pallas_frontend.py::frontend_fpfh (csrc/fpfh.cu), which skips
    the points past ``active_limit`` and the tile pairs
    ``tiles_in_radius`` rejects, and equals the plain version bit for
    bit."""
    bsz, v = points.shape[:2]
    check("points", points, (bsz, v, 3))
    check("spfh_rows", spfh_rows, (bsz, v, FPFH_DIM))
    check("pair_maskf", pair_maskf, (bsz, v))
    if same_device(points, spfh_rows, pair_maskf).type != "cuda":
        return fpfh_sums_plain(points, spfh_rows, pair_maskf, radius)
    return fpfh_sums_launch(points, spfh_rows, pair_maskf, radius)


def fpfh_sums_launch(points: torch.Tensor, spfh_rows: torch.Tensor,
                     pair_maskf: torch.Tensor, radius: float, tiles=None):
    """The kernel's launch on CUDA tensors checked by ``fpfh_sums``.
    ``tiles``: (bounds, lim) of the same points and pair mask from
    ``spfh_launch``, which spare the pre-pass; else it runs first."""
    bsz, v = points.shape[:2]
    dev = points.device
    out = torch.empty((bsz, v, FPFH_DIM), dtype=torch.float32, device=dev)
    build = tiles is None
    if build:
        tiles = (torch.empty((bsz, -(-v // PAIR_TILE), 8),
                             dtype=torch.float32, device=dev),
                 torch.empty((bsz,), dtype=torch.int32, device=dev))
    launch("fpfh", points, spfh_rows, pair_maskf, bsz, v,
           float(radius * radius), *tiles, int(build), out)
    LAUNCHES["fpfh"] += 1
    return out


def frontend_fpfh(points: torch.Tensor, normals: torch.Tensor,
                  normal_valid: torch.Tensor, mask: torch.Tensor,
                  radius: float) -> torch.Tensor:
    """(B, V, 33) FPFH descriptors: SPFH kernel, per-row x100/count
    scaling, weighted-sum kernel, then each 11-bin block normalised to
    100 (PCL conventions, as pallas_frontend.py::frontend_fpfh). On the
    card the two kernels share the SPFH kernel's tile AABBs and limits:
    one pre-pass for both."""
    pair_maskf = (mask & normal_valid).to(points.dtype).contiguous()
    normals = normals.contiguous()
    on_card = _check_spfh(points, normals, pair_maskf).type == "cuda"
    if on_card:
        raw, cnt, *tiles = spfh_launch(points, normals, pair_maskf, radius)
    else:
        raw, cnt = spfh_plain(points, normals, pair_maskf, radius)
    spfh_rows = (raw * (100.0 / torch.clamp(cnt, min=1.0))[..., None]
                 ).contiguous()
    sums = (fpfh_sums_launch(points, spfh_rows, pair_maskf, radius, tiles)
            if on_card else
            fpfh_sums_plain(points, spfh_rows, pair_maskf, radius))
    return normalize_blocks(sums)


# ------------------------------------------------------------ B7, B6 ----

def _merge_top2(run, cand):
    """Merge a chunk's (d1, i1, d2, i2) into the running pair by the
    strict-less rules of pallas_frontend.py:_nn2_kernel (earlier chunks
    win ties)."""
    rd1, ri1, rd2, ri2 = run
    cd1, ci1, cd2, ci2 = cand
    w1 = cd1 < rd1
    nd1 = torch.where(w1, cd1, rd1)
    ni1 = torch.where(w1, ci1, ri1)
    nd2 = torch.where(w1, rd1, cd1)          # the loser of the first slot
    ni2 = torch.where(w1, ri1, ci1)
    rep = rd2 < nd2
    nd2 = torch.where(rep, rd2, nd2)
    ni2 = torch.where(rep, ri2, ni2)
    rep = cd2 < nd2
    nd2 = torch.where(rep, cd2, nd2)
    ni2 = torch.where(rep, ci2, ni2)
    return nd1, ni1, nd2, ni2


def _nn_chunk(nb: int) -> int:
    """Column chunk of the tie rule: 2048 where Nb is a multiple of it (the
    Pallas kernel's case), else all of Nb in one chunk (the JAX package's
    XLA top-2, which it takes for such Nb)."""
    return NN_CHUNK if nb % NN_CHUNK == 0 else nb


def _ordered_dot(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(Na, C) dot products rows @ cols.T as the NN kernels take them:
    from 0, one round-to-nearest multiply and one add per component, in
    component order. No matrix product, ``addcmul`` or ``baddbmm``: their
    summation order follows the library's blocking and thread count, and
    may fuse a multiply into an add."""
    dot = rows.new_zeros((rows.shape[0], cols.shape[0]))
    term = torch.empty_like(dot)
    rows_t, cols_t = rows.T.contiguous(), cols.T.contiguous()
    for k in range(rows.shape[1]):
        torch.mul(rows_t[k, :, None], cols_t[k, None, :], out=term)
        dot.add_(term)
    return dot


def _chunk_d2(desc_a, desc_b, maskf_a, maskf_b, sq_a, sq_b, b, c0, chunk,
              lim):
    """(Na, C) distances of batch entry b's A rows to its B columns
    c0:c0+C, max((|a|^2 - 2 a.b) + |b|^2, 0), masked pairs f32 max, with
    the kernels' arithmetic (``_ordered_dot``): given the same sq_a and
    sq_b, bit-equal to csrc/nn1.cu and csrc/nn2.cu on any host and at any
    thread count. Only rows and columns before the active limits ``lim``
    (one past the last valid row and column, as the kernels skip) are
    computed: past them every pair is masked. Both NN plain versions take
    their distances from here, so they agree bit for bit."""
    la, lb = lim
    d2 = desc_a.new_full((desc_a.shape[1], chunk), FLT_MAX)
    ce = min(c0 + chunk, lb)
    if la > 0 and ce > c0:
        part = torch.clamp(sq_a[b, :la, None]
                           - 2.0 * _ordered_dot(desc_a[b, :la],
                                                desc_b[b, c0:ce])
                           + sq_b[b, None, c0:ce], min=0.0)
        ok = (maskf_a[b, :la, None] > 0) & (maskf_b[b, None, c0:ce] > 0)
        d2[:la, :ce - c0] = torch.where(ok, part, FLT_MAX)
    return d2


def nearest_neighbors2_plain(desc_a, desc_b, maskf_a, maskf_b, sq_a, sq_b):
    """Raw top-2 per A row, before the wrapper's invalid-row fill:
    (i1, d1, i2, d2), each (B, Na). Columns in chunks (``_nn_chunk``); in
    a chunk the first minimum, then the first minimum of the rest."""
    bsz, na = desc_a.shape[:2]
    nb = desc_b.shape[1]
    chunk = _nn_chunk(nb)
    dev = desc_a.device
    lims = nn_active_limits(maskf_a > 0, maskf_b > 0).tolist()
    outs = []
    for b in range(bsz):
        run = (torch.full((na,), FLT_MAX, device=dev),
               torch.zeros(na, dtype=torch.int64, device=dev),
               torch.full((na,), FLT_MAX, device=dev),
               torch.zeros(na, dtype=torch.int64, device=dev))
        for c0 in range(0, nb, chunk):
            d2 = _chunk_d2(desc_a, desc_b, maskf_a, maskf_b, sq_a, sq_b, b,
                           c0, chunk, lims[b])
            loc1 = torch.argmin(d2, dim=1)       # first minimum
            cd1 = d2.gather(1, loc1[:, None])[:, 0]
            d2x = d2.scatter(1, loc1[:, None], FLT_MAX)  # drop the 1st
            loc2 = torch.argmin(d2x, dim=1)
            cd2 = d2x.gather(1, loc2[:, None])[:, 0]
            run = _merge_top2(run, (cd1, loc1 + c0, cd2, loc2 + c0))
        outs.append(run)
    d1, i1, d2, i2 = (torch.stack(t) for t in zip(*outs))
    return i1.to(torch.int32), d1, i2.to(torch.int32), d2


def nearest_neighbors_plain(desc_a, desc_b, maskf_a, maskf_b, sq_a, sq_b):
    """Raw 1-NN per A row, before the wrapper's fill: (idx, d2), each
    (B, Na): the first minimum of each chunk, replaced across chunks only
    on strictly less (pallas_frontend.py:443-445), which is argmin's
    first minimum over all columns. Equals the first slot of
    ``nearest_neighbors2_plain`` bit for bit (the same distances)."""
    bsz, na = desc_a.shape[:2]
    nb = desc_b.shape[1]
    chunk = _nn_chunk(nb)
    dev = desc_a.device
    lims = nn_active_limits(maskf_a > 0, maskf_b > 0).tolist()
    outs = []
    for b in range(bsz):
        rd = torch.full((na,), FLT_MAX, device=dev)
        ri = torch.zeros(na, dtype=torch.int64, device=dev)
        for c0 in range(0, nb, chunk):
            d2 = _chunk_d2(desc_a, desc_b, maskf_a, maskf_b, sq_a, sq_b, b,
                           c0, chunk, lims[b])
            loc = torch.argmin(d2, dim=1)        # first minimum
            cd = d2.gather(1, loc[:, None])[:, 0]
            better = cd < rd
            rd = torch.where(better, cd, rd)
            ri = torch.where(better, loc + c0, ri)
        outs.append((ri, rd))
    idx, d2 = (torch.stack(t) for t in zip(*outs))
    return idx.to(torch.int32), d2


def _nn_inputs(desc_a, desc_b, mask_a, mask_b):
    """Checks shared by the NN wrappers; returns the device."""
    bsz, na, dim = desc_a.shape
    nb = desc_b.shape[1]
    check("desc_a", desc_a, (bsz, na, dim))
    check("desc_b", desc_b, (bsz, nb, dim))
    check("mask_a", mask_a, (bsz, na), torch.bool)
    check("mask_b", mask_b, (bsz, nb), torch.bool)
    dev = same_device(desc_a, desc_b, mask_a, mask_b)
    if dev.type == "cuda" and dim != FPFH_DIM:
        raise ValueError(f"the kernel takes {FPFH_DIM}-D descriptors")
    return dev


def neighbor_operands(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      mask_a: torch.Tensor, mask_b: torch.Tensor):
    """The NN kernels' operands of the search of A in B and of B in A,
    formed once for both: two tuples (maskf_a, maskf_b, |a|^2, |b|^2,
    limits) and (maskf_b, maskf_a, |b|^2, |a|^2, limits'), the active
    limits (``nn_active_limits``) on the card, None on the CPU (the plain
    versions find their own)."""
    maskf_a, maskf_b = mask_a.to(torch.float32), mask_b.to(torch.float32)
    sq_a, sq_b = (desc_a * desc_a).sum(-1), (desc_b * desc_b).sum(-1)
    lim_ab = lim_ba = None
    if desc_a.device.type == "cuda":
        lim_a, lim_b = active_limit(mask_a), active_limit(mask_b)
        lim_ab = torch.stack([lim_a, lim_b], 1).contiguous()
        lim_ba = torch.stack([lim_b, lim_a], 1).contiguous()
    return ((maskf_a, maskf_b, sq_a, sq_b, lim_ab),
            (maskf_b, maskf_a, sq_b, sq_a, lim_ba))


def nearest_neighbors(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      mask_a: torch.Tensor, mask_b: torch.Tensor,
                      operands=None, fill: bool = True):
    """Nearest neighbour of each A row in B: (idx, d2), each (B, Na)
    (int32 index, f32 squared distance), the first minimum on ties. desc
    (B, N, 33) f32, masks (B, N) bool. Invalid rows, and rows with no
    valid column, get index 0 / f32 max (with ``fill`` False the
    kernel's own outputs there). ``operands``: this search's tuple of
    ``neighbor_operands`` where the caller formed them. Replaces
    pallas_frontend.py::nearest_neighbors_pallas (csrc/nn1.cu, which
    skips rows and columns past ``nn_active_limits`` and splits the
    columns into NN1_SPLIT-wide work items, one launch per call); equals
    the first slot of ``nearest_neighbors2``."""
    bsz, na = desc_a.shape[:2]
    nb = desc_b.shape[1]
    dev = _nn_inputs(desc_a, desc_b, mask_a, mask_b)
    maskf_a, maskf_b, sq_a, sq_b, limits = (
        operands or neighbor_operands(desc_a, desc_b, mask_a, mask_b)[0])
    if dev.type != "cuda":
        idx, d2 = nearest_neighbors_plain(desc_a, desc_b, maskf_a, maskf_b,
                                          sq_a, sq_b)
    else:
        idx = torch.empty((bsz, na), dtype=torch.int32, device=dev)
        d2 = torch.empty((bsz, na), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        partial = ticket = 0
        if nb > NN1_SPLIT:
            tiles = bsz * -(-na // NN1_ROWS)
            ticket, partial = stream_scratch(
                dev, stream, tiles, 2 * tiles * -(-nb // NN1_SPLIT) * NN1_ROWS)
        launch("nn1", desc_a, desc_b, sq_a, sq_b, maskf_a, maskf_b, limits,
               bsz, na, nb, NN1_SPLIT, partial, ticket, idx, d2,
               stream=stream)
        LAUNCHES["nearest_neighbors"] += 1
    if not fill:
        return idx, d2
    empty = ~mask_a | (d2 >= FLT_MAX)
    return torch.where(empty, 0, idx), torch.where(empty, FLT_MAX, d2)


def nearest_neighbors2(desc_a: torch.Tensor, desc_b: torch.Tensor,
                       mask_a: torch.Tensor, mask_b: torch.Tensor,
                       operands=None, fill: bool = True):
    """Top-2 neighbours of each A row in B: (i1, d1, i2, d2), each (B, Na)
    (int32 indices, f32 squared distances). desc (B, N, 33) f32, masks
    (B, N) bool. Invalid rows, and slots with no valid column, get index
    0 / f32 max (with ``fill`` False the kernel's own outputs there);
    ``operands`` as for ``nearest_neighbors``. Replaces
    pallas_frontend.py::nearest_neighbors2_pallas (csrc/nn2.cu), which
    skips rows and columns past ``nn_active_limits`` and equals the plain
    version bit for bit given the same |a|^2 and |b|^2."""
    bsz, na = desc_a.shape[:2]
    nb = desc_b.shape[1]
    dev = _nn_inputs(desc_a, desc_b, mask_a, mask_b)
    maskf_a, maskf_b, sq_a, sq_b, limits = (
        operands or neighbor_operands(desc_a, desc_b, mask_a, mask_b)[0])
    if dev.type != "cuda":
        out = nearest_neighbors2_plain(desc_a, desc_b, maskf_a, maskf_b,
                                       sq_a, sq_b)
    else:
        i1 = torch.empty((bsz, na), dtype=torch.int32, device=dev)
        i2 = torch.empty_like(i1)
        d1 = torch.empty((bsz, na), dtype=torch.float32, device=dev)
        d2 = torch.empty_like(d1)
        launch("nn2", desc_a, desc_b, sq_a, sq_b, maskf_a, maskf_b, limits,
               bsz, na, nb, _nn_chunk(nb), i1, d1, i2, d2)
        LAUNCHES["nearest_neighbors2"] += 1
        out = (i1, d1, i2, d2)
    return _fill_empty(*out, mask_a) if fill else out


def nn_active_limits(mask_a: torch.Tensor,
                     mask_b: torch.Tensor) -> torch.Tensor:
    """(B, 2) int32 on the masks' device: one past the last valid row of
    A and one past the last valid column of B per batch entry (0 where
    there is none), the top-2 kernel's active limits
    (pallas_frontend.py::_nn_active_limits). A reduction on the device,
    with nothing read back."""
    return torch.stack([active_limit(mask_a), active_limit(mask_b)], 1).to(
        torch.int32).contiguous()


def _fill_empty(i1, d1, i2, d2, mask_a):
    """Index 0 / f32 max for invalid rows and for slots no valid column
    filled (pallas_frontend.py:590-594)."""
    e1 = ~mask_a | (d1 >= FLT_MAX)
    e2 = ~mask_a | (d2 >= FLT_MAX)
    return (torch.where(e1, 0, i1), torch.where(e1, FLT_MAX, d1),
            torch.where(e2, 0, i2), torch.where(e2, FLT_MAX, d2))
