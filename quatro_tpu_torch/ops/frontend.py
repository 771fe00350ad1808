"""The front end's four kernels: moment sums, SPFH, FPFH and top-2 NN.

Counterpart of ``quatro_tpu/ops/pallas_frontend.py``. Each kernel has

* a wrapper (``moment_sums``, ``spfh``, ``fpfh_sums``,
  ``nearest_neighbors2``) that checks its inputs, allocates the outputs
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
                                      normalize_blocks)
from quatro_tpu_torch.ops.launch import (LAUNCHES, check, launch,  # noqa: F401
                                         reset_launches, same_device)
from quatro_tpu_torch.ops.normals import Normals, normals_from_moments

FLT_MAX = torch.finfo(torch.float32).max
NN_CHUNK = 2048          # column chunk of the top-2 tie rule
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

def moment_sums_plain(points: torch.Tensor, maskf: torch.Tensor,
                      radius: float) -> torch.Tensor:
    """(B, V, 10): [count, s_dx, s_dy, s_dz, s_dxdx, s_dxdy, s_dxdz,
    s_dydy, s_dydz, s_dzdz] over valid in-radius pairs, self included,
    dx = x_i - x_j. Masked rows are zero."""
    r2 = _r2(radius, points)
    out = points.new_zeros((*points.shape[:2], 10))
    for b in range(points.shape[0]):
        p, m = points[b], maskf[b] > 0
        for s in range(0, p.shape[0], _ROW_TILE):
            pr = p[s:s + _ROW_TILE]
            (dx, dy, dz), d2 = _pair_geometry(pr, p)
            a = ((d2 <= r2) & m[None, :]
                 & m[s:s + _ROW_TILE, None]).to(p.dtype)
            ax, ay, az = a * dx, a * dy, a * dz
            out[b, s:s + _ROW_TILE] = torch.stack(
                [a.sum(1), ax.sum(1), ay.sum(1), az.sum(1),
                 (ax * dx).sum(1), (ax * dy).sum(1), (ax * dz).sum(1),
                 (ay * dy).sum(1), (ay * dz).sum(1), (az * dz).sum(1)], -1)
    return out


def moment_sums(points: torch.Tensor, maskf: torch.Tensor,
                radius: float) -> torch.Tensor:
    """Ten centred neighbourhood moment sums per point, (B, V, 10) f32.
    points (B, V, 3) f32, maskf (B, V) f32 0/1. Replaces
    pallas_frontend.py::moment_sums_pallas (csrc/moment_sums.cu)."""
    bsz, v = points.shape[:2]
    check("points", points, (bsz, v, 3))
    check("maskf", maskf, (bsz, v))
    if same_device(points, maskf).type != "cuda":
        return moment_sums_plain(points, maskf, radius)
    out = torch.empty((bsz, v, 10), dtype=torch.float32, device=points.device)
    launch("moment_sums", points, maskf, bsz, v,
           float(radius * radius), out)
    LAUNCHES["moment_sums"] += 1
    return out


def frontend_normals(points: torch.Tensor, mask: torch.Tensor,
                     radius: float) -> Normals:
    """PCA normals over true radius neighbourhoods from the moment kernel;
    points (B, V, 3), mask (B, V) bool."""
    mom = moment_sums(points, mask.to(points.dtype).contiguous(), radius)
    return normals_from_moments(points, mask, mom)


# ----------------------------------------------------------------- B4 ----

def darboux_bins(d, d2, n_i, n_j, use_rsqrt: bool):
    """Darboux features of pairs (pcl::computePairFeatures semantics):
    d = p_j - p_i components, d2 = |d|^2, n_i / n_j normal components.
    Returns (b1, b2, b3) int32 bins and the frame-valid mask
    (v_norm2 > 1e-20). use_rsqrt: the kernel form (rsqrt, products) of
    pallas_frontend.py:_spfh_body; else the dense form (sqrt, quotients)
    of dense_features.py. Every product is a separate f32 operation, as
    in the CUDA kernel."""

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    if use_rsqrt:
        inv_dist = torch.rsqrt(torch.clamp(d2, min=1e-30))
        angle1 = dot(n_i, d) * inv_dist
        angle2 = dot(n_j, d) * inv_dist
    else:
        dist = torch.sqrt(torch.clamp(d2, min=1e-30))
        angle1 = dot(n_i, d) / dist
        angle2 = dot(n_j, d) / dist
    swap = torch.abs(angle1) < torch.abs(angle2)
    n1s = tuple(torch.where(swap, n_j[k], n_i[k]) for k in range(3))
    n2s = tuple(torch.where(swap, n_i[k], n_j[k]) for k in range(3))
    ds = tuple(torch.where(swap, -d[k], d[k]) for k in range(3))
    f3 = torch.where(swap, -angle2, angle1)
    vv = cross(ds, n1s)
    v_norm2 = dot(vv, vv)
    inv = torch.rsqrt(torch.clamp(v_norm2, min=1e-30))
    vv = tuple(c * inv for c in vv)
    ww = cross(n1s, vv)
    f2 = dot(vv, n2s)
    f1 = torch.atan2(dot(ww, n2s), dot(n1s, n2s))
    return (_bin_index(f1, -math.pi, math.pi), _bin_index(f2, -1.0, 1.0),
            _bin_index(f3, -1.0, 1.0), v_norm2 > 1e-20)


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


def spfh(points: torch.Tensor, normals: torch.Tensor,
         pair_maskf: torch.Tensor, radius: float):
    """Raw SPFH bin counts (B, V, 33) f32 and pair counts (B, V) f32.
    Replaces pallas_frontend.py::spfh_pallas (csrc/spfh.cu)."""
    bsz, v = points.shape[:2]
    check("points", points, (bsz, v, 3))
    check("normals", normals, (bsz, v, 3))
    check("pair_maskf", pair_maskf, (bsz, v))
    if same_device(points, normals, pair_maskf).type != "cuda":
        return spfh_plain(points, normals, pair_maskf, radius)
    hist = torch.empty((bsz, v, FPFH_DIM), dtype=torch.float32,
                       device=points.device)
    cnt = torch.empty((bsz, v), dtype=torch.float32, device=points.device)
    launch("spfh", points, normals, pair_maskf, bsz, v,
           float(radius * radius), hist, cnt)
    LAUNCHES["spfh"] += 1
    return hist, cnt


# ----------------------------------------------------------------- B5 ----

def fpfh_sums_plain(points: torch.Tensor, spfh_rows: torch.Tensor,
                    pair_maskf: torch.Tensor, radius: float) -> torch.Tensor:
    """(B, V, 33): sum_j SPFH_j / max(d2_ij, 1e-12) over valid pairs with
    1e-12 < d2 <= r^2 (an f32 matrix product, never TF32)."""
    r2 = _r2(radius, points)
    out = torch.zeros_like(spfh_rows)
    for b in range(points.shape[0]):
        p, m = points[b], pair_maskf[b] > 0
        for s in range(0, p.shape[0], _ROW_TILE):
            _, d2 = _pair_geometry(p[s:s + _ROW_TILE], p)
            ok = (m[s:s + _ROW_TILE, None] & m[None, :] & (d2 <= r2)
                  & (d2 > 1e-12))
            w = torch.where(ok, 1.0 / torch.clamp(d2, min=1e-12), 0.0)
            out[b, s:s + _ROW_TILE] = w @ spfh_rows[b]
    return out


def fpfh_sums(points: torch.Tensor, spfh_rows: torch.Tensor,
              pair_maskf: torch.Tensor, radius: float) -> torch.Tensor:
    """Unnormalised FPFH weighted sums (B, V, 33) f32. Replaces the pair
    pass of pallas_frontend.py::frontend_fpfh (csrc/fpfh.cu)."""
    bsz, v = points.shape[:2]
    check("points", points, (bsz, v, 3))
    check("spfh_rows", spfh_rows, (bsz, v, FPFH_DIM))
    check("pair_maskf", pair_maskf, (bsz, v))
    if same_device(points, spfh_rows, pair_maskf).type != "cuda":
        return fpfh_sums_plain(points, spfh_rows, pair_maskf, radius)
    out = torch.empty((bsz, v, FPFH_DIM), dtype=torch.float32,
                      device=points.device)
    launch("fpfh", points, spfh_rows, pair_maskf, bsz, v,
           float(radius * radius), out)
    LAUNCHES["fpfh"] += 1
    return out


def frontend_fpfh(points: torch.Tensor, normals: torch.Tensor,
                  normal_valid: torch.Tensor, mask: torch.Tensor,
                  radius: float) -> torch.Tensor:
    """(B, V, 33) FPFH descriptors: SPFH kernel, per-row x100/count
    scaling, weighted-sum kernel, then each 11-bin block normalised to
    100 (PCL conventions, as pallas_frontend.py::frontend_fpfh)."""
    pair_maskf = (mask & normal_valid).to(points.dtype).contiguous()
    raw, cnt = spfh(points, normals.contiguous(), pair_maskf, radius)
    spfh_rows = raw * (100.0 / torch.clamp(cnt, min=1.0))[..., None]
    return normalize_blocks(fpfh_sums(points, spfh_rows.contiguous(),
                                      pair_maskf, radius))


# ----------------------------------------------------------------- B7 ----

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


def nearest_neighbors2_plain(desc_a, desc_b, maskf_a, maskf_b, sq_a, sq_b):
    """Raw top-2 per A row, before the wrapper's invalid-row fill:
    (i1, d1, i2, d2), each (B, Na). Columns in chunks (``_nn_chunk``); in
    a chunk the first minimum, then the first minimum of the rest."""
    bsz, na = desc_a.shape[:2]
    nb = desc_b.shape[1]
    chunk = _nn_chunk(nb)
    dev = desc_a.device
    big = torch.tensor(FLT_MAX, dtype=torch.float32, device=dev)
    outs = []
    for b in range(bsz):
        run = (torch.full((na,), FLT_MAX, device=dev),
               torch.zeros(na, dtype=torch.int64, device=dev),
               torch.full((na,), FLT_MAX, device=dev),
               torch.zeros(na, dtype=torch.int64, device=dev))
        for c0 in range(0, nb, chunk):
            cols = desc_b[b, c0:c0 + chunk]
            d2 = torch.clamp(sq_a[b][:, None] - 2.0 * (desc_a[b] @ cols.T)
                             + sq_b[b, c0:c0 + chunk][None, :], min=0.0)
            ok = (maskf_a[b][:, None] > 0) & (maskf_b[b, c0:c0 + chunk] > 0)
            d2 = torch.where(ok, d2, big)
            loc1 = torch.argmin(d2, dim=1)       # first minimum
            cd1 = d2.gather(1, loc1[:, None])[:, 0]
            d2x = d2.scatter(1, loc1[:, None], FLT_MAX)  # drop the 1st
            loc2 = torch.argmin(d2x, dim=1)
            cd2 = d2x.gather(1, loc2[:, None])[:, 0]
            run = _merge_top2(run, (cd1, loc1 + c0, cd2, loc2 + c0))
        outs.append(run)
    d1, i1, d2, i2 = (torch.stack(t) for t in zip(*outs))
    return i1.to(torch.int32), d1, i2.to(torch.int32), d2


def nearest_neighbors2(desc_a: torch.Tensor, desc_b: torch.Tensor,
                       mask_a: torch.Tensor, mask_b: torch.Tensor):
    """Top-2 neighbours of each A row in B: (i1, d1, i2, d2), each (B, Na)
    (int32 indices, f32 squared distances). desc (B, N, 33) f32, masks
    (B, N) bool. Invalid rows, and slots with no valid column, get index
    0 / f32 max. Replaces
    pallas_frontend.py::nearest_neighbors2_pallas (csrc/nn2.cu)."""
    bsz, na, dim = desc_a.shape
    nb = desc_b.shape[1]
    check("desc_a", desc_a, (bsz, na, dim))
    check("desc_b", desc_b, (bsz, nb, dim))
    check("mask_a", mask_a, (bsz, na), torch.bool)
    check("mask_b", mask_b, (bsz, nb), torch.bool)
    chunk = _nn_chunk(nb)
    dev = same_device(desc_a, desc_b, mask_a, mask_b)
    maskf_a = mask_a.to(torch.float32)
    maskf_b = mask_b.to(torch.float32)
    sq_a = (desc_a * desc_a).sum(-1)
    sq_b = (desc_b * desc_b).sum(-1)
    if dev.type != "cuda":
        i1, d1, i2, d2 = nearest_neighbors2_plain(desc_a, desc_b, maskf_a,
                                                  maskf_b, sq_a, sq_b)
    else:
        if dim != FPFH_DIM:
            raise ValueError(f"the kernel takes {FPFH_DIM}-D descriptors")
        i1 = torch.empty((bsz, na), dtype=torch.int32, device=dev)
        i2 = torch.empty_like(i1)
        d1 = torch.empty((bsz, na), dtype=torch.float32, device=dev)
        d2 = torch.empty_like(d1)
        launch("nn2", desc_a, desc_b, sq_a, sq_b, maskf_a, maskf_b, bsz, na,
               nb, chunk, i1, d1, i2, d2)
        LAUNCHES["nearest_neighbors2"] += 1
    return _fill_empty(i1, d1, i2, d2, mask_a)


def _fill_empty(i1, d1, i2, d2, mask_a):
    """Index 0 / f32 max for invalid rows and for slots no valid column
    filled (pallas_frontend.py:590-594)."""
    e1 = ~mask_a | (d1 >= FLT_MAX)
    e2 = ~mask_a | (d2 >= FLT_MAX)
    return (torch.where(e1, 0, i1), torch.where(e1, FLT_MAX, d1),
            torch.where(e2, 0, i2), torch.where(e2, FLT_MAX, d2))
