"""The hit counts of the registration overlap.

For a posed source cloud and a target cloud, the number of valid source
points with a valid target point within a radius, for every pose and pair
at once (``solver/verify.alignment_overlap``; the ``block_hits`` fusion
of ``quatro_tpu/solver/verify.py:63`` inside its ``lax.map``, no Pallas
kernel there). ``overlap_hits`` calls ``csrc/overlap_hits.cu`` for CUDA
tensors (a pass that packs the valid points, then the distances over
them alone) and counts the call; for CPU tensors it runs
``overlap_hits_plain``, the blocked torch route (a ``fori`` device loop
over fixed blocks of source rows). There is no fallback between the two.

Distances are difference-first per coordinate, ((dx dx) + (dy dy)) +
(dz dz) with every operation rounded on its own, never the Gram identity
(``torch.cdist``'s default), whose f32 cancellation at 40-80 m ranges
reaches ~1e-2 m^2.
"""

from __future__ import annotations

import math

import torch

from quatro_tpu_torch.ops.launch import (LAUNCHES, launch, same_device,
                                         stream_scratch)
from quatro_tpu_torch.utils import loops

OVERLAP_THREADS = 128       # csrc/overlap_hits.cu's threads a block
OVERLAP_SPLIT_MIN = 512     # targets a split at least


def _lead(p, pm, tgt, tgt_mask):
    return torch.broadcast_shapes(p.shape[:-2], tgt.shape[:-2],
                                  pm.shape[:-1], tgt_mask.shape[:-1])


def _block_hits(consts, state, rows):
    """One block of ``overlap_hits_plain``'s device loop: the hits of the
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


def overlap_hits_plain(p, pm, tgt, tgt_mask, r2,
                       row_block: int = 2048) -> torch.Tensor:
    """int64 hits of the lead shape (p's, pm's, tgt's and tgt_mask's
    leading axes broadcast together) in torch operations: the distances
    in blocks of ``row_block`` source rows split among the leading
    entries (at least one row a block), the source padded to a whole
    number of blocks and the padding masked out (as the JAX package pads),
    the blocks a ``fori`` device loop (utils/loops.py, the JAX package's
    ``lax.map``). The count is an integer, so the blocking does not
    change it."""
    lead = _lead(p, pm, tgt, tgt_mask)
    rows = max(1, row_block // max(1, math.prod(lead)))
    n = p.shape[-2]
    blocks = -(-n // rows)
    pad = blocks * rows - n
    pm = torch.nn.functional.pad(pm, (0, pad))
    p = torch.nn.functional.pad(p, (0, 0, 0, pad))
    dev = p.device
    iota = torch.arange(rows, device=dev)

    def body(consts, state):
        return _block_hits(consts, state, rows)

    hits, _ = loops.fori(
        "overlap", body, (p, pm, tgt, tgt_mask, r2, iota),
        (torch.zeros(lead, dtype=torch.int64, device=dev),
         torch.zeros((), dtype=torch.int64, device=dev)), blocks, blocks)
    return hits


def _rows_of(t: torch.Tensor, core: int, lead) -> torch.Tensor:
    """(prod(lead),) int32: each leading entry's row of ``t`` with its
    leading axes flattened, under the broadcast to ``lead``."""
    tl = t.shape[:t.dim() - core]
    return torch.arange(math.prod(tl), dtype=torch.int32,
                        device=t.device).reshape(tl).expand(lead).reshape(-1)


# pack and idx of kernel_operands by (device, the four operands' leading
# shapes), built once a shape (outside a CUDA graph capture)
_INDEX: dict = {}


def _index_operands(p, pm, tgt, tgt_mask, lead):
    joint = torch.broadcast_shapes(tgt.shape[:-2], tgt_mask.shape[:-1])
    pack = torch.stack([_rows_of(tgt, 2, joint),
                        _rows_of(tgt_mask, 1, joint)]).contiguous()
    combo = torch.arange(math.prod(joint), dtype=torch.int32,
                         device=p.device).reshape(joint).expand(lead)
    idx = torch.stack([_rows_of(p, 2, lead), _rows_of(pm, 1, lead),
                       combo.reshape(-1)]).contiguous()
    return pack, idx


def kernel_operands(p, pm, tgt, tgt_mask, lead):
    """What csrc/overlap_hits.cu reads: p (Lp, N, 3), pm (Lpm, N), tgt
    (Lt, M, 3) and tgt_mask (Ltm, M), each flattened over its own leading
    axes and contiguous (a pair's target once, whatever its poses); pack
    (2, Ct) int32, each target combination's row of tgt and of tgt_mask
    (the combinations: tgt's and tgt_mask's leading axes broadcast
    together); idx (3, prod(lead)) int32, each leading entry's row of p,
    of pm and its target combination. pack and idx depend on the shapes
    alone, and are kept from the first call at the shapes."""
    n, m = p.shape[-2], tgt.shape[-2]
    key = (p.device, p.shape[:-2], pm.shape[:-1], tgt.shape[:-2],
           tgt_mask.shape[:-1])
    index = _INDEX.get(key)
    if index is None:
        index = _index_operands(p, pm, tgt, tgt_mask, lead)
        if not (p.is_cuda and torch.cuda.is_current_stream_capturing()):
            _INDEX[key] = index
    return (p.reshape(-1, n, 3).contiguous(), pm.reshape(-1, n).contiguous(),
            tgt.reshape(-1, m, 3).contiguous(),
            tgt_mask.reshape(-1, m).contiguous(), *index)


def overlap_plan(lead: int, n: int, m: int, sms: int = 132):
    """(rows a thread, row tiles, target splits) of the kernel for
    ``lead`` leading entries of N source rows against M targets: 4 rows a
    thread, halved while the grid of (leading entry, tile of 128 x rows)
    holds fewer than two blocks an SM, then as many splits of the targets
    (at least OVERLAP_SPLIT_MIN a split) as bring it to two."""
    want = 2 * sms
    r = 4
    while r > 1 and lead * -(-n // (OVERLAP_THREADS * r)) < want:
        r //= 2
    tiles = -(-n // (OVERLAP_THREADS * r))
    splits = 1
    if lead * tiles < want:
        splits = max(1, min(-(-want // (lead * tiles)),
                            m // OVERLAP_SPLIT_MIN))
    return r, tiles, splits


def overlap_hits(p: torch.Tensor, pm: torch.Tensor, tgt: torch.Tensor,
                 tgt_mask: torch.Tensor, r2: torch.Tensor,
                 row_block: int = 2048) -> torch.Tensor:
    """int64 hits of the lead shape: for each leading entry, the valid
    rows of the posed source p (..., N, 3) (mask pm (..., N)) whose
    nearest valid point of tgt (..., M, 3) (mask tgt_mask (..., M)) lies
    within r2 (a 0-d f32 tensor, the squared radius); the leading axes
    broadcast. On CUDA tensors one call of csrc/overlap_hits.cu over the
    valid points only (each pair's target packed once, whatever its
    poses), bit for bit ``overlap_hits_plain``; that plain version, in
    blocks of ``row_block`` rows, for CPU tensors."""
    if p.dtype != torch.float32 or tgt.dtype != torch.float32:
        raise TypeError(f"p and tgt: expected float32, got {p.dtype} and "
                        f"{tgt.dtype}")
    if pm.dtype != torch.bool or tgt_mask.dtype != torch.bool:
        raise TypeError("pm and tgt_mask must be bool")
    if r2.dtype != torch.float32 or r2.dim() != 0:
        raise TypeError("r2 must be a 0-d float32 tensor")
    if p.shape[-1] != 3 or tgt.shape[-1] != 3:
        raise ValueError(f"p {tuple(p.shape)} and tgt {tuple(tgt.shape)} "
                         "must end in 3")
    lead = _lead(p, pm, tgt, tgt_mask)
    dev = same_device(p, pm, tgt, tgt_mask, r2)
    if dev.type != "cuda":
        return overlap_hits_plain(p, pm, tgt, tgt_mask, r2, row_block)
    n, m = p.shape[-2], tgt.shape[-2]
    if pm.shape[-1] != n or tgt_mask.shape[-1] != m:
        raise ValueError(f"masks {tuple(pm.shape)} / {tuple(tgt_mask.shape)} "
                         f"do not fit p {tuple(p.shape)} / tgt "
                         f"{tuple(tgt.shape)}")
    out = torch.zeros(lead, dtype=torch.int64, device=dev)
    count = math.prod(lead)
    if count == 0 or n == 0:
        return out
    pk, pmk, tk, tmk, pack, idx = kernel_operands(p, pm, tgt, tgt_mask, lead)
    ct, lpm = pack.shape[1], pmk.shape[0]
    r, tiles, splits = overlap_plan(
        count, n, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    tpack = torch.empty((ct, m, 4), dtype=torch.float32, device=dev)
    counts = torch.empty(ct + lpm, dtype=torch.int32, device=dev)
    sidx = torch.empty((lpm, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = ticket = 0
    if splits > 1:
        ticket, partial = stream_scratch(
            dev, stream, count * tiles,
            count * tiles * splits * OVERLAP_THREADS * r)
    launch("overlap_hits", pk, pmk, tk, tmk, r2, pack, idx, ct, lpm, count,
           n, m, r, tiles, splits, tpack, counts, sidx, counts[ct:],
           partial, ticket, out, stream=stream)
    LAUNCHES["overlap_hits"] += 1
    return out
