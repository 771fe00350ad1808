"""Descriptor matching: mutual-NN + cross-check + tuple test.

PyTorch counterpart of ``quatro_tpu/ops/matching.py`` (the reference's
``teaser::Matcher``, src/teaser_utils/feature_matcher.cc:77-265). Same
candidate sets, the same quality sort, the same host-drawn tuple-test
shifts and the same compaction, so the correspondence set equals the JAX
package's slot for slot on the same descriptors. Nearest neighbours come
from the top-2 kernel (ops/frontend.py::nearest_neighbors2) where the
starvation fallback needs second neighbours, else from the 1-NN kernel
(ops/frontend.py::nearest_neighbors), as the JAX package dispatches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from quatro_tpu_torch.device import resolve_device, to_tensor
from quatro_tpu_torch.ops.frontend import (nearest_neighbors,
                                           nearest_neighbors2)
from quatro_tpu_torch.ops.neighbors import pairwise_sq_dists
from quatro_tpu_torch.utils import fused
from quatro_tpu_torch.utils.batch import drop_axis, gather_rows

_IDX_BITS = 15                    # candidate packing: (src << 15) | tgt
_INT32_MAX = (1 << 31) - 1


class Correspondences(NamedTuple):
    # shapes of one pair; a batch of B pairs adds a leading B
    src_idx: torch.Tensor   # (C,) int32 into source keypoints
    tgt_idx: torch.Tensor   # (C,) int32 into target keypoints
    mask: torch.Tensor      # (C,) bool
    src_xyz: torch.Tensor   # (C, 3) gathered source keypoints
    tgt_xyz: torch.Tensor   # (C, 3) gathered target keypoints

    def row(self, b: int) -> "Correspondences":
        """Pair b's correspondences."""
        return Correspondences(*(t[b] for t in self))

    @staticmethod
    def stack(rows) -> "Correspondences":
        """Correspondences stacked along a new leading pair axis."""
        return Correspondences(*(torch.stack(c) for c in zip(*rows)))


def descriptor_distances(desc_a: torch.Tensor, desc_b: torch.Tensor,
                         mask_a: torch.Tensor, mask_b: torch.Tensor):
    """(..., Na, Nb) squared L2 distances between descriptor sets
    (``pairwise_sq_dists``), the float32 maximum where either row is
    masked."""
    d2 = pairwise_sq_dists(desc_a, desc_b)
    return torch.where(mask_a[..., :, None] & mask_b[..., None, :], d2,
                       torch.finfo(d2.dtype).max)


def _nearest_neighbors(desc_a, desc_b, mask_a, mask_b):
    """Nearest neighbour of A in B per pair of (B, Na, 33) descriptors:
    (idx, d2), each (B, Na), the index int64 for indexing."""
    idx, d2 = nearest_neighbors(desc_a.contiguous(), desc_b.contiguous(),
                                mask_a.contiguous(), mask_b.contiguous())
    return idx.long(), d2


def _nearest_neighbors_2(desc_a, desc_b, mask_a, mask_b):
    """Top-2 neighbours of A in B per pair: (i1, d1, i2, d2), each
    (B, Na), indices int64 for indexing."""
    i1, d1, i2, d2 = nearest_neighbors2(desc_a.contiguous(),
                                        desc_b.contiguous(),
                                        mask_a.contiguous(),
                                        mask_b.contiguous())
    return i1.long(), d1, i2.long(), d2


def tuple_shifts(n_cand: int, trials_per_corr: int, seed: int) -> np.ndarray:
    """(T, 2) shift pairs of the shift-structured tuple test, drawn on the
    host exactly as quatro_tpu/ops/matching.py::tuple_test_keep draws
    them, so both packages test the same triples."""
    host_rng = np.random.default_rng(seed)
    shifts = np.unique(
        host_rng.integers(1, max(n_cand - 1, 2),
                          size=(4 * trials_per_corr, 2)), axis=0)
    return shifts[shifts[:, 0] != shifts[:, 1]][:trials_per_corr]


def tuple_test_keep(cs: tuple, ct: tuple, cand_pos: torch.Tensor,
                    ncorr: torch.Tensor, tuple_scale: float = 0.95,
                    trials_per_corr: int = 100, seed: int = 0):
    """Shift-structured tuple (length-ratio) test (reference:
    feature_matcher.cc:187-247, re-designed as in the JAX package): trial
    t tests candidates (i, i+s1 mod n, i+s2 mod n); a pair is kept when
    any triple it is part of passes all three ratio gates. All trials run
    at once as (T, n) gathers, with the same shifts for every pair (as
    under vmap).

    cs/ct: coordinate component tuples (3 x (..., n)) of the compacted
    candidates; cand_pos: (..., n) bool validity; ncorr: (...) live
    counts.
    """
    n = cand_pos.shape[-1]
    dev = cand_pos.device
    shifts = torch.as_tensor(tuple_shifts(n, trials_per_corr, seed),
                             device=dev)
    iota = torch.arange(n, device=dev)
    fwd1 = (iota[None, :] + shifts[:, 0:1]) % n      # roll(c, -s1)
    fwd2 = (iota[None, :] + shifts[:, 1:2]) % n

    def lengths(p, q):
        d = [p[c] - q[c] for c in range(3)]
        return fused.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])

    cs0 = tuple(c[..., None, :] for c in cs)
    ct0 = tuple(c[..., None, :] for c in ct)
    r1 = tuple(c[..., fwd1] for c in cs)
    r2 = tuple(c[..., fwd2] for c in cs)
    t1 = tuple(c[..., fwd1] for c in ct)
    t2 = tuple(c[..., fwd2] for c in ct)
    li = (lengths(cs0, r1), lengths(r1, r2), lengths(r2, cs0))
    lj = (lengths(ct0, t1), lengths(t1, t2), lengths(t2, ct0))
    geo = torch.ones((*cand_pos.shape[:-1], shifts.shape[0], n),
                     dtype=torch.bool, device=dev)
    for a, b in zip(li, lj):
        geo &= (a * tuple_scale < b) & (b < a / tuple_scale)
    live = ncorr[..., None, None]
    ok = geo & cand_pos[..., None, :] & (fwd1 < live) & (fwd2 < live)
    back1 = ((iota[None, :] - shifts[:, 0:1]) % n).expand(ok.shape)
    back2 = ((iota[None, :] - shifts[:, 1:2]) % n).expand(ok.shape)
    hit = ok | ok.gather(-1, back1) | ok.gather(-1, back2)   # roll(ok, s)
    return hit.any(dim=-2) & cand_pos


def match_features(src_xyz: torch.Tensor, tgt_xyz: torch.Tensor,
                   src_desc: torch.Tensor, tgt_desc: torch.Tensor,
                   src_mask: torch.Tensor, tgt_mask: torch.Tensor,
                   capacity: int = 1024, use_crosscheck: bool = True,
                   use_tuple_test: bool = True,
                   tuple_scale: float = 0.95, trials_per_corr: int = 100,
                   seed: int = 0, tuple_min_keep: int = 8,
                   crosscheck_min_matches: int = 64,
                   device=None) -> Correspondences:
    """Full matcher: NN candidates -> tuple test -> compacted output
    (semantics of quatro_tpu/ops/matching.py::match_features), for one
    pair (V, 3) / (V, 33) or a batch of pairs (B, V, 3) / (B, V, 33), each
    pair decided by its own masks.

    With crosscheck the candidates are the mutual nearest neighbours; when
    fewer than ``crosscheck_min_matches`` survive, the one-directional
    union extended with each side's second neighbours. Without crosscheck,
    the one-directional union. The best ``capacity`` by descriptor
    distance are kept. The branch with the starvation fallback searches
    with the top-2 kernel (B7), the others with the 1-NN kernel (B6), as
    the JAX package does, one launch per direction for the whole batch.
    Inputs are numpy arrays or tensors; device: None means "cuda"
    (RuntimeError without a card).
    """
    dev = resolve_device(device)
    src_xyz, tgt_xyz, src_desc, tgt_desc = (
        to_tensor(x, torch.float32, dev)
        for x in (src_xyz, tgt_xyz, src_desc, tgt_desc))
    src_mask, tgt_mask = (to_tensor(m, torch.bool, dev)
                          for m in (src_mask, tgt_mask))
    if src_desc.dim() == 2:
        return drop_axis(match_features(
            src_xyz[None], tgt_xyz[None], src_desc[None], tgt_desc[None],
            src_mask[None], tgt_mask[None], capacity, use_crosscheck,
            use_tuple_test, tuple_scale, trials_per_corr, seed,
            tuple_min_keep, crosscheck_min_matches, dev))
    bsz, na = src_mask.shape
    nb = tgt_mask.shape[-1]
    if max(na, nb) > (1 << _IDX_BITS):
        raise ValueError(f"candidate packing supports {1 << _IDX_BITS} "
                         f"keypoints, got {max(na, nb)}")
    ia = torch.arange(na, device=dev).expand(bsz, na)
    ib = torch.arange(nb, device=dev).expand(bsz, nb)

    fallback = use_crosscheck and crosscheck_min_matches > 0
    if fallback:
        nn_ab, d2_ab, nn_ab2, d2_ab2 = _nearest_neighbors_2(
            src_desc, tgt_desc, src_mask, tgt_mask)
        nn_ba, d2_ba, nn_ba2, d2_ba2 = _nearest_neighbors_2(
            tgt_desc, src_desc, tgt_mask, src_mask)
    else:
        nn_ab, d2_ab = _nearest_neighbors(src_desc, tgt_desc, src_mask,
                                          tgt_mask)
        nn_ba, d2_ba = _nearest_neighbors(tgt_desc, src_desc, tgt_mask,
                                          src_mask)
    mutual_a = ((nn_ba.gather(-1, nn_ab) == ia) & src_mask
                & tgt_mask.gather(-1, nn_ab))
    mutual_b = ((nn_ab.gather(-1, nn_ba) == ib) & tgt_mask
                & src_mask.gather(-1, nn_ba))
    flag_a_union = src_mask & tgt_mask.gather(-1, nn_ab)
    flag_b_union = tgt_mask & src_mask.gather(-1, nn_ba) & ~mutual_b  # dedup

    if fallback:
        # starvation fallback (see the JAX package): too few mutual pairs
        # -> the one-directional union plus both sides' second neighbours,
        # decided per pair
        use_union = mutual_a.sum(-1) < crosscheck_min_matches
        flag_a2 = src_mask & tgt_mask.gather(-1, nn_ab2)
        flag_b2 = tgt_mask & src_mask.gather(-1, nn_ba2)
        cand_src0 = torch.cat([ia, nn_ba, ia, nn_ba2], -1)
        cand_tgt0 = torch.cat([nn_ab, ib, nn_ab2, ib], -1)
        zeros_u = torch.zeros((bsz, na + 2 * nb), dtype=torch.bool,
                              device=dev)
        cand_flag = torch.where(
            use_union[:, None],
            torch.cat([flag_a_union, flag_b_union, flag_a2, flag_b2], -1),
            torch.cat([mutual_a, zeros_u], -1))
        cand_q0 = torch.cat([d2_ab, d2_ba, d2_ab2, d2_ba2], -1)
    elif use_crosscheck:
        cand_src0, cand_tgt0, cand_flag = ia, nn_ab, mutual_a
        cand_q0 = d2_ab
    else:
        cand_src0 = torch.cat([ia, nn_ba], -1)
        cand_tgt0 = torch.cat([nn_ab, ib], -1)
        cand_flag = torch.cat([flag_a_union, flag_b_union], -1)
        cand_q0 = torch.cat([d2_ab, d2_ba], -1)

    n_cand = cand_src0.shape[-1]
    packed_st0 = (cand_src0 << _IDX_BITS) + cand_tgt0

    # one quality sort: best descriptor distance first (d2 >= 0, so its
    # f32 bit pattern orders like the value), invalid last, ties by the
    # packed pair id — the JAX package's two-key sort as one int64 key
    qbits0 = torch.clamp(cand_q0, min=0.0).to(torch.float32).contiguous() \
        .view(torch.int32).long()
    qkey0 = torch.where(cand_flag, qbits0, _INT32_MAX)
    packed_st = torch.sort((qkey0 << 32) | packed_st0, dim=-1
                           ).values & 0xFFFFFFFF
    ncorr = cand_flag.sum(-1)

    # tuple test + compaction on a static quality-ordered prefix
    tt = min(n_cand, max(2 * capacity, 2048))
    packed_tt = packed_st[:, :tt]
    ic_t = torch.arange(tt, device=dev)
    ncorr_t = torch.clamp(ncorr, max=tt)
    cand_pos = ic_t < ncorr_t[:, None]
    cand_src = packed_tt >> _IDX_BITS
    cand_tgt = packed_tt & ((1 << _IDX_BITS) - 1)

    keep = cand_pos
    if use_tuple_test:
        cs3 = gather_rows(src_xyz, cand_src).transpose(-1, -2)
        ct3 = gather_rows(tgt_xyz, cand_tgt).transpose(-1, -2)
        tuple_keep = tuple_test_keep(cs3.unbind(-2), ct3.unbind(-2),
                                     cand_pos, ncorr_t,
                                     tuple_scale=tuple_scale,
                                     trials_per_corr=trials_per_corr,
                                     seed=seed)
        keep = torch.where((tuple_keep.sum(-1) >= tuple_min_keep)[:, None],
                           tuple_keep, cand_pos)

    # final compaction: kept pairs first, in quality order
    poskey = torch.where(keep, ic_t, tt + ic_t)
    packed_sel = packed_tt.gather(
        -1, torch.sort(poskey, dim=-1, stable=True).indices)
    kcount = keep.sum(-1)
    if tt >= capacity:
        sel = packed_sel[:, :capacity]
    else:
        sel = torch.cat([packed_sel, packed_sel.new_zeros(
            (bsz, capacity - tt))], -1)
    out_mask = (torch.arange(capacity, device=dev)
                < torch.clamp(kcount, max=capacity)[:, None])
    s_idx = torch.where(out_mask, sel >> _IDX_BITS, 0)
    t_idx = torch.where(out_mask, sel & ((1 << _IDX_BITS) - 1), 0)
    s_xyz = torch.where(out_mask[..., None], gather_rows(src_xyz, s_idx), 0.0)
    t_xyz = torch.where(out_mask[..., None], gather_rows(tgt_xyz, t_idx), 0.0)
    return Correspondences(s_idx.to(torch.int32), t_idx.to(torch.int32),
                           out_mask, s_xyz, t_xyz)
