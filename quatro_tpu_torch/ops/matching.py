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
from quatro_tpu_torch.utils import fused

_IDX_BITS = 15                    # candidate packing: (src << 15) | tgt
_INT32_MAX = (1 << 31) - 1


class Correspondences(NamedTuple):
    src_idx: torch.Tensor   # (C,) int32 into source keypoints
    tgt_idx: torch.Tensor   # (C,) int32 into target keypoints
    mask: torch.Tensor      # (C,) bool
    src_xyz: torch.Tensor   # (C, 3) gathered source keypoints
    tgt_xyz: torch.Tensor   # (C, 3) gathered target keypoints


def _nearest_neighbors(desc_a, desc_b, mask_a, mask_b):
    """Nearest neighbour of A in B: (idx, d2), each (Na,), the index int64
    for indexing."""
    idx, d2 = nearest_neighbors(desc_a[None].contiguous(),
                                desc_b[None].contiguous(),
                                mask_a[None].contiguous(),
                                mask_b[None].contiguous())
    return idx[0].long(), d2[0]


def _nearest_neighbors_2(desc_a, desc_b, mask_a, mask_b):
    """Top-2 neighbours of A in B: (i1, d1, i2, d2), each (Na,), indices
    int64 for indexing."""
    i1, d1, i2, d2 = nearest_neighbors2(desc_a[None].contiguous(),
                                        desc_b[None].contiguous(),
                                        mask_a[None].contiguous(),
                                        mask_b[None].contiguous())
    return i1[0].long(), d1[0], i2[0].long(), d2[0]


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
    at once as (T, n) gathers.

    cs/ct: coordinate component tuples (3 x (n,)) of the compacted
    candidates; cand_pos: (n,) bool validity; ncorr: live count.
    """
    n = cand_pos.shape[0]
    dev = cand_pos.device
    shifts = torch.as_tensor(tuple_shifts(n, trials_per_corr, seed),
                             device=dev)
    iota = torch.arange(n, device=dev)
    fwd1 = (iota[None, :] + shifts[:, 0:1]) % n      # roll(c, -s1)
    fwd2 = (iota[None, :] + shifts[:, 1:2]) % n

    def lengths(p, q):
        d = [p[c] - q[c] for c in range(3)]
        return fused.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])

    cs0 = tuple(c[None, :] for c in cs)
    ct0 = tuple(c[None, :] for c in ct)
    r1 = tuple(c[fwd1] for c in cs)
    r2 = tuple(c[fwd2] for c in cs)
    t1 = tuple(c[fwd1] for c in ct)
    t2 = tuple(c[fwd2] for c in ct)
    li = (lengths(cs0, r1), lengths(r1, r2), lengths(r2, cs0))
    lj = (lengths(ct0, t1), lengths(t1, t2), lengths(t2, ct0))
    geo = torch.ones((shifts.shape[0], n), dtype=torch.bool, device=dev)
    for a, b in zip(li, lj):
        geo &= (a * tuple_scale < b) & (b < a / tuple_scale)
    ok = geo & cand_pos[None, :] & (fwd1 < ncorr) & (fwd2 < ncorr)
    back1 = (iota[None, :] - shifts[:, 0:1]) % n     # roll(ok, s1)
    back2 = (iota[None, :] - shifts[:, 1:2]) % n
    hit = ok | ok.gather(1, back1) | ok.gather(1, back2)
    return hit.any(dim=0) & cand_pos


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
    (semantics of quatro_tpu/ops/matching.py::match_features).

    With crosscheck the candidates are the mutual nearest neighbours; when
    fewer than ``crosscheck_min_matches`` survive, the one-directional
    union extended with each side's second neighbours. Without crosscheck,
    the one-directional union. The best ``capacity`` by descriptor
    distance are kept. The branch with the starvation fallback searches
    with the top-2 kernel (B7), the others with the 1-NN kernel (B6), as
    the JAX package does. Inputs are numpy arrays or tensors; device:
    None means "cuda" (RuntimeError without a card).
    """
    dev = resolve_device(device)
    src_xyz, tgt_xyz, src_desc, tgt_desc = (
        to_tensor(x, torch.float32, dev)
        for x in (src_xyz, tgt_xyz, src_desc, tgt_desc))
    src_mask, tgt_mask = (to_tensor(m, torch.bool, dev)
                          for m in (src_mask, tgt_mask))
    na = src_desc.shape[0]
    nb = tgt_desc.shape[0]
    if max(na, nb) > (1 << _IDX_BITS):
        raise ValueError(f"candidate packing supports {1 << _IDX_BITS} "
                         f"keypoints, got {max(na, nb)}")
    ia = torch.arange(na, device=dev)
    ib = torch.arange(nb, device=dev)

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
    mutual_a = (nn_ba[nn_ab] == ia) & src_mask & tgt_mask[nn_ab]
    mutual_b = (nn_ab[nn_ba] == ib) & tgt_mask & src_mask[nn_ba]
    flag_a_union = src_mask & tgt_mask[nn_ab]
    flag_b_union = tgt_mask & src_mask[nn_ba] & ~mutual_b  # dedup mutuals

    if fallback:
        # starvation fallback (see the JAX package): too few mutual pairs
        # -> the one-directional union plus both sides' second neighbours
        use_union = mutual_a.sum() < crosscheck_min_matches
        flag_a2 = src_mask & tgt_mask[nn_ab2]
        flag_b2 = tgt_mask & src_mask[nn_ba2]
        cand_src0 = torch.cat([ia, nn_ba, ia, nn_ba2])
        cand_tgt0 = torch.cat([nn_ab, ib, nn_ab2, ib])
        zeros_u = torch.zeros(na + nb, dtype=torch.bool, device=dev)
        cand_flag = torch.where(
            use_union,
            torch.cat([flag_a_union, flag_b_union, flag_a2, flag_b2]),
            torch.cat([mutual_a, torch.zeros_like(ib, dtype=torch.bool),
                       zeros_u]))
        cand_q0 = torch.cat([d2_ab, d2_ba, d2_ab2, d2_ba2])
    elif use_crosscheck:
        cand_src0, cand_tgt0, cand_flag = ia, nn_ab, mutual_a
        cand_q0 = d2_ab
    else:
        cand_src0 = torch.cat([ia, nn_ba])
        cand_tgt0 = torch.cat([nn_ab, ib])
        cand_flag = torch.cat([flag_a_union, flag_b_union])
        cand_q0 = torch.cat([d2_ab, d2_ba])

    n_cand = cand_src0.shape[0]
    packed_st0 = (cand_src0 << _IDX_BITS) + cand_tgt0

    # one quality sort: best descriptor distance first (d2 >= 0, so its
    # f32 bit pattern orders like the value), invalid last, ties by the
    # packed pair id — the JAX package's two-key sort as one int64 key
    qbits0 = torch.clamp(cand_q0, min=0.0).to(torch.float32).contiguous() \
        .view(torch.int32).long()
    qkey0 = torch.where(cand_flag, qbits0, _INT32_MAX)
    packed_st = torch.sort((qkey0 << 32) | packed_st0).values & 0xFFFFFFFF
    ncorr = cand_flag.sum()

    # tuple test + compaction on a static quality-ordered prefix
    tt = min(n_cand, max(2 * capacity, 2048))
    packed_tt = packed_st[:tt]
    ic_t = torch.arange(tt, device=dev)
    ncorr_t = torch.clamp(ncorr, max=tt)
    cand_pos = ic_t < ncorr_t
    cand_src = packed_tt >> _IDX_BITS
    cand_tgt = packed_tt & ((1 << _IDX_BITS) - 1)

    keep = cand_pos
    if use_tuple_test:
        cs3 = src_xyz.T[:, cand_src]
        ct3 = tgt_xyz.T[:, cand_tgt]
        tuple_keep = tuple_test_keep(tuple(cs3), tuple(ct3), cand_pos,
                                     ncorr_t, tuple_scale=tuple_scale,
                                     trials_per_corr=trials_per_corr,
                                     seed=seed)
        keep = torch.where(tuple_keep.sum() >= tuple_min_keep, tuple_keep,
                           cand_pos)

    # final compaction: kept pairs first, in quality order
    poskey = torch.where(keep, ic_t, tt + ic_t)
    packed_sel = packed_tt[torch.sort(poskey, stable=True).indices]
    kcount = keep.sum()
    if tt >= capacity:
        sel = packed_sel[:capacity]
    else:
        sel = torch.cat([packed_sel, packed_sel.new_zeros(capacity - tt)])
    out_mask = torch.arange(capacity, device=dev) < torch.clamp(kcount,
                                                               max=capacity)
    s_idx = torch.where(out_mask, sel >> _IDX_BITS, 0)
    t_idx = torch.where(out_mask, sel & ((1 << _IDX_BITS) - 1), 0)
    s_xyz = torch.where(out_mask[:, None], src_xyz[s_idx], 0.0)
    t_xyz = torch.where(out_mask[:, None], tgt_xyz[t_idx], 0.0)
    return Correspondences(s_idx.to(torch.int32), t_idx.to(torch.int32),
                           out_mask, s_xyz, t_xyz)
