"""The matcher's candidate keys, tuple test and compaction as two kernels.

The JAX package's ``match_features`` (quatro_tpu/ops/matching.py:230-333)
is one compiled program with no Pallas kernel in it: XLA fuses the
candidate assembly, runs the shift-structured tuple test as a
``lax.scan`` of 100 trials and the compaction as a second sort. The port
runs, around the neighbour kernels (B6 / B7) and one ``torch.sort``:

- ``match_candidates``: from both directions' neighbours (before the
  wrappers' fill of empty rows, which it applies itself) and the masks,
  every candidate's int64 sort key ``(quality bits << 32) | (src << 15 |
  tgt)`` and each pair's candidate count ``ncorr``, under the three
  branches of the matcher: the starvation fallback's four blocks [ia,
  nn_ba, ia, nn_ba2] (the union decided per pair on its mutual count),
  crosscheck's one block, the union's two (csrc/match_candidates.cu, a
  block a pair);
- ``tuple_compact``: on the quality-ordered prefix of ``tt`` sorted keys,
  the tuple test's trials, the ``tuple_min_keep`` gate, the stable
  partition of the kept candidates first, the cut to ``capacity`` and
  the index split and coordinate gathers, written as the five
  ``Correspondences`` tensors (csrc/tuple_test.cu, a block a pair).

For CUDA tensors a wrapper checks its inputs, launches on the current
stream and counts the launch in ``LAUNCHES``; for CPU tensors it runs its
plain version (``*_plain``: the torch code the matcher ran before, the
JAX package's arithmetic). There is no fallback between the two. On the
card the kernels equal their plain versions bit for bit: the keys and the
partition are exact integer work, and every length of the tuple test
rounds each product, sum and square root once, as the torch operations
do there (a division by the Python scalar ``tuple_scale`` is, on the
card, the product with its f32 reciprocal).
"""

from __future__ import annotations

import numpy as np
import torch

from quatro_tpu_torch.ops.launch import LAUNCHES, check, launch, same_device
from quatro_tpu_torch.utils import fused
from quatro_tpu_torch.utils.batch import gather_rows

IDX_BITS = 15                     # candidate packing: (src << 15) | tgt
_INT32_MAX = (1 << 31) - 1
_FLT_MAX = torch.finfo(torch.float32).max
# the candidate branches of match_features, as the kernel numbers them
FALLBACK, CROSSCHECK, UNION = 0, 1, 2
TUPLE_SMEM_MAX = 200 * 1024       # above: the pair's workspace in memory


def candidate_mode(use_crosscheck: bool, crosscheck_min_matches: int) -> int:
    """The branch of ``match_features`` that a configuration takes."""
    if use_crosscheck and crosscheck_min_matches > 0:
        return FALLBACK
    return CROSSCHECK if use_crosscheck else UNION


def candidate_count(mode: int, na: int, nb: int) -> int:
    """Candidates per pair of a branch."""
    return {FALLBACK: 2 * (na + nb), CROSSCHECK: na, UNION: na + nb}[mode]


# ----------------------------------------------------------- candidates --

def _filled(idx, d2, mask):
    """The neighbour wrappers' fill: index 0 / f32 max for invalid rows and
    for slots no valid column filled (pallas_frontend.py:590-594); the
    index int64 for indexing."""
    empty = ~mask | (d2 >= _FLT_MAX)
    return torch.where(empty, 0, idx).long(), torch.where(empty, _FLT_MAX, d2)


def match_candidates_plain(i_ab, d_ab, i_ba, d_ba, i_ab2, d_ab2, i_ba2, d_ba2,
                           src_mask, tgt_mask, mode: int,
                           crosscheck_min_matches: int):
    """``match_candidates`` in torch operations (quatro_tpu/ops/matching.py:
    230-285 and the int64 form of its two-key sort's key)."""
    bsz, na = src_mask.shape
    nb = tgt_mask.shape[-1]
    dev = src_mask.device
    ia = torch.arange(na, device=dev).expand(bsz, na)
    ib = torch.arange(nb, device=dev).expand(bsz, nb)
    nn_ab, d2_ab = _filled(i_ab, d_ab, src_mask)
    nn_ba, d2_ba = _filled(i_ba, d_ba, tgt_mask)
    mutual_a = ((nn_ba.gather(-1, nn_ab) == ia) & src_mask
                & tgt_mask.gather(-1, nn_ab))
    mutual_b = ((nn_ab.gather(-1, nn_ba) == ib) & tgt_mask
                & src_mask.gather(-1, nn_ba))
    flag_a_union = src_mask & tgt_mask.gather(-1, nn_ab)
    flag_b_union = tgt_mask & src_mask.gather(-1, nn_ba) & ~mutual_b  # dedup

    if mode == FALLBACK:
        # starvation fallback (see the JAX package): too few mutual pairs
        # -> the one-directional union plus both sides' second neighbours,
        # decided per pair
        nn_ab2, d2_ab2 = _filled(i_ab2, d_ab2, src_mask)
        nn_ba2, d2_ba2 = _filled(i_ba2, d_ba2, tgt_mask)
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
    elif mode == CROSSCHECK:
        cand_src0, cand_tgt0, cand_flag = ia, nn_ab, mutual_a
        cand_q0 = d2_ab
    else:
        cand_src0 = torch.cat([ia, nn_ba], -1)
        cand_tgt0 = torch.cat([nn_ab, ib], -1)
        cand_flag = torch.cat([flag_a_union, flag_b_union], -1)
        cand_q0 = torch.cat([d2_ab, d2_ba], -1)

    packed_st0 = (cand_src0 << IDX_BITS) + cand_tgt0
    # best descriptor distance first (d2 >= 0, so its f32 bit pattern
    # orders like the value), invalid last, ties by the packed pair id:
    # the JAX package's two-key sort as one int64 key
    qbits0 = torch.clamp(cand_q0, min=0.0).to(torch.float32).contiguous() \
        .view(torch.int32).long()
    qkey0 = torch.where(cand_flag, qbits0, _INT32_MAX)
    return ((qkey0 << 32) | packed_st0,
            cand_flag.sum(-1).to(torch.int32))


def match_candidates(i_ab, d_ab, i_ba, d_ba, i_ab2, d_ab2, i_ba2, d_ba2,
                     src_mask, tgt_mask, mode: int,
                     crosscheck_min_matches: int):
    """The matcher's candidates of a batch of pairs as sort keys.

    i_ab, d_ab (B, Na) int32 / f32: each source row's nearest target and
    its squared descriptor distance, i_ba, d_ba (B, Nb) the reverse, as
    the neighbour kernels return them before their wrappers' fill (filled
    ones do as well: the fill is applied again and changes nothing); the
    second neighbours i_ab2 ... d_ba2 under ``FALLBACK``, else None;
    src_mask (B, Na), tgt_mask (B, Nb) bool. ``mode``: ``FALLBACK``,
    ``CROSSCHECK`` or ``UNION`` (``candidate_mode``).

    Returns keys (B, n_cand) int64 = (quality << 32) | (src << 15 | tgt),
    the quality the f32 bits of max(d2, 0) for a candidate and 2^31 - 1
    for a slot that is none, and ncorr (B,) int32, the candidates of each
    pair. For CUDA tensors one launch of csrc/match_candidates.cu; for CPU
    tensors ``match_candidates_plain``."""
    second = (i_ab2, d_ab2, i_ba2, d_ba2)
    if mode == FALLBACK and any(t is None for t in second):
        raise ValueError("the fallback branch takes the second neighbours")
    firsts = (i_ab, d_ab, i_ba, d_ba, src_mask, tgt_mask)
    dev = same_device(*firsts, *(t for t in second if t is not None))
    if dev.type != "cuda":
        return match_candidates_plain(i_ab, d_ab, i_ba, d_ba, i_ab2, d_ab2,
                                      i_ba2, d_ba2, src_mask, tgt_mask,
                                      mode, crosscheck_min_matches)
    bsz, na = src_mask.shape
    nb = tgt_mask.shape[-1]
    if max(na, nb) > (1 << IDX_BITS):
        raise ValueError(f"candidate packing supports {1 << IDX_BITS} "
                         f"keypoints, got {max(na, nb)}")
    for name, t, n, dtype in (("i_ab", i_ab, na, torch.int32),
                              ("d_ab", d_ab, na, torch.float32),
                              ("i_ba", i_ba, nb, torch.int32),
                              ("d_ba", d_ba, nb, torch.float32),
                              ("src_mask", src_mask, na, torch.bool),
                              ("tgt_mask", tgt_mask, nb, torch.bool)):
        check(name, t, (bsz, n), dtype)
    if mode == FALLBACK:
        for name, t, n, dtype in (("i_ab2", i_ab2, na, torch.int32),
                                  ("d_ab2", d_ab2, na, torch.float32),
                                  ("i_ba2", i_ba2, nb, torch.int32),
                                  ("d_ba2", d_ba2, nb, torch.float32)):
            check(name, t, (bsz, n), dtype)
    else:
        second = (0, 0, 0, 0)
    keys = torch.empty((bsz, candidate_count(mode, na, nb)),
                       dtype=torch.int64, device=dev)
    ncorr = torch.empty(bsz, dtype=torch.int32, device=dev)
    if bsz:
        launch("match_candidates", i_ab, d_ab, i_ba, d_ba, *second,
               src_mask, tgt_mask, bsz, na, nb, mode, crosscheck_min_matches,
               keys, ncorr)
        LAUNCHES["match_candidates"] += 1
    return keys, ncorr


# -------------------------------------------------- tuple test, compaction --

def tuple_shifts(n_cand: int, trials_per_corr: int, seed: int) -> np.ndarray:
    """(T, 2) shift pairs of the shift-structured tuple test, drawn on the
    host exactly as quatro_tpu/ops/matching.py::tuple_test_keep draws
    them, so both packages test the same triples."""
    host_rng = np.random.default_rng(seed)
    shifts = np.unique(
        host_rng.integers(1, max(n_cand - 1, 2),
                          size=(4 * trials_per_corr, 2)), axis=0)
    return shifts[shifts[:, 0] != shifts[:, 1]][:trials_per_corr]


_SHIFTS: dict = {}


def device_shifts(tt: int, trials_per_corr: int, seed: int,
                  device: torch.device) -> torch.Tensor:
    """``tuple_shifts`` as a (T, 2) int32 tensor on ``device``, uploaded
    once per (tt, trials, seed, device)."""
    key = (tt, trials_per_corr, seed, str(device))
    t = _SHIFTS.get(key)
    if t is None:
        t = _SHIFTS[key] = torch.as_tensor(
            tuple_shifts(tt, trials_per_corr, seed).astype(np.int32),
            device=device).reshape(-1, 2).contiguous()
    return t


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


def tuple_compact_plain(keys, ncorr, src_xyz, tgt_xyz, tt: int,
                        capacity: int, use_tuple_test: bool = True,
                        tuple_scale: float = 0.95,
                        trials_per_corr: int = 100, seed: int = 0,
                        tuple_min_keep: int = 8):
    """``tuple_compact`` in torch operations (quatro_tpu/ops/matching.py:
    295-333)."""
    bsz = keys.shape[0]
    dev = keys.device
    packed_tt = keys[:, :tt] & 0xFFFFFFFF
    ic_t = torch.arange(tt, device=dev)
    ncorr_t = torch.clamp(ncorr, max=tt)
    cand_pos = ic_t < ncorr_t[:, None]
    cand_src = packed_tt >> IDX_BITS
    cand_tgt = packed_tt & ((1 << IDX_BITS) - 1)

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
    s_idx = torch.where(out_mask, sel >> IDX_BITS, 0)
    t_idx = torch.where(out_mask, sel & ((1 << IDX_BITS) - 1), 0)
    s_xyz = torch.where(out_mask[..., None], gather_rows(src_xyz, s_idx), 0.0)
    t_xyz = torch.where(out_mask[..., None], gather_rows(tgt_xyz, t_idx), 0.0)
    return (s_idx.to(torch.int32), t_idx.to(torch.int32), out_mask, s_xyz,
            t_xyz)


def tuple_workspace(tt: int) -> int:
    """Bytes of a pair's tuple-test workspace (a candidate of the prefix:
    6 coordinates, the packed pair and a keep byte, the keep bytes in
    whole words): in shared memory up to ``TUPLE_SMEM_MAX``, else in
    device memory."""
    return 4 * (7 * tt + -(-tt // 4))


def tuple_compact(keys, ncorr, src_xyz, tgt_xyz, tt: int, capacity: int,
                  use_tuple_test: bool = True, tuple_scale: float = 0.95,
                  trials_per_corr: int = 100, seed: int = 0,
                  tuple_min_keep: int = 8):
    """Tuple test and compaction of a batch of pairs' sorted candidates.

    keys (B, n_cand) int64 sorted along each row (``match_candidates``'
    keys after ``torch.sort``), ncorr (B,) int32 the candidates of each
    pair, src_xyz (B, Na, 3) and tgt_xyz (B, Nb, 3) f32 the keypoints;
    ``tt`` <= n_cand the prefix tested, ``capacity`` the slots kept. With
    ``use_tuple_test``, the shift-structured test of
    ``tuple_test_keep`` (shifts ``tuple_shifts(tt, trials_per_corr,
    seed)``) on the first min(ncorr, tt) candidates, whose survivors are
    kept where there are at least ``tuple_min_keep`` of them and all the
    candidates otherwise; without, all the candidates. Returns (src_idx,
    tgt_idx (B, capacity) int32, mask (B, capacity) bool, src_xyz, tgt_xyz
    (B, capacity, 3) f32): the kept candidates first in quality order, cut
    to capacity, zeros past them. For CUDA tensors one launch of
    csrc/tuple_test.cu; for CPU tensors ``tuple_compact_plain``."""
    dev = same_device(keys, ncorr, src_xyz, tgt_xyz)
    if dev.type != "cuda":
        return tuple_compact_plain(keys, ncorr, src_xyz, tgt_xyz, tt,
                                   capacity, use_tuple_test, tuple_scale,
                                   trials_per_corr, seed, tuple_min_keep)
    bsz, n_cand = keys.shape
    na, nb = src_xyz.shape[1], tgt_xyz.shape[1]
    check("keys", keys, (bsz, n_cand), torch.int64)
    check("ncorr", ncorr, (bsz,), torch.int32)
    check("src_xyz", src_xyz, (bsz, na, 3))
    check("tgt_xyz", tgt_xyz, (bsz, nb, 3))
    if not 0 < tt <= n_cand:
        raise ValueError(f"tuple_compact: prefix {tt} of {n_cand} keys")
    outs = (torch.empty((bsz, capacity), dtype=torch.int32, device=dev),
            torch.empty((bsz, capacity), dtype=torch.int32, device=dev),
            torch.empty((bsz, capacity), dtype=torch.bool, device=dev),
            torch.empty((bsz, capacity, 3), dtype=torch.float32, device=dev),
            torch.empty((bsz, capacity, 3), dtype=torch.float32, device=dev))
    if bsz == 0 or capacity == 0:
        return outs
    shifts, trials = 0, 0
    if use_tuple_test:
        shifts = device_shifts(tt, trials_per_corr, seed, dev)
        trials = shifts.shape[0]
    work = 0
    if tuple_workspace(tt) > TUPLE_SMEM_MAX:
        work = torch.empty(bsz * tuple_workspace(tt) // 4,
                           dtype=torch.float32, device=dev)
    scale = np.float32(tuple_scale)
    launch("tuple_test", keys, ncorr, src_xyz, tgt_xyz, shifts, work,
           bsz, n_cand, na, nb, tt, capacity, trials,
           int(use_tuple_test), float(scale), fused.recip(tuple_scale),
           tuple_min_keep, *outs)
    LAUNCHES["tuple_compact"] += 1
    return outs
