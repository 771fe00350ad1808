"""The (yaw, translation) vote around B2 as two kernels.

The JAX package runs ``vote_hypotheses`` as one ``jax.jit`` traced into the
solver's (``quatro_tpu/solver/vote.py:65-251``; no Pallas kernel of its
own): XLA fuses the yaw histogram's entries, the smoothing and refine,
the translation grids and the runs around one ``segment_sums`` call (B2)
and two ``lax.sort``s. The port runs the vote as B2 between two launches
(``solver/vote.py`` composes them):

- ``vote_entries``: the histogram's ids (B, M N) int32 and values (B, 3,
  M N) f32, B2's layout (csrc/vote.cu, a thread-block cluster of 8 CTAs
  a pair): the degrees of ``adj & mask & mask^T`` and the M top-degree
  anchors in ``torch.sort(descending, stable)`` order (each row's rank
  among the pair's keys, shared through distributed shared memory), then
  per (anchor, j) the angle, the baseline gate, the weight and the bin;
- ``vote_translation``: from B2's histograms (B, bins, 3) or given yaws,
  each yaw mode (the smoothed votes' first maximum outside the earlier
  modes' exclusion zones, the refine's circular mean) and, at each mode,
  the translation vote's candidate masks (B, modes, cand, N) bool: the
  implied translations on two half-offset grids, the stable sort of the
  2N keys, the runs and their occupancy ranking, the chosen runs' means
  in XLA's prefix order and the support masks (a block a (pair, mode)).
  The candidates then go to ``ops.cliques.distinct_cliques``.

For CUDA tensors a wrapper checks its inputs, launches on the current
stream and counts the launch in ``LAUNCHES``; for CPU tensors it runs its
plain version (``*_plain``, the torch code the vote ran before, split at
these seams). There is no fallback between the two, and the kernels equal
their plain versions on the card bit for bit: every product, sum and
quotient rounds once as its torch operation does there, ``torch.atan2``,
``cos`` and ``sin`` are the card's ``atan2f``, ``cosf`` and ``sinf``, and
the sorts are stable sorts of (key, index).

Limits on the card: N <= 4096 for the entries (the keys in shared
memory) and 2N <= 4096 for the translation masks (the JAX package's own
limit of the occupancy rank key); past them a ``ValueError``.
"""

from __future__ import annotations

import math

import torch

from quatro_tpu_torch.ops.cliques import _top_k_indices
from quatro_tpu_torch.ops.launch import LAUNCHES, check, launch, same_device
from quatro_tpu_torch.utils import fused
from quatro_tpu_torch.utils.batch import gather_rows
from quatro_tpu_torch.utils.scan import prefix_sum
from quatro_tpu_torch.utils.se3 import rotate_points, yaw_to_rotation

_QBITS = 10                     # translation grid: 10 bits per axis
_QHALF = 1 << (_QBITS - 1)
_SENTINEL = (1 << 31) - 1       # int32 max: the JAX package's sort sentinel
_RANK_BITS = 12                 # occupancy rank key: (count, position)
_RANK_MAX = (1 << _RANK_BITS) - 1
ENTRIES_MAX_POINTS = 4096       # the entries kernel's keys in shared memory
TRANSLATION_MAX_POINTS = 1 << (_RANK_BITS - 1)   # 2N keys in 12 bits


def candidates(num_hyps: int, n: int) -> int:
    """The translation vote's candidate rows a mode: the JAX package's
    ``max(2 num_hyps + 2, num_hyps)``, cut to the 2N rank keys there
    are."""
    return min(max(2 * num_hyps + 2, num_hyps), 2 * n)


# ---------------------------------------------------------------- entries

def vote_entries_plain(src, tgt, mask, adj, num_anchors: int = 64,
                       num_bins: int = 256, min_baseline: float = 1.0,
                       max_weight_baseline: float = 10.0):
    """``vote_entries`` in torch operations: ids (M*N,) int32 in [0,
    num_bins] (num_bins = dropped) and vals (3, M*N) f32 = (w, w sin,
    w cos) of the edges against the top-degree anchors; with a leading
    pair axis, ids (B, M*N) and vals (B, 3, M*N)."""
    adj_m = adj & mask[..., None, :] & mask[..., :, None]
    deg = adj_m.sum(-1)
    anchor_idx = _top_k_indices(torch.where(mask, deg, -1), num_anchors)

    a_src = gather_rows(src, anchor_idx)[..., :2]   # (M, 2)
    a_tgt = gather_rows(tgt, anchor_idx)[..., :2]
    adj_rows = gather_rows(adj_m, anchor_idx)       # (M, N) row gathers

    v0 = src[..., None, :, 0] - a_src[..., 0:1]     # (M, N)
    v1 = src[..., None, :, 1] - a_src[..., 1:2]
    w0 = tgt[..., None, :, 0] - a_tgt[..., 0:1]
    w1 = tgt[..., None, :, 1] - a_tgt[..., 1:2]
    cross = v0 * w1 - v1 * w0
    dot = v0 * w0 + v1 * w1
    ang = torch.atan2(cross, dot)                   # (M, N) in [-pi, pi]
    blen = fused.sqrt(v0 * v0 + v1 * v1)
    wgt = torch.where(adj_rows & (blen > min_baseline),
                      torch.clamp(blen, max=max_weight_baseline), 0.0)

    bins = torch.clamp((ang + math.pi) * (num_bins / (2.0 * math.pi)), 0,
                       num_bins - 1).to(torch.int32)
    lead = mask.shape[:-1]
    ids = torch.where(wgt > 0, bins, num_bins).reshape(*lead, -1)
    # sin/cos from the cross/dot already computed: no extra trig
    norm = torch.clamp(fused.sqrt(cross * cross + dot * dot), min=1e-12)
    vals = torch.stack([wgt, wgt * cross / norm, wgt * dot / norm], -3
                       ).reshape(*lead, 3, -1)
    return ids.to(torch.int32).contiguous(), vals.contiguous()


def vote_entries(src, tgt, mask, adj, num_anchors: int = 64,
                 num_bins: int = 256, min_baseline: float = 1.0,
                 max_weight_baseline: float = 10.0):
    """The yaw histogram's entries of one pair (N, 3) or a batch (B, N, 3)
    (``vote_entries_plain``'s shapes). For CUDA tensors one launch of
    csrc/vote.cu's entries kernel (a cluster a pair; N <= 4096, else
    ValueError), bit for bit ``vote_entries_plain``, which runs for CPU
    tensors."""
    if same_device(src, tgt, mask, adj).type != "cuda":
        return vote_entries_plain(src, tgt, mask, adj, num_anchors, num_bins,
                                  min_baseline, max_weight_baseline)
    if mask.dim() == 1:
        ids, vals = vote_entries(src[None], tgt[None], mask[None], adj[None],
                                 num_anchors, num_bins, min_baseline,
                                 max_weight_baseline)
        return ids[0], vals[0]
    bsz, n = mask.shape
    if n > ENTRIES_MAX_POINTS:
        raise ValueError(f"vote_entries: N = {n} > {ENTRIES_MAX_POINTS} "
                         "correspondences on the card")
    check("src", src, (bsz, n, 3))
    check("tgt", tgt, (bsz, n, 3))
    check("mask", mask, (bsz, n), torch.bool)
    check("adj", adj, (bsz, n, n), torch.bool)
    m = min(int(num_anchors), n)
    dev = src.device
    ids = torch.empty((bsz, m * n), dtype=torch.int32, device=dev)
    vals = torch.empty((bsz, 3, m * n), dtype=torch.float32, device=dev)
    if bsz and n:
        launch("vote", src, tgt, mask, adj, bsz, n, m, int(num_bins),
               fused.f32(min_baseline), fused.f32(max_weight_baseline),
               fused.f32(num_bins / (2.0 * math.pi)),
               int(adj.data_ptr() % 16 == 0), ids, vals)
        LAUNCHES["vote_entries"] += 1
    return ids, vals


# ------------------------------------------------------------ translation

def yaw_modes_plain(hist: torch.Tensor, num_modes: int = 1) -> torch.Tensor:
    """The yaw modes of B2's histograms (B, bins, 3): (B, num_modes) f32,
    each further mode taken outside a +-2-bin exclusion zone of the
    earlier ones; the top bin refined to the circular mean of its +-1
    neighbourhood."""
    num_bins = hist.shape[-2]
    votes = hist[..., 0]
    # circular +-1 neighbourhood so a mode straddling a bin edge still wins
    smooth = votes + torch.roll(votes, 1, -1) + torch.roll(votes, -1, -1)

    def refine(b):
        nb = torch.stack([b, (b + 1) % num_bins, (b - 1) % num_bins], -1)
        w = gather_rows(hist, nb)                   # (B, 3, 3)
        window = w[..., 0, :] + w[..., 1, :] + w[..., 2, :]
        return torch.atan2(window[..., 1], window[..., 2])  # circular mean

    if num_modes == 1:
        return refine(torch.argmax(smooth, -1))[..., None]
    modes = []
    s = smooth
    bins_iota = torch.arange(num_bins, device=hist.device)
    for _ in range(num_modes):
        b = torch.argmax(s, -1)
        modes.append(refine(b))
        d = torch.abs((bins_iota - b[..., None] + num_bins // 2) % num_bins
                      - num_bins // 2)
        s = torch.where(d <= 2, -1.0, s)            # exclusion zone
    return torch.stack(modes, -1)


def translation_keys_plain(src, tgt, mask, yaw, scale, bin_m: float):
    """The implied translations t = tgt - scale R(yaw) src (B, N, 3) of
    clouds (B, N, 3) at yaws and scales (B,), and their keys on both
    half-offset grids (B, 2N) int64 (masked at the sentinel)."""
    dtype, dev = src.dtype, src.device
    bsz = mask.shape[0]
    rot = yaw_to_rotation(yaw).to(dtype)
    scale = torch.as_tensor(scale, dtype=dtype, device=dev).expand(bsz)
    t = tgt - scale[:, None, None] * rotate_points(src, rot)   # (B, N, 3)
    inv_bin = torch.tensor(1.0 / bin_m, dtype=dtype, device=dev)

    def grid_keys(offset):
        q = torch.clamp(torch.floor(t * inv_bin + offset).to(torch.int64)
                        + _QHALF, 0, (1 << _QBITS) - 1)
        return ((q[..., 0] << (2 * _QBITS)) + (q[..., 1] << _QBITS)
                + q[..., 2])

    key = torch.cat([
        torch.where(mask, grid_keys(0.0), _SENTINEL),
        torch.where(mask, grid_keys(0.5) + (1 << (3 * _QBITS)), _SENTINEL)],
        -1)
    return t, key


def translation_candidates_plain(src, tgt, mask, yaw, scale, num_hyps: int,
                                 bin_m: float, refine_scale: float = 1.5,
                                 min_votes: int = 2) -> torch.Tensor:
    """The translation vote's candidate masks at one yaw a pair: (B, cand,
    N) bool for clouds (B, N, 3), yaws and scales (B,): the support
    masks |t_i - mean_bin|_inf <= refine_scale bin_m of the most
    occupied bins of both grids, before the distinct greedy."""
    dtype, dev = src.dtype, src.device
    bsz, n = mask.shape
    m2 = 2 * n
    t, key = translation_keys_plain(src, tgt, mask, yaw, scale, bin_m)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    t_s = gather_rows(torch.cat([t, t], -2), order).transpose(-1, -2)

    pos = torch.arange(m2, device=dev)
    valid_b = key_s != _SENTINEL
    first = torch.ones((bsz, 1), dtype=torch.bool, device=dev)
    is_new = torch.cat([first, key_s[:, 1:] != key_s[:, :-1]], -1) & valid_b
    start_pos = torch.where(is_new, pos, m2)
    run_end = torch.where(torch.cat([is_new[:, 1:], first], -1), pos + 1, m2)
    next_start = torch.cummin(run_end.flip(-1), -1).values.flip(-1)
    run_len = torch.where(is_new, next_start - start_pos, 0)

    # rank bins by occupancy (desc), position tiebreak: a small 2N sort
    cand = max(2 * num_hyps + 2, num_hyps)
    rank_key = torch.where(
        is_new & (run_len >= min_votes),
        ((_RANK_MAX - torch.clamp(run_len, max=_RANK_MAX)) << _RANK_BITS)
        + torch.clamp(pos, max=_RANK_MAX), _SENTINEL)
    rank_s = torch.sort(rank_key, dim=-1).values[:, :cand]
    got = rank_s != _SENTINEL
    starts = torch.where(got, rank_s & _RANK_MAX, 0)
    counts = torch.where(got, run_len.gather(-1, starts), 0)

    cs3 = prefix_sum(t_s)                           # XLA's addition order
    ends = starts + counts

    def at(i):                                      # cs3[:, :, i] per pair
        return cs3.gather(-1, i[:, None, :].expand(bsz, 3, i.shape[-1]))

    hi3 = at(torch.clamp(ends - 1, 0, m2 - 1))
    lo3 = torch.where(starts[:, None, :] > 0,
                      at(torch.clamp(starts - 1, min=0)), 0.0)
    means = ((hi3 - lo3) / torch.clamp(counts, min=1)[:, None, :]
             ).transpose(-1, -2)                    # (B, cand, 3)

    r = torch.tensor(refine_scale * bin_m, dtype=dtype, device=dev)
    close = torch.amax(torch.abs(t[:, None, :, :] - means[:, :, None, :]),
                       dim=-1) <= r                 # (B, cand, N)
    return close & mask[:, None, :] & got[:, :, None]


def _check_translation_size(n: int) -> None:
    if 2 * n > 1 << _RANK_BITS:
        raise ValueError(
            f"translation vote supports up to {TRANSLATION_MAX_POINTS} "
            f"correspondences (got {n}); the occupancy rank key packs "
            "positions in 12 bits")


def vote_translation_plain(hist, yaw, src, tgt, mask, scale,
                           num_modes: int = 1, num_hyps: int = 2,
                           bin_m: float = 1.0, refine_scale: float = 1.5,
                           min_votes: int = 2, want_masks: bool = True):
    """``vote_translation`` in torch operations: the yaws of B2's
    histograms (``yaw_modes_plain``), or the given (B, modes) yaws, and
    at each the candidate masks (``translation_candidates_plain``)."""
    yaws = (yaw_modes_plain(hist, num_modes) if hist is not None
            else yaw.reshape(mask.shape[0], num_modes))
    if not want_masks:
        return yaws, None
    _check_translation_size(mask.shape[-1])
    return yaws, torch.stack([
        translation_candidates_plain(src, tgt, mask, yaws[:, r], scale,
                                     num_hyps, bin_m, refine_scale,
                                     min_votes)
        for r in range(num_modes)], 1)


def vote_translation(hist, yaw, src, tgt, mask, scale, num_modes: int = 1,
                     num_hyps: int = 2, bin_m: float = 1.0,
                     refine_scale: float = 1.5, min_votes: int = 2,
                     want_masks: bool = True):
    """The yaw modes and the translation vote's candidates of a batch of
    pairs: from B2's histograms ``hist`` (B, bins, 3) (``yaw`` None) or
    the given ``yaw`` (B, num_modes) (``hist`` None), clouds (B, N, 3),
    mask (B, N) and scales (B,) -> (yaws (B, num_modes) f32, candidate
    masks (B, num_modes, ``candidates(num_hyps, N)``, N) bool, or None
    without ``want_masks``). For CUDA tensors one launch of csrc/vote.cu's
    translation kernel (a block a (pair, mode)), bit for bit
    ``vote_translation_plain``, which runs for CPU tensors; 2N > 4096
    raises ValueError on both."""
    if same_device(src, tgt, mask).type != "cuda":
        return vote_translation_plain(hist, yaw, src, tgt, mask, scale,
                                      num_modes, num_hyps, bin_m,
                                      refine_scale, min_votes, want_masks)
    bsz, n = mask.shape
    dev = src.device
    if want_masks:
        _check_translation_size(n)
    check("src", src, (bsz, n, 3))
    check("tgt", tgt, (bsz, n, 3))
    check("mask", mask, (bsz, n), torch.bool)
    if hist is not None:
        bins = hist.shape[1]
        check("hist", hist, (bsz, bins, 3))
    else:
        bins = 0
        check("yaw", yaw, (bsz, num_modes))
    if want_masks:
        check("scale", scale, (bsz,))
    cand = candidates(num_hyps, n)
    yaws = torch.empty((bsz, num_modes), dtype=torch.float32, device=dev)
    masks = (torch.empty((bsz, num_modes, cand, n), dtype=torch.bool,
                         device=dev) if want_masks else None)
    if bsz and num_modes:
        launch("vote_translation", hist if hist is not None else 0,
               yaw if yaw is not None else 0, src, tgt, mask,
               scale if want_masks else 0, bsz, n, bins, num_modes, cand,
               int(min_votes), fused.f32(1.0 / bin_m),
               fused.f32(refine_scale * bin_m), int(bool(want_masks)), yaws,
               masks if want_masks else 0)
        LAUNCHES["vote_translation"] += 1
    return yaws, masks


def gate_sizes(sizes: torch.Tensor, min_votes: int) -> torch.Tensor:
    """sizes where sizes >= min_votes, else 0.0, for the distinct greedy's
    f32 counts (whole numbers, never NaN), as one elementwise launch:
    ``torch.where(sizes >= min_votes, sizes, 0.0)``'s values."""
    return torch.nn.functional.threshold(sizes, min_votes - 0.5, 0.0)
