"""Clique-independent pose hypotheses by (yaw, translation) voting.

PyTorch counterpart of ``quatro_tpu/solver/vote.py``: the recovery path
for planar aliasing, where the correct consensus set sits below every
top-K clique.

1. Yaw vote: every consistent edge (i, j) against M top-degree anchors
   implies a yaw, the angle between the XY projections of its two TIMs;
   the edges vote into a circular histogram weighted by baseline length,
   accumulated as (w, w sin, w cos) per bin by the segment-sum kernel
   (B2, ops/segment.py), so the top bin refines to a circular mean.
2. Translation vote: at that yaw each correspondence implies
   t_i = tgt_i - scale R(yaw) src_i, quantised on two half-offset 3-D
   grids; the most occupied bins are re-collected as support masks
   |t_i - mean_bin|_inf <= 1.5 bin and deduplicated like the clique
   hypotheses.

Every function takes one pair or a batch of pairs (a leading axis B),
as vmap gives the JAX package's one.

The numbers are knife-edge (a grid edge, the top bin), so the JAX
package's arithmetic is carried over as it is: the bin formula, the f32
inverse bin, stable sorts, XLA's prefix-sum order for the bin means.
"""

from __future__ import annotations

import math

import torch

from quatro_tpu_torch.ops.segment import segment_sums
from quatro_tpu_torch.solver.clique import _top_k_indices, top_distinct_cliques
from quatro_tpu_torch.utils import fused
from quatro_tpu_torch.utils.batch import drop_axis, gather_rows
from quatro_tpu_torch.utils.scan import prefix_sum
from quatro_tpu_torch.utils.se3 import rotate_points, yaw_to_rotation

_QBITS = 10                     # translation grid: 10 bits per axis
_QHALF = 1 << (_QBITS - 1)
_SENTINEL = (1 << 31) - 1       # int32 max: the JAX package's sort sentinel
_RANK_BITS = 12                 # occupancy rank key: (count, position)
_RANK_MAX = (1 << _RANK_BITS) - 1


def yaw_vote_entries(src, tgt, mask, adj, num_anchors: int = 64,
                     num_bins: int = 256, min_baseline: float = 1.0,
                     max_weight_baseline: float = 10.0):
    """The yaw histogram's entries: ids (M*N,) int32 in [0, num_bins]
    (num_bins = dropped) and vals (3, M*N) f32 = (w, w sin, w cos) of the
    edges against the top-degree anchors; with a leading pair axis, ids
    (B, M*N) and vals (B, 3, M*N)."""
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


def pair_segment_sums(ids: torch.Tensor, vals: torch.Tensor,
                      num_bins: int) -> torch.Tensor:
    """Each pair's histogram of (B, E) ids in [0, num_bins) and (B, K, E)
    values, as ONE call of B2 with its pair axis: (B, num_bins, K), row b
    bit for bit ``segment_sums(ids[b], vals[b], num_bins)``."""
    return segment_sums(ids.contiguous(), vals.contiguous(), num_bins)


def yaw_vote(src, tgt, mask, adj, num_anchors: int = 64,
             num_bins: int = 256, min_baseline: float = 1.0,
             max_weight_baseline: float = 10.0, num_modes: int = 1):
    """Modal yaw (radians, a 0-d tensor) implied by the consistency graph's
    edges, or (num_modes,) yaws, each further mode taken outside a +-2-bin
    exclusion zone of the earlier ones; with a leading pair axis, one row
    per pair. The histograms are always the B2 wrapper's (its plain
    version on the CPU, the function of the JAX package's fallback), one
    call for every pair (``pair_segment_sums``)."""
    if mask.dim() == 1:
        return drop_axis(yaw_vote(src[None], tgt[None], mask[None],
                                  adj[None], num_anchors, num_bins,
                                  min_baseline, max_weight_baseline,
                                  num_modes))
    ids, vals = yaw_vote_entries(src, tgt, mask, adj, num_anchors, num_bins,
                                 min_baseline, max_weight_baseline)
    hist = pair_segment_sums(ids, vals, num_bins)   # (B, bins, 3)
    votes = hist[..., 0]
    # circular +-1 neighbourhood so a mode straddling a bin edge still wins
    smooth = votes + torch.roll(votes, 1, -1) + torch.roll(votes, -1, -1)

    def refine(b):
        nb = torch.stack([b, (b + 1) % num_bins, (b - 1) % num_bins], -1)
        w = gather_rows(hist, nb)                   # (B, 3, 3)
        window = w[..., 0, :] + w[..., 1, :] + w[..., 2, :]
        return torch.atan2(window[..., 1], window[..., 2])  # circular mean

    if num_modes == 1:
        return refine(torch.argmax(smooth, -1))
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


def translation_vote_masks(src, tgt, mask, yaw, scale, num_hyps: int,
                           bin_m: float, refine_scale: float = 1.5,
                           min_votes: int = 2):
    """Top ``num_hyps`` distinct translation modes at the given yaw:
    ((num_hyps, N) bool support masks, (num_hyps,) f32 re-collected
    sizes), or one row of each per pair for a batch (B, N, 3) with yaws
    and scales (B,); slots beyond the distinct modes found have size 0.
    Raises ValueError past 2048 correspondences, where the 12-bit position
    of the occupancy rank key would clamp."""
    if mask.dim() == 1:
        return drop_axis(translation_vote_masks(
            src[None], tgt[None], mask[None], torch.as_tensor(yaw)[None],
            torch.as_tensor(scale)[None], num_hyps, bin_m, refine_scale,
            min_votes))
    dtype, dev = src.dtype, src.device
    bsz, n = mask.shape
    m2 = 2 * n
    if m2 > 1 << _RANK_BITS:
        raise ValueError(
            f"translation vote supports up to 2048 correspondences (got "
            f"{n}); the occupancy rank key packs positions in 12 bits")
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
    cand_masks = close & mask[:, None, :] & got[:, :, None]
    masks, sizes = top_distinct_cliques(cand_masks, num_hyps)
    return masks, torch.where(sizes >= min_votes, sizes, 0.0)


def vote_hypotheses(src, tgt, mask, adj, scale, num_hyps: int, bin_m: float,
                    num_anchors: int = 64, num_bins: int = 256,
                    num_yaw_modes: int = 1):
    """(num_hyps, N) vote support masks and (num_hyps,) sizes, or one row
    of each per pair for a batch (B, N, 3), every pair's histogram in one
    B2 call. With num_yaw_modes > 1 the translation modes of every yaw
    mode compete in one deduplicated ranking for the num_hyps slots."""
    if mask.dim() == 1:
        return drop_axis(vote_hypotheses(
            src[None], tgt[None], mask[None], adj[None],
            torch.as_tensor(scale)[None], num_hyps, bin_m, num_anchors,
            num_bins, num_yaw_modes))
    if num_yaw_modes == 1:
        yaw = yaw_vote(src, tgt, mask, adj, num_anchors=num_anchors,
                       num_bins=num_bins)
        return translation_vote_masks(src, tgt, mask, yaw, scale, num_hyps,
                                      bin_m)
    yaws = yaw_vote(src, tgt, mask, adj, num_anchors=num_anchors,
                    num_bins=num_bins, num_modes=num_yaw_modes)
    cand = torch.cat([translation_vote_masks(src, tgt, mask, yaws[:, i],
                                             scale, num_hyps, bin_m)[0]
                      for i in range(num_yaw_modes)], 1)
    masks, sizes = top_distinct_cliques(cand, num_hyps)
    return masks, torch.where(sizes >= 2, sizes, 0.0)
