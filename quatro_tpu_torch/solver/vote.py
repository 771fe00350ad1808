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

On the card the vote is four launches (``ops/vote.py``): the histogram's
entries, B2, the yaw modes with the translation vote's candidates, and
the distinct greedy (one more with several yaw modes); on the CPU the
same seams run their plain versions.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.segment import segment_sums
from quatro_tpu_torch.ops.vote import (gate_sizes, vote_entries,
                                       vote_translation)
from quatro_tpu_torch.solver.clique import top_distinct_cliques
from quatro_tpu_torch.utils.batch import drop_axis


def yaw_vote_entries(src, tgt, mask, adj, num_anchors: int = 64,
                     num_bins: int = 256, min_baseline: float = 1.0,
                     max_weight_baseline: float = 10.0):
    """The yaw histogram's entries: ids (M*N,) int32 in [0, num_bins]
    (num_bins = dropped) and vals (3, M*N) f32 = (w, w sin, w cos) of the
    edges against the top-degree anchors; with a leading pair axis, ids
    (B, M*N) and vals (B, 3, M*N) (``ops.vote.vote_entries``)."""
    return vote_entries(src, tgt, mask, adj, num_anchors, num_bins,
                        min_baseline, max_weight_baseline)


def pair_segment_sums(ids: torch.Tensor, vals: torch.Tensor,
                      num_bins: int) -> torch.Tensor:
    """Each pair's histogram of (B, E) ids in [0, num_bins) and (B, K, E)
    values, as ONE call of B2 with its pair axis: (B, num_bins, K), row b
    bit for bit ``segment_sums(ids[b], vals[b], num_bins)``."""
    return segment_sums(ids.contiguous(), vals.contiguous(), num_bins)


def _scales(scale, bsz: int, like: torch.Tensor) -> torch.Tensor:
    """(B,) f32 scales on the clouds' device."""
    return torch.as_tensor(scale, dtype=like.dtype, device=like.device
                           ).expand(bsz).contiguous()


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
    ids, vals = vote_entries(src, tgt, mask, adj, num_anchors, num_bins,
                             min_baseline, max_weight_baseline)
    hist = pair_segment_sums(ids, vals, num_bins)   # (B, bins, 3)
    yaws, _ = vote_translation(hist, None, src, tgt, mask, None, num_modes,
                               want_masks=False)
    return yaws[:, 0] if num_modes == 1 else yaws


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
    bsz = mask.shape[0]
    yaw = torch.as_tensor(yaw, dtype=src.dtype, device=src.device
                          ).reshape(bsz, 1).contiguous()
    _, cand = vote_translation(None, yaw, src, tgt, mask,
                               _scales(scale, bsz, src), 1, num_hyps, bin_m,
                               refine_scale, min_votes)
    masks, sizes = top_distinct_cliques(cand[:, 0], num_hyps)
    return masks, gate_sizes(sizes, min_votes)


def vote_hypotheses(src, tgt, mask, adj, scale, num_hyps: int, bin_m: float,
                    num_anchors: int = 64, num_bins: int = 256,
                    num_yaw_modes: int = 1):
    """(num_hyps, N) vote support masks and (num_hyps,) sizes, or one row
    of each per pair for a batch (B, N, 3), every pair's histogram in one
    B2 call. With num_yaw_modes > 1 the translation modes of every yaw
    mode compete in one deduplicated ranking for the num_hyps slots (each
    mode's own distinct greedy first, all modes' in one call)."""
    if mask.dim() == 1:
        return drop_axis(vote_hypotheses(
            src[None], tgt[None], mask[None], adj[None],
            torch.as_tensor(scale)[None], num_hyps, bin_m, num_anchors,
            num_bins, num_yaw_modes))
    bsz, n = mask.shape
    ids, vals = vote_entries(src, tgt, mask, adj, num_anchors, num_bins)
    hist = pair_segment_sums(ids, vals, num_bins)   # (B, bins, 3)
    _, cand = vote_translation(hist, None, src, tgt, mask,
                               _scales(scale, bsz, src), num_yaw_modes,
                               num_hyps, bin_m)
    if num_yaw_modes == 1:
        masks, sizes = top_distinct_cliques(cand[:, 0], num_hyps)
        return masks, gate_sizes(sizes, 2)
    per_mode, _ = top_distinct_cliques(cand.flatten(0, 1), num_hyps)
    masks, sizes = top_distinct_cliques(
        per_mode.reshape(bsz, -1, n), num_hyps)
    return masks, gate_sizes(sizes, 2)
