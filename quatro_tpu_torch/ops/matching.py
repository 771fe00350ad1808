"""Descriptor matching: mutual-NN + cross-check + tuple test.

PyTorch counterpart of ``quatro_tpu/ops/matching.py`` (the reference's
``teaser::Matcher``, src/teaser_utils/feature_matcher.cc:77-265). Same
candidate sets, the same quality sort, the same host-drawn tuple-test
shifts and the same compaction, so the correspondence set equals the JAX
package's slot for slot on the same descriptors. Nearest neighbours come
from the top-2 kernel (ops/frontend.py::nearest_neighbors2) where the
starvation fallback needs second neighbours, else from the 1-NN kernel
(ops/frontend.py::nearest_neighbors), as the JAX package dispatches; the
candidates' sort keys and the tuple test with the compaction are the two
kernels of ``ops/match_kernels.py`` around one ``torch.sort``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.device import resolve_device, to_tensor
from quatro_tpu_torch.ops.frontend import (nearest_neighbors,
                                           nearest_neighbors2,
                                           neighbor_operands)
from quatro_tpu_torch.ops.match_kernels import (  # noqa: F401
    IDX_BITS, FALLBACK, candidate_mode, match_candidates, tuple_compact,
    tuple_shifts, tuple_test_keep)
from quatro_tpu_torch.ops.neighbors import pairwise_sq_dists
from quatro_tpu_torch.utils.batch import drop_axis


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


def neighbors_both_ways(src_desc, tgt_desc, src_mask, tgt_mask, top2: bool):
    """The matcher's two searches, source in target and target in source,
    each one launch of B7 (``top2``) or B6 for the batch, with the
    operands the two share formed once (``neighbor_operands``). Returns
    the two directions' outputs as the kernels write them, before the
    wrappers' fill of empty rows (``match_candidates`` applies it):
    ((i1, d1[, i2, d2]) of the source rows, the same of the target
    rows), indices int32."""
    search = nearest_neighbors2 if top2 else nearest_neighbors
    ops_ab, ops_ba = neighbor_operands(src_desc, tgt_desc, src_mask,
                                       tgt_mask)
    return (search(src_desc, tgt_desc, src_mask, tgt_mask, operands=ops_ab,
                   fill=False),
            search(tgt_desc, src_desc, tgt_mask, src_mask, operands=ops_ba,
                   fill=False))


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
    na, nb = src_mask.shape[-1], tgt_mask.shape[-1]
    if max(na, nb) > (1 << IDX_BITS):
        raise ValueError(f"candidate packing supports {1 << IDX_BITS} "
                         f"keypoints, got {max(na, nb)}")
    mode = candidate_mode(use_crosscheck, crosscheck_min_matches)
    nn_ab, nn_ba = neighbors_both_ways(src_desc, tgt_desc, src_mask,
                                       tgt_mask, top2=mode == FALLBACK)
    if mode != FALLBACK:
        nn_ab, nn_ba = (*nn_ab, None, None), (*nn_ba, None, None)
    keys, ncorr = match_candidates(
        nn_ab[0], nn_ab[1], nn_ba[0], nn_ba[1], nn_ab[2], nn_ab[3],
        nn_ba[2], nn_ba[3], src_mask, tgt_mask, mode,
        crosscheck_min_matches)
    # one quality sort: best descriptor distance first, invalid last, ties
    # by the packed pair id (the JAX package's two-key lax.sort)
    keys = torch.sort(keys, dim=-1).values
    # tuple test + compaction on a static quality-ordered prefix
    tt = min(keys.shape[-1], max(2 * capacity, 2048))
    return Correspondences(*tuple_compact(
        keys, ncorr, src_xyz, tgt_xyz, tt, capacity, use_tuple_test,
        tuple_scale, trials_per_corr, seed, tuple_min_keep))
