"""Patchwork ground segmentation over the Concentric Zone Model.

PyTorch counterpart of ``quatro_tpu/preprocessing/patchwork.py`` (the
reference's ``PatchWork::estimate_ground``, include/patchwork.hpp:329-476):
per-point CZM patch ids, a (patch, z-bin) histogram for the seed heights,
``num_iter`` plane fits per patch (one fused kernel each; all but the
last in a ``fori`` device loop, utils/loops.py), the uprightness /
elevation / flatness gates, and one classification pass.
The three N-sized passes are the kernels of ``ops/segment.py``:
``cross_histogram`` (B8), ``fit_iteration_moments`` (B9) and
``classify_points`` (B10); the arithmetic around them is the three
kernels of ``ops/czm.py``: ``czm_points`` (the per-point binning and
channels), ``seed_heights`` (the seed table from B8's histogram) and
``plane_fit`` (each fit's planes from B9's sums, the gates on the last).
Only the decoding of B10's codes is left to torch.

Every function takes a leading batch axis (the pipeline runs source and
target as one batch of two); ``estimate_ground`` also takes one cloud.
Moments use patch-relative x/y (offsets from each patch's static CZM
centre) to keep the raw-moment covariance centred.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.config import PatchworkConfig
# czm_bin, the per-point CZM binning, is public here too
from quatro_tpu_torch.ops.czm import (  # noqa: F401
    Z_BINS, _pad128, _patch_tables, czm_bin, czm_points, plane_fit,
    seed_heights)
from quatro_tpu_torch.ops.segment import (classify_points, cross_histogram,
                                          fit_iteration_moments)
from quatro_tpu_torch.utils import loops


class PatchworkResult(NamedTuple):
    ground: torch.Tensor          # (B, N) bool
    nonground: torch.Tensor       # (B, N) bool
    dropped: torch.Tensor         # (B, N) bool: outside the CZM or a skipped patch
    patch_normal: torch.Tensor    # (B, P, 3) fitted plane normals
    patch_accepted: torch.Tensor  # (B, P) gate decision per patch
    reverted: torch.Tensor        # (B, N) bool, subset of ground
    rejected: torch.Tensor        # (B, N) bool, subset of nonground


def _fit_trip(consts, tab, cfg: PatchworkConfig, p_pad: int, exact: bool,
              patch_live=None):
    """One plane-fit iteration of ``estimate_ground``: the members under
    the delivery table ``tab`` summed by patch (B9), then each patch's
    plane (``plane_fit``): the next table, or on the exact last fit (with
    ``patch_live``) the planes, gates and classification table."""
    pid, chan, ptab = consts
    s = fit_iteration_moments(pid, chan, tab, p_pad, cfg.num_patches,
                              exact=exact)
    return plane_fit(s, ptab, cfg, final=patch_live is not None,
                     patch_live=patch_live)


def estimate_ground(points, mask, cfg: PatchworkConfig = PatchworkConfig()
                    ) -> PatchworkResult:
    """Full Patchwork pass on (B, N, 3) points and (B, N) masks (or one
    cloud (N, 3), (N,); the result then has no batch axis)."""
    batched = points.dim() == 3
    if not batched:
        points, mask = points[None], mask[None]
    p_cnt = cfg.num_patches
    p_pad = _pad128(p_cnt + 1)

    # per point: CZM patch ids, the channels, the seed stage's z-bins
    pid, zb, chan, weights, b0 = czm_points(points.contiguous(),
                                            mask.contiguous(), cfg)
    ptab = _patch_tables(cfg, points.device)

    # --- seed stage: margin-anchored (patch, z-bin) histogram (B8) --------
    hist = cross_histogram(pid, zb, weights, p_pad, Z_BINS)
    # seed membership: z < seed height + th_seeds (the CPU's histogram is
    # a view)
    _, patch_live, tab = seed_heights(hist.contiguous(), b0, cfg)

    # --- iterative plane fit: one fused kernel per iteration (B9) ---------
    # (include/patchwork.hpp:545-586; covariance on patch-relative offsets)
    # The intermediate iterations only decide the next membership: bf16
    # moments, a fori device loop over the delivery table (CUDA graphs on
    # the card). The last is exact and feeds the covariance gates: it runs
    # after the loop, so the bf16 / exact switch stays out of the graph.
    consts = (pid, chan, ptab)

    def body(consts, state):
        return (_fit_trip(consts, state[0], cfg, p_pad, exact=False),)

    (tab,) = loops.fori("patchwork_fit", body, consts, (tab,),
                        cfg.num_iter - 1, cfg.num_iter - 1)
    # the gates folded into the last table's flags (patchwork.hpp:394-451)
    n1, n2, n3, _, _, _, tab, accepted = _fit_trip(
        consts, tab, cfg, p_pad, exact=True, patch_live=patch_live)

    # --- one int32 code per point (B10) ----------------------------------
    code = classify_points(pid, chan, tab, p_pad, p_cnt)
    ground = (code & 1) > 0
    nonground = (code & 2) > 0
    res = PatchworkResult(ground, nonground, mask & ~ground & ~nonground,
                          torch.stack([n1, n2, n3], -1), accepted,
                          (code & 4) > 0, (code & 8) > 0)
    if not batched:
        return PatchworkResult(*(t[0] for t in res))
    return res
