"""Component-wise translation estimation (COTE).

PyTorch counterpart of ``quatro_tpu/solver/translation.py`` (reference:
include/quatro.hpp:585-747). The reference's serial sweep over 2N sorted
interval endpoints is a prefix sum: sort the events once, prefix-sum the
epsilon-weighted series, evaluate the cost at every centre and take the
argmin. All three axes run at once along a leading axis. With one noise
bound for every value (the pipeline's case) COTE is the polish's COTE
kernel on the card and ops/polish.py's ``cote_axis_plain`` on the CPU;
this module keeps the general branch, a bound a value (the TLS scale's).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.ops.polish import (cote_translation,
                                         cote_translation_plain)
from quatro_tpu_torch.utils.scan import prefix_sum


class CoteResult(NamedTuple):
    translation: torch.Tensor    # (..., 3)
    inlier_mask: torch.Tensor    # (..., N) inlier on ALL axes (quatro.hpp:606-614)


def _estimate_axis_ranges(x: torch.Tensor, ranges: torch.Tensor,
                          mask: torch.Tensor):
    """Quatro::estimate (include/quatro.hpp:618-747) with a noise bound
    of its own for every value (the JAX package's general branch, which
    the TLS scale takes), without the median mode: x, ranges, mask
    (..., N). Returns the estimates (...)."""
    dtype, dev = x.dtype, x.device
    n = x.shape[-1]
    maskf = mask.to(dtype)
    big = torch.finfo(dtype).max
    values = torch.cat([x - ranges, x + ranges], -1)
    eps = torch.cat([maskf, -maskf], -1)
    values = torch.where(eps != 0, values, big)            # masked last
    order = torch.sort(values, dim=-1, stable=True).indices
    eps_s = eps.gather(-1, order)
    idx_s = torch.cat([torch.arange(n, device=dev)] * 2)[order]
    x_s = x.gather(-1, idx_s) * torch.abs(eps_s)
    rng_s = ranges.gather(-1, idx_s) * torch.abs(eps_s)
    w_s = torch.where(mask, 1.0 / torch.clamp(ranges * ranges, min=1e-30),
                      0.0).gather(-1, idx_s)
    card, dot_w, dot_xw, sum_x, sum_x2, rng_c = prefix_sum(torch.stack(
        [eps_s, eps_s * w_s, eps_s * w_s * x_s, eps_s * x_s,
         eps_s * x_s * x_s, eps_s * rng_s], -2)).unbind(-2)
    # `ranges_inverse_sum` (sic) starts at sum(ranges) and drops by each
    # event's range (quatro.hpp:652,696)
    range_rem = torch.where(mask, ranges, 0.0).sum(-1, keepdim=True) - rng_c
    x_hat = dot_xw / torch.where(dot_w == 0, 1.0, dot_w)
    cost = card * x_hat * x_hat + sum_x2 - 2.0 * sum_x * x_hat + range_rem
    cost = torch.where((card > 0.5) & (eps_s != 0), cost, big)
    return x_hat.gather(-1, torch.argmin(cost, -1, keepdim=True))[..., 0]


def solve_translation(src: torch.Tensor, dst: torch.Tensor,
                      mask: torch.Tensor, noise_bound: float,
                      cbar2: float = 1.0, use_median: bool = True) -> CoteResult:
    """COTE over all three axes (reference: include/quatro.hpp:585-615);
    src, dst (..., N, 3), mask (..., N), every row on its own. src is
    already scale * R @ src; the per-axis values are dst - src. On the card
    one launch of the polish's COTE kernel (ops/polish.cote_translation);
    on the CPU its plain version, ``solve_translation_plain``."""
    return CoteResult(*cote_translation(src, dst, mask, noise_bound, cbar2,
                                        use_median))


def solve_translation_plain(src: torch.Tensor, dst: torch.Tensor,
                            mask: torch.Tensor, noise_bound: float,
                            cbar2: float = 1.0,
                            use_median: bool = True) -> CoteResult:
    """``solve_translation`` in torch operations on any device
    (ops/polish.cote_translation_plain: the three axes' rows through
    ``cote_axis_plain``)."""
    return CoteResult(*cote_translation_plain(src, dst, mask, noise_bound,
                                              cbar2, use_median))
