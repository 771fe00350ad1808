"""Component-wise translation estimation (COTE).

PyTorch counterpart of ``quatro_tpu/solver/translation.py`` (reference:
include/quatro.hpp:585-747). The reference's serial sweep over 2N sorted
interval endpoints is a prefix sum: sort the events once, prefix-sum the
epsilon-weighted series, evaluate the cost at every centre and take the
argmin. All three axes run at once along a leading axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quatro_tpu_torch.utils.scan import prefix_sum


class CoteResult(NamedTuple):
    translation: torch.Tensor    # (3,)
    inlier_mask: torch.Tensor    # (N,) inlier on ALL axes (quatro.hpp:606-614)


def _estimate_axis(x: torch.Tensor, beta: torch.Tensor, mask: torch.Tensor,
                   use_median: bool):
    """Truncated-LS consensus estimate per row of x (A, N), with the same
    noise bound ``beta`` for every correspondence — the pipeline's case
    (the reference passes constant alphas, include/quatro.hpp:600-604), in
    which the reference's six running series collapse to three.
    Port of Quatro::estimate (include/quatro.hpp:618-747) with static
    shapes: masked correspondences are zero-weight events sorted last.
    Returns (estimates (A,), inliers (A, N))."""
    dtype, dev = x.dtype, x.device
    a, n = x.shape
    maskf = mask.to(dtype).expand(a, n)
    big = torch.finfo(dtype).max

    # 2N events: interval entries (+1) at x - beta, exits (-1) at x + beta
    values = torch.cat([x - beta, x + beta], dim=1)
    eps = torch.cat([maskf, -maskf], dim=1)
    src_idx = torch.cat([torch.arange(n, device=dev)] * 2)
    values = torch.where(eps != 0, values, big)
    order = torch.sort(values, dim=1, stable=True).indices
    eps_s = eps.gather(1, order)
    idx_s = src_idx[order]
    x_s = torch.cat([x, x], dim=1).gather(1, order) * torch.abs(eps_s)
    cs3 = prefix_sum(torch.stack([eps_s, eps_s * x_s,
                                  eps_s * x_s * x_s], dim=1))
    card, sum_x, sum_x2 = cs3[:, 0], cs3[:, 1], cs3[:, 2]
    total = maskf.sum(1, keepdim=True)
    inv_b2 = 1.0 / torch.clamp(beta * beta, min=1e-30)
    dot_w = card * inv_b2
    dot_xw = sum_x * inv_b2
    range_rem = beta * (total - card)

    x_hat = dot_xw / torch.where(dot_w == 0, 1.0, dot_w)
    cost = card * x_hat * x_hat + sum_x2 - 2.0 * sum_x * x_hat + range_rem
    valid_center = (card > 0.5) & (eps_s != 0)
    cost = torch.where(valid_center, cost, big)
    min_idx = torch.argmin(cost, dim=1)
    estimate = x_hat.gather(1, min_idx[:, None])[:, 0]

    if use_median:
        # reference median mode (quatro.hpp:714-730), including its
        # even-parity formula for odd counts
        n_card = card.gather(1, min_idx[:, None])[:, 0].to(torch.int64)
        j = torch.arange(n, device=dev)[None, :]
        back = min_idx[:, None] - j
        pos = torch.clamp(back, 0, 2 * n - 1)
        valid_j = (j < n_card[:, None]) & (back >= 0)
        cand = torch.where(valid_j, x.gather(1, idx_s.gather(1, pos)), big)
        cand = torch.sort(cand, dim=1).values
        lo = torch.clamp(n_card // 2 - 1, 0, n - 1)
        hi = torch.clamp(n_card // 2, 0, n - 1)
        median = 0.5 * (cand.gather(1, lo[:, None])[:, 0]
                        + cand.gather(1, hi[:, None])[:, 0])
        median = torch.where(n_card == 1, cand[:, 0], median)
        estimate = torch.where(n_card > 0, median, estimate)

    inliers = (torch.abs(x - estimate[:, None]) <= beta) & mask
    return estimate, inliers


def solve_translation(src: torch.Tensor, dst: torch.Tensor,
                      mask: torch.Tensor, noise_bound: float,
                      cbar2: float = 1.0, use_median: bool = True) -> CoteResult:
    """COTE over all three axes (reference: include/quatro.hpp:585-615).
    src is already scale * R @ src; the per-axis values are dst - src."""
    dtype = src.dtype
    beta = (torch.tensor(noise_bound, dtype=dtype, device=src.device)
            * torch.sqrt(torch.tensor(cbar2, dtype=dtype, device=src.device)))
    est, inl = _estimate_axis((dst - src).T, beta, mask, use_median)
    return CoteResult(est, inl.all(dim=0) & mask)
