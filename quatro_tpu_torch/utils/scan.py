"""Prefix sums in the JAX package's addition order.

f32 prefix sums feed differences (voxel centroids, COTE's consensus
costs), so their rounding decides results the port compares slot by slot
with the JAX package. XLA's CPU backend adds a prefix sum in blocks of 16
(running sums inside each block, block totals prefix-summed the same way,
then each block's exclusive carry added); ``prefix_sum`` repeats that
order, which torch.cumsum (float64 accumulation on the CPU, another order
on the card) does not.
"""

from __future__ import annotations

import torch

BLOCK = 16


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """f32 running sum along the last axis, one addition at a time
    (torch.cumsum accumulates in float64 on the CPU)."""
    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, dim=-1)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along the last axis, in the order XLA
    adds it: running sums inside blocks of 16, the block totals
    prefix-summed the same way recursively, then each block's exclusive
    carry added to it. Bit-identical to ``jnp.cumsum`` on the JAX
    package's CPU backend (tests/test_torch_frontend_prep.py). On the
    level_a VLP-16 scan it keeps the voxel centroids within 7.6e-6 m of
    the JAX package's (torch.cumsum: 2.9e-4 m)."""
    n = x.shape[-1]
    if n <= BLOCK:
        return _sequential_cumsum(x)
    pad = (-n) % BLOCK
    rows = torch.nn.functional.pad(x, (0, pad)).reshape(
        *x.shape[:-1], -1, BLOCK)
    inner = _sequential_cumsum(rows)
    carry = prefix_sum(inner[..., -1])
    excl = torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]],
                     dim=-1)
    return (inner + excl[..., None]).reshape(*x.shape[:-1], -1)[..., :n]
