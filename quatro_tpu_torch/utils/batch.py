"""The pair axis: rows of batched results.

The solver and the pipeline take a leading axis of B pairs, as the JAX
package's ``jax.vmap`` gives its functions one; a single pair runs as
B = 1. These helpers take a row of, or stack, the results: tensors,
tuples, NamedTuples and dataclasses of them (``None`` and other values
pass through unchanged).
"""

from __future__ import annotations

import dataclasses

import torch


def take_row(out, b):
    """Row ``b`` of every tensor in ``out``."""
    if torch.is_tensor(out):
        return out[b]
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        return dataclasses.replace(out, **{
            f.name: take_row(getattr(out, f.name), b)
            for f in dataclasses.fields(out)})
    if isinstance(out, tuple):
        rows = [take_row(v, b) for v in out]
        return type(out)(*rows) if hasattr(out, "_fields") else tuple(rows)
    return out


def drop_axis(out):
    """``out`` of a call at B = 1 without its pair axis."""
    return take_row(out, 0)


def stack_rows(rows):
    """Results of one structure stacked along a new leading axis."""
    first = rows[0]
    if torch.is_tensor(first):
        return torch.stack(rows)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: stack_rows([getattr(r, f.name) for r in rows])
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        cols = [stack_rows(list(c)) for c in zip(*rows)]
        return type(first)(*cols) if hasattr(first, "_fields") \
            else tuple(cols)
    if first is None:
        return None
    return rows


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, i]] over the second-to-last axis: x (..., N, C), idx
    (..., M) -> (..., M, C); the batched form of ``x[idx]``."""
    return x.gather(-2, idx[..., None].expand(*idx.shape, x.shape[-1]))
