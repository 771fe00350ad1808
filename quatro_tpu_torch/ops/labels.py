"""The range-image labelling's min-label sweep.

One sweep of ``preprocessing/projection.label_components`` (the sweep of
``quatro_tpu/preprocessing/projection.py:203``, which XLA fuses into loop
fusions inside the labelling's ``lax.while_loop``; no Pallas kernel
there), for a batch of images. ``label_sweep`` launches
``csrc/label_sweep.cu`` for CUDA tensors and counts the launch; for CPU
tensors it runs ``label_sweep_plain``, the JAX package's roll-doubling in
torch operations. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.launch import LAUNCHES, check, launch, same_device


def roll_image(t: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """t shifted so that out[r, c] = t[r + dr, c + dc], both axes wrapping
    (jnp.roll(t, (-dr, -dc)) over the image axes)."""
    return torch.roll(t, shifts=(-dr, -dc), dims=(-2, -1))


def label_sweep_plain(labels: torch.Tensor, e: torch.Tensor, dr: int,
                      dc: int, steps: int, npix: int) -> torch.Tensor:
    """Min-label roll-doubling sweep along (dr, dc) over the edges ``e``.
    Wrapped contributions across the row boundary are masked: a gate that
    would cross it contains an edge the labelling's edge masks zeroed
    there."""
    best = torch.where(e, torch.minimum(labels, roll_image(labels, dr, dc)),
                       labels)
    gate = e
    s = 1
    for _ in range(steps - 1):
        cand = roll_image(best, dr * s, dc * s)
        best = torch.minimum(best, torch.where(gate, cand, npix))
        gate = gate & roll_image(gate, dr * s, dc * s)
        s *= 2
    return best


def label_sweep(labels: torch.Tensor, edges: torch.Tensor, dr: int, dc: int,
                steps: int, npix: int) -> torch.Tensor:
    """One sweep of (B, R, C) int32 labels along (dr, dc) over the (B, R,
    C) bool edges, ``steps`` doubling steps (reach 2^(steps - 1)); both
    contiguous. One launch of csrc/label_sweep.cu for CUDA tensors, bit
    for bit ``label_sweep_plain``; that plain version for CPU tensors."""
    if labels.dim() != 3:
        raise ValueError(f"labels: expected (B, R, C), got "
                         f"{tuple(labels.shape)}")
    bsz, rows, cols = labels.shape
    check("labels", labels, (bsz, rows, cols), torch.int32)
    check("edges", edges, (bsz, rows, cols), torch.bool)
    if not 1 <= steps <= 40:
        raise ValueError(f"steps must lie in [1, 40], got {steps}")
    if same_device(labels, edges).type != "cuda":
        return label_sweep_plain(labels, edges, dr, dc, steps, npix)
    out = torch.empty_like(labels)
    if labels.numel() == 0:
        return out
    launch("label_sweep", labels, edges, bsz, rows, cols, int(dr), int(dc),
           int(steps), int(npix), out)
    LAUNCHES["label_sweep"] += 1
    return out
