"""Segment sums over a small group axis (B2).

Counterpart of ``segment_sums`` in ``quatro_tpu/ops/segment_matmul.py``:
out[p, k] = sum over i with ids[i] == p of vals[k, i], ids outside
[0, p_pad) dropped. The TPU kernel contracts a one-hot tile on the MXU
because the TPU has no cheap scatter; the CUDA kernel
(``csrc/segment_sums.cu``) sums in shared memory instead, in a fixed
order. ``segment_sums`` launches it for CUDA tensors and counts the
launch; for CPU tensors it runs ``segment_sums_plain``.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.launch import LAUNCHES, check, launch, same_device

SEG_CHUNK = 1024        # entries per block of the kernel's first pass
_PLAIN_ROWS = 8192      # entries per one-hot block of the plain version


def segment_sums_plain(ids: torch.Tensor, vals: torch.Tensor,
                       p_pad: int) -> torch.Tensor:
    """(p_pad, K) f32: the JAX package's off-TPU form, a one-hot
    contraction in full f32 (no TF32), in blocks of 8192 entries so the
    one-hot stays small (p_pad = 640 at N = 131072)."""
    k, n = vals.shape
    bins = torch.arange(p_pad, dtype=ids.dtype, device=ids.device)
    out = vals.new_zeros((p_pad, k))
    for s in range(0, n, _PLAIN_ROWS):
        oh = (ids[s:s + _PLAIN_ROWS, None] == bins[None, :]).to(vals.dtype)
        out += oh.T @ vals[:, s:s + _PLAIN_ROWS].T
    return out


def segment_sums(ids: torch.Tensor, vals: torch.Tensor,
                 p_pad: int) -> torch.Tensor:
    """out[p, k] = sum over i with ids[i] == p of vals[k, i]; ids (N,)
    int32, vals (K, N) f32, any N, K and p_pad; ids outside [0, p_pad)
    are dropped. Returns (p_pad, K) f32. Replaces
    segment_matmul.py::segment_sums (csrc/segment_sums.cu); on the card
    the sums repeat bit for bit from run to run."""
    k, n = vals.shape
    check("ids", ids, (n,), torch.int32)
    check("vals", vals, (k, n))
    if same_device(ids, vals).type != "cuda":
        return segment_sums_plain(ids, vals, p_pad)
    chunks = -(-n // SEG_CHUNK)
    partial = torch.empty((chunks, p_pad, k), dtype=torch.float32,
                          device=vals.device)
    out = torch.empty((p_pad, k), dtype=torch.float32, device=vals.device)
    launch("segment_sums", ids, vals, n, k, p_pad, SEG_CHUNK, partial, out)
    LAUNCHES["segment_sums"] += 1
    return out
