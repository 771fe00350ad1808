"""Translation-invariant-measurement (TIM) consistency graph and the TLS
scale.

PyTorch counterpart of ``quatro_tpu/solver/scale.py``. With the pipeline's
fixed scale = 1 the reference's two-sided length-ratio test
(include/quatro.hpp:355-386) reduces to

    | d_tgt(i,j) - d_src(i,j) | <= beta,      beta = 2*noise_bound*sqrt(cbar2)

so the graph is one dense (N, N) boolean adjacency. ``solve_scale_tls``
(``estimate_scaling``) estimates the scale instead and tests each pair's
length ratio against it; ``solve_scale`` is the reference's identity
scale. ``pairwise_distances`` is ops/kernels.py's, re-exported here where
the JAX package defines it.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.kernels import consistency_graph, pairwise_distances
from quatro_tpu_torch.solver.translation import _estimate_axis_ranges


def tim_consistency_graph(src: torch.Tensor, tgt: torch.Tensor,
                          mask: torch.Tensor, noise_bound: float,
                          cbar2: float = 1.0,
                          use_pallas=None) -> torch.Tensor:
    """Boolean (..., N, N) adjacency of scale-consistent correspondence
    pairs (the reference's scale_inliers_mask_ + Graph::addEdge,
    include/quatro.hpp:361-385,784-789, specialised to scale = 1); src,
    tgt (N, 3) or a batch of pairs (B, N, 3), the batch in one B1 launch.

    use_pallas (SolverConfig.use_pallas_graph): on the card, None and True
    run the B1 kernel at any N and False raises ValueError (the plain graph
    runs on the CPU only). On the CPU every value computes the plain form,
    which is the kernel's plain version (ops/kernels.py).
    """
    if use_pallas is False and src.device.type == "cuda":
        raise ValueError("use_pallas_graph=False selects the plain "
                         "consistency graph, which runs on the CPU only; on "
                         "the card the graph is the kernel")
    n = src.shape[-2]
    beta = 2.0 * float(noise_bound) * float(cbar2) ** 0.5
    consistent = consistency_graph(src.contiguous(), tgt.contiguous(), beta)
    pair_valid = mask[..., :, None] & mask[..., None, :]
    off_diag = ~torch.eye(n, dtype=torch.bool, device=src.device)
    return consistent & pair_valid & off_diag


def solve_scale(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """The reference's scale solver: identity scale
    (include/quatro.hpp:361)."""
    return torch.ones((), dtype=src.dtype, device=src.device)


def solve_scale_tls(src: torch.Tensor, tgt: torch.Tensor, mask: torch.Tensor,
                    noise_bound: float, cbar2: float = 1.0):
    """TLS consensus scale over the pairwise length ratios (the
    TEASER++-style scale stage; the reference's ``estimate_scaling`` is
    inert, include/quatro.hpp:361). Each pair i < j of valid, distinct
    points measures s_ij = d_tgt / d_src with the bound beta / d_src, and
    COTE's sorted-endpoint sweep takes the consensus over the N^2
    flattened pairs. src, tgt (..., N, 3). Returns (scale (...), inlier
    adjacency (..., N, N) bool: pairs whose ratio lies within their bound
    of the scale)."""
    dtype, dev = src.dtype, src.device
    n = src.shape[-2]
    beta = (torch.full((), 2.0 * noise_bound, dtype=dtype, device=dev)
            * torch.sqrt(torch.full((), cbar2, dtype=dtype, device=dev)))
    d_src = pairwise_distances(src)
    d_tgt = pairwise_distances(tgt)
    pair_valid = (mask[..., :, None] & mask[..., None, :]
                  & torch.ones((n, n), dtype=torch.bool, device=dev).triu(1)
                  & (d_src > 1e-6))
    d_src_c = torch.clamp(d_src, min=1e-6)
    ratios = d_tgt / d_src_c
    alphas = beta / d_src_c
    lead = src.shape[:-2]
    flat_valid = pair_valid.reshape(*lead, n * n)
    scale = _estimate_axis_ranges(
        torch.where(flat_valid, ratios.reshape(*lead, n * n), 0.0),
        torch.where(flat_valid, alphas.reshape(*lead, n * n), 1.0),
        flat_valid)
    off_diag = ~torch.eye(n, dtype=torch.bool, device=dev)
    inliers = ((torch.abs(ratios - scale[..., None, None]) <= alphas)
               & mask[..., :, None] & mask[..., None, :] & off_diag)
    return scale, inliers
