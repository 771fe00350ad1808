"""Translation-invariant-measurement (TIM) consistency graph.

PyTorch counterpart of ``quatro_tpu/solver/scale.py``. With the pipeline's
fixed scale = 1 the reference's two-sided length-ratio test
(include/quatro.hpp:355-386) reduces to

    | d_tgt(i,j) - d_src(i,j) | <= beta,      beta = 2*noise_bound*sqrt(cbar2)

so the graph is one dense (N, N) boolean adjacency.
"""

from __future__ import annotations

import math

import torch


def pairwise_distances(points: torch.Tensor) -> torch.Tensor:
    """Dense Euclidean distance matrix for (N, 3) points, in the exact
    broadcast-difference form (the Gram identity loses ~1e-3 to
    cancellation, which would blur the +-beta test)."""
    d = [points[:, None, k] - points[None, :, k] for k in range(3)]
    return torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


def tim_consistency_graph(src: torch.Tensor, tgt: torch.Tensor,
                          mask: torch.Tensor, noise_bound: float,
                          cbar2: float = 1.0,
                          use_pallas=None) -> torch.Tensor:
    """Boolean (N, N) adjacency of scale-consistent correspondence pairs
    (the reference's scale_inliers_mask_ + Graph::addEdge,
    include/quatro.hpp:361-385,784-789, specialised to scale = 1).

    use_pallas: the consistency-graph kernel (B1) arrives with slice 2 of
    the port; None and False run the plain form here.
    """
    if use_pallas:
        raise NotImplementedError(
            "the consistency-graph kernel (B1) is ported in slice 2; "
            "use SolverConfig(use_pallas_graph=False)")
    n = src.shape[0]
    beta = 2.0 * noise_bound * math.sqrt(cbar2)
    beta = torch.tensor(beta, dtype=src.dtype, device=src.device)
    consistent = torch.abs(pairwise_distances(tgt)
                           - pairwise_distances(src)) <= beta
    pair_valid = mask[:, None] & mask[None, :]
    off_diag = ~torch.eye(n, dtype=torch.bool, device=src.device)
    return consistent & pair_valid & off_diag
