"""Translation-invariant-measurement (TIM) consistency graph.

PyTorch counterpart of ``quatro_tpu/solver/scale.py``. With the pipeline's
fixed scale = 1 the reference's two-sided length-ratio test
(include/quatro.hpp:355-386) reduces to

    | d_tgt(i,j) - d_src(i,j) | <= beta,      beta = 2*noise_bound*sqrt(cbar2)

so the graph is one dense (N, N) boolean adjacency.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.kernels import consistency_graph


def tim_consistency_graph(src: torch.Tensor, tgt: torch.Tensor,
                          mask: torch.Tensor, noise_bound: float,
                          cbar2: float = 1.0,
                          use_pallas=None) -> torch.Tensor:
    """Boolean (N, N) adjacency of scale-consistent correspondence pairs
    (the reference's scale_inliers_mask_ + Graph::addEdge,
    include/quatro.hpp:361-385,784-789, specialised to scale = 1).

    use_pallas (SolverConfig.use_pallas_graph): on the card, None and True
    run the B1 kernel at any N and False raises ValueError (the plain graph
    runs on the CPU only). On the CPU every value computes the plain form,
    which is the kernel's plain version (ops/kernels.py).
    """
    if use_pallas is False and src.device.type == "cuda":
        raise ValueError("use_pallas_graph=False selects the plain "
                         "consistency graph, which runs on the CPU only; on "
                         "the card the graph is the kernel")
    n = src.shape[0]
    beta = 2.0 * float(noise_bound) * float(cbar2) ** 0.5
    consistent = consistency_graph(src, tgt, beta)
    pair_valid = mask[:, None] & mask[None, :]
    off_diag = ~torch.eye(n, dtype=torch.bool, device=src.device)
    return consistent & pair_valid & off_diag
