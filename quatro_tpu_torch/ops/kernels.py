"""The solver's consistency-graph kernel (B1).

Counterpart of ``quatro_tpu/ops/pallas_kernels.py``: the (N, N) boolean
test |d_tgt(i,j) - d_src(i,j)| <= beta over all pairs of correspondences,
with no mask or diagonal terms (the caller applies those, as in the JAX
package). ``consistency_graph`` launches ``csrc/consistency_graph.cu`` for
CUDA tensors and counts the launch; for CPU tensors it runs
``consistency_graph_plain``. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.launch import LAUNCHES, check, launch, same_device
from quatro_tpu_torch.utils import fused


def pairwise_distances(points: torch.Tensor) -> torch.Tensor:
    """Dense Euclidean distance matrix for (N, 3) points, in the exact
    broadcast-difference form sqrt((dx*dx + dy*dy) + dz*dz) (the Gram
    identity loses ~1e-3 to cancellation, which would blur the +-beta
    test), the square root correctly rounded as the kernel's (torch's CPU
    sqrt rounds by the host's instruction set, utils/fused.py)."""
    d = [points[:, None, k] - points[None, :, k] for k in range(3)]
    return fused.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


def consistency_graph_plain(src: torch.Tensor, tgt: torch.Tensor,
                            beta: float) -> torch.Tensor:
    """(N, N) bool |d_tgt - d_src| <= beta, beta rounded to f32."""
    beta_t = torch.tensor(beta, dtype=torch.float32, device=src.device)
    return torch.abs(pairwise_distances(tgt)
                     - pairwise_distances(src)) <= beta_t


def consistency_graph(src: torch.Tensor, tgt: torch.Tensor,
                      beta: float) -> torch.Tensor:
    """(N, N) bool consistency test of correspondence pairs; src, tgt
    (N, 3) f32 contiguous, any N. Replaces
    pallas_kernels.py::consistency_graph_pallas (csrc/consistency_graph.cu),
    bit for bit equal to ``consistency_graph_plain``."""
    n = src.shape[0]
    check("src", src, (n, 3))
    check("tgt", tgt, (n, 3))
    if same_device(src, tgt).type != "cuda":
        return consistency_graph_plain(src, tgt, beta)
    out = torch.empty((n, n), dtype=torch.bool, device=src.device)
    if n == 0:
        return out
    launch("consistency_graph", src, tgt, n, float(beta), out)
    LAUNCHES["consistency_graph"] += 1
    return out


def sqrt_rn_mismatches(device="cuda") -> int:
    """The non-negative floats, 0 to +inf, on which the B1 kernel's
    branch-free square root differs from CUDA's __fsqrt_rn (IEEE's) in any
    bit: 0 is the kernel's contract. Runs on the card only."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    launch("sqrt_rn_check", bad)
    return int(bad.item())
