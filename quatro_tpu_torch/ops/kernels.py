"""The solver's kernels: the consistency graph (B1) and the exact clique
search.

Counterpart of ``quatro_tpu/ops/pallas_kernels.py``: the (N, N) boolean
test |d_tgt(i,j) - d_src(i,j)| <= beta over all pairs of correspondences,
for one pair or a batch of pairs (the JAX kernel's grid axis under vmap),
with no mask or diagonal terms (the caller applies those, as in the JAX
package). ``consistency_graph`` launches ``csrc/consistency_graph.cu`` for
CUDA tensors and counts the launch; for CPU tensors it runs
``consistency_graph_plain``. There is no fallback between the two.

``exact_clique`` is the branch-and-bound of
``quatro_tpu/solver/clique.py::exact_max_clique_bb`` (a ``lax.while_loop``
there, no Pallas kernel) on B pairs' restricted graphs: one launch of
``csrc/exact_clique.cu`` for CUDA tensors, ``exact_clique_search_plain``
(the JAX loop's body over the pair axis, a device loop) for CPU tensors.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.launch import LAUNCHES, check, launch, same_device
from quatro_tpu_torch.utils import fused, loops

EXACT_CHUNK = 64        # search steps of the plain version per flag read


def pairwise_distances(points: torch.Tensor) -> torch.Tensor:
    """Dense Euclidean distance matrices for (..., N, 3) points, in the
    exact broadcast-difference form sqrt((dx*dx + dy*dy) + dz*dz) (the
    Gram identity loses ~1e-3 to cancellation, which would blur the
    +-beta test), the square root correctly rounded as the kernel's
    (torch's CPU sqrt rounds by the host's instruction set,
    utils/fused.py)."""
    d = [points[..., :, None, k] - points[..., None, :, k] for k in range(3)]
    return fused.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


def consistency_graph_plain(src: torch.Tensor, tgt: torch.Tensor,
                            beta: float) -> torch.Tensor:
    """(..., N, N) bool |d_tgt - d_src| <= beta, beta rounded to f32."""
    beta_t = torch.tensor(beta, dtype=torch.float32, device=src.device)
    return torch.abs(pairwise_distances(tgt)
                     - pairwise_distances(src)) <= beta_t


def consistency_graph(src: torch.Tensor, tgt: torch.Tensor,
                      beta: float) -> torch.Tensor:
    """(N, N) bool consistency test of correspondence pairs for src, tgt
    (N, 3), or (B, N, N) for a batch of B pairs (B, N, 3) in one launch;
    f32 contiguous, any N. Replaces
    pallas_kernels.py::consistency_graph_pallas (csrc/consistency_graph.cu),
    bit for bit equal to ``consistency_graph_plain``."""
    n = src.shape[-2]
    lead = tuple(src.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"src: expected (N, 3) or (B, N, 3), got "
                         f"{tuple(src.shape)}")
    check("src", src, (*lead, n, 3))
    check("tgt", tgt, (*lead, n, 3))
    if same_device(src, tgt).type != "cuda":
        return consistency_graph_plain(src, tgt, beta)
    out = torch.empty((*lead, n, n), dtype=torch.bool, device=src.device)
    if n == 0 or out.numel() == 0:
        return out
    launch("consistency_graph", src, tgt, n, (lead or (1,))[0], float(beta),
           out)
    LAUNCHES["consistency_graph"] += 1
    return out


def sqrt_rn_mismatches(device="cuda") -> int:
    """The non-negative floats, 0 to +inf, on which the B1 kernel's
    branch-free square root differs from CUDA's __fsqrt_rn (IEEE's) in any
    bit: 0 is the kernel's contract. Runs on the card only."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    launch("sqrt_rn_check", bad)
    return int(bad.item())


def _exact_step(consts, state, max_steps: int):
    """One step of the JAX package's search body on every pair that is
    still searching (quatro_tpu/solver/clique.py:362-380); a pair whose
    stack is empty or whose steps reached ``max_steps`` keeps its state.
    Only the frames below the stack pointer are ever read, so the include
    frame is written only where it is pushed."""
    sub, depth_iota, cap_iota = consts
    p_stk, c_stk, sp, best_size, best_set, steps = state
    live = (sp > 0) & (steps < max_steps)
    sp1 = torch.clamp(sp - 1, min=0)
    at = depth_iota == sp1[:, None]                          # (B, depth)
    idx = sp1[:, None, None].expand(-1, 1, p_stk.shape[-1])
    p = p_stk.gather(1, idx)[:, 0]
    c = c_stk.gather(1, idx)[:, 0]
    csz = c.sum(-1)
    psz = p.sum(-1)
    improved = live & (csz > best_size)
    best_size = torch.where(improved, csz, best_size)
    best_set = torch.where(improved[:, None], c, best_set)
    push = live & (csz + psz > best_size) & (psz > 0)
    v = torch.argmax(p.to(torch.uint8), -1)                  # first in P
    vm = cap_iota == v[:, None]
    row = sub.gather(1, v[:, None, None].expand(-1, 1, sub.shape[-1]))[:, 0]
    ex = (at & push[:, None])[..., None]
    top = ((depth_iota == (sp1 + 1)[:, None]) & push[:, None])[..., None]
    p_stk = torch.where(top, (p & row)[:, None], torch.where(
        ex, (p & ~vm)[:, None], p_stk))
    c_stk = torch.where(top, (c | vm)[:, None], c_stk)
    sp = torch.where(live, torch.where(push, sp1 + 2, sp1), sp)
    return p_stk, c_stk, sp, best_size, best_set, steps + live.to(steps.dtype)


def exact_clique_search_plain(sub: torch.Tensor, vvalid: torch.Tensor,
                              best0: torch.Tensor, max_steps: int):
    """The exact search on B restricted graphs in torch operations:
    (best (B, cap) bool, completed (B,) bool, steps (B,) int32) of
    sub (B, cap, cap), vvalid (B, cap) and incumbent best0 (B, cap) bool.
    The JAX package's ``lax.while_loop`` under vmap: stacks (B, cap + 2,
    cap), a device loop (utils/loops.py) that reads its flag once per
    EXACT_CHUNK steps while any pair is searching."""
    bsz, cap = vvalid.shape
    dev = sub.device
    depth = cap + 2
    p_stk = torch.zeros((bsz, depth, cap), dtype=torch.bool, device=dev)
    p_stk[:, 0] = vvalid
    state = (p_stk, torch.zeros_like(p_stk),
             torch.ones(bsz, dtype=torch.int64, device=dev),
             best0.sum(-1), best0.clone(),
             torch.zeros(bsz, dtype=torch.int32, device=dev))

    def body(consts, state):
        return _exact_step(consts, state, max_steps)

    def searching(state):
        return ((state[2] > 0) & (state[5] < max_steps)).any()

    (_, _, sp, _, best, steps), _ = loops.while_chunks(
        "exact_clique", body, searching,
        (sub, torch.arange(depth, device=dev), torch.arange(cap, device=dev)),
        state, max(max_steps, 0), EXACT_CHUNK)
    return best & vvalid, sp == 0, steps


def exact_clique(sub: torch.Tensor, vvalid: torch.Tensor, best0: torch.Tensor,
                 max_steps: int):
    """The exact clique search on B pairs' restricted graphs sub (B, cap,
    cap), vvalid (B, cap), incumbent best0 (B, cap), all bool and
    contiguous, at most ``max_steps`` steps a pair: (best (B, cap) bool,
    completed (B,) bool, steps (B,) int32). One launch of
    csrc/exact_clique.cu for the B pairs on the card, bit for bit
    ``exact_clique_search_plain``; that plain version on the CPU."""
    if sub.dim() != 3:
        raise ValueError(f"sub: expected (B, cap, cap), got "
                         f"{tuple(sub.shape)}")
    bsz, cap = sub.shape[:2]
    check("sub", sub, (bsz, cap, cap), torch.bool)
    check("vvalid", vvalid, (bsz, cap), torch.bool)
    check("best0", best0, (bsz, cap), torch.bool)
    if same_device(sub, vvalid, best0).type != "cuda":
        return exact_clique_search_plain(sub, vvalid, best0, max_steps)
    dev = sub.device
    best = torch.empty((bsz, cap), dtype=torch.bool, device=dev)
    completed = torch.empty(bsz, dtype=torch.bool, device=dev)
    steps = torch.empty(bsz, dtype=torch.int32, device=dev)
    if bsz == 0:
        return best, completed, steps
    # per pair, in 64-bit words: the adjacency rows, cap + 2 frames of two
    # bitsets, the best set
    scratch = torch.empty(bsz * -(-cap // 64) * (3 * cap + 5),
                          dtype=torch.int64, device=dev)
    launch("exact_clique", sub, vvalid, best0, bsz, cap, int(max_steps),
           scratch, best, completed, steps)
    LAUNCHES["exact_clique"] += 1
    return best, completed, steps
