"""Place recognition: Scan Context descriptors.

PyTorch counterpart of ``quatro_tpu/ops/scancontext.py`` (Kim & Kim,
IROS'18), the front end that lets ``sequence.run_sequence`` find
loop-closure candidates from the scans alone:

- descriptor: a polar max-height image over (range ring, azimuth sector),
  one ``scatter_reduce("amax")`` over n_rings * n_sectors + 1 cells (the
  last takes the invalid points);
- yaw invariance: the column-cosine similarity maximised over all sector
  shifts of the query, every shift in one ``einsum``;
- retrieval: a rotation-invariant ring key (occupancy per ring) prunes the
  earlier frames by L1 distance, then the shifted-cosine distance ranks
  the survivors.

Ring and sector follow the JAX package's compiled arithmetic, since the
synthetic lidar puts every 15th column exactly on a sector edge: the range
is the correctly rounded square root of a single-rounding multiply-add
(``utils/fused.py``), and XLA folds ``/ max_range * n_rings`` and
``/ (2 pi) * n_sectors`` into one multiplication by an f32 constant each,
which the port does too. The arctangent is ``utils/fused.atan2``: the C
library's f32 atan2f (fdlibm), which XLA's CPU code calls, written out in
torch operations, so the card's cells equal the CPU's and the CPU's the
JAX package's. The f64 arctangent rounded once to f32 would agree between
the devices too, but it is an ulp away from atan2f on 36-80 edge points
of each synthetic scan, which then change sector; CUDA's f32 arctangent
moved 126 / 130 points of the level_a scans.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from quatro_tpu_torch.utils import fused


def scan_context_cells(points: torch.Tensor, mask: torch.Tensor,
                       n_rings: int = 20, n_sectors: int = 120,
                       max_range: float = 80.0) -> torch.Tensor:
    """(N,) int64 cell of each point, ring * n_sectors + sector, and
    n_rings * n_sectors for masked points and points beyond max_range."""
    x, y = points[:, 0], points[:, 1]
    r = fused.sqrt(fused.fma(x, x, y * y))
    ring_scale = fused.f32(fused.f32(n_rings) / fused.f32(max_range))
    sector_scale = fused.f32(fused.f32(n_sectors) / fused.f32(2 * math.pi))
    ring = torch.clamp((r * ring_scale).to(torch.int64), 0, n_rings - 1)
    sector = torch.clamp(((fused.atan2(y, x) + fused.f32(math.pi))
                          * sector_scale).to(torch.int64), 0, n_sectors - 1)
    return torch.where(mask & (r <= max_range), ring * n_sectors + sector,
                       n_rings * n_sectors)


def scan_context_from_cells(points: torch.Tensor, cell: torch.Tensor,
                            n_rings: int = 20, n_sectors: int = 120,
                            min_height: float = -2.0) -> torch.Tensor:
    """The descriptor of points already assigned to cells: the max of
    z - min_height per cell, 0 where a cell is empty."""
    cells = n_rings * n_sectors
    h = torch.where(cell < cells, points[:, 2] - fused.f32(min_height),
                    -torch.inf)
    img = torch.full((cells + 1,), -torch.inf, dtype=points.dtype,
                     device=points.device)
    img = img.scatter_reduce(0, cell, h, reduce="amax")
    return torch.clamp(img[:-1], min=0.0).reshape(n_rings, n_sectors)


def scan_context(points: torch.Tensor, mask: torch.Tensor,
                 n_rings: int = 20, n_sectors: int = 120,
                 max_range: float = 80.0,
                 min_height: float = -2.0) -> torch.Tensor:
    """(n_rings, n_sectors) max-height polar descriptor of one scan
    (points (N, 3), mask (N,)), on the points' device.

    Heights are sensor-relative, offset so that empty cells sit at 0 and
    occupied cells are positive (the original's 'no return' value)."""
    cell = scan_context_cells(points, mask, n_rings, n_sectors, max_range)
    return scan_context_from_cells(points, cell, n_rings, n_sectors,
                                   min_height)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """(..., n_rings) rotation-invariant occupancy ratio per ring: the
    exact count times the f32 reciprocal of the sector count, as XLA
    compiles ``jnp.mean``."""
    occupied = (desc > 0).sum(-1).to(desc.dtype)
    return occupied * fused.f32(1.0 / desc.shape[-1])


def _shifted(query: torch.Tensor) -> torch.Tensor:
    """(S, R, S): every circular sector shift of the query, shift k being
    ``roll(query, k, axis=-1)``."""
    s = query.shape[-1]
    ar = torch.arange(s, device=query.device)
    return query[:, (ar[None, :] - ar[:, None]) % s].permute(1, 0, 2)


def _sc_distances(query: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """(C,) yaw-invariant distances of the query (R, S) to candidates
    (C, R, S); all shifts of all candidates in one einsum."""
    shifts = _shifted(query)                              # (S, R, S)
    num = torch.einsum("krs,crs->cks", shifts, cands)     # (C, S, S)
    qn = torch.linalg.vector_norm(shifts, dim=-2)         # (S, S)
    cn = torch.linalg.vector_norm(cands, dim=-2)          # (C, S)
    denom = torch.clamp(qn[None] * cn[:, None], min=1e-9)
    # columns where either side is empty carry no evidence
    on = (qn > 0)[None] & (cn > 0)[:, None]
    cos = torch.where(on, num / denom, 0.0)
    n_on = torch.clamp(on.sum(-1), min=1).to(cos.dtype)
    sim = cos.sum(-1) / n_on                              # (C, S)
    return 1.0 - sim.amax(-1)


def sc_distance(query: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Yaw-invariant Scan Context distance in [0, 1] (0 = same place): the
    column-wise cosine distance, minimised over all sector shifts of the
    query."""
    return _sc_distances(query, cand[None])[0]


def _best_earlier_match(descs, keys, j: int, pool: int, ring_prune: int):
    """(best index, best distance) among frames < pool for query frame j,
    as 0-d tensors. The candidate pool is masked, not sliced, as in the JAX
    package: the ``ring_prune`` nearest ring keys, ties to the lower index
    (a stable sort, as ``lax.top_k``), and the first minimum of the
    distances."""
    m = keys.shape[0]
    in_pool = torch.arange(m, device=keys.device) < pool
    kd = torch.where(in_pool, (keys - keys[j]).abs().sum(-1), torch.inf)
    idx = torch.sort(kd, stable=True).indices[:ring_prune]
    dists = torch.where(in_pool[idx], _sc_distances(descs[j], descs[idx]),
                        torch.inf)
    best = torch.argmin(dists)
    return idx[best], dists[best]


def detect_loop_candidates(descs: torch.Tensor, min_gap: int = 3,
                           max_distance: float = 0.5,
                           ring_prune: int = 10) -> List[Tuple[int, int]]:
    """Loop-closure candidate pairs (i, j), i < j with j - i > min_gap,
    from (M, R, S) descriptors: for each frame j, prune the earlier frames
    by ring-key L1 distance to ``ring_prune`` survivors, score those with
    the shifted-cosine distance, and keep the best if it is within
    ``max_distance``. A host loop over the frames with one read back each
    (the best index and its distance together)."""
    m = descs.shape[0]
    keys = ring_key(descs)                               # (M, R)
    prune = min(ring_prune, max(m - min_gap - 1, 1))
    out: List[Tuple[int, int]] = []
    for j in range(min_gap + 1, m):
        i, d = _best_earlier_match(descs, keys, j, j - min_gap, prune)
        i, d = torch.stack([i.double(), d.double()]).tolist()
        if d <= max_distance:
            out.append((int(i), j))
    return out
