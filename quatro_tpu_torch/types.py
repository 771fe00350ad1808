"""Core data types: padded point sets and registration solutions.

PyTorch counterpart of ``quatro_tpu/types.py``: one fixed-capacity
``PointBatch`` of ``points (..., N, 3) f32`` + ``mask (..., N) bool``, so
every stage keeps the JAX package's static shapes and slot order and the
two can be compared index by index.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch


@dataclass
class PointBatch:
    """A padded, masked set of 3-D points.

    points: (..., N, 3) float tensor. Padded rows are zero.
    mask:   (..., N) bool tensor; True where the row is a real point.
    """

    points: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> torch.Tensor:
        """Number of valid points (int32)."""
        return self.mask.sum(dim=-1).to(torch.int32)

    @staticmethod
    def from_numpy(xyz: np.ndarray, capacity: Optional[int] = None,
                   device=None) -> "PointBatch":
        """Pack an (M, 3) numpy array into a capacity-N PointBatch.

        Overflow (M > capacity) is truncated — callers pick capacities large
        enough for their sensor (see PipelineConfig). ``device=None`` keeps
        the tensors on the CPU; the pipeline moves them to its device.
        """
        xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
        m = xyz.shape[0]
        n = capacity if capacity is not None else m
        m = min(m, n)
        pts = np.zeros((n, 3), dtype=np.float32)
        pts[:m] = xyz[:m]
        mask = np.zeros((n,), dtype=bool)
        mask[:m] = True
        return PointBatch(points=torch.from_numpy(pts).to(device),
                          mask=torch.from_numpy(mask).to(device))

    def to_numpy(self) -> np.ndarray:
        """Return only the valid points as an (M, 3) numpy array."""
        return self.points[self.mask].cpu().numpy()

    def to(self, device) -> "PointBatch":
        return PointBatch(self.points.to(device), self.mask.to(device))


@dataclass
class RegistrationSolution:
    """Result of one registration solve (mirrors the JAX package's
    ``RegistrationSolution``; the reference's
    ``Quatro::RegistrationSolution`` plus masked inlier bookkeeping)."""

    # shapes of one pair; a batch of B pairs (and the K hypotheses of a
    # multi-hypothesis solve) adds leading axes to every field
    valid: torch.Tensor          # () bool — False iff the clique degenerated
    scale: torch.Tensor          # () f32 — always 1 in the reference pipeline
    rotation: torch.Tensor       # (3, 3) f32
    translation: torch.Tensor    # (3,) f32
    max_clique_mask: torch.Tensor    # (N,) bool — inliers after clique selection
    final_inlier_mask: torch.Tensor  # (N,) bool — inliers after COTE
    num_rotation_inliers: torch.Tensor  # () int32
    gnc_iterations: torch.Tensor        # () int32 — GNC-TLS iterations used
    gnc_cost: torch.Tensor              # () f32 — final GNC cost

    @staticmethod
    def stack(sols) -> "RegistrationSolution":
        """Solutions stacked along a new leading (pair or hypothesis)
        axis."""
        return RegistrationSolution(*(
            torch.stack([getattr(s, f.name) for s in sols])
            for f in fields(RegistrationSolution)))

    def row(self, b: int) -> "RegistrationSolution":
        """Row ``b`` of a batch: pair b's solution."""
        return RegistrationSolution(*(getattr(self, f.name)[b]
                                      for f in fields(self)))

    def take(self, index) -> "RegistrationSolution":
        """Row ``index`` of the first axis past those of ``index`` (an int
        or an integer tensor, read on the device): a 0-d index picks one
        hypothesis of a (K, ...) solution, a (B,) index one per pair of a
        (B, K, ...) solution."""
        index = torch.as_tensor(index)
        d = index.dim()

        def pick(t):
            i = index.to(t.device).reshape(*index.shape, 1,
                                           *([1] * (t.dim() - d - 1)))
            return t.gather(d, i.expand(*index.shape, 1,
                                        *t.shape[d + 1:])).squeeze(d)

        return RegistrationSolution(*(pick(getattr(self, f.name))
                                      for f in fields(self)))

    def transform(self) -> torch.Tensor:
        """The 4x4 homogeneous transform [R|t; 0 1]; batch-safe (leading
        axes on rotation/translation yield (..., 4, 4))."""
        batch = self.rotation.shape[:-2]
        out = self.rotation.new_zeros((*batch, 4, 4))
        out[..., :3, :3] = self.rotation
        out[..., :3, 3] = self.translation
        out[..., 3, 3] = 1.0
        return out
