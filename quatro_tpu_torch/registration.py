"""Reference-idiom object API for drop-in migration.

PyTorch counterpart of ``quatro_tpu/registration.py``. The reference
solver is a PCL ``Registration`` subclass driven as

    quatro.reset(params);
    quatro.setInputSource(src); quatro.setInputTarget(tgt);
    quatro.computeTransformation(output);          // 4x4
    quatro.getMaxCliques(); quatro.getFinalInliers();

(reference: include/quatro.hpp:70-71,286,755,769,949-961 and README.md:
26-32). ``QuatroRegistration`` mirrors that surface in snake_case over the
functional solver (``solver.quatro.register_correspondences``); the object
is a thin stateful shell, and its results come back as numpy.

Differences by design: ``reset()`` is optional (there is no solver state
to leak between runs, where the reference warns it MUST be called,
examples/run_global_registration.cpp:99-101); inputs are plain (N, 3)
arrays or a ``PointBatch``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from quatro_tpu_torch.config import SolverConfig
from quatro_tpu_torch.device import resolve_device
from quatro_tpu_torch.solver.quatro import register_correspondences
from quatro_tpu_torch.types import PointBatch, RegistrationSolution

ArrayLike = Union[np.ndarray, torch.Tensor, PointBatch]


def _round_capacity(n: int) -> int:
    """Pad to the next multiple of 128, the JAX package's rule, so both
    packages see the same padded inputs."""
    return max(128, -(-n // 128) * 128)


class QuatroRegistration:
    """Stateful shell over the functional solver, in the reference's idiom;
    ``device=None`` is the card.

    >>> quatro = QuatroRegistration(SolverConfig())
    >>> quatro.set_input_source(src_keypoints)   # (N, 3) matched keypoints
    >>> quatro.set_input_target(tgt_keypoints)
    >>> T = quatro.compute_transformation()      # (4, 4) numpy
    >>> quatro.get_final_inliers()               # (M, 3) numpy
    """

    def __init__(self, params: Optional[SolverConfig] = None,
                 capacity: Optional[int] = None, device=None):
        self._params = params or SolverConfig()
        self._capacity = capacity
        self._device = resolve_device(device)
        self._src: Optional[PointBatch] = None
        self._tgt: Optional[PointBatch] = None
        self._prior_ryrx: Optional[np.ndarray] = None
        self._solution: Optional[RegistrationSolution] = None

    # -- configuration (reference: Quatro::reset, include/quatro.hpp:755) --
    def reset(self, params: Optional[SolverConfig] = None) -> None:
        """Clear inputs and solution; optionally swap the parameter set."""
        if params is not None:
            self._params = params
        self._src = self._tgt = self._solution = None
        self._prior_ryrx = None

    @property
    def params(self) -> SolverConfig:
        return self._params

    # -- inputs (reference: include/quatro.hpp:286, PCL Registration) ------
    def _coerce(self, cloud: ArrayLike) -> PointBatch:
        if isinstance(cloud, PointBatch):
            return cloud
        if torch.is_tensor(cloud):
            cloud = cloud.detach().cpu().numpy()
        arr = np.asarray(cloud, np.float32).reshape(-1, 3)
        cap = self._capacity or _round_capacity(arr.shape[0])
        return PointBatch.from_numpy(arr, cap)

    def set_input_source(self, cloud: ArrayLike) -> None:
        self._src = self._coerce(cloud)
        self._solution = None

    def set_input_target(self, cloud: ArrayLike) -> None:
        self._tgt = self._coerce(cloud)
        self._solution = None

    def set_pre_estimated_ryrx(self, ryrx: np.ndarray) -> None:
        """IMU roll/pitch prior; the estimated yaw composes as Rz @ RyRx
        (reference: include/quatro.hpp:276-279)."""
        self._prior_ryrx = np.asarray(ryrx, np.float32).reshape(3, 3)

    # -- solve (reference: include/quatro.hpp:769) --------------------------
    def compute_transformation(self) -> np.ndarray:
        """Run the solver; returns the 4x4 transform (identity rotation and
        zero translation when the solve degenerates, like the reference's
        ``solution_.valid=false`` path, include/quatro.hpp:809-813)."""
        if self._src is None or self._tgt is None:
            raise RuntimeError(
                "set_input_source/set_input_target before "
                "compute_transformation")
        if self._src.capacity != self._tgt.capacity:
            cap = max(self._src.capacity, self._tgt.capacity)
            self._src = PointBatch.from_numpy(self._src.to_numpy(), cap)
            self._tgt = PointBatch.from_numpy(self._tgt.to_numpy(), cap)
        self._solution = register_correspondences(
            self._src.points, self._tgt.points,
            self._src.mask & self._tgt.mask, self._params,
            prior_ryrx=self._prior_ryrx, device=self._device)
        return self._solution.transform().cpu().numpy()

    # -- results (reference: include/quatro.hpp:949-961) --------------------
    @property
    def solution(self) -> RegistrationSolution:
        if self._solution is None:
            raise RuntimeError("compute_transformation has not been run")
        return self._solution

    def is_valid(self) -> bool:
        return bool(self.solution.valid)

    def _selected(self, mask: torch.Tensor) -> np.ndarray:
        return self._src.points.cpu().numpy()[mask.cpu().numpy()]

    def get_max_cliques(self) -> np.ndarray:
        """Source keypoints selected by the clique stage, (M, 3)."""
        return self._selected(self.solution.max_clique_mask)

    def get_final_inliers(self) -> np.ndarray:
        """Source keypoints surviving every stage, (M, 3)."""
        return self._selected(self.solution.final_inlier_mask)

    def get_final_inliers_indices(self) -> np.ndarray:
        """Indices (into the input correspondence order) of final inliers."""
        return np.flatnonzero(self.solution.final_inlier_mask.cpu().numpy())
