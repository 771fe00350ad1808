"""PyTorch / CUDA port of quatro-tpu for NVIDIA Hopper (H100).

A second package beside the JAX reference ``quatro_tpu``; it imports
neither jax nor anything of ``quatro_tpu``. ``pipeline.register_scan_pair``
runs end to end on raw scans (Patchwork ground removal, range-image
sub-clustering, then ``register_features``), with the single-hypothesis
solver and with the shipping multi-hypothesis solver of
``PipelineConfig.recommended()``; its kernels are hand-written CUDA in
``csrc/``.
"""

from quatro_tpu_torch.config import (FPFHConfig, LidarConfig, PipelineConfig,
                                     SolverConfig, config_from_dict,
                                     config_to_dict)
from quatro_tpu_torch.pipeline import (extract_features, register_features,
                                      register_scan_pair)
from quatro_tpu_torch.solver.quatro import (register_correspondences,
                                            register_hypotheses)
from quatro_tpu_torch.types import PointBatch, RegistrationSolution

__all__ = [
    "FPFHConfig", "LidarConfig", "PipelineConfig", "SolverConfig",
    "config_from_dict", "config_to_dict", "extract_features",
    "register_features", "register_scan_pair", "register_correspondences",
    "register_hypotheses",
    "PointBatch", "RegistrationSolution",
]
