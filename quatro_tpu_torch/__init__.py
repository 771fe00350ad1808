"""PyTorch / CUDA port of quatro-tpu for NVIDIA Hopper (H100).

A second package beside the JAX reference ``quatro_tpu``; it imports
neither jax nor anything of ``quatro_tpu``. The pair entry points run in
every configuration the JAX package's accept: ``register_scan_pair`` on
raw scans (Patchwork ground removal, range-image sub-clustering, optional
ground-plane leveling, ``register_features``, optional point-to-plane
ICP), ``register_features``, ``register_correspondences`` and
``register_hypotheses`` with every solver mode. Loop closing runs on
top: ``OdometryRunner`` (one feature extraction per frame) and
``run_sequence`` (odometry, Scan Context loop candidates, batched edge
registration, pose-graph solve); ``QuatroRegistration`` is the reference's
object API over the solver. The kernels, twelve, are hand-written CUDA in
``csrc/``; ``table_lookup`` is B12's public op.
"""

from quatro_tpu_torch.config import (FPFHConfig, GroundAlignmentConfig,
                                     IcpConfig, LidarConfig, PipelineConfig,
                                     SolverConfig, config_from_dict,
                                     config_to_dict)
from quatro_tpu_torch.odometry import OdometryRunner
from quatro_tpu_torch.ops.segment import table_lookup
from quatro_tpu_torch.pipeline import (extract_features, register_features,
                                      register_scan_pair)
from quatro_tpu_torch.registration import QuatroRegistration
from quatro_tpu_torch.sequence import run_sequence
from quatro_tpu_torch.solver.quatro import (register_batch,
                                            register_correspondences,
                                            register_hypotheses)
from quatro_tpu_torch.types import PointBatch, RegistrationSolution

__all__ = [
    "FPFHConfig", "GroundAlignmentConfig", "IcpConfig", "LidarConfig",
    "PipelineConfig", "SolverConfig", "config_from_dict", "config_to_dict",
    "extract_features", "register_features", "register_scan_pair",
    "register_correspondences", "register_hypotheses", "register_batch",
    "OdometryRunner", "run_sequence", "QuatroRegistration", "table_lookup",
    "PointBatch", "RegistrationSolution",
]
