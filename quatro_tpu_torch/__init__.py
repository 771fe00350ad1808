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
object API over the solver. The user's entry points sit above these:
``python -m quatro_tpu_torch.cli {register,evaluate,overlap,sequence,
sweep}`` (``cli.py``, with ``--device``) and the evaluation harness
``eval.py`` (loop-closure success rate over the pair axis, outlier
sweep), reading reference-format YAML (``config_io.py``), KITTI ``.bin``
through the native loader (``native/``), PCD and writing PLY (``io/``).
The kernels, twelve for the JAX package's Pallas calls, one for its
exact clique search and one for its SO(3) Kabsch solve, are hand-written
CUDA in ``csrc/``;
``table_lookup`` is B12's public op.
"""

__version__ = "0.1.0"

from quatro_tpu_torch.config import (DEFAULT_CONFIG, FPFHConfig,
                                     GroundAlignmentConfig, IcpConfig,
                                     LidarConfig, PatchworkConfig,
                                     PipelineConfig, ProjectionConfig,
                                     SolverConfig, config_from_dict,
                                     config_to_dict, replace)
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
    "DEFAULT_CONFIG", "FPFHConfig", "GroundAlignmentConfig", "IcpConfig",
    "LidarConfig", "PatchworkConfig", "PipelineConfig", "ProjectionConfig",
    "SolverConfig", "config_from_dict", "config_to_dict", "replace",
    "__version__",
    "extract_features", "register_features", "register_scan_pair",
    "register_correspondences", "register_hypotheses", "register_batch",
    "OdometryRunner", "run_sequence", "QuatroRegistration", "table_lookup",
    "PointBatch", "RegistrationSolution",
]
