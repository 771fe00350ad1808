from quatro_tpu_torch.parallel.mesh import (PAIRS_AXIS, make_pairs_mesh,
                                            pairs_sharding, replicated)
from quatro_tpu_torch.parallel.posegraph import (PoseGraphEdges,
                                                 optimize_pose_graph,
                                                 wrap_angle)
from quatro_tpu_torch.parallel.sharding import (make_full_pipeline_step,
                                                make_loop_closing_step,
                                                sharded_register_batch)

__all__ = [
    "PAIRS_AXIS", "make_pairs_mesh", "pairs_sharding", "replicated",
    "PoseGraphEdges", "optimize_pose_graph", "wrap_angle",
    "make_full_pipeline_step", "make_loop_closing_step",
    "sharded_register_batch",
]
