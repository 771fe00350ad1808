"""Sharded batched registration and the multi-card "step".

PyTorch counterpart of ``quatro_tpu/parallel/sharding.py``. Scan-pair data
parallelism over the ('pairs',) mesh (parallel/mesh.py): each rank runs
the whole per-pair pipeline on its own rows as one batched call over the
pair axis (no communication: the pipeline is per pair), then the pose
graph all-reduces its J^T sums over the mesh's process group.

Where the JAX package's jitted ``shard_map`` takes global arrays and
hands each device its block, here each process holds only its block: a
rank passes the rows ``pairs_sharding(mesh).rows(B)`` (or
``distributed.local_batch_slice(B)``) of the global batch of B pairs,
which raise ValueError when B does not divide by the mesh's size, and
gets those rows' solutions back. On a mesh of one, local is global, and
the functions give the unsharded composition's bits.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.config import PipelineConfig, SolverConfig
from quatro_tpu_torch.device import to_tensor
from quatro_tpu_torch.parallel.mesh import PairsMesh
from quatro_tpu_torch.parallel.posegraph import (PoseGraphEdges,
                                                 optimize_pose_graph,
                                                 solution_to_edge)
from quatro_tpu_torch.pipeline import register_scan_pair
from quatro_tpu_torch.solver.quatro import register_batch
from quatro_tpu_torch.types import PointBatch


def sharded_register_batch(mesh: PairsMesh,
                           config: SolverConfig = SolverConfig()):
    """A function solving this rank's rows of a correspondence batch:
    (src (b, N, 3), tgt (b, N, 3), mask (b, N)) -> RegistrationSolution
    with a leading b, one ``register_batch`` call on the mesh's device.
    It issues no collective."""

    def local(src, tgt, mask):
        return register_batch(src, tgt, mask, config, device=mesh.device)

    return local


def _posegraph_tail(mesh: PairsMesh, sols, edge_i, edge_j, poses0,
                    num_poses, gn_iters, cg_iters):
    """The pose-graph solve from this rank's edge solutions; the J^T sums
    all-reduce over the mesh (the only traffic between ranks:
    pose-vector-sized, never cloud-sized)."""
    dev = mesh.device
    t_meas, yaw = solution_to_edge(sols.translation, sols.rotation)
    weight = sols.final_inlier_mask.sum(-1).to(torch.float32)
    edges = PoseGraphEdges(
        i=to_tensor(edge_i, torch.int32, dev),
        j=to_tensor(edge_j, torch.int32, dev),
        t_meas=t_meas, yaw_meas=yaw,
        weight=torch.clamp_min(weight, 1.0),
        mask=sols.valid)
    return optimize_pose_graph(to_tensor(poses0, torch.float32, dev), edges,
                               num_poses, gn_iters=gn_iters,
                               cg_iters=cg_iters, psum_axis=mesh)


def make_loop_closing_step(mesh: PairsMesh, num_poses: int,
                           config: SolverConfig = SolverConfig(),
                           gn_iters: int = 6, cg_iters: int = 24):
    """The multi-card step: this rank's pair registrations in one batched
    call, then the pose-graph solve whose J^T sums all-reduce over the
    mesh (BASELINE.json configs 2 and 5).

    Returned function:
        (src (b, N, 3), tgt (b, N, 3), mask (b, N), edge_i (b,),
         edge_j (b,), poses0 (M, 4)) -> (poses (M, 4), solutions)
    with this rank's b rows of the edges and the same poses0 on every
    rank; poses come back the same on every rank, the solutions are this
    rank's rows. Edge (i, j) carries the registration of scan j (source)
    onto scan i (target), the pose-graph measurement convention
    (parallel/posegraph.py, sequence.py): t_ij = R(-yaw_i)(t_j - t_i),
    yaw_ij = yaw_j - yaw_i; so feed src = scan j's correspondences, tgt =
    scan i's.
    """
    register = sharded_register_batch(mesh, config)

    def step(src, tgt, mask, edge_i, edge_j, poses0):
        sols = register(src, tgt, mask)
        poses = _posegraph_tail(mesh, sols, edge_i, edge_j, poses0,
                                num_poses, gn_iters, cg_iters)
        return poses, sols

    return step


def make_full_pipeline_step(mesh: PairsMesh, num_poses: int, config=None,
                            gn_iters: int = 6, cg_iters: int = 24):
    """The multi-card step over raw scans: this rank's pairs through the
    whole pipeline (Patchwork ground segmentation, range-image
    sub-clustering, voxels, FPFH, matching and the solve;
    examples/run_global_registration.cpp:127-251) as one
    ``register_scan_pair`` call over the pair axis, feeding the same
    pose-graph all-reduce. The front end issues no collective.
    ``config=None`` means ``PipelineConfig()``.

    Returned function:
        (src_pts (b, P, 3), src_mask (b, P), tgt_pts (b, P, 3),
         tgt_mask (b, P), edge_i (b,), edge_j (b,), poses0 (M, 4))
        -> (poses (M, 4), solutions)
    with the rows and edge convention of ``make_loop_closing_step``.
    """
    config = config or PipelineConfig()

    def step(src_pts, src_mask, tgt_pts, tgt_mask, edge_i, edge_j, poses0):
        sols = register_scan_pair(PointBatch(src_pts, src_mask),
                                  PointBatch(tgt_pts, tgt_mask), config,
                                  device=mesh.device).solution
        poses = _posegraph_tail(mesh, sols, edge_i, edge_j, poses0,
                                num_poses, gn_iters, cg_iters)
        return poses, sols

    return step
