"""Trajectory-level registration: odometry + loop closing + ATE.

PyTorch counterpart of ``quatro_tpu/sequence.py``, Quatro++'s use case at
trajectory scale: register consecutive scans for odometry, register
loop-closure candidate pairs, and solve the pose graph.

    scans -> OdometryRunner (feature reuse) -> odometry edges
          -> loop candidates (Scan Context, or a ground-truth oracle)
          -> registration edges -> optimize_pose_graph -> poses + ATE

Convention: registering (src=scan_j, tgt=scan_i) yields the edge (i, j)
measurement t_ij = R(-yaw_i)(t_j - t_i), yaw_ij = yaw_j - yaw_i.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from quatro_tpu_torch.config import PipelineConfig
from quatro_tpu_torch.odometry import (FrameFeatures, OdometryRunner,
                                       load_frame_features,
                                       save_frame_features)
from quatro_tpu_torch.parallel.posegraph import (PoseGraphEdges,
                                                 optimize_pose_graph,
                                                 solution_to_edge, wrap_angle)
from quatro_tpu_torch.types import PointBatch


@dataclass
class SequenceResult:
    poses: np.ndarray            # (M, 4) optimized (x, y, z, yaw)
    odometry_poses: np.ndarray   # (M, 4) integrated odometry (pre-closure)
    edges_total: int
    edges_valid: int
    ate_before: float
    ate_after: float
    wall_s: float
    # the registered pose-graph edges (odometry first, then loop
    # candidates) and the edge gate's decisions
    edges_i: np.ndarray = None   # (E,) int
    edges_j: np.ndarray = None   # (E,) int
    edge_mask: np.ndarray = None  # (E,) bool


def _feature_fingerprint(config: PipelineConfig) -> str:
    """Salt for cached per-frame features: exactly the inputs of
    ``OdometryRunner.extract``. Solver, ICP and matcher-only knobs are
    left out, so flipping them keeps the extraction work. Equal to the JAX
    package's digest for the same configuration (both hash the dataclass
    reprs)."""
    f = config.fpfh
    key = (config.lidar, config.patchwork, config.projection,
           f.normal_radius, f.fpfh_radius,
           f.max_neighbors_normal, f.max_neighbors_fpfh,
           config.ground_segmentation_mode, config.use_subclustering,
           config.voxel_size, config.max_raw_points,
           config.max_nonground_points, config.max_segment_points,
           config.max_voxels,
           # both change what FrameFeatures holds (leveled coordinates,
           # raw-voxel ICP clouds)
           config.ground_alignment, config.icp.enabled)
    return hashlib.sha1(repr(key).encode()).hexdigest()[:10]


def _edge_fingerprint(config: PipelineConfig, min_edge_inliers: int,
                      min_edge_overlap: float) -> str:
    """Salt for the edge log: the feature fingerprint plus everything the
    registration depends on (matcher, solver, edge gates)."""
    key = (_feature_fingerprint(config), config.fpfh, config.solver,
           config.icp, config.ground_alignment,
           min_edge_inliers, min_edge_overlap)
    return hashlib.sha1(repr(key).encode()).hexdigest()[:10]


def _compose(pose: np.ndarray, t_rel: np.ndarray, yaw_rel: float):
    """pose_j from pose_i and the edge measurement (module docstring)."""
    c, s = np.cos(pose[3]), np.sin(pose[3])
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    out = np.empty(4)
    out[:3] = pose[:3] + rot @ t_rel
    out[3] = pose[3] + yaw_rel
    return out


def _ate(poses: np.ndarray, gt: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum(
        (poses[:, :3] - gt[:, :3]) ** 2, axis=1))))


def run_sequence(scans: Sequence[PointBatch],
                 config: PipelineConfig = PipelineConfig(),
                 loop_candidates: Optional[List[Tuple[int, int]]] = None,
                 gt_poses: Optional[np.ndarray] = None,
                 loop_radius: float = 10.0, min_gap: int = 3,
                 min_edge_inliers: int = 2,
                 min_edge_overlap: float = 0.35,
                 gn_iters: int = 10, cg_iters: int = 40,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 8,
                 batch_size: int = 16,
                 use_place_recognition: Optional[bool] = None,
                 place_recognition_max_distance: float = 0.5,
                 device=None) -> SequenceResult:
    """Register a scan sequence and close its loops; ``device=None`` is
    the card.

    loop_candidates: (i, j) pairs to attempt as closures. If None, they
    come from Scan Context place recognition over the scans
    (ops/scancontext.py), unless gt_poses is given and
    use_place_recognition is not forced True: then pose proximity serves
    as a controlled oracle.

    checkpoint_dir: if set, the run is resumable. Per-frame features and
    the edge log persist to disk, salted with the parameters that produced
    them; a rerun loads the cached features, skips every registered edge,
    and a killed job loses at most ``checkpoint_every`` edges of work.

    Edges register ``batch_size`` at a time, each batch one batched call
    of ``OdometryRunner.register_pairs`` (the last batch holds only the
    edges left). Each batch's poses, validity, inlier counts
    and overlaps are read back once. An edge enters the pose graph iff the
    solver reports valid, the final inlier count >= ``min_edge_inliers``,
    and (when ``min_edge_overlap`` > 0) the alignment overlap passes
    (solver/verify.py).
    """
    t0 = time.time()
    runner = OdometryRunner(config, device)
    dev = runner.device
    m = len(scans)

    # checkpoints are salted with what each artifact depends on: features
    # re-extract only when an extraction knob changed, the edge log
    # re-registers when a registration or gating knob (or the features) did
    feat_fp = _feature_fingerprint(config)
    edge_fp = _edge_fingerprint(config, min_edge_inliers, min_edge_overlap)

    def _feat_path(k: int) -> str:
        return os.path.join(checkpoint_dir, f"feat_{feat_fp}_{k:05d}.npz")

    feats: List[FrameFeatures] = []
    for k, s in enumerate(scans):
        if checkpoint_dir and os.path.exists(_feat_path(k)):
            feats.append(load_frame_features(_feat_path(k)).to(dev))
        else:
            feats.append(runner.extract(s))
            if checkpoint_dir:
                os.makedirs(checkpoint_dir, exist_ok=True)
                save_frame_features(_feat_path(k), feats[-1])

    # --- edge plan: odometry edges first, then loop candidates -----------
    if use_place_recognition is None:
        use_place_recognition = gt_poses is None
    if loop_candidates is None:
        if use_place_recognition:
            from quatro_tpu_torch.ops.scancontext import (
                detect_loop_candidates, scan_context)
            descs = torch.stack([scan_context(s.points.to(dev),
                                              s.mask.to(dev))
                                 for s in scans])
            loop_candidates = detect_loop_candidates(
                descs, min_gap=min_gap,
                max_distance=place_recognition_max_distance)
        elif gt_poses is not None:
            loop_candidates = []
            for i in range(m):
                for j in range(i + min_gap + 1, m):
                    if np.linalg.norm(gt_poses[i, :3] - gt_poses[j, :3]) \
                            < loop_radius:
                        loop_candidates.append((i, j))
    loop_candidates = loop_candidates or []
    plan = [(k, k + 1) for k in range(m - 1)] + list(loop_candidates)

    ei, ej, t_meas, yaw_meas, weights, emask = [], [], [], [], [], []
    odo = np.zeros((m, 4))
    n_done = 0

    state_path = (os.path.join(checkpoint_dir, "edges.npz")
                  if checkpoint_dir else None)
    if state_path and os.path.exists(state_path):
        st = np.load(state_path)
        # a checkpoint of another plan, configuration or edge gate must
        # not resume the wrong trajectory or mix two gating policies
        if ("fingerprint" in st.files and str(st["fingerprint"]) == edge_fp
                and int(st["m"]) == m and st["plan"].shape[0] == len(plan)
                and np.array_equal(st["plan"], np.asarray(plan))):
            n_done = int(st["n_done"])
            ei = list(st["ei"][:n_done])
            ej = list(st["ej"][:n_done])
            t_meas = list(st["t_meas"][:n_done])
            yaw_meas = list(st["yaw_meas"][:n_done])
            weights = list(st["weights"][:n_done])
            emask = list(st["emask"][:n_done])
            odo = st["odo"].copy()

    def _save_state():
        np.savez(state_path, fingerprint=edge_fp,
                 m=m, n_done=len(ei), plan=np.asarray(plan),
                 ei=np.asarray(ei, np.int32), ej=np.asarray(ej, np.int32),
                 t_meas=np.asarray(t_meas, np.float32).reshape(len(ei), 3),
                 yaw_meas=np.asarray(yaw_meas, np.float32),
                 weights=np.asarray(weights, np.float32),
                 emask=np.asarray(emask, bool), odo=odo)

    for start in range(n_done, len(plan), batch_size):
        chunk = plan[start:start + batch_size]
        # edge (i, j): register src=scan_j onto tgt=scan_i; the chunk's
        # edges in one batched call (the JAX package pads the last chunk
        # to batch_size for vmap's static shapes; rows past the chunk
        # would never be read)
        sols, overlaps = runner.register_pairs(
            FrameFeatures.stack([feats[j] for _, j in chunk]),
            FrameFeatures.stack([feats[i] for i, _ in chunk]))
        t_all, yaw_all = solution_to_edge(sols.translation, sols.rotation)
        counts = sols.final_inlier_mask.sum(-1).to(torch.float32)
        host = torch.cat([t_all, yaw_all[:, None],
                          sols.valid[:, None].to(torch.float32),
                          counts[:, None], overlaps[:, None]], 1).cpu().numpy()
        t_all, yaw_all = host[:, :3], host[:, 3]
        valid, counts, overlaps = host[:, 4] > 0, host[:, 5], host[:, 6]
        for k, (i, j) in enumerate(chunk):
            ok = bool(valid[k]) and counts[k] >= min_edge_inliers
            if ok and min_edge_overlap > 0:
                # geometric verification: correct poses score high overlap
                # even from few inliers, confidently wrong ones near zero
                ok = bool(overlaps[k] >= min_edge_overlap)
            ei.append(i)
            ej.append(j)
            t_meas.append(t_all[k])
            yaw_meas.append(float(yaw_all[k]))
            weights.append(max(float(counts[k]), 1.0))
            emask.append(ok)
            if j == i + 1 and start + k < m - 1:  # odometry edge: integrate
                odo[j] = _compose(odo[i], t_all[k], yaw_all[k]) if ok \
                    else odo[i]
        if state_path and (len(ei) // checkpoint_every
                           > (len(ei) - len(chunk)) // checkpoint_every):
            _save_state()
    if state_path:
        _save_state()

    edges = PoseGraphEdges(
        i=torch.as_tensor(np.asarray(ei, np.int32), device=dev),
        j=torch.as_tensor(np.asarray(ej, np.int32), device=dev),
        t_meas=torch.as_tensor(np.asarray(t_meas, np.float32).reshape(-1, 3),
                               device=dev),
        yaw_meas=torch.as_tensor(np.asarray(yaw_meas, np.float32),
                                 device=dev),
        weight=torch.as_tensor(np.asarray(weights, np.float32), device=dev),
        mask=torch.as_tensor(np.asarray(emask, bool), device=dev))
    poses = optimize_pose_graph(
        torch.as_tensor(odo, dtype=torch.float32, device=dev), edges, m,
        gn_iters=gn_iters, cg_iters=cg_iters).cpu().numpy()

    ate_before = _ate(odo, gt_poses) if gt_poses is not None else float("nan")
    ate_after = _ate(poses, gt_poses) if gt_poses is not None else float("nan")
    return SequenceResult(
        poses=poses, odometry_poses=odo,
        edges_total=len(ei), edges_valid=int(np.sum(emask)),
        ate_before=ate_before, ate_after=ate_after,
        wall_s=time.time() - t0,
        edges_i=np.asarray(ei, int), edges_j=np.asarray(ej, int),
        edge_mask=np.asarray(emask, bool))


def _wrap_f32(a: float) -> float:
    """The JAX package's f32 ``wrap_angle`` of one Python float, as a
    Python float (one element at a time: torch's scalar f32 sine, cosine
    and arctangent give XLA's bits on these angles where its vectorised
    ones do not always)."""
    return float(wrap_angle(torch.tensor(a, dtype=torch.float32)))


def make_synthetic_sequence(num_poses: int = 10, seed: int = 0,
                            radius: float = 14.0,
                            config: PipelineConfig = PipelineConfig(),
                            cache_dir: Optional[str] = None,
                            raw_capacity: int = 131072):
    """Scans along a circular loop in one scene (first and last poses
    adjacent: a natural loop closure), on the CPU. Returns (scans,
    gt_poses (M, 4) f32 in the pose-0 frame). The scans equal the JAX
    package's for the same arguments, and the cache files are shared."""
    from quatro_tpu_torch.io.synthetic import make_scene, raycast_scan

    scene = make_scene(seed, extent=radius * 3)
    gt = np.zeros((num_poses, 4))
    for k in range(num_poses):
        ang = 2 * np.pi * k / num_poses
        gt[k, :3] = [radius * np.cos(ang) - radius, radius * np.sin(ang),
                     1.723]
        gt[k, 3] = _wrap_f32(ang + np.pi / 2)

    # carve a corridor along the trajectory: drop boxes whose xy footprint
    # (padded 2 m) contains a pose (a sensor inside a box sees garbage)
    keep = np.ones(scene.box_min.shape[0], bool)
    for k in range(num_poses):
        inside = ((gt[k, 0] > scene.box_min[:, 0] - 2.0)
                  & (gt[k, 0] < scene.box_max[:, 0] + 2.0)
                  & (gt[k, 1] > scene.box_min[:, 1] - 2.0)
                  & (gt[k, 1] < scene.box_max[:, 1] + 2.0))
        keep &= ~inside
    scene.box_min = scene.box_min[keep]
    scene.box_max = scene.box_max[keep]

    scans = []
    for k in range(num_poses):
        xyz = None
        cpath = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            key = hashlib.sha1(repr((seed, num_poses, radius, k,
                                     config.lidar)).encode()).hexdigest()[:16]
            cpath = os.path.join(cache_dir, f"seq_{key}.npy")
            if os.path.exists(cpath):
                xyz = np.load(cpath)
        if xyz is None:
            xyz = raycast_scan(scene, gt[k, :3], gt[k, 3],
                               lidar=config.lidar, seed=seed * 100 + k)
            if cpath:
                np.save(cpath, xyz)
        scans.append(PointBatch.from_numpy(xyz, raw_capacity))

    # ground truth in the pose-0 frame (the graph's gauge anchor):
    # t_rel = R(-yaw_0)(t_k - t_0), yaw_rel = yaw_k - yaw_0
    c, s = np.cos(gt[0, 3]), np.sin(gt[0, 3])
    rot0t = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
    rel = np.zeros_like(gt)
    rel[:, :3] = (gt[:, :3] - gt[0, :3]) @ rot0t.T
    rel[:, 3] = [_wrap_f32(a) for a in gt[:, 3] - gt[0, 3]]
    return scans, rel.astype(np.float32)
