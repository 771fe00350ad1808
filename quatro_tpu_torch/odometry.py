"""Sequential (odometry / loop-closure sweep) registration runner.

PyTorch counterpart of ``quatro_tpu/odometry.py``, which replaces the
reference's stateful ``FPFHManager`` (include/fpfh_manager.hpp:25-238):

* descriptor reuse between consecutive frames: the previous target's
  voxels and descriptors become the next source (``swapTgt2Src``,
  fpfh_manager.hpp:74-77,111-118), so each frame pays feature extraction
  once;
* feature caching to disk so parameter sweeps skip re-extraction
  (``saveFeaturePair`` / ``loadFeaturePair``, fpfh_manager.hpp:179-232),
  as .npz files with the JAX package's keys: a cache written by one
  package loads in the other.

Extraction is ``preprocess`` -> [``frame_leveling``] -> ``extract_features``
[-> a raw-scan voxelisation with normals for ICP]; registration is the
matcher -> hypotheses and arbitration (or the single solve) -> [compose the
leveling back] -> [ICP]. The runner takes ``device=None`` (the card; see
device.py).
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np
import torch

from quatro_tpu_torch.config import PipelineConfig
from quatro_tpu_torch.device import resolve_device, to_tensor
from quatro_tpu_torch.ops.matching import match_features
from quatro_tpu_torch.pipeline import (extract_features, preprocess,
                                       raw_scan_normals, raw_scan_voxels)
from quatro_tpu_torch.solver.ground import (GroundAlignment,
                                            compose_leveled_solution,
                                            frame_leveling)
from quatro_tpu_torch.solver.icp import refine_icp
from quatro_tpu_torch.solver.quatro import (register_correspondences,
                                            register_hypotheses)
from quatro_tpu_torch.solver.verify import (alignment_overlap,
                                            arbitrate_hypotheses)
from quatro_tpu_torch.types import PointBatch, RegistrationSolution
from quatro_tpu_torch.utils.se3 import rotate_points


@dataclass
class FrameFeatures:
    """Extracted per-frame features, the cacheable unit; every field may
    carry a leading batch axis.

    With ground alignment on, voxels and descriptors live in the frame's
    LEVELED coordinates (level @ p) and ``level`` / ``ground_height`` /
    ``ground_ok`` carry the leveling; registration composes the pair back
    to the raw frames (solver/ground.py). With ICP on, ``raw_*`` carry a
    voxelisation of the RAW scan (ground kept: point-to-plane needs it to
    constrain z) and its normals."""

    voxels: torch.Tensor       # (V, 3)
    voxel_mask: torch.Tensor   # (V,)
    descriptors: torch.Tensor  # (V, 33)
    desc_mask: torch.Tensor    # (V,)
    level: Optional[torch.Tensor] = None             # (3, 3)
    ground_height: Optional[torch.Tensor] = None     # ()
    ground_ok: Optional[torch.Tensor] = None         # () bool
    raw_voxels: Optional[torch.Tensor] = None        # (V, 3)
    raw_voxel_mask: Optional[torch.Tensor] = None    # (V,)
    raw_normals: Optional[torch.Tensor] = None       # (V, 3)
    raw_normal_valid: Optional[torch.Tensor] = None  # (V,)

    def _map(self, fn) -> "FrameFeatures":
        return FrameFeatures(**{f.name: None if getattr(self, f.name) is None
                                else fn(getattr(self, f.name))
                                for f in fields(self)})

    def to(self, device) -> "FrameFeatures":
        return self._map(lambda t: t.to(device))

    def row(self, k: int) -> "FrameFeatures":
        """Batch row ``k`` of every field."""
        return self._map(lambda t: t[k])

    def rows(self, start: int, stop: int) -> "FrameFeatures":
        return self._map(lambda t: t[start:stop])

    @staticmethod
    def _join(feats, fn) -> "FrameFeatures":
        return FrameFeatures(**{
            f.name: None if getattr(feats[0], f.name) is None
            else fn([getattr(x, f.name) for x in feats])
            for f in fields(FrameFeatures)})

    @staticmethod
    def stack(feats) -> "FrameFeatures":
        """Features stacked along a new leading batch axis."""
        return FrameFeatures._join(feats, torch.stack)

    @staticmethod
    def cat(feats) -> "FrameFeatures":
        """Batched features concatenated along their batch axis."""
        return FrameFeatures._join(feats, torch.cat)


class OdometryRunner:
    """Streaming pair registration with one feature extraction per frame."""

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self._prev: Optional[FrameFeatures] = None

    def _extract_impl(self, points, mask) -> FrameFeatures:
        """Features of one scan (N, 3) or a batch of scans (B, N, 3)."""
        cfg, dev = self.config, self.device
        points = to_tensor(points, torch.float32, dev)
        mask = to_tensor(mask, torch.bool, dev)
        seg, ground = preprocess(points, mask, cfg, dev)
        extra = {}
        pts = points
        if cfg.ground_alignment.enabled:
            level, height, ok = frame_leveling(points, ground & mask,
                                               cfg.ground_alignment)
            pts = rotate_points(points, level)
            extra.update(level=level, ground_height=height, ground_ok=ok)
        vox, desc, dmask, _ = extract_features(pts, seg, cfg, dev)
        if cfg.icp.enabled:
            # ICP refines on a raw-scan voxelisation, as
            # pipeline.refine_solution does
            vr, mr = raw_scan_voxels(points, mask, cfg)
            nrm = raw_scan_normals(vr, mr, cfg)
            extra.update(raw_voxels=vr, raw_voxel_mask=mr,
                         raw_normals=nrm.normals,
                         raw_normal_valid=nrm.valid)
        return FrameFeatures(vox.points, vox.mask, desc, dmask, **extra)

    def _register_impl(self, src: FrameFeatures, tgt: FrameFeatures):
        """For B pairs of features (a leading B on every field): (final
        solutions in the RAW frames, correspondences, the coarse poses
        (rotation, translation) in the feature frames for overlap
        verification against the stored, possibly leveled, voxels, and
        the coarse overlaps where arbitration already computed them, else
        None), every pair in one batched call."""
        cfg, dev = self.config, self.device
        f = cfg.fpfh
        corr = match_features(
            src.voxels, tgt.voxels, src.descriptors, tgt.descriptors,
            src.desc_mask, tgt.desc_mask, capacity=f.max_correspondences,
            use_crosscheck=f.use_crosscheck,
            crosscheck_min_matches=f.crosscheck_min_matches,
            use_tuple_test=f.use_tuple_test, tuple_scale=f.tuple_scale,
            trials_per_corr=f.tuple_trials_per_corr, seed=f.tuple_seed,
            tuple_min_keep=f.tuple_min_keep, device=dev)
        overlap = None
        if cfg.solver.total_hypotheses > 1:
            sols = register_hypotheses(corr.src_xyz, corr.tgt_xyz, corr.mask,
                                       cfg.solver,
                                       k=cfg.solver.num_hypotheses,
                                       device=dev)
            sol, overlaps = arbitrate_hypotheses(
                sols, src.voxels, src.voxel_mask, tgt.voxels, tgt.voxel_mask,
                radius=2.0 * cfg.voxel_size)
            # arbitration already scored the winner against the clouds
            overlap = torch.where(sols.valid, overlaps, -1.0).amax(-1)
        else:
            sol = register_correspondences(corr.src_xyz, corr.tgt_xyz,
                                           corr.mask, cfg.solver, device=dev)
        coarse = (sol.rotation, sol.translation)
        if cfg.ground_alignment.enabled:
            ga = GroundAlignment(src.level, tgt.level, src.ground_height,
                                 tgt.ground_height,
                                 src.ground_ok & tgt.ground_ok)
            rot, t = compose_leveled_solution(
                sol.rotation, sol.translation, ga,
                use_ground_z=cfg.ground_alignment.use_ground_z)
            sol = dataclasses.replace(sol, rotation=rot, translation=t)
        if cfg.icp.enabled:
            icp_res = refine_icp(
                src.raw_voxels, src.raw_voxel_mask, tgt.raw_voxels,
                tgt.raw_voxel_mask, tgt.raw_normals, tgt.raw_normal_valid,
                sol.rotation, sol.translation, cfg.icp, valid=sol.valid)
            sol = dataclasses.replace(sol, rotation=icp_res.rotation,
                                      translation=icp_res.translation)
        return sol, corr, coarse, overlap

    def _register_verify_impl(self, src: FrameFeatures, tgt: FrameFeatures):
        sol, _, (rot_c, t_c), overlap = self._register_impl(src, tgt)
        # verified with the COARSE pose: the stored voxels live in the
        # (possibly leveled) feature frames, and ICP cannot rescue a wrong
        # coarse pose anyway
        if overlap is None:
            overlap = alignment_overlap(
                src.voxels, src.voxel_mask, tgt.voxels, tgt.voxel_mask,
                rot_c, t_c, radius=2.0 * self.config.voxel_size)
        return sol, overlap

    def extract(self, scan: PointBatch) -> FrameFeatures:
        return self._extract_impl(scan.points, scan.mask)

    def step(self, scan: PointBatch) -> Optional[RegistrationSolution]:
        """Feed the next frame; returns the solution against the previous
        frame (None for the first). The new frame's features are computed
        once and reused as the next step's source (swapTgt2Src)."""
        feats = self.extract(scan)
        sol = None
        if self._prev is not None:
            sol = self.register_pair(self._prev, feats)
        self._prev = feats
        return sol

    def register_pair(self, src: FrameFeatures,
                      tgt: FrameFeatures) -> RegistrationSolution:
        sol, *_ = self._register_impl(FrameFeatures.stack([src]),
                                      FrameFeatures.stack([tgt]))
        return sol.row(0)

    def register_pairs(self, src: FrameFeatures, tgt: FrameFeatures
                       ) -> Tuple[RegistrationSolution, torch.Tensor]:
        """Pair registration with overlap verification for B pairs: every
        field of src and tgt carries a leading batch axis. Returns
        (solutions stacked along B, overlaps (B,)), overlap being the
        acceptance score of solver/verify.py. The B pairs are one batched
        call, as the JAX package vmaps them; each row equals the pair's
        own call."""
        return self._register_verify_impl(src, tgt)

    def reset(self):
        self._prev = None


_FEATURE_FIELDS = tuple(f.name for f in fields(FrameFeatures))


def save_frame_features(path: str, feats: FrameFeatures) -> None:
    """Cache features to .npz (replaces the PCD pair cache,
    fpfh_manager.hpp:179-198), in the JAX package's keys; the optional
    fields are stored where present."""
    data = {k: getattr(feats, k).detach().cpu().numpy()
            for k in _FEATURE_FIELDS if getattr(feats, k) is not None}
    np.savez_compressed(path, **data)


def load_frame_features(path: str) -> FrameFeatures:
    """Features from an .npz cache of either package, as CPU tensors
    (``FrameFeatures.to`` moves them)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"[odometry]: feature cache missing: {path}")
    z = np.load(path)
    return FrameFeatures(**{k: torch.from_numpy(np.array(z[k]))
                            for k in _FEATURE_FIELDS if k in z.files})


def run_odometry_windowed(scan_stream, config: PipelineConfig =
                          PipelineConfig(), window: int = 16,
                          stats: Optional[dict] = None, device=None):
    """Windowed streaming odometry.

    Buffers ``window`` frames, extracts their features as ONE batch, and
    registers the window's consecutive pairs (including the boundary pair
    to the previous window's last frame, so no pair is lost) through
    ``register_pairs``. Window k's results are read back only after
    window k+1 has been issued, as in the JAX package; poses arrive with
    up to 2W frames of lag. Each frame is extracted once (FPFHManager's
    swapTgt2Src reuse, fpfh_manager.hpp:74-118).

    ``scan_stream`` yields (points (N, 3), mask (N,)) per frame, all of
    one capacity N. Yields (frame_index, solution | None, overlap | None)
    in frame order (frame 0 has no pair); solutions are read back to the
    CPU. ``stats``, when given, accumulates "dispatch_s" (host time
    building and issuing the device work) and "fetch_s" (host time blocked
    reading results back).
    """
    runner = OdometryRunner(config, device)
    dev = runner.device
    prev: Optional[FrameFeatures] = None   # last frame, leading axis of 1
    buf_p, buf_m, buf_i = [], [], []
    frame_no = 0
    if stats is not None:
        stats.setdefault("dispatch_s", 0.0)
        stats.setdefault("fetch_s", 0.0)

    def dispatch():
        """Extract and register the buffered window; return its frame
        indices, 1 if its first frame has no predecessor (else 0), and the
        (solutions, overlaps) of its pairs, still on the device."""
        nonlocal prev
        if not buf_p:
            return None
        t0 = time.perf_counter()
        w = len(buf_p)
        feats = runner._extract_impl(torch.stack(buf_p), torch.stack(buf_m))
        if prev is None:        # the very first frame has no predecessor
            first, srcs, tgts = 1, feats.rows(0, w - 1), feats.rows(1, w)
        else:
            first, srcs, tgts = 0, FrameFeatures.cat(
                [prev, feats.rows(0, w - 1)]), feats
        pending = (runner.register_pairs(srcs, tgts)
                   if tgts.voxels.shape[0] else None)
        prev = feats.rows(w - 1, w)
        idxs = list(buf_i)
        buf_p.clear(), buf_m.clear(), buf_i.clear()
        if stats is not None:
            stats["dispatch_s"] += time.perf_counter() - t0
        return idxs, first, pending

    def fetch(job):
        if job is None:
            return []
        idxs, first, pending = job
        t0 = time.perf_counter()
        out = [(idxs[0], None, None)] if first else []
        if pending is not None:
            sols = RegistrationSolution(*(
                getattr(pending[0], f.name).cpu()
                for f in fields(RegistrationSolution)))
            overlaps = pending[1].tolist()
            for k, idx in enumerate(idxs[first:]):
                out.append((idx, sols.take(k), float(overlaps[k])))
        if stats is not None:
            stats["fetch_s"] += time.perf_counter() - t0
        return out

    pending = None
    for pts, mask in scan_stream:
        buf_p.append(to_tensor(pts, torch.float32, dev))
        buf_m.append(to_tensor(mask, torch.bool, dev))
        buf_i.append(frame_no)
        frame_no += 1
        if len(buf_p) == window:
            cur = dispatch()
            yield from fetch(pending)
            pending = cur
    cur = dispatch()
    yield from fetch(pending)
    yield from fetch(cur)


def _file_stream(paths, capacity: int, n_workers: int, queue_depth: int):
    """Each KITTI .bin as (points (capacity, 3), mask (capacity,)) numpy
    arrays, in file order: through the native prefetching ``ScanLoader``
    (disk IO for the frames ahead overlaps the device work on this one),
    or one ``load_kitti_bin`` at a time where the native library does not
    build. Closing the generator closes the loader."""
    from quatro_tpu_torch import native
    from quatro_tpu_torch.io.kitti import load_kitti_bin

    if not native.available():
        for p in paths:
            pb = PointBatch.from_numpy(load_kitti_bin(p), capacity)
            yield pb.points.numpy(), pb.mask.numpy()
        return
    with native.ScanLoader(paths, capacity=capacity, n_workers=n_workers,
                           queue_depth=queue_depth) as loader:
        yield from loader


def run_odometry_files_windowed(paths, config: PipelineConfig =
                                PipelineConfig(), window: int = 16,
                                capacity: Optional[int] = None,
                                n_workers: int = 4, queue_depth: int = 0,
                                device=None):
    """Windowed odometry (``run_odometry_windowed``) over KITTI .bin
    files read by the native prefetching loader. queue_depth defaults to
    2 * window, so the disk IO of the next window overlaps the device
    work of this one."""
    capacity = capacity or config.max_raw_points
    stream = _file_stream(paths, capacity, n_workers,
                          queue_depth or 2 * window)
    try:
        yield from run_odometry_windowed(stream, config, window=window,
                                         device=device)
    finally:
        stream.close()


def run_odometry_files(paths, config: PipelineConfig = PipelineConfig(),
                       capacity: Optional[int] = None, n_workers: int = 4,
                       queue_depth: int = 8, device=None):
    """Stream a sequence of KITTI .bin scans through the odometry runner,
    read by the native prefetching loader (frames k+1 .. k+queue_depth
    load while frame k is registered). Yields (frame_index,
    RegistrationSolution | None) per frame."""
    capacity = capacity or config.max_raw_points
    runner = OdometryRunner(config, device)
    stream = _file_stream(paths, capacity, n_workers, queue_depth)
    try:
        for i, (pts, mask) in enumerate(stream):
            yield i, runner.step(PointBatch(torch.from_numpy(pts),
                                            torch.from_numpy(mask)))
    finally:
        stream.close()
