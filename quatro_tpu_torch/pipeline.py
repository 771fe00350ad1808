"""The registration pipeline: [Patchwork ground removal -> range-image
sub-clustering ->] voxel -> normals -> FPFH -> matching -> Quatro solve.

PyTorch counterpart of ``quatro_tpu/pipeline.py`` (the reference's
application flow, examples/run_global_registration.cpp:127-251):
``register_scan_pair`` takes raw scans, ``register_features`` clouds whose
ground is already removed. The source and target clouds go through
preprocessing and feature extraction as one batch of two.

Entry points take ``device=None`` (the card; see device.py) and an
optional ``timer``: a callable given the name of each stage as it ends,
for per-stage timing: "patchwork" and "projection" (raw scans only), then
"voxel", "normals", "fpfh", "matching", then the solver's "graph",
"cliques" and "polish", with "vote" before "polish" and "arbitration"
after it on the multi-hypothesis path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from quatro_tpu_torch.config import PipelineConfig
from quatro_tpu_torch.device import resolve_device, to_tensor
from quatro_tpu_torch.ops.matching import Correspondences, match_features
from quatro_tpu_torch.ops.voxel import voxel_downsample
from quatro_tpu_torch.preprocessing.patchwork import estimate_ground
from quatro_tpu_torch.preprocessing.projection import segment_cloud
from quatro_tpu_torch.solver.quatro import (register_correspondences,
                                            register_hypotheses)
from quatro_tpu_torch.solver.verify import arbitrate_hypotheses
from quatro_tpu_torch.types import PointBatch, RegistrationSolution


class PipelineResult(NamedTuple):
    solution: RegistrationSolution
    correspondences: Correspondences
    src_voxels: PointBatch
    tgt_voxels: PointBatch
    icp: None = None           # ICP refinement is not ported yet
    # the multi-hypothesis path's K solutions and their overlaps (K,)
    hypotheses: Optional[RegistrationSolution] = None
    overlaps: Optional[torch.Tensor] = None


def _noop(stage: str) -> None:
    pass


def extract_features(points, mask, config: PipelineConfig, device=None,
                     timer: Optional[Callable[[str], None]] = None):
    """Voxel downsample -> normals -> FPFH for one cloud (N, 3) or a batch
    of clouds (B, N, 3) of one capacity.

    Returns (voxel PointBatch, descriptors (.., V, 33), descriptor mask,
    Normals), with the batch axis when the input had one. On the card the
    kernel front end (ops/frontend.py) always runs, whatever V is, and
    ``use_pallas_frontend=False`` raises ValueError. On the CPU the JAX
    package's dispatch holds: the kernel path's plain versions when
    ``config.fpfh.use_pallas_frontend`` is True and V is a multiple of 512,
    else the dense path.
    """
    from quatro_tpu_torch.ops.dense_features import dense_fpfh, dense_normals
    from quatro_tpu_torch.ops.frontend import frontend_fpfh, frontend_normals
    from quatro_tpu_torch.ops.normals import Normals

    timer = timer or _noop
    dev = resolve_device(device)
    pts = to_tensor(points, torch.float32, dev)
    msk = to_tensor(mask, torch.bool, dev)
    batched = pts.dim() == 3
    if not batched:
        pts, msk = pts[None], msk[None]
    if dev.type == "cuda" and config.fpfh.use_pallas_frontend is False:
        raise ValueError("use_pallas_frontend=False selects the dense plain "
                         "front end, which runs on the CPU only; on the "
                         "card the front end is the kernels")

    vox = [voxel_downsample(p, m, config.voxel_size, config.max_voxels,
                            active_cap=config.max_segment_points)
           for p, m in zip(pts, msk)]
    vox_pts = torch.stack([v[0] for v in vox]).contiguous()
    vox_mask = torch.stack([v[1] for v in vox]).contiguous()
    timer("voxel")
    if dev.type == "cuda" or (config.fpfh.use_pallas_frontend
                              and vox_pts.shape[1] % 512 == 0):
        normals = frontend_normals(vox_pts, vox_mask,
                                   config.fpfh.normal_radius)
        timer("normals")
        desc = frontend_fpfh(vox_pts, normals.normals, normals.valid,
                             vox_mask, config.fpfh.fpfh_radius)
    else:
        normals = dense_normals(vox_pts, vox_mask, config.fpfh.normal_radius)
        timer("normals")
        desc = dense_fpfh(vox_pts, normals.normals, normals.valid, vox_mask,
                          config.fpfh.fpfh_radius)
    timer("fpfh")
    desc_mask = vox_mask & normals.valid
    if not batched:
        return (PointBatch(vox_pts[0], vox_mask[0]), desc[0], desc_mask[0],
                Normals(*(t[0] for t in normals)))
    return PointBatch(vox_pts, vox_mask), desc, desc_mask, normals


def register_features(src: PointBatch, tgt: PointBatch,
                      config: PipelineConfig = PipelineConfig(),
                      device=None,
                      timer: Optional[Callable[[str], None]] = None
                      ) -> PipelineResult:
    """Feature extraction + matching + solve on already-preprocessed
    clouds. With ``config.solver.total_hypotheses > 1`` (as in
    ``PipelineConfig.recommended()``) the solver returns clique and vote
    hypotheses and the one whose pose best overlaps the voxel clouds
    within 2 * voxel_size wins (solver/verify.py)."""
    if config.icp.enabled:
        raise NotImplementedError("ICP refinement is not ported yet")
    timer = timer or _noop
    dev = resolve_device(device)
    src, tgt = src.to(dev), tgt.to(dev)
    if src.points.shape == tgt.points.shape:
        vox, desc, dmask, _ = extract_features(
            torch.stack([src.points, tgt.points]),
            torch.stack([src.mask, tgt.mask]), config, dev, timer)
        src_vox = PointBatch(vox.points[0], vox.mask[0])
        tgt_vox = PointBatch(vox.points[1], vox.mask[1])
        src_desc, tgt_desc = desc[0], desc[1]
        src_dmask, tgt_dmask = dmask[0], dmask[1]
    else:
        src_vox, src_desc, src_dmask, _ = extract_features(
            src.points, src.mask, config, dev, timer)
        tgt_vox, tgt_desc, tgt_dmask, _ = extract_features(
            tgt.points, tgt.mask, config, dev, timer)

    f = config.fpfh
    corr = match_features(
        src_vox.points, tgt_vox.points, src_desc, tgt_desc,
        src_dmask, tgt_dmask, capacity=f.max_correspondences,
        use_crosscheck=f.use_crosscheck,
        crosscheck_min_matches=f.crosscheck_min_matches,
        use_tuple_test=f.use_tuple_test, tuple_scale=f.tuple_scale,
        trials_per_corr=f.tuple_trials_per_corr,
        tuple_min_keep=f.tuple_min_keep, seed=f.tuple_seed, device=dev)
    timer("matching")
    if config.solver.total_hypotheses <= 1:
        sol = register_correspondences(corr.src_xyz, corr.tgt_xyz, corr.mask,
                                       config.solver, device=dev, timer=timer)
        return PipelineResult(sol, corr, src_vox, tgt_vox)
    sols = register_hypotheses(corr.src_xyz, corr.tgt_xyz, corr.mask,
                               config.solver, k=config.solver.num_hypotheses,
                               device=dev, timer=timer)
    sol, overlaps = arbitrate_hypotheses(
        sols, src_vox.points, src_vox.mask, tgt_vox.points, tgt_vox.mask,
        radius=2.0 * config.voxel_size)
    timer("arbitration")
    return PipelineResult(sol, corr, src_vox, tgt_vox, hypotheses=sols,
                          overlaps=overlaps)


def preprocess(points, mask, config: PipelineConfig, device=None,
               timer: Optional[Callable[[str], None]] = None):
    """Ground segmentation and sub-cluster rejection of raw scans (N, 3)
    or a batch (B, N, 3) (the reference's STEP 2-3,
    examples/run_global_registration.cpp:128-162): in Patchwork mode the
    ground goes first and the non-ground cloud is clustered; in LeGO-LOAM
    mode the raw cloud is clustered with its own vertical-angle ground
    test. Returns (valid_segment_mask, ground_mask), shaped as mask."""
    timer = timer or _noop
    dev = resolve_device(device)
    pts = to_tensor(points, torch.float32, dev)
    msk = to_tensor(mask, torch.bool, dev)
    if config.ground_segmentation_mode == "Patchwork":
        pw = estimate_ground(pts, msk, config.patchwork)
        timer("patchwork")
        if not config.use_subclustering:
            return pw.nonground, pw.ground
        proj = segment_cloud(pts, pw.nonground, config.lidar,
                             config.projection, ground_mode="Patchwork",
                             max_points=config.max_nonground_points)
        timer("projection")
        return proj.valid_segments, pw.ground
    # LeGO-LOAM clusters the raw cloud: no non-ground bound applies
    proj = segment_cloud(pts, msk, config.lidar, config.projection,
                         ground_mode="LeGO-LOAM")
    timer("projection")
    return proj.valid_segments, proj.ground


def register_scan_pair(src: PointBatch, tgt: PointBatch,
                       config: PipelineConfig = PipelineConfig(),
                       device=None,
                       timer: Optional[Callable[[str], None]] = None
                       ) -> PipelineResult:
    """The full pipeline on raw scans: Patchwork ground removal ->
    range-image sub-cluster rejection -> ``register_features`` on the
    segment masks. Both scans are preprocessed as one batch of two
    whatever ``stack_preprocess`` says (that knob chose between two XLA
    programs on the TPU; per cloud the results are the same); scans of
    different capacities go one at a time. Ground alignment and ICP are
    not ported yet and raise NotImplementedError."""
    if config.ground_alignment.enabled:
        raise NotImplementedError("ground alignment is not ported yet")
    if config.icp.enabled:
        raise NotImplementedError("ICP refinement is not ported yet")
    dev = resolve_device(device)
    src, tgt = src.to(dev), tgt.to(dev)
    if src.points.shape == tgt.points.shape:
        seg, _ = preprocess(torch.stack([src.points, tgt.points]),
                            torch.stack([src.mask, tgt.mask]), config, dev,
                            timer)
        src_seg, tgt_seg = seg[0], seg[1]
    else:
        src_seg, _ = preprocess(src.points, src.mask, config, dev, timer)
        tgt_seg, _ = preprocess(tgt.points, tgt.mask, config, dev, timer)
    return register_features(PointBatch(src.points, src_seg),
                             PointBatch(tgt.points, tgt_seg), config, dev,
                             timer)
