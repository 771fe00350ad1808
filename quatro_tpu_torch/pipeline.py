"""The registration pipeline: [Patchwork ground removal -> range-image
sub-clustering -> ground-plane leveling ->] voxel -> normals -> FPFH ->
matching -> Quatro solve [-> compose the leveling back -> ICP polish].

PyTorch counterpart of ``quatro_tpu/pipeline.py`` (the reference's
application flow, examples/run_global_registration.cpp:127-251):
``register_scan_pair`` takes raw scans, ``register_features`` clouds whose
ground is already removed. Both take one pair or a batch of B pairs
(the JAX package's ``jit(vmap(...))`` serving path): the B source and B
target clouds go through preprocessing and feature extraction as one
batch of 2B, the matcher and the solver over the pair axis, with no loop
over pairs or clouds.

Entry points take ``device=None`` (the card; see device.py) and an
optional ``timer``: a callable given the name of each stage as it ends,
for per-stage timing: "patchwork" and "projection" (raw scans only),
"leveling" (ground alignment), then "voxel", "normals", "fpfh",
"matching", then the solver's "graph", "cliques" and "polish", with
"vote" before "polish" and "arbitration" after it on the
multi-hypothesis path, and "icp" last when ICP is on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from quatro_tpu_torch.config import PipelineConfig
from quatro_tpu_torch.device import resolve_device, to_tensor
from quatro_tpu_torch.ops.matching import Correspondences, match_features
from quatro_tpu_torch.ops.neighbors import radius_neighbors
from quatro_tpu_torch.ops.normals import estimate_normals
from quatro_tpu_torch.ops.voxel import voxel_downsample
from quatro_tpu_torch.preprocessing.patchwork import estimate_ground
from quatro_tpu_torch.preprocessing.projection import segment_cloud
from quatro_tpu_torch.solver.ground import (align_ground,
                                            compose_leveled_solution)
from quatro_tpu_torch.solver.icp import IcpResult, refine_icp
from quatro_tpu_torch.solver.quatro import (register_correspondences,
                                            register_hypotheses)
from quatro_tpu_torch.solver.verify import arbitrate_hypotheses
from quatro_tpu_torch.types import PointBatch, RegistrationSolution
from quatro_tpu_torch.utils.batch import drop_axis, stack_rows, take_row
from quatro_tpu_torch.utils.se3 import rotate_points


class PipelineResult(NamedTuple):
    # one pair's; a batched call gives every tensor a leading B
    solution: RegistrationSolution
    correspondences: Correspondences
    src_voxels: PointBatch
    tgt_voxels: PointBatch
    # the point-to-plane refinement's details when config.icp.enabled
    icp: Optional[IcpResult] = None
    # the multi-hypothesis path's K solutions and their overlaps (K,)
    hypotheses: Optional[RegistrationSolution] = None
    overlaps: Optional[torch.Tensor] = None

    def row(self, b: int) -> "PipelineResult":
        """Pair b's result of a batched call."""
        return take_row(self, b)

    @staticmethod
    def stack(rows) -> "PipelineResult":
        """Results stacked along a new leading pair axis."""
        return stack_rows(list(rows))


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

    vox_pts, vox_mask = voxel_downsample(pts, msk, config.voxel_size,
                                         config.max_voxels,
                                         active_cap=config.max_segment_points)
    vox_pts, vox_mask = vox_pts.contiguous(), vox_mask.contiguous()
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


def _pair_axis(src: PointBatch, tgt: PointBatch, dev):
    """Both clouds on the device with a leading pair axis (added for one
    pair: the flag says so)."""
    src, tgt = src.to(dev), tgt.to(dev)
    one = src.points.dim() == 2
    if one:
        src = PointBatch(src.points[None], src.mask[None])
        tgt = PointBatch(tgt.points[None], tgt.mask[None])
    if src.points.shape[0] != tgt.points.shape[0]:
        raise ValueError(f"{src.points.shape[0]} source and "
                         f"{tgt.points.shape[0]} target clouds")
    return src, tgt, one


def _both(fn, src_points, src_mask, tgt_points, tgt_mask):
    """``fn`` on the source and target clouds (B, N, 3) as one batch of 2B
    where their capacities agree, else one after the other; returns the
    source's and the target's outputs."""
    bsz = src_points.shape[0]
    if src_points.shape == tgt_points.shape:
        out = fn(torch.cat([src_points, tgt_points]),
                 torch.cat([src_mask, tgt_mask]))
        return take_row(out, slice(0, bsz)), take_row(out, slice(bsz, None))
    return fn(src_points, src_mask), fn(tgt_points, tgt_mask)


def register_features(src: PointBatch, tgt: PointBatch,
                      config: PipelineConfig = PipelineConfig(),
                      device=None,
                      timer: Optional[Callable[[str], None]] = None
                      ) -> PipelineResult:
    """Feature extraction + matching + solve on already-preprocessed
    clouds: one pair (N, 3), or a batch of B pairs (B, N, 3) in one call
    with a leading B on the result (each row the per-pair call's). With
    ``config.solver.total_hypotheses > 1`` (as in
    ``PipelineConfig.recommended()``) the solver returns clique and vote
    hypotheses and the one whose pose best overlaps the voxel clouds
    within 2 * voxel_size wins (solver/verify.py). With
    ``config.icp.enabled`` the pose is then polished by point-to-plane
    ICP on these clouds (``refine_solution``)."""
    timer = timer or _noop
    dev = resolve_device(device)
    src, tgt, one = _pair_axis(src, tgt, dev)
    (src_vox, src_desc, src_dmask, _), (tgt_vox, tgt_desc, tgt_dmask, _) = \
        _both(lambda p, m: extract_features(p, m, config, dev, timer),
              src.points, src.mask, tgt.points, tgt.mask)

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
    sols = overlaps = icp_res = None
    if config.solver.total_hypotheses <= 1:
        sol = register_correspondences(corr.src_xyz, corr.tgt_xyz, corr.mask,
                                       config.solver, device=dev, timer=timer)
    else:
        sols = register_hypotheses(corr.src_xyz, corr.tgt_xyz, corr.mask,
                                   config.solver,
                                   k=config.solver.num_hypotheses,
                                   device=dev, timer=timer)
        sol, overlaps = arbitrate_hypotheses(
            sols, src_vox.points, src_vox.mask, tgt_vox.points, tgt_vox.mask,
            radius=2.0 * config.voxel_size)
        timer("arbitration")
    if config.icp.enabled:
        sol, icp_res = refine_solution(src.points, src.mask, tgt.points,
                                       tgt.mask, sol, config)
        timer("icp")
    res = PipelineResult(sol, corr, src_vox, tgt_vox, icp_res,
                         hypotheses=sols, overlaps=overlaps)
    return drop_axis(res) if one else res


def raw_scan_voxels(points, mask, config: PipelineConfig):
    """ICP's voxels of raw scans, one (N, 3) or a batch (B, N, 3) in one
    call, with no ``active_cap`` (a raw scan keeps all its points, ground
    included: the plane Patchwork removes is what constrains z). Returns
    (voxels, voxel mask). ``refine_solution`` and
    ``OdometryRunner.extract`` both take ICP's features from here and
    ``raw_scan_normals``."""
    return voxel_downsample(points, mask, config.voxel_size,
                            config.max_voxels)


def raw_scan_normals(vox, vmask, config: PipelineConfig,
                     timer: Optional[Callable[[str], None]] = None):
    """ICP's target normals of ``raw_scan_voxels``' output, from K-capped
    radius neighbours, in one call for the batch (on the card one launch
    each of csrc/knn.cu and csrc/neighbor_normals.cu); ``timer`` marks
    "icp lists" after the lists."""
    nbrs = radius_neighbors(vox, vmask, config.fpfh.normal_radius,
                            config.fpfh.max_neighbors_normal)
    (timer or _noop)("icp lists")
    return estimate_normals(vox, nbrs)


def refine_solution(src_points, src_mask, tgt_points, tgt_mask,
                    sol: RegistrationSolution, config: PipelineConfig,
                    timer: Optional[Callable[[str], None]] = None):
    """Point-to-plane ICP polish of a coarse solution on the given clouds
    (the JAX package's refine_solution), for one pair (N, 3) or a batch
    (B, N, 3): both sides' raw-scan voxels in one batch of 2B
    (``raw_scan_voxels``), the target's normals (``raw_scan_normals``),
    then ``refine_icp`` gated on
    ``sol.valid``. Pass clouds that still hold the ground: without it z
    is unconstrained wherever the remaining structure is vertical.
    ``timer`` marks the sub-steps "icp voxels", "icp lists", "icp
    normals", "icp passes" and "icp final".
    Returns (solution with the refined pose, IcpResult)."""
    if src_points.dim() == 2:
        return drop_axis(refine_solution(
            src_points[None], src_mask[None], tgt_points[None],
            tgt_mask[None], take_row(sol, None), config, timer))
    timer = timer or _noop
    (vox_s, m_s), (vox_t, m_t) = _both(
        lambda p, m: raw_scan_voxels(p, m, config), src_points, src_mask,
        tgt_points, tgt_mask)
    timer("icp voxels")
    normals = raw_scan_normals(vox_t, m_t, config, timer)
    timer("icp normals")
    icp_res = refine_icp(vox_s, m_s, vox_t, m_t, normals.normals,
                         normals.valid, sol.rotation, sol.translation,
                         config.icp, valid=sol.valid, timer=timer)
    return dataclasses.replace(sol, rotation=icp_res.rotation,
                               translation=icp_res.translation), icp_res


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
    """The full pipeline on raw scans (examples/run_global_registration.cpp:
    127-251): Patchwork ground removal -> range-image sub-cluster
    rejection -> [ground-plane leveling] -> ``register_features`` on the
    segment masks -> [compose the leveling back] -> [ICP polish].

    One pair of scans (N, 3), or a batch of B pairs (B, N, 3) in one call
    with a leading B on every tensor of the result, each row the per-pair
    call's (the JAX package's ``jit(vmap(register_scan_pair))``). The
    source and target scans are preprocessed as one batch of 2B whatever
    ``stack_preprocess`` says (that knob chose between two XLA programs on
    the TPU; per cloud the results are the same); scans of different
    capacities go apart. With ``config.ground_alignment.enabled``
    both scans are leveled by their fitted ground planes before the
    yaw-only solve and the pose is composed back (full 6-DoF, the Quatro++
    extension, solver/ground.py); the correspondences, voxel clouds and
    hypotheses are then in the leveled frames, the solution always in the
    raw ones. With ``config.icp.enabled`` the coarse solve runs with ICP
    off and the pose is polished on the raw clouds, ground included.
    """
    timer = timer or _noop
    dev = resolve_device(device)
    src, tgt, one = _pair_axis(src, tgt, dev)
    (src_seg, src_ground), (tgt_seg, tgt_ground) = _both(
        lambda p, m: preprocess(p, m, config, dev, timer),
        src.points, src.mask, tgt.points, tgt.mask)

    coarse_cfg = config
    if config.icp.enabled:
        coarse_cfg = dataclasses.replace(
            config, icp=dataclasses.replace(config.icp, enabled=False))
    ga = None
    src_pts, tgt_pts = src.points, tgt.points
    if config.ground_alignment.enabled:
        ga = align_ground(src.points, src_ground & src.mask, tgt.points,
                          tgt_ground & tgt.mask, config.ground_alignment)
        src_pts = rotate_points(src.points, ga.src_level)     # points @ L.T
        tgt_pts = rotate_points(tgt.points, ga.tgt_level)
        timer("leveling")

    res = register_features(PointBatch(src_pts, src_seg),
                            PointBatch(tgt_pts, tgt_seg), coarse_cfg, dev,
                            timer)
    sol = res.solution
    if ga is not None:
        rot, t = compose_leveled_solution(
            sol.rotation, sol.translation, ga,
            use_ground_z=config.ground_alignment.use_ground_z)
        sol = dataclasses.replace(sol, rotation=rot, translation=t)
    icp_res = res.icp
    if config.icp.enabled:
        sol, icp_res = refine_solution(src.points, src.mask, tgt.points,
                                       tgt.mask, sol, config)
        timer("icp")
    res = res._replace(solution=sol, icp=icp_res)
    return drop_axis(res) if one else res
