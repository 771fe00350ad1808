#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when a check fails:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the float32 precision flags (TF32 off everywhere);
2. build: the twelve kernels from quatro_tpu_torch/csrc, one nvcc per
   source, all started together; build time and ptxas register and spill
   summary;
3. path A, the main path (Quatro++ coarse to fine): ``register_scan_pair``
   on the raw seed-11 HDL-64E synthetic pair (the pair of
   tests/test_pipeline.py, capacity 131072) tilted as tests/test_ground.py
   tilts it, under ``PipelineConfig.recommended(max_voxels=8192)`` with
   ground alignment and ICP on: Patchwork ground removal, range-image
   sub-clustering, ground-plane leveling of both scans, 8192 voxels, 1024
   correspondences, 4 clique + 2 vote hypotheses arbitrated by overlap on
   the leveled clouds, the pose composed back with the ground-height z,
   then point-to-plane ICP on the raw voxel clouds. The pose must be valid,
   within 0.01 rad / 0.05 m of the tilted ground truth, ICP converged, and
   the launch counts over the run 1 (moments), 1 (SPFH), 1 (FPFH), 0
   (1-NN), 2 (top-2 NN), 1 (consistency graph), 1 (segment sums), 1 (cross
   histogram), 3 (plane-fit moments), 1 (classification), 1 (image
   lookup), 0 (table lookup). Per-stage times from CUDA events after one
   warm-up run
   ("leveling" and "icp" among them); ground, non-ground and segment points
   per cloud; the hypotheses and the winner; the pair latency over five
   more runs;
4. path B, the reference matcher: ``register_scan_pair`` on the untilted
   raw pair under ``PipelineConfig(max_voxels=8192)`` with
   ``crosscheck_min_matches=0`` (crosscheck and tuple test with no
   starvation fallback, the single-clique solver): valid, within 0.05 rad
   / 0.6 m, launches 2 (1-NN), 0 (top-2 NN), 0 (segment sums); three timed
   runs. Then ``register_correspondences`` on its correspondences under
   each solver mode off the shipping path (TEASER full SO(3), FGR, the TLS
   scale, exact clique): each valid and within 0.01 rad / 0.1 m of path
   B's own pose, the scale within 0.02 of 1; each mode's time and GNC
   iterations, and the exact search's completion, restriction and steps;
   then TEASER on the JAX package's own path B correspondences
   (tests/torch_teaser_path_b.npz), against the JAX package's TEASER pose
   on the CPU;
5. earlier paths: ``register_scan_pair`` on the untilted raw pair under
   the recommended configuration (the main path before ground alignment
   and ICP), and
   ``register_features`` on the pair after a crude ground strip (65536
   points per cloud), recommended (preprocessing launches 0) and single
   hypothesis (also 0 segment sums), with their bands (0.05 rad / 0.6 m
   raw, 0.05 rad / 0.5 m stripped), stage split and latency;
6. path S, loop closing: ``run_sequence`` over the 12 scans of
   ``make_synthetic_sequence(num_poses=12, seed=1, radius=6.0)`` (HDL-64E,
   capacity 131072) under path A's configuration, with Scan Context
   supplying the loop candidates (ground truth only for the ATE). Gates,
   the JAX package's own for this run (tests/test_scancontext.py:87-98):
   a loop found (more than 11 edges), >= 60 % of the edges valid, ATE
   after the closure < 1 m and <= ATE before + 0.15 m, every pose finite;
   the launch counts per frame (B3-B5, B8, B10, B11 once, B9 three
   times), per registered edge (B7 twice, B1 and B2 once, the last batch
   padded to 16 edges) and per pose-graph solve (B2 once per J^T apply,
   10 x 41); a second ``optimize_pose_graph`` on the run's edges equal to
   it bit for bit; ``run_odometry_windowed(window=4)`` equal to
   ``OdometryRunner.step`` within 1e-5 rad / 1e-4 m. Times: per-frame
   extraction and per-edge registration (median and spread), Scan
   Context, the pose graph, the whole sequence, and the device idle share
   of one ``OdometryRunner.step``;
7. profile: one more run of path A under torch.profiler (after the timed
   runs, since the profiler slows the host for the runs after it): the
   card's busy time, its idle share of the median pair, the top kernels
   and the device time per launch of each of the port's kernels, and of
   B3's, B4's, B5's and B9's wrappers with all their kernels;
8. kernels: each kernel on the main path's own tensors (B6 on path B's
   descriptors, B12 on the rows B10 was handed) against its plain PyTorch
   version, with its time, the plain version's time, the least time the
   card could take for the same work, and one library call computing the
   same function where there is one (1-NN, top-2 NN, segment sums, cross
   histogram, image lookup, table lookup). B2, B3 (with its active limits
   and the tile pairs it tested and skipped), B5 (alone and on B4's tile
   table), B6, B7 (both directions, with the active limits it found), B8
   and B9 (both flags, with its active limits) are held bit for bit
   against their plain versions run on CPU copies of the same inputs and
   across two launches, B2 also on the arguments of one J^T apply of path
   S's pose graph, with a row of its own (``pose_graph`` in B2's row), and
   B1 also on a seeded N = 1000 (rows that start inside a 16-byte piece),
   and its branch-free square root against __fsqrt_rn on every
   non-negative float;
   B4's counts and bins equal those of its plain
   version run on the card (the same rsqrtf and atan2f), and the tile
   pairs kept at the FPFH radius are printed. Each row also
   has the device time per call of the kernel and of the library call
   (torch.profiler, from a profiled run that saw every call), so that the
   two compare like with like. The bounds of the radius-pair kernels (B3,
   B4, B5) count the radius tests of the valid pairs in the tile pairs
   that an exact culling keeps (``culled_pairs``), and their bytes the
   mask and the outputs of every row but the points, normals and SPFH
   rows of the valid rows only (``radius_pair_bytes``): the kernels read
   no other.

The last two lines of standard output are the card's kernel table as one
JSON object and ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the quatro_tpu_torch package beside it, it fails before
printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): f32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# f32 operations per pair, counted from the kernels' sources: the radius
# test (3 sub, 3 mul, 2 add, 1 compare) on every pair of valid points that
# an exact tile culling leaves (``culled_pairs``), and the work on each
# pair inside the radius.
OPS_PAIR_TEST = 9
OPS_MOMENTS = 16          # 10 accumulations, 6 products
OPS_SPFH = 80             # Darboux frame, atan2 and three bins (approx.)
OPS_FPFH = 2 + 2 * 33     # weight (max, divide), 33 products and sums
OPS_NN = 2 * 33 + 4       # 33 FMAs, the expansion, the top-2 compares
OPS_NN1 = 2 * 33 + 4      # 33 FMAs, the expansion (3), the compare
OPS_GRAPH = 21            # per pair: 2 x (3 sub, 3 mul, 2 add, sqrt),
                          # sub, abs, compare
OPS_PLANE = 6             # per point: projection (3 mul, 2 add), compare
OPS_MOMENTS_PT = 16       # per member point: 6 products, 10 additions
OPS_CLASSIFY = 8          # projection, compare, flag arithmetic

PAIR_REPEATS = 5          # timed runs of path A
PATH_B_REPEATS = 3
EARLIER_REPEATS = 3       # timed runs of each earlier path
PIPELINE_PAIR = dict(seed=11, yaw_deg=20.0, translation=(2.5, 1.0, 0.05))
RAW_CAPACITY = 131072
# path A's platform tilts (tests/test_ground.py:142-151), roll/pitch/yaw
TILT_SRC = (0.07, -0.05, 0.0)
TILT_TGT = (-0.04, 0.06, 0.0)
SOLVER_MODES = {"TEASER": dict(reg_name="TEASER"),
                "FGR": dict(rotation_estimation_algorithm="FGR"),
                "TLS scale": dict(estimate_scaling=True),
                "exact": dict(inlier_selection_mode="exact")}

REPLACES = {
    "moment_sums": "quatro_tpu/ops/pallas_frontend.py:293",
    "spfh": "quatro_tpu/ops/pallas_frontend.py:366",
    "fpfh": "quatro_tpu/ops/pallas_frontend.py:391",
    "nearest_neighbors": "quatro_tpu/ops/pallas_frontend.py:622",
    "nearest_neighbors2": "quatro_tpu/ops/pallas_frontend.py:550",
    "consistency_graph": "quatro_tpu/ops/pallas_kernels.py:47",
    "segment_sums": "quatro_tpu/ops/segment_matmul.py:158",
    "cross_histogram": "quatro_tpu/ops/segment_matmul.py:225",
    "fit_iteration_moments": "quatro_tpu/ops/segment_matmul.py:309",
    "classify_points": "quatro_tpu/ops/segment_matmul.py:385",
    "image_lookup": "quatro_tpu/ops/segment_matmul.py:482",
    "table_lookup": "quatro_tpu/ops/segment_matmul.py:420",
}
SOURCES = {
    "moment_sums": "quatro_tpu_torch/csrc/moment_sums.cu",
    "spfh": "quatro_tpu_torch/csrc/spfh.cu",
    "fpfh": "quatro_tpu_torch/csrc/fpfh.cu",
    "nearest_neighbors": "quatro_tpu_torch/csrc/nn1.cu",
    "nearest_neighbors2": "quatro_tpu_torch/csrc/nn2.cu",
    "consistency_graph": "quatro_tpu_torch/csrc/consistency_graph.cu",
    "segment_sums": "quatro_tpu_torch/csrc/segment_sums.cu",
    "cross_histogram": "quatro_tpu_torch/csrc/cross_histogram.cu",
    "fit_iteration_moments": "quatro_tpu_torch/csrc/fit_iteration_moments.cu",
    "classify_points": "quatro_tpu_torch/csrc/classify_points.cu",
    "image_lookup": "quatro_tpu_torch/csrc/image_lookup.cu",
    "table_lookup": "quatro_tpu_torch/csrc/table_lookup.cu",
}
MAIN_LAUNCHES = {"moment_sums": 1, "spfh": 1, "fpfh": 1,
                 "nearest_neighbors": 0, "nearest_neighbors2": 2,
                 "consistency_graph": 1, "segment_sums": 1,
                 "cross_histogram": 1, "fit_iteration_moments": 3,
                 "classify_points": 1, "image_lookup": 1, "table_lookup": 0}
PATH_B_LAUNCHES = dict(MAIN_LAUNCHES, nearest_neighbors=2,
                       nearest_neighbors2=0, segment_sums=0)
FEATURES_LAUNCHES = dict(MAIN_LAUNCHES, cross_histogram=0,
                         fit_iteration_moments=0, classify_points=0,
                         image_lookup=0)
SINGLE_LAUNCHES = dict(FEATURES_LAUNCHES, segment_sums=0)
# path S: make_synthetic_sequence's arguments, run_sequence's edge batch
# and pose-graph trip counts, and the windowed runner's window
SEQUENCE = dict(num_poses=12, seed=1, radius=6.0)
SEQ_BATCH = 16
PG_ITERS = (10, 40)
SEQ_WINDOW = 4


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def nonground(xyz, sensor_height=1.723, margin=0.3):
    """The crude ground strip of tests/test_pipeline.py, for the earlier
    paths that take clouds without ground."""
    return xyz[xyz[:, 2] > -sensor_height + margin]


def pose_errors(sol, gt):
    """(rotation error rad, translation error m) of a solution against a
    4x4 ground truth (numpy)."""
    from quatro_tpu_torch.utils.se3 import rotation_geodesic_error
    rot = sol.rotation.detach().cpu()
    rerr = float(rotation_geodesic_error(
        torch.from_numpy(np.asarray(gt[:3, :3], np.float32)), rot))
    terr = float(np.linalg.norm(sol.translation.detach().cpu().numpy()
                                - gt[:3, 3]))
    return rerr, terr


def cuda_ms(fn, reps=20):
    """Mean ms of one call over `reps` calls after a warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class StageTimer:
    """The pipeline's ``timer`` callback: a CUDA event at each stage end."""

    def __init__(self):
        self.marks = []
        self.mark("start")

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    __call__ = mark

    def split_ms(self):
        torch.cuda.synchronize()
        return {name: prev.elapsed_time(ev) for (_, prev), (name, ev)
                in zip(self.marks, self.marks[1:])}


def bound(ops, nbytes):
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision must be 'highest'")
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}  device "
        f"{torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    log("precision: matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()}")
    return card


def phase_build():
    from quatro_tpu_torch import _build
    t0 = time.perf_counter()
    built = _build.build(force=True)
    log(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, info in built.items():
        log(f"  {name}: nvcc {info['seconds']:.1f} s")
        for line in info["ptxas"].splitlines():
            log(f"    {line.strip()}")


def full_width_case():
    """The seed-11 HDL-64E pair of tests/test_pipeline.py: raw scans at
    capacity 131072, tilted for path A as tests/test_ground.py tilts them
    (ground truth composed as there), untilted for path B and the earlier
    raw path, and 65536 points per cloud after the crude ground strip for
    the earlier feature paths. Returns (pairs, ground truths, configs)."""
    from quatro_tpu_torch.config import (FPFHConfig, GroundAlignmentConfig,
                                         IcpConfig, PipelineConfig)
    from quatro_tpu_torch.io.synthetic import make_scan_pair
    from quatro_tpu_torch.types import PointBatch
    from quatro_tpu_torch.utils.se3 import rotation_from_rpy

    src_xyz, tgt_xyz, gt = make_scan_pair(**PIPELINE_PAIR)
    a = rotation_from_rpy(*TILT_SRC).numpy()
    b = rotation_from_rpy(*TILT_TGT).numpy()
    gt_tilt = np.eye(4)
    gt_tilt[:3, :3] = b @ gt[:3, :3] @ a.T          # tgt2 = B R A^T src2 + B t
    gt_tilt[:3, 3] = b @ gt[:3, 3]
    cfgs = {
        "A": PipelineConfig.recommended(
            max_voxels=8192,
            ground_alignment=GroundAlignmentConfig(enabled=True),
            icp=IcpConfig(enabled=True)),
        "B": PipelineConfig(max_voxels=8192,
                            fpfh=FPFHConfig(crosscheck_min_matches=0)),
        "recommended": PipelineConfig.recommended(max_voxels=8192),
        "single": PipelineConfig(max_voxels=8192)}
    pairs = {
        "tilted": (PointBatch.from_numpy(src_xyz @ a.T, RAW_CAPACITY),
                   PointBatch.from_numpy(tgt_xyz @ b.T, RAW_CAPACITY)),
        "raw": (PointBatch.from_numpy(src_xyz, capacity=RAW_CAPACITY),
                PointBatch.from_numpy(tgt_xyz, capacity=RAW_CAPACITY)),
        "stripped": (PointBatch.from_numpy(nonground(src_xyz), capacity=65536),
                     PointBatch.from_numpy(nonground(tgt_xyz),
                                           capacity=65536))}
    main = cfgs["A"]
    log(f"pipeline: HDL-64E pair seed 11, {int(pairs['raw'][0].mask.sum())} /"
        f" {int(pairs['raw'][1].mask.sum())} raw points (capacity "
        f"{RAW_CAPACITY}), Patchwork {main.patchwork.num_patches} patches, "
        f"range image {main.lidar.n_scan} x {main.lidar.horizon_scan}, "
        f"max_voxels {main.max_voxels}, max_correspondences "
        f"{main.fpfh.max_correspondences}; path A tilts {TILT_SRC} / "
        f"{TILT_TGT} (rad), {main.solver.num_hypotheses} clique + "
        f"{main.solver.num_vote_hypotheses} vote hypotheses, ICP "
        f"{main.icp.max_source_points} source points x {main.max_voxels} "
        f"target voxels, {main.icp.iterations} iterations, "
        f"{main.fpfh.max_neighbors_normal}-neighbour normals; earlier "
        f"feature paths {int(pairs['stripped'][0].mask.sum())} / "
        f"{int(pairs['stripped'][1].mask.sum())} points after the crude "
        "ground strip")
    return pairs, {"tilted": gt_tilt, "raw": gt}, cfgs


def phase_pipeline(entry, pair, gt, cfg, name, expected, repeats,
                   max_terr=0.5, max_rerr=0.05):
    """One path through ``entry`` (register_scan_pair or
    register_features): warm-up, a run with the stage split and the launch
    counts (set to 0 just before it, read just after), then ``repeats``
    timed runs. Returns (result, launches, median host wall ms)."""
    from quatro_tpu_torch.ops import launch

    entry(*pair, cfg)                                # warm-up
    torch.cuda.synchronize()
    launch.reset_launches()
    timer = StageTimer()
    t0 = time.perf_counter()
    res = entry(*pair, cfg, timer=timer)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(launch.LAUNCHES)
    stages = timer.split_ms()

    sol = res.solution
    n_corr = int(res.correspondences.mask.sum())
    rerr, terr = pose_errors(sol, gt)
    occupied = [int(v.mask.sum()) for v in (res.src_voxels, res.tgt_voxels)]
    log(f"{name}: valid {bool(sol.valid)}  voxels {occupied[0]} / "
        f"{occupied[1]}  correspondences {n_corr}  rotation error "
        f"{rerr:.6f} rad  translation error {terr:.6f} m")
    log(f"{name} stages (ms, CUDA events): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()})
        + f"  host wall {wall_ms:.3f} ms")
    log(f"{name} launches: {json.dumps(launches)}")
    if res.icp is not None:
        log(f"{name} icp: converged {bool(res.icp.converged)}  inliers "
            f"{int(res.icp.num_inliers)}  rmse {float(res.icp.rmse):.6f} m")
    if res.hypotheses is not None:
        hyps = res.hypotheses
        score = torch.where(hyps.valid, res.overlaps, -1.0)
        log(f"{name} hypotheses: " + json.dumps({
            "sizes": hyps.max_clique_mask.sum(1).tolist(),
            "valid": hyps.valid.tolist(),
            "overlaps": [round(x, 4) for x in res.overlaps.tolist()],
            "winner": int(torch.argmax(score))}))
    check(bool(sol.valid), f"{name}: solution not valid")
    check(n_corr >= 10, f"{name}: too few correspondences: {n_corr}")
    check(rerr < max_rerr, f"{name}: rotation error {rerr} rad")
    check(terr < max_terr, f"{name}: translation error {terr} m")
    check(torch.isfinite(sol.transform()).all(), f"{name}: non-finite pose")
    check(launches == expected,
          f"{name}: launch counts {launches} != {expected}")

    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        entry(*pair, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    wall_ms = walls[len(walls) // 2]
    log(f"{name} pair latency over {repeats} runs (ms, host wall): "
        f"min {walls[0]:.3f}  median {wall_ms:.3f}  max {walls[-1]:.3f}")
    return res, launches, wall_ms, stages


def phase_solver_modes(res, cfg):
    """``register_correspondences`` on path B's correspondences under each
    solver mode off the shipping path: each valid and within 0.01 rad /
    0.1 m of path B's own pose (the JAX package: within 0.0012 rad / 0.007
    m on the CPU), the TLS scale within 0.02 of 1. Logs each mode's time
    (host wall, after a warm-up) and GNC iterations, and for "exact" the
    search's completion, restriction and steps."""
    import dataclasses

    from quatro_tpu_torch.solver import clique
    from quatro_tpu_torch.solver.quatro import register_correspondences
    from quatro_tpu_torch.solver.scale import tim_consistency_graph

    corr = res.correspondences
    ref = res.solution.transform().cpu().numpy().astype(np.float64)
    out = {}
    for name, kw in SOLVER_MODES.items():
        sc = dataclasses.replace(cfg.solver, **kw)
        args = (corr.src_xyz, corr.tgt_xyz, corr.mask, sc)
        register_correspondences(*args)                  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = register_correspondences(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rerr, terr = pose_errors(sol, ref)
        info = {"ms": round(ms, 3), "valid": bool(sol.valid),
                "gnc_iterations": int(sol.gnc_iterations),
                "scale": float(sol.scale),
                "clique": int(sol.max_clique_mask.sum()),
                "rotation_vs_path_b_rad": rerr,
                "translation_vs_path_b_m": terr}
        if name == "exact":
            adj = tim_consistency_graph(corr.src_xyz, corr.tgt_xyz, corr.mask,
                                        sc.noise_bound, sc.cbar2)
            greedy = clique.greedy_cliques(
                adj, clique.clique_seed_scores(adj, corr.mask), corr.mask,
                num_seeds=sc.clique_num_seeds, max_size=sc.max_clique_size,
                swap_rounds=sc.clique_swap_rounds) & corr.mask
            _, completed, restricted, steps = clique.exact_max_clique_bb(
                adj, corr.mask, incumbent=greedy, cap=sc.exact_clique_cap,
                max_steps=sc.exact_clique_max_steps)
            info.update(completed=bool(completed),
                        restricted=bool(restricted), steps=steps,
                        greedy=int(greedy.sum()))
        log(f"solver mode {name}: {json.dumps(info)}")
        check(bool(sol.valid), f"solver mode {name}: not valid")
        check(rerr < 0.01 and terr < 0.1,
              f"solver mode {name}: {rerr} rad / {terr} m from path B")
        check(bool(torch.isfinite(sol.transform()).all()),
              f"solver mode {name}: non-finite pose")
        if name == "TLS scale":
            check(abs(float(sol.scale) - 1.0) < 0.02,
                  f"TLS scale {float(sol.scale)}")
        out[name] = info
    return out


def phase_teaser_fixture(cfg):
    """TEASER and the default solve on the JAX package's own path B
    correspondences (tests/torch_teaser_path_b.npz, made on the CPU; its
    recipe in tests/test_torch_repeatability.py): each valid, its largest
    difference to the JAX package's 4x4 pose logged, and TEASER's
    distance to the default pose beside the JAX package's."""
    import dataclasses
    from pathlib import Path

    from quatro_tpu_torch.solver.quatro import register_correspondences
    from quatro_tpu_torch.utils.se3 import rotation_geodesic_error

    z = np.load(Path(__file__).resolve().parent / "tests"
                / "torch_teaser_path_b.npz")
    poses = {}
    for name, sc in (("teaser_pose", dataclasses.replace(
            cfg.solver, reg_name="TEASER")), ("default_pose", cfg.solver)):
        sol = register_correspondences(z["src_xyz"], z["tgt_xyz"], z["mask"],
                                       sc)
        check(bool(sol.valid), f"{name} on the JAX correspondences: not valid")
        poses[name] = sol.transform().cpu().numpy()
        log(f"{name} on the JAX package's path B correspondences "
            f"({int(z['mask'].sum())}): largest entry difference to its "
            f"pose {float(np.abs(poses[name] - z[name]).max()):.3g}")

    def gap(a, b):
        rot = float(rotation_geodesic_error(torch.from_numpy(a[:3, :3]),
                                            torch.from_numpy(b[:3, :3])))
        return rot, float(np.linalg.norm(a[:3, 3] - b[:3, 3]))

    log("TEASER against the default pose on those correspondences: card "
        "%.6f rad / %.6f m, JAX package (CPU) %.6f rad / %.6f m"
        % (*gap(poses["teaser_pose"], poses["default_pose"]),
           *gap(z["teaser_pose"], z["default_pose"])))


def capture_preprocessing(raw, cfg):
    """The arguments the main path hands each preprocessing kernel: one
    more preprocessing run of the pair (after the counted run) with the
    four wrappers wrapped to record their arguments. Logs the ground,
    non-ground and segment points per cloud."""
    from quatro_tpu_torch.device import resolve_device
    from quatro_tpu_torch.preprocessing import patchwork, projection

    calls = {}
    wrapped = [(patchwork, "cross_histogram"),
               (patchwork, "fit_iteration_moments"),
               (patchwork, "classify_points"), (projection, "image_lookup")]
    saved = [getattr(mod, fn) for mod, fn in wrapped]

    def recorder(name, fn):
        def call(*args, **kwargs):
            calls.setdefault(name, []).append((args, kwargs))
            return fn(*args, **kwargs)
        return call

    dev = resolve_device()
    pts = torch.stack([raw[0].points, raw[1].points]).to(dev)
    msk = torch.stack([raw[0].mask, raw[1].mask]).to(dev)
    try:
        for (mod, fn), orig in zip(wrapped, saved):
            setattr(mod, fn, recorder(fn, orig))
        # pipeline.preprocess, with the Patchwork result kept
        pw = patchwork.estimate_ground(pts, msk, cfg.patchwork)
        seg = projection.segment_cloud(
            pts, pw.nonground, cfg.lidar, cfg.projection,
            max_points=cfg.max_nonground_points).valid_segments
    finally:
        for (mod, fn), orig in zip(wrapped, saved):
            setattr(mod, fn, orig)
    torch.cuda.synchronize()
    log("main path preprocessing (source / target): " + json.dumps({
        "ground": pw.ground.sum(1).tolist(),
        "nonground": pw.nonground.sum(1).tolist(),
        "dropped": pw.dropped.sum(1).tolist(),
        "segments": seg.sum(1).tolist()}))
    check(bool((pw.ground.sum(1) > 0).all() and (seg.sum(1) > 0).all()),
          "preprocessing left no ground or no segments")
    return calls


def sequence_launches(frames, registered):
    """Path S's expected launch counts: per frame the preprocessing and
    front-end kernels, per registered edge the matcher's top-2 NN twice,
    the graph and the vote's segment sums, and per pose-graph solve one
    segment sum per J^T apply (gn x (cg + 1))."""
    gn, cg = PG_ITERS
    return dict(MAIN_LAUNCHES, moment_sums=frames, spfh=frames, fpfh=frames,
                nearest_neighbors2=2 * registered,
                consistency_graph=registered,
                segment_sums=registered + gn * (cg + 1),
                cross_histogram=frames, fit_iteration_moments=3 * frames,
                classify_points=frames, image_lookup=frames)


def _spread(ms):
    ms = sorted(ms)
    return {"median": round(ms[len(ms) // 2], 3), "min": round(ms[0], 3),
            "max": round(ms[-1], 3), "n": len(ms)}


def _synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_sequence(cfg, card):
    """Path S: ``run_sequence`` with Scan Context loop candidates over the
    synthetic 12-scan loop under path A's configuration, with its gates,
    launch counts, the pose graph's repeatability, the windowed runner
    against ``step``, and its times. Returns the run's launch counts and
    the arguments (ids, vals, p_pad) of the pose graph's first J^T apply
    (its B2 call)."""
    from torch.profiler import ProfilerActivity, profile

    from quatro_tpu_torch import sequence
    from quatro_tpu_torch.odometry import (FrameFeatures, OdometryRunner,
                                           run_odometry_windowed)
    from quatro_tpu_torch.ops import launch
    from quatro_tpu_torch.ops.scancontext import (detect_loop_candidates,
                                                  scan_context)
    from quatro_tpu_torch.parallel import posegraph
    from quatro_tpu_torch.parallel.posegraph import optimize_pose_graph

    t0 = time.perf_counter()
    scans, gt = sequence.make_synthetic_sequence(
        config=cfg, raw_capacity=RAW_CAPACITY, **SEQUENCE)
    log(f"path S: {len(scans)} scans ({cfg.lidar.n_scan} rings, "
        f"{[int(s.mask.sum()) for s in scans]} points, capacity "
        f"{RAW_CAPACITY}) ray-cast on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    graphs = []
    solve = sequence.optimize_pose_graph

    def recorder(*args, **kwargs):
        graphs.append((args, kwargs))
        return solve(*args, **kwargs)

    gn, cg = PG_ITERS
    torch.cuda.synchronize()
    launch.reset_launches()
    sequence.optimize_pose_graph = recorder
    try:
        res, wall_ms = _synced_ms(lambda: sequence.run_sequence(
            scans, cfg, gt_poses=gt, use_place_recognition=True,
            batch_size=SEQ_BATCH, gn_iters=gn, cg_iters=cg))
    finally:
        sequence.optimize_pose_graph = solve
    launches = dict(launch.LAUNCHES)
    m = len(scans)
    edges = list(zip(res.edges_i.tolist(), res.edges_j.tolist()))
    registered = -(-len(edges) // SEQ_BATCH) * SEQ_BATCH
    expected = sequence_launches(m, registered)
    log("path S run: " + json.dumps({
        "edges_total": res.edges_total, "edges_valid": res.edges_valid,
        "loop_edges": edges[m - 1:],
        "rejected": [e for e, ok in zip(edges, res.edge_mask) if not ok],
        "ate_before_m": res.ate_before, "ate_after_m": res.ate_after,
        "wall_ms": round(wall_ms, 3), "registered_edges": registered}))
    log(f"path S launches: {json.dumps(launches)}")
    check(res.edges_total > m - 1,
          "path S: place recognition found no loop candidate")
    check(res.edges_valid >= 0.6 * res.edges_total,
          f"path S: {res.edges_valid} of {res.edges_total} edges valid")
    check(bool(np.isfinite(res.poses).all()), "path S: non-finite pose")
    check(res.ate_after < 1.0, f"path S: ATE after {res.ate_after} m")
    check(res.ate_after <= res.ate_before + 0.15,
          f"path S: closing made it worse: {res.ate_before} -> "
          f"{res.ate_after} m")
    check(launches == expected,
          f"path S: launch counts {launches} != {expected}")

    # the pose graph again on the run's own edges: the same bits; its
    # first J^T apply's B2 arguments recorded (one list append per call)
    (args, kwargs), = graphs
    jt_calls = []
    jt_sums = posegraph.segment_sums

    def jt_recorder(*a):
        jt_calls.append(a)
        return jt_sums(*a)

    posegraph.segment_sums = jt_recorder
    try:
        again, pg_ms = _synced_ms(lambda: optimize_pose_graph(*args,
                                                              **kwargs))
    finally:
        posegraph.segment_sums = jt_sums
    check(len(jt_calls) == gn * (cg + 1),
          f"path S: {len(jt_calls)} J^T applies in one pose-graph solve")
    check(np.array_equal(again.cpu().numpy(), res.poses),
          "path S: a second pose-graph solve differs")

    # times: extraction per frame, registration per edge, Scan Context
    runner = OdometryRunner(cfg)
    extract_ms, feats = [], []
    for sc in scans:
        f, ms = _synced_ms(lambda: runner.extract(sc))
        feats.append(f)
        extract_ms.append(ms)
    register_ms = [_synced_ms(lambda: runner.register_pairs(
        FrameFeatures.stack([feats[j]]), FrameFeatures.stack([feats[i]])))[1]
        for i, j in edges]
    descs, sc_ms = _synced_ms(lambda: torch.stack([
        scan_context(sc.points.to(runner.device), sc.mask.to(runner.device))
        for sc in scans]))
    cands, detect_ms = _synced_ms(lambda: detect_loop_candidates(descs))
    check(cands == edges[m - 1:], f"path S: candidates {cands} != "
          f"{edges[m - 1:]}")

    # the windowed runner against the frame-by-frame one
    runner.reset()
    stepped = [runner.step(sc) for sc in scans]
    windowed = {i: sol for i, sol, _ in run_odometry_windowed(
        ((sc.points, sc.mask) for sc in scans), cfg, window=SEQ_WINDOW)}
    worst_r = worst_t = 0.0
    for k in range(1, m):
        a, b = stepped[k], windowed[k]
        check(bool(a.valid) == bool(b.valid), f"path S: frame {k} validity")
        worst_r = max(worst_r, float((a.rotation.cpu() - b.rotation).abs()
                                     .max()))
        worst_t = max(worst_t, float((a.translation.cpu() - b.translation)
                                     .abs().max()))
    log(f"path S windowed (window {SEQ_WINDOW}) against step: rotation "
        f"within {worst_r:.3g}, translation within {worst_t:.3g} m")
    check(worst_r <= 1e-5 and worst_t <= 1e-4,
          "path S: windowed odometry differs from step")

    # the device idle share of one OdometryRunner.step
    walls = []
    for k in range(1, 4):
        runner.reset()
        runner.step(scans[k - 1])
        walls.append(_synced_ms(lambda: runner.step(scans[k]))[1])
    step_ms = sorted(walls)[1]
    runner.reset()
    runner.step(scans[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.step(scans[1])
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3
    idle = (f"{1.0 - busy / step_ms:.4f}" if busy > 0 else "not measured "
            "(the profiler saw no device time)")
    log("path S times (ms; " + card + "): " + json.dumps({
        "extract_per_frame": _spread(extract_ms),
        "register_per_edge": _spread(register_ms),
        "scan_context_12_scans": round(sc_ms, 3),
        "loop_detection": round(detect_ms, 3),
        "pose_graph": round(pg_ms, 3),
        "sequence_wall": round(wall_ms, 3),
        "step_median_of_3": round(step_ms, 3),
        "step_device_busy": round(busy, 3)}) + f"; step idle share {idle}")
    return launches, jt_calls[0]


def phase_profile(pair, cfg, wall_ms, top=10):
    """One more pipeline run under torch.profiler: the card's busy time
    (sum of device times on the one stream), the idle share against the
    unprofiled run's host wall time ``wall_ms`` (the profiler slows the
    host, not the card), and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from quatro_tpu_torch.pipeline import register_scan_pair

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        register_scan_pair(*pair, cfg)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, fills): the CPU operators
    # that launched them carry the same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    if not rows:
        log("profile: the profiler saw no device time; idle share not "
            "measured")
        return
    log(f"profile: device busy {busy_ms:.3f} ms in "
        f"{sum(c for *_, c in rows)} device operations; idle share "
        f"{1.0 - busy_ms / wall_ms:.4f} of the {wall_ms:.3f} ms pair "
        f"(host wall under the profiler {prof_wall_ms:.3f} ms)")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}")
    # the port's own kernels, by device time per launch (the kernel
    # phase's CUDA-event times of the small kernels include the wrappers'
    # host time per call)
    own = {name.split("(")[0].replace("void ", ""): round(ms / count, 6)
           for name, ms, count in rows if "quatro::" in name}
    log("profile: device ms per launch of the port's kernels: "
        + json.dumps(own))
    # taken only where the profile saw each of the wrapper's launches
    per_wrapper = {}
    for w, names in WRAPPER_KERNELS.items():
        mine = [(name.replace("void ", ""), ms, count)
                for name, ms, count in rows]
        seen = sum(c for name, _, c in mine if name.startswith(MAIN_KERNEL[w]))
        per_wrapper[w] = (round(sum(ms for name, ms, _ in mine
                                    if name.startswith(names))
                                / MAIN_LAUNCHES[w], 6)
                          if seen == MAIN_LAUNCHES[w] else
                          f"not measured (the profile saw {seen} of "
                          f"{MAIN_LAUNCHES[w]} launches)")
    log("profile: device ms per wrapper launch (its kernels but the shared "
        "tile pre-pass): "
        + json.dumps(per_wrapper))


def nn1_kernel_row(res_b, cfg, launches_b, row):
    """B6 on path B's own descriptors (source against target): the same
    bits as the first slot of the top-2 kernel (the same per-pair
    arithmetic), and index and d2 equal to the plain version's run on CPU
    copies with the card's |a|^2 and |b|^2, bit for bit."""
    from quatro_tpu_torch.ops import frontend as fe

    pts = torch.stack([res_b.src_voxels.points,
                       res_b.tgt_voxels.points]).contiguous()
    mask = torch.stack([res_b.src_voxels.mask, res_b.tgt_voxels.mask])
    normals = fe.frontend_normals(pts, mask, cfg.fpfh.normal_radius)
    desc = fe.frontend_fpfh(pts, normals.normals.contiguous(), normals.valid,
                            mask, cfg.fpfh.fpfh_radius).contiguous()
    dmask = (mask & normals.valid).contiguous()
    da, db = desc[0:1], desc[1:2]
    ma, mb = dmask[0:1], dmask[1:2]
    v = desc.shape[1]

    def plain(a, b):
        idx, d2 = fe.nearest_neighbors_plain(a, b, ma.float(), mb.float(),
                                             (a * a).sum(-1), (b * b).sum(-1))
        empty = ~ma | (d2 >= fe.FLT_MAX)
        return torch.where(empty, 0, idx), torch.where(empty, fe.FLT_MAX, d2)

    idx, d2 = fe.nearest_neighbors(da, db, ma, mb)
    i1, d1, _, _ = fe.nearest_neighbors2(da, db, ma, mb)
    check(torch.equal(idx, i1) and torch.equal(d2, d1),
          "1-NN kernel differs from the top-2 kernel's first slot")
    sq_a, sq_b = (da * da).sum(-1).cpu(), (db * db).sum(-1).cpu()
    ridx, rd2 = fe.nearest_neighbors_plain(da.cpu(), db.cpu(),
                                           ma.float().cpu(), mb.float().cpu(),
                                           sq_a, sq_b)
    empty = ~ma.cpu() | (rd2 >= fe.FLT_MAX)
    ridx = torch.where(empty, 0, ridx)
    rd2 = torch.where(empty, fe.FLT_MAX, rd2)
    check(torch.equal(idx.cpu(), ridx) and torch.equal(d2.cpu(), rd2),
          "1-NN differs from its plain version on CPU copies")
    log(f"nearest_neighbors: {int(ma.sum())} valid source rows, "
        f"{int(mb.sum())} valid target columns; equal to the top-2 "
        "kernel's first slot and to the plain version on CPU copies, bit "
        "for bit")

    def library_nn():
        d = torch.cdist(da[0], db[0]).square()
        d = torch.where(ma[0][:, None] & mb[0][None, :], d, fe.FLT_MAX)
        return torch.min(d, dim=1)

    nva, nvb = float(ma.sum()), float(mb.sum())
    row("nearest_neighbors", float((d2.cpu() - rd2)[ma.cpu()].abs().max()),
        lambda: fe.nearest_neighbors(da, db, ma, mb), lambda: plain(da, db),
        nva * nvb * OPS_NN1, (2 * v * (33 + 1)) * 4 + v * 2 * 4, library_nn,
        launches=launches_b["nearest_neighbors"])


def _device_hits(fn, name, reps, main=None, tries=5):
    """The profiler's device events (kernels, copies, fills) whose name
    holds ``name`` over ``reps`` calls of ``fn``, each with its launches
    per call, as [(event, launches per call)]. The profiler misses the
    first device event of a profiled run, and now and then more, so an
    event seen ``c`` times ran ceil(c / reps) times per call. A run is
    taken when at most one launch is missing in all and, with ``main`` =
    (kernel, launches per call), that kernel ran its launches per call;
    else it profiles again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [(e, -(-e.count // reps)) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation and e.self_device_time_total > 0
                and name in e.key]
        missing = sum(k * reps - e.count for e, k in hits)
        if hits and missing <= 1 and (main is None or sum(
                k for e, k in hits if main[0] in e.key) == main[1]):
            return hits
        log(f"profile: {name!r} over {reps} calls: the profiler saw "
            f"{[(e.key[:48], e.count) for e, _ in hits]}; profiling again")
    log(f"profile: {name!r}: no profiled run in {tries} saw every call; "
        "not measured")
    return []


def device_ms_per_launch(fn, kernel, reps=10):
    """Mean device time per launch of the kernels whose name holds
    ``kernel``, over ``reps`` calls of ``fn``, from torch.profiler (the
    CUDA-event time of a call also holds the wrapper's own small launches
    and host time); None where no profiled run saw every call."""
    hits = _device_hits(fn, kernel, reps)
    if not hits:
        return None
    return sum(e.self_device_time_total for e, _ in hits) / 1e3 / sum(
        e.count for e, _ in hits)


def device_ms_per_call(fn, prefix="", reps=10, main=None):
    """Mean device time of one call of ``fn``: each device event (kernel,
    copy, fill) it runs whose name holds ``prefix`` ("quatro::" for the
    port's own kernels, "" for all), at its mean device time from
    torch.profiler over ``reps`` calls, times its launches per call
    (``_device_hits``, with ``main``); None where no profiled run saw
    every call."""
    hits = _device_hits(fn, prefix, reps, main)
    if not hits:
        return None
    return sum(e.self_device_time_total / e.count * k for e, k in hits) / 1e3


# device ms per call of the former designs on NVIDIA H100 80GB HBM3,
# 700.00 W, printed beside this run's: the top-2 and histogram kernels with
# one thread per row each, the moment sums, SPFH and FPFH with one thread
# per row over every column, the plane-fit moments with an all-pairs
# compare; the segment sums with one thread per bin comparing every entry
# of its chunk and a second pass, the consistency graph with one thread per
# byte (the vote's shape and N = 1024)
FORMER_DEVICE_MS = {"nearest_neighbors2": 1.757077,
                    "cross_histogram": 1.572931,
                    "moment_sums": 0.218100,
                    "spfh": 0.650900, "fpfh": 0.748800,
                    "fit_iteration_moments": 0.074700,
                    "segment_sums": 0.030200, "consistency_graph": 0.005400}
# the kernels of each redesigned wrapper, by the profiler's names, for its
# device time per launch in path A's profile (chunk_sum_kernel<9> is B9's
# second pass, <8> B8's). The tile pre-pass that B3 launches and B4
# launches for itself and B5 is listed on its own, as
# quatro::tile_bounds_kernel, two launches per pair.
WRAPPER_KERNELS = {"moment_sums": ("quatro::moment_sums_kernel",),
                   "spfh": ("quatro::spfh_kernel",),
                   "fpfh": ("quatro::fpfh_kernel",),
                   "fit_iteration_moments": ("quatro::fit_limit_kernel",
                                             "quatro::fit_partials_kernel",
                                             "quatro::chunk_sum_kernel<9>")}
# the kernel each wrapper launches once per call, by the profiler's name:
# a profiled run counts only if it saw this kernel once per call
MAIN_KERNEL = {"moment_sums": "quatro::moment_sums_kernel",
               "spfh": "quatro::spfh_kernel", "fpfh": "quatro::fpfh_kernel",
               "nearest_neighbors": "quatro::nn1_kernel",
               "nearest_neighbors2": "quatro::nn2_kernel",
               "consistency_graph": "quatro::consistency_graph_kernel",
               "segment_sums": "quatro::segment_sums_kernel",
               "cross_histogram": "quatro::hist_partials_kernel",
               "fit_iteration_moments": "quatro::fit_partials_kernel",
               "classify_points": "quatro::classify_kernel",
               "image_lookup": "quatro::image_lookup_kernel",
               "table_lookup": "quatro::table_lookup_kernel"}


def culled_pairs(pts, mask, radius):
    """Valid pairs, summed over the clouds, in the pairs of PAIR_TILE-point
    tiles whose AABBs lie within ``radius`` (``tiles_in_radius``): the
    pairs that an exact tile culling tests (B3's kernel does), and so the
    radius tests these inputs need."""
    from quatro_tpu_torch.ops import frontend as fe

    bb = fe.tile_bounds(pts, mask.float())
    passing = fe.tiles_in_radius(bb, bb, radius).double()
    bsz, v = mask.shape
    cnt = torch.nn.functional.pad(
        mask.double(), (0, bb.shape[1] * fe.PAIR_TILE - v)).reshape(
        bsz, -1, fe.PAIR_TILE).sum(-1)
    return float(torch.einsum("br,brc,bc->", cnt, passing, cnt))


def radius_pair_bytes(mask, per_row, per_valid_row):
    """Bytes a radius-pair kernel must move: ``per_row`` f32 words (its
    mask and outputs) for every row, ``per_valid_row`` (its points,
    normals or SPFH rows) only for the rows ``mask`` marks valid, which
    are the only ones it reads them for."""
    return (mask.numel() * per_row + int(mask.sum()) * per_valid_row) * 4


def phase_kernels(res, cfg, main_launches, calls, res_b, cfg_b, launches_b,
                  jt_call, launches_s):
    """Every kernel against its plain version: B1-B5 and B7-B12 on the
    main path's tensors, with the main path's launch counts (B12's 0: no
    path launches it); B6 on path B's, with path B's; B2 also on path S's
    J^T apply ``jt_call``, with path S's launch counts."""
    from quatro_tpu_torch.ops import frontend as fe
    from quatro_tpu_torch.ops.fpfh import normalize_blocks

    pts = torch.stack([res.src_voxels.points,
                       res.tgt_voxels.points]).contiguous()
    mask = torch.stack([res.src_voxels.mask, res.tgt_voxels.mask])
    maskf = mask.float().contiguous()
    rn, rf = cfg.fpfh.normal_radius, cfg.fpfh.fpfh_radius
    bsz, v = mask.shape
    nv = mask.sum(1).double()
    rows = []

    def in_radius(radius, m):
        """In-radius pairs (self excluded) per cloud, valid pairs only."""
        n = 0
        for b in range(bsz):
            p = pts[b][m[b]]
            for s in range(0, p.shape[0], 2048):
                d2 = torch.cdist(p[s:s + 2048], p, compute_mode=
                                 "donot_use_mm_for_euclid_dist").square()
                n += int(((d2 <= radius * radius) & (d2 > 1e-12)).sum())
        return n

    def row(name, err, k_fn, p_fn, ops, nbytes, lib_fn=None, launches=None,
            label=None):
        """One kernel's row: CUDA-event ms of the wrapper's call (20 calls),
        of the plain version's (5) and of the library call's (20); the
        device ms per call of the port's kernels (``k_fn`` is one wrapper
        call, one launch of its main kernel) and of the library call
        (torch.profiler); the bound from this run's data. Appended to the
        kernel table unless ``label`` names a second shape of the kernel
        (then only logged, with the label, and returned)."""
        b_ms, by = bound(ops, nbytes)
        r = {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": REPLACES[name],
             "launches": main_launches[name] if launches is None
             else launches,
             "max_abs_err": err, "ms": cuda_ms(k_fn),
             "plain_ms": cuda_ms(p_fn, 5), "bound_ms": b_ms, "bound_by": by,
             "library_ms": cuda_ms(lib_fn) if lib_fn else None,
             "device_ms": device_ms_per_call(k_fn, "quatro::",
                                             main=(MAIN_KERNEL[name], 1)),
             "library_device_ms": (device_ms_per_call(lib_fn) if lib_fn
                                   else None)}
        if label is not None:
            log(f"{name} ({label}): " + json.dumps(r))
            return r
        log(json.dumps(r))
        if name in FORMER_DEVICE_MS:
            lib = (f"against the library call's {r['library_ms']:.6f} ms "
                   "(CUDA events, 20 calls); library device "
                   f"{r['library_device_ms']} ms" if lib_fn else
                   "(CUDA events, 20 calls; no library call)")
            log(f"{name}: device {r['device_ms']} ms per call against "
                f"{FORMER_DEVICE_MS[name]} ms for the former design; call "
                f"{r['ms']:.6f} ms {lib}")
        rows.append(r)

    # B3 moment sums, bit for bit against the plain version on CPU copies
    # and across two launches; its pre-pass's limits and tile AABBs equal
    # to their torch mirrors, and the tile pairs its warps tested
    got, bounds, lim = fe.moment_sums_launch(pts, maskf, rn)
    check(torch.equal(got, fe.moment_sums(pts, maskf, rn)),
          "moment sums differ between launches")
    pc, mc = pts.cpu(), maskf.cpu()
    ref = fe.moment_sums_plain(pc, mc, rn)
    check(torch.equal(got.cpu(), ref),
          "moment sums differ from the plain version on CPU copies")
    rbb = fe.tile_bounds(pc, mc)
    check(torch.equal(bounds.cpu(), rbb)
          and torch.equal(lim.cpu(), fe.active_limit(mc > 0)),
          "moment sums' tile AABBs or active limits differ from torch's")
    passing = fe.tiles_in_radius(rbb, rbb, rn)
    nct = [-(-n // fe.PAIR_TILE) for n in lim.tolist()]
    tested = [n * n for n in nct]
    skipped = [n * n - int(passing[b, :n, :n].sum())
               for b, n in enumerate(nct)]
    log(f"moment_sums: active limits {lim.tolist()} of {v}; tile pairs "
        f"tested {tested}, skipped {skipped} per cloud; equal to the plain "
        "version on CPU copies and across two launches, bit for bit")
    n_rn = in_radius(rn, mask)
    row("moment_sums", float((got.cpu() - ref).abs().max()),
        lambda: fe.moment_sums(pts, maskf, rn),
        lambda: fe.moment_sums_plain(pts, maskf, rn),
        culled_pairs(pts, mask, rn) * OPS_PAIR_TEST
        + (n_rn + float(nv.sum())) * OPS_MOMENTS,
        radius_pair_bytes(mask, 1 + 10, 3))

    # B4 SPFH, on the pipeline's own normals: counts and bins equal to the
    # plain version run on the card (the same rsqrtf and atan2f) and across
    # two launches; its pre-pass's tile AABBs and limits equal to torch's
    normals = fe.frontend_normals(pts, mask, rn)
    nrm = normals.normals.contiguous()
    pmask = mask & normals.valid
    pmf = pmask.float().contiguous()
    hist, cnt, bounds, lim = fe.spfh_launch(pts, nrm, pmf, rf)
    again = fe.spfh(pts, nrm, pmf, rf)
    check(torch.equal(hist, again[0]) and torch.equal(cnt, again[1]),
          "SPFH differs between launches")
    rhist, rcnt = fe.spfh_plain(pts, nrm, pmf, rf)
    flipped = int((hist != rhist).any(-1).sum())
    log(f"spfh: {flipped} of {bsz * v} rows with a bin that differs from "
        f"the plain version on the card; pair counts "
        f"{'equal' if torch.equal(cnt, rcnt) else 'DIFFERENT'}")
    check(torch.equal(cnt, rcnt), "SPFH pair counts differ")
    check(flipped == 0, f"SPFH bins differ on {flipped} rows")
    rbb = fe.tile_bounds(pts.cpu(), pmf.cpu())
    check(torch.equal(bounds.cpu(), rbb)
          and torch.equal(lim.cpu(), fe.active_limit(pmask.cpu())),
          "SPFH's tile AABBs or active limits differ from torch's")
    passing = fe.tiles_in_radius(rbb, rbb, rf)
    nct = [-(-n // fe.PAIR_TILE) for n in lim.tolist()]
    kept = [int(passing[b, :n, :n].sum()) for b, n in enumerate(nct)]
    log(f"spfh / fpfh: active limits {lim.tolist()} of {v}; tile pairs "
        f"tested {[n * n for n in nct]}, kept {kept} per cloud at "
        f"{rf} m ({[round(k / max(n * n, 1), 4) for k, n in zip(kept, nct)]})")
    n_rf = in_radius(rf, pmask)
    pairs_rf = culled_pairs(pts, pmask, rf)
    row("spfh", float((hist - rhist).abs().max()),
        lambda: fe.spfh(pts, nrm, pmf, rf),
        lambda: fe.spfh_plain(pts, nrm, pmf, rf),
        pairs_rf * OPS_PAIR_TEST + n_rf * OPS_SPFH,
        radius_pair_bytes(pmask, 1 + 33 + 1, 3 + 3))

    # B5 FPFH weighted sums, bit for bit against the plain version on CPU
    # copies and across two launches, alone and on SPFH's tile table; timed
    # on SPFH's table, as frontend_fpfh launches it
    srows = (hist * (100.0 / torch.clamp(cnt, min=1.0))[..., None]).contiguous()
    table = (bounds, lim)
    got = fe.fpfh_sums(pts, srows, pmf, rf)
    shared = fe.fpfh_sums_launch(pts, srows, pmf, rf, table)
    check(torch.equal(got, shared), "FPFH differs between launches")
    ref = fe.fpfh_sums_plain(pts.cpu(), srows.cpu(), pmf.cpu(), rf)
    check(torch.equal(got.cpu(), ref),
          "FPFH sums differ from the plain version on CPU copies")
    log("fpfh: equal to the plain version on CPU copies and across two "
        "launches (one on SPFH's tile table), bit for bit")
    row("fpfh", float((got.cpu() - ref).abs().max()),
        lambda: fe.fpfh_sums_launch(pts, srows, pmf, rf, table),
        lambda: fe.fpfh_sums_plain(pts, srows, pmf, rf),
        pairs_rf * OPS_PAIR_TEST + n_rf * OPS_FPFH,
        radius_pair_bytes(pmask, 1 + 33, 3 + 33))

    # B7 top-2 NN, both directions, bit for bit against the plain version
    # on CPU copies with the card's |a|^2 and |b|^2
    desc = fe.frontend_fpfh(pts, nrm, normals.valid, mask, rf).contiguous()
    dmask = pmask.contiguous()
    for x, y in ((1, 0), (0, 1)):         # source against target last
        da, db = desc[x:x + 1], desc[y:y + 1]
        ma, mb = dmask[x:x + 1], dmask[y:y + 1]
        lim = fe.nn_active_limits(ma, mb)[0].tolist()
        got = fe.nearest_neighbors2(da, db, ma, mb)
        again = fe.nearest_neighbors2(da, db, ma, mb)
        check(all(torch.equal(g, h) for g, h in zip(got, again)),
              "top-2 NN differs between launches")
        sq_a, sq_b = (da * da).sum(-1), (db * db).sum(-1)
        ref = fe._fill_empty(*fe.nearest_neighbors2_plain(
            da.cpu(), db.cpu(), ma.float().cpu(), mb.float().cpu(),
            sq_a.cpu(), sq_b.cpu()), ma.cpu())
        for what, g, r in zip(("i1", "d1", "i2", "d2"), got, ref):
            check(torch.equal(g.cpu(), r),
                  f"top-2 NN {what} differs from the plain version")
        log(f"nearest_neighbors2 (cloud {x} against cloud {y}): active "
            f"limits {lim[0]} rows of {v}, {lim[1]} columns of {v}; "
            f"{int(ma.sum())} valid rows, {int(mb.sum())} valid columns; "
            "all four outputs equal to the plain version on CPU copies and "
            "across two launches, bit for bit")

    def library_top2():
        d = torch.cdist(da[0], db[0]).square()
        d = torch.where(ma[0][:, None] & mb[0][None, :], d, fe.FLT_MAX)
        return torch.topk(d, 2, dim=1, largest=False)

    nva, nvb = float(ma.sum()), float(mb.sum())
    row("nearest_neighbors2",
        float((got[1].cpu() - ref[1])[ma.cpu()].abs().max()),
        lambda: fe.nearest_neighbors2(da, db, ma, mb),
        lambda: fe.nearest_neighbors2_plain(da, db, ma.float(), mb.float(),
                                            sq_a, sq_b),
        nva * nvb * OPS_NN, (2 * v * (33 + 1)) * 4 + v * 4 * 4, library_top2)

    # B1 consistency graph, on the pair's correspondences
    from quatro_tpu_torch.ops import kernels, segment
    from quatro_tpu_torch.solver import vote
    from quatro_tpu_torch.solver.scale import tim_consistency_graph

    sc = cfg.solver
    corr = res.correspondences
    cs, ct = corr.src_xyz, corr.tgt_xyz
    beta = 2.0 * sc.noise_bound * sc.cbar2 ** 0.5
    got = kernels.consistency_graph(cs, ct, beta)
    ref = kernels.consistency_graph_plain(cs, ct, beta)
    check(torch.equal(got, ref), "consistency graph differs from plain")
    n = cs.shape[0]
    log(f"consistency_graph: N {n}, {int(got.sum())} consistent pairs, "
        "equal to the plain version")
    row("consistency_graph", float((got != ref).sum()),
        lambda: kernels.consistency_graph(cs, ct, beta),
        lambda: kernels.consistency_graph_plain(cs, ct, beta),
        float(n * n) * OPS_GRAPH, 2 * n * 3 * 4 + n * n)
    # and at N = 1000, whose rows start inside the kernel's 16-byte pieces
    rng = np.random.default_rng(1000)
    rs = rng.uniform(-30, 30, (1000, 3)).astype(np.float32)
    rt = rs + rng.normal(0, 0.5, (1000, 3)).astype(np.float32)
    rs, rt = (torch.from_numpy(a).to(cs.device) for a in (rs, rt))
    odd = kernels.consistency_graph(rs, rt, beta)
    check(torch.equal(odd, kernels.consistency_graph_plain(rs, rt, beta)),
          "consistency graph differs from plain at N = 1000")
    log(f"consistency_graph: N 1000 (seeded), {int(odd.sum())} consistent "
        "pairs, equal to the plain version")
    check(kernels.sqrt_rn_mismatches() == 0,
          "the consistency graph's square root differs from __fsqrt_rn")
    log("consistency_graph: its branch-free square root equals __fsqrt_rn "
        "on every non-negative float from 0 to +inf")

    # B2 segment sums, on the vote's own histogram entries
    adj = tim_consistency_graph(cs, ct, corr.mask, sc.noise_bound, sc.cbar2)
    ids, vals = vote.yaw_vote_entries(cs, ct, corr.mask, adj,
                                      num_anchors=sc.vote_yaw_anchors,
                                      num_bins=sc.vote_yaw_bins)
    p_pad = sc.vote_yaw_bins
    kv, nv_ids = vals.shape
    got = segment.segment_sums(ids, vals, p_pad)
    again = segment.segment_sums(ids, vals, p_pad)
    check(torch.equal(got, again), "segment sums differ between launches")
    ref = segment.segment_sums_plain(ids.cpu(), vals.cpu(), p_pad,
                                     segment.SEG_CHUNK)
    check(torch.equal(got.cpu(), ref),
          "segment sums differ from the plain version on CPU copies")
    in_range = int(((ids >= 0) & (ids < p_pad)).sum())
    log(f"segment_sums: N {nv_ids}, K {kv}, p_pad {p_pad}, {in_range} "
        "entries in range; equal to the plain version on CPU copies and "
        "across two launches, bit for bit")
    dest = torch.where((ids >= 0) & (ids < p_pad), ids, p_pad).long()
    src_rows = vals.T.contiguous()

    def library_segment():
        return torch.zeros((p_pad + 1, kv), device=vals.device).index_add_(
            0, dest, src_rows)

    row("segment_sums", float((got.cpu() - ref).abs().max()),
        lambda: segment.segment_sums(ids, vals, p_pad),
        lambda: segment.segment_sums_plain(ids, vals, p_pad,
                                           segment.SEG_CHUNK),
        float(in_range * kv), nv_ids * 4 * (1 + kv) + p_pad * kv * 4,
        library_segment)
    rows[-1]["pose_graph"] = segment_sums_pose_graph_row(jt_call, launches_s,
                                                         row)
    nn1_kernel_row(res_b, cfg_b, launches_b, row)
    preprocessing_kernel_rows(calls, row)
    return rows


def segment_sums_pose_graph_row(jt_call, launches_s, row):
    """B2 on the arguments of one J^T apply of path S's pose graph: bit for
    bit against its plain version on CPU copies and across two launches,
    and its row (path S's launches: one per registered edge, 410 per
    pose-graph solve)."""
    from quatro_tpu_torch.ops import segment

    ids, vals, p_pad = jt_call
    got = segment.segment_sums(ids, vals, p_pad)
    again = segment.segment_sums(ids, vals, p_pad)
    check(torch.equal(got, again),
          "segment sums differ between launches (pose graph)")
    ref = segment.segment_sums_plain(ids.cpu(), vals.cpu(), p_pad,
                                     segment.SEG_CHUNK)
    check(torch.equal(got.cpu(), ref), "segment sums differ from the plain "
          "version on CPU copies (pose graph)")
    kv, n = vals.shape
    in_range = int(((ids >= 0) & (ids < p_pad)).sum())
    log(f"segment_sums (pose graph's J^T apply): N {n}, K {kv}, p_pad "
        f"{p_pad}, {in_range} entries in range; equal to the plain version "
        "on CPU copies and across two launches, bit for bit")
    dest = torch.where((ids >= 0) & (ids < p_pad), ids, p_pad).long()
    src_rows = vals.T.contiguous()

    def library_segment():
        return torch.zeros((p_pad + 1, kv), device=vals.device).index_add_(
            0, dest, src_rows)

    return row("segment_sums", float((got.cpu() - ref).abs().max()),
               lambda: segment.segment_sums(ids, vals, p_pad),
               lambda: segment.segment_sums_plain(ids, vals, p_pad,
                                                  segment.SEG_CHUNK),
               float(in_range * kv), n * 4 * (1 + kv) + p_pad * kv * 4,
               library_segment, launches=launches_s["segment_sums"],
               label="pose graph's J^T apply on path S")


def preprocessing_kernel_rows(calls, row):
    """B8-B12 on the arguments the main path handed B8-B11: B8 and B9
    (with its active limits) bit-equal to their plain versions on CPU
    copies and across two launches; B10, B11 and B12 bit-equal, B12 on
    B10's ids and patch table."""
    from quatro_tpu_torch.ops import segment

    # B8 cross histogram: the Patchwork seed stage
    (ids_a, ids_b, w, a_pad, b_pad), _ = calls["cross_histogram"][0]
    got = segment.cross_histogram(ids_a, ids_b, w, a_pad, b_pad)
    again = segment.cross_histogram(ids_a, ids_b, w, a_pad, b_pad)
    check(torch.equal(got, again), "cross histogram differs between launches")
    ref = segment.cross_histogram_plain(ids_a.cpu(), ids_b.cpu(), w.cpu(),
                                        a_pad, b_pad)
    check(torch.equal(got.cpu(), ref),
          "cross histogram differs from its plain version on CPU copies")
    bsz, k, n = w.shape
    inr = ((ids_a >= 0) & (ids_a < a_pad) & (ids_b >= 0) & (ids_b < b_pad))
    bins = a_pad * b_pad
    key = torch.where(inr, ids_a.long() * b_pad + ids_b.long(), bins)
    offs = (torch.arange(bsz * k, device=w.device) * (bins + 1)).reshape(
        bsz, k, 1)
    flat_key = (key[:, None, :] + offs).reshape(-1)
    flat_w = w.reshape(-1)
    first = device_ms_per_launch(
        lambda: segment.cross_histogram(ids_a, ids_b, w, a_pad, b_pad),
        "quatro::hist_partials_kernel")
    log(f"cross_histogram: B {bsz}, N {n}, K {k}, {a_pad} x {b_pad} bins, "
        f"{int(inr.sum())} points in range; equal to the plain version on "
        "CPU copies and across two launches, bit for bit; first pass "
        f"{first} ms of device time per launch")
    row("cross_histogram", float((got.cpu() - ref).abs().max()),
        lambda: segment.cross_histogram(ids_a, ids_b, w, a_pad, b_pad),
        lambda: segment.cross_histogram_plain(ids_a, ids_b, w, a_pad, b_pad),
        float(inr.sum()) * k, bsz * n * 4 * (2 + k) + bsz * k * bins * 4,
        lambda: torch.bincount(flat_key, weights=flat_w,
                               minlength=bsz * k * (bins + 1)))

    # B9 plane-fit moments: iterations 1-2 in bf16, the last exact
    errs = []
    for (ids, chan, tab, p_pad, p_cnt), kw in calls["fit_iteration_moments"]:
        got, lim = segment.fit_iteration_moments_launch(ids, chan, tab, p_pad,
                                                        p_cnt, **kw)
        again = segment.fit_iteration_moments(ids, chan, tab, p_pad, p_cnt,
                                              **kw)
        check(torch.equal(got, again), "plane-fit moments differ between "
              "launches")
        ref = segment.fit_iteration_moments_plain(ids.cpu(), chan.cpu(),
                                                  tab.cpu(), p_pad, p_cnt,
                                                  **kw)
        check(torch.equal(got.cpu(), ref), "plane-fit moments differ from "
              "the plain version on CPU copies")
        check(torch.equal(lim.cpu(), segment.fit_active_limit(
            ids.cpu(), p_pad, p_cnt)), "plane-fit active limits differ")
        errs.append(float((got.cpu() - ref).abs().max()))
        log(f"fit_iteration_moments (exact={kw['exact']}): "
            f"{int(got[..., 0].sum())} member points, active limits "
            f"{lim.tolist()} of {ids.shape[1]} ({segment.FIT_CHUNK}-point "
            "chunks); equal to the plain version on CPU copies and across "
            "two launches, bit for bit")
    bsz, _, n = chan.shape
    members = float(got[..., 0].sum())
    row("fit_iteration_moments", max(errs),
        lambda: segment.fit_iteration_moments(ids, chan, tab, p_pad, p_cnt,
                                              **kw),
        lambda: segment.fit_iteration_moments_plain(ids, chan, tab, p_pad,
                                                    p_cnt, **kw),
        bsz * n * OPS_PLANE + members * OPS_MOMENTS_PT,
        bsz * n * 4 * 6 + bsz * p_pad * (5 + 10) * 4)

    # B10 final classification
    (ids, chan, tab, p_pad, p_cnt), _ = calls["classify_points"][0]
    got = segment.classify_points(ids, chan, tab, p_pad, p_cnt)
    ref = segment.classify_points_plain(ids, chan, tab, p_pad, p_cnt)
    check(torch.equal(got, ref), "classification differs from plain")
    log(f"classify_points: {int(((got & 1) > 0).sum())} ground, "
        f"{int(((got & 2) > 0).sum())} nonground, equal to the plain version")
    row("classify_points", float((got != ref).sum()),
        lambda: segment.classify_points(ids, chan, tab, p_pad, p_cnt),
        lambda: segment.classify_points_plain(ids, chan, tab, p_pad, p_cnt),
        bsz * n * OPS_CLASSIFY, bsz * n * 4 * (1 + 3 + 1)
        + bsz * p_pad * 5 * 4)

    # B12 table lookup: the rows B10 was handed, delivered by the kernel;
    # the codes recomputed from them equal B10's on every point
    rows_b12 = segment.table_lookup(ids, tab)
    check(torch.equal(rows_b12, segment.table_lookup_plain(ids, tab)),
          "table lookup differs from plain")
    check(torch.equal(segment.codes_from_rows(ids, chan, rows_b12, p_cnt),
                      got), "codes from B12's rows differ from B10's")
    bsz, n = ids.shape
    k = tab.shape[-1]
    gather_idx = ids.clamp(0, p_pad - 1).long()[..., None].expand(-1, -1, k)
    log(f"table_lookup: B {bsz}, N {n}, {p_pad} x {k} table, "
        f"{int(((ids >= 0) & (ids < p_pad)).sum())} ids in range, equal to "
        f"the plain version bit for bit, codes from its rows equal to B10's "
        "on every point")
    row("table_lookup", float((rows_b12 - segment.table_lookup_plain(
        ids, tab)).abs().max()),
        lambda: segment.table_lookup(ids, tab),
        lambda: segment.table_lookup_plain(ids, tab),
        0.0, bsz * n * 4 + bsz * p_pad * k * 4 + bsz * k * n * 4,
        lambda: torch.gather(tab, 1, gather_idx))

    # B11 image lookup: the projection's packed pixel words
    (flat, img, rows_n, cols_n), _ = calls["image_lookup"][0]
    got = segment.image_lookup(flat, img, rows_n, cols_n)
    ref = segment.image_lookup_plain(flat, img, rows_n, cols_n)
    check(torch.equal(got, ref), "image lookup differs from plain")
    npix = rows_n * cols_n
    bsz, n = flat.shape
    inr = (flat >= 0) & (flat < npix)
    padded = torch.cat([img.reshape(bsz, npix),
                        torch.zeros_like(img.reshape(bsz, npix)[:, :1])], 1)
    idx = (torch.where(inr, flat.long(), npix)
           + torch.arange(bsz, device=flat.device)[:, None] * (npix + 1))
    log(f"image_lookup: B {bsz}, N {n}, {rows_n} x {cols_n} pixels, "
        f"{int(inr.sum())} points in the image, equal to the plain version")
    row("image_lookup", float((got != ref).sum()),
        lambda: segment.image_lookup(flat, img, rows_n, cols_n),
        lambda: segment.image_lookup_plain(flat, img, rows_n, cols_n),
        0.0, bsz * n * 4 * 2 + bsz * npix * 4,
        lambda: torch.take(padded, idx))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import quatro_tpu_torch  # noqa: F401  (fails outside the repository)

    card = phase_device()
    phase_build()
    from quatro_tpu_torch.pipeline import register_features, register_scan_pair
    pairs, gts, cfgs = full_width_case()
    res_a, launches_a, wall_a, stages_a = phase_pipeline(
        register_scan_pair, pairs["tilted"], gts["tilted"], cfgs["A"],
        "path A (main: ground alignment + ICP)", MAIN_LAUNCHES, PAIR_REPEATS,
        max_terr=0.05, max_rerr=0.01)
    check(bool(res_a.icp.converged), "path A: ICP did not converge")
    check({"leveling", "icp"} <= set(stages_a),
          f"path A: stages {sorted(stages_a)}")
    calls = capture_preprocessing(pairs["tilted"], cfgs["A"])
    res_b, launches_b, _, _ = phase_pipeline(
        register_scan_pair, pairs["raw"], gts["raw"], cfgs["B"],
        "path B (reference matcher, crosscheck_min_matches=0)",
        PATH_B_LAUNCHES, PATH_B_REPEATS, max_terr=0.6)
    phase_solver_modes(res_b, cfgs["B"])
    phase_teaser_fixture(cfgs["B"])
    for entry, pair, cfg, name, expected, max_terr in (
            (register_scan_pair, "raw", "recommended",
             "earlier path (raw scans, recommended)", MAIN_LAUNCHES, 0.6),
            (register_features, "stripped", "recommended",
             "earlier path (features, recommended)", FEATURES_LAUNCHES, 0.5),
            (register_features, "stripped", "single",
             "earlier path (features, single hypothesis)", SINGLE_LAUNCHES,
             0.5)):
        phase_pipeline(entry, pairs[pair], gts["raw"], cfgs[cfg], name,
                       expected, EARLIER_REPEATS, max_terr=max_terr)
    launches_s, jt_call = phase_sequence(cfgs["A"], card)
    phase_profile(pairs["tilted"], cfgs["A"], wall_a)
    rows = phase_kernels(res_a, cfgs["A"], launches_a, calls, res_b,
                         cfgs["B"], launches_b, jt_call, launches_s)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
