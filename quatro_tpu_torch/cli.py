"""Command-line application: the reference demo without ROS, on the card.

PyTorch counterpart of ``quatro_tpu/cli.py``, which replaces
``examples/run_global_registration.cpp``: loads two scans (KITTI .bin or
synthetic), runs the full pipeline, prints the per-stage point-count table
and timing splits the reference prints (run_global_registration.cpp:
168-236,248-251), and optionally dumps PLY artifacts instead of rviz
topics. The same subcommands, arguments and JSON lines as the JAX
package's, plus ``--device`` (default ``cuda``, which raises without a
card; ``--device cpu`` runs the plain PyTorch versions).

Usage:
    python -m quatro_tpu_torch.cli register SRC.bin TGT.bin [options]
    python -m quatro_tpu_torch.cli register --synthetic [--seed 0] [options]
    python -m quatro_tpu_torch.cli {evaluate,overlap,sequence,sweep} ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

# ray-cast scan pairs, shared with the JAX package's CLI (git-ignored)
DEFAULT_CACHE = str(Path(__file__).resolve().parent.parent / ".scan_cache")


def _build_config(args):
    from quatro_tpu_torch.config import (FPFHConfig, GroundAlignmentConfig,
                                         IcpConfig, LidarConfig,
                                         PipelineConfig, SolverConfig)
    icp = IcpConfig(enabled=getattr(args, "refine", False),
                    yaw_only=getattr(args, "refine_yaw_only", False))
    ground = GroundAlignmentConfig(
        enabled=getattr(args, "ground_alignment", False))
    if getattr(args, "params_yaml", None) or getattr(args, "patchwork_yaml",
                                                     None):
        from quatro_tpu_torch.config_io import load_params_yaml
        cfg = load_params_yaml(args.params_yaml, args.patchwork_yaml)
        return dataclasses.replace(
            cfg, max_raw_points=args.max_raw_points,
            max_voxels=args.max_voxels, icp=icp, ground_alignment=ground,
            fpfh=dataclasses.replace(
                cfg.fpfh, max_correspondences=args.max_correspondences))
    if getattr(args, "auto_radii", False):
        fpfh = FPFHConfig.for_lidar(LidarConfig.preset(args.lidar_type),
                                    max_correspondences=args.max_correspondences)
    else:
        fpfh = FPFHConfig(normal_radius=args.normal_radius,
                          fpfh_radius=args.fpfh_radius,
                          max_correspondences=args.max_correspondences)
    return PipelineConfig(
        icp=icp,
        ground_alignment=ground,
        lidar=LidarConfig.preset(args.lidar_type),
        ground_segmentation_mode=args.ground_mode,
        use_subclustering=not getattr(args, "no_subclustering", False),
        voxel_size=args.voxel_size,
        max_voxels=args.max_voxels,
        fpfh=fpfh,
        solver=SolverConfig(reg_name=args.reg_type,
                            noise_bound=args.noise_bound,
                            rotation_gnc_factor=args.gnc_factor,
                            rotation_max_iterations=args.num_max_iter,
                            rotation_cost_threshold=args.rot_cost_diff_thr,
                            num_hypotheses=getattr(args, "num_hypotheses",
                                                   1)))


def cmd_register(args) -> int:
    import torch

    from quatro_tpu_torch.device import resolve_device
    from quatro_tpu_torch.pipeline import register_scan_pair
    from quatro_tpu_torch.types import PointBatch
    from quatro_tpu_torch.utils.profiling import StageTimer

    dev = resolve_device(args.device)
    config = _build_config(args)

    if args.synthetic:
        from quatro_tpu_torch.io.synthetic import make_scan_pair
        src_xyz, tgt_xyz, gt = make_scan_pair(seed=args.seed,
                                              lidar=config.lidar)
    else:
        from quatro_tpu_torch.io.kitti import load_kitti_bin
        src_xyz = load_kitti_bin(args.src)
        tgt_xyz = load_kitti_bin(args.tgt)
        gt = None

    cap = args.max_raw_points
    src = PointBatch.from_numpy(src_xyz, capacity=cap, device=dev)
    tgt = PointBatch.from_numpy(tgt_xyz, capacity=cap, device=dev)

    timer = StageTimer()
    with timer.stage("first run (warm-up)", sync=dev):
        res = register_scan_pair(src, tgt, config, device=dev)
    with timer.stage("steady-state solve", sync=dev):
        res = register_scan_pair(src, tgt, config, device=dev)

    sol = res.solution
    n_corr = int(res.correspondences.mask.sum())

    # stage table (reference: run_global_registration.cpp:168-236)
    rows = [
        ("# of raw cloud", int(src.mask.sum()), int(tgt.mask.sum())),
        ("# after voxelization", int(res.src_voxels.mask.sum()),
         int(res.tgt_voxels.mask.sum())),
        ("# after matching", n_corr, n_corr),
        ("# max clique", int(sol.max_clique_mask.sum()), ""),
        ("# final inliers", int(sol.final_inlier_mask.sum()), ""),
    ]
    width = 22
    print("-" * (width + 24))
    for name, a, b in rows:
        print(f"{name:<{width}} | {a:>8} | {b:>8}")
    print("-" * (width + 24))
    print(timer.table())

    T = sol.transform().cpu().numpy()
    print(f"valid: {bool(sol.valid)}")
    if res.icp is not None:
        print(f"icp refinement: converged={bool(res.icp.converged)} "
              f"rmse={float(res.icp.rmse):.4f} "
              f"inliers={int(res.icp.num_inliers)}")
    print("estimated transform:")
    print(np.array2string(T, precision=4, suppress_small=True))
    if gt is not None:
        print("ground truth:")
        print(np.array2string(gt, precision=4, suppress_small=True))

    if args.dump_dir:
        os.makedirs(args.dump_dir, exist_ok=True)
        from quatro_tpu_torch.io.ply import save_correspondences_ply, save_ply
        from quatro_tpu_torch.utils.se3 import apply_transform
        aligned = apply_transform(torch.from_numpy(T),
                                  torch.from_numpy(np.asarray(
                                      src_xyz, np.float32))).numpy()
        save_ply(os.path.join(args.dump_dir, "source.ply"), src_xyz,
                 color=(230, 90, 90))
        save_ply(os.path.join(args.dump_dir, "target.ply"), tgt_xyz,
                 color=(90, 230, 90))
        save_ply(os.path.join(args.dump_dir, "aligned.ply"), aligned,
                 color=(90, 90, 230))
        cm = res.correspondences.mask.cpu().numpy()
        csrc = res.correspondences.src_xyz.cpu().numpy()
        ctgt = res.correspondences.tgt_xyz.cpu().numpy()
        save_correspondences_ply(
            os.path.join(args.dump_dir, "correspondences.ply"), csrc, ctgt,
            cm)
        # clique / final-inlier keypoints (the reference's /max_clique_source,
        # /max_clique_target, /final_inliers topics,
        # run_global_registration.cpp:57-82)
        clq = sol.max_clique_mask.cpu().numpy() & cm
        fin = sol.final_inlier_mask.cpu().numpy() & cm
        save_ply(os.path.join(args.dump_dir, "max_clique_source.ply"),
                 csrc[clq], color=(255, 200, 0))
        save_ply(os.path.join(args.dump_dir, "max_clique_target.ply"),
                 ctgt[clq], color=(255, 140, 0))
        save_ply(os.path.join(args.dump_dir, "final_inliers.ply"),
                 csrc[fin], color=(255, 0, 200))
        # ground + Patchwork gate diagnostics (the reference's /ground_seg,
        # /revert_pc, /reject_pc topics, patchwork.hpp:118-119,465-475)
        if config.ground_segmentation_mode == "Patchwork":
            from quatro_tpu_torch.preprocessing.patchwork import \
                estimate_ground
            pw = estimate_ground(src.points, src.mask, config.patchwork)
            spts = src.points.cpu().numpy()
            save_ply(os.path.join(args.dump_dir, "ground_source.ply"),
                     spts[pw.ground.cpu().numpy()], color=(120, 80, 40))
            save_ply(os.path.join(args.dump_dir, "revert_pc.ply"),
                     spts[pw.reverted.cpu().numpy()], color=(0, 255, 255))
            save_ply(os.path.join(args.dump_dir, "reject_pc.ply"),
                     spts[pw.rejected.cpu().numpy()], color=(255, 0, 0))
        print(f"PLY artifacts written to {args.dump_dir}")

    if args.json:
        print(json.dumps({
            "valid": bool(sol.valid), "transform": T.tolist(),
            "n_correspondences": n_corr,
            "n_final_inliers": int(sol.final_inlier_mask.sum()),
        }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="quatro_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(parser):
        parser.add_argument("--device", default="cuda",
                            help="torch device to run on (default: the "
                                 "card; 'cpu' runs the plain PyTorch "
                                 "versions)")

    r = sub.add_parser("register", help="register a scan pair")
    r.add_argument("src", nargs="?", help="source .bin scan")
    r.add_argument("tgt", nargs="?", help="target .bin scan")
    r.add_argument("--synthetic", action="store_true",
                   help="use a synthetic ray-cast scan pair with known GT")
    r.add_argument("--seed", type=int, default=0)
    # config/params.yaml equivalents
    r.add_argument("--params-yaml", default=None,
                   help="reference-format params.yaml (overrides flags)")
    r.add_argument("--patchwork-yaml", default=None,
                   help="reference-format patchwork_params.yaml")
    r.add_argument("--lidar-type", default="Velodyne-64-HDE")
    r.add_argument("--ground-mode", default="Patchwork",
                   choices=["Patchwork", "LeGO-LOAM"])
    r.add_argument("--no-subclustering", action="store_true",
                   help="skip range-image sub-cluster rejection (keeps all "
                        "non-ground points; more robust on sparse scenes)")
    r.add_argument("--voxel-size", type=float, default=0.3)
    r.add_argument("--normal-radius", type=float, default=0.5)
    r.add_argument("--fpfh-radius", type=float, default=0.75)
    r.add_argument("--auto-radii", action="store_true",
                   help="scale FPFH radii to the sensor's ring spacing "
                        "(FPFHConfig.for_lidar) instead of the KITTI "
                        "defaults — recommended for sparse sensors")
    r.add_argument("--noise-bound", type=float, default=0.3)
    r.add_argument("--num-hypotheses", type=int, default=1,
                   help="solve the K largest distinct cliques and keep the "
                        "best by geometric overlap — recovers repetitive-"
                        "structure (planar aliasing) failures")
    r.add_argument("--gnc-factor", type=float, default=1.4)
    r.add_argument("--num-max-iter", type=int, default=50)
    r.add_argument("--rot-cost-diff-thr", type=float, default=0.00011)
    r.add_argument("--reg-type", default="Quatro",
                   choices=["Quatro", "TEASER"])
    r.add_argument("--max-raw-points", type=int, default=131072)
    r.add_argument("--max-voxels", type=int, default=8192)
    r.add_argument("--max-correspondences", type=int, default=1024)
    r.add_argument("--ground-alignment", action="store_true",
                   help="level scans by their fitted ground planes "
                        "(full 6-DoF, Quatro++ extension)")
    r.add_argument("--refine", action="store_true",
                   help="polish the coarse pose with point-to-plane ICP "
                        "on the device (extension beyond the reference)")
    r.add_argument("--refine-yaw-only", action="store_true",
                   help="restrict ICP updates to yaw + translation")
    r.add_argument("--dump-dir", default=None,
                   help="write source/target/aligned/correspondence PLYs")
    r.add_argument("--json", action="store_true",
                   help="also print a machine-readable JSON result line")
    device_arg(r)
    r.set_defaults(fn=cmd_register)

    e = sub.add_parser("evaluate",
                       help="loop-closure success-rate sweep (synthetic GT)")
    e.add_argument("--n-pairs", type=int, default=50)
    e.add_argument("--lidar-type", default="Velodyne-64-HDE")
    e.add_argument("--max-voxels", type=int, default=8192)
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--num-hypotheses", type=int, default=1)
    e.add_argument("--cache-dir", default=DEFAULT_CACHE,
                   help="disk cache for generated scan pairs")
    e.add_argument("--tilt-deg", type=float, default=0.0,
                   help="random per-scan roll/pitch tilt (non-level "
                        "platform); pair with --ground-alignment")
    e.add_argument("--ground-alignment", action="store_true",
                   help="level scans by their fitted ground planes "
                        "(full 6-DoF, Quatro++ extension)")
    e.add_argument("--refine", action="store_true",
                   help="polish with point-to-plane ICP on the device")
    e.add_argument("--terrain-slope", type=float, default=0.0,
                   help="ground slope (dz/dx) — sloped/curved world")
    e.add_argument("--terrain-amp", type=float, default=0.0,
                   help="ground ripple amplitude (m)")
    e.add_argument("--dynamic-fraction", type=float, default=0.0,
                   help="fraction of cars that MOVE between the captures")
    e.add_argument("--num-vote-hypotheses", type=int, default=0,
                   help="extra clique-independent (yaw, translation)-vote "
                        "hypotheses (solver/vote.py)")
    e.add_argument("--vote-yaw-modes", type=int, default=1,
                   help="vote translations at the top-K yaw histogram "
                        "modes (a dominant aliased structure can outvote "
                        "the true yaw)")
    e.add_argument("--batch", type=int, default=1,
                   help="register pairs in chunks of this size, one call "
                        "over the pair axis each (the bench's serving "
                        "pattern)")
    device_arg(e)
    e.set_defaults(fn=cmd_evaluate)

    o = sub.add_parser("overlap",
                       help="success-vs-overlap sweep over baseline "
                            "distances (partial-overlap robustness)")
    o.add_argument("--baselines", type=float, nargs="+",
                   default=[2.0, 5.0, 10.0, 15.0, 20.0, 25.0])
    o.add_argument("--n-pairs", type=int, default=16)
    o.add_argument("--lidar-type", default="Velodyne-64-HDE")
    o.add_argument("--max-voxels", type=int, default=8192)
    o.add_argument("--num-hypotheses", type=int, default=1)
    o.add_argument("--seed", type=int, default=0)
    o.add_argument("--cache-dir", default=DEFAULT_CACHE)
    device_arg(o)
    o.set_defaults(fn=cmd_overlap)

    q = sub.add_parser(
        "sequence",
        help="register a scan sequence: odometry + place-recognition loop "
             "closing + pose-graph solve (resumable)")
    q.add_argument("scans", nargs="*",
                   help=".bin scan files in order (or a directory of them)")
    q.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="use an N-pose synthetic loop instead of files")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--radius", type=float, default=8.0,
                   help="synthetic loop radius (m)")
    q.add_argument("--lidar-type", default="Velodyne-64-HDE")
    q.add_argument("--auto-radii", action="store_true")
    q.add_argument("--max-raw-points", type=int, default=131072)
    q.add_argument("--max-voxels", type=int, default=8192)
    q.add_argument("--num-hypotheses", type=int, default=1)
    q.add_argument("--ground-alignment", action="store_true")
    q.add_argument("--refine", action="store_true",
                   help="point-to-plane ICP polish on every edge")
    q.add_argument("--min-edge-overlap", type=float, default=0.35)
    q.add_argument("--min-edge-inliers", type=int, default=2)
    q.add_argument("--batch-size", type=int, default=16)
    q.add_argument("--checkpoint-dir", default=None,
                   help="make the run resumable (features + edge log)")
    q.add_argument("--cache-dir", default=DEFAULT_CACHE,
                   help="ray-cast cache for --synthetic scans")
    q.add_argument("--poses-out", default=None,
                   help="write optimized poses as TUM-format trajectory")
    q.add_argument("--trajectory-ply", default=None,
                   help="write the pose graph (path + accepted/rejected "
                        "loop edges) as a PLY line set")
    device_arg(q)
    q.set_defaults(fn=cmd_sequence)

    s = sub.add_parser("sweep",
                       help="correspondence-level outlier-robustness sweep")
    s.add_argument("--rates", type=float, nargs="+",
                   default=[0.5, 0.8, 0.9, 0.95, 0.99])
    s.add_argument("--n-trials", type=int, default=64)
    s.add_argument("--n-corr", type=int, default=512)
    s.add_argument("--seed", type=int, default=0)
    device_arg(s)
    s.set_defaults(fn=cmd_sweep)

    args = p.parse_args(argv)
    if args.cmd == "register" and not args.synthetic \
            and (not args.src or not args.tgt):
        p.error("register needs SRC TGT scans or --synthetic")
    return args.fn(args)


def cmd_evaluate(args) -> int:
    from quatro_tpu_torch.config import (GroundAlignmentConfig, IcpConfig,
                                         LidarConfig, PipelineConfig,
                                         SolverConfig)
    from quatro_tpu_torch.eval import evaluate_loop_closures
    config = PipelineConfig(
        lidar=LidarConfig.preset(args.lidar_type),
        max_voxels=args.max_voxels,
        solver=SolverConfig(num_hypotheses=getattr(args, "num_hypotheses",
                                                   1),
                            num_vote_hypotheses=getattr(
                                args, "num_vote_hypotheses", 0),
                            vote_yaw_modes=getattr(
                                args, "vote_yaw_modes", 1)),
        ground_alignment=GroundAlignmentConfig(
            enabled=getattr(args, "ground_alignment", False)),
        icp=IcpConfig(enabled=getattr(args, "refine", False)))
    terrain = None
    if getattr(args, "terrain_slope", 0.0) or getattr(args, "terrain_amp",
                                                      0.0):
        from quatro_tpu_torch.io.synthetic import Terrain
        terrain = Terrain(slope_x=args.terrain_slope,
                          slope_y=0.4 * args.terrain_slope,
                          amp=args.terrain_amp)
    report = evaluate_loop_closures(
        args.n_pairs, config, seed0=args.seed,
        cache_dir=args.cache_dir,
        tilt_deg=getattr(args, "tilt_deg", 0.0),
        terrain=terrain,
        dynamic_fraction=getattr(args, "dynamic_fraction", 0.0),
        batch=getattr(args, "batch", 1), device=args.device)
    print(json.dumps(report.summary()))
    return 0


def cmd_overlap(args) -> int:
    from quatro_tpu_torch.config import (LidarConfig, PipelineConfig,
                                         SolverConfig)
    from quatro_tpu_torch.eval import evaluate_overlap_sweep
    config = PipelineConfig(
        lidar=LidarConfig.preset(args.lidar_type),
        max_voxels=args.max_voxels,
        solver=SolverConfig(num_hypotheses=args.num_hypotheses))
    out = evaluate_overlap_sweep(tuple(args.baselines), args.n_pairs,
                                 config, seed0=args.seed,
                                 cache_dir=args.cache_dir,
                                 device=args.device)
    print(json.dumps(out))
    return 0


def cmd_sequence(args) -> int:
    """Trajectory mode: odometry + loop closing, the Quatro++ use case the
    reference's one-pair demo cannot express."""
    from quatro_tpu_torch.config import (FPFHConfig, GroundAlignmentConfig,
                                         IcpConfig, LidarConfig,
                                         PipelineConfig, SolverConfig)
    from quatro_tpu_torch.sequence import (make_synthetic_sequence,
                                           run_sequence)

    lidar = LidarConfig.preset(args.lidar_type)
    fpfh = (FPFHConfig.for_lidar(lidar) if args.auto_radii else FPFHConfig())
    config = PipelineConfig(
        lidar=lidar, fpfh=fpfh,
        max_raw_points=args.max_raw_points, max_voxels=args.max_voxels,
        solver=SolverConfig(num_hypotheses=args.num_hypotheses),
        ground_alignment=GroundAlignmentConfig(
            enabled=args.ground_alignment),
        icp=IcpConfig(enabled=args.refine))

    gt = None
    if args.synthetic:
        scans, gt = make_synthetic_sequence(
            num_poses=args.synthetic, seed=args.seed, radius=args.radius,
            config=config, raw_capacity=args.max_raw_points,
            cache_dir=args.cache_dir)
    else:
        from quatro_tpu_torch.io.kitti import load_kitti_bin
        from quatro_tpu_torch.types import PointBatch
        paths = list(args.scans)
        if len(paths) == 1 and os.path.isdir(paths[0]):
            paths = sorted(
                os.path.join(paths[0], f) for f in os.listdir(paths[0])
                if f.endswith(".bin"))
        if len(paths) < 2:
            raise SystemExit("sequence needs >= 2 scans (or --synthetic N)")
        scans = [PointBatch.from_numpy(load_kitti_bin(p),
                                       args.max_raw_points) for p in paths]

    res = run_sequence(scans, config, gt_poses=gt,
                       use_place_recognition=True,
                       min_edge_overlap=args.min_edge_overlap,
                       min_edge_inliers=args.min_edge_inliers,
                       batch_size=args.batch_size,
                       checkpoint_dir=args.checkpoint_dir,
                       device=args.device)

    if args.poses_out:
        # TUM format: timestamp tx ty tz qx qy qz qw (yaw-only quaternion)
        with open(args.poses_out, "w") as f:
            for k, p in enumerate(res.poses):
                h = 0.5 * p[3]
                f.write(f"{k:.1f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"0.0 0.0 {np.sin(h):.6f} {np.cos(h):.6f}\n")
    if args.trajectory_ply:
        from quatro_tpu_torch.io.ply import save_trajectory_ply
        save_trajectory_ply(args.trajectory_ply, res.poses,
                            res.edges_i, res.edges_j, res.edge_mask)

    print(json.dumps({
        "frames": len(scans),
        "edges_total": res.edges_total,
        "edges_valid": res.edges_valid,
        "loop_candidates": res.edges_total - (len(scans) - 1),
        "ate_before": None if np.isnan(res.ate_before)
        else round(res.ate_before, 4),
        "ate_after": None if np.isnan(res.ate_after)
        else round(res.ate_after, 4),
        "wall_s": round(res.wall_s, 2),
        "poses_out": args.poses_out}))
    return 0


def cmd_sweep(args) -> int:
    from quatro_tpu_torch.eval import evaluate_outlier_robustness
    res = evaluate_outlier_robustness(outlier_rates=args.rates,
                                      n_trials=args.n_trials,
                                      n_corr=args.n_corr, seed0=args.seed,
                                      device=args.device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
