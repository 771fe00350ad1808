#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when a check fails:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the float32 precision flags (TF32 off everywhere);
2. build: the ten kernels from quatro_tpu_torch/csrc, one nvcc per
   source, all started together; build time and ptxas register and spill
   summary;
3. pipeline, main path: ``register_scan_pair`` on the raw seed-11 HDL-64E
   synthetic pair (the pair of tests/test_pipeline.py, capacity 131072)
   under the shipping ``PipelineConfig.recommended(max_voxels=8192)``:
   Patchwork ground removal, range-image sub-clustering, then 8192
   voxels, 1024 correspondences and 4 clique + 2 vote hypotheses
   arbitrated by overlap, on the card. The pose must be valid and within
   0.05 rad / 0.6 m of the ground truth, and the launch counts over the run
   must be 1 (moments), 1 (SPFH), 1 (FPFH), 2 (top-2 NN), 1 (consistency
   graph), 1 (segment sums), 1 (cross histogram), 3 (plane-fit moments),
   1 (classification) and 1 (image lookup). Per-stage times from CUDA
   events after one warm-up run; ground, non-ground and segment points per
   cloud; each hypothesis's size, validity and overlap and the winner; the
   pair latency over ten more runs;
4. pipeline, earlier paths: ``register_features`` on the same pair after a
   crude ground strip (65536 points per cloud), under the same
   recommended configuration (launches as above but 0 for the four
   preprocessing kernels) and under the single-hypothesis
   ``PipelineConfig(max_voxels=8192)`` (also 0 segment sums), with the
   pose bands 0.05 rad / 0.5 m, their stage split and their latency over
   three runs each;
5. profile: one more run of the main path under torch.profiler (after
   the timed runs, since the profiler slows the host for the runs after
   it): the card's busy time, its idle share of the median pair, the top
   kernels and the device time per launch of each of the port's kernels;
6. kernels: each kernel on the main path's own tensors against its plain
   PyTorch version on the card, with its time, the plain version's time,
   the least time the card could take for the same work, and one library
   call computing the same function where there is one (top-2 NN, segment
   sums, cross histogram, image lookup).

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
# test (3 sub, 3 mul, 2 add, 1 compare) on every pair of valid points, and
# the work on each pair inside the radius.
OPS_PAIR_TEST = 9
OPS_MOMENTS = 16          # 10 accumulations, 6 products
OPS_SPFH = 80             # Darboux frame, atan2 and three bins (approx.)
OPS_FPFH = 2 + 2 * 33     # weight (max, divide) and 33 FMAs
OPS_NN = 2 * 33 + 4       # 33 FMAs, the expansion, the top-2 compares
OPS_GRAPH = 21            # per pair: 2 x (3 sub, 3 mul, 2 add, sqrt),
                          # sub, abs, compare
OPS_PLANE = 6             # per point: projection (3 mul, 2 add), compare
OPS_MOMENTS_PT = 16       # per member point: 6 products, 10 additions
OPS_CLASSIFY = 8          # projection, compare, flag arithmetic

PAIR_REPEATS = 10         # timed runs of the main path
EARLIER_REPEATS = 3       # timed runs of each earlier path
PIPELINE_PAIR = dict(seed=11, yaw_deg=20.0, translation=(2.5, 1.0, 0.05))
RAW_CAPACITY = 131072

REPLACES = {
    "moment_sums": "quatro_tpu/ops/pallas_frontend.py:293",
    "spfh": "quatro_tpu/ops/pallas_frontend.py:366",
    "fpfh": "quatro_tpu/ops/pallas_frontend.py:391",
    "nearest_neighbors2": "quatro_tpu/ops/pallas_frontend.py:550",
    "consistency_graph": "quatro_tpu/ops/pallas_kernels.py:47",
    "segment_sums": "quatro_tpu/ops/segment_matmul.py:158",
    "cross_histogram": "quatro_tpu/ops/segment_matmul.py:225",
    "fit_iteration_moments": "quatro_tpu/ops/segment_matmul.py:309",
    "classify_points": "quatro_tpu/ops/segment_matmul.py:385",
    "image_lookup": "quatro_tpu/ops/segment_matmul.py:482",
}
SOURCES = {
    "moment_sums": "quatro_tpu_torch/csrc/moment_sums.cu",
    "spfh": "quatro_tpu_torch/csrc/spfh.cu",
    "fpfh": "quatro_tpu_torch/csrc/fpfh.cu",
    "nearest_neighbors2": "quatro_tpu_torch/csrc/nn2.cu",
    "consistency_graph": "quatro_tpu_torch/csrc/consistency_graph.cu",
    "segment_sums": "quatro_tpu_torch/csrc/segment_sums.cu",
    "cross_histogram": "quatro_tpu_torch/csrc/cross_histogram.cu",
    "fit_iteration_moments": "quatro_tpu_torch/csrc/fit_iteration_moments.cu",
    "classify_points": "quatro_tpu_torch/csrc/classify_points.cu",
    "image_lookup": "quatro_tpu_torch/csrc/image_lookup.cu",
}
MAIN_LAUNCHES = {"moment_sums": 1, "spfh": 1, "fpfh": 1,
                 "nearest_neighbors2": 2, "consistency_graph": 1,
                 "segment_sums": 1, "cross_histogram": 1,
                 "fit_iteration_moments": 3, "classify_points": 1,
                 "image_lookup": 1}
FEATURES_LAUNCHES = dict(MAIN_LAUNCHES, cross_histogram=0,
                         fit_iteration_moments=0, classify_points=0,
                         image_lookup=0)
SINGLE_LAUNCHES = dict(FEATURES_LAUNCHES, segment_sums=0)


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
    from quatro_tpu_torch.utils.se3 import rotation_geodesic_error
    rot = sol.rotation.detach().cpu()
    rerr = float(rotation_geodesic_error(
        torch.from_numpy(gt[:3, :3]).float(), rot))
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
    log(smi.stdout.strip().splitlines()[0])
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
    capacity 131072 for the main path, and 65536 points per cloud after
    the crude ground strip for the earlier paths; the shipping
    multi-hypothesis configuration and the single-hypothesis default at
    8192 voxels."""
    from quatro_tpu_torch.config import PipelineConfig
    from quatro_tpu_torch.io.synthetic import make_scan_pair
    from quatro_tpu_torch.types import PointBatch

    src_xyz, tgt_xyz, gt = make_scan_pair(**PIPELINE_PAIR)
    main = PipelineConfig.recommended(max_voxels=8192)
    single = PipelineConfig(max_voxels=8192)
    raw = (PointBatch.from_numpy(src_xyz, capacity=RAW_CAPACITY),
           PointBatch.from_numpy(tgt_xyz, capacity=RAW_CAPACITY))
    stripped = (PointBatch.from_numpy(nonground(src_xyz), capacity=65536),
                PointBatch.from_numpy(nonground(tgt_xyz), capacity=65536))
    log(f"pipeline: HDL-64E pair seed 11, {int(raw[0].mask.sum())} / "
        f"{int(raw[1].mask.sum())} raw points (capacity {RAW_CAPACITY}), "
        f"Patchwork {main.patchwork.num_patches} patches, range image "
        f"{main.lidar.n_scan} x {main.lidar.horizon_scan}, max_voxels "
        f"{main.max_voxels}, max_correspondences "
        f"{main.fpfh.max_correspondences}, hypotheses "
        f"{main.solver.num_hypotheses} clique + "
        f"{main.solver.num_vote_hypotheses} vote; earlier paths "
        f"{int(stripped[0].mask.sum())} / {int(stripped[1].mask.sum())} "
        "points after the crude ground strip")
    return raw, stripped, gt, main, single


def phase_pipeline(entry, pair, gt, cfg, name, expected, repeats,
                   max_terr=0.5):
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
    check(rerr < 0.05, f"{name}: rotation error {rerr} rad")
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
    return res, launches, wall_ms


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
    own = {name.split("(")[0]: round(ms / count, 6)
           for name, ms, count in rows if name.startswith("quatro::")}
    log("profile: device ms per launch of the port's kernels: "
        + json.dumps(own))


def phase_kernels(res, cfg, launches, calls):
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

    def row(name, err, k_ms, p_ms, ops, nbytes, lib_ms=None):
        b_ms, by = bound(ops, nbytes)
        r = {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": REPLACES[name], "launches": launches[name],
             "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
             "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
        log(json.dumps(r))
        rows.append(r)

    # B3 moment sums
    got = fe.moment_sums(pts, maskf, rn)
    ref = fe.moment_sums_plain(pts, maskf, rn)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    pairs_all = float((nv * nv).sum())
    n_rn = in_radius(rn, mask)
    row("moment_sums", float((got - ref).abs().max()),
        cuda_ms(lambda: fe.moment_sums(pts, maskf, rn)),
        cuda_ms(lambda: fe.moment_sums_plain(pts, maskf, rn), 5),
        pairs_all * OPS_PAIR_TEST + (n_rn + float(nv.sum())) * OPS_MOMENTS,
        bsz * v * (3 + 1 + 10) * 4)

    # B4 SPFH, on the pipeline's own normals
    normals = fe.frontend_normals(pts, mask, rn)
    nrm = normals.normals.contiguous()
    pmask = mask & normals.valid
    pmf = pmask.float().contiguous()
    hist, cnt = fe.spfh(pts, nrm, pmf, rf)
    rhist, rcnt = fe.spfh_plain(pts, nrm, pmf, rf)
    check(torch.equal(cnt, rcnt), "SPFH pair counts differ")
    flipped = float((hist != rhist).any(-1).float().mean())
    log(f"spfh: bin-edge flips on {flipped:.4%} of rows")
    check(flipped < 0.005, f"SPFH bins differ on {flipped:.2%} of rows")
    npv = pmask.sum(1).double()
    n_rf = in_radius(rf, pmask)
    row("spfh", float((hist - rhist).abs().max()),
        cuda_ms(lambda: fe.spfh(pts, nrm, pmf, rf)),
        cuda_ms(lambda: fe.spfh_plain(pts, nrm, pmf, rf), 5),
        float((npv * npv).sum()) * OPS_PAIR_TEST + n_rf * OPS_SPFH,
        bsz * v * (3 + 3 + 1 + 33 + 1) * 4)

    # B5 FPFH weighted sums, compared after the per-block normalisation
    srows = (hist * (100.0 / torch.clamp(cnt, min=1.0))[..., None]).contiguous()
    got = fe.fpfh_sums(pts, srows, pmf, rf)
    ref = fe.fpfh_sums_plain(pts, srows, pmf, rf)
    diff = (normalize_blocks(got) - normalize_blocks(ref)).abs()
    check(float(diff.mean()) < 0.02, f"FPFH mean diff {float(diff.mean())}")
    affected = float((diff.amax(-1) > 1.0).float().mean())
    check(affected < 0.02, f"FPFH rows off by > 1: {affected:.2%}")
    row("fpfh", float(diff.max()),
        cuda_ms(lambda: fe.fpfh_sums(pts, srows, pmf, rf)),
        cuda_ms(lambda: fe.fpfh_sums_plain(pts, srows, pmf, rf), 5),
        float((npv * npv).sum()) * OPS_PAIR_TEST + n_rf * OPS_FPFH,
        bsz * v * (3 + 33 + 1 + 33) * 4)

    # B7 top-2 NN, source descriptors against target descriptors
    desc = fe.frontend_fpfh(pts, nrm, normals.valid, mask, rf).contiguous()
    dmask = pmask.contiguous()
    da, db = desc[0:1], desc[1:2]
    ma, mb = dmask[0:1], dmask[1:2]
    i1, d1, i2, d2 = fe.nearest_neighbors2(da, db, ma, mb)
    sq_a, sq_b = (da * da).sum(-1), (db * db).sum(-1)
    ri1, rd1, ri2, rd2 = fe._fill_empty(*fe.nearest_neighbors2_plain(
        da, db, ma.float(), mb.float(), sq_a, sq_b), ma)
    # distances within rtol 1e-5 plus 1e-6 of the largest |a|^2 + |b|^2
    # (the expansion's rounding, all there is of a distance between equal
    # descriptors); the first index equal wherever the top-2 gap is clear
    scale = float(sq_a.max() + sq_b.max())
    for got_d, ref_d in ((d1, rd1), (d2, rd2)):
        ok = ~ma | ((got_d - ref_d).abs() <= 1e-5 * ref_d.abs() + 1e-6 * scale)
        check(bool(ok.all()), "top-2 distances differ")
    clear = ma & (rd2 - rd1 > 1e-4 * rd1)
    check(torch.equal(i1[clear], ri1[clear]), "top-2 first indices differ")
    log(f"nearest_neighbors2: {int(clear.sum())} of {int(ma.sum())} valid "
        f"rows with a clear gap, i1 equal on all of them")

    def library_top2():
        d = torch.cdist(da[0], db[0]).square()
        d = torch.where(ma[0][:, None] & mb[0][None, :], d, fe.FLT_MAX)
        return torch.topk(d, 2, dim=1, largest=False)

    nva, nvb = float(ma.sum()), float(mb.sum())
    row("nearest_neighbors2",
        float((d1 - rd1)[ma].abs().max()),
        cuda_ms(lambda: fe.nearest_neighbors2(da, db, ma, mb)),
        cuda_ms(lambda: fe.nearest_neighbors2_plain(
            da, db, ma.float(), mb.float(), sq_a, sq_b), 5),
        nva * nvb * OPS_NN,
        (2 * v * (33 + 1)) * 4 + v * 4 * 4,
        cuda_ms(library_top2))

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
        cuda_ms(lambda: kernels.consistency_graph(cs, ct, beta)),
        cuda_ms(lambda: kernels.consistency_graph_plain(cs, ct, beta), 5),
        float(n * n) * OPS_GRAPH, 2 * n * 3 * 4 + n * n)

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
    ref = segment.segment_sums_plain(ids, vals, p_pad)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    in_range = int(((ids >= 0) & (ids < p_pad)).sum())
    log(f"segment_sums: N {nv_ids}, K {kv}, p_pad {p_pad}, {in_range} "
        "entries in range, bit-equal across two launches")
    dest = torch.where((ids >= 0) & (ids < p_pad), ids, p_pad).long()
    src_rows = vals.T.contiguous()

    def library_segment():
        return torch.zeros((p_pad + 1, kv), device=vals.device).index_add_(
            0, dest, src_rows)

    row("segment_sums", float((got - ref).abs().max()),
        cuda_ms(lambda: segment.segment_sums(ids, vals, p_pad)),
        cuda_ms(lambda: segment.segment_sums_plain(ids, vals, p_pad), 5),
        float(in_range * kv), nv_ids * 4 * (1 + kv) + p_pad * kv * 4,
        cuda_ms(library_segment))
    preprocessing_kernel_rows(calls, row)
    return rows


def preprocessing_kernel_rows(calls, row):
    """B8-B11 on the arguments the main path handed them: each against its
    plain version (B8 and B9 bit-equal across two launches and within
    rtol 1e-5 / atol 1e-4 of the plain sums, the f32 summation-order bound
    of B2; B9's membership counts equal; B10 and B11 bit-equal)."""
    from quatro_tpu_torch.ops import segment

    # B8 cross histogram: the Patchwork seed stage
    (ids_a, ids_b, w, a_pad, b_pad), _ = calls["cross_histogram"][0]
    got = segment.cross_histogram(ids_a, ids_b, w, a_pad, b_pad)
    again = segment.cross_histogram(ids_a, ids_b, w, a_pad, b_pad)
    check(torch.equal(got, again), "cross histogram differs between launches")
    ref = segment.cross_histogram_plain(ids_a, ids_b, w, a_pad, b_pad)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
    check(torch.equal(got[:, 0], ref[:, 0]), "cross histogram counts differ")
    bsz, k, n = w.shape
    inr = ((ids_a >= 0) & (ids_a < a_pad) & (ids_b >= 0) & (ids_b < b_pad))
    bins = a_pad * b_pad
    key = torch.where(inr, ids_a.long() * b_pad + ids_b.long(), bins)
    offs = (torch.arange(bsz * k, device=w.device) * (bins + 1)).reshape(
        bsz, k, 1)
    flat_key = (key[:, None, :] + offs).reshape(-1)
    flat_w = w.reshape(-1)
    log(f"cross_histogram: B {bsz}, N {n}, K {k}, {a_pad} x {b_pad} bins, "
        f"{int(inr.sum())} points in range, bit-equal across two launches")
    row("cross_histogram", float((got - ref).abs().max()),
        cuda_ms(lambda: segment.cross_histogram(ids_a, ids_b, w, a_pad,
                                                b_pad)),
        cuda_ms(lambda: segment.cross_histogram_plain(ids_a, ids_b, w,
                                                      a_pad, b_pad), 5),
        float(inr.sum()) * k, bsz * n * 4 * (2 + k) + bsz * k * bins * 4,
        cuda_ms(lambda: torch.bincount(flat_key, weights=flat_w,
                                       minlength=bsz * k * (bins + 1))))

    # B9 plane-fit moments: iterations 1-2 in bf16, the last exact
    errs = []
    for (ids, chan, tab, p_pad, p_cnt), kw in calls["fit_iteration_moments"]:
        got = segment.fit_iteration_moments(ids, chan, tab, p_pad, p_cnt, **kw)
        again = segment.fit_iteration_moments(ids, chan, tab, p_pad, p_cnt,
                                              **kw)
        check(torch.equal(got, again), "plane-fit moments differ between "
              "launches")
        ref = segment.fit_iteration_moments_plain(ids, chan, tab, p_pad,
                                                  p_cnt, **kw)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
        check(torch.equal(got[..., 0], ref[..., 0]),
              "plane-fit membership counts differ")
        errs.append(float((got - ref).abs().max()))
        log(f"fit_iteration_moments (exact={kw['exact']}): "
            f"{int(got[..., 0].sum())} member points, counts equal, "
            "bit-equal across two launches")
    bsz, _, n = chan.shape
    members = float(got[..., 0].sum())
    row("fit_iteration_moments", max(errs),
        cuda_ms(lambda: segment.fit_iteration_moments(ids, chan, tab, p_pad,
                                                      p_cnt, **kw)),
        cuda_ms(lambda: segment.fit_iteration_moments_plain(
            ids, chan, tab, p_pad, p_cnt, **kw), 5),
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
        cuda_ms(lambda: segment.classify_points(ids, chan, tab, p_pad,
                                                p_cnt)),
        cuda_ms(lambda: segment.classify_points_plain(ids, chan, tab, p_pad,
                                                      p_cnt), 5),
        bsz * n * OPS_CLASSIFY, bsz * n * 4 * (1 + 3 + 1)
        + bsz * p_pad * 5 * 4)

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
        cuda_ms(lambda: segment.image_lookup(flat, img, rows_n, cols_n)),
        cuda_ms(lambda: segment.image_lookup_plain(flat, img, rows_n,
                                                   cols_n), 5),
        0.0, bsz * n * 4 * 2 + bsz * npix * 4,
        cuda_ms(lambda: torch.take(padded, idx)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import quatro_tpu_torch  # noqa: F401  (fails outside the repository)

    phase_device()
    phase_build()
    from quatro_tpu_torch.pipeline import register_features, register_scan_pair
    raw, stripped, gt, main_cfg, single_cfg = full_width_case()
    res, launches, wall_ms = phase_pipeline(
        register_scan_pair, raw, gt, main_cfg, "main path", MAIN_LAUNCHES,
        PAIR_REPEATS, max_terr=0.6)
    calls = capture_preprocessing(raw, main_cfg)
    phase_pipeline(register_features, stripped, gt, main_cfg,
                   "earlier path (features, recommended)", FEATURES_LAUNCHES,
                   EARLIER_REPEATS)
    phase_pipeline(register_features, stripped, gt, single_cfg,
                   "earlier path (features, single hypothesis)",
                   SINGLE_LAUNCHES, EARLIER_REPEATS)
    phase_profile(raw, main_cfg, wall_ms)
    rows = phase_kernels(res, main_cfg, launches, calls)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
