#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when a check fails:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the float32 precision flags (TF32 off everywhere);
2. build: the thirty kernels from quatro_tpu_torch/csrc (the twelve
   of the JAX package's Pallas calls, the exact clique search, the
   Kabsch rotation, the range-image labelling, the overlaps' hit
   counts, the range image's point keys and owners, edge masks and
   component stats, Patchwork's CZM points, seed heights and plane
   fits, the clique stage's k-core search, growth, swaps and
   distinct greedy, and ICP's neighbour lists, normals, correspondences
   and updates), one nvcc per source (twenty-five: the seed heights
   and plane fits share csrc/plane_fit.cu, the clique stage's four
   csrc/cliques.cu, ICP's correspondences and updates csrc/icp.cu), all
   started together; build time and ptxas register and spill summary;
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
   lookup), 0 (table lookup), 1 (overlap hits), 1 each (range image, edge
   masks, component stats: one wrapper call a ``segment_cloud`` call),
   1/1/3 for CZM points, seed heights, plane fits (one wrapper call an
   ``estimate_ground`` call, a plane fit one a fit), 1/1/1/2 for the
   k-core search, growth, swaps and distinct greedy (the K clique
   hypotheses' and the vote's), 1/1/13/12 for ICP's neighbour lists,
   normals, correspondences and updates (the target's lists and normals
   once, a correspondence and an update a pass of the 12 in the loop's
   CUDA graph, counted at its replays, and the correspondences once more
   at the returned pose) and 1 (the labelling: one
   launch a ``label_components`` call, each image to its own exit; every
   path's launch counts hold it so, and its logs give the most rounds an
   image ran, ``launch_counts``). Per-stage times from CUDA events after
   one warm-up run
   ("leveling" and "icp" among them); ground, non-ground and segment points
   per cloud; the hypotheses and the winner; the pair latency over five
   more runs. Then its device loops (utils/loops.py; Patchwork's bf16
   plane fits, the GNC, the overlaps' blocks and ICP's passes; the clique
   stage's loops, the k-core search, the growth, the swaps and the
   distinct greedy, run on the card only on their plain route since its
   four kernels, csrc/cliques.cu) on its own tensors, each recorded in one more
   run and run again through the CUDA-graph route (twice) and through
   ``eager_loops()`` at its chunk and at chunk 1 (a flag read per round,
   as before the graphs), all bit for bit, with each loop's calls,
   rounds, flag reads, captures, replays and ms per route; a ``fori``
   must read no flag, a ``while_chunks`` loop at most ceil(rounds /
   chunk) + 1 (``phase_loops``; path P's B = 8 call, path S's extraction
   and registration and its pose graph, and path M's pose graph
   likewise);
4. path B, the reference matcher: ``register_scan_pair`` on the untilted
   raw pair under ``PipelineConfig(max_voxels=8192)`` with
   ``crosscheck_min_matches=0`` (crosscheck and tuple test with no
   starvation fallback, the single-clique solver): valid, within 0.05 rad
   / 0.6 m, launches 2 (1-NN), 0 (top-2 NN), 0 (segment sums); three timed
   runs. Then ``register_correspondences`` on its correspondences under
   each solver mode off the shipping path (TEASER full SO(3), FGR, the
   3-D FGR, the TLS scale, exact clique): each valid and within 0.01 rad
   / 0.1 m of path B's own pose, the scale within 0.02 of 1, the exact
   search one kernel launch (0 in every other mode), the Kabsch kernel
   launched in the SO(3) modes (TEASER, the 3-D FGR) and in no other;
   each mode's time,
   GNC iterations and device loops; for the exact search its completion,
   restriction and steps, and the host search (Python-int bitsets) timed
   beside it (the same solution); for TEASER and the 3-D FGR their GNC loop
   captured and replayed, bit-equal to ``eager_loops()`` with equal
   launches, and the route before the Kabsch kernel (torch.linalg.svd,
   uncaptured) timed beside it;
   the exact kernel bit-equal to its plain version run on the card (mask,
   completed, restricted, steps) at B = 1, truncated at 40 steps and at a
   cap of 256 (four 64-bit words). Then every mode at B = 8 on the
   correspondences of path P's bench.py pairs in one call, each row
   bit-equal to its per-pair call, and the exact kernel against its
   plain version there; then TEASER on the JAX package's own path B
   correspondences (tests/torch_teaser_path_b.npz), against the JAX
   package's TEASER pose on the CPU;
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
   the launch counts per frame (B3-B5, B8, B10, B11, the labelling and
   ICP's lists and normals once, B9 three times), per batched
   registration call of up to 16 edges (B7 twice, B1 and B2 once, ICP's
   correspondences 13 and updates 12 times) and per pose-graph solve (B2
   once per J^T apply, 10 x 41); ICP's four kernels on one frame's
   extraction and the first batch of edges, every call bit for bit its
   plain version on the card; a second ``optimize_pose_graph`` on the
   run's edges equal to
   it bit for bit, uncaptured (its J^T calls recorded), replayed, and as
   a one-shot solve with no graph kept; ``run_odometry_windowed(window=4)``
   equal to
   ``OdometryRunner.step`` within 1e-5 rad / 1e-4 m. Times: per-frame
   extraction and per-edge registration (median and spread), Scan
   Context, the pose graph, the whole sequence, and the device idle share
   of one ``OdometryRunner.step``; the device loops of one frame's
   extraction and one edge's registration (``phase_loops``); every
   labelling and every ``estimate_ground`` call of the run against its
   plain route on the card, bit for bit;
7. path E, the user's entry points (eval.py and cli.py, as a user calls
   them, at full width): (a) ``evaluate_loop_closures(n_pairs=16,
   batch=8, config=recommended(max_voxels=8192), raw_capacity=131072,
   seed0=0)`` (the JAX package's success-rate record, EVAL_r05.json
   ``tpu_n300_shipping``), its pairs ray-cast once by the harness's
   process pool into a cache, then the same with ``batch=1``: at least 15
   of 16 pairs within 5 deg / 2 m (failures printed), every batched row's
   valid and correspondence count equal to batch 1's and its errors
   within 1e-3 deg / 1e-4 m, each batched call's launches equal to one
   pair's (path A's counts but ICP's: no ICP); the summary, pairs/s of
   both and the
   ray-cast seconds; (b) ``evaluate_outlier_robustness()`` at its
   defaults (rates 0.5 to 0.99, 64 trials of 512 correspondences: one
   ``register_batch`` call at B = 64 a rate, one B1 launch each), >= 5/6
   at rates 0.5 and 0.9, each rate's row and call ms; (c)
   ``cli.main(["register", "--synthetic", "--seed", "11", ...,
   "--dump-dir", ..., "--json"])`` on the card: valid, the ten PLY
   artifacts, the stage table; then ``register a.bin b.bin`` on the same
   pair written as KITTI .bin and read by the native loader (which must
   build): its transform equal to the synthetic run's;
8. profile: one more run of path A under torch.profiler (after the timed
   runs, since the profiler slows the host for the runs after it): the
   card's busy time, its idle share of the median pair, the top kernels
   and the device time per launch of each of the port's kernels, and of
   B3's, B4's, B5's and B9's wrappers with all their kernels; the device
   busy time of each stage (``stage_device_busy``: the device events
   between marker fills launched at the stage ends) beside its ms, and
   every stage's device time and launches by kernel; and
   the ``icp`` stage's device time and launches by sub-step (raw voxels,
   lists, normals, passes, final) and kernel (``icp_substeps``);
9. kernels: each kernel on the main path's own tensors (B6 on path B's
   descriptors, B12 on the rows B10 was handed) against its plain PyTorch
   version, with its time, the plain version's time, the least time the
   card could take for the same work, and one library call computing the
   same function where there is one (1-NN, top-2 NN, segment sums, cross
   histogram, image lookup, table lookup); the exact clique search on path
   B's exact mode's restriction, with its steps and device ns per step
   (bound: this run's steps, and the restriction's bytes); the Kabsch
   kernel on path B's TEASER mode's first GNC iteration, bit for bit its
   plain version on the card and on CPU copies (for both, the bound in
   bytes and operations does not apply: ``bound_applies`` false, their
   serial chains limit them); the labelling kernel on path A's labelling
   call, bit for bit its plain route (labels and each image's rounds) on
   the card and on CPU copies, its row timing the whole labelling (one
   launch; bound: the bytes of valid, the masks and the labels written,
   13 a pixel), with its cluster size and shared memory a CTA, and
   segment_cloud with the kernel against the plain route on the card
   under all three neighbour modes and at max_cc_iters = 2 (every field,
   labels, feasibility, rounds) on path A's clouds and on a VLP-16 and an
   Ouster OS1-64 pair, the range image's three kernels with it (their
   plain versions on the plain route); the range image's keys and owners,
   edge masks and component stats each on path A's recorded operands,
   bit for bit their plain versions on the card (NaN where NaN) and
   across two launches, the range image also with NaN and inf points and
   with a max_points prefix of half the valid points and none, the edge
   masks under all three neighbour modes; Patchwork's CZM points, seed
   heights and plane fits on path A's ``estimate_ground`` operands, on the
   VLP-16 and OS1-64 pairs with NaN and inf points and an empty cloud,
   each under the configured Patchwork and under ``PATCHWORK_VARIANT``
   (the global elevation gate, one fit): every wrapper call bit for bit
   its plain version on the card and across two launches, and every
   field of ``estimate_ground`` with the kernels bit for bit the plain
   routes (``patchwork_cases``); the clique stage's four kernels on path
   A's calls (the k-core search with the graph's pack, the growth and
   swaps on its packed graph, both distinct greedies), each bit for bit
   its plain version on the card, and on tests/torch_clique_cases.py's
   graphs (N = 1, 33, 100, an all-False mask, an edgeless, a complete, a
   self-loop, an asymmetric graph, a junk pair, 195 miss-one vertices)
   and at N = 2048, whose packed rows exceed a block's shared memory
   (``clique_cases``; their library column one round's cuBLAS counting
   product, their bound the bool graph's bytes); ICP's four kernels on
   path A's calls (the target's lists and normals, every pass's
   correspondences and update, the final correspondences), each bit for
   bit its plain version on the card and across two launches, with the
   blocks a launch runs and the SMs they spread over, the library calls
   ``torch.cdist`` + ``topk`` (lists) and ``cdist`` + ``argmin``
   (correspondences), their bound the operations of the distances to
   the valid columns and the bytes in and out once (``icp_kernel_rows``);
   each with its row (device ms
   of every event of the wrapper's call, the sort's too, and of the
   port's kernels alone; bound: the inputs read and outputs written once,
   OPS_RANGE_POINT / OPS_EDGE / OPS_STATS; no library call); the overlap
   kernel on path A's arbitration
   call (bound: 9 operations per valid source row and valid target
   point), bit for bit its plain version on the card and on CPU copies,
   and with a NaN in a valid target point (no hit). B2, B3 (with
   its active limits and the tile pairs it tested and skipped), B5 (alone
   and on B4's tile table), B6, B7 (both directions, with the active
   limits it found), B8, B9 (both flags, with its active limits) and the
   exact search are held bit for bit against their plain versions run on
   CPU copies of the same inputs and across two launches, B2 also on the
   arguments of one J^T apply of path S's pose graph, with a row of its
   own (``pose_graph`` in B2's row), and B1 also on a seeded N = 1000
   (rows that start inside a 16-byte piece), and its branch-free square
   root against __fsqrt_rn on every non-negative float;
   B4's counts and bins equal those of its plain
   version run on the card (the same rsqrtf and atan2f), and the tile
   pairs kept at the FPFH radius are printed. Each row also
   has the device time per call of the kernel and of the library call
   (torch.profiler, from a profiled run that saw every call, the calls
   between two runs of marker fills), so that the two compare like with
   like; the phase fails, naming them, where a kernel's row or B9's
   uncaptured bf16 trip has none. B9's
   row also times a bf16 trip inside a CUDA graph and uncaptured. The bounds of the radius-pair kernels (B3,
   B4, B5) count the radius tests of the valid pairs in the tile pairs
   that an exact culling keeps (``culled_pairs``), and their bytes the
   mask and the outputs of every row but the points, normals and SPFH
   rows of the valid rows only (``radius_pair_bytes``): the kernels read
   no other;
10. path P, the pair axis, after the kernels (its large batches and
   profiles leave the profiler missing more events in the runs after
   them): (a)
   bench.py's 8 distinct HDL-64E pairs (``make_scan_pair(seed=s, yaw_deg=10+7s, translation=(2+0.3s, 1-0.2s,
   0.05))``, capacity 131072) under its configuration (8192 voxels, 1024
   correspondences, 4 + 2 hypotheses) as one ``register_scan_pair`` call
   at B = 8, and (b) path A's configuration at B = 4 on path A's tilted
   pair and the first three bench pairs tilted alike: every row equal to
   the per-pair call on its pair (exactly the voxels, correspondence
   slots, masks, valid, GNC iterations, winner and ICP's inliers; poses
   within 1e-5 rad / 1e-4 m), the batched call's launch counts equal to
   one pair's, and each pair within 0.05 rad / 0.6 m of the ground truth
   alone within it batched (the count printed); (c) ms per call and
   pairs/s at B = 1, 8 and 64 (the 8 pairs cycled, as bench.py does),
   median and spread of 3 runs after a warm-up, with the stage split and
   the peak memory, the device loops' counters of a call, the device
   idle share of the B = 8 call under torch.profiler, B = 64's stage split
   with each stage's device busy time, and B1 with its pair axis at B = 8
   and 64 (one launch, bit for bit its plain version on CPU copies,
   device ms beside its bound; ``pair_axis`` in B1's row of the kernel
   table); at each B the batched voxel grid equal to the per-cloud call
   on every cloud (128 at B = 64) and the overlaps to the per-pair call
   on every pair, bit for bit; at B = 64 the labelling kernel on the 128
   images, the overlap kernel on the 384 (pair, pose) rows and the range
   image's three kernels on the 128 clouds, each bit for bit its plain
   version on the card with its device, call and plain ms and bound
   (``b64`` in their rows), Patchwork's three kernels likewise on the 128
   clouds' ``estimate_ground`` call (``patchwork_cases``, ``b64``), the
   clique stage's four on the 64 pairs' calls (``clique_rows_b64``), B2
   on the vote's call with its bound and ``index_add_`` on the same ids
   and values (``b2_row_b64``, ``b64`` in B2's row),
   segment_cloud with the kernels against the
   plain routes under all three neighbour modes and at max_cc_iters = 2,
   and every stage's device time and launches by kernel (as for path A
   in the profile phase);
11. path M, the multi-card step on one card (parallel/), after path P:
   (a) on a one-rank NCCL group (a file store under build/),
   ``make_full_pipeline_step`` over path S's 12 frames as the ring of
   edges k -> (k + 1) % 12 (src scan k + 1, tgt scan k) under path A's
   configuration, poses0 the ground truth + N(0, 0.1) with pose 0 exact:
   solutions and poses equal to ``register_scan_pair`` at B = 12 followed
   by ``optimize_pose_graph`` bit for bit, every labelling and
   ``estimate_ground`` call against its plain route, ATE after < 1 m, launches path
   A's per batched call plus 6 x 25 = 150 B2 (the pose graph's J^T), the
   collective profile 150 all-reduces; its wall over 3 calls, pairs/s and
   the pose graph's share; then ``sharded_register_batch`` (no collective)
   and ``make_loop_closing_step`` on an 8-pose ring of 1024
   correspondences a pair (tests/test_parallel.py's ring), each equal to
   the unsharded composition; (b) two gloo ranks sharing the card
   (``--path-m-rank``, spawned; NCCL refuses two ranks on one card), each
   on its ``local_batch_slice`` of the same ring: gloo's all_reduce on a
   CUDA tensor first, then the rows equal to (a)'s (masks, valid and
   counts exactly, poses within 1e-5 rad / 1e-4 m) and the all-reduced
   poses within 1e-4 of (a)'s, each rank's profile, two runs' bits.
   ``launches_path_m`` in every row of the kernel table.

After path M it prints the device loops' graphs captured per path (their
count and bytes: static buffers plus the reserved memory's growth during
each capture, summed over the path, ``utils/loops.CAPTURED``), the graphs
held at each path's end and their bytes (``utils/loops.held``), and the
same for path P's B = 64 alone.
The last two lines of standard output are the card's kernel table as one
JSON object and ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the quatro_tpu_torch package beside it, it fails before
printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
OPS_NN = 2 * 33 + 4       # 33 multiplies and 33 adds (unfused), the
                          # expansion, the top-2 compares
OPS_NN1 = 2 * 33 + 4      # 33 multiplies and 33 adds (unfused), the
                          # expansion (3), the compare
OPS_GRAPH = 21            # per pair: 2 x (3 sub, 3 mul, 2 add, sqrt),
                          # sub, abs, compare
OPS_PLANE = 6             # per point: projection (3 mul, 2 add), compare
OPS_MOMENTS_PT = 16       # per member point: 6 products, 10 additions
OPS_CLASSIFY = 8          # projection, compare, flag arithmetic
OPS_EXACT_WORD = 8        # per search step and 64-bit word: two popcounts,
                          # the non-zero test, the frames' and, or, and-not,
                          # the vertex mask
OPS_EXACT_STEP = 12       # per step: the two shuffle sums, the tests
OPS_KABSCH_POINT = 9 * 3  # per point: 9 entries of H, a product and a
                          # fused multiply-add each (the f32 product of src
                          # and w shared by three entries)
OPS_KABSCH_ROW = 2000     # per row: the 3 x 3 SVD's bidiagonalisation,
                          # sweeps and back transformation (approx.)
OPS_OVERLAP = 9           # per (valid source row, valid target point): 3
                          # sub, 3 mul, 2 add, the min
OPS_RANGE_POINT = 105     # per point: hypot 10, range 7, two fdlibm
                          # arctangents of ~32 each, row and column 12, the
                          # tests, pixel and key 12
OPS_EDGE = 38             # per (pixel, offset): max, min, a product, a
                          # multiply-add in f64, an arctangent, the test
OPS_COMPOSE = 3           # per (pixel, composed mask): two ands, an or
OPS_STATS = 12            # per pixel: the label test, row, three atomics,
                          # the gate's compares
OPS_CZM_POINT = 140       # per point: hypot 10, an fdlibm arctangent ~35,
                          # the wrap, the zone's compares, two quotients and
                          # truncations, the CZM tests, two differences, the
                          # z-bin (difference, quotient, floor, clamps), a
                          # product, the z range's compares
OPS_SEED_BIN = 14         # per (patch, bin): eligibility, two products, the
                          # prefix (6 adds) and a difference, the take's
                          # clamps, the share's product and quotient, the
                          # tree's add
OPS_PLANE_FIT = 170       # per patch: the covariance 15, the eigenpair ~110
                          # (acosf, cosf, rsqrtf ~20 each), the sanitising,
                          # sign, offset and gates ~30

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
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
                "TEASER FGR": dict(reg_name="TEASER",
                                   rotation_estimation_algorithm="FGR"),
                "TLS scale": dict(estimate_scaling=True),
                "exact": dict(inlier_selection_mode="exact")}
# the exact search's kernel against its plain version: a truncated search
# and a cap of four 64-bit words
EXACT_TRUNCATED = 40
EXACT_WIDE_CAP = 256

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
    # no pl.pallas_call: the lax.while_loop of exact_max_clique_bb
    "exact_clique": "quatro_tpu/solver/clique.py:382",
    # no pl.pallas_call: svd_rot3d's XLA dot and LAPACK SVD
    "kabsch": "quatro_tpu/solver/rotation.py:55",
    # no pl.pallas_call: label_components' lax.while_loop (its propagate
    # and sweep, XLA loop fusions) and alignment_overlap's block_hits
    "label_sweep": "quatro_tpu/preprocessing/projection.py:269",
    "overlap_hits": "quatro_tpu/solver/verify.py:63",
    # no pl.pallas_call: project_to_range_image's keys and owner image,
    # _neighbor_edges and the composed masks, label_components' stats
    # (XLA loop fusions around lax.sort)
    "range_image": "quatro_tpu/preprocessing/projection.py:72",
    "edge_masks": "quatro_tpu/preprocessing/projection.py:141",
    "component_stats": "quatro_tpu/preprocessing/projection.py:279",
    # no pl.pallas_call: estimate_ground's czm_bin, _patch_center_of_point,
    # channels and z-bins (:119-186, 232-295), its seed stage (:296-319),
    # its plane algebra and gates (:328-387), XLA loop fusions around the
    # Pallas kernels
    "czm_points": "quatro_tpu/preprocessing/patchwork.py:119",
    "seed_heights": "quatro_tpu/preprocessing/patchwork.py:296",
    "plane_fit": "quatro_tpu/preprocessing/patchwork.py:328",
    # no pl.pallas_call: the clique stage's lax.while_loops (the k-core
    # search's peel and binary search, the growth's two phases, the swap
    # under vmap) and top_distinct_cliques' lax.fori_loop
    "kcore_search": "quatro_tpu/solver/clique.py:65",
    "grow_cliques": "quatro_tpu/solver/clique.py:104",
    "swap_cliques": "quatro_tpu/solver/clique.py:197",
    "distinct_cliques": "quatro_tpu/solver/clique.py:401",
    # no pl.pallas_call: radius_neighbors' lax.map of Gram blocks and
    # lax.top_k, estimate_normals' XLA fusions, refine_icp's correspond and
    # step inside its lax.scan
    "radius_knn": "quatro_tpu/ops/neighbors.py:48",
    "neighbor_normals": "quatro_tpu/ops/normals.py:94",
    "icp_correspond": "quatro_tpu/solver/icp.py:108",
    "icp_update": "quatro_tpu/solver/icp.py:119",
    # no pl.pallas_call: match_features' candidate assembly (XLA fusions
    # before its lax.sort), tuple_test_keep's lax.scan over the trials and
    # the compaction's sort
    "match_candidates": "quatro_tpu/ops/matching.py:230",
    "tuple_compact": "quatro_tpu/ops/matching.py:165",
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
    "exact_clique": "quatro_tpu_torch/csrc/exact_clique.cu",
    "kabsch": "quatro_tpu_torch/csrc/kabsch.cu",
    "label_sweep": "quatro_tpu_torch/csrc/label_sweep.cu",
    "overlap_hits": "quatro_tpu_torch/csrc/overlap_hits.cu",
    "range_image": "quatro_tpu_torch/csrc/range_image.cu",
    "edge_masks": "quatro_tpu_torch/csrc/edge_masks.cu",
    "component_stats": "quatro_tpu_torch/csrc/component_stats.cu",
    "czm_points": "quatro_tpu_torch/csrc/czm_points.cu",
    "seed_heights": "quatro_tpu_torch/csrc/plane_fit.cu",
    "plane_fit": "quatro_tpu_torch/csrc/plane_fit.cu",
    **dict.fromkeys(("kcore_search", "grow_cliques", "swap_cliques",
                     "distinct_cliques"), "quatro_tpu_torch/csrc/cliques.cu"),
    "radius_knn": "quatro_tpu_torch/csrc/knn.cu",
    "neighbor_normals": "quatro_tpu_torch/csrc/neighbor_normals.cu",
    **dict.fromkeys(("icp_correspond", "icp_update"),
                    "quatro_tpu_torch/csrc/icp.cu"),
    "match_candidates": "quatro_tpu_torch/csrc/match_candidates.cu",
    "tuple_compact": "quatro_tpu_torch/csrc/tuple_test.cu",
}
# label_sweep: one launch a label_components call (the whole labelling);
# range_image, edge_masks, component_stats: one wrapper call a
# segment_cloud call; czm_points, seed_heights: one wrapper call an
# estimate_ground call, plane_fit one a plane fit (num_iter); the clique
# stage: one k-core search, growth and swap a solve, the distinct greedy
# once for the K clique hypotheses and once for the vote's; ICP's lists
# and normals once (the target's raw-scan voxels), its correspondences once
# a pass and once at the returned pose, its update once a pass; the
# matcher's candidates and tuple test once a matcher call
ICP_PASSES = 12           # IcpConfig.iterations
MAIN_LAUNCHES = {"moment_sums": 1, "spfh": 1, "fpfh": 1,
                 "nearest_neighbors": 0, "nearest_neighbors2": 2,
                 "consistency_graph": 1, "segment_sums": 1,
                 "cross_histogram": 1, "fit_iteration_moments": 3,
                 "classify_points": 1, "image_lookup": 1, "table_lookup": 0,
                 "exact_clique": 0, "kabsch": 0,
                 "label_sweep": 1, "overlap_hits": 1, "range_image": 1,
                 "edge_masks": 1, "component_stats": 1, "czm_points": 1,
                 "seed_heights": 1, "plane_fit": 3, "kcore_search": 1,
                 "grow_cliques": 1, "swap_cliques": 1, "distinct_cliques": 2,
                 "radius_knn": 1, "neighbor_normals": 1,
                 "icp_correspond": ICP_PASSES + 1, "icp_update": ICP_PASSES,
                 "match_candidates": 1, "tuple_compact": 1}
PROJECTION_KERNELS = ("range_image", "edge_masks", "component_stats")
PATCHWORK_KERNELS = ("czm_points", "seed_heights", "plane_fit")
CLIQUE_KERNELS = ("kcore_search", "grow_cliques", "swap_cliques",
                  "distinct_cliques")
ICP_KERNELS = ("radius_knn", "neighbor_normals", "icp_correspond",
               "icp_update")
MATCH_KERNELS = ("match_candidates", "tuple_compact")
# the wrappers' names in the modules that call them (recorded there)
ICP_CALLERS = {"radius_knn": ("pipeline", "radius_neighbors"),
               "neighbor_normals": ("pipeline", "estimate_normals"),
               "icp_correspond": ("solver.icp", "icp_correspond"),
               "icp_update": ("solver.icp", "icp_update")}
OPS_KNN_PAIR = 10         # per (row, column): the dot's product and two
# fused terms (2 each), the norms' sum, 2 a.b, the difference, the clamp
OPS_NORMAL_SLOT = 30      # per list slot: 4 weighted products, 3
# differences, 12 moment products, 10 tree additions
OPS_NORMAL_POINT = 150    # per point: 10 quotients, the eigenpair ~110, the
# curvature, flip and masks
OPS_CORR_PAIR = 10        # per (source row, target): as OPS_KNN_PAIR
OPS_CORR_ROW = 40         # per source row: the pose, gate, residual, Huber
# weight and cross product
OPS_UPDATE_ROW = 42 * 3   # per row: 42 products (2 for h's), 42 additions
OPS_UPDATE_PAIR = 1500    # per pair: the 6 x 7 Gauss-Jordan, exp_so3 and the
# update (a one-thread chain)
OPS_TRIPLE = 22           # per live triple of the tuple test: its first
# side's two lengths (3 sub, 3 mul, 2 add, a root each), two products and
# two compares, which every triple needs before its gate can fail
MATCH_STARVED = 40        # valid target keypoints of the starving pair
# the clique kernels also held against their plain versions on
# tests/torch_clique_cases.py's graphs (edge cases) and at N = 2048, whose
# packed rows exceed a block's shared memory (read through L2)
CLIQUE_EDGE_CASES = ("n1", "n33", "n100", "mask_off", "edgeless", "complete",
                     "loops", "asym", "junk_batch", "miss_one", "wide_2048")
# Patchwork's kernels also held against their plain versions off the
# default configuration: the far patches' global elevation gate and one
# exact fit (no fori trip)
PATCHWORK_VARIANT = dict(using_global_elevation=True, num_iter=1)
# PipelineConfig.recommended() without ICP (the earlier raw path, path E)
RECOMMENDED_LAUNCHES = dict(MAIN_LAUNCHES, **dict.fromkeys(ICP_KERNELS, 0))
PATH_B_LAUNCHES = dict(RECOMMENDED_LAUNCHES, nearest_neighbors=2,
                       nearest_neighbors2=0, segment_sums=0, overlap_hits=0,
                       distinct_cliques=0)
FEATURES_LAUNCHES = dict(RECOMMENDED_LAUNCHES, cross_histogram=0,
                         fit_iteration_moments=0, classify_points=0,
                         image_lookup=0, label_sweep=0,
                         **dict.fromkeys(PROJECTION_KERNELS, 0),
                         **dict.fromkeys(PATCHWORK_KERNELS, 0))
SINGLE_LAUNCHES = dict(FEATURES_LAUNCHES, segment_sums=0, overlap_hits=0,
                       distinct_cliques=0)
# the labelling kernel against its plain route on images of other presets
# (ray-cast pairs, all three neighbour modes, and a cap of LABEL_CAP
# rounds that stops images before their exits)
LABEL_PRESETS = ("VLP-16", "Ouster-OS1-64")
NEIGHBOR_MODES = ("4CrossNeighbor", "4Neighbor", "8Neighbor")
LABEL_CAP = 2
# path S: make_synthetic_sequence's arguments, run_sequence's edge batch
# and pose-graph trip counts, and the windowed runner's window
SEQUENCE = dict(num_poses=12, seed=1, radius=6.0)
SEQ_BATCH = 16
PG_ITERS = (10, 40)
SEQ_WINDOW = 4
# path P: bench.py's pairs (bench.py:131-136) and batches, the runs timed
# per batch, path A's batch, and the ground-truth band (path B's)
BENCH_PAIRS = 8
PAIR_AXIS_BATCHES = (1, 8, 64)
PAIR_AXIS_REPEATS = 3
P_PATH_A_BATCH = 4
P_BAND = (0.05, 0.6)
# path E: eval.py's success-rate run (EVAL_r05.json's tpu_n300_shipping
# configuration and seeds) at E_PAIRS pairs, its gates, the outlier sweep
# at the JAX defaults, and the CLI's synthetic pair
E_PAIRS = 16
E_BATCH = 8
E_CONFIG = dict(max_voxels=8192)  # PipelineConfig.recommended's overrides
E_MIN_SUCCESS = 15
E_ROW_TOL = (1e-3, 1e-4)          # batched rows against batch=1 (deg, m)
E_RAYCAST_LIMIT_S = 120.0
E_SWEEP_GATES = (0.5, 0.9)        # rates held to 5/6, tests/test_eval.py:70-77
E_CLI_SEED = 11
E_CLI_LIDAR = "Velodyne-64-HDE"
E_CLI_WIDTH = ("--max-raw-points", str(RAW_CAPACITY), "--max-voxels", "8192")
E_CLI_ARTIFACTS = ("source.ply", "target.ply", "aligned.ply",
                   "correspondences.ply", "max_clique_source.ply",
                   "max_clique_target.ply", "final_inliers.ply",
                   "ground_source.ply", "revert_pc.ply", "reject_pc.ply")
# path M: the steps' pose-graph trip counts (their defaults), the initial
# poses' noise and seed (tests/test_parallel.py:137-138), the timed calls,
# the loop-closing step's ring (pairs, inliers, outliers), the ranks that
# share the card over gloo, their bands against one rank and their limit
M_ITERS = (6, 24)
M_NOISE = 0.1
M_SEED = 7
M_REPEATS = 3
M_PAIRS = 8
M_CORR = (256, 768)
M_RANKS = 2
M_POSE_TOL = 1e-4                 # all-reduced poses, two ranks vs one
M_ROW_TOL = (1e-5, 1e-4)          # a rank's rows vs the one-rank call
M_RANK_LIMIT_S = 300


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# each label_sweeps call's per-image rounds (device tensors, read when a
# run's counts are read), recorded by ``record_label_rounds``
LABEL_ROUNDS = []


def record_label_rounds():
    """Wrap ``projection.label_sweeps`` for the whole run so that each
    call's rounds (B,) are kept (no host read on the path)."""
    from quatro_tpu_torch.preprocessing import projection

    real = projection.label_sweeps

    def rec(*args, **kwargs):
        out = real(*args, **kwargs)
        LABEL_ROUNDS.append(out[1])
        return out

    projection.label_sweeps = rec


def label_rounds():
    """A mark: the labelling calls recorded so far."""
    return len(LABEL_ROUNDS)


def launch_counts(rounds0=None):
    """``LAUNCHES`` as they stand; with a mark ``rounds0``, also
    "label_rounds": the most rounds an image ran in the labelling calls
    since the mark (the data decide them; 0 where none ran)."""
    from quatro_tpu_torch.ops import launch
    out = dict(launch.LAUNCHES)
    if rounds0 is not None:
        out["label_rounds"] = max((int(r.max()) for r in
                                   LABEL_ROUNDS[rounds0:] if r.numel()),
                                  default=0)
    return out


def launches_match(got, expected):
    """A run's counts (``launch_counts``) equal ``expected`` kernel by
    kernel."""
    return all(got[k] == v for k, v in expected.items())


def same_launches(a, b):
    """Two runs' kernel counts equal (the rounds may differ)."""
    return ({k: v for k, v in a.items() if k != "label_rounds"}
            == {k: v for k, v in b.items() if k != "label_rounds"})


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


_PAD = {}                 # the marker fill's tensor and profiler name


def _pad_tensor():
    if "t" not in _PAD:
        _PAD["t"] = torch.empty(1, dtype=torch.int16, device="cuda")
    return _PAD["t"]


def pad_key():
    """The profiler's name of the marker launch (a one-element int16
    fill, which no path launches), learnt once from a profiled run of 64
    of them: the device events around and between measured calls."""
    from torch.profiler import ProfilerActivity, profile

    if "key" not in _PAD:
        t = _pad_tensor()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                t.fill_(7)
            torch.cuda.synchronize()
        seen = [(e.count, e.key) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation]
        check(seen, "profile: the marker fills left no device event")
        _PAD["key"] = max(seen)[1]
    return _PAD["key"]


def pad_launches(t=None, n=64):
    """n fills of ``t`` (the marker's tensor by default): the profiler
    drops a few device events at the ends of a profiled run (2-4 of 10
    calls' on the H100 with torch 2.11), so the measured calls sit
    between two runs of these."""
    t = _pad_tensor() if t is None else t
    for _ in range(n):
        t.fill_(7)


def graph_ms(fn, reps=20, replays=5):
    """Device ms per call of ``fn`` inside a CUDA graph: ``reps`` calls
    captured in one graph, replayed ``replays`` times between CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / (reps * replays)


def stage_device_busy(run, tries=3, by_kernel=None):
    """Device busy ms per stage of one call ``run(timer)``: under
    torch.profiler a marker fill is launched at the start and at each
    stage end (``timer``); on the one stream the device events between
    two markers are that stage's work (graph replays included). Returns
    {stage: busy ms}, or None when no profiled run of ``tries`` saw every
    marker. A dict ``by_kernel`` gets {stage: {event name: [launches,
    ms]}} of the same run."""
    from torch.profiler import ProfilerActivity, profile

    key = pad_key()
    t = _pad_tensor()
    other = torch.empty(1, dtype=torch.int32, device="cuda")
    names = []

    def timer(name):
        t.fill_(7)
        names.append(name)

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(tries):
        names.clear()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_launches(other)
            torch.cuda.synchronize()
            t.fill_(7)
            run(timer)
            torch.cuda.synchronize()
            pad_launches(other)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == cuda
                      and not e.is_user_annotation),
                     key=lambda e: e.time_range.start)
        marks = [k for k, e in enumerate(evs) if e.name == key]
        if len(marks) == len(names) + 1:
            busy = {}
            for name, a, b in zip(names, marks, marks[1:]):
                busy[name] = round(busy.get(name, 0.0) + sum(
                    e.time_range.elapsed_us() for e in evs[a + 1:b])
                    / 1e3, 3)
                if by_kernel is not None:
                    split = by_kernel.setdefault(name, {})
                    for e in evs[a + 1:b]:
                        c = split.setdefault(e.name, [0, 0.0])
                        c[0] += 1
                        c[1] += e.time_range.elapsed_us() / 1e3
            return busy
        log(f"profile: stage markers seen {len(marks)} of "
            f"{len(names) + 1}; profiling again")
    return None


def short_kernel_name(name, width=150):
    """A profiler kernel name without its namespaces' boilerplate, cut to
    ``width`` characters: the functor that tells torch's elementwise
    kernels apart stays in view."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at_cuda_detail::cub::", "std::array<char*, "):
        name = name.replace(noise, "")
    return name[:width]


def log_stage_kernels(label, by_kernel, stages=None, top=16):
    """The device time of ``stages`` (default: every stage) by kernel
    (``stage_device_busy``'s ``by_kernel``), the largest first
    (``short_kernel_name``), with each stage's device launches."""
    for stage in (by_kernel if stages is None else stages):
        split = by_kernel.get(stage, {})
        total = sum(ms for _, ms in split.values())
        rows = sorted(split.items(), key=lambda kv: -kv[1][1])[:top]
        log(f"{label}: {stage} device {total:.3f} ms in "
            f"{sum(n for n, _ in split.values())} launches by kernel "
            f"({len(split)} names; launches, ms, share): " + json.dumps(
                [[short_kernel_name(name), n, round(ms, 4),
                  round(ms / total, 4) if total else None]
                 for name, (n, ms) in rows]))


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


def tilted(src_xyz, tgt_xyz, gt):
    """A pair tilted as tests/test_ground.py:142-151 tilts it: (source,
    target, ground truth composed as there)."""
    from quatro_tpu_torch.utils.se3 import rotation_from_rpy

    a = rotation_from_rpy(*TILT_SRC).numpy()
    b = rotation_from_rpy(*TILT_TGT).numpy()
    gt_tilt = np.eye(4)
    gt_tilt[:3, :3] = b @ gt[:3, :3] @ a.T          # tgt2 = B R A^T src2 + B t
    gt_tilt[:3, 3] = b @ gt[:3, 3]
    return src_xyz @ a.T, tgt_xyz @ b.T, gt_tilt


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

    src_xyz, tgt_xyz, gt = make_scan_pair(**PIPELINE_PAIR)
    src_tilt, tgt_tilt, gt_tilt = tilted(src_xyz, tgt_xyz, gt)
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
        "tilted": (PointBatch.from_numpy(src_tilt, RAW_CAPACITY),
                   PointBatch.from_numpy(tgt_tilt, RAW_CAPACITY)),
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
    rounds0 = label_rounds()
    timer = StageTimer()
    t0 = time.perf_counter()
    res = entry(*pair, cfg, timer=timer)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(rounds0)
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
    check(launches_match(launches, expected),
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


def _clone_tree(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(_clone_tree(v) for v in x)
    return x


def record_loops(fn):
    """fn() with every device loop it runs recorded (utils/loops.py):
    (fn's result, [(kind, args, kwargs)]), the loops' tensors cloned."""
    from quatro_tpu_torch.utils import loops
    calls, real = [], {k: getattr(loops, k) for k in ("while_chunks", "fori")}

    def recorder(kind):
        def rec(*args, **kwargs):
            calls.append((kind, _clone_tree(args), kwargs))
            return real[kind](*args, **kwargs)
        return rec

    for kind in real:
        setattr(loops, kind, recorder(kind))
    try:
        out = fn()
    finally:
        for kind, f in real.items():
            setattr(loops, kind, f)
    return out, calls


def _loop_state(kind, out):
    """The state a loop returned (while_chunks also returns its trips,
    which count the rounds a chunk runs past the exit)."""
    return list(out[0] if kind == "while_chunks" else out)


def phase_loops(card, label, fn):
    """The device loops of one call of ``fn`` on the pipeline's own
    tensors: each recorded loop run again through the CUDA-graph route
    (twice: the second replays only) and through ``eager_loops()``, at its
    own chunk and at chunk 1 (one flag read per round, as the loops ran
    before the graphs), all four bit for bit. Prints per loop its calls,
    and per call its rounds, flag reads, captures and replays on the
    graph route and at chunk 1, with both routes' ms (host wall ending in
    a synchronise). Returns fn's result."""
    from quatro_tpu_torch.utils import loops
    out, calls = record_loops(fn)
    check(calls, f"{label}: no device loop ran")
    table = {}
    for kind, args, kwargs in calls:
        name = args[0]

        def run(kind=kind, args=args, kwargs=kwargs):
            return getattr(loops, kind)(*args, **kwargs)

        routes = {}
        for route, mode in (("chunk_1", loops.eager_loops(chunk=1)),
                            ("eager", loops.eager_loops()),
                            ("graph", contextlib.nullcontext()),
                            ("graph_again", contextlib.nullcontext())):
            loops.reset_loops()
            with mode:
                got, ms = _synced_ms(run)
            routes[route] = (_loop_state(kind, got), ms,
                             dict(loops.LOOPS.get(name, {})))
        ref = routes["eager"][0]
        for route, (got, _, _) in routes.items():
            check(len(got) == len(ref) and all(
                torch.equal(a, b) for a, b in zip(got, ref)),
                f"{label}: loop {name} on the {route} route differs from "
                "eager_loops()")
        # a fori reads no flag; a while_chunks loop reads one per chunk,
        # and one more for the exit, of the rounds it runs at chunk 1
        reads = routes["graph_again"][2].get("reads", 0)
        chunk = args[5] if kind == "fori" else args[6]
        limit = (0 if kind == "fori" else
                 -(-routes["chunk_1"][2].get("rounds", 0) // chunk) + 1)
        check(reads <= limit, f"{label}: loop {name} read {reads} flags "
              f"(at most {limit})")
        row = table.setdefault(name, {"calls": 0, "graph": {},
                                      "chunk_1": {}, "graph_ms": 0.0,
                                      "chunk_1_ms": 0.0})
        row["calls"] += 1
        for route, key in (("graph_again", "graph"), ("chunk_1", "chunk_1")):
            for k, v in routes[route][2].items():
                row[key][k] = row[key].get(k, 0) + v
        row["graph_ms"] += routes["graph_again"][1]
        row["chunk_1_ms"] += routes["chunk_1"][1]
    for row in table.values():
        row["graph_ms"] = round(row["graph_ms"], 3)
        row["chunk_1_ms"] = round(row["chunk_1_ms"], 3)
    log(f"{label} device loops ({card}; graph route equal to "
        "eager_loops() bit for bit): " + json.dumps(table))
    return out


def _host_exact_clique(sub, vvalid, best0, max_steps):
    """``ops.kernels.exact_clique`` on the host: the restriction copied
    there, ``host_dfs`` (tests/torch_clique_oracle.py, the tests' oracle)
    one pair after another, the results copied back."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_clique_oracle import host_dfs

    host = [t.cpu().numpy() for t in (sub, vvalid, best0)]
    outs = [host_dfs(*(h[b] for h in host), max_steps)
            for b in range(host[0].shape[0])]
    dev = sub.device
    return (torch.from_numpy(np.stack([o[0] for o in outs])).to(dev),
            torch.tensor([o[1] for o in outs]).to(dev),
            torch.tensor([o[2] for o in outs], dtype=torch.int32).to(dev))


@contextlib.contextmanager
def host_route(which):
    """A solver stage through the host, for timing beside the card's
    route: "exact", the host search (``_host_exact_clique``); "so3", the
    SO(3) GNC as it ran before the Kabsch kernel: ``torch.linalg.svd`` and
    ``det`` of a matrix product per GNC iteration, its chunks uncaptured
    (the SVD checks its result on the host)."""
    from quatro_tpu_torch.ops import kernels
    from quatro_tpu_torch.solver import rotation
    from quatro_tpu_torch.utils import loops
    from quatro_tpu_torch.utils.se3 import rotate_points

    def svd_rot3d(src, dst, weights):
        h = (src * weights[..., None]).transpose(-1, -2) @ dst
        u, _, vt = torch.linalg.svd(h)
        v = vt.transpose(-1, -2)
        det = torch.linalg.det(u) * torch.linalg.det(v)
        v = torch.cat([v[..., :2], v[..., 2:] * torch.where(
            det < 0, -1.0, 1.0)[..., None, None]], -1)
        return rotate_points(v, u)

    def run_uncaptured(name, round_fn, src, dst, maskf, scale_sq, state,
                       bound):
        state, _ = loops.while_chunks(
            name, round_fn, rotation._any_live, (src, dst, maskf, scale_sq),
            state, bound, rotation.GNC_CHUNK, graph=False)
        return state

    saved = (kernels.exact_clique, rotation._SO3, rotation._run_iterations)
    if which == "exact":
        kernels.exact_clique = _host_exact_clique
    else:
        rotation._SO3 = (svd_rot3d, rotation._SO3[1])
        rotation._run_iterations = run_uncaptured
    try:
        yield
    finally:
        kernels.exact_clique, rotation._SO3, rotation._run_iterations = saved


def _differing_fields(got, ref):
    from dataclasses import fields
    return [f.name for f in fields(got)
            if not torch.equal(getattr(got, f.name), getattr(ref, f.name))]


def exact_routes(adj, mask, inc, cap, max_steps, label):
    """``exact_max_clique_bb`` on the card through the kernel and through
    its plain version (``exact_clique_search_plain`` on the card, a device
    loop): mask, completed, restricted and steps bit-equal, the kernel's
    route one launch. Returns the kernel route's steps."""
    from quatro_tpu_torch.ops import kernels, launch
    from quatro_tpu_torch.solver import clique

    launch.reset_launches()
    got = clique.exact_max_clique_bb(adj, mask, incumbent=inc, cap=cap,
                                     max_steps=max_steps)
    torch.cuda.synchronize()
    check(launch.LAUNCHES["exact_clique"] == 1,
          f"exact search ({label}): {launch.LAUNCHES['exact_clique']} "
          "launches, not one")
    real = kernels.exact_clique
    kernels.exact_clique = kernels.exact_clique_search_plain
    try:
        ref = clique.exact_max_clique_bb(adj, mask, incumbent=inc, cap=cap,
                                         max_steps=max_steps)
    finally:
        kernels.exact_clique = real
    for what, g, r in zip(("mask", "completed", "restricted", "steps"),
                          got, ref):
        check(torch.equal(g, r), f"exact search ({label}): the kernel's "
              f"{what} differs from its plain version's")
    steps = got[3].reshape(-1).tolist()
    log(f"exact search ({label}, cap {cap}, max_steps {max_steps}): the "
        f"kernel equal to its plain version on the card (mask, completed, "
        f"restricted, steps); steps {steps}, completed "
        f"{got[1].reshape(-1).tolist()}, restricted "
        f"{got[2].reshape(-1).tolist()}")
    return steps


SO3_MODES = {"TEASER": "gnc_tls", "TEASER FGR": "fgr_gm"}


def phase_solver_modes(res, cfg, card, corr8):
    """``register_correspondences`` on path B's correspondences under each
    solver mode off the shipping path: each valid and within 0.01 rad /
    0.1 m of path B's own pose (the JAX package: within 0.0012 rad / 0.007
    m on the CPU), the TLS scale within 0.02 of 1, the exact search one
    kernel launch and every other mode none. Logs each mode's time (host
    wall, after a warm-up), GNC iterations and device loops; for "exact"
    the search's completion, restriction and steps and the host search's
    time in this run; for TEASER and the 3-D FGR their GNC loop
    captured and replayed, bit-equal to ``eager_loops()`` with equal
    launches, and the uncaptured torch.linalg.svd route's time. The exact
    kernel against its plain version (``exact_routes``) at B = 1,
    truncated and at cap 256. Then every mode at B = 8 on ``corr8`` (path
    P's bench pairs' correspondences) in one call, each row bit-equal to
    its per-pair call, and the exact search there at B = 8. Returns the
    exact kernel's path B arguments and launches for the kernel table."""
    import dataclasses

    from quatro_tpu_torch.ops import kabsch, kernels, launch
    from quatro_tpu_torch.solver import clique
    from quatro_tpu_torch.solver.quatro import register_correspondences
    from quatro_tpu_torch.solver.scale import tim_consistency_graph
    from quatro_tpu_torch.utils import loops

    corr = res.correspondences
    ref = res.solution.transform().cpu().numpy().astype(np.float64)
    out = {}
    exact = {}
    for name, kw in SOLVER_MODES.items():
        sc = dataclasses.replace(cfg.solver, **kw)
        args = (corr.src_xyz, corr.tgt_xyz, corr.mask, sc)
        loops.reset_loops()
        register_correspondences(*args)                  # warm-up
        torch.cuda.synchronize()
        launch.reset_launches()
        calls, kcalls = [], []
        with recorded(kernels, "exact_clique", calls), \
                recorded(kabsch, "kabsch_rotation", kcalls):
            sol, ms = _synced_ms(lambda: register_correspondences(*args))
        launches = dict(launch.LAUNCHES)
        counters = {k: dict(v) for k, v in loops.LOOPS.items()}
        rerr, terr = pose_errors(sol, ref)
        info = {"ms": round(ms, 3), "valid": bool(sol.valid),
                "gnc_iterations": int(sol.gnc_iterations),
                "scale": float(sol.scale),
                "clique": int(sol.max_clique_mask.sum()),
                "rotation_vs_path_b_rad": rerr,
                "translation_vs_path_b_m": terr,
                "exact_clique_launches": launches["exact_clique"],
                "kabsch_launches": launches["kabsch"]}
        check(launches["exact_clique"] == (name == "exact"),
              f"solver mode {name}: {launches['exact_clique']} exact "
              "search launches")
        check((launches["kabsch"] > 0) == (name in SO3_MODES),
              f"solver mode {name}: {launches['kabsch']} Kabsch launches")
        if name in SO3_MODES:
            gnc = counters.get(SO3_MODES[name], {})
            check(gnc.get("captures", 0) >= 1 and gnc.get("replays", 0) >= 1,
                  f"solver mode {name}: its GNC loop did not capture and "
                  f"replay: {gnc}")
            launch.reset_launches()
            with loops.eager_loops():
                eager = register_correspondences(*args)
            torch.cuda.synchronize()
            same_solution(sol, eager, f"solver mode {name}: the graph route "
                          "against eager_loops()")
            check(dict(launch.LAUNCHES) == launches,
                  f"solver mode {name}: eager_loops() launched "
                  f"{dict(launch.LAUNCHES)}, the graph route {launches}")
            with host_route("so3"):
                register_correspondences(*args)
                _, host_ms = _synced_ms(
                    lambda: register_correspondences(*args))
            info.update(gnc_loop=gnc, uncaptured_svd_ms=round(host_ms, 3))
            if name == "TEASER":
                exact.update(kabsch_args=kcalls[0][0],
                             kabsch_launches_b=launches["kabsch"])
        if name == "exact":
            adj = tim_consistency_graph(corr.src_xyz, corr.tgt_xyz, corr.mask,
                                        sc.noise_bound, sc.cbar2)
            scores, packed = clique.clique_seed_scores_and_bits(
                adj, corr.mask)
            greedy = clique.greedy_cliques(
                adj, scores, corr.mask, num_seeds=sc.clique_num_seeds,
                max_size=sc.max_clique_size,
                swap_rounds=sc.clique_swap_rounds, packed=packed) & corr.mask
            _, completed, restricted, steps = clique.exact_max_clique_bb(
                adj, corr.mask, incumbent=greedy, cap=sc.exact_clique_cap,
                max_steps=sc.exact_clique_max_steps, seed_scores=scores)
            with host_route("exact"):
                register_correspondences(*args)
                host, host_ms = _synced_ms(
                    lambda: register_correspondences(*args))
            same_solution(sol, host, "solver mode exact against the host "
                          "search")
            info.update(completed=bool(completed),
                        restricted=bool(restricted), steps=int(steps),
                        greedy=int(greedy.sum()),
                        host_search_ms=round(host_ms, 3))
            exact_routes(adj, corr.mask, greedy, sc.exact_clique_cap,
                         sc.exact_clique_max_steps, "path B, B = 1")
            exact_routes(adj, corr.mask, greedy, sc.exact_clique_cap,
                         EXACT_TRUNCATED, "path B, truncated")
            exact_routes(adj, corr.mask, greedy, EXACT_WIDE_CAP,
                         sc.exact_clique_max_steps, "path B, multi-word")
            exact.update(args=calls[0][0], launches_b=launches[
                "exact_clique"], steps=int(steps))
        log(f"solver mode {name} ({card}): {json.dumps(info)}")
        check(bool(sol.valid), f"solver mode {name}: not valid")
        check(rerr < 0.01 and terr < 0.1,
              f"solver mode {name}: {rerr} rad / {terr} m from path B")
        check(bool(torch.isfinite(sol.transform()).all()),
              f"solver mode {name}: non-finite pose")
        if name == "TLS scale":
            check(abs(float(sol.scale) - 1.0) < 0.02,
                  f"TLS scale {float(sol.scale)}")
        out[name] = info
    loops.reset_loops()
    exact["b8"], exact["kabsch_b8"] = solver_modes_batched(corr8, cfg, card)
    return exact


def solver_modes_batched(corr8, cfg, card):
    """Every solver mode on B pairs' correspondences (B, N, 3) in one
    ``register_correspondences`` call: each row bit-equal to the per-pair
    call on its pair, the exact search one launch for the B pairs and
    its kernel equal to its plain version there. Returns the exact
    call's and TEASER's call's launches."""
    import dataclasses

    from quatro_tpu_torch.ops import launch
    from quatro_tpu_torch.solver import clique
    from quatro_tpu_torch.solver.quatro import register_correspondences
    from quatro_tpu_torch.solver.scale import tim_consistency_graph

    bsz = corr8.src_xyz.shape[0]
    table = {}
    for name, kw in SOLVER_MODES.items():
        sc = dataclasses.replace(cfg.solver, **kw)
        args = (corr8.src_xyz, corr8.tgt_xyz, corr8.mask, sc)
        register_correspondences(*args)                  # warm-up
        launch.reset_launches()
        batch, ms = _synced_ms(lambda: register_correspondences(*args))
        launches = dict(launch.LAUNCHES)
        check(launches["exact_clique"] == (name == "exact"),
              f"solver mode {name} at B = {bsz}: "
              f"{launches['exact_clique']} exact search launches")
        check((launches["kabsch"] > 0) == (name in SO3_MODES),
              f"solver mode {name} at B = {bsz}: {launches['kabsch']} "
              "Kabsch launches")
        singles_ms = 0.0
        for b in range(bsz):
            one, one_ms = _synced_ms(lambda: register_correspondences(
                corr8.src_xyz[b], corr8.tgt_xyz[b], corr8.mask[b], sc))
            singles_ms += one_ms
            same_solution(batch.row(b), one, f"solver mode {name} at B = "
                          f"{bsz}: row {b} against its per-pair call")
        table[name] = {"ms": round(ms, 3), "per_pair_calls_ms": round(
            singles_ms, 3), "valid": batch.valid.tolist(),
            "gnc_iterations": batch.gnc_iterations.tolist(),
            "launches": {k: v for k, v in launches.items() if v}}
        if name == "exact":
            adj = tim_consistency_graph(*args[:3], sc.noise_bound, sc.cbar2)
            scores, packed = clique.clique_seed_scores_and_bits(
                adj, corr8.mask)
            greedy = clique.greedy_cliques(
                adj, scores, corr8.mask, num_seeds=sc.clique_num_seeds,
                max_size=sc.max_clique_size,
                swap_rounds=sc.clique_swap_rounds, packed=packed) & corr8.mask
            table[name]["steps"] = exact_routes(
                adj, corr8.mask, greedy, sc.exact_clique_cap,
                sc.exact_clique_max_steps, f"path P's pairs, B = {bsz}")
            exact_b8 = launches["exact_clique"]
        if name == "TEASER":
            kabsch_b8 = launches["kabsch"]
    log(f"solver modes at B = {bsz} (path P's bench.py pairs, {card}; every "
        f"row bit-equal to its per-pair call): {json.dumps(table)}")
    return exact_b8, kabsch_b8


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
    eight wrappers wrapped to record their arguments (the labelling's
    ``label_sweeps``, the range image's three), and segment_cloud's and
    label_components' arguments. Logs the ground, non-ground and segment points per
    cloud."""
    from quatro_tpu_torch.device import resolve_device
    from quatro_tpu_torch.preprocessing import patchwork, projection
    from quatro_tpu_torch.utils import loops

    calls = {}
    wrapped = [(patchwork, "cross_histogram"),
               (patchwork, "fit_iteration_moments"),
               (patchwork, "classify_points"), (projection, "image_lookup"),
               (projection, "label_sweeps"), (projection, "label_components"),
               *((projection, k) for k in PROJECTION_KERNELS)]
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
        # pipeline.preprocess, with the Patchwork result kept; uncaptured,
        # so that the plane fits' loop calls B9's wrapper on every trip (a
        # replay calls no Python)
        with loops.eager_loops():
            pw = patchwork.estimate_ground(pts, msk, cfg.patchwork)
            seg_args = ((pts, pw.nonground, cfg.lidar, cfg.projection),
                        {"max_points": cfg.max_nonground_points})
            seg = projection.segment_cloud(*seg_args[0],
                                           **seg_args[1]).valid_segments
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
    calls["segment_cloud"] = [seg_args]
    calls["estimate_ground"] = [((pts, msk, cfg.patchwork), {})]
    return calls


def capture_overlap(pair, cfg):
    """The arguments the main path hands the overlap kernel's wrapper: one
    more run of the pair with ``verify.overlap_hits`` recording them."""
    from quatro_tpu_torch.pipeline import register_scan_pair
    from quatro_tpu_torch.solver import verify

    with recorded(verify, "overlap_hits", []) as calls:
        register_scan_pair(*pair, cfg)
    torch.cuda.synchronize()
    check(len(calls) == 1, f"path A: {len(calls)} overlap calls, not one")
    return calls[0][0]


def sequence_launches(frames, calls):
    """Path S's expected launch counts: per frame the preprocessing and
    front-end kernels (the labelling once), per batched
    registration call (one per edge batch) the matcher's top-2 NN twice,
    the graph, the clique stage's kernels, the vote's segment sums, the
    overlaps, ICP's passes (ICP's lists and normals once a frame) and the
    matcher's two kernels, and per pose-graph solve one segment sum per J^T apply (gn x (cg + 1))."""
    gn, cg = PG_ITERS
    return dict(MAIN_LAUNCHES, moment_sums=frames, spfh=frames, fpfh=frames,
                nearest_neighbors2=2 * calls,
                consistency_graph=calls,
                segment_sums=calls + gn * (cg + 1),
                cross_histogram=frames, fit_iteration_moments=3 * frames,
                classify_points=frames, image_lookup=frames,
                label_sweep=frames, overlap_hits=calls,
                **dict.fromkeys(PROJECTION_KERNELS, frames),
                czm_points=frames, seed_heights=frames, plane_fit=3 * frames,
                kcore_search=calls, grow_cliques=calls, swap_cliques=calls,
                distinct_cliques=2 * calls, radius_knn=frames,
                neighbor_normals=frames,
                icp_correspond=(ICP_PASSES + 1) * calls,
                icp_update=ICP_PASSES * calls,
                **dict.fromkeys(MATCH_KERNELS, calls))


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

    from quatro_tpu_torch import pipeline, sequence
    from quatro_tpu_torch.odometry import (FrameFeatures, OdometryRunner,
                                           run_odometry_windowed)
    from quatro_tpu_torch.ops import launch
    from quatro_tpu_torch.ops.scancontext import (detect_loop_candidates,
                                                  scan_context)
    from quatro_tpu_torch.parallel import posegraph
    from quatro_tpu_torch.parallel.posegraph import optimize_pose_graph
    from quatro_tpu_torch.preprocessing import projection
    from quatro_tpu_torch.utils import loops

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
    rounds0 = label_rounds()
    sequence.optimize_pose_graph = recorder
    try:
        # each labelling and Patchwork call's operands cloned, for the
        # checks below
        with recorded(projection, "label_sweeps", []) as lab_calls, \
                recorded(pipeline, "estimate_ground", []) as pw_calls:
            res, wall_ms = _synced_ms(lambda: sequence.run_sequence(
                scans, cfg, gt_poses=gt, use_place_recognition=True,
                batch_size=SEQ_BATCH, gn_iters=gn, cg_iters=cg))
    finally:
        sequence.optimize_pose_graph = solve
    launches = launch_counts(rounds0)
    labelling_calls_equal(lab_calls, "path S")
    patchwork_calls_equal(pw_calls, "path S")
    del lab_calls, pw_calls
    m = len(scans)
    edges = list(zip(res.edges_i.tolist(), res.edges_j.tolist()))
    calls = -(-len(edges) // SEQ_BATCH)
    expected = sequence_launches(m, calls)
    log("path S run: " + json.dumps({
        "edges_total": res.edges_total, "edges_valid": res.edges_valid,
        "loop_edges": edges[m - 1:],
        "rejected": [e for e, ok in zip(edges, res.edge_mask) if not ok],
        "ate_before_m": res.ate_before, "ate_after_m": res.ate_after,
        "wall_ms": round(wall_ms, 3), "registered_edges": len(edges),
        "registration_calls": calls}))
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
    check(launches_match(launches, expected),
          f"path S: launch counts {launches} != {expected}")

    # the pose graph again on the run's own edges: the same bits; its
    # first J^T apply's B2 arguments recorded (one list append per call)
    (args, kwargs), = graphs
    jt_calls = []
    jt_sums = posegraph.segment_sums

    def jt_recorder(*a):
        jt_calls.append(a)
        return jt_sums(*a)

    # (uncaptured: a replay calls no Python)
    posegraph.segment_sums = jt_recorder
    try:
        with loops.eager_loops():
            again, pg_eager_ms = _synced_ms(lambda: optimize_pose_graph(
                *args, **kwargs))
    finally:
        posegraph.segment_sums = jt_sums
    check(len(jt_calls) == gn * (cg + 1),
          f"path S: {len(jt_calls)} J^T applies in one pose-graph solve")
    check(np.array_equal(again.cpu().numpy(), res.poses),
          "path S: a second pose-graph solve differs")
    # the graph route: the run's own solve captured its first trip, a
    # solve after it replays every trip, and a solve with no graph kept
    # (a one-shot solve) runs its first trip uncaptured and captures it
    phase_loops(card, "path S pose graph", lambda: optimize_pose_graph(
        *args, **kwargs))
    replayed, pg_ms = _synced_ms(lambda: optimize_pose_graph(*args,
                                                             **kwargs))
    loops.clear_graphs()
    first, pg_first_ms = _synced_ms(lambda: optimize_pose_graph(*args,
                                                                **kwargs))
    for name, x in (("replayed", replayed), ("one-shot", first)):
        check(np.array_equal(x.cpu().numpy(), res.poses),
              f"path S: the {name} pose-graph solve differs")

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
    # ICP's kernels on one frame's extraction and the first batch of edges
    # (every call against its plain version on the card)
    batch = edges[:SEQ_BATCH]
    icp_calls_equal(icp_run(lambda: (runner.extract(scans[0]),
                                     runner.register_pairs(
        FrameFeatures.stack([feats[j] for _, j in batch]),
        FrameFeatures.stack([feats[i] for i, _ in batch]))))[1],
        f"path S, one frame and a batch of {len(batch)} edges")
    # the stages' device loops of one frame's extraction and of the last
    # edge's registration (Patchwork's fits, labelling, ICP, overlaps)
    i, j = edges[-1]
    phase_loops(card, "path S extract and register", lambda: (
        runner.extract(scans[j]), runner.register_pairs(
            FrameFeatures.stack([feats[j]]), FrameFeatures.stack([feats[i]]))))
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
        "pose_graph_one_shot": round(pg_first_ms, 3),
        "pose_graph_uncaptured": round(pg_eager_ms, 3),
        "sequence_wall": round(wall_ms, 3),
        "step_median_of_3": round(step_ms, 3),
        "step_device_busy": round(busy, 3)}) + f"; step idle share {idle}")
    return launches, jt_calls[0], (scans, gt)


def bench_case():
    """bench.py's 8 distinct pairs and configuration (bench.py:120-136):
    HDL-64E scans at capacity 131072, 8192 voxels, 1024 correspondences,
    4 clique + 2 vote hypotheses, no ground alignment or ICP. Returns
    ([(source, target, ground truth)], config)."""
    from quatro_tpu_torch.config import (FPFHConfig, PipelineConfig,
                                         SolverConfig)
    from quatro_tpu_torch.io.synthetic import make_scan_pair

    cfg = PipelineConfig(max_raw_points=RAW_CAPACITY, max_voxels=8192,
                         fpfh=FPFHConfig(max_correspondences=1024),
                         solver=SolverConfig(num_hypotheses=4,
                                             num_vote_hypotheses=2))
    scans = [make_scan_pair(seed=s, yaw_deg=10.0 + 7 * s,
                            translation=(2.0 + 0.3 * s, 1.0 - 0.2 * s, 0.05))
             for s in range(BENCH_PAIRS)]
    return scans, cfg


def pair_batch(clouds, dev):
    """(M, 3) numpy clouds as one PointBatch (B, RAW_CAPACITY, 3) on
    ``dev``."""
    from quatro_tpu_torch.types import PointBatch

    pbs = [PointBatch.from_numpy(c, RAW_CAPACITY) for c in clouds]
    return PointBatch(torch.stack([p.points for p in pbs]).to(dev),
                      torch.stack([p.mask for p in pbs]).to(dev))


EXACT_FIELDS = ("valid", "max_clique_mask", "final_inlier_mask",
                "num_rotation_inliers", "gnc_iterations")


def check_rows(batch, singles, name):
    """Every row of a batched result against the per-pair call on its
    pair: exactly the voxel clouds, the correspondence slots, the
    solution's and the hypotheses' masks, valid, GNC iteration counts,
    the arbitration winner and ICP's inlier count; the pose within 1e-5
    rad / 1e-4 m. Returns the worst pose gaps (rad, m)."""
    from quatro_tpu_torch.utils.se3 import rotation_geodesic_error

    worst_r = worst_t = 0.0
    for b, one in enumerate(singles):
        row = batch.row(b)
        what = f"{name}: pair {b}"
        for got, ref in ((row.src_voxels, one.src_voxels),
                         (row.tgt_voxels, one.tgt_voxels)):
            check(torch.equal(got.points, ref.points)
                  and torch.equal(got.mask, ref.mask),
                  f"{what}: voxels differ from the per-pair call")
        for got, ref, f in zip(row.correspondences, one.correspondences,
                               one.correspondences._fields):
            check(torch.equal(got, ref),
                  f"{what}: correspondences' {f} differ from the per-pair "
                  "call")
        sols = [(row.solution, one.solution, "solution")]
        if one.hypotheses is not None:
            sols.append((row.hypotheses, one.hypotheses, "hypotheses"))
            win = [int(torch.argmax(torch.where(r.hypotheses.valid,
                                                r.overlaps, -1.0)))
                   for r in (row, one)]
            check(win[0] == win[1], f"{what}: winner {win[0]} != {win[1]}")
        for got, ref, label in sols:
            for f in EXACT_FIELDS:
                check(torch.equal(getattr(got, f), getattr(ref, f)),
                      f"{what}: {label}'s {f} differs from the per-pair call")
        if one.icp is not None:
            check(torch.equal(row.icp.num_inliers, one.icp.num_inliers)
                  and torch.equal(row.icp.converged, one.icp.converged),
                  f"{what}: ICP's inliers differ from the per-pair call")
        worst_r = max(worst_r, float(rotation_geodesic_error(
            one.solution.rotation.cpu(), row.solution.rotation.cpu())))
        worst_t = max(worst_t, float((row.solution.translation
                                      - one.solution.translation).abs()
                                     .max()))
    check(worst_r <= 1e-5 and worst_t <= 1e-4,
          f"{name}: poses {worst_r} rad / {worst_t} m from the per-pair "
          "calls")
    return worst_r, worst_t


def pair_axis_gate(name, cases, cfg, dev):
    """One batched ``register_scan_pair`` call on ``cases`` [(source,
    target, ground truth)] against the per-pair calls: every row equal
    (``check_rows``), the launch counts of the batched call (set to 0
    just before it, read just after) equal to one pair's call (the
    labelling's rounds, each image's own, may differ), and each
    pair that its own call puts within P_BAND of the ground truth within
    it batched. Returns (batched result, its launch counts)."""
    from quatro_tpu_torch.ops import launch
    from quatro_tpu_torch.pipeline import register_scan_pair

    from quatro_tpu_torch.types import PointBatch

    singles = []
    for k, (src, tgt, _) in enumerate(cases):
        pair = tuple(PointBatch.from_numpy(c, RAW_CAPACITY).to(dev)
                     for c in (src, tgt))
        if k == 0:                               # one pair's launches
            register_scan_pair(*pair, cfg)
            torch.cuda.synchronize()
            launch.reset_launches()
            rounds0 = label_rounds()
        singles.append(register_scan_pair(*pair, cfg))
        torch.cuda.synchronize()
        if k == 0:
            one_launches = launch_counts(rounds0)
    src_b = pair_batch([c[0] for c in cases], dev)
    tgt_b = pair_batch([c[1] for c in cases], dev)
    register_scan_pair(src_b, tgt_b, cfg)        # warm-up
    torch.cuda.synchronize()
    launch.reset_launches()
    rounds0 = label_rounds()
    batch, ms = _synced_ms(lambda: register_scan_pair(src_b, tgt_b, cfg))
    launches = launch_counts(rounds0)
    check(same_launches(launches, one_launches),
          f"{name}: launches of the batched call {launches} != one pair's "
          f"{one_launches}")
    worst_r, worst_t = check_rows(batch, singles, name)
    in_band = kept = 0
    for b, (_, _, gt) in enumerate(cases):
        ok_one = np.less(pose_errors(singles[b].solution, gt), P_BAND).all()
        ok_row = np.less(pose_errors(batch.row(b).solution, gt),
                         P_BAND).all()
        in_band += int(ok_one)
        kept += int(ok_one and ok_row)
        check(ok_row or not ok_one,
              f"{name}: pair {b} in band alone, out of it batched")
    log(f"{name}: B {len(cases)} in one call ({ms:.3f} ms host wall), "
        f"every row equal to its per-pair call (poses within "
        f"{worst_r:.3g} rad / {worst_t:.3g} m); {kept} of {in_band} pairs "
        f"within {P_BAND[0]} rad / {P_BAND[1]} m of the ground truth alone "
        f"stay so batched ({len(cases)} pairs); launches "
        f"{json.dumps(launches)} (one pair's {json.dumps(one_launches)})")
    return batch, launches


def graph_pair_axis_row(corr, cfg, label):
    """B1 with a pair axis on a batch's own correspondences (B, N, 3): one
    launch, bit for bit its plain version on CPU copies; its device ms per
    call beside its bound (the B x N^2 output bytes or operations)."""
    from quatro_tpu_torch.ops import kernels, launch

    sc = cfg.solver
    beta = 2.0 * sc.noise_bound * sc.cbar2 ** 0.5
    cs, ct = corr.src_xyz.contiguous(), corr.tgt_xyz.contiguous()
    bsz, n, _ = cs.shape
    before = launch.LAUNCHES["consistency_graph"]
    got = kernels.consistency_graph(cs, ct, beta)
    check(launch.LAUNCHES["consistency_graph"] == before + 1,
          f"B1 ({label}): not one launch")
    check(torch.equal(got.cpu(), kernels.consistency_graph_plain(
        cs.cpu(), ct.cpu(), beta)),
        f"B1 ({label}): differs from its plain version on CPU copies")
    b_ms, by = bound(float(bsz * n * n) * OPS_GRAPH,
                     2 * bsz * n * 3 * 4 + bsz * n * n)
    row = {"shape": f"({bsz},{n},3)^2 -> ({bsz},{n},{n})",
           "device_ms": device_ms_per_call(
               lambda: kernels.consistency_graph(cs, ct, beta), "quatro::",
               main=(MAIN_KERNEL["consistency_graph"], 1)),
           "ms": cuda_ms(lambda: kernels.consistency_graph(cs, ct, beta)),
           "bound_ms": b_ms, "bound_by": by}
    log(f"consistency_graph ({label}): " + json.dumps(row)
        + "; one launch, equal to the plain version on CPU copies")
    return row


@contextlib.contextmanager
def recorded(mod, name, calls):
    """``mod.name`` wrapped for the block: each call's (arguments cloned,
    keyword arguments, result) appended to ``calls``."""
    orig = getattr(mod, name)

    def rec(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((_clone_tree(args), dict(kwargs), out))
        return out

    setattr(mod, name, rec)
    try:
        yield calls
    finally:
        setattr(mod, name, orig)


def check_batched_stages(vox_calls, overlap_calls, label):
    """The batched voxel grid and overlaps of one call against the
    per-cloud and per-pair calls on the same inputs, bit for bit: each
    cloud of every ``voxel_downsample`` call against its own call, each
    pair of every ``alignment_overlap`` call (its K poses) against the
    call on that pair alone. Returns (clouds, pairs) checked."""
    from quatro_tpu_torch.ops.voxel import voxel_downsample
    from quatro_tpu_torch.solver.verify import alignment_overlap

    clouds = pairs = 0
    for args, kwargs, (vox, vmask) in vox_calls:
        pts, msk = args[:2]
        for c in range(pts.shape[0]):
            one = voxel_downsample(pts[c], msk[c], *args[2:], **kwargs)
            check(torch.equal(vox[c], one[0]) and torch.equal(vmask[c],
                                                              one[1]),
                  f"{label}: cloud {c} of the batched voxel grid differs "
                  "from its own call")
        clouds += pts.shape[0]
    for args, kwargs, out in overlap_calls:
        for b in range(out.shape[0]):
            one = alignment_overlap(*(a[b:b + 1] for a in args[:6]),
                                    *args[6:], **kwargs)
            check(torch.equal(out[b:b + 1], one),
                  f"{label}: pair {b}'s overlaps differ from its own call")
        pairs += out.shape[0]
    check(clouds and pairs, f"{label}: no voxel grid or overlap recorded")
    return clouds, pairs


def phase_pair_axis(card, pairs, gts, cfg_a, bench):
    """Path P, the pair axis: (a) bench.py's 8 pairs under its
    configuration as one call at B = 8, (b) path A's configuration at B =
    4 (path A's tilted pair and the first three bench pairs tilted alike),
    each against the per-pair calls (``pair_axis_gate``); (c) ms per call
    and pairs/s at B = 1, 8 and 64 (the 8 pairs cycled as bench.py cycles
    them, a batch per offset), median and spread of 3 runs after a
    warm-up, with the stage split, B1 at B = 8 and 64, the device idle
    share of the B = 8 call, the peak memory at B = 64 and the bytes the
    device loops' graphs took at B = 64, and the sweep and overlap kernels
    at B = 64's shapes (``stage_kernel_rows_b64``), Patchwork's, the
    clique stage's, the matcher's (``match_rows_b64``) and B2's pair axis
    (``b2_row_b64``) on that call's operands. ``bench``: (bench.py's
    scans, its configuration, the seconds their ray-cast took). Returns
    B1's pair-axis rows, B = 64's graph bytes, the sweep and overlap
    kernels' B = 64 rows and the launches of the B = 8 call."""
    from torch.profiler import ProfilerActivity, profile

    from quatro_tpu_torch import pipeline
    from quatro_tpu_torch.device import resolve_device
    from quatro_tpu_torch.pipeline import register_scan_pair
    from quatro_tpu_torch.solver import verify, vote
    from quatro_tpu_torch.utils import loops

    dev = resolve_device(None)
    scans, cfg, cast_s = bench
    log(f"path P: bench.py's {len(scans)} HDL-64E pairs ray-cast in "
        f"{cast_s:.1f} s; {cfg.max_voxels} voxels, "
        f"{cfg.fpfh.max_correspondences} correspondences, "
        f"{cfg.solver.num_hypotheses} + {cfg.solver.num_vote_hypotheses} "
        "hypotheses")
    batch8, launches8 = pair_axis_gate("path P (a), bench.py's pairs",
                                       scans, cfg, dev)
    src_a = pairs["tilted"][0].to_numpy()
    tgt_a = pairs["tilted"][1].to_numpy()
    cases_a = [(src_a, tgt_a, gts["tilted"])] + [
        tilted(*scans[k]) for k in range(P_PATH_A_BATCH - 1)]
    pair_axis_gate("path P (b), path A's configuration", cases_a, cfg_a,
                   dev)

    times, rows = {}, {}
    for bsz in PAIR_AXIS_BATCHES:
        batches = [(pair_batch([scans[(i + off) % len(scans)][0]
                                for i in range(bsz)], dev),
                    pair_batch([scans[(i + off) % len(scans)][1]
                                for i in range(bsz)], dev))
                   for off in range(PAIR_AXIS_REPEATS + 1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        captured = dict(loops.CAPTURED)
        res = register_scan_pair(*batches[0], cfg)          # warm-up
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        timer = StageTimer()
        loops.reset_loops()
        walls = [_synced_ms(lambda: register_scan_pair(
            *batches[1], cfg, timer=timer))[1]]
        stages = timer.split_ms()
        counters = {k: dict(v) for k, v in loops.LOOPS.items()}
        walls += [_synced_ms(lambda: register_scan_pair(*b, cfg))[1]
                  for b in batches[2:]]
        spread = _spread(walls)
        graphs = {k: loops.CAPTURED[k] - captured[k] for k in captured}
        graphs["held_now"] = loops.held()
        times[bsz] = dict(ms_per_call=spread, graphs_captured=graphs,
                          pairs_per_s=round(bsz * 1e3 / spread["median"], 3),
                          stages_ms={k: round(v, 3)
                                     for k, v in stages.items()},
                          peak_gib=round(peak / 2 ** 30, 3),
                          held_before_gib=round(held / 2 ** 30, 3))
        log(f"path P (c) B {bsz} ({card}): " + json.dumps(times[bsz]))
        log(f"path P (c) B {bsz} device loops of one call: "
            + json.dumps(counters))
        # one more call with the voxel grid's and the overlaps' inputs
        # recorded (after the peak: the records hold copies)
        with recorded(pipeline, "voxel_downsample", []) as vox_calls, \
                recorded(verify, "alignment_overlap", []) as ov_calls:
            register_scan_pair(*batches[0], cfg)
        clouds, pairs_ok = check_batched_stages(
            vox_calls, ov_calls, f"path P (c) B = {bsz}")
        del vox_calls, ov_calls
        log(f"path P (c) B {bsz}: the batched voxel grid equal to the "
            f"per-cloud call on all {clouds} clouds, the overlaps to the "
            f"per-pair call on all {pairs_ok} pairs, bit for bit")
        if bsz == max(PAIR_AXIS_BATCHES):
            # the labelling's and the overlaps' inputs of one more call:
            # their kernels against the plain versions at this shape
            with recorded(pipeline, "segment_cloud", []) as seg_calls, \
                    recorded(verify, "overlap_hits", []) as hit_calls, \
                    recorded(pipeline, "estimate_ground", []) as pw_calls, \
                    recorded(vote, "segment_sums", []) as b2_calls:
                (_, match_calls), clique_calls = clique_run(
                    lambda: match_run(
                        lambda: register_scan_pair(*batches[0], cfg)))
            stage_rows = stage_kernel_rows_b64(
                (seg_calls[0][0], seg_calls[0][1]), hit_calls[0][0],
                f"path P, B = {bsz}")
            stage_rows.update(patchwork_rows_b64(pw_calls[0][0],
                                                 f"path P, B = {bsz}"))
            stage_rows.update(clique_rows_b64(clique_calls,
                                              f"path P, B = {bsz}"))
            stage_rows["segment_sums"] = b2_row_b64(b2_calls[0][0],
                                                    f"path P, B = {bsz}")
            stage_rows.update(match_rows_b64(match_calls,
                                             f"path P, B = {bsz}"))
            del (seg_calls, hit_calls, pw_calls, clique_calls, b2_calls,
                 match_calls)
            by_kernel = {}
            busy = stage_device_busy(lambda timer: register_scan_pair(
                *batches[1], cfg, timer=timer), by_kernel=by_kernel)
            log_stage_kernels(f"path P (c) B {bsz}", by_kernel)
            log(f"path P (c) B {bsz} stage split ({card}; ms, CUDA events "
                "of the timed call; device busy from torch.profiler in "
                "one more call, between marker fills): " + json.dumps(
                    {k: {"ms": round(v, 3), "device_busy_ms":
                         None if busy is None else busy.get(k)}
                     for k, v in stages.items()})
                + f"; peak {peak / 2 ** 30:.3f} GiB")
        if bsz > 1:
            rows[bsz] = graph_pair_axis_row(res.correspondences, cfg,
                                            f"path P, B = {bsz}")
        if bsz == 8:
            phase_loops(card, "path P (c) B = 8", lambda: register_scan_pair(
                *batches[1], cfg))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                register_scan_pair(*batches[1], cfg)
                torch.cuda.synchronize()
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.is_user_annotation) / 1e3
            idle = (round(1.0 - busy / spread["median"], 4) if busy > 0
                    else "not measured (the profiler saw no device time)")
            log(f"path P (c) B 8: device busy {busy:.3f} ms of the "
                f"{spread['median']:.3f} ms median call; idle share {idle}")
    check(all(times[b]["ms_per_call"]["median"] > 0 for b in times),
          "path P: no time measured")
    log("path P times (" + card + "): " + json.dumps(
        {b: {"median_ms": t["ms_per_call"]["median"],
             "pairs_per_s": t["pairs_per_s"]} for b, t in times.items()})
        + f"; launches per batched call at B = 8: {json.dumps(launches8)}")
    return (rows, times[max(PAIR_AXIS_BATCHES)]["graphs_captured"],
            stage_rows, launches8)


def _launch_diff(before):
    """The launches since ``before``, a ``launch_counts()``."""
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()}


def phase_entry(card, work_dir):
    """Path E, the user's entry points, through eval.py and cli.py as a
    user calls them: (a) ``evaluate_loop_closures`` at full width under
    ``recommended(max_voxels=8192)`` (the JAX package's success-rate record,
    EVAL_r05.json ``tpu_n300_shipping``, seeds from 0) at batch E_BATCH and
    at batch 1 on the same pairs (ray-cast once by the harness's process
    pool into a cache under ``work_dir``): at least E_MIN_SUCCESS of
    E_PAIRS pairs within 5 deg / 2 m, every batched row's valid and
    correspondence count equal to batch 1's and its errors within
    E_ROW_TOL, each batched call's launches those of one pair; (b)
    ``evaluate_outlier_robustness()`` at its defaults (one
    ``register_batch`` call at B = 64 a rate, one B1 launch each), 5/6 at
    the rates of E_SWEEP_GATES; (c) ``cli.main(["register", "--synthetic",
    ...])`` on the card with its PLY dumps, then ``register a.bin b.bin``
    on the same pair written as KITTI .bin and read by the native loader,
    its transform equal to the synthetic run's."""
    import contextlib
    import io
    import os

    from quatro_tpu_torch import cli, native
    from quatro_tpu_torch import eval as ev
    from quatro_tpu_torch.config import LidarConfig, PipelineConfig
    from quatro_tpu_torch.io import kitti
    from quatro_tpu_torch.io.synthetic import make_scan_pair

    check(native.available(), "path E: the native loader does not build")
    cfg = PipelineConfig.recommended(**E_CONFIG)
    pool_s = []
    warm, register, register_batch = (ev._warm_cache, ev.register_scan_pair,
                                      ev.register_batch)
    calls = {}

    def timed_warm(*args):
        t0 = time.perf_counter()
        warm(*args)
        pool_s.append(time.perf_counter() - t0)

    def counted(src, tgt, *args, **kwargs):
        before = launch_counts()
        out = register(src, tgt, *args, **kwargs)
        calls.setdefault(tuple(src.points.shape[:-2]), []).append(
            _launch_diff(before))
        return out

    reports = {}
    ev._warm_cache, ev.register_scan_pair = timed_warm, counted
    try:
        for bsz in (E_BATCH, 1):
            def run(bsz=bsz):
                return ev.evaluate_loop_closures(
                    n_pairs=E_PAIRS, config=cfg, raw_capacity=RAW_CAPACITY,
                    seed0=0, cache_dir=os.path.join(work_dir, "scans"),
                    batch=bsz)
            if bsz == E_BATCH:      # the batched calls' matcher recorded
                reports[bsz], match_recs = match_run(run)
            else:
                reports[bsz] = run()
    finally:
        ev._warm_cache, ev.register_scan_pair = warm, register
    match_calls_equal(match_recs, f"path E (a) batch {E_BATCH}")
    del match_recs
    raycast_s = sum(pool_s)
    log(f"path E (a): {E_PAIRS} {cfg.lidar.name} pairs ray-cast by eval.py's "
        f"process pool in {raycast_s:.1f} s ({os.cpu_count()} cores)")
    check(raycast_s <= E_RAYCAST_LIMIT_S,
          f"path E: ray-casting took {raycast_s:.1f} s")
    for bsz, rep in reports.items():
        # wall_s times the calls after the warm-up: with batch > 1 chunk
        # 0's result is reused, so the harness's pairs_per_s counts its
        # pairs over the other chunks' time (as the JAX package's does)
        timed = E_PAIRS - bsz if bsz > 1 else E_PAIRS
        log(f"path E (a) batch {bsz} ({card}): " + json.dumps(
            dict(rep.summary(), wall_s=rep.wall_s, compile_s=rep.compile_s,
                 pairs_timed=timed, timed_pairs_per_s=timed / rep.wall_s)))
        log(f"path E (a) batch {bsz} rows: " + json.dumps(
            [[p.seed, p.valid, round(p.rot_err_deg, 5),
              round(p.trans_err_m, 5), p.n_corr] for p in rep.pairs]))
    batched, single = reports[E_BATCH].pairs, reports[1].pairs
    ok = sum(p.success for p in batched)
    failures = [(p.seed, p.rot_err_deg, p.trans_err_m, p.valid)
                for p in batched if not p.success]
    log(f"path E (a): {ok} of {E_PAIRS} within 5 deg / 2 m; failures "
        f"{failures}")
    check(ok >= E_MIN_SUCCESS, f"path E: {ok} of {E_PAIRS} successful")
    worst = [0.0, 0.0]
    for b, o in zip(batched, single):
        check((b.seed, b.valid, b.n_corr) == (o.seed, o.valid, o.n_corr),
              f"path E: seed {b.seed} batched {b} != batch 1 {o}")
        worst = [max(worst[0], abs(b.rot_err_deg - o.rot_err_deg)),
                 max(worst[1], abs(b.trans_err_m - o.trans_err_m))]
    check(worst[0] <= E_ROW_TOL[0] and worst[1] <= E_ROW_TOL[1],
          f"path E: batched rows {worst} deg / m from batch 1's")
    one = calls[()][0]
    check(launches_match(one, RECOMMENDED_LAUNCHES),
          f"path E: one pair's launches {one}")
    check(all(same_launches(c, one) for c in calls[(E_BATCH,)]),
          f"path E: batched launches {calls[(E_BATCH,)]} != one pair's {one}")
    log(f"path E (a): every batched row equal to batch 1's (errors within "
        f"{worst[0]:.3g} deg / {worst[1]:.3g} m); launches per batched call "
        f"{json.dumps(calls[(E_BATCH,)][0])} (one pair's the same)")

    sweep_ms, sweep_b1 = [], []

    def timed_batch(*args, **kwargs):
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        out = register_batch(*args, **kwargs)
        torch.cuda.synchronize()
        sweep_ms.append((time.perf_counter() - t0) * 1e3)
        sweep_b1.append(_launch_diff(before)["consistency_graph"])
        return out

    ev.register_batch = timed_batch
    try:
        sweep = ev.evaluate_outlier_robustness()
    finally:
        ev.register_batch = register_batch
    for (rate, row), ms in zip(sweep.items(), sweep_ms):
        log(f"path E (b) rate {rate} ({card}): " + json.dumps(
            dict(row, register_batch_ms=round(ms, 3))))
    check(sweep_b1 == [1] * len(sweep),
          f"path E: B1 launches per sweep call {sweep_b1}")
    for rate in E_SWEEP_GATES:
        check(sweep[rate]["success_rate"] >= 5 / 6,
              f"path E: outlier rate {rate}: {sweep[rate]}")

    def run_cli(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        out = buf.getvalue()
        log(out.rstrip())
        check(rc == 0, f"path E: cli {argv[:2]} returned {rc}")
        res = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
        return out, res, time.perf_counter() - t0

    dump = os.path.join(work_dir, "dump")
    width = ["--lidar-type", E_CLI_LIDAR, *E_CLI_WIDTH, "--json"]
    out, syn, syn_s = run_cli(["register", "--synthetic", "--seed",
                               str(E_CLI_SEED), "--dump-dir", dump, *width])
    check(syn["valid"], "path E: the CLI's synthetic pair is not valid")
    check("steady-state solve" in out and "total" in out
          and "# of raw cloud" in out, "path E: no stage table printed")
    sizes = {n: os.path.getsize(os.path.join(dump, n))
             for n in E_CLI_ARTIFACTS if os.path.exists(os.path.join(dump, n))}
    check(len(sizes) == len(E_CLI_ARTIFACTS)
          and all(sizes[n] > 100 for n in E_CLI_ARTIFACTS[:8]),
          f"path E: CLI artifacts {sizes}")
    src_xyz, tgt_xyz, _ = make_scan_pair(
        seed=E_CLI_SEED, lidar=LidarConfig.preset(E_CLI_LIDAR))
    bins = [os.path.join(work_dir, n) for n in ("a.bin", "b.bin")]
    for path, xyz in zip(bins, (src_xyz, tgt_xyz)):
        kitti.save_kitti_bin(path, xyz)
    check(kitti._native_ready(), "path E: io/kitti.py takes numpy's route")
    _, from_bin, bin_s = run_cli(["register", *bins, *width])
    gap = float(np.abs(np.asarray(from_bin["transform"])
                       - np.asarray(syn["transform"])).max())
    check(from_bin["transform"] == syn["transform"],
          f"path E: the .bin route's transform is {gap} from the "
          "synthetic run's")
    log(f"path E (c) ({card}): cli register --synthetic {syn_s:.3f} s, "
        f"register a.bin b.bin {bin_s:.3f} s (each with its warm-up, "
        f"ray-cast and dumps); {len(sizes)} PLY artifacts; the .bin "
        "route's transform equal to the synthetic run's")


def phase_profile(pair, cfg, wall_ms, stages, top=10):
    """One more pipeline run under torch.profiler: the card's busy time
    (sum of device times on the one stream), the idle share against the
    unprofiled run's host wall time ``wall_ms`` (the profiler slows the
    host, not the card), and the kernels that take the most device time;
    then the device busy time of each stage beside its CUDA-event ms
    ``stages`` (``stage_device_busy``), and the ``icp`` stage's device
    time by sub-step and kernel (``icp_substeps``)."""
    from torch.profiler import ProfilerActivity, profile

    from quatro_tpu_torch.pipeline import register_scan_pair

    by_kernel = {}
    busy = stage_device_busy(lambda timer: register_scan_pair(
        *pair, cfg, timer=timer), by_kernel=by_kernel)
    log_stage_kernels("profile: path A", by_kernel)
    log("profile: path A stages (ms, CUDA events of the counted run; "
        "device busy from torch.profiler in one more run, between marker "
        "fills): " + json.dumps(
            {k: {"ms": round(v, 3), "device_busy_ms":
                 None if busy is None else busy.get(k)}
             for k, v in stages.items()}))
    icp_substeps(pair, cfg, "profile: path A icp sub-steps")

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
    again = fe.nearest_neighbors(da, db, ma, mb)
    check(torch.equal(idx, again[0]) and torch.equal(d2, again[1]),
          "1-NN kernel differs between launches")
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
    r_end, c_end = fe.nn_active_limits(ma, mb)[0].tolist()
    tiles, splits = -(-v // fe.NN1_ROWS), -(-v // fe.NN1_SPLIT)
    busy_tiles = -(-r_end // fe.NN1_ROWS)
    busy = busy_tiles * max(1, -(-c_end // fe.NN1_SPLIT))
    log(f"nearest_neighbors: {int(ma.sum())} valid source rows, "
        f"{int(mb.sum())} valid target columns; active limits {r_end} rows, "
        f"{c_end} columns of {v}; {busy} of {tiles * splits} blocks did work "
        f"({busy_tiles} row tiles of {fe.NN1_ROWS} x "
        f"{max(1, -(-c_end // fe.NN1_SPLIT))} splits of {fe.NN1_SPLIT} "
        f"columns), {tiles - busy_tiles} wrote empty rows; equal across two "
        "launches, to the top-2 kernel's first slot and to the plain version "
        "on CPU copies, bit for bit")

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
    per call, as [(event, launches per call)]. The profiler drops device
    events at the ends of a profiled run, so the calls sit between two
    runs of marker fills (``pad_launches``; their events are left out);
    an event seen ``c`` times ran ceil(c / reps) times per call. A run is
    taken when no event misses more than one launch and, with ``main`` =
    (kernel, launches per call), that kernel ran its launches per call;
    else it profiles again."""
    from torch.profiler import ProfilerActivity, profile

    key = pad_key()
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pad_launches()
            for _ in range(reps):
                fn()
            pad_launches()
            torch.cuda.synchronize()
        hits = [(e, -(-e.count // reps)) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation and e.self_device_time_total > 0
                and name in e.key and e.key != key]
        missing = max((k * reps - e.count for e, k in hits), default=0)
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


def device_ms_per_call(fn, prefix="", reps=10, main=None, tries=5):
    """Mean device time of one call of ``fn``: each device event (kernel,
    copy, fill) it runs whose name holds ``prefix`` ("quatro::" for the
    port's own kernels, "" for all), at its mean device time from
    torch.profiler over ``reps`` calls, times its launches per call
    (``_device_hits``, with ``main``); None where no profiled run saw
    every call."""
    hits = _device_hits(fn, prefix, reps, main, tries)
    if not hits:
        return None
    return sum(e.self_device_time_total / e.count * k for e, k in hits) / 1e3


# device ms per call of the former designs on NVIDIA H100 80GB HBM3,
# 700.00 W, printed beside this run's: the top-2 and histogram kernels with
# one thread per row each, the moment sums, SPFH and FPFH with one thread
# per row over every column, the plane-fit moments with an all-pairs
# compare; the segment sums with one thread per bin comparing every entry
# of its chunk and a second pass, the consistency graph with one thread per
# byte (the vote's shape and N = 1024); the 1-NN with 8 threads a row over
# every column and no limits (path B's shapes), the table lookup with one
# thread a point and 4-byte stores after the table's staging
# path A's icp stage before ICP's four kernels: device ms and launches of
# PR 22's tree on NVIDIA H100 80GB HBM3, 700.00 W (tests/torch_stage_busy.py
# --cases A, two runs in the call that timed these kernels' tree beside it)
FORMER_ICP = {"device_ms": [14.061, 14.077], "launches": 3560}
FORMER_DEVICE_MS = {"nearest_neighbors2": 1.757077,
                    "cross_histogram": 1.572931,
                    "moment_sums": 0.218100,
                    "spfh": 0.650900, "fpfh": 0.748800,
                    "fit_iteration_moments": 0.074700,
                    "segment_sums": 0.030200, "consistency_graph": 0.005400,
                    "nearest_neighbors": 0.169200, "table_lookup": 0.004800}
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
                                             "quatro::chunk_sum_kernel<9>"),
                   "overlap_hits": ("quatro::overlap_pack_kernel",
                                    "quatro::overlap_hits_kernel"),
                   "range_image": ("quatro::range_keys_kernel",
                                   "quatro::range_owner_kernel"),
                   "component_stats": ("quatro::component_accumulate_kernel",
                                       "quatro::component_feasible_kernel"),
                   "czm_points": ("quatro::czm_zrange_kernel",
                                  "quatro::czm_points_kernel"),
                   "kcore_search": ("quatro::clq::clique_pack_kernel",
                                    "quatro::clq::kcore_kernel")}
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
               "table_lookup": "quatro::table_lookup_kernel",
               "exact_clique": "quatro::exact_clique_kernel",
               "kabsch": "quatro::kabsch::kabsch_kernel",
               "label_sweep": "quatro::label_sweeps_kernel",
               "overlap_hits": "quatro::overlap_hits_kernel",
               "range_image": "quatro::range_keys_kernel",
               "edge_masks": "quatro::edge_masks_kernel",
               "component_stats": "quatro::component_feasible_kernel",
               "czm_points": "quatro::czm_points_kernel",
               "seed_heights": "quatro::seed_heights_kernel",
               "plane_fit": "quatro::plane_fit_kernel",
               "kcore_search": "quatro::clq::kcore_kernel",
               "grow_cliques": "quatro::clq::grow_kernel",
               "swap_cliques": "quatro::clq::swap_kernel",
               "distinct_cliques": "quatro::clq::distinct_kernel",
               "radius_knn": "quatro::knn::radius_knn_kernel",
               "neighbor_normals": "quatro::nrm::neighbor_normals_kernel",
               "icp_correspond": "quatro::icp::icp_correspond_kernel",
               "icp_update": "quatro::icp::icp_update_kernel",
               "match_candidates": "quatro::mc::match_candidates_kernel",
               "tuple_compact": "quatro::tup::tuple_compact_kernel"}


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
                  jt_call, launches_s, exact, overlap_args, clique_recs,
                  icp_recs, match_recs, match_recs_b):
    """Every kernel against its plain version: B1-B5 and B7-B12 on the
    main path's tensors, with the main path's launch counts (B12's 0: no
    path launches it); B6 on path B's, with path B's; B2 also on path S's
    J^T apply ``jt_call``, with path S's launch counts; the exact search
    on path B's exact mode's restriction (``exact``), with its launches;
    the labelling kernel on path A's labelling call (``calls``), the
    overlap on path A's arbitration call (``overlap_args``), the clique
    stage's four kernels on path A's calls (``clique_recs``), ICP's four
    on path A's calls (``icp_recs``) and the matcher's two on path A's and
    path B's calls (``match_recs``, ``match_recs_b``)."""
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
            label=None, lib_main=None, extra=None, prefix="quatro::"):
        """One kernel's row: CUDA-event ms of the wrapper's call (20 calls),
        of the plain version's (5) and of the library call's (20); the
        device ms per call of the port's kernels (``k_fn`` is one wrapper
        call, one launch of its main kernel; with ``prefix`` "" every
        device event of the call, a sort's too) and of the library call
        (torch.profiler, None where no profiled run saw every call;
        ``lib_main`` names the library's main kernel and its launches per
        call); the bound from this run's data; ``extra`` keys. Appended to the kernel table unless ``label`` names a second
        shape of the kernel (then only logged, with the label, and
        returned)."""
        b_ms, by = bound(ops, nbytes)
        r = {"name": name, "route": "cuda", "source": SOURCES[name],
             "replaces": REPLACES[name],
             "launches": main_launches[name] if launches is None
             else launches,
             "max_abs_err": err, "ms": cuda_ms(k_fn),
             "plain_ms": cuda_ms(p_fn, 5), "bound_ms": b_ms, "bound_by": by,
             "library_ms": cuda_ms(lib_fn) if lib_fn else None,
             "device_ms": device_ms_per_call(
                 k_fn, prefix, main=(MAIN_KERNEL[name], 1)),
             "library_device_ms": (device_ms_per_call(lib_fn, main=lib_main,
                                                      tries=10)
                                   if lib_fn else None)}
        r.update(extra or {})
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
    exact_kernel_row(exact, row, rows)
    kabsch_kernel_row(exact, row, rows)
    preprocessing_kernel_rows(calls, row)
    label_sweep_row(calls, main_launches, row, rows)
    projection_kernel_rows(calls, main_launches, row)
    patchwork_kernel_rows(calls, main_launches, row)
    clique_kernel_rows(clique_recs, main_launches, row)
    icp_kernel_rows(icp_recs, main_launches, row)
    match_kernel_rows(match_recs, main_launches, row, match_recs_b,
                      match_recs_b["match_features"][0])
    segment_routes_equal(calls["segment_cloud"][0], "path A")
    for preset in LABEL_PRESETS:
        segment_routes_equal(preset_segment_args(preset), preset)
        patchwork_cases(*patchwork_preset_args(preset), preset)
    overlap_row(overlap_args, main_launches, row)
    check(sorted(r["name"] for r in rows) == sorted(MAIN_KERNEL),
          "kernel phase: not one row for each kernel")
    missing = [r["name"] for r in rows if r["device_ms"] is None] + [
        f"{r['name']} (bf16 trip, uncaptured)" for r in rows
        if r.get("bf16_device_ms_uncaptured", 0.0) is None]
    check(not missing, "kernel phase: no profiled run saw every call of "
          f"{missing}")
    log("kernel phase: device ms of all thirty-two kernels "
        "(torch.profiler): "
        + json.dumps({r["name"]: round(r["device_ms"], 6) for r in rows}))
    return rows


def exact_kernel_row(exact, row, rows):
    """The exact search's kernel on path B's exact mode's restriction
    (B = 1, cap 64): bit for bit its plain version on CPU copies (best
    set, completed, steps) and across two launches; its row with the
    launches per path-B pair and per B = 8 call, the steps, and the
    device ns per step. The bound counts this run's steps
    (OPS_EXACT_WORD per 64-bit word and OPS_EXACT_STEP per step) at the
    f32 rate, and the restriction's bytes read once and the outputs'
    written once; the walk's dependent chain, not either, bounds it
    (``bound_applies`` false in its row): two dependent round trips to the
    frame stack in global memory a step."""
    from quatro_tpu_torch.ops import kernels

    sub, vvalid, best0, max_steps = exact["args"]
    got = kernels.exact_clique(sub, vvalid, best0, max_steps)
    again = kernels.exact_clique(sub, vvalid, best0, max_steps)
    ref = kernels.exact_clique_search_plain(sub.cpu(), vvalid.cpu(),
                                            best0.cpu(), max_steps)
    for what, g, a, r in zip(("best", "completed", "steps"), got, again,
                             ref):
        check(torch.equal(g, a), f"exact search's {what} differs between "
              "launches")
        check(torch.equal(g.cpu(), r), f"exact search's {what} differs "
              "from the plain version on CPU copies")
    bsz, cap = vvalid.shape
    steps = int(got[2].sum())
    words = -(-cap // 64)
    row("exact_clique", 0.0,
        lambda: kernels.exact_clique(sub, vvalid, best0, max_steps),
        lambda: kernels.exact_clique_search_plain(sub, vvalid, best0,
                                                  max_steps),
        float(steps * (OPS_EXACT_WORD * words + OPS_EXACT_STEP)),
        bsz * cap * cap + 3 * bsz * cap + 5 * bsz,
        launches=exact["launches_b"],
        extra={"launches_b8_call": exact["b8"], "steps": steps,
               "shape": f"({bsz},{cap},{cap})", "bound_applies": False})
    r = rows[-1]
    r["ns_per_step"] = (None if r["device_ms"] is None
                        else round(r["device_ms"] * 1e6 / steps, 3))
    log(f"exact_clique: {steps} steps at cap {cap}, equal to the plain "
        f"version on CPU copies and across two launches; device "
        f"{r['device_ms']} ms, {r['ns_per_step']} ns a step")


def kabsch_kernel_row(exact, row, rows):
    """The Kabsch kernel on the arguments path B's TEASER mode handed it
    (its GNC's first iteration, uncaptured): bit for bit its plain version
    run on the card and on CPU copies, and across two launches; its row
    with the launches per path-B TEASER call and per B = 8 call. Its
    bound (src, dst and w read once, R written once; this run's points'
    products and the SVD's operations at the f32 rate) is far below the
    serial chains that limit it: each entry of H adds the N points one
    after the other, and one thread runs the SVD."""
    from quatro_tpu_torch.ops import kabsch

    src, dst, w = exact["kabsch_args"]
    got = kabsch.kabsch_rotation(src, dst, w)
    again = kabsch.kabsch_rotation(src, dst, w)
    plain = kabsch.kabsch_rotation_plain(src, dst, w)
    ref = kabsch.kabsch_rotation_plain(src.cpu(), dst.cpu(), w.cpu())
    check(torch.equal(got, again), "Kabsch rotations differ between "
          "launches")
    check(torch.equal(got, plain), "the Kabsch kernel differs from its "
          "plain version run on the card")
    check(torch.equal(got.cpu(), ref), "the Kabsch kernel differs from its "
          "plain version on CPU copies")
    rows_n = src[..., 0, 0].numel()
    n = src.shape[-2]
    row("kabsch", float((got.cpu() - ref).abs().max()),
        lambda: kabsch.kabsch_rotation(src, dst, w),
        lambda: kabsch.kabsch_rotation_plain(src, dst, w),
        float(rows_n * (n * OPS_KABSCH_POINT + OPS_KABSCH_ROW)),
        rows_n * (n * 7 + 9) * 4,
        launches=exact["kabsch_launches_b"],
        extra={"launches_b8_call": exact["kabsch_b8"],
               "shape": f"({rows_n},{n},3)", "bound_applies": False})
    log(f"kabsch: {rows_n} rows of {n} points, equal to the plain version "
        "on the card and on CPU copies and across two launches; device "
        f"{rows[-1]['device_ms']} ms")


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
                               minlength=bsz * k * (bins + 1)),
        lib_main=("kernelHistogram1D", 1))

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
    # a bf16 trip, as the plane fits' device loop runs it: inside a CUDA
    # graph and uncaptured
    (b_ids, b_chan, b_tab, _, _), b_kw = next(
        c for c in calls["fit_iteration_moments"] if not c[1]["exact"])

    def bf16_trip():
        return segment.fit_iteration_moments(b_ids, b_chan, b_tab, p_pad,
                                             p_cnt, **b_kw)

    in_graph = graph_ms(bf16_trip)
    uncaptured = device_ms_per_call(
        bf16_trip, "quatro::", main=(MAIN_KERNEL["fit_iteration_moments"],
                                     1))
    log(f"fit_iteration_moments (bf16 trip): device {in_graph:.6f} ms per "
        f"call inside a CUDA graph (20 calls a graph), {uncaptured} ms "
        "uncaptured (torch.profiler)")
    bsz, _, n = chan.shape
    members = float(got[..., 0].sum())
    row("fit_iteration_moments", max(errs),
        lambda: segment.fit_iteration_moments(ids, chan, tab, p_pad, p_cnt,
                                              **kw),
        lambda: segment.fit_iteration_moments_plain(ids, chan, tab, p_pad,
                                                    p_cnt, **kw),
        bsz * n * OPS_PLANE + members * OPS_MOMENTS_PT,
        bsz * n * 4 * 6 + bsz * p_pad * (5 + 10) * 4,
        extra={"bf16_device_ms_in_graph": in_graph,
               "bf16_device_ms_uncaptured": uncaptured})

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


@contextlib.contextmanager
def sweep_route(plain):
    """The labelling, the range image's three kernels (keys and owners,
    edge masks, component stats) and Patchwork's three (CZM points, seed
    heights, plane fits) through their kernels, or (``plain``) through
    their plain versions on the card, uncaptured; yields a list that gets
    each labelling call's (labels, rounds)."""
    from quatro_tpu_torch.ops import czm
    from quatro_tpu_torch.ops import range_image as ri
    from quatro_tpu_torch.ops.labels import label_sweeps_plain
    from quatro_tpu_torch.preprocessing import patchwork, projection
    from quatro_tpu_torch.utils import loops

    real = projection.label_sweeps
    saved = {k: getattr(projection, k) for k in PROJECTION_KERNELS}
    saved_pw = {k: getattr(patchwork, k) for k in PATCHWORK_KERNELS}
    outs = []

    def run(*args, **kwargs):
        out = (label_sweeps_plain if plain else real)(*args, **kwargs)
        outs.append(out)
        return out

    projection.label_sweeps = run
    if plain:
        for k in PROJECTION_KERNELS:
            setattr(projection, k, getattr(ri, f"{k}_plain"))
        for k in PATCHWORK_KERNELS:
            setattr(patchwork, k, getattr(czm, f"{k}_plain"))
    try:
        with loops.eager_loops():
            yield outs
    finally:
        projection.label_sweeps = real
        for k, fn in saved.items():
            setattr(projection, k, fn)
        for k, fn in saved_pw.items():
            setattr(patchwork, k, fn)


def segment_routes_equal(seg_args, label):
    """segment_cloud on ``seg_args`` ((points, mask, lidar, projection
    config), keyword arguments) under each neighbour mode, and under the
    first with max_cc_iters = LABEL_CAP, with the labelling and range-image
    kernels and with their plain versions on the card (``sweep_route``):
    every field of the result (segment masks, range image, labels,
    owners), label_components' labels, feasibility and pixel feasibility
    and each image's rounds bit for bit, and each kernel launched once.
    Returns each case's rounds, feasible components and segment points."""
    import dataclasses

    from quatro_tpu_torch.preprocessing import projection

    (pts, mask, lidar, pcfg), kwargs = seg_args
    summary = {}
    cases = [(mode, None) for mode in NEIGHBOR_MODES]
    cases.append((NEIGHBOR_MODES[0], LABEL_CAP))
    for mode, cap in cases:
        cfg = dataclasses.replace(pcfg, neighbor_mode=mode)
        if cap is not None:
            cfg = dataclasses.replace(cfg, max_cc_iters=cap)
        runs = []
        for plain in (False, True):
            before = launch_counts()
            with recorded(projection, "label_components", []) as comps, \
                    sweep_route(plain) as outs:
                res = projection.segment_cloud(pts, mask, lidar, cfg,
                                               **kwargs)
            torch.cuda.synchronize()
            runs.append((tuple(res) + tuple(comps[0][2]) + (outs[0][1],),
                         _launch_diff(before)))
        (got, n_k), (ref, n_p) = runs
        names = res._fields + ("labels", "feasible", "pix_feasible",
                               "rounds")
        key = mode if cap is None else f"{mode}, max_cc_iters {cap}"
        for what, a, b in zip(names, got, ref):
            check(torch.equal(a, b), f"{label}, {key}: {what} with the "
                  "labelling kernel differs from its plain route")
        rounds = got[-1].tolist()
        check(n_k["label_sweep"] == 1 and n_p["label_sweep"] == 0
              and min(rounds) > 0,
              f"{label}, {key}: {n_k['label_sweep']} labelling launches, "
              f"rounds {rounds}")
        check(all(n_k[k] == 1 and n_p[k] == 0 for k in PROJECTION_KERNELS),
              f"{label}, {key}: projection kernel launches {n_k} / {n_p}")
        check(cap is None or max(rounds) == cap,
              f"{label}, {key}: rounds {rounds} never reach the cap")
        summary[key] = {"rounds": rounds, "components": int(got[7].sum()),
                        "segment_points": got[0].sum(-1).tolist()}
    log(f"label_sweep, range_image, edge_masks, component_stats ({label}: "
        f"{tuple(pts.shape[:-2])} clouds, {lidar.n_scan} x "
        f"{lidar.horizon_scan} images): labels, feasibility, segment masks, "
        "range image, owners and each image's rounds with the kernels equal "
        "to their plain routes on the card under every neighbour mode and "
        f"at max_cc_iters {LABEL_CAP}, bit for bit: " + json.dumps(summary))
    return summary


def preset_segment_args(preset):
    """segment_cloud's arguments for a ray-cast pair of a lidar preset
    (tests/test_torch_kernels_gpu.py's level_a pair), ground stripped as
    ``nonground`` strips it, as one batch of two clouds on the card."""
    from quatro_tpu_torch.config import LidarConfig, ProjectionConfig
    from quatro_tpu_torch.device import resolve_device

    lidar = LidarConfig.preset(preset)
    pair = preset_pair(preset)
    n = 65536
    pts = torch.zeros(2, n, 3)
    mask = torch.zeros(2, n, dtype=torch.bool)
    for b, xyz in enumerate(pair[:2]):
        xyz = nonground(xyz)[:n]
        pts[b, :len(xyz)], mask[b, :len(xyz)] = torch.from_numpy(xyz), True
    dev = resolve_device()
    return (pts.to(dev), mask.to(dev), lidar, ProjectionConfig()), {}


def labelling_bytes(args):
    """The bytes a labelling call must move: valid and each edge mask read
    once, the int32 labels written once (13 a pixel under 8 masks)."""
    labels, _, masks = args[:3]
    return float(labels.numel() * (1 + len(masks) + 4))


def kernel_registers(source):
    """{entry: registers} of a kernel library's entries, from this run's
    build (ptxas -v); {} where it was not built in this run."""
    from quatro_tpu_torch import _build

    out, entry = {}, None
    for line in _build.build_log.get(source, {}).get("ptxas",
                                                     "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = int(m.group(1))
            entry = None
    return out


def labelling_routes(args, label):
    """The labelling kernel on a recorded ``label_sweeps`` call: labels and
    each image's rounds equal across two launches, to the plain route on
    the card (uncaptured) and on CPU copies. Returns (kernel fn, plain
    fn, rounds, layout)."""
    from quatro_tpu_torch.ops.labels import (label_layout, label_sweeps,
                                             label_sweeps_plain)
    from quatro_tpu_torch.utils import loops

    def plain():
        with loops.eager_loops():
            return label_sweeps_plain(*args)

    got = label_sweeps(*args)
    again = label_sweeps(*args)
    ref = plain()
    cpu = label_sweeps_plain(args[0].cpu(), args[1].cpu(),
                             [m.cpu() for m in args[2]], *args[3:])
    for what, other in (("a second launch", again), ("the plain route on "
                        "the card", ref)):
        check(torch.equal(got[0], other[0]) and torch.equal(got[1],
                                                            other[1]),
              f"label_sweep ({label}): labels or rounds differ from {what}")
    check(torch.equal(got[0].cpu(), cpu[0]) and torch.equal(got[1].cpu(),
                                                            cpu[1]),
          f"label_sweep ({label}): labels or rounds differ from the plain "
          "route on CPU copies")
    return ((lambda: label_sweeps(*args)), plain, got[1].tolist(),
            label_layout(*args[0].shape))


def labelling_calls_equal(recs, label):
    """Each ``label_sweeps`` call of a path (``recorded``: its operands
    cloned, its result) against the plain route on the card (uncaptured)
    on the same operands: labels and each image's rounds bit for bit.
    Returns each call's rounds."""
    from quatro_tpu_torch.ops.labels import label_sweeps_plain
    from quatro_tpu_torch.utils import loops

    check(len(recs) > 0, f"{label}: no labelling call recorded")
    rounds = []
    for k, (args, kwargs, out) in enumerate(recs):
        with loops.eager_loops():
            ref = label_sweeps_plain(*args, **kwargs)
        check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
              f"label_sweep ({label}, call {k}): labels or rounds differ "
              "from the plain route on the card")
        rounds.append(out[1].tolist())
    log(f"label_sweep ({label}): {len(recs)} labelling calls of "
        f"{[int(a[0].shape[0]) for a, _, _ in recs]} images, rounds "
        f"{rounds}; labels and each image's rounds equal to the plain route "
        "on the card, bit for bit")
    return rounds


def label_sweep_row(calls, main_launches, row, rows):
    """The labelling kernel on path A's labelling call (recorded in
    ``capture_preprocessing``), bit for bit its plain route on the card
    and on CPU copies (``labelling_routes``); its row times the whole
    labelling, with its cluster size, shared memory a CTA and registers."""
    recs = calls["label_sweeps"]
    check(len(recs) == 1, f"path A: {len(recs)} labelling calls recorded")
    (args, _), = recs
    k_fn, p_fn, rounds, layout = labelling_routes(args, "path A")
    labels = args[0]
    log(f"label_sweep (path A): {tuple(labels.shape)} int32 images, "
        f"{len(args[2])} edge masks, rounds {rounds} (max_cc_iters "
        f"{args[4]}), layout {json.dumps(layout)}; labels and rounds equal "
        "to the plain route on the card and on CPU copies and across two "
        "launches")
    row("label_sweep", 0.0, k_fn, p_fn, 0.0, labelling_bytes(args),
        launches=main_launches["label_sweep"],
        extra={"unit": "the whole labelling (one launch)",
               "label_rounds": rounds, "shape": str(tuple(labels.shape)),
               "sweeps": [list(s) for s in args[3]], **layout,
               "registers": kernel_registers("label_sweep")})


def same_bits(a, b):
    """Equal dtypes, shapes and values, bit for bit where not NaN and NaN
    at the same places (torch.equal is false on any NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def routes_equal(name, args, label):
    """One projection kernel's wrapper on ``args`` against its plain
    version on the card, every output bit for bit (NaN where NaN), and
    across two launches; returns the outputs."""
    from quatro_tpu_torch.ops import range_image as ri

    got = getattr(ri, name)(*args)
    again = getattr(ri, name)(*args)
    ref = getattr(ri, f"{name}_plain")(*args)
    got_t, again_t, ref_t = ((t,) if torch.is_tensor(t) else tuple(t)
                             for t in (got, again, ref))
    check(all(same_bits(g, a) for g, a in zip(got_t, again_t)),
          f"{name} ({label}): differs between launches")
    check(all(same_bits(g, r) for g, r in zip(got_t, ref_t)),
          f"{name} ({label}): differs from its plain version on the card")
    return got


def with_specials(points, mask):
    """Copies of a batch of clouds with NaN and inf coordinates in valid
    and masked points, and cloud 0's last point alone far out at the end
    of the range quantisation (its packed word the sentinel where it is
    the last of 2^17 points)."""
    points, mask = points.clone(), mask.clone()
    last = mask.shape[1] - 1
    points[0, 3, 1] = float("nan")
    points[-1, 5] = float("nan")
    mask[-1, 5] = False
    points[0, 7, 0] = float("inf")
    points[-1, 9, 2] = -float("inf")
    points[0, 11] = torch.tensor([float("inf"), float("inf"), 1.0])
    points[0, last] = torch.tensor([125.0, 0.4, 0.0])
    mask[0, last] = True
    return points, mask


def projection_work(name, args):
    """(operations, bytes) of one call of a projection kernel's wrapper:
    OPS_RANGE_POINT a point; OPS_EDGE a (pixel, offset) and OPS_COMPOSE a
    composed mask; OPS_STATS a pixel; its inputs read once and its outputs
    written once (the sort's own traffic not counted)."""
    if name == "range_image":
        points, _, lidar = args[:3]
        bsz, n = points.shape[:2]
        npix = lidar.n_scan * lidar.horizon_scan
        return (float(bsz * n * OPS_RANGE_POINT),
                float(bsz * n * (12 + 1 + 8 + 8 + 4 + 1 + 8)
                      + bsz * npix * (4 + 8)))
    if name == "edge_masks":
        from quatro_tpu_torch.ops.range_image import is_4cross
        rimg, _, offsets = args[:3]
        pix = rimg.numel()
        comp = 4 if is_4cross(offsets) else 0
        return (float(pix * (len(offsets) * OPS_EDGE + comp * OPS_COMPOSE)),
                float(pix * (4 + 1 + len(offsets) + comp)))
    labels = args[0]
    return (float(labels.numel() * OPS_STATS),
            float(labels.numel() * (4 + 1 + 8 + 1 + 1)))


def projection_cases(calls, label):
    """The three projection kernels on one segment_cloud call's recorded
    operands (``calls``: capture_preprocessing's), each against its plain
    version on the card (``routes_equal``); the range image also with NaN
    and inf points and with a max_points prefix of half the valid points
    (and none), the edge masks also under the other two neighbour modes.
    Returns {name: operands}."""
    import dataclasses

    from quatro_tpu_torch.config import ProjectionConfig

    ops = {k: calls[k][0][0] for k in PROJECTION_KERNELS}
    points, mask, lidar, min_range, cap = ops["range_image"]
    half = max(1, int(mask.sum(1).min()) // 2)
    notes = {}
    for case, (p, m, c) in {"recorded": (points, mask, cap),
                            "nan_inf": (*with_specials(points, mask), cap),
                            "prefix": (points, mask, half),
                            "no_prefix": (points, mask, None)}.items():
        out = routes_equal("range_image", (p, m, lidar, min_range, c),
                           f"{label}, {case}")
        notes[case] = {"max_points": c, "owned": int((out[6] >= 0).sum()),
                       "nan_ranges": int(torch.isnan(out[2]).sum())}
    rimg, valid, offsets, sc_x, sc_y, theta = ops["edge_masks"]
    for mode in NEIGHBOR_MODES:
        offs = dataclasses.replace(ProjectionConfig(),
                                   neighbor_mode=mode).neighbor_offsets
        out = routes_equal("edge_masks", (rimg, valid, offs, sc_x, sc_y,
                                          theta), f"{label}, {mode}")
        notes[mode] = {"masks": out.shape[0], "edges": int(out.sum())}
    out = routes_equal("component_stats", ops["component_stats"], label)
    notes["components"] = int(out[1].sum())
    log(f"range_image, edge_masks, component_stats ({label}): equal to "
        "their plain versions on the card and across two launches, bit "
        "for bit (the range image also with NaN and inf points and "
        "prefixes, the edge masks under every neighbour mode): "
        + json.dumps(notes))
    return ops


def projection_kernel_rows(calls, main_launches, row):
    """The three projection kernels on path A's segment_cloud call
    (``projection_cases``), each with its row: the wrapper's device ms
    (every device event of the call, the sort's too) and the port's
    kernels' alone, bound from this call's shapes, no library call."""
    from quatro_tpu_torch.ops import range_image as ri

    ops = projection_cases(calls, "path A")
    for name in PROJECTION_KERNELS:
        args = ops[name]
        k_fn = (lambda f=getattr(ri, name), a=args: f(*a))
        p_fn = (lambda f=getattr(ri, f"{name}_plain"), a=args: f(*a))
        row(name, 0.0, k_fn, p_fn, *projection_work(name, args),
            launches=main_launches[name], prefix="",
            extra={"kernel_device_ms": device_ms_per_call(
                k_fn, "quatro::", main=(MAIN_KERNEL[name], 1)),
                   "shape": str(tuple(args[0].shape)),
                   "registers": kernel_registers(name)})


def overlap_work(p, pm, tgt, tm):
    """(operations, bytes) of one overlap call: OPS_OVERLAP per (valid
    source row, valid target point) of every leading entry; the kernel's
    operands read once and the int64 hits written once."""
    from quatro_tpu_torch.ops.overlap import kernel_operands

    lead = torch.broadcast_shapes(p.shape[:-2], tgt.shape[:-2],
                                  pm.shape[:-1], tm.shape[:-1])
    ops = kernel_operands(p, pm, tgt, tm, lead)
    pack, idx = ops[4].long(), ops[5].long()
    rows_valid = ops[1].sum(-1)[idx[1]].double()
    tgt_valid = ops[3].sum(-1)[pack[1]][idx[2]].double()
    pairs = (rows_valid * tgt_valid).sum()
    nbytes = sum(t.numel() * t.element_size() for t in ops) + 8 * idx.shape[1]
    return float(pairs) * OPS_OVERLAP, float(nbytes)


def overlap_extra(p, tgt):
    """The overlap call's plan (rows a thread, tiles, splits) and the
    kernels' registers, for its row."""
    from quatro_tpu_torch.ops.overlap import overlap_plan

    lead = math.prod(torch.broadcast_shapes(p.shape[:-2], tgt.shape[:-2]))
    plan = overlap_plan(lead, p.shape[-2], tgt.shape[-2],
                        torch.cuda.get_device_properties(
                            p.device).multi_processor_count)
    return {"plan_rows_tiles_splits": list(plan),
            "registers": kernel_registers("overlap_hits")}


def overlap_row(args, main_launches, row):
    """The overlap kernel on path A's arbitration call (6 poses on one
    pair), bit for bit its plain version on the card and on CPU copies and
    across two launches, then with a NaN in the first and in the last
    valid target point (no row hits: the min propagates it, as torch.amin
    does); its row."""
    from quatro_tpu_torch.ops.overlap import overlap_hits, overlap_hits_plain

    p, pm, tgt, tm, r2, row_block = args
    got = overlap_hits(*args)
    check(torch.equal(got, overlap_hits(*args)),
          "overlap hits differ between launches")
    check(torch.equal(got, overlap_hits_plain(*args)),
          "overlap hits differ from the plain version on the card")
    ref = overlap_hits_plain(*(t.cpu() for t in args[:5]), row_block)
    check(torch.equal(got.cpu(), ref),
          "overlap hits differ from the plain version on CPU copies")
    nan_hits = []
    valid_t = torch.nonzero(tm.reshape(-1))
    for where in (int(valid_t[0]), int(valid_t[-1])):
        t_nan = tgt.clone()
        t_nan.reshape(-1, 3)[where, 1] = float("nan")
        nan_args = (p, pm, t_nan, tm, r2, row_block)
        got_nan = overlap_hits(*nan_args)
        check(torch.equal(got_nan, overlap_hits_plain(*nan_args))
              and int(got_nan.max()) == 0,
              f"overlap hits with a NaN target point: {got_nan.tolist()}")
        nan_hits.append(got_nan.tolist())
    log(f"overlap_hits (path A): {tuple(p.shape)} posed source against "
        f"{tuple(tgt.shape)} target, hits {got.tolist()}, equal to the "
        "plain version on the card and on CPU copies and across two "
        "launches; with a NaN in the first / last valid target point "
        f"{nan_hits}, equal to the plain version")
    ops, nbytes = overlap_work(p, pm, tgt, tm)
    row("overlap_hits", float((got.cpu() - ref).abs().max()),
        lambda: overlap_hits(*args), lambda: overlap_hits_plain(*args),
        ops, nbytes, launches=main_launches["overlap_hits"],
        extra={"shape": f"{tuple(p.shape)} x {tuple(tgt.shape)}",
               **overlap_extra(p, tgt)})


def stage_kernel_rows_b64(seg_args, overlap_args, label):
    """The labelling, overlap and projection kernels at path P's B = 64
    shapes: the labelling, range image, edge masks and stats of its 128
    clouds (recorded from one segment_cloud on ``seg_args``;
    ``projection_cases``), the arbitration call's 384 (pair, pose) rows;
    each bit for bit its plain version on the card (the labelling also on
    CPU copies, with each image's rounds), with its device ms, call ms,
    plain ms and bound. Then the labels, feasibility, segment masks and
    rounds under every neighbour mode and at the cap
    (``segment_routes_equal``)."""
    from quatro_tpu_torch.ops import range_image as ri
    from quatro_tpu_torch.ops.overlap import overlap_hits, overlap_hits_plain
    from quatro_tpu_torch.preprocessing import projection

    with contextlib.ExitStack() as stack:
        recs = {k: stack.enter_context(recorded(projection, k, []))
                for k in ("label_sweeps", *PROJECTION_KERNELS)}
        projection.segment_cloud(*seg_args[0], **seg_args[1])
    (args, _, _), = recs.pop("label_sweeps")
    k_lab, p_lab, rounds, layout = labelling_routes(args, label)
    ops = projection_cases(recs, label)
    del recs
    check(torch.equal(overlap_hits(*overlap_args),
                      overlap_hits_plain(*overlap_args)),
          f"overlap_hits ({label}): differs from its plain version on the "
          "card")
    out = {}
    cases = [("label_sweep", k_lab, p_lab, (0.0, labelling_bytes(args)),
              tuple(args[0].shape),
              dict(layout, label_rounds_max=max(rounds),
                   label_rounds_sum=sum(rounds)), "quatro::"),
             ("overlap_hits", lambda: overlap_hits(*overlap_args),
              lambda: overlap_hits_plain(*overlap_args),
              overlap_work(*overlap_args[:4]),
              (tuple(overlap_args[0].shape), tuple(overlap_args[2].shape)),
              overlap_extra(overlap_args[0], overlap_args[2]), "quatro::")]
    for name in PROJECTION_KERNELS:
        a = ops[name]
        k_fn = (lambda f=getattr(ri, name), a=a: f(*a))
        cases.append((name, k_fn,
                      (lambda f=getattr(ri, f"{name}_plain"), a=a: f(*a)),
                      projection_work(name, a), tuple(a[0].shape),
                      {"kernel_device_ms": device_ms_per_call(
                          k_fn, "quatro::", main=(MAIN_KERNEL[name], 1))},
                      ""))
    for name, k_fn, p_fn, work, shape, extra, prefix in cases:
        b_ms, by = bound(*work)
        out[name] = dict({"shape": str(shape),
                          "device_ms": device_ms_per_call(
                              k_fn, prefix, main=(MAIN_KERNEL[name], 1)),
                          "ms": cuda_ms(k_fn), "plain_ms": cuda_ms(p_fn, 5),
                          "bound_ms": b_ms, "bound_by": by}, **extra)
    log(f"label_sweep / overlap_hits / range_image / edge_masks / "
        f"component_stats ({label}): " + json.dumps(out)
        + "; each equal to its plain version on the card")
    segment_routes_equal(seg_args, label)
    return out


def patchwork_run(points, mask, cfg):
    """One ``estimate_ground`` on the card, its fits uncaptured, with the
    three Patchwork wrappers recorded: (result, {name: [(arguments
    cloned, keyword arguments, result)]})."""
    from quatro_tpu_torch.preprocessing import patchwork
    from quatro_tpu_torch.utils import loops

    with contextlib.ExitStack() as stack:
        recs = {k: stack.enter_context(recorded(patchwork, k, []))
                for k in PATCHWORK_KERNELS}
        with loops.eager_loops():
            res = patchwork.estimate_ground(points, mask, cfg)
    return res, recs


def patchwork_kernels_equal(recs, label):
    """Each recorded call of the three Patchwork wrappers again: the
    wrapper twice and its plain version on the card on the same operands,
    every output bit for bit (NaN where NaN) and equal to the recorded
    call's. Returns {name: calls}."""
    from quatro_tpu_torch.ops import czm

    counts = {}
    for name in PATCHWORK_KERNELS:
        check(recs.get(name), f"{label}: no {name} call recorded")
        for k, (args, kwargs, out) in enumerate(recs[name]):
            runs = [out, getattr(czm, name)(*args, **kwargs),
                    getattr(czm, f"{name}_plain")(*args, **kwargs)]
            ref, again, plain = ((t,) if torch.is_tensor(t) else tuple(t)
                                 for t in runs)
            for what, other in (("a second launch", again),
                                ("its plain version on the card", plain)):
                check(len(other) == len(ref) and all(
                    same_bits(a, b) for a, b in zip(ref, other)),
                    f"{name} ({label}, call {k}): differs from {what}")
        counts[name] = len(recs[name])
    log(f"czm_points, seed_heights, plane_fit ({label}): calls "
        f"{json.dumps(counts)}, each equal across launches and to its "
        "plain version on the card, bit for bit")
    return counts


def patchwork_routes_equal(points, mask, cfg, label):
    """``estimate_ground`` with Patchwork's kernels and with their plain
    versions on the card (``sweep_route``, uncaptured): every field bit
    for bit, the kernels launched once, once and num_iter times on the
    kernel route and never on the plain one. Returns the ground points
    per cloud."""
    from quatro_tpu_torch.preprocessing import patchwork

    runs = []
    for plain in (False, True):
        before = launch_counts()
        with sweep_route(plain):
            res = patchwork.estimate_ground(points, mask, cfg)
        torch.cuda.synchronize()
        runs.append((res, _launch_diff(before)))
    (got, n_k), (ref, n_p) = runs
    for field, a, b in zip(got._fields, got, ref):
        check(same_bits(a, b), f"{label}: estimate_ground's {field} with "
              "the Patchwork kernels differs from the plain route")
    want = {"czm_points": 1, "seed_heights": 1, "plane_fit": cfg.num_iter}
    check(all(n_k[k] == v and n_p[k] == 0 for k, v in want.items()),
          f"{label}: Patchwork kernel launches {n_k} / {n_p}")
    return got.ground.sum(-1).tolist()


def patchwork_cases(points, mask, cfg, label):
    """Patchwork's three kernels on one ``estimate_ground`` call on
    (points, mask), under ``cfg`` and under ``PATCHWORK_VARIANT``: every
    recorded wrapper call bit for bit its plain version on the card
    (``patchwork_kernels_equal``), and the call's every field with the
    kernels bit for bit the plain route (``patchwork_routes_equal``).
    Returns the calls recorded under ``cfg``."""
    import dataclasses

    out, ground = {}, {}
    variant = dataclasses.replace(cfg, **PATCHWORK_VARIANT)
    for key, c in (("configured", cfg), ("variant", variant)):
        _, recs = patchwork_run(points, mask, c)
        patchwork_kernels_equal(recs, f"{label}, {key}")
        ground[key] = patchwork_routes_equal(points, mask, c,
                                             f"{label}, {key}")
        if key == "configured":
            out = recs
    log(f"estimate_ground ({label}, {tuple(points.shape)} points): with "
        "the Patchwork kernels equal to the plain routes on the card, every "
        f"field bit for bit, under its configuration and {PATCHWORK_VARIANT}"
        f"; ground points {json.dumps(ground)}")
    return out


def patchwork_work(name, args, kwargs):
    """(operations, bytes) of one Patchwork wrapper call: OPS_CZM_POINT a
    point, OPS_SEED_BIN a (patch, bin), OPS_PLANE_FIT a patch; the parts
    of its inputs that the kernel reads, once, and its outputs written
    once."""
    from quatro_tpu_torch.ops import czm

    if name == "czm_points":
        points, mask, cfg = args
        bsz, n = points.shape[:2]
        # the centre rows that the points gather (csrc/czm_points.cu)
        keep = mask & (points[..., 2] >= -1.8 * cfg.sensor_height)
        patch, _ = czm.czm_bin(points, keep, cfg)
        rows = torch.unique(torch.clamp(patch, 0, cfg.num_patches - 1))
        # points 12 and mask 1 in, 8 a centre row; ids, z-bins, five
        # channels, two weights and b0 out
        return (float(bsz * n * OPS_CZM_POINT),
                float(bsz * n * (13 + 4 + 4 + 20 + 8) + bsz * 4
                      + 8 * rows.numel()))
    if name == "seed_heights":
        hist, _, cfg = args
        bsz, _, p_pad, zbins = hist.shape
        p = cfg.num_patches
        # the P patches' counts and z sums and b0 in (not the rows past
        # P); lpr_h, live and every table row out
        return (float(bsz * p * zbins * OPS_SEED_BIN),
                float(bsz * 2 * p * zbins * 4 + bsz * 4 + bsz * p * 5
                      + bsz * p_pad * 20))
    sums, _, cfg = args[:3]
    bsz, p_pad, _ = sums.shape
    p = cfg.num_patches
    # the P patches' sums and the centres in, every table row out; the
    # last fit also reads the thresholds, the concentric indices and live,
    # and writes six planes' fields and accepted
    final = kwargs.get("final")
    return (float(bsz * p * OPS_PLANE_FIT),
            float(bsz * p * 10 * 4 + (5 if final else 2) * p * 4
                  + bsz * p_pad * 20
                  + ((24 + 1 + 1) * bsz * p if final else 0)))


def patchwork_fns(name, args, kwargs):
    """The wrapper's and the plain version's call on recorded operands."""
    from quatro_tpu_torch.ops import czm

    return ((lambda f=getattr(czm, name): f(*args, **kwargs)),
            (lambda f=getattr(czm, f"{name}_plain"): f(*args, **kwargs)))


def patchwork_kernel_rows(calls, main_launches, row):
    """Patchwork's three kernels on path A's ``estimate_ground`` operands
    (``patchwork_cases``), each with its row: plane_fit's on the exact
    last fit, with the bf16 trip's device ms in a CUDA graph and
    uncaptured; no library call."""
    (args, _), = calls["estimate_ground"]
    recs = patchwork_cases(*args, "path A")
    for name in PATCHWORK_KERNELS:
        a, kw, _ = recs[name][-1]
        k_fn, p_fn = patchwork_fns(name, a, kw)
        extra = {"shape": str(tuple(a[0].shape)),
                 "registers": kernel_registers(SOURCES[name].split("/")[-1]
                                               .split(".")[0])}
        if name == "plane_fit":
            trip, _ = patchwork_fns(name, *recs[name][0][:2])
            extra.update(bf16_device_ms_in_graph=graph_ms(trip),
                         bf16_device_ms_uncaptured=device_ms_per_call(
                             trip, "quatro::",
                             main=(MAIN_KERNEL[name], 1)))
        row(name, 0.0, k_fn, p_fn, *patchwork_work(name, a, kw),
            launches=main_launches[name], extra=extra)


def patchwork_rows_b64(args, label):
    """Patchwork's three kernels at path P's B = 64 shapes, on one
    ``estimate_ground`` call's operands (``patchwork_cases``): each bit
    for bit its plain version on the card, with its device ms, call ms,
    plain ms and bound (plane_fit's on the exact last fit)."""
    recs = patchwork_cases(*args, label)
    out = {}
    for name in PATCHWORK_KERNELS:
        a, kw, _ = recs[name][-1]
        k_fn, p_fn = patchwork_fns(name, a, kw)
        b_ms, by = bound(*patchwork_work(name, a, kw))
        out[name] = {"shape": str(tuple(a[0].shape)),
                     "device_ms": device_ms_per_call(
                         k_fn, "quatro::", main=(MAIN_KERNEL[name], 1)),
                     "ms": cuda_ms(k_fn), "plain_ms": cuda_ms(p_fn, 5),
                     "bound_ms": b_ms, "bound_by": by}
    log(f"czm_points / seed_heights / plane_fit ({label}): "
        + json.dumps(out) + "; each equal to its plain version on the card")
    return out


def patchwork_calls_equal(recs, label):
    """Each ``estimate_ground`` call of a path (``recorded``: its operands
    cloned, its result) against the plain route on the card
    (``sweep_route``) on the same operands: every field bit for bit.
    Returns each call's clouds."""
    from quatro_tpu_torch.preprocessing import patchwork

    check(len(recs) > 0, f"{label}: no estimate_ground call recorded")
    for k, (args, kwargs, out) in enumerate(recs):
        with sweep_route(True):
            ref = patchwork.estimate_ground(*args, **kwargs)
        for field, a, b in zip(out._fields, out, ref):
            check(same_bits(a, b), f"estimate_ground ({label}, call {k}): "
                  f"{field} differs from the plain route on the card")
    clouds = [int(a[0].shape[0]) if a[0].dim() == 3 else 1
              for a, _, _ in recs]
    log(f"estimate_ground ({label}): {len(recs)} calls of {clouds} clouds, "
        "every field equal to the plain route on the card, bit for bit")
    return clouds


# ------------------------------------------------------- clique stage --

def _clique_cases():
    """tests/torch_clique_cases.py (the graphs and clique rows the clique
    kernels are held on, and the stage's calls on one batch)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_clique_cases
    return torch_clique_cases


def clique_run(fn):
    """fn() with solver/clique.py's four clique wrappers recorded: (fn's
    result, {name: [(arguments cloned, keyword arguments, result)]})."""
    from quatro_tpu_torch.solver import clique

    with contextlib.ExitStack() as stack:
        recs = {k: stack.enter_context(recorded(clique, k, []))
                for k in CLIQUE_KERNELS}
        out = fn()
    return out, recs


def capture_cliques(pair, cfg):
    """The clique wrappers' calls of one more path A run (``clique_run``):
    one k-core search, growth and swap, two distinct greedies (the K
    clique hypotheses, the vote's)."""
    from quatro_tpu_torch.pipeline import register_scan_pair

    _, recs = clique_run(lambda: register_scan_pair(*pair, cfg))
    torch.cuda.synchronize()
    counts = {k: len(v) for k, v in recs.items()}
    check(counts == {k: MAIN_LAUNCHES[k] for k in CLIQUE_KERNELS},
          f"path A: clique wrapper calls {counts}")
    return recs


def _clique_args(name, args, kwargs):
    """A clique wrapper call's arguments by name, defaults filled in."""
    import inspect

    from quatro_tpu_torch.ops import cliques as tcl

    bound = inspect.signature(getattr(tcl, name)).bind(*args, **kwargs)
    bound.apply_defaults()
    return dict(bound.arguments)


def _as_tuple(out):
    return (out,) if torch.is_tensor(out) else tuple(out)


def clique_fns(name, args, kwargs):
    """The wrapper's and the plain version's call on recorded operands,
    each returning a tuple of tensors (the k-core search's packed graph
    left out; the plain versions take no packed graph)."""
    from quatro_tpu_torch.ops import cliques as tcl

    wrapper = getattr(tcl, name)
    plain = getattr(tcl, f"{name}_plain")
    plain_kw = {k: v for k, v in _clique_args(name, args, kwargs).items()
                if k != "packed"}
    keep = 3 if name == "kcore_search" else None
    return ((lambda: _as_tuple(wrapper(*args, **kwargs))[:keep]),
            (lambda: _as_tuple(plain(**plain_kw))))


def clique_calls_equal(recs, label):
    """Each recorded call of the four clique wrappers again: the wrapper
    once more and its plain version on the card (uncaptured) on the same
    operands, every output bit for bit equal to the recorded call's.
    Returns {name: calls}."""
    from quatro_tpu_torch.utils import loops

    counts = {}
    for name in CLIQUE_KERNELS:
        check(recs.get(name), f"{label}: no {name} call recorded")
        for k, (args, kwargs, out) in enumerate(recs[name]):
            k_fn, p_fn = clique_fns(name, args, kwargs)
            ref = _as_tuple(out)[:3 if name == "kcore_search" else None]
            with loops.eager_loops():
                plain = p_fn()
            for what, other in (("a second launch", k_fn()),
                                ("its plain version on the card", plain)):
                check(len(other) == len(ref) and all(
                    same_bits(a, b) for a, b in zip(ref, other)),
                    f"{name} ({label}, call {k}): differs from {what}")
        counts[name] = len(recs[name])
    log(f"kcore_search, grow_cliques, swap_cliques, distinct_cliques "
        f"({label}): calls {json.dumps(counts)}, each equal across launches "
        "and to its plain version on the card, bit for bit")
    return counts


def clique_cases():
    """The four clique kernels against their plain versions on the card
    on tests/torch_clique_cases.py's graphs (``CLIQUE_EDGE_CASES``: N = 1,
    33, 100, an all-False mask, an edgeless and a complete graph, self
    loops, an asymmetric graph, three pairs with a junk one, 195 miss-one
    vertices; two graphs at N = 2048) through ``clique_stage_calls`` (the
    k-core search, three growths, two swaps, two distinct greedies), and
    the distinct greedy on its row cases under both force_first: every
    output bit for bit. Logs where each kernel's packed rows sat."""
    from quatro_tpu_torch.ops import cliques as tcl
    from quatro_tpu_torch.utils import loops

    from quatro_tpu_torch.device import resolve_device

    cases = _clique_cases()
    dev = resolve_device()
    routes = {}
    for name in CLIQUE_EDGE_CASES:
        if name == "wide_2048":
            adj, mask = cases.wide_graphs(2, 2048, dev)
        else:
            adj, mask = (cases.miss_one_batch()[:2] if name == "miss_one"
                         else cases.graph_case(name))
            adj, mask = (torch.from_numpy(a).to(dev).contiguous()
                         for a in (adj, mask))
        tcl.reset_routes()
        got = cases.clique_stage_calls(adj, mask, tcl, True)
        routes[name] = {k: [r for r, c in v.items() if c]
                        for k, v in tcl.ROUTES.items()}
        with loops.eager_loops():
            ref = cases.clique_stage_calls(adj, mask, tcl, False)
        for call, outs in got.items():
            check(len(outs) == len(ref[call]) and all(
                same_bits(a, b) for a, b in zip(outs, ref[call])),
                f"clique cases, {name}: {call} differs from the plain "
                "version on the card")
    for name in ("random", "singletons", "all_false"):
        rows = torch.from_numpy(cases.distinct_case(name)).to(dev)
        for force_first in (False, True):
            got = tcl.distinct_cliques(rows, 4, force_first=force_first)
            ref = tcl.distinct_cliques_plain(rows, 4,
                                             force_first=force_first)
            check(all(same_bits(a, b) for a, b in zip(got, ref)),
                  f"clique cases, distinct rows {name}: differ from the "
                  "plain version on the card")
    check(routes["wide_2048"]["kcore_search"] == ["global"],
          f"clique cases: N = 2048's rows not read through L2: {routes}")
    log("clique kernels on tests/torch_clique_cases.py's graphs and rows: "
        "every output equal to the plain version on the card, bit for bit; "
        "packed rows (shared memory or L2) by case: " + json.dumps(routes))


def clique_work(name, args, kwargs):
    """(operations, bytes) of one clique wrapper call: the inputs its
    kernels read once and the outputs they write once. The k-core search
    packs the (B, N, N) bool graph (N^2 B bytes read) and writes its bits,
    rows and columns (B, N, ceil(N / 32)) int32 each; the growth reads
    both (its symmetry test and its column counts), the swaps the rows,
    and neither reads the bool graph. The operations are left at 0: the
    kernels' popcount rounds are dependent chains, bound by their latency
    and by one block a pair, which neither rate sees."""
    a = _clique_args(name, args, kwargs)
    if name == "distinct_cliques":
        c = a["cliques"]
        bsz, s, n = c.shape
        k = min(a["k"], s)
        return 0.0, float(c.numel() + bsz * k * (n + 4))
    bsz, n = a["mask"].shape
    bits = bsz * n * (-(-n // 32)) * 4  # one of rows, cols
    base = a["mask"].numel()
    if name == "kcore_search":          # lo, core, deg and the bits out
        return 0.0, float(base + a["adj"].numel()
                          + bsz * (8 + n + 4 * n) + 2 * bits)
    if name == "grow_cliques":          # scores, tiebreak in; cliques out
        s = min(a["num_seeds"], n)
        return 0.0, float(base + 2 * bits + 4 * bsz * n + 4 * n
                          + bsz * s * n)
    return 0.0, float(base + bits + 2 * a["cliques"].numel())


def clique_library(name, args, kwargs):
    """One round of the counting product that the kernel's loop replaces
    (``ops.cliques._count_mm``: a cuBLAS product over f32 0/1 operands),
    at this call's shape: (fn, label). Its operands are made once here,
    as the plain route makes them once a loop."""
    from quatro_tpu_torch.ops import cliques as tcl

    a = _clique_args(name, args, kwargs)
    if name == "distinct_cliques":
        cf = a["cliques"].float()
        return ((lambda: tcl._count_mm(cf, cf.transpose(-1, -2))),
                f"one product cf @ cf^T, {tuple(cf.shape)} f32")
    adj_f = a["adj"].float()
    bsz, n = a["mask"].shape
    if name == "kcore_search":
        alive = a["mask"].float()
        return ((lambda: tcl._count_mv(adj_f, alive)),
                f"one peel round's adj @ alive, ({bsz}, {n}, {n}) f32")
    if name == "grow_cliques":
        cand = adj_f[:, :min(a["num_seeds"], n)].contiguous()
        return ((lambda: tcl._count_mm(cand, adj_f)),
                f"one growth round's cand @ adj, {tuple(cand.shape)} f32")
    adj_t = adj_f.transpose(-1, -2)
    x = a["cliques"][:, :min(a["top"], a["cliques"].shape[1])].float()
    return ((lambda: x @ adj_t),
            f"one swap round's x @ adj^T, {tuple(x.shape)} f32")


def clique_kernel_rows(recs, main_launches, row):
    """The clique stage's four kernels on path A's calls
    (``capture_cliques``): each bit for bit its plain version on the card
    (``clique_calls_equal``) and on the edge cases (``clique_cases``), with
    its row on the call the main path makes first (the k-core search with
    its pack, the growth and swaps on its packed graph, the K hypotheses'
    distinct greedy); the library column one round's counting product."""
    from quatro_tpu_torch.ops import cliques as tcl

    clique_calls_equal(recs, "path A")
    clique_cases()
    for name in CLIQUE_KERNELS:
        a, kw, _ = recs[name][0]
        k_fn, p_fn = clique_fns(name, a, kw)
        lib_fn, lib_label = clique_library(name, a, kw)
        tcl.reset_routes()
        k_fn()
        extra = {"shape": str(tuple(a[0].shape)),
                 "registers": kernel_registers("cliques"),
                 "library": lib_label, "calls_path_a": len(recs[name]),
                 "packed_rows": [r for r, c in tcl.ROUTES[name].items()
                                 if c]}
        row(name, 0.0, k_fn, p_fn, *clique_work(name, a, kw), lib_fn,
            launches=main_launches[name], extra=extra)


def clique_rows_b64(recs, label):
    """The clique stage's four kernels at path P's B = 64 shapes, on one
    call's recorded operands: each bit for bit its plain version on the
    card (``clique_calls_equal``), with its device ms, call ms, plain ms,
    bound and one round's counting product."""
    clique_calls_equal(recs, label)
    out = {}
    for name in CLIQUE_KERNELS:
        a, kw, _ = recs[name][0]
        k_fn, p_fn = clique_fns(name, a, kw)
        lib_fn, lib_label = clique_library(name, a, kw)
        b_ms, by = bound(*clique_work(name, a, kw))
        out[name] = {"shape": str(tuple(a[0].shape)),
                     "device_ms": device_ms_per_call(
                         k_fn, "quatro::", main=(MAIN_KERNEL[name], 1)),
                     "ms": cuda_ms(k_fn), "plain_ms": cuda_ms(p_fn, 5),
                     "bound_ms": b_ms, "bound_by": by,
                     "library_ms": cuda_ms(lib_fn), "library": lib_label}
    log(f"kcore_search / grow_cliques / swap_cliques / distinct_cliques "
        f"({label}): " + json.dumps(out)
        + "; each equal to its plain version on the card")
    return out

# ---------------------------------------------------------------- ICP --

def _icp_module(name):
    import importlib
    return importlib.import_module(f"quatro_tpu_torch.{name}")


# each ICP kernel's wrapper and plain version: (module, wrapper)
ICP_FNS = {"radius_knn": ("ops.neighbors", "radius_neighbors"),
           "neighbor_normals": ("ops.normals", "estimate_normals"),
           "icp_correspond": ("ops.icp", "icp_correspond"),
           "icp_update": ("ops.icp", "icp_update")}


def icp_run(fn):
    """fn() under ``eager_loops()`` (each pass calls the wrappers from
    Python; a graph replay calls none) with ICP's four wrappers recorded
    where the path calls them: (fn's result, {kernel: [(arguments cloned,
    keyword arguments, result)]})."""
    from quatro_tpu_torch.utils import loops

    with contextlib.ExitStack() as stack:
        recs = {k: stack.enter_context(recorded(_icp_module(mod), attr, []))
                for k, (mod, attr) in ICP_CALLERS.items()}
        stack.enter_context(loops.eager_loops())
        out = fn()
    torch.cuda.synchronize()
    return out, recs


def capture_icp(pair, cfg):
    """ICP's wrapper calls of one more path A run (``icp_run``): the
    target's lists and normals once, the correspondences 13 times (12
    passes and the returned pose), the update 12 times."""
    from quatro_tpu_torch.pipeline import register_scan_pair

    _, recs = icp_run(lambda: register_scan_pair(*pair, cfg))
    counts = {k: len(v) for k, v in recs.items()}
    check(counts == {k: MAIN_LAUNCHES[k] for k in ICP_KERNELS},
          f"path A: ICP wrapper calls {counts}")
    return recs


def exact_bits(a, b):
    """Equal dtypes, shapes and bits (f32 through their int32 views, so
    -0.0 and NaN payloads count)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def icp_fns(name, args, kwargs):
    """The wrapper's and the plain version's call on recorded operands,
    each returning a tuple of tensors."""
    mod, fn = ICP_FNS[name]
    m = _icp_module(mod)
    wrapper, plain = getattr(m, fn), getattr(m, f"{fn}_plain")
    return ((lambda: _as_tuple(wrapper(*args, **kwargs))),
            (lambda: _as_tuple(plain(*args, **kwargs))))


def icp_calls_equal(recs, label):
    """Each recorded call of ICP's four wrappers again: the wrapper once
    more and its plain version on the card on the same operands, every
    output bit for bit the recorded call's. Returns {name: calls}."""
    counts = {}
    for name in ICP_KERNELS:
        check(recs.get(name), f"{label}: no {name} call recorded")
        for k, (args, kwargs, out) in enumerate(recs[name]):
            k_fn, p_fn = icp_fns(name, args, kwargs)
            ref = _as_tuple(out)
            for what, other in (("a second launch", k_fn()),
                                ("its plain version on the card", p_fn())):
                check(len(other) == len(ref) and all(
                    exact_bits(a, b) for a, b in zip(ref, other)),
                    f"{name} ({label}, call {k}): differs from {what}")
        counts[name] = len(recs[name])
    log(f"radius_knn, neighbor_normals, icp_correspond, icp_update "
        f"({label}): calls {json.dumps(counts)}, each equal across launches "
        "and to its plain version on the card, bit for bit")
    return counts


def icp_shape(name, args):
    """(batch, rows, columns or slots) of a recorded call."""
    if name == "radius_knn":
        return args[0].shape[0], args[0].shape[1], args[0].shape[1]
    if name == "neighbor_normals":
        return tuple(args[1].idx.shape)
    if name == "icp_correspond":
        return args[0].shape[0], args[0].shape[1], args[4].shape[1]
    return tuple(args[0].shape)


def icp_work(name, args):
    """(operations, bytes) of one ICP wrapper call on this run's data: the
    inputs read once, the outputs written once, and the distances the
    valid columns (targets) need, for every row."""
    from quatro_tpu_torch.ops.icp import ROW_WIDTH

    if name == "radius_knn":
        pts, mask, _, k = args[:4]
        bsz, n = mask.shape
        pairs = float(n * mask.sum())
        return pairs * OPS_KNN_PAIR, float(bsz * n * (12 + 1 + 9 * k))
    if name == "neighbor_normals":
        bsz, n, k = args[1].idx.shape
        return (float(bsz * n * (k * OPS_NORMAL_SLOT + OPS_NORMAL_POINT)),
                float(bsz * n * (12 + 5 * k + 17)))
    if name == "icp_correspond":
        src, tgt_ok, gates = args[0], args[5], args[7]
        bsz, ks, v = src.shape[0], src.shape[1], tgt_ok.shape[1]
        pairs = float(ks * tgt_ok.sum())
        return (pairs * OPS_CORR_PAIR + bsz * ks * OPS_CORR_ROW,
                float(bsz * ks * (13 + 4 * ROW_WIDTH + 1)
                      + bsz * v * 25 + bsz * 48 + 4 * gates.numel() + 8))
    bsz, ks = args[1].shape
    return (float(bsz * (ks * OPS_UPDATE_ROW + OPS_UPDATE_PAIR)),
            float(bsz * ks * (4 * ROW_WIDTH + 1) + bsz * 96 + 40))


def icp_library(name, args):
    """One PyTorch call computing the same function, where there is one
    (``torch.cdist`` + ``topk`` for the lists, + ``argmin`` for the
    correspondences; both on this call's operands, the pose applied
    first): (fn, label), else (None, None)."""
    from quatro_tpu_torch.ops.neighbors import _FLT_MAX

    if name == "radius_knn":
        pts, mask, _, k = args[:4]

        def lib():
            d = torch.cdist(pts, pts).square()
            d = torch.where(mask[..., None, :], d, _FLT_MAX)
            return torch.topk(d, k, dim=-1, largest=False)
        return lib, "cdist + topk"
    if name == "icp_correspond":
        src, _, rot, trans, tgt, tgt_ok = args[:6]

        def lib():
            p = src @ rot.transpose(-1, -2) + trans[..., None, :]
            d = torch.cdist(p, tgt).square()
            d = torch.where(tgt_ok[..., None, :], d, _FLT_MAX)
            return torch.argmin(d, dim=-1)
        return lib, "cdist + argmin"
    return None, None


def icp_blocks(name, args):
    """The blocks one launch runs (csrc/knn.cu: 16 rows a block of 512
    threads; csrc/neighbor_normals.cu: 8 points a block of 256;
    csrc/icp.cu: 8 source rows a block of 256, the update a block of 1024
    a pair) and the SMs they can spread over (at most 132)."""
    bsz, rows, _ = icp_shape(name, args)
    per = {"radius_knn": 16, "neighbor_normals": 8, "icp_correspond": 8}
    blocks = bsz * (-(-rows // per[name]) if name in per else 1)
    return {"blocks": blocks, "sms": min(blocks, 132)}


def icp_kernel_rows(recs, main_launches, row):
    """ICP's four kernels on path A's calls (``capture_icp``): each bit for
    bit its plain version on the card and across two launches
    (``icp_calls_equal``), with its row on the first call (the
    correspondences' and the update's of the first pass), the blocks
    each launch runs and, for the lists and the correspondences, the
    library call."""
    icp_calls_equal(recs, "path A")
    for name in ICP_KERNELS:
        a, kw, _ = recs[name][0]
        k_fn, p_fn = icp_fns(name, a, kw)
        lib_fn, lib_label = icp_library(name, a)
        extra = {"shape": str(icp_shape(name, a)),
                 "registers": kernel_registers(SOURCES[name].split("/")[-1]
                                               [:-3]),
                 "library": lib_label, "calls_path_a": len(recs[name]),
                 **icp_blocks(name, a)}
        row(name, 0.0, k_fn, p_fn, *icp_work(name, a), lib_fn,
            launches=main_launches[name], extra=extra)


def icp_substeps(pair, cfg, label):
    """The ``icp`` stage of one path A call split by sub-step: its
    ``refine_solution`` call recorded, then run again with a timer
    (raw voxels, lists, normals, passes, final), each sub-step's device
    busy ms and its device time and launches by kernel
    (``stage_device_busy``, ``log_stage_kernels``)."""
    from quatro_tpu_torch import pipeline

    with recorded(pipeline, "refine_solution", []) as calls:
        pipeline.register_scan_pair(*pair, cfg)
    args, kwargs, _ = calls[0]
    by_kernel = {}
    busy = stage_device_busy(lambda timer: pipeline.refine_solution(
        *args, **kwargs, timer=timer), by_kernel=by_kernel)
    log_stage_kernels(label, by_kernel)
    total = sum(ms for split in by_kernel.values() for _, ms in
                split.values())
    launches = sum(n for split in by_kernel.values() for n, _ in
                   split.values())
    log(f"{label}: device busy ms by sub-step " + json.dumps(busy)
        + f"; the stage {total:.3f} ms of device work in {launches} "
        f"launches (before ICP's kernels: {FORMER_ICP})")
    return busy


# ----------------------------------------------------------- matcher --

def match_run(fn):
    """fn() with the matcher's two wrappers recorded where ops/matching.py
    calls them, and the pipeline's ``match_features`` calls: (fn's result,
    {kernel: [(arguments cloned, keyword arguments, result)],
    "match_features": [...]})."""
    from quatro_tpu_torch import pipeline
    from quatro_tpu_torch.ops import matching

    with contextlib.ExitStack() as stack:
        recs = {k: stack.enter_context(recorded(matching, k, []))
                for k in MATCH_KERNELS}
        recs["match_features"] = stack.enter_context(
            recorded(pipeline, "match_features", []))
        out = fn()
    torch.cuda.synchronize()
    return out, recs


def capture_matching(pair, cfg, label):
    """The matcher's wrapper calls of one more run of ``pair`` under
    ``cfg`` (``match_run``): one call of each kernel."""
    from quatro_tpu_torch.pipeline import register_scan_pair

    _, recs = match_run(lambda: register_scan_pair(*pair, cfg))
    counts = {k: len(recs[k]) for k in MATCH_KERNELS}
    check(counts == dict.fromkeys(MATCH_KERNELS, 1),
          f"{label}: matcher wrapper calls {counts}")
    return recs


def match_fns(name, args, kwargs):
    """The wrapper's and the plain version's call on recorded operands,
    each returning a tuple of tensors."""
    from quatro_tpu_torch.ops import match_kernels as mk

    wrapper, plain = getattr(mk, name), getattr(mk, f"{name}_plain")
    return ((lambda: _as_tuple(wrapper(*args, **kwargs))),
            (lambda: _as_tuple(plain(*args, **kwargs))))


def match_calls_equal(recs, label):
    """Each recorded call of the matcher's two wrappers again: the wrapper
    once more and its plain version on the card on the same operands,
    every output bit for bit the recorded call's. Returns {name:
    calls}."""
    counts = {}
    for name in MATCH_KERNELS:
        check(recs.get(name), f"{label}: no {name} call recorded")
        for k, (args, kwargs, out) in enumerate(recs[name]):
            k_fn, p_fn = match_fns(name, args, kwargs)
            ref = _as_tuple(out)
            for what, other in (("a second launch", k_fn()),
                                ("its plain version on the card", p_fn())):
                check(len(other) == len(ref) and all(
                    exact_bits(a, b) for a, b in zip(ref, other)),
                    f"{name} ({label}, call {k}): differs from {what}")
        counts[name] = len(recs[name])
    ncorr = [int(n) for _, _, (_, nc) in recs["match_candidates"]
             for n in nc.tolist()]
    log(f"match_candidates, tuple_compact ({label}): calls "
        f"{json.dumps(counts)} (candidates a pair: {ncorr[:8]}"
        f"{' ...' if len(ncorr) > 8 else ''}), each equal across launches "
        "and to its plain version on the card, bit for bit")
    return counts


@contextlib.contextmanager
def plain_match_route():
    """ops/matching.py's two kernel wrappers swapped for their plain
    versions for the block."""
    from quatro_tpu_torch.ops import match_kernels as mk
    from quatro_tpu_torch.ops import matching

    saved = {k: getattr(matching, k) for k in MATCH_KERNELS}
    for k in MATCH_KERNELS:
        setattr(matching, k, getattr(mk, f"{k}_plain"))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(matching, k, v)


def match_branches(feat_call, label):
    """``match_features`` on one recorded pipeline call's keypoints and
    descriptors under each branch (the starvation fallback, crosscheck
    alone, the union without crosscheck), the pair batched with itself
    with its target cut to MATCH_STARVED valid keypoints (which starves
    under the fallback): the two kernels once each a call, every output
    bit for bit the plain route on the card."""
    from quatro_tpu_torch.ops import matching

    args, kwargs, _ = feat_call
    x = [a if a.dim() == (3 if i < 4 else 2) else a[None]
         for i, a in enumerate(args[:6])]
    tm = x[5][0]
    starved = tm & (torch.cumsum(tm.int(), 0) <= MATCH_STARVED)
    batch = [torch.cat([a[:1], a[:1]]) for a in x[:5]] + [
        torch.stack([tm, starved])]
    base = {k: v for k, v in kwargs.items()
            if k not in ("use_crosscheck", "crosscheck_min_matches")}
    kept = {}
    for branch, kw in (("fallback", dict(crosscheck_min_matches=64)),
                       ("crosscheck", dict(crosscheck_min_matches=0)),
                       ("union", dict(use_crosscheck=False))):
        before = launch_counts()
        got = matching.match_features(*batch, **base, **kw)
        diff = _launch_diff(before)
        check({k: diff[k] for k in MATCH_KERNELS}
              == dict.fromkeys(MATCH_KERNELS, 1),
              f"{label} ({branch}): matcher launches {diff}")
        with plain_match_route():
            ref = matching.match_features(*batch, **base, **kw)
        check(all(exact_bits(a, b) for a, b in zip(got, ref)),
              f"{label} ({branch}): the kernels' correspondences differ "
              "from the plain route's on the card")
        kept[branch] = got.mask.sum(-1).tolist()
    log(f"match_features ({label}): every branch on the pair and its "
        f"starving copy, correspondences kept {json.dumps(kept)}; each bit "
        "for bit the plain route on the card")
    return kept


def _live_triples(ncorr, tt, trials, seed):
    """Triples of the tuple test whose three members are candidates,
    summed over the pairs: what any tuple test of these inputs must
    evaluate."""
    from quatro_tpu_torch.ops.match_kernels import tuple_shifts

    shifts = tuple_shifts(tt, trials, seed)
    total = 0
    for n in ncorr:
        live = min(int(n), tt)
        i = np.arange(live)
        for s1, s2 in shifts:
            total += int((((i + s1) % tt < live) & ((i + s2) % tt < live))
                         .sum())
    return total


def match_work(name, args):
    """(operations, bytes) of one matcher wrapper call on this run's data:
    the candidates' neighbours and masks read once and the keys written
    once; the tuple test's live triples (``OPS_TRIPLE`` each), the prefix
    of keys, the candidates' coordinates read once and the outputs
    written once."""
    from quatro_tpu_torch.ops.match_kernels import FALLBACK, candidate_count

    if name == "match_candidates":
        sm, tm, mode = args[8], args[9], args[10]
        bsz, na = sm.shape
        nb = tm.shape[1]
        per = 8 * (2 if mode == FALLBACK else 1)
        return 0.0, float(bsz * ((na + nb) * (per + 1)
                                 + candidate_count(mode, na, nb) * 8 + 4))
    keys, ncorr, _, _, tt, cap, use_tuple, _, trials, seed = args[:10]
    nc = ncorr.tolist()
    live = sum(min(n, tt) for n in nc)
    ops = (_live_triples(nc, tt, trials, seed) * OPS_TRIPLE
           if use_tuple else 0)
    return (float(ops), float(keys.shape[0] * (tt * 8 + 4 + cap * 33)
                              + (live * 24 if use_tuple else 0)))


def match_library(name, args):
    """The compaction's library yardstick: one stable ``torch.sort`` of
    the prefix's keys and a ``gather`` of the first ``capacity`` (the
    candidate keys have none: None, None)."""
    if name != "tuple_compact":
        return None, None
    keys, tt, cap = args[0], args[4], args[5]
    prefix = keys[:, :tt]

    def lib():
        order = torch.sort(prefix, dim=-1, stable=True).indices
        return prefix.gather(-1, order[:, :cap])
    return lib, "torch.sort(stable=True) + gather"


def match_kernel_rows(recs, main_launches, row, recs_b, feats_b):
    """The matcher's two kernels: on path A's calls (``capture_matching``)
    and path B's (crosscheck alone) bit for bit their plain versions on
    the card and across two launches, every branch on path B's
    descriptors (``match_branches``), and their rows on path A's call with
    the blocks each launch runs (a block a pair) and, for the
    compaction, the library's sort and gather."""
    match_calls_equal(recs, "path A")
    match_calls_equal(recs_b, "path B")
    match_branches(feats_b, "path B")
    for name in MATCH_KERNELS:
        a, kw, _ = recs[name][0]
        k_fn, p_fn = match_fns(name, a, kw)
        lib_fn, lib_label = match_library(name, a)
        bsz = a[0].shape[0]
        extra = {"shape": str(tuple(a[0].shape)),
                 "registers": kernel_registers(SOURCES[name].split("/")[-1]
                                               [:-3]),
                 "library": lib_label, "blocks": bsz, "sms": min(bsz, 132)}
        row(name, 0.0, k_fn, p_fn, *match_work(name, a), lib_fn,
            launches=main_launches[name], extra=extra)


def match_rows_b64(recs, label):
    """The matcher's two kernels at path P's B = 64 call, on its recorded
    operands: bit for bit their plain versions on the card
    (``match_calls_equal``), with device ms, call ms, plain ms, bound and
    the compaction's library sort."""
    match_calls_equal(recs, label)
    out = {}
    for name in MATCH_KERNELS:
        a, kw, _ = recs[name][0]
        k_fn, p_fn = match_fns(name, a, kw)
        lib_fn, lib_label = match_library(name, a)
        b_ms, by = bound(*match_work(name, a))
        out[name] = {"shape": str(tuple(a[0].shape)),
                     "device_ms": device_ms_per_call(
                         k_fn, "quatro::", main=(MAIN_KERNEL[name], 1)),
                     "ms": cuda_ms(k_fn), "plain_ms": cuda_ms(p_fn, 5),
                     "bound_ms": b_ms, "bound_by": by,
                     "library_ms": cuda_ms(lib_fn) if lib_fn else None,
                     "library_device_ms": (device_ms_per_call(lib_fn,
                                                              tries=10)
                                           if lib_fn else None),
                     "library": lib_label}
    log(f"match_candidates / tuple_compact ({label}): " + json.dumps(out))
    return out


def b2_row_b64(args, label):
    """B2 with its pair axis at the vote's shape of one B = 64 call (its
    recorded operands, ids (B, E), vals (B, 3, E)): bit for bit its plain
    version on CPU copies, each pair's one-row call and a second launch;
    the kernel's device and call ms, its bound (the ids and values read
    once, the sums written once: bytes), and ``index_add_``'s device and
    call ms on the same ids and values (the pairs' bins side by side, a
    dump row for the dropped ids)."""
    from quatro_tpu_torch.ops import segment

    ids, vals, p_pad = args
    bsz, kv, n = vals.shape
    got = segment.segment_sums(ids, vals, p_pad)
    check(torch.equal(got, segment.segment_sums(ids, vals, p_pad)),
          f"{label}: B2 differs between launches")
    check(torch.equal(got.cpu(), segment.segment_sums_plain(
        ids.cpu(), vals.cpu(), p_pad, segment.SEG_CHUNK)),
        f"{label}: B2 differs from its plain version on CPU copies")
    check(all(torch.equal(got[b], segment.segment_sums(ids[b], vals[b],
                                                       p_pad))
              for b in range(bsz)),
          f"{label}: B2's pair axis differs from the one-row calls")
    live = (ids >= 0) & (ids < p_pad)
    off = torch.arange(bsz, device=ids.device)[:, None] * p_pad
    dest = torch.where(live, ids + off, bsz * p_pad).reshape(-1).long()
    src_rows = vals.transpose(1, 2).reshape(-1, kv).contiguous()

    def k_fn():
        return segment.segment_sums(ids, vals, p_pad)

    def lib():
        return torch.zeros((bsz * p_pad + 1, kv),
                           device=vals.device).index_add_(0, dest, src_rows)

    b_ms, by = bound(float(int(live.sum()) * kv),
                     bsz * n * 4 * (1 + kv) + bsz * p_pad * kv * 4)
    out = {"shape": f"ids ({bsz}, {n}), vals ({bsz}, {kv}, {n}), p_pad "
                    f"{p_pad}",
           "device_ms": device_ms_per_call(
               k_fn, "quatro::", main=(MAIN_KERNEL["segment_sums"], 1)),
           "ms": cuda_ms(k_fn), "bound_ms": b_ms, "bound_by": by,
           "library_ms": cuda_ms(lib),
           "library_device_ms": device_ms_per_call(lib, tries=10),
           "library": "index_add_"}
    log(f"segment_sums ({label}, the vote's B2 call with its pair axis; "
        "equal to its plain version on CPU copies and to each pair's "
        "one-row call, bit for bit): " + json.dumps(out))
    return out


@functools.lru_cache(maxsize=None)
def preset_pair(preset):
    """tests/test_torch_kernels_gpu.py's level_a pair of a lidar preset,
    ray-cast once: numpy (source, target)."""
    from quatro_tpu_torch.config import LidarConfig
    from quatro_tpu_torch.io.synthetic import make_scan_pair

    return make_scan_pair(seed=101, yaw_deg=38.0,
                          translation=(2.5, -1.2, 0.04),
                          lidar=LidarConfig.preset(preset))[:2]


def patchwork_preset_args(preset):
    """``estimate_ground``'s operands for a preset's raw pair (capacity
    RAW_CAPACITY) with tests/torch_czm_cases.py's special points (NaN and
    inf points, points on the CZM's edges, a kept point at +inf height in
    the second cloud: its z range, and so its seed stage's bins,
    unbounded) and an empty third cloud, on the card, with the preset's
    Patchwork configuration."""
    from quatro_tpu_torch.config import PipelineConfig
    from quatro_tpu_torch.device import resolve_device

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_czm_cases import czm_specials

    n = RAW_CAPACITY
    pts = torch.zeros(2, n, 3)
    mask = torch.zeros(2, n, dtype=torch.bool)
    for b, xyz in enumerate(preset_pair(preset)):
        xyz = xyz[:n]
        pts[b, :len(xyz)], mask[b, :len(xyz)] = torch.from_numpy(xyz), True
    cfg = PipelineConfig.for_lidar(preset).patchwork
    pts, mask = czm_specials(pts, mask, cfg)
    dev = resolve_device()
    return pts.to(dev), mask.to(dev), cfg


def loop_ring(m, n_inliers, n_outliers):
    """tests/test_parallel.py:101-138's ring of m poses (20 deg and
    (1.5, 0.5) m a step) with correspondences whose registration is edge k
    -> (k + 1) % m (src scan j, tgt scan i), and poses0 = ground truth +
    N(0, M_NOISE) with pose 0 exact. Returns numpy (src, tgt, mask,
    edge_i, edge_j, poses0, gt)."""
    from quatro_tpu_torch.io.synthetic import make_correspondences

    rng = np.random.default_rng(M_SEED)
    gt = np.zeros((m, 4), np.float32)
    for k in range(1, m):
        gt[k, 3] = gt[k - 1, 3] + np.deg2rad(20.0)
        gt[k, :2] = gt[k - 1, :2] + [1.5, 0.5]
    src, tgt = [], []
    for k in range(m):
        j = (k + 1) % m
        c, s = np.cos(gt[k, 3]), np.sin(gt[k, 3])
        dt = gt[j, :3] - gt[k, :3]
        a, b, _, _ = make_correspondences(
            seed=100 + k, n_inliers=n_inliers, n_outliers=n_outliers,
            yaw_deg=np.rad2deg(gt[j, 3] - gt[k, 3]),
            translation=(c * dt[0] + s * dt[1], -s * dt[0] + c * dt[1],
                         dt[2]))
        src.append(a)
        tgt.append(b)
    ei = np.arange(m, dtype=np.int32)
    init = gt + rng.normal(0, M_NOISE, gt.shape).astype(np.float32)
    init[0] = gt[0]
    return (np.stack(src).astype(np.float32), np.stack(tgt).astype(np.float32),
            np.ones((m, src[0].shape[0]), bool), ei, (ei + 1) % m, init, gt)


def composed_poses(sols, edge_i, edge_j, poses0, num_poses):
    """The unsharded composition's tail: the edges from the solutions
    (weight max(final inliers, 1), mask valid), then ``optimize_pose_graph``
    with no psum axis at path M's trip counts."""
    from quatro_tpu_torch.parallel.posegraph import (PoseGraphEdges,
                                                     optimize_pose_graph,
                                                     solution_to_edge)
    dev = sols.rotation.device
    t_meas, yaw = solution_to_edge(sols.translation, sols.rotation)
    weight = torch.clamp_min(sols.final_inlier_mask.sum(-1).float(), 1.0)
    edges = PoseGraphEdges(torch.as_tensor(edge_i, device=dev),
                           torch.as_tensor(edge_j, device=dev), t_meas, yaw,
                           weight, sols.valid)
    gn, cg = M_ITERS
    return edges, optimize_pose_graph(torch.as_tensor(poses0, device=dev),
                                      edges, num_poses, gn_iters=gn,
                                      cg_iters=cg)


def same_solution(got, ref, what):
    """Two RegistrationSolutions bit for bit; ``what`` names the pair."""
    diff = _differing_fields(got, ref)
    check(not diff, f"{what}: {diff} differ")


def phase_multichip(card, scans, gt, cfg, work_dir):
    """Path M, the multi-card step on one card: (a) on a one-rank NCCL
    group, ``make_full_pipeline_step`` over path S's frames as the ring of
    edges k -> (k + 1) % m, and ``make_loop_closing_step`` and
    ``sharded_register_batch`` on M_PAIRS correspondence pairs, each equal
    to the unsharded composition bit for bit, with its launches and
    collective profile; (b) M_RANKS gloo ranks sharing the card, each on
    its rows of the same pairs, against (a). Returns the raw-scan step's
    launch counts."""
    import torch.distributed as dist

    from quatro_tpu_torch import pipeline
    from quatro_tpu_torch.ops import launch
    from quatro_tpu_torch.parallel import (make_full_pipeline_step,
                                           make_loop_closing_step,
                                           optimize_pose_graph,
                                           sharded_register_batch)
    from quatro_tpu_torch.parallel.diagnostics import collective_profile
    from quatro_tpu_torch.parallel.distributed import (global_pairs_mesh,
                                                       initialize_multihost)
    from quatro_tpu_torch.pipeline import register_scan_pair
    from quatro_tpu_torch.preprocessing import projection
    from quatro_tpu_torch.solver.quatro import register_batch
    from quatro_tpu_torch.types import PointBatch
    from quatro_tpu_torch.utils import loops

    gn, cg = M_ITERS
    reduces = {"all-reduce": gn * (cg + 1)}
    m = len(scans)
    initialize_multihost(f"file://{work_dir}/store_nccl", num_processes=1,
                         process_id=0)
    try:
        check(dist.get_backend() == "nccl",
              f"path M: the group's backend is {dist.get_backend()}")
        mesh = global_pairs_mesh()
        dev = mesh.device
        log(f"path M: one-rank {dist.get_backend()} group, mesh "
            f"{mesh.size} rank {mesh.rank} on {dev}")

        # (a) the raw-scan ring through make_full_pipeline_step
        src = PointBatch(torch.stack([scans[(k + 1) % m].points
                                      for k in range(m)]),
                         torch.stack([scans[(k + 1) % m].mask
                                      for k in range(m)])).to(dev)
        tgt = PointBatch(torch.stack([sc.points for sc in scans]),
                         torch.stack([sc.mask for sc in scans])).to(dev)
        ei = np.arange(m, dtype=np.int32)
        ej = (ei + 1) % m
        rng = np.random.default_rng(M_SEED)
        poses0 = gt + rng.normal(0, M_NOISE, gt.shape).astype(np.float32)
        poses0[0] = gt[0]
        args = (src.points, src.mask, tgt.points, tgt.mask, ei, ej, poses0)
        step = make_full_pipeline_step(mesh, m, cfg, gn_iters=gn,
                                       cg_iters=cg)
        out = []
        torch.cuda.synchronize()
        launch.reset_launches()
        rounds0 = label_rounds()
        # each labelling and Patchwork call's operands cloned, for the
        # checks below
        with recorded(projection, "label_sweeps", []) as lab_calls, \
                recorded(pipeline, "estimate_ground", []) as pw_calls:
            prof, first_ms = _synced_ms(lambda: collective_profile(
                lambda: out.append(step(*args))))
        launches = launch_counts(rounds0)
        labelling_calls_equal(lab_calls, "path M (a)")
        patchwork_calls_equal(pw_calls, "path M (a)")
        del lab_calls, pw_calls
        expected = dict(MAIN_LAUNCHES, segment_sums=MAIN_LAUNCHES[
            "segment_sums"] + gn * (cg + 1))
        log(f"path M (a) raw-scan step, {m} pairs: launches "
            f"{json.dumps(launches)}; collectives {dict(prof)}")
        check(launches_match(launches, expected),
              f"path M: launch counts {launches} != {expected}")
        check(dict(prof) == reduces, f"path M: collectives {dict(prof)}")
        (poses, sols), = out
        ref = register_scan_pair(src, tgt, cfg).solution
        edges, ref_poses = composed_poses(ref, ei, ej, poses0, m)
        same_solution(sols, ref, "path M raw-scan step against the unsharded "
                      "composition")
        check(torch.equal(poses, ref_poses),
              "path M: the raw-scan step's poses differ from the "
              "unsharded composition")
        got = poses.cpu().numpy()
        ate = {name: float(np.sqrt(np.mean(np.sum(
            (p[:, :3] - gt[:, :3]) ** 2, axis=1))))
            for name, p in (("before", poses0), ("after", got))}
        log(f"path M (a): {int(sols.valid.sum())} of {m} edges valid, "
            f"final inliers {sols.final_inlier_mask.sum(-1).tolist()}, "
            f"ATE {ate['before']:.6f} -> {ate['after']:.6f} m")
        check(bool(np.isfinite(got).all()), "path M: non-finite pose")
        check(ate["after"] < 1.0, f"path M: ATE after {ate['after']} m")
        step_ms = [_synced_ms(lambda: step(*args))[1]
                   for _ in range(M_REPEATS)]
        p0 = torch.as_tensor(poses0, device=dev)
        pg_ms = [_synced_ms(lambda: optimize_pose_graph(
            p0, edges, m, gn_iters=gn, cg_iters=cg, psum_axis=mesh))[1]
            for _ in range(M_REPEATS)]
        # the pose graph's time apart: the same solve with no axis, and
        # the all-reduces alone, one per J^T apply on a (m, 4) sum
        pg_none_ms = [_synced_ms(lambda: optimize_pose_graph(
            p0, edges, m, gn_iters=gn, cg_iters=cg))[1]
            for _ in range(M_REPEATS)]
        phase_loops(card, "path M (a) pose graph under the NCCL axis",
                    lambda: optimize_pose_graph(p0, edges, m, gn_iters=gn,
                                                cg_iters=cg,
                                                psum_axis=mesh))
        sums = torch.zeros((m, 4), device=dev)
        ar_ms = [_synced_ms(lambda: [dist.all_reduce(sums) for _ in range(
            gn * (cg + 1))])[1] for _ in range(M_REPEATS)]
        wall = _spread(step_ms)["median"]
        pg = _spread(pg_ms)["median"]

        # (a) the loop-closing step and sharded registration, one rank
        ring = loop_ring(M_PAIRS, *M_CORR)
        src8, tgt8, mask8, ei8, ej8, init8, gt8 = ring
        reg = sharded_register_batch(mesh)
        regs = []
        check(collective_profile(lambda: regs.append(reg(src8, tgt8, mask8)))
              == {}, "path M: registration issued a collective")
        ref8 = register_batch(src8, tgt8, mask8)
        same_solution(regs[0], ref8, "path M sharded_register_batch against "
                      "the unsharded composition")
        step8 = make_loop_closing_step(mesh, M_PAIRS, gn_iters=gn,
                                       cg_iters=cg)
        out8 = []
        prof8 = collective_profile(lambda: out8.append(step8(
            src8, tgt8, mask8, ei8, ej8, init8)))
        check(dict(prof8) == reduces, f"path M: loop closing {dict(prof8)}")
        (poses8, sols8), = out8
        same_solution(sols8, ref8, "path M loop-closing step against the "
                      "unsharded composition")
        check(torch.equal(poses8, composed_poses(ref8, ei8, ej8, init8,
                                                 M_PAIRS)[1]),
              "path M: the loop-closing step's poses differ from the "
              "unsharded composition")
        err8 = np.linalg.norm(poses8[:, :3].cpu().numpy() - gt8[:, :3],
                              axis=1)
        check(float(err8.max()) < 0.25, f"path M: ring pose errors {err8}")
        lc_ms = [_synced_ms(lambda: step8(src8, tgt8, mask8, ei8, ej8,
                                          init8))[1]
                 for _ in range(M_REPEATS)]
    finally:
        # the graphs that captured this group's all-reduces go with it
        loops.clear_graphs()
        dist.destroy_process_group()

    # (b) M_RANKS gloo ranks on the one card, each on its rows
    data = os.path.join(work_dir, "ring.npz")
    np.savez(data, *ring)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--path-m-rank", str(r),
         str(M_RANKS), os.path.join(work_dir, "store_gloo"), data,
         os.path.join(work_dir, f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(M_RANKS)]
    deadline = time.monotonic() + M_RANK_LIMIT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        log(f"path M (b) rank {r}: " + text.strip()[-3000:])
        check(p.returncode == 0, f"path M: rank {r} exited {p.returncode}")
    gap = rows_r = rows_t = 0.0
    rank_ms = []
    for r in range(M_RANKS):
        got = np.load(os.path.join(work_dir, f"rank{r}.npz"))
        lo, hi = (int(x) for x in got["rows"])
        for name in ("valid", "max_clique_mask", "final_inlier_mask",
                     "num_rotation_inliers", "gnc_iterations"):
            check(np.array_equal(got[name],
                                 getattr(sols8, name)[lo:hi].cpu().numpy()),
                  f"path M: rank {r}'s {name} differs from one rank's")
        rows_r = max(rows_r, float(np.abs(
            got["rotation"] - sols8.rotation[lo:hi].cpu().numpy()).max()))
        rows_t = max(rows_t, float(np.abs(
            got["translation"]
            - sols8.translation[lo:hi].cpu().numpy()).max()))
        gap = max(gap, float(np.abs(got["poses"]
                                    - poses8.cpu().numpy()).max()))
        rank_ms.append(float(np.median(got["step_ms"])))
    log(f"path M (b): {M_RANKS} gloo ranks on one card: rows within "
        f"{rows_r:.3g} rad / {rows_t:.3g} m of one rank's, poses within "
        f"{gap:.3g} of one rank's")
    check(rows_r <= M_ROW_TOL[0] and rows_t <= M_ROW_TOL[1],
          "path M: a rank's rows left the pair axis's band")
    check(gap <= M_POSE_TOL, f"path M: all-reduced poses {gap} apart")
    log("path M times (ms; " + card + "): " + json.dumps({
        "raw_scan_step_first": round(first_ms, 3),
        "raw_scan_step": _spread(step_ms),
        "raw_scan_pairs_per_s": round(m / wall * 1e3, 3),
        "pose_graph": _spread(pg_ms),
        "pose_graph_share": round(pg / wall, 4),
        "pose_graph_no_axis": _spread(pg_none_ms),
        "all_reduces_alone": _spread(ar_ms),
        "collectives_per_step": dict(prof),
        "loop_closing_step_8_pairs": _spread(lc_ms),
        "loop_closing_pairs_per_s": round(
            M_PAIRS / _spread(lc_ms)["median"] * 1e3, 3),
        "gloo_rank_step": [round(x, 3) for x in rank_ms]}))
    return launches


def path_m_rank(rank, world, store, data, out):
    """One gloo rank of path M (b), started by ``phase_multichip`` as
    ``chip_smoke.py --path-m-rank rank world store data out``: its
    ``local_batch_slice`` of the ring through ``make_loop_closing_step`` on
    the card, its collective profile, two runs' bits; its rows, poses and
    step times saved to ``out``."""
    import torch.distributed as dist

    from quatro_tpu_torch.parallel import (make_loop_closing_step,
                                           sharded_register_batch)
    from quatro_tpu_torch.parallel.diagnostics import collective_profile
    from quatro_tpu_torch.parallel.distributed import (global_pairs_mesh,
                                                       initialize_multihost,
                                                       local_batch_slice)

    rank, world = int(rank), int(world)
    initialize_multihost(f"file://{store}", num_processes=world,
                         process_id=rank, backend="gloo")
    try:
        mesh = global_pairs_mesh()
        probe = torch.full((4,), float(rank + 1), device=mesh.device)
        dist.all_reduce(probe)            # gloo on a CUDA tensor
        check(bool((probe == world * (world + 1) / 2).all()),
              f"gloo all_reduce on the card gave {probe.tolist()}")
        ring = np.load(data)
        src, tgt, mask, ei, ej, init, _ = (ring[f"arr_{i}"] for i in range(7))
        sl = local_batch_slice(src.shape[0])
        local = [torch.from_numpy(a[sl]) for a in (src, tgt, mask, ei, ej)]
        gn, cg = M_ITERS
        step = make_loop_closing_step(mesh, src.shape[0], gn_iters=gn,
                                      cg_iters=cg)
        check(collective_profile(sharded_register_batch(mesh), *local[:3])
              == {}, "registration issued a collective")
        out_ = []
        prof = collective_profile(lambda: out_.append(step(*local, init)))
        check(dict(prof) == {"all-reduce": gn * (cg + 1)},
              f"loop closing issued {dict(prof)}")
        poses, sols = out_[0]
        step_ms = []
        for _ in range(M_REPEATS):
            dist.barrier()
            again, ms = _synced_ms(lambda: step(*local, init))
            step_ms.append(ms)
            check(torch.equal(again[0], poses), "two runs differ")
        np.savez(out, rows=[sl.start, sl.stop], poses=poses.cpu().numpy(),
                 step_ms=step_ms, **{
                     name: getattr(sols, name).cpu().numpy() for name in (
                         "valid", "max_clique_mask", "final_inlier_mask",
                         "num_rotation_inliers", "gnc_iterations",
                         "rotation", "translation")})
        dist.barrier()
    finally:
        dist.destroy_process_group()
    log(f"rank {rank}: rows {sl.start}-{sl.stop}, profile {dict(prof)}, "
        f"step ms {[round(x, 3) for x in step_ms]}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import quatro_tpu_torch  # noqa: F401  (fails outside the repository)

    if sys.argv[1:2] == ["--path-m-rank"]:
        return path_m_rank(*sys.argv[2:])
    card = phase_device()
    phase_build()
    record_label_rounds()
    from quatro_tpu_torch.pipeline import register_features, register_scan_pair
    from quatro_tpu_torch.utils import loops
    graph_mem = {}

    def graphs_of(label, before):
        """The device loops' captures and their bytes since ``before``
        (cumulative), and the graphs kept at the end and their bytes."""
        graph_mem[label] = {k: loops.CAPTURED[k] - before[k] for k in before}
        graph_mem[label]["held_now"] = loops.held()
        return dict(loops.CAPTURED)

    mark = dict(loops.CAPTURED)
    pairs, gts, cfgs = full_width_case()
    res_a, launches_a, wall_a, stages_a = phase_pipeline(
        register_scan_pair, pairs["tilted"], gts["tilted"], cfgs["A"],
        "path A (main: ground alignment + ICP)", MAIN_LAUNCHES, PAIR_REPEATS,
        max_terr=0.05, max_rerr=0.01)
    check(bool(res_a.icp.converged), "path A: ICP did not converge")
    check({"leveling", "icp"} <= set(stages_a),
          f"path A: stages {sorted(stages_a)}")
    phase_loops(card, "path A", lambda: register_scan_pair(
        *pairs["tilted"], cfgs["A"]))
    calls = capture_preprocessing(pairs["tilted"], cfgs["A"])
    overlap_args = capture_overlap(pairs["tilted"], cfgs["A"])
    clique_recs = capture_cliques(pairs["tilted"], cfgs["A"])
    icp_recs = capture_icp(pairs["tilted"], cfgs["A"])
    match_recs = capture_matching(pairs["tilted"], cfgs["A"], "path A")
    mark = graphs_of("path A", mark)
    t0 = time.perf_counter()
    bench = (*bench_case(), time.perf_counter() - t0)
    res_b, launches_b, _, _ = phase_pipeline(
        register_scan_pair, pairs["raw"], gts["raw"], cfgs["B"],
        "path B (reference matcher, crosscheck_min_matches=0)",
        PATH_B_LAUNCHES, PATH_B_REPEATS, max_terr=0.6)
    match_recs_b = capture_matching(pairs["raw"], cfgs["B"], "path B")
    dev = res_b.solution.rotation.device
    corr8 = register_scan_pair(pair_batch([c[0] for c in bench[0]], dev),
                               pair_batch([c[1] for c in bench[0]], dev),
                               bench[1]).correspondences
    exact = phase_solver_modes(res_b, cfgs["B"], card, corr8)
    del corr8
    phase_teaser_fixture(cfgs["B"])
    mark = graphs_of("path B", mark)
    for entry, pair, cfg, name, expected, max_terr in (
            (register_scan_pair, "raw", "recommended",
             "earlier path (raw scans, recommended)", RECOMMENDED_LAUNCHES,
             0.6),
            (register_features, "stripped", "recommended",
             "earlier path (features, recommended)", FEATURES_LAUNCHES, 0.5),
            (register_features, "stripped", "single",
             "earlier path (features, single hypothesis)", SINGLE_LAUNCHES,
             0.5)):
        phase_pipeline(entry, pairs[pair], gts["raw"], cfgs[cfg], name,
                       expected, EARLIER_REPEATS, max_terr=max_terr)
    mark = graphs_of("earlier paths", mark)
    launches_s, jt_call, (scans, seq_gt) = phase_sequence(cfgs["A"], card)
    mark = graphs_of("path S", mark)
    os.makedirs(BUILD_DIR, exist_ok=True)
    work_dir = tempfile.mkdtemp(prefix="smoke_entry_", dir=BUILD_DIR)
    try:
        phase_entry(card, work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    mark = graphs_of("path E", mark)
    phase_profile(pairs["tilted"], cfgs["A"], wall_a, stages_a)
    rows = phase_kernels(res_a, cfgs["A"], launches_a, calls, res_b,
                         cfgs["B"], launches_b, jt_call, launches_s, exact,
                         overlap_args, clique_recs, icp_recs, match_recs,
                         match_recs_b)
    del calls, overlap_args, clique_recs, icp_recs, match_recs, match_recs_b
    mark = graphs_of("profile and kernels", mark)
    # last: its large batches and profiles leave the profiler missing
    # more events in the runs after them
    (graph_rows, graph_mem["path P, B = 64 (warm-up and timed calls)"],
     stage_rows, launches8) = phase_pair_axis(card, pairs, gts, cfgs["A"],
                                              bench)
    mark = graphs_of("path P", mark)
    work_dir = tempfile.mkdtemp(prefix="smoke_multichip_", dir=BUILD_DIR)
    try:
        launches_m = phase_multichip(card, scans, seq_gt, cfgs["A"],
                                     work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    graphs_of("path M", mark)
    log(f"device loops' graphs captured per path ({card}; graphs, and "
        "bytes: their static buffers plus the growth of the reserved "
        "memory during each capture, summed over the path's captures, "
        "evicted ones included; held_now: the graphs kept at the path's "
        "end, at most MAX_GRAPHS, and their capture bytes): "
        + json.dumps(graph_mem))
    for r in rows:
        if r["name"] == "consistency_graph":
            r["pair_axis"] = graph_rows
        if r["name"] in stage_rows:
            r["b64"] = stage_rows[r["name"]]
            r["launches_b8_call"] = launches8[r["name"]]
            r["label_rounds_b8_call"] = launches8["label_rounds"]
        r["launches_path_m"] = launches_m[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
