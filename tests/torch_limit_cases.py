"""Inputs at the first sizes past the card kernels' former limits, where
each kernel now takes its wide route: held against the JAX package on the
CPU (tests/test_torch_limits.py) and against their plain versions on the
card (tests/test_torch_limits_gpu.py, chip_smoke.py). Imports no JAX.

- the polish: N = 4097 points a row (and 8192 on the card);
- ICP's update: 8193 source rows;
- the neighbour lists and their normals: K = 65 and 96 (and 257 on the
  card, the block route);
- the CZM: nine zones;
- B8: five channels, and a histogram of more than 176 KB of rows;
- the leveling: 2^18 + 1 points a cloud;
- the growth: N = 4097 with max_size 4098 on a complete graph, the graph
  on which the JAX package's f32 test absorbs a non-clique, and (on the
  card) a complete graph of 20000 vertices, past the shared memory of the
  first design's arrays;
- the labelling: images of 1-11 rows wider than a cluster's shared memory
  holds (1 x 131071, 4 x 32767, 11 x 11915), on the card in a global
  workspace.
"""

import dataclasses

import numpy as np
import torch

from quatro_tpu_torch.config import PatchworkConfig, SolverConfig

import torch_polish_cases as pc

POLISH_N = 4097
ICP_ROWS = 8193
LIST_WIDTHS_PAST = (65, 96)
GROUND_N = (1 << 18) + 1
GROW_N = 4097
# past ~18600 vertices the first design's arrays left shared memory
GROW_WIDE_N = 20000
# images of few rows that no cluster's shared memory holds
NARROW_IMAGES = ((1, 131071), (4, 32767), (11, 11915))
# zones past the point kernel's parameter table of 8
NINE_ZONES = dict(num_zones=9,
                  num_sectors_each_zone=(16, 24, 32, 40, 48, 54, 48, 40, 32),
                  num_rings_each_zone=(2, 2, 2, 2, 3, 3, 3, 4, 4),
                  min_ranges_each_zone=(2.7, 6.0, 9.5, 13.0, 17.0, 22.0,
                                        30.0, 40.0, 55.0),
                  max_r=80.0)
# B8 past its first route: (K, a_pad, b_pad): five channels; two channels
# of 768 columns (32 rows x 2 x 768 floats = 192 KB > 176 KB)
HIST_SHAPES = {"k5": (5, 256, 128), "wide_bins": (2, 64, 768)}
HIST_N = 8192


def nine_zone_config() -> PatchworkConfig:
    return PatchworkConfig(**NINE_ZONES)


def polish_case(n: int = POLISH_N, opts=None):
    """One pair of n correspondences (80 inliers, the last seven slots
    masked off) with torch_polish_cases' six selections as its rows, in
    torch_polish_cases.polish_case's layout."""
    rng = np.random.default_rng(7)
    src, tgt, inl = pc._pair(0, n, 80, 0.05, (0.0, 0.0))
    mask = np.arange(n) < n - 7
    clique = torch.from_numpy(pc._rows(inl & mask, mask, rng)[None])
    return dict(src=torch.from_numpy(src[None]),
                tgt=torch.from_numpy(tgt[None]), clique=clique,
                valid=clique.sum(-1) > 1, scale=torch.ones(clique.shape[:2]),
                prior=torch.eye(3), has_prior=False,
                config=dataclasses.replace(SolverConfig(), **(opts or {})))


def wide_source(vox, vmask, rows: int = ICP_ROWS):
    """ICP's source past the update's 8192 rows: the source cloud's valid
    voxels repeated with a seeded jitter of 2 cm to ``rows`` points, the
    last three masked off. Returns (points (rows, 3), mask (rows,))."""
    pts = vox[0][vmask[0]].numpy()
    rng = np.random.default_rng(8193)
    reps = -(-rows // len(pts))
    src = np.concatenate([pts + rng.normal(0.0, 0.02, pts.shape)
                          for _ in range(reps)])[:rows].astype(np.float32)
    mask = np.arange(rows) < rows - 3
    return torch.from_numpy(src), torch.from_numpy(mask)


def histogram_inputs(name: str, seed: int = 5):
    """B8's inputs of a HIST_SHAPES case: ids (1, N) int32 out of range on
    both axes now and then, weights (1, K, N) f32 (a count channel, then
    heights). Returns (ids_a, ids_b, weights, a_pad, b_pad)."""
    k, a_pad, b_pad = HIST_SHAPES[name]
    rng = np.random.default_rng(seed)
    n = HIST_N
    ia = rng.integers(-2, a_pad + 3, n).astype(np.int32)
    ib = rng.integers(-2, b_pad + 3, n).astype(np.int32)
    w = np.concatenate([(rng.uniform(size=(1, n)) > 0.3),
                        rng.normal(-1.7, 0.4, (k - 1, n))]).astype(np.float32)
    return (torch.from_numpy(ia)[None], torch.from_numpy(ib)[None],
            torch.from_numpy(w)[None], a_pad, b_pad)


def ground_cloud(n: int = GROUND_N, seed: int = 18):
    """A tilted ground plane of n points (75 % ground, the rest clutter
    above it) and its ground mask, (n, 3) f32 and (n,) bool."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-40.0, 40.0, (n, 2))
    z = -1.7 + 0.03 * xy[:, 0] - 0.02 * xy[:, 1] + rng.normal(0, 0.02, n)
    ground = rng.uniform(size=n) < 0.75
    z = np.where(ground, z, z + rng.uniform(0.3, 3.0, n))
    pts = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    return torch.from_numpy(pts), torch.from_numpy(ground)


def complete_graph(n: int, missing=()):
    """(1, n, n) bool: every pair adjacent but those in ``missing``, no
    self loops; with seed scores that make vertex 0 the one seed."""
    adj = ~torch.eye(n, dtype=torch.bool)
    for u, v in missing:
        adj[u, v] = adj[v, u] = False
    scores = torch.zeros(1, n)
    scores[0, 0] = 1.0
    return adj[None], scores, torch.ones(1, n, dtype=torch.bool)


# The graph on which the JAX package's early completion rests on f32
# rounding: 6144 vertices, one edge missing among the seed's 6143
# candidates. The exact edge sum is 6143 * 6142 - 2 = 37730304; the f32
# product 6143 * 6142 (37730306, not a multiple of 4 past 2^25) rounds to
# that same number, so the f32 test absorbs a set that is no clique.
ROUNDING_N = 6144
ROUNDING_MISSING = ((1, 2),)


def narrow_labelling(rows: int, cols: int, mode: str = "4CrossNeighbor",
                     bsz: int = 2, seed: int = 0):
    """``label_sweeps``' arguments for bsz random rows x cols images under
    the projection's sweep schedule of ``mode``: (labels, valid, masks,
    sweeps, max_iters, npix) on the CPU; 80 % of the pixels valid, each
    labelled by its flat index (npix where invalid), each sweep's edges 97
    % of the valid pixels, none across the row boundary for dr != 0."""
    from quatro_tpu_torch.config import ProjectionConfig
    from quatro_tpu_torch.preprocessing.projection import sweep_schedule
    cfg = dataclasses.replace(ProjectionConfig(), neighbor_mode=mode)
    sched = sweep_schedule(rows, cols, cfg)
    rng = np.random.default_rng(seed + rows)
    npix = rows * cols
    valid = rng.random((bsz, rows, cols)) < 0.8
    labels = np.where(valid, np.arange(npix).reshape(rows, cols), npix)
    masks = []
    for dr, _, _ in sched:
        e = (rng.random((bsz, rows, cols)) < 0.97) & valid
        if dr != 0:
            e[:, rows - 1 if dr > 0 else 0] = False
        masks.append(torch.from_numpy(e))
    return (torch.from_numpy(labels.astype(np.int32)),
            torch.from_numpy(valid), masks, sched, cfg.max_cc_iters, npix)
