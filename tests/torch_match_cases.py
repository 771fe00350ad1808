"""The inputs that the matcher's two kernels (ops/match_kernels.py's
match_candidates and tuple_compact) and B2's pair axis are held on:
against the JAX package on the CPU (tests/test_torch_match_kernels.py) and
against their plain versions on the card (tests/test_torch_kernels_gpu.py).
Made from seeds with numpy; imports no JAX.

- ``neighbor_case``: both directions' neighbours as the neighbour kernels
  write them (before the wrappers' fill), with masked rows, rows no valid
  column filled (f32 max) and, per pair, a chosen number of mutual pairs:
  so one pair of a batch can starve under the fallback's
  ``crosscheck_min_matches`` while another keeps its mutual pairs.
- ``tuple_case``: sorted candidate keys over keypoints of which a share
  are inliers of one rigid motion (their triples pass the tuple test) and
  the rest outliers, with each pair's candidate count.
- ``segment_case``: the vote's histogram entries at a pair axis, one pair
  with every id out of range.
"""

import numpy as np

FLT_MAX = float(np.finfo(np.float32).max)
# the tuple test and compaction: (tt, capacity, ncorr per pair, inlier
# share per pair, tuple test, tuple_min_keep): ncorr below tt; a pair whose
# tuple test collapses under tuple_min_keep (no inliers, few candidates);
# tt below capacity; no test
TUPLE_CASES = {
    "ncorr_below_tt": (2048, 512, (1500, 700), (0.3, 0.05), True, 8),
    "collapse": (2048, 512, (900, 25), (0.2, 0.0), True, 8),
    "tt_below_capacity": (300, 512, (300, 120), (0.4, 0.4), True, 8),
    "no_tuple_test": (2048, 512, (1500, 300), (0.3, 0.3), False, 8),
}


def neighbor_case(seed, bsz, na, nb, mutual, second=True):
    """(i_ab, d_ab, i_ba, d_ba, i_ab2, d_ab2, i_ba2, d_ba2, src_mask,
    tgt_mask) as numpy arrays, indices int32; ``mutual[b]`` rows of pair b
    made mutual nearest neighbours (before masking). Without ``second``
    the second neighbours are None."""
    rng = np.random.default_rng(seed)
    smask = rng.random((bsz, na)) < 0.9
    tmask = rng.random((bsz, nb)) < 0.9
    smask[:, na - na // 8:] = False             # a masked tail, as voxels
    i_ab = rng.integers(0, nb, (bsz, na)).astype(np.int32)
    i_ba = rng.integers(0, na, (bsz, nb)).astype(np.int32)
    for b, m in enumerate(mutual):
        rows = rng.choice(na, size=m, replace=False)
        cols = rng.choice(nb, size=m, replace=False)
        i_ab[b, rows], i_ba[b, cols] = cols, rows
    # distances on a 1/8 grid, ties included; some rows no column filled
    d_ab = (rng.integers(0, 4000, (bsz, na)) / 8.0).astype(np.float32)
    d_ba = (rng.integers(0, 4000, (bsz, nb)) / 8.0).astype(np.float32)
    d_ab[rng.random((bsz, na)) < 0.02] = FLT_MAX
    d_ba[rng.random((bsz, nb)) < 0.02] = FLT_MAX
    out = [i_ab, d_ab, i_ba, d_ba]
    if second:
        i_ab2 = rng.integers(0, nb, (bsz, na)).astype(np.int32)
        i_ba2 = rng.integers(0, na, (bsz, nb)).astype(np.int32)
        d_ab2 = (d_ab + rng.integers(0, 80, (bsz, na)) / 8.0).astype(
            np.float32)
        d_ba2 = (d_ba + rng.integers(0, 80, (bsz, nb)) / 8.0).astype(
            np.float32)
        d_ab2[rng.random((bsz, na)) < 0.05] = FLT_MAX
        d_ba2[rng.random((bsz, nb)) < 0.05] = FLT_MAX
        out += [i_ab2, d_ab2, i_ba2, d_ba2]
    else:
        out += [None] * 4
    return (*out, smask, tmask)


def _rotation(yaw, pitch):
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    return rz @ ry


def tuple_case(seed, bsz, n_cand, na, nb, ncorr, inlier_share):
    """(keys (B, n_cand) int64 sorted per row, ncorr (B,) int32, src_xyz
    (B, na, 3), tgt_xyz (B, nb, 3) f32). Pair b's first ncorr[b] slots
    are candidates, in increasing quality keys; a share
    ``inlier_share[b]`` of them pair a source keypoint with its image
    under one rigid motion (plus 2 cm noise), the others pair unrelated
    keypoints; the slots past them hold packed pairs under the invalid
    key."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-40, 40, (bsz, na, 3)).astype(np.float32)
    tgt = rng.uniform(-40, 40, (bsz, nb, 3)).astype(np.float32)
    keys = np.empty((bsz, n_cand), np.int64)
    m = min(na, nb)
    for b in range(bsz):
        rot = _rotation(rng.uniform(-np.pi, np.pi), rng.uniform(-0.1, 0.1))
        trans = rng.uniform(-5, 5, 3)
        n_in = int(round(ncorr[b] * inlier_share[b]))
        s = rng.integers(0, na, n_cand)
        t = rng.integers(0, nb, n_cand)
        inl = rng.choice(ncorr[b], size=n_in, replace=False)
        s[inl] = rng.choice(m, size=n_in, replace=False)
        t[inl] = s[inl]
        tgt[b, s[inl]] = (src[b, s[inl]].astype(np.float64) @ rot.T + trans
                          + rng.normal(0, 0.02, (n_in, 3))).astype(np.float32)
        q = np.sort(rng.integers(0, 1 << 30, ncorr[b]))
        hi = np.full(n_cand, (1 << 31) - 1, np.int64)
        hi[:ncorr[b]] = q
        keys[b] = (hi << 32) | ((s.astype(np.int64) << 15) + t)
        keys[b] = np.sort(keys[b])
    return keys, np.asarray(ncorr, np.int32), src, tgt


def segment_case(seed, bsz, n, k=3, p_pad=256, dead=(1,)):
    """(ids (B, N) int32, vals (B, K, N) f32): ids in [0, p_pad] (p_pad is
    the vote's dropped bin) and some below 0; the rows in ``dead`` all out
    of range."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2, p_pad + 1, (bsz, n)).astype(np.int32)
    for b in dead:
        ids[b] = p_pad + rng.integers(0, 3, n)
    vals = rng.normal(0, 10, (bsz, k, n)).astype(np.float32)
    return ids, vals
