"""FPFH (Fast Point Feature Histogram) 33-D descriptors.

PyTorch counterpart of ``quatro_tpu/ops/fpfh.py`` (PCL's
FPFHEstimation, src/teaser_utils/fpfh.cc:44-75): 3 Darboux angles x 11
bins = 33-D descriptors. It holds what the dense and kernel front ends
share (the Darboux features, the binning, the block normalisation) and
the K-capped two-pass FPFH over neighbour lists
(``ops/neighbors.radius_neighbors``), a public op of the JAX package that
no pipeline path calls: ``pair_features``, ``compute_spfh`` and
``compute_fpfh``, plain PyTorch on the device of their tensors (the JAX
functions are plain jnp, not Pallas).
"""

from __future__ import annotations

import math

import torch

from quatro_tpu_torch.utils.fused import recip

NUM_BINS = 11
FPFH_DIM = 3 * NUM_BINS


def _bin_index(f: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """floor(11 * (f - lo) / (hi - lo)) clipped to [0, 10], int32, the
    division taken as a multiplication by the f32 reciprocal of the width:
    the JAX package's compiled division by a constant, and the SPFH
    kernel's (csrc/spfh.cu), on the CPU and the card alike."""
    idx = torch.floor(NUM_BINS * (f - lo) * recip(hi - lo)).to(torch.int32)
    return torch.clamp(idx, 0, NUM_BINS - 1)


def normalize_blocks(fpfh: torch.Tensor) -> torch.Tensor:
    """Scale each 11-bin block of (..., 33) descriptors to sum 100 (PCL
    convention; an all-zero block stays zero)."""
    out = []
    for s in range(0, FPFH_DIM, NUM_BINS):
        block = fpfh[..., s:s + NUM_BINS]
        total = torch.clamp(block.sum(dim=-1, keepdim=True), min=1e-12)
        out.append(block * (100.0 / total))
    return torch.cat(out, dim=-1)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def darboux_features(d, d2, n_i, n_j, use_rsqrt: bool):
    """Darboux angle features of pairs (pcl::computePairFeatures
    semantics): d = p_j - p_i components, d2 = |d|^2, n_i / n_j normal
    components, each broadcastable to a common shape. Returns (f1 in
    [-pi, pi], f2, f3 in [-1, 1], frame-valid mask v_norm2 > 1e-20).
    use_rsqrt: the kernel form (rsqrt, products) of
    pallas_frontend.py:_spfh_body; else the dense form (sqrt, quotients)
    of dense_features.py and fpfh.py. Every product is a separate f32
    operation, as in the CUDA kernel (csrc/spfh.cu)."""
    if use_rsqrt:
        inv_dist = torch.rsqrt(torch.clamp(d2, min=1e-30))
        angle1 = _dot(n_i, d) * inv_dist
        angle2 = _dot(n_j, d) * inv_dist
    else:
        dist = torch.sqrt(torch.clamp(d2, min=1e-30))
        angle1 = _dot(n_i, d) / dist
        angle2 = _dot(n_j, d) / dist
    # the source normal is the one making the smaller angle with d
    swap = torch.abs(angle1) < torch.abs(angle2)
    n1s = tuple(torch.where(swap, n_j[k], n_i[k]) for k in range(3))
    n2s = tuple(torch.where(swap, n_i[k], n_j[k]) for k in range(3))
    ds = tuple(torch.where(swap, -d[k], d[k]) for k in range(3))
    f3 = torch.where(swap, -angle2, angle1)
    vv = _cross(ds, n1s)
    v_norm2 = _dot(vv, vv)
    inv = torch.rsqrt(torch.clamp(v_norm2, min=1e-30))
    vv = tuple(c * inv for c in vv)
    ww = _cross(n1s, vv)
    f2 = _dot(vv, n2s)
    f1 = torch.atan2(_dot(ww, n2s), _dot(n1s, n2s))
    return f1, f2, f3, v_norm2 > 1e-20


def pair_features(p1, n1, p2, n2):
    """Darboux angle features between oriented point-normal pairs, the
    JAX package's ``pair_features``: p1, n1, p2, n2 are component tuples
    (x, y, z), each broadcastable to a common shape. Returns (f1, f2, f3,
    valid): valid where the points differ and the frame is not
    degenerate."""
    d = tuple(p2[k] - p1[k] for k in range(3))
    d2 = _dot(d, d)
    f1, f2, f3, frame_ok = darboux_features(d, d2, n1, n2, use_rsqrt=False)
    return f1, f2, f3, (d2 > 0) & frame_ok


def _histogram11(bins: torch.Tensor, incr: torch.Tensor) -> list:
    """``incr`` summed into 11 bins along axis 1: 11 (N,) columns."""
    return [torch.where(bins == b, incr, 0.0).sum(1)
            for b in range(NUM_BINS)]


def compute_spfh(points: torch.Tensor, normals: torch.Tensor, nbrs,
                 normal_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point SPFH histograms (N, 33) over neighbour lists: each 11-bin
    block sums to 100 over the valid neighbour pairs (PCL's hist_incr =
    100 / num_pairs). points, normals (N, 3). normal_valid (N,): pairs
    with a point whose normal failed are left out (PCL emits NaN
    descriptors there and filters them)."""
    idx = nbrs.idx.long()
    p_i = tuple(points[:, c][:, None] for c in range(3))
    n_i = tuple(normals[:, c][:, None] for c in range(3))
    p_j = tuple(points[:, c][idx] for c in range(3))
    n_j = tuple(normals[:, c][idx] for c in range(3))

    f1, f2, f3, ok = pair_features(p_i, n_i, p_j, n_j)
    pair_ok = ok & nbrs.valid & (nbrs.dist2 > 1e-12)      # self left out
    if normal_valid is not None:
        pair_ok &= normal_valid[:, None] & normal_valid[idx]
    pair_ok = pair_ok.to(points.dtype)

    cnt = torch.clamp(pair_ok.sum(1), min=1.0)[:, None]
    incr = pair_ok * (torch.full_like(cnt, 100.0) / cnt)
    cols = (_histogram11(_bin_index(f1, -math.pi, math.pi), incr)
            + _histogram11(_bin_index(f2, -1.0, 1.0), incr)
            + _histogram11(_bin_index(f3, -1.0, 1.0), incr))
    return torch.stack(cols, dim=-1)


def compute_fpfh(points: torch.Tensor, normals: torch.Tensor, nbrs,
                 normal_valid: torch.Tensor | None = None) -> torch.Tensor:
    """FPFH descriptors (N, 33): the SPFH rows of the neighbours weighted
    by 1 / d^2 and summed, each 11-bin block normalised to 100.
    normal_valid (N,): neighbours with failed normals add neither angle
    pairs nor their SPFH rows."""
    spfh = compute_spfh(points, normals, nbrs, normal_valid)
    w_ok = nbrs.valid & (nbrs.dist2 > 1e-12)
    if normal_valid is not None:
        w_ok &= normal_valid[nbrs.idx.long()]
    d2 = torch.clamp(nbrs.dist2, min=1e-12)
    w = torch.where(w_ok, torch.full_like(d2, 1.0) / d2, 0.0)
    fpfh = (w[..., None] * spfh[nbrs.idx.long()]).sum(1)
    return normalize_blocks(fpfh)
