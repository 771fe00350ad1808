"""ICP's correspondence and Gauss-Newton passes as two kernels.

The JAX package runs ``refine_icp``'s passes inside one compiled
``lax.scan`` (``quatro_tpu/solver/icp.py:108-150``; no Pallas kernel
there). The port runs each pass as two launches, both captured in the
``fori`` device loop's CUDA graph (``solver/icp.py``):

- ``icp_correspond``: every source row of every pair at the current pose
  (csrc/icp.cu: a CTA a tile of 512 rows, four a thread, and a slice of
  the targets staged once for the tile; an f32 screen with a stated error
  bound leaves the exact distance to the few targets that can win; the
  slices' keys merged by a 64-bit integer atomic, the tile's last CTA
  writing its rows): p = R s + t, the first target of least squared
  distance (``ordered_sq_dists``' arithmetic), the gate read on the device
  at the loop's step, and per row what the update takes, ``[p x n, n, w,
  r]`` (w the Huber weight of the residual r, 0 where the row is not
  matched) and whether it matched. No (K, V) distance matrix is written.
- ``icp_update``: per pair (a block a pair) the 6 x 6 normal equations and
  gradient summed over the rows in ``fused.pairwise_sum``'s tree, the
  yaw-only DoF mask, the damping, ``_solve_spd``'s Gauss-Jordan, the
  ``min_correspondences`` gate, ``exp_so3`` and the update of the whole
  transform, and the step + 1.

For CUDA tensors a wrapper checks its inputs, launches on the current
stream and counts the launch in ``LAUNCHES``; for CPU tensors it runs its
plain version (``*_plain``, the torch code the pass ran before, now in this
stated arithmetic). There is no fallback between the two, and the kernels
equal their plain versions on the card bit for bit: every operation rounds
once, as the torch operation it stands for does there (the cross product
and the residual written out as separate products and sums, which a
fusing library kernel would contract).
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.launch import (LAUNCHES, check, launch, same_device,
                                         size_route)
from quatro_tpu_torch.ops.neighbors import ordered_sq_dists, sq_norms
from quatro_tpu_torch.utils.batch import gather_rows
from quatro_tpu_torch.utils.fused import f32, pairwise_sum
from quatro_tpu_torch.utils.se3 import exp_so3, rotate_points

_FLT_MAX = torch.finfo(torch.float32).max
ROW_WIDTH = 8          # [p x n (3), n (3), w, r] a source row
# rows of the update kernel's register fold (8 leaves a thread); more take
# its wide route, the same tree by tree.cuh's strided fold
UPDATE_MAX_ROWS = 8192
CORR_TILE = 512        # source rows a CTA of the correspondence kernel
# the correspondence kernel's keys and tickets, zero between launches, per
# (device, stream, words): kept for the process, since a captured ICP loop
# holds the pointer it was captured with
_CORR_SCRATCH: dict = {}


def _corr_scratch(dev: torch.device, bsz: int, ks: int) -> torch.Tensor:
    """B K int64 keys, then B ceil(K / CORR_TILE) int32 tickets, zeroed
    once; the kernel leaves them zero."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = 2 * bsz * ks + bsz * -(-ks // CORR_TILE)
    key = (dev.index, stream, words)
    buf = _CORR_SCRATCH.get(key)
    if buf is None:
        buf = _CORR_SCRATCH[key] = torch.zeros(words, dtype=torch.int32,
                                               device=dev)
    return buf


def _solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with a @ x = b for (..., n, n) symmetric positive definite a (the
    damped normal equations) and (..., n) b: Gauss-Jordan elimination
    without pivoting, in elementwise operations, so every system of a
    batch is solved in the same operations whatever the batch (torch's
    batched solvers pick their algorithm by the batch size on the card).
    Nothing is read back from the device."""
    n = a.shape[-1]
    m = torch.cat([a, b[..., None]], -1)                   # (..., n, n + 1)
    rows = torch.arange(n, device=a.device)[:, None]
    for j in range(n):
        pivot = m[..., j:j + 1, :] / m[..., j:j + 1, j:j + 1]
        m = torch.where(rows == j, pivot, m - m[..., :, j:j + 1] * pivot)
    return m[..., n]


def icp_correspond_plain(src, smask, rot, trans, tgt, tgt_ok, normals,
                         gates, step, huber_delta: float):
    """``icp_correspond`` in torch operations: rows (..., K, 8) and ok
    (..., K)."""
    dtype = src.dtype
    p = rotate_points(src, rot) + trans[..., None, :]              # (K, 3)
    d2 = torch.where(tgt_ok[..., None, :],
                     ordered_sq_dists(p, tgt, sq_norms(p), sq_norms(tgt)),
                     _FLT_MAX)                                     # (K, V)
    j = torch.argmin(d2, dim=-1)                                   # first min
    d2min = d2.gather(-1, j[..., None])[..., 0]
    gate = gates.gather(0, step)
    ok = smask & (d2min <= gate * gate)
    n = gather_rows(normals, j)
    d = p - gather_rows(tgt, j)
    (p0, p1, p2), (n0, n1, n2) = p.unbind(-1), n.unbind(-1)
    r = n0 * d[..., 0] + n1 * d[..., 1] + n2 * d[..., 2]
    absr = torch.abs(r)
    # a tensor numerator: `float / tensor` is reciprocal-then-multiply
    huber = torch.where(absr <= huber_delta, 1.0,
                        torch.full_like(absr, huber_delta)
                        / torch.clamp(absr, min=1e-12))
    w = ok.to(dtype) * huber
    rows = torch.stack([p1 * n2 - p2 * n1, p2 * n0 - p0 * n2,
                        p0 * n1 - p1 * n0, n0, n1, n2, w, r], -1)
    return rows, ok


def icp_correspond(src, smask, rot, trans, tgt, tgt_ok, normals, gates,
                   step, huber_delta: float):
    """Gated point-to-plane correspondences of a batch of pairs at its
    current pose: src (B, K, 3) with smask (B, K), rot (B, 3, 3), trans
    (B, 3), targets tgt (B, V, 3) with tgt_ok (B, V) and normals (B, V, 3),
    the gate schedule ``gates`` (T,) f32 read at ``step`` ((1,) int64, on
    the device). Returns rows (B, K, 8) f32 = [p x n, n, w, r] of each
    source row (p = R s + t, n the normal of its first nearest valid
    target, r = n . (p - q), w = ok * Huber(r)) and ok (B, K) bool:
    matched within the gate. A row with every target masked matches
    target 0 and is not ok; a NaN distance is the least (torch.argmin's).
    For CUDA tensors one launch of csrc/icp.cu (V >= 1); for CPU tensors
    ``icp_correspond_plain``."""
    if same_device(src, smask, rot, trans, tgt, tgt_ok, normals, gates,
                   step).type != "cuda":
        return icp_correspond_plain(src, smask, rot, trans, tgt, tgt_ok,
                                    normals, gates, step, huber_delta)
    bsz, ks, v = src.shape[0], src.shape[-2], tgt.shape[-2]
    check("src", src, (bsz, ks, 3))
    check("smask", smask, (bsz, ks), torch.bool)
    check("rot", rot, (bsz, 3, 3))
    check("trans", trans, (bsz, 3))
    check("tgt", tgt, (bsz, v, 3))
    check("tgt_ok", tgt_ok, (bsz, v), torch.bool)
    check("normals", normals, (bsz, v, 3))
    check("gates", gates, gates.shape)
    check("step", step, (1,), torch.int64)
    rows = torch.empty((bsz, ks, ROW_WIDTH), dtype=torch.float32,
                       device=src.device)
    ok = torch.empty((bsz, ks), dtype=torch.bool, device=src.device)
    if bsz and ks:
        if v == 0:
            raise ValueError("icp_correspond: no targets")
        launch("icp", src, smask, rot, trans, tgt, tgt_ok, normals, gates,
               step, bsz, ks, v, f32(huber_delta), rows, ok,
               _corr_scratch(src.device, bsz, ks))
        LAUNCHES["icp_correspond"] += 1
    return rows, ok


def icp_update_plain(rows, ok, rot, trans, step, dof, damping: float,
                     min_corr: int):
    """``icp_update`` in torch operations."""
    a, w, r = rows[..., :6], rows[..., 6], rows[..., 7]
    aw = a * w[..., None]
    # the normal equations' sums over K in one fixed order, so a pair of
    # a batch gets its own bits (a matrix product's order follows the
    # batch on the card)
    h = pairwise_sum(a[..., :, :, None] * aw[..., :, None, :], -3)
    g = pairwise_sum(aw * r[..., None], -2)
    # constrained GN for yaw_only: disabled DoF decoupled before the
    # solve (zero rows / columns / gradient, unit diagonal)
    h = h * (dof[:, None] * dof[None, :]) + torch.diag(1.0 - dof)
    g = g * dof
    lam = damping * (pairwise_sum(h.diagonal(dim1=-2, dim2=-1)) + 1.0)
    eye6 = torch.eye(6, dtype=rows.dtype, device=rows.device)
    delta = -_solve_spd(h + lam[..., None, None] * eye6, g)
    enough = ok.sum(-1) >= min_corr
    delta = torch.where(enough[..., None], delta, 0.0)
    # the Jacobian linearises about p = R src + t: the increment acts on
    # the whole transform
    dr = exp_so3(delta[..., :3])
    rot = rotate_points(dr, rot.transpose(-1, -2))                # dr @ rot
    trans = (rotate_points(trans[..., None, :], dr)[..., 0, :]
             + delta[..., 3:])                                     # dr @ t
    return rot, trans, step + 1


def icp_update(rows, ok, rot, trans, step, dof, damping: float,
               min_corr: int):
    """One damped Gauss-Newton update of each pair from ``icp_correspond``'s
    rows (B, K, 8) and ok (B, K): h = sum a^T (a w), g = sum (a w) r over
    the K rows in ``fused.pairwise_sum``'s tree, the DoF mask ``dof`` (6,)
    f32 ([wx, wy, wz, tx, ty, tz], 0 where yaw_only freezes it), lambda =
    damping (trace h + 1), the step left out where fewer than
    ``min_corr`` rows are ok; returns (exp(dw) R, exp(dw) t + dt, step +
    1). For CUDA tensors one launch of csrc/icp.cu's update kernel (a
    block a pair; past ``UPDATE_MAX_ROWS`` rows its wide route, counted in
    ``SIZE_ROUTES``); for CPU tensors ``icp_update_plain``."""
    if same_device(rows, ok, rot, trans, step, dof).type != "cuda":
        return icp_update_plain(rows, ok, rot, trans, step, dof, damping,
                                min_corr)
    bsz, ks = ok.shape
    check("rows", rows, (bsz, ks, ROW_WIDTH))
    check("ok", ok, (bsz, ks), torch.bool)
    check("rot", rot, (bsz, 3, 3))
    check("trans", trans, (bsz, 3))
    check("step", step, (1,), torch.int64)
    check("dof", dof, (6,))
    if rows.data_ptr() % 16:
        raise ValueError("icp_update: rows must start on 16 bytes")
    rot_out = torch.empty_like(rot)
    trans_out = torch.empty_like(trans)
    step_out = torch.empty_like(step)
    if bsz:
        launch("icp_update", rows, ok, rot, trans, step, dof, bsz, ks,
               f32(damping), int(min_corr), rot_out, trans_out, step_out)
        LAUNCHES["icp_update"] += 1
        size_route("icp_update", ks > UPDATE_MAX_ROWS)
    else:
        step_out.copy_(step + 1)
    return rot_out, trans_out, step_out
