"""The polish: chain TIMs, the yaw GNC and COTE as three kernels.

The JAX package runs the polish of every hypothesis inside one compiled
program (``quatro_tpu/solver/quatro.py:103-194``, vmapped over the
hypotheses): the chain order (``:56-70``), the GNC's ``lax.while_loop``
(``quatro_tpu/solver/rotation.py:79-148``, FGR's at ``:151-189``) and
COTE's multi-operand ``lax.sort`` and cumsums
(``quatro_tpu/solver/translation.py:31-148``); no Pallas kernel there.
The port runs it as three launches of csrc/polish.cu over the B x H
hypothesis rows, with no device loop and no host read:

- ``polish_chain``: a block a row. The chain order (the stable sort of
  ``where(mask, iota, n + iota)``, a block compaction), the cyclic
  successor ``leaf``, the chain mask, its length ``m``, and the two TIMs
  (``(a - b) * chain``, the target's then ``/ scale``), the source's
  levelled by the IMU prior where one is given. Every solver mode.
- ``gnc_yaw``: a block a row, the whole quasi-SO(3) GNC (GNC-TLS or FGR's
  graduated Geman-McClure): iteration 0 (mu's start, the noise-free
  stop), then each row to its own exit or the bound. The sums over the
  points are ``utils/fused.pairwise_sum``'s tree (the points padded to a
  power of two, halves added level by level).
- ``polish_cote``: a block a (row, axis), the row's last block finishing
  it (an integer ticket after a fence). The rotation composed with the
  prior, the rotation inliers chained, the selection compacted, COTE's
  source, then per axis the 2N events' stable sort (a bitonic sort of
  (order-preserving bits, index) keys in shared memory), the three
  series' prefix in XLA's blocked order (csrc/scan.cuh), the first
  minimum of the cost, the median or the weighted mean; last, the axes'
  inliers ANDed and scattered back, and the ``valid`` gating.
  ``cote_translation`` is the same kernel on given points
  (``solver/translation.solve_translation``).

For CUDA tensors a wrapper checks its inputs, launches on the current
stream and counts the launch in ``LAUNCHES`` and its route in
``SIZE_ROUTES``: rows of more than ``MAX_POINTS`` points take the kernels'
wide route (the chain's order and COTE's events in a global workspace,
the GNC's points recomputed from global memory and folded by
``tree.cuh``'s strided fold), bit for bit the same; for CPU tensors
``polish_chain``, ``polish_cote`` and ``cote_translation`` run their plain
versions (``*_plain``: the torch code of the polish before the kernels,
split at the same seams). ``gnc_yaw`` takes CUDA tensors only: the yaw's
plain version is solver/rotation.py's ``while_chunks`` loop, shared with
the SO(3) GNC, and ``solver/rotation.gnc_rotation_2d`` makes the choice.
The wrappers return plain tuples and this module imports nothing of the
solver. There is no fallback between the two routes, and the kernels
equal their plain versions on the card bit for bit: every operation
rounds once, as the torch operation it stands for does there (no
contraction; ``atan2f``, ``cosf``, ``sinf`` and the IEEE square root and
quotient, as torch's kernels call them).
"""

from __future__ import annotations

import numpy as np
import torch

from quatro_tpu_torch.ops.launch import (LAUNCHES, check, launch, same_device,
                                         size_route, stream_scratch)
from quatro_tpu_torch.utils import fused
from quatro_tpu_torch.utils.batch import gather_rows
from quatro_tpu_torch.utils.scan import prefix_sum
from quatro_tpu_torch.utils.se3 import rotate_points

# points a row of the kernels' first route (COTE's 8192 events in shared
# memory, the GNC's points in registers); wider rows take the wide route
MAX_POINTS = 4096
_ALGORITHMS = {"GNC_TLS": 0, "FGR": 1}


def _check_points(n: int) -> None:
    if n < 1:
        raise ValueError(f"the polish kernels take rows of at least 1 point, "
                         f"got {n}")


def _pow2(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def cote_block_words(n: int) -> int:
    """64-bit words of COTE's global workspace for one (row, axis) of a
    row of n > MAX_POINTS points: the 2N events and N candidates, padded to
    powers of two, as keys; the values, the prefix's levels (three series)
    and the selection as 32-bit words; the mask as bytes
    (csrc/polish.cu::cote_bytes)."""
    from quatro_tpu_torch.ops.voxel import level_words
    nbytes = ((_pow2(2 * n) + _pow2(n)) * 8
              + (2 * n + 3 * level_words(2 * n)) * 4 + n)
    return -(-nbytes // 8)


def _cote_work(rows: int, n: int, dev):
    """(workspace, words a block) for COTE's (row, axis) blocks: a global
    one past MAX_POINTS points a row, else none (shared memory)."""
    past = n > MAX_POINTS
    size_route("polish_cote", past)
    if not past:
        return 0, 0
    words = cote_block_words(n)
    return torch.empty(rows * 3 * words, dtype=torch.int64, device=dev), words


def _prior_rows(prior: torch.Tensor, b: int) -> torch.Tensor:
    """The prior for (B, H, ...) rows: (3, 3), or (B, 3, 3) as (B, 1, 3, 3)."""
    return prior.reshape(b, 1, 3, 3) if prior.dim() == 3 else prior


def _cote_beta(noise_bound: float, cbar2: float) -> float:
    """noise_bound * sqrt(cbar2) in f32, as solve_translation forms it on
    the device (both correctly rounded)."""
    return float(np.float32(noise_bound) * np.sqrt(np.float32(cbar2)))


# ----------------------------------------------------------------- chain --

def chain_order(inlier_mask: torch.Tensor):
    """Sorted clique indices + cyclic successor with static shapes
    (include/quatro.hpp:806,828-843), per row of (..., N) masks:
    positions 0..m-1 hold the clique indices ascending; leaf(i) =
    clique[(i+1) % m]. (order, leaf, chain mask, m)."""
    n = inlier_mask.shape[-1]
    iota = torch.arange(n, device=inlier_mask.device)
    order = torch.sort(torch.where(inlier_mask, iota, n + iota), dim=-1,
                       stable=True).indices
    m = inlier_mask.sum(-1)
    nxt = torch.where(iota + 1 < m[..., None], iota + 1, 0)
    return order, order.gather(-1, nxt), iota < m[..., None], m


def polish_chain_plain(src, tgt, clique_mask, scale, prior, has_prior: bool):
    """``polish_chain``'s plain version."""
    b, h, n = clique_mask.shape
    src_r = src[:, None].expand(b, h, n, 3)
    tgt_r = tgt[:, None].expand(b, h, n, 3)
    order, leaf, chain_mask, m = chain_order(clique_mask)
    chainf = chain_mask.to(src.dtype)[..., None]
    src_tims = (gather_rows(src_r, leaf) - gather_rows(src_r, order)) * chainf
    dst_tims = ((gather_rows(tgt_r, leaf) - gather_rows(tgt_r, order))
                * chainf / scale[..., None, None])
    if has_prior:
        # level the source with the IMU roll/pitch before the yaw solve
        src_tims = rotate_points(src_tims, _prior_rows(prior, b))
    return order, leaf, chain_mask, m, src_tims, dst_tims


def polish_chain(src, tgt, clique_mask, scale, prior, has_prior: bool):
    """The chain of every hypothesis row: src, tgt (B, N, 3) f32, one
    selection a row of clique_mask (B, H, N) bool, scale (B, H) f32, the
    prior (3, 3) or (B, 3, 3) f32 (applied to the source TIMs where
    ``has_prior``), all contiguous. Returns (order, leaf (B, H, N) int64,
    chain mask (B, H, N) bool, m (B, H) int64, src_tims, dst_tims (B, H,
    N, 3) f32). For CUDA tensors one launch of csrc/polish.cu's chain
    kernel, bit for bit ``polish_chain_plain``, which runs for CPU
    tensors."""
    if clique_mask.dim() != 3 or src.dim() != 3:
        raise ValueError(f"polish_chain takes (B, N, 3) points and (B, H, N) "
                         f"masks, got {tuple(src.shape)} and "
                         f"{tuple(clique_mask.shape)}")
    b, h, n = clique_mask.shape
    check("src", src, (b, n, 3))
    check("tgt", tgt, (b, n, 3))
    check("clique_mask", clique_mask, (b, h, n), torch.bool)
    check("scale", scale, (b, h))
    if prior.dim() == 3:
        check("prior", prior, (b, 3, 3))
    else:
        check("prior", prior, (3, 3))
    dev = same_device(src, tgt, clique_mask, scale, prior)
    if dev.type != "cuda":
        return polish_chain_plain(src, tgt, clique_mask, scale, prior,
                                  has_prior)
    _check_points(n)
    order = torch.empty((b, h, n), dtype=torch.int64, device=dev)
    leaf = torch.empty_like(order)
    chain_mask = torch.empty((b, h, n), dtype=torch.bool, device=dev)
    m = torch.empty((b, h), dtype=torch.int64, device=dev)
    src_tims = torch.empty((b, h, n, 3), dtype=torch.float32, device=dev)
    dst_tims = torch.empty_like(src_tims)
    if b * h:
        past = n > MAX_POINTS
        work = (torch.empty((b * h, n), dtype=torch.int32, device=dev)
                if past else 0)
        launch("polish", src, tgt, clique_mask, scale, prior, b, h, n,
               9 if prior.dim() == 3 else 0, int(bool(has_prior)), order,
               leaf, chain_mask, m, src_tims, dst_tims, work)
        LAUNCHES["polish_chain"] += 1
        size_route("polish_chain", past)
    return order, leaf, chain_mask, m, src_tims, dst_tims


# ------------------------------------------------------------------- yaw --

def _point_view(name, x, rows, n):
    """(x as (rows, N, 2), its row and point strides): the last axis
    unit-strided, the leading axes flattened without a copy."""
    if x.shape[-2:] != (n, 2):
        raise ValueError(f"{name}: expected (..., {n}, 2), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {x.dtype}")
    v = x.reshape(rows, n, 2)
    if v.stride(-1) != 1 or v.data_ptr() != x.data_ptr():
        raise ValueError(f"{name}: the coordinates must be unit-strided and "
                         "the rows one view")
    return v, v.stride(0), v.stride(1)


def gnc_yaw(src_xy, dst_xy, mask, noise_bound, gnc_factor: float = 1.4,
            max_iterations: int = 50, cost_threshold: float = 0.00011,
            algorithm: str = "GNC_TLS"):
    """The quasi-SO(3) GNC of every row, on CUDA tensors (the kernel of
    solver/rotation.gnc_rotation_2d, whose plain version is that module's
    loop): src_xy, dst_xy (..., N, 2) f32 (unit-strided coordinates; the
    TIMs' first two columns are a view), mask (..., N) bool, noise_bound a
    Python float or one f32 a row. Returns (rotation (..., 2, 2), weights,
    inliers (..., N), iterations (...) int32, cost (...)), ``GncResult``'s
    fields, from one launch of csrc/polish.cu's GNC kernel; ValueError
    for tensors off the card."""
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown rotation algorithm {algorithm!r}")
    lead, n = tuple(mask.shape[:-1]), mask.shape[-1]
    tensors = [src_xy, dst_xy, mask] + ([noise_bound]
                                        if torch.is_tensor(noise_bound)
                                        else [])
    if same_device(*tensors).type != "cuda":
        raise ValueError("gnc_yaw launches its kernel on CUDA tensors; for "
                         "others solver/rotation.gnc_rotation_2d runs its "
                         "plain loop")
    _check_points(n)
    rows = int(np.prod(lead, dtype=np.int64))
    src_v, src_rs, src_ps = _point_view("src_xy", src_xy, rows, n)
    dst_v, dst_rs, dst_ps = _point_view("dst_xy", dst_xy, rows, n)
    check("mask", mask, lead + (n,), torch.bool)
    nb_rows, nb = None, 0.0
    if torch.is_tensor(noise_bound):
        nb_rows = noise_bound.expand(lead).contiguous()
        check("noise_bound", nb_rows, lead)
    else:
        nb = float(noise_bound)
    dev = mask.device
    rotation = torch.empty(lead + (2, 2), dtype=torch.float32, device=dev)
    weights = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    inliers = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    iters = torch.empty(lead, dtype=torch.int32, device=dev)
    cost = torch.empty(lead, dtype=torch.float32, device=dev)
    if rows:
        past = n > MAX_POINTS
        work = (torch.empty(lead + (n,), dtype=torch.float32, device=dev)
                if past else 0)
        launch("gnc_yaw", src_v, dst_v, mask,
               nb_rows if nb_rows is not None else 0, rows, n, src_rs,
               src_ps, dst_rs, dst_ps, nb, _ALGORITHMS[algorithm],
               gnc_factor if algorithm == "GNC_TLS" else fused.recip(gnc_factor),
               int(max_iterations), float(cost_threshold),
               rotation, weights, inliers, iters, cost, work)
        LAUNCHES["gnc_yaw"] += 1
        size_route("gnc_yaw", past)
    return rotation, weights, inliers, iters, cost


# ------------------------------------------------------------------ cote --

def cote_axis_plain(x: torch.Tensor, beta: torch.Tensor, mask: torch.Tensor,
                   use_median: bool):
    """Truncated-LS consensus estimate per row of x (A, N) under its own
    mask row (or one (N,) mask for every row), with the same
    noise bound ``beta`` for every correspondence — the pipeline's case
    (the reference passes constant alphas, include/quatro.hpp:600-604), in
    which the reference's six running series collapse to three.
    Port of Quatro::estimate (include/quatro.hpp:618-747) with static
    shapes: masked correspondences are zero-weight events sorted last.
    Returns (estimates (A,), inliers (A, N)). COTE's plain version, the
    arithmetic the kernel keeps."""
    dtype, dev = x.dtype, x.device
    a, n = x.shape
    maskf = mask.to(dtype).expand(a, n)
    big = torch.finfo(dtype).max

    # 2N events: interval entries (+1) at x - beta, exits (-1) at x + beta
    values = torch.cat([x - beta, x + beta], dim=1)
    eps = torch.cat([maskf, -maskf], dim=1)
    src_idx = torch.cat([torch.arange(n, device=dev)] * 2)
    values = torch.where(eps != 0, values, big)
    order = torch.sort(values, dim=1, stable=True).indices
    eps_s = eps.gather(1, order)
    idx_s = src_idx[order]
    x_s = torch.cat([x, x], dim=1).gather(1, order) * torch.abs(eps_s)
    cs3 = prefix_sum(torch.stack([eps_s, eps_s * x_s,
                                  eps_s * x_s * x_s], dim=1))
    card, sum_x, sum_x2 = cs3[:, 0], cs3[:, 1], cs3[:, 2]
    total = maskf.sum(1, keepdim=True)
    inv_b2 = 1.0 / torch.clamp(beta * beta, min=1e-30)
    dot_w = card * inv_b2
    dot_xw = sum_x * inv_b2
    range_rem = beta * (total - card)

    x_hat = dot_xw / torch.where(dot_w == 0, 1.0, dot_w)
    cost = card * x_hat * x_hat + sum_x2 - 2.0 * sum_x * x_hat + range_rem
    valid_center = (card > 0.5) & (eps_s != 0)
    cost = torch.where(valid_center, cost, big)
    min_idx = torch.argmin(cost, dim=1)
    estimate = x_hat.gather(1, min_idx[:, None])[:, 0]

    if use_median:
        # reference median mode (quatro.hpp:714-730), including its
        # even-parity formula for odd counts
        n_card = card.gather(1, min_idx[:, None])[:, 0].to(torch.int64)
        j = torch.arange(n, device=dev)[None, :]
        back = min_idx[:, None] - j
        pos = torch.clamp(back, 0, 2 * n - 1)
        valid_j = (j < n_card[:, None]) & (back >= 0)
        cand = torch.where(valid_j, x.gather(1, idx_s.gather(1, pos)), big)
        cand = torch.sort(cand, dim=1).values
        lo = torch.clamp(n_card // 2 - 1, 0, n - 1)
        hi = torch.clamp(n_card // 2, 0, n - 1)
        median = 0.5 * (cand.gather(1, lo[:, None])[:, 0]
                        + cand.gather(1, hi[:, None])[:, 0])
        median = torch.where(n_card == 1, cand[:, 0], median)
        estimate = torch.where(n_card > 0, median, estimate)

    inliers = (torch.abs(x - estimate[:, None]) <= beta) & mask
    return estimate, inliers


def cote_translation_plain(src, dst, mask, noise_bound: float,
                           cbar2: float = 1.0, use_median: bool = True):
    """``cote_translation``'s plain version: the three axes' rows through
    ``cote_axis_plain``."""
    dtype = src.dtype
    beta = (torch.tensor(noise_bound, dtype=dtype, device=src.device)
            * torch.sqrt(torch.tensor(cbar2, dtype=dtype, device=src.device)))
    x = (dst - src).transpose(-1, -2)                   # (..., 3, N)
    n = x.shape[-1]
    est, inl = cote_axis_plain(x.reshape(-1, n), beta,
                               mask[..., None, :].expand(x.shape)
                               .reshape(-1, n), use_median)
    inl = inl.reshape(x.shape)
    return est.reshape(x.shape[:-1]), inl.all(dim=-2) & mask


def cote_translation(src, dst, mask, noise_bound: float, cbar2: float = 1.0,
                     use_median: bool = True):
    """COTE over the three axes of every row (solver/translation.py's
    ``solve_translation``): src, dst (..., N, 3) f32 and mask (..., N)
    bool, contiguous. Returns (translation (..., 3), inlier mask (...,
    N)), ``CoteResult``'s fields. For CUDA tensors one launch of
    csrc/polish.cu's COTE kernel on the given points (counted as
    ``polish_cote``), bit for bit ``cote_translation_plain``, which runs
    for CPU tensors."""
    lead, n = tuple(mask.shape[:-1]), mask.shape[-1]
    if same_device(src, dst, mask).type != "cuda":
        return cote_translation_plain(src, dst, mask, noise_bound, cbar2,
                                      use_median)
    _check_points(n)
    check("src", src, lead + (n, 3))
    check("dst", dst, lead + (n, 3))
    check("mask", mask, lead + (n,), torch.bool)
    rows = int(np.prod(lead, dtype=np.int64))
    dev = mask.device
    translation = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
    inliers = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    if rows:
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets, partials = stream_scratch(dev, stream, rows, 3 * rows)
        work, words = _cote_work(rows, n, dev)
        launch("cote", src, dst, mask, rows, n,
               _cote_beta(noise_bound, cbar2), int(bool(use_median)),
               tickets, partials, translation, inliers, work, words,
               stream=stream)
        LAUNCHES["polish_cote"] += 1
    return translation, inliers


def polish_cote_plain(src, tgt, scale, gnc_rotation, prior, gnc_inliers,
                      order, m, valid, noise_bound: float, cbar2: float,
                      use_median: bool, use_rot_inliers: bool):
    """``polish_cote``'s plain version."""
    b, h, n = order.shape
    dtype, dev = src.dtype, src.device
    src_r = src[:, None].expand(b, h, n, 3)
    tgt_r = tgt[:, None].expand(b, h, n, 3)
    if gnc_rotation.shape[-1] == 2:
        rotation = torch.eye(3, dtype=dtype, device=dev).repeat(b, h, 1, 1)
        rotation[..., :2, :2] = gnc_rotation
    else:
        rotation = gnc_rotation
    rotation = rotate_points(rotation,
                             _prior_rows(prior, b).transpose(-1, -2))  # R RyRx

    # rotation-inlier chaining (include/quatro.hpp:860-874)
    iota = torch.arange(n, device=dev)
    chain_mask = iota < m[..., None]
    prev = torch.where(iota == 0, torch.clamp(m - 1, min=0)[..., None],
                       iota - 1)
    rot_inliers = gnc_inliers & gnc_inliers.gather(-1, prev) & chain_mask
    num_rot_inliers = rot_inliers.sum(-1).to(torch.int32)

    # COTE translation (include/quatro.hpp:879-911)
    if use_rot_inliers:
        sel_mask = torch.where((num_rot_inliers > 0)[..., None], rot_inliers,
                               chain_mask)
    else:
        sel_mask = chain_mask
    pos_order = torch.sort(torch.where(sel_mask, iota, n + iota), dim=-1,
                           stable=True).indices
    cote_mask = iota < sel_mask.sum(-1, keepdim=True)
    sel_idx = order.gather(-1, pos_order)
    cote_t, cote_inl = cote_translation_plain(
        rotate_points(scale[..., None, None] * gather_rows(src_r, sel_idx),
                      rotation), gather_rows(tgt_r, sel_idx),
        cote_mask, noise_bound, cbar2, use_median)

    final_mask = torch.zeros_like(chain_mask).scatter(
        -1, sel_idx, cote_inl & cote_mask)
    eye = torch.eye(3, dtype=dtype, device=dev)
    return (torch.where(valid[..., None, None], rotation, eye),
            torch.where(valid[..., None], cote_t, 0.0),
            final_mask & valid[..., None], num_rot_inliers)


def polish_cote(src, tgt, scale, gnc_rotation, prior, gnc_inliers, order, m,
                valid, noise_bound: float, cbar2: float, use_median: bool,
                use_rot_inliers: bool):
    """Everything of the polish after the GNC, for every hypothesis row:
    src, tgt (B, N, 3) f32, scale (B, H) f32, the GNC's rotation (B, H, 2,
    2) (yaw) or (B, H, 3, 3) and inliers (B, H, N) bool, the prior (3, 3)
    or (B, 3, 3), ``polish_chain``'s order (B, H, N) int64 and m (B, H)
    int64, valid (B, H) bool, all contiguous; COTE's noise bound (the
    solver's ``noise_bound * cote_noise_bound_coeff``) and cbar2, the
    median mode, ``using_rot_inliers_when_estimating_cote``. Returns
    (rotation (B, H, 3, 3), R RyRx or the identity where not valid;
    translation (B, H, 3), 0 where not valid; the final inlier mask (B, H,
    N) bool; the rotation inliers' count (B, H) int32). For CUDA tensors
    one launch of csrc/polish.cu's COTE kernel (a block a row and axis),
    bit for bit ``polish_cote_plain``, which runs for CPU tensors."""
    if order.dim() != 3:
        raise ValueError(f"order: expected (B, H, N), got "
                         f"{tuple(order.shape)}")
    b, h, n = order.shape
    d = gnc_rotation.shape[-1]
    if d not in (2, 3):
        raise ValueError(f"gnc_rotation: expected (B, H, 2, 2) or (B, H, 3, "
                         f"3), got {tuple(gnc_rotation.shape)}")
    check("src", src, (b, n, 3))
    check("tgt", tgt, (b, n, 3))
    check("scale", scale, (b, h))
    check("gnc_rotation", gnc_rotation, (b, h, d, d))
    if prior.dim() == 3:
        check("prior", prior, (b, 3, 3))
    else:
        check("prior", prior, (3, 3))
    check("gnc_inliers", gnc_inliers, (b, h, n), torch.bool)
    check("order", order, (b, h, n), torch.int64)
    check("m", m, (b, h), torch.int64)
    check("valid", valid, (b, h), torch.bool)
    dev = same_device(src, tgt, scale, gnc_rotation, prior, gnc_inliers,
                      order, m, valid)
    if dev.type != "cuda":
        return polish_cote_plain(src, tgt, scale, gnc_rotation, prior,
                                 gnc_inliers, order, m, valid, noise_bound,
                                 cbar2, use_median, use_rot_inliers)
    _check_points(n)
    rotation = torch.empty((b, h, 3, 3), dtype=torch.float32, device=dev)
    translation = torch.empty((b, h, 3), dtype=torch.float32, device=dev)
    final_mask = torch.empty((b, h, n), dtype=torch.bool, device=dev)
    num_rot = torch.empty((b, h), dtype=torch.int32, device=dev)
    rows = b * h
    if rows:
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets, partials = stream_scratch(dev, stream, rows, 3 * rows)
        work, words = _cote_work(rows, n, dev)
        launch("polish_cote", src, tgt, scale, gnc_rotation, prior,
               gnc_inliers, order, m, valid, b, h, n, d,
               9 if prior.dim() == 3 else 0, _cote_beta(noise_bound, cbar2),
               int(bool(use_median)), int(bool(use_rot_inliers)), tickets,
               partials, rotation, translation, final_mask, num_rot, work,
               words, stream=stream)
        LAUNCHES["polish_cote"] += 1
    return rotation, translation, final_mask, num_rot
