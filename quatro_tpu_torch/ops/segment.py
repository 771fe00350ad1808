"""Segment sums and lookups over a small group axis: B2 and B8-B12.

Counterpart of ``quatro_tpu/ops/segment_matmul.py``. The TPU kernels
contract one-hot tiles on the MXU because the TPU has no cheap scatter or
gather; the CUDA kernels (``csrc/``) sum in shared memory in a fixed order
and gather directly. Each kernel has a wrapper that launches it for CUDA
tensors and counts the launch in ``LAUNCHES``, and a ``*_plain`` version
that the wrapper runs for CPU tensors; there is no fallback between the
two. The plain versions add in f32 in the kernels' order, through
``index_add_`` (never a matrix product, whose order follows the BLAS
blocking and thread count), so the sums equal the kernels' bit for bit on
CPU copies and nothing of (points x groups) size is ever built.

* ``segment_sums`` (B2): out[p, k] = sum over ids[i] == p of vals[k, i];
* ``cross_histogram`` (B8): the Patchwork seed stage's weighted 2-D
  (patch, z-bin) histogram;
* ``fit_iteration_moments`` (B9): one Patchwork plane-fit iteration, table
  delivery, membership and the ten moment sums fused;
* ``classify_points`` (B10): the final Patchwork code of every point;
* ``image_lookup`` (B11): out[i] = img[flat_ids[i]], a plain gather;
* ``table_lookup`` (B12): out[k, i] = tab[ids[i], k], a per-point row
  gather. No path of either package reaches the TPU kernel: its only
  callers are B9's and B10's fallbacks, taken off the TPU or where N is no
  multiple of 8192, and there it takes its einsum too. Here it is a public
  op of its own.

Every kernel takes a leading batch axis: B8-B12 the pipeline's source and
target as one batch of two, B2 the vote's pairs (its one-row form is the
pose graph's J^T apply).
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.launch import (LAUNCHES, active_limit, check,
                                         launch, same_device, stream_scratch)

SEG_CHUNK = 1024        # entries per block of B2 (its block size)
HIST_CHUNK = 8192       # points per partial histogram of B8
FIT_CHUNK = 1024        # points per partial moment table of B9
HIST_ROWS = 32          # histogram rows per block of B8 (shared memory)
_HIST_MAX_K = 4         # weight channels B8 stages
_SMEM_BYTES = 200 * 1024
_HIST_SMEM_BYTES = 176 * 1024   # B8's histogram rows; its lists take 42 KB
_MOMENTS = 10


def segment_sums_plain(ids: torch.Tensor, vals: torch.Tensor, p_pad: int,
                       chunk: int) -> torch.Tensor:
    """(B, p_pad, K) f32 for ids (B, N) and vals (B, K, N), or (p_pad, K)
    for ids (N,) and vals (K, N), in the kernel's order: per row and chunk
    of ``chunk`` consecutive entries, each bin adds its entries' values in
    index order starting from 0; then each row's chunk sums are added in
    chunk order, so a row's sums are those of a call on that row alone.
    The chunk sums come from one 1-D ``index_add_`` into zeroed rows, one
    row per (row, chunk, channel) with a dump bin for ids outside [0,
    p_pad): on the CPU ``index_add_`` adds in index order, so the result
    does not depend on torch's thread count, where a matrix product's
    order follows the BLAS blocking."""
    if ids.dim() == 1:
        return segment_sums_plain(ids[None], vals[None], p_pad, chunk)[0]
    bsz, k, n = vals.shape
    nch = -(-n // chunk)
    dev = ids.device
    key = torch.where((ids >= 0) & (ids < p_pad), ids, p_pad).long()
    row = ((torch.arange(bsz, device=dev)[:, None, None] * nch
            + (torch.arange(n, device=dev) // chunk)[None, None, :]) * k
           + torch.arange(k, device=dev)[None, :, None])
    part = vals.new_zeros(bsz * nch * k * (p_pad + 1)).index_add_(
        0, (row * (p_pad + 1) + key[:, None, :]).reshape(-1),
        vals.reshape(-1)).reshape(bsz, nch, k, p_pad + 1)
    out = vals.new_zeros((bsz, k, p_pad + 1))
    for c in range(nch):
        out = out + part[:, c]
    return out[..., :p_pad].transpose(1, 2).contiguous()


def segment_sums(ids: torch.Tensor, vals: torch.Tensor,
                 p_pad: int) -> torch.Tensor:
    """out[b, p, k] = sum over i with ids[b, i] == p of vals[b, k, i];
    ids (B, N) int32, vals (B, K, N) f32, any B, N, K and p_pad; ids
    outside [0, p_pad) are dropped. Returns (B, p_pad, K) f32, row b
    bit for bit the call on row b alone. ids (N,) and vals (K, N) are
    the one-row view and return (p_pad, K). Replaces
    segment_matmul.py::segment_sums with the pair axis jax.vmap gives it
    (csrc/segment_sums.cu, one launch per call); on the card the sums
    repeat bit for bit from run to run."""
    if ids.dim() == 1:
        k, n = vals.shape
        check("ids", ids, (n,), torch.int32)
        check("vals", vals, (k, n))
        return segment_sums(ids[None], vals[None], p_pad)[0]
    bsz, k, n = vals.shape
    check("ids", ids, (bsz, n), torch.int32)
    check("vals", vals, (bsz, k, n))
    dev = same_device(ids, vals)
    if dev.type != "cuda":
        return segment_sums_plain(ids, vals, p_pad, SEG_CHUNK)
    out = torch.empty((bsz, p_pad, k), dtype=torch.float32, device=dev)
    if bsz == 0 or p_pad == 0 or k == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = ticket = 0
    if n > SEG_CHUNK:
        # the rows' tickets and partials: B x chunks x p_pad x K words
        ticket, partial = stream_scratch(dev, stream, bsz,
                                         bsz * -(-n // SEG_CHUNK) * p_pad * k)
    launch("segment_sums", ids, vals, bsz, n, k, p_pad, SEG_CHUNK, partial,
           ticket, out, stream=stream)
    LAUNCHES["segment_sums"] += 1
    return out


# ----------------------------------------------------------------- B8 ----

def cross_histogram_plain(ids_a: torch.Tensor, ids_b: torch.Tensor,
                          weights: torch.Tensor, a_pad: int,
                          b_pad: int) -> torch.Tensor:
    """(B, K, a_pad, b_pad) f32: per chunk of HIST_CHUNK points an
    ``index_add_`` into a dump-extended bin axis, then the chunks added in
    order (the kernel's order; on the CPU ``index_add_`` adds in index
    order)."""
    bsz, k, n = weights.shape
    bins = a_pad * b_pad
    ok = (ids_a >= 0) & (ids_a < a_pad) & (ids_b >= 0) & (ids_b < b_pad)
    key = torch.where(ok, ids_a.long() * b_pad + ids_b.long(), bins)
    out = weights.new_zeros((bsz, k, bins + 1))
    for b in range(bsz):
        for s in range(0, n, HIST_CHUNK):
            for g in range(k):
                out[b, g] += weights.new_zeros(bins + 1).index_add_(
                    0, key[b, s:s + HIST_CHUNK], weights[b, g, s:s + HIST_CHUNK])
    return out[..., :bins].reshape(bsz, k, a_pad, b_pad)


def cross_histogram(ids_a: torch.Tensor, ids_b: torch.Tensor,
                    weights: torch.Tensor, a_pad: int,
                    b_pad: int) -> torch.Tensor:
    """Weighted 2-D histogram: out[b, k, a, c] = sum over i with
    ids_a[b, i] == a and ids_b[b, i] == c of weights[b, k, i]; ids (B, N)
    int32, weights (B, K, N) f32 (K <= 4), any N; ids out of range are
    dropped. Replaces segment_matmul.py::cross_histogram
    (csrc/cross_histogram.cu). The TPU kernel rounds the weights to bf16 on
    the MXU; this one adds in f32, in ``cross_histogram_plain``'s order, so
    it repeats bit for bit and equals the plain version on CPU copies bit
    for bit."""
    bsz, k, n = weights.shape
    check("ids_a", ids_a, (bsz, n), torch.int32)
    check("ids_b", ids_b, (bsz, n), torch.int32)
    check("weights", weights, (bsz, k, n))
    if same_device(ids_a, ids_b, weights).type != "cuda":
        return cross_histogram_plain(ids_a, ids_b, weights, a_pad, b_pad)
    if k > _HIST_MAX_K or HIST_ROWS * k * b_pad * 4 > _HIST_SMEM_BYTES:
        raise ValueError(f"cross_histogram kernel: K = {k} (at most "
                         f"{_HIST_MAX_K}) and b_pad = {b_pad} exceed its "
                         "shared memory")
    chunks = -(-n // HIST_CHUNK)
    partial = torch.empty((bsz, chunks, k, a_pad, b_pad),
                          dtype=torch.float32, device=weights.device)
    out = torch.empty((bsz, k, a_pad, b_pad), dtype=torch.float32,
                      device=weights.device)
    launch("cross_histogram", ids_a, ids_b, weights, bsz, n, k, a_pad, b_pad,
           HIST_CHUNK, partial, out)
    LAUNCHES["cross_histogram"] += 1
    return out


# ------------------------------------------------------- B9, B10, B12 ----

def table_lookup_plain(ids: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """out[b, k, i] = tab[b, ids[b, i], k], zeros for ids outside [0,
    p_pad), as one ``torch.gather``: B12's plain version, which B9's and
    B10's plain versions also use to deliver their rows. ids (B, N), tab
    (B, p_pad, K); returns (B, K, N)."""
    p_pad, k = tab.shape[1:]
    inr = (ids >= 0) & (ids < p_pad)
    idx = ids.clamp(0, p_pad - 1).long()[..., None].expand(-1, -1, k)
    rows = torch.gather(tab, 1, idx)
    return torch.where(inr[..., None], rows, 0.0).transpose(1, 2)


def table_lookup(ids: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """out[b, k, i] = tab[b, ids[b, i], k], zeros for ids outside [0,
    p_pad); ids (B, N) int32, tab (B, p_pad, K) f32, any N and K. Returns
    (B, K, N) f32, equal to ``table_lookup_plain`` bit for bit (the kernel
    only copies). Replaces segment_matmul.py::table_lookup
    (csrc/table_lookup.cu), which stages the table in shared memory and
    raises ValueError where it does not fit."""
    bsz, n = ids.shape
    p_pad, k = tab.shape[1:]
    check("ids", ids, (bsz, n), torch.int32)
    check("tab", tab, (bsz, p_pad, k))
    if same_device(ids, tab).type != "cuda":
        return table_lookup_plain(ids, tab)
    if p_pad * k * 4 > _SMEM_BYTES:
        raise ValueError(f"table_lookup kernel: a {p_pad} x {k} table exceeds "
                         "its shared memory")
    out = torch.empty((bsz, k, n), dtype=torch.float32, device=tab.device)
    if n == 0 or bsz == 0:
        return out
    launch("table_lookup", ids, tab, bsz, n, p_pad, k, out)
    LAUNCHES["table_lookup"] += 1
    return out


def _plane_proj(vals: torch.Tensor, chan: torch.Tensor) -> torch.Tensor:
    """(n1 * x + n2 * y) + n3 * z, each product and sum rounded once (the
    kernels' order, segment_matmul.py:283-284)."""
    return (vals[:, 0] * chan[:, 0] + vals[:, 1] * chan[:, 1]
            + vals[:, 2] * chan[:, 2])


def fit_moment_channels(ids: torch.Tensor, chan: torch.Tensor,
                        tab: torch.Tensor, p_cnt: int,
                        exact: bool) -> torch.Tensor:
    """(B, 10, N) moment channels of one plane-fit iteration: [1, px, py,
    pz, px px, px py, px pz, py py, py pz, pz pz] of member points (pz =
    z; zero elsewhere), membership ids < p_cnt and n . p < th under the
    delivered row [n1, n2, n3, th, _]; rounded to bf16 (to nearest even)
    when not exact (segment_matmul.py:267-274, 330-335)."""
    vals = table_lookup_plain(ids, tab)
    member = (ids < p_cnt) & (_plane_proj(vals, chan) < vals[:, 3])
    px, py, pz = chan[:, 3], chan[:, 4], chan[:, 2]
    mom = torch.stack([torch.ones_like(px), px, py, pz, px * px, px * py,
                       px * pz, py * py, py * pz, pz * pz], 1)
    mom = mom * member[:, None].to(mom.dtype)
    if not exact:
        mom = mom.to(torch.bfloat16).to(torch.float32)
    return mom


def fit_iteration_moments_plain(ids, chan, tab, p_pad: int, p_cnt: int,
                                exact: bool = True) -> torch.Tensor:
    """(B, p_pad, 10): the moment channels summed by patch id, in the
    kernel's order (``segment_sums_plain`` at FIT_CHUNK)."""
    mom = fit_moment_channels(ids, chan, tab, p_cnt, exact)
    return torch.stack([segment_sums_plain(ids[b], mom[b], p_pad, FIT_CHUNK)
                        for b in range(ids.shape[0])])


def fit_iteration_moments(ids: torch.Tensor, chan: torch.Tensor,
                          tab: torch.Tensor, p_pad: int, p_cnt: int,
                          exact: bool = True) -> torch.Tensor:
    """One fused Patchwork plane-fit iteration: deliver the per-patch row
    [n1, n2, n3, th, _] of tab to every point, test membership, and sum
    the ten moment channels by patch. ids (B, N) int32, chan (B, 5, N) f32
    [x, y, z, px, py], tab (B, p_pad, 5) f32 with zero rows past p_cnt.
    Returns (B, p_pad, 10) f32. Replaces
    segment_matmul.py::fit_iteration_moments
    (csrc/fit_iteration_moments.cu), which skips the points past
    ``fit_active_limit`` and equals the plain version bit for bit."""
    bsz, _, n = chan.shape
    check("ids", ids, (bsz, n), torch.int32)
    check("chan", chan, (bsz, 5, n))
    check("tab", tab, (bsz, p_pad, 5))
    if same_device(ids, chan, tab).type != "cuda":
        return fit_iteration_moments_plain(ids, chan, tab, p_pad, p_cnt,
                                           exact)
    return fit_iteration_moments_launch(ids, chan, tab, p_pad, p_cnt,
                                        exact)[0]


def fit_iteration_moments_launch(ids, chan, tab, p_pad: int, p_cnt: int,
                                 exact: bool = True):
    """The kernel's launch on CUDA tensors checked by
    ``fit_iteration_moments``: (out, lim), lim the pre-pass's active limit,
    equal to ``fit_active_limit`` (for the checks on the card)."""
    bsz, _, n = chan.shape
    dev = chan.device
    out = torch.empty((bsz, p_pad, _MOMENTS), dtype=torch.float32,
                      device=dev)
    lim = torch.empty((bsz,), dtype=torch.int32, device=dev)
    partial = torch.empty((bsz, -(-n // FIT_CHUNK), p_pad, _MOMENTS),
                          dtype=torch.float32, device=dev)
    launch("fit_iteration_moments", ids, chan, tab, bsz, n, p_pad, p_cnt,
           int(exact), FIT_CHUNK, lim, partial, out)
    LAUNCHES["fit_iteration_moments"] += 1
    return out, lim


def fit_active_limit(ids: torch.Tensor, p_pad: int,
                     p_cnt: int) -> torch.Tensor:
    """(B,) int32: one past the last point whose id lies in [0, min(p_cnt,
    p_pad)), B9's active limit (segment_matmul.py::_tile_limit at point
    granularity); the points past it add nothing."""
    return active_limit((ids >= 0) & (ids < min(p_cnt, p_pad)))


def classify_points_plain(ids, chan, tab, p_pad: int,
                          p_cnt: int) -> torch.Tensor:
    """(B, N) int32 codes: bit 0 ground, 1 nonground, 2 reverted, 3
    rejected, from the delivered [n1, n2, n3, th, flags] row
    (segment_matmul.py:357-367)."""
    return codes_from_rows(ids, chan, table_lookup_plain(ids, tab), p_cnt)


def codes_from_rows(ids, chan, vals, p_cnt: int) -> torch.Tensor:
    """``classify_points``' codes from rows already delivered to the
    points, vals (B, 5, N) as ``table_lookup`` gives them."""
    fl = (vals[:, 4] + 0.5).to(torch.int32)
    live = (ids < p_cnt) & ((fl & 8) > 0)
    isg = _plane_proj(vals, chan) < vals[:, 3]
    g = live & ((fl & 1) > 0) & isg
    ng = live & ~g
    rev = live & ((fl & 2) > 0) & isg
    rej = live & ((fl & 4) > 0) & isg
    return (g.to(torch.int32) + 2 * ng.to(torch.int32)
            + 4 * rev.to(torch.int32) + 8 * rej.to(torch.int32))


def classify_points(ids: torch.Tensor, chan: torch.Tensor, tab: torch.Tensor,
                    p_pad: int, p_cnt: int) -> torch.Tensor:
    """Final Patchwork classification, one int32 code per point (0 for
    dropped points); shapes as ``fit_iteration_moments``, tab's last
    column the patch flags. Replaces segment_matmul.py::classify_points
    (csrc/classify_points.cu)."""
    bsz, _, n = chan.shape
    check("ids", ids, (bsz, n), torch.int32)
    check("chan", chan, (bsz, 5, n))
    check("tab", tab, (bsz, p_pad, 5))
    if same_device(ids, chan, tab).type != "cuda":
        return classify_points_plain(ids, chan, tab, p_pad, p_cnt)
    out = torch.empty((bsz, n), dtype=torch.int32, device=chan.device)
    launch("classify_points", ids, chan, tab, bsz, n, p_pad, p_cnt, out)
    LAUNCHES["classify_points"] += 1
    return out


# ---------------------------------------------------------------- B11 ----

def image_lookup_plain(flat_ids: torch.Tensor, img: torch.Tensor, rows: int,
                       cols: int) -> torch.Tensor:
    """(B, N): img[b].flat[flat_ids[b, i]], 0 outside [0, rows * cols)."""
    npix = rows * cols
    inr = (flat_ids >= 0) & (flat_ids < npix)
    got = torch.gather(img.reshape(img.shape[0], npix), 1,
                       flat_ids.clamp(0, npix - 1).long())
    return torch.where(inr, got, 0)


def image_lookup(flat_ids: torch.Tensor, img: torch.Tensor, rows: int,
                 cols: int) -> torch.Tensor:
    """out[b, i] = img[b].flat[flat_ids[b, i]], 0 for ids outside [0,
    rows * cols); flat_ids (B, N) int32, img (B, rows, cols) int32 (the
    projection's packed pixel words, read directly: the TPU kernel's f32
    detour existed for the MXU). Replaces segment_matmul.py::image_lookup
    (csrc/image_lookup.cu)."""
    bsz, n = flat_ids.shape
    check("flat_ids", flat_ids, (bsz, n), torch.int32)
    check("img", img, (bsz, rows, cols), torch.int32)
    if same_device(flat_ids, img).type != "cuda":
        return image_lookup_plain(flat_ids, img, rows, cols)
    out = torch.empty((bsz, n), dtype=torch.int32, device=img.device)
    launch("image_lookup", flat_ids, img, bsz, n, rows * cols, out)
    LAUNCHES["image_lookup"] += 1
    return out
