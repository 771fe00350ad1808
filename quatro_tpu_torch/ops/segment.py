"""Segment sums and lookups over a small group axis: B2 and B8-B11.

Counterpart of ``quatro_tpu/ops/segment_matmul.py``. The TPU kernels
contract one-hot tiles on the MXU because the TPU has no cheap scatter or
gather; the CUDA kernels (``csrc/``) sum in shared memory in a fixed order
and gather directly. Each kernel has a wrapper that launches it for CUDA
tensors and counts the launch in ``LAUNCHES``, and a ``*_plain`` version
that the wrapper runs for CPU tensors; there is no fallback between the
two. The plain versions compute in full f32 (never TF32), in blocks so that
nothing of (points x groups) size is ever built.

* ``segment_sums`` (B2): out[p, k] = sum over ids[i] == p of vals[k, i];
* ``cross_histogram`` (B8): the Patchwork seed stage's weighted 2-D
  (patch, z-bin) histogram;
* ``fit_iteration_moments`` (B9): one Patchwork plane-fit iteration, table
  delivery, membership and the ten moment sums fused;
* ``classify_points`` (B10): the final Patchwork code of every point;
* ``image_lookup`` (B11): out[i] = img[flat_ids[i]], a plain gather.

B8-B11 take a leading batch axis (the pipeline runs source and target as
one batch of two); B2 takes one segment problem.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.launch import LAUNCHES, check, launch, same_device

SEG_CHUNK = 1024        # entries per block of B2's first pass
HIST_CHUNK = 8192       # points per partial histogram of B8
FIT_CHUNK = 1024        # points per partial moment table of B9
HIST_ROWS = 32          # histogram rows per block of B8 (shared memory)
_HIST_MAX_K = 4         # weight channels B8 stages
_SMEM_BYTES = 200 * 1024
_PLAIN_ROWS = 8192      # entries per one-hot block of the plain versions
_MOMENTS = 10


def segment_sums_plain(ids: torch.Tensor, vals: torch.Tensor,
                       p_pad: int) -> torch.Tensor:
    """(p_pad, K) f32: the JAX package's off-TPU form, a one-hot
    contraction in full f32 (no TF32), in blocks of 8192 entries so the
    one-hot stays small."""
    k, n = vals.shape
    bins = torch.arange(p_pad, dtype=ids.dtype, device=ids.device)
    out = vals.new_zeros((p_pad, k))
    for s in range(0, n, _PLAIN_ROWS):
        oh = (ids[s:s + _PLAIN_ROWS, None] == bins[None, :]).to(vals.dtype)
        out += oh.T @ vals[:, s:s + _PLAIN_ROWS].T
    return out


def segment_sums(ids: torch.Tensor, vals: torch.Tensor,
                 p_pad: int) -> torch.Tensor:
    """out[p, k] = sum over i with ids[i] == p of vals[k, i]; ids (N,)
    int32, vals (K, N) f32, any N, K and p_pad; ids outside [0, p_pad)
    are dropped. Returns (p_pad, K) f32. Replaces
    segment_matmul.py::segment_sums (csrc/segment_sums.cu); on the card
    the sums repeat bit for bit from run to run."""
    k, n = vals.shape
    check("ids", ids, (n,), torch.int32)
    check("vals", vals, (k, n))
    if same_device(ids, vals).type != "cuda":
        return segment_sums_plain(ids, vals, p_pad)
    chunks = -(-n // SEG_CHUNK)
    partial = torch.empty((chunks, p_pad, k), dtype=torch.float32,
                          device=vals.device)
    out = torch.empty((p_pad, k), dtype=torch.float32, device=vals.device)
    launch("segment_sums", ids, vals, n, k, p_pad, SEG_CHUNK, partial, out)
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
    the MXU; this one adds in f32, and repeats bit for bit."""
    bsz, k, n = weights.shape
    check("ids_a", ids_a, (bsz, n), torch.int32)
    check("ids_b", ids_b, (bsz, n), torch.int32)
    check("weights", weights, (bsz, k, n))
    if same_device(ids_a, ids_b, weights).type != "cuda":
        return cross_histogram_plain(ids_a, ids_b, weights, a_pad, b_pad)
    if k > _HIST_MAX_K or HIST_ROWS * k * b_pad * 4 > _SMEM_BYTES:
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
    p_pad): the function of segment_matmul.py::table_lookup (B12, whose
    kernel is not ported), as a gather. ids (B, N), tab (B, p_pad, K);
    returns (B, K, N)."""
    p_pad, k = tab.shape[1:]
    inr = (ids >= 0) & (ids < p_pad)
    idx = ids.clamp(0, p_pad - 1).long()[..., None].expand(-1, -1, k)
    rows = torch.gather(tab, 1, idx)
    return torch.where(inr[..., None], rows, 0.0).transpose(1, 2)


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
    """(B, p_pad, 10): the moment channels summed by patch id."""
    mom = fit_moment_channels(ids, chan, tab, p_cnt, exact)
    return torch.stack([segment_sums_plain(ids[b], mom[b], p_pad)
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
    (csrc/fit_iteration_moments.cu); on the card the sums repeat bit for
    bit from run to run."""
    bsz, _, n = chan.shape
    check("ids", ids, (bsz, n), torch.int32)
    check("chan", chan, (bsz, 5, n))
    check("tab", tab, (bsz, p_pad, 5))
    if same_device(ids, chan, tab).type != "cuda":
        return fit_iteration_moments_plain(ids, chan, tab, p_pad, p_cnt,
                                           exact)
    if p_pad * 5 * 4 > _SMEM_BYTES:
        raise ValueError(f"fit_iteration_moments kernel: p_pad {p_pad} "
                         "exceeds its shared memory")
    chunks = -(-n // FIT_CHUNK)
    partial = torch.empty((bsz, chunks, p_pad, _MOMENTS),
                          dtype=torch.float32, device=chan.device)
    out = torch.empty((bsz, p_pad, _MOMENTS), dtype=torch.float32,
                      device=chan.device)
    launch("fit_iteration_moments", ids, chan, tab, bsz, n, p_pad, p_cnt,
           int(exact), FIT_CHUNK, partial, out)
    LAUNCHES["fit_iteration_moments"] += 1
    return out


def classify_points_plain(ids, chan, tab, p_pad: int,
                          p_cnt: int) -> torch.Tensor:
    """(B, N) int32 codes: bit 0 ground, 1 nonground, 2 reverted, 3
    rejected, from the delivered [n1, n2, n3, th, flags] row
    (segment_matmul.py:357-367)."""
    vals = table_lookup_plain(ids, tab)
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
