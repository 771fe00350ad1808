"""The weighted Kabsch rotation of the SO(3) GNC, as the JAX package
computes it on the CPU, bit for bit.

``quatro_tpu/solver/rotation.py::svd_rot3d`` forms H = (src w)^T dst with
XLA's dot, then takes R = V diag(1, 1, det) U^T from ``jnp.linalg.svd``,
which calls LAPACK's ``sgesdd``. Where a GNC loop ends on an
ill-conditioned H (singular values 572, 0.70 and 0.20 on one fixture of
tests/test_torch_reference_modes.py), one ulp in any iteration moves the
final rotation by 1e-5, so the port repeats every rounding of that chain:

* H: each entry a sequence of fused multiply-adds over the N points, from
  0, in index order (XLA's dot on the CPU), of the f32 product src w;
* the SVD of the 3 x 3 H as ``sgesdd`` computes it: ``sgebd2``'s
  Householder bidiagonalisation, ``sbdsqr``'s implicit QR sweeps with
  their convergence tests, shifts, 2 x 2 blocks (``slasv2``), rotations
  (``slartg``, LAPACK 3.10's) and sort, then ``sormbr``'s back
  transformation. The BLAS calls round as the OpenBLAS build under the
  JAX package's LAPACK does: ``sger`` and ``srot`` fuse their multiply-
  adds, ``sgemv`` adds a transposed column's products one at a time but
  for the last of an odd number of columns of length 3, whose third
  product is fused;
* R = V diag(1, 1, sign) U^T by fused multiply-adds in index order.

``kabsch_rotation`` launches ``csrc/kabsch.cu`` (one block per row: nine
threads sum H, one runs the SVD) for CUDA tensors and counts the launch;
for CPU tensors it runs ``kabsch_rotation_plain``, the same chain in torch
operations over the rows (the QR sweeps a device loop, utils/loops.py).
There is no fallback between the two. Both read nothing back on the card.
"""

from __future__ import annotations

import torch

from quatro_tpu_torch.ops.launch import LAUNCHES, check, launch, same_device
from quatro_tpu_torch.utils import fused, loops

EPS = 2.0 ** -24                    # slamch('Epsilon')
SAFMIN = 2.0 ** -126                # slamch('Safe minimum')
SAFMAX = 2.0 ** 126
TOL = 10.0 * EPS                    # sbdsqr: max(10, min(100, eps^-1/8)) eps
RTMIN = fused.f32(SAFMIN ** 0.5)    # slartg's safe range
RTMAX = fused.f32((SAFMAX / 2) ** 0.5)
HNDRTH_TOL = fused.f32(fused.f32(0.01) * TOL)
N_TOL = fused.f32(3.0 * TOL)
SQRT3 = fused.f32(3.0 ** 0.5)
THRESH_FLOOR = fused.f32(6.0 * (3.0 * (3.0 * SAFMIN)))
SWEEP_BOUND = 64                    # visits to the 3 x 3 block, at most
SWEEP_CHUNK = 2                     # visits of the plain version per read


def _w(c, a, b):
    return torch.where(c, a, b)


def _sign(a, b):
    """Fortran's SIGN(a, b): |a| with the sign bit of b."""
    return torch.copysign(torch.abs(a), b)


def _sqrt(x):
    """The correctly rounded f32 square root: the f64 root of an f32 value
    rounds to it (no f64 root lies within an f64 ulp of an f32 midpoint;
    on this CPU route checked over two binades exhaustively and 42M
    random values against utils/fused.sqrt, at a fifth of its cost)."""
    return torch.sqrt(x.double()).float()


def _safe(c, x):
    """x where c, else 1 (a divisor of a branch that is not taken)."""
    return _w(c, x, torch.ones_like(x))


def weighted_cross_plain(src, dst, weights):
    """H (rows, 3, 3) of src, dst (rows, N, 3) and weights (rows, N): each
    entry f32 fused multiply-adds over the points in index order from 0,
    of the f32 products src w."""
    a = (src * weights[..., None]).double()
    p = a[..., :, :, None] * dst.double()[..., :, None, :]    # exact
    h = torch.zeros(p.shape[:-3] + (3, 3), dtype=torch.float32,
                    device=src.device)
    for pk in p.unbind(-3):
        h = (pk + h).float()
    return h


def _larfg(alpha, xs):
    """slarfg: (beta, tau, tail) of the reflector taking (alpha, *xs) to
    (beta, 0, ...); tau = 0 and beta = alpha where xs are all 0. snrm2
    sums its squares in f64; slapy2 is w sqrt(1 + (z / w)^2)."""
    xnorm = torch.sqrt(sum(x.double() * x.double() for x in xs)).float()
    a = torch.abs(alpha)
    w, z = torch.maximum(a, xnorm), torch.minimum(a, xnorm)
    q = z / _safe(w > 0, w)
    norm = _w(z == 0, w, w * _sqrt(1.0 + q * q))
    zero = xnorm == 0
    beta = _w(zero, alpha, -_sign(norm, alpha))
    tau = _w(zero, torch.zeros_like(alpha),
             (beta - alpha) / _safe(~zero, beta))
    inv = 1.0 / _safe(~zero, alpha - beta)
    return beta, tau, [_w(zero, x, x * inv) for x in xs]


def _gemv_t(col, v, fused_last: bool):
    """sgemv 'T' of one column: the products added one at a time (v[0] is
    1, so the first is exact); ``fused_last``: the last of an odd number
    of length-3 columns, whose third product is fused."""
    t = col[0] * v[0] + col[1] * v[1]
    if len(col) == 3:
        t = fused.fma(col[2], v[2], t) if fused_last else t + col[2] * v[2]
    return t


def _larf_left(cols, v, tau):
    """slarf from the left: columns ``cols`` (each a list over the
    reflector's rows) minus v tau (v^T col); sger's update fused."""
    out = []
    for k, col in enumerate(cols):
        last = len(cols) % 2 == 1 and k == len(cols) - 1
        tmp = -tau * _gemv_t(col, v, last)
        out.append([fused.fma(vi, tmp, c) for vi, c in zip(v, col)])
    return out


def _larf_right(rows, v, tau):
    """slarf from the right: rows ``rows`` (each a list over the
    reflector's columns) minus (row v) tau v^T; sgemv 'N' fuses its
    second product, sger its update."""
    out = []
    for row in rows:
        w = fused.fma(row[1], v[1], row[0] * v[0])
        out.append([fused.fma(w, -tau * vj, c) for vj, c in zip(v, row)])
    return out


def _bidiagonalize(h):
    """sgebd2 on (rows, 3, 3) h: (d, e, (tq0, v), (tq1, u), (tp0, g)) with
    Q = H1 H2, H1 = I - tq0 (1, *v)(1, *v)^T on rows 0..2, H2 on rows 1..2
    with (1, *u), and P = G1 on columns 1..2 with (1, *g)."""
    a = [list(r.unbind(-1)) for r in h.unbind(-2)]
    one = torch.ones_like(a[0][0])
    d0, tq0, v = _larfg(a[0][0], [a[1][0], a[2][0]])
    v = [one, *v]
    c1, c2 = _larf_left([[a[i][1] for i in range(3)],
                         [a[i][2] for i in range(3)]], v, tq0)
    for i in range(3):
        a[i][1], a[i][2] = c1[i], c2[i]
    e0, tp0, g = _larfg(a[0][1], [a[0][2]])
    g = [one, *g]
    (a[1][1], a[1][2]), (a[2][1], a[2][2]) = _larf_right(
        [[a[1][1], a[1][2]], [a[2][1], a[2][2]]], g, tp0)
    d1, tq1, u = _larfg(a[1][1], [a[2][1]])
    u = [one, *u]
    (a[1][2], a[2][2]), = _larf_left([[a[1][2], a[2][2]]], u, tq1)
    return ([d0, d1, a[2][2]], [e0, a[1][2]], (tq0, v), (tq1, u), (tp0, g))


def _lartg(f, g):
    """slartg (LAPACK 3.10): (c, s, r) with [c s; -s c] [f; g] = [r; 0]."""
    f1, g1 = torch.abs(f), torch.abs(g)
    one, zero = torch.ones_like(f), torch.zeros_like(f)
    plain = (f1 > RTMIN) & (f1 < RTMAX) & (g1 > RTMIN) & (g1 < RTMAX)
    u = torch.clamp(torch.maximum(f1, g1), SAFMIN, SAFMAX)
    u = _w(plain, one, u)
    fs, gs = f / u, g / u
    d = _sqrt(fs * fs + gs * gs)
    d = _safe(d > 0, d)
    c = torch.abs(fs) / d
    r = _sign(d, f)
    s = gs / r
    r = _w(plain, r, r * u)
    gz, fz = g == 0, f == 0
    c = _w(gz, one, _w(fz, zero, c))
    s = _w(gz, zero, _w(fz, _sign(one, g), s))
    r = _w(gz, f, _w(fz, g1, r))
    return c, s, r


def _las2_min(f, g, h):
    """slas2's smaller singular value of [f g; 0 h]."""
    fa, ga, ha = torch.abs(f), torch.abs(g), torch.abs(h)
    fhmn, fhmx = torch.minimum(fa, ha), torch.maximum(fa, ha)
    fx = _safe(fhmx > 0, fhmx)
    as_ = 1.0 + fhmn / fx
    at = (fhmx - fhmn) / fx
    q = ga / fx
    c = 2.0 / (_sqrt(as_ * as_ + q * q) + _sqrt(at * at + q * q))
    small_g = fhmn * c
    au = fhmx / _safe(ga > 0, ga)
    c2 = 1.0 / (_sqrt(1.0 + (as_ * au) * (as_ * au))
                + _sqrt(1.0 + (at * au) * (at * au)))
    big_g = (fhmn * c2) * au
    big_g = big_g + big_g
    big_g = _w(au == 0, (fhmn * fhmx) / _safe(ga > 0, ga), big_g)
    out = _w(ga < fhmx, small_g, big_g)
    return _w(fhmn == 0, torch.zeros_like(f), out)


def _lasv2(f, g, h):
    """slasv2 of [f g; 0 h]: (ssmin, ssmax, snr, csr, snl, csl)."""
    one = torch.ones_like(f)
    fa, ha = torch.abs(f), torch.abs(h)
    swap = ha > fa
    ft, ht = _w(swap, h, f), _w(swap, f, h)
    fa, ha = torch.abs(ft), torch.abs(ht)
    gt, ga = g, torch.abs(g)
    pmax = _w(swap, torch.full_like(f, 3.0), one)
    # ga > fa and fa / ga < eps: a very large g
    huge = (ga > fa) & (fa / _safe(ga > 0, ga) < EPS)
    pmax = _w(ga > fa, torch.full_like(f, 2.0), pmax)
    gs = _safe(ga > 0, gt)
    hmin = _w(ha > 1.0, fa / (ga / _safe(ha > 0, ha)), (fa / _safe(ga > 0, ga))
              * ha)
    # the normal case
    d = fa - ha
    l = _w(d == fa, one, d / _safe(fa > 0, fa))
    fs = _safe(ft != 0, ft)
    m = gt / fs
    t = 2.0 - l
    mm, tt = m * m, t * t
    s = _sqrt(tt + mm)
    r = _w(l == 0, torch.abs(m), _sqrt(l * l + mm))
    a = 0.5 * (s + r)
    a = _safe(a > 0, a)
    n_min, n_max = ha / a, fa * a
    t_tiny = _w(l == 0, _sign(2.0 * one, ft) * _sign(one, gt),
                gt / _safe(d != 0, _sign(d, ft)) + m / t)
    t = _w(mm == 0, t_tiny, (m / (s + t) + m / _safe(r + l != 0, r + l))
           * (1.0 + a))
    l2 = _sqrt(t * t + 4.0)
    n_crt, n_srt = 2.0 / l2, t / l2
    n_clt = (n_crt + n_srt * m) / a
    n_slt = ((ht / fs) * n_srt) / a
    zero_g = ga == 0
    ssmin = _w(zero_g, ha, _w(huge, hmin, n_min))
    ssmax = _w(zero_g, fa, _w(huge, ga, n_max))
    clt = _w(zero_g | huge, one, n_clt)
    crt = _w(zero_g, one, _w(huge, ft / gs, n_crt))
    slt = _w(zero_g, 0.0 * one, _w(huge, ht / gs, n_slt))
    srt = _w(zero_g, 0.0 * one, _w(huge, one, n_srt))
    csl, snl = _w(swap, srt, clt), _w(swap, crt, slt)
    csr, snr = _w(swap, slt, crt), _w(swap, clt, srt)
    tsign = _w(pmax == 1, _sign(one, csr) * _sign(one, csl) * _sign(one, f),
               _w(pmax == 2,
                  _sign(one, snr) * _sign(one, csl) * _sign(one, g),
                  _sign(one, snr) * _sign(one, snl) * _sign(one, h)))
    ssmax = _sign(ssmax, tsign)
    ssmin = _sign(ssmin, tsign * _sign(one, f) * _sign(one, h))
    return ssmin, ssmax, snr, csr, snl, csl


def _rot(x, y, c, s):
    """srot on two vectors: (c x + s y, c y - s x), each a fused
    multiply-add of the other product."""
    return fused.fma(c, x, s * y), fused.fma(c, y, -(s * x))


def _lasr(x, y, c, s):
    """slasr's plane rotation of two vectors: (s y + c x, c y - s x),
    every product and sum rounded."""
    return s * y + c * x, c * y - s * x


def _sides(right, left):
    """Rotation parameters (rows,) of the two sides of w, as (rows, 2, 1):
    ``right`` for w[:, 0] (VT's rows), ``left`` for w[:, 1] (U's
    columns)."""
    return torch.stack([right, left], -1)[..., None]


def _sweep(d, e, w, shift):
    """One of sbdsqr's QR sweeps down the 3 x 3 block, chasing the bulge
    from the top (idir = 1): the zero-shift sweep where ``shift`` is 0,
    else the shifted one. Both make four rotations in the same places, so
    each row's four slartg calls are shared, and w takes the same ones:
    the first and third on w[:, 0] (VT's rows), the second and fourth on
    w[:, 1] (U's columns). Returns (d, e, w)."""
    d0, d1, d2 = d
    e0, e1 = e
    z = shift == 0
    f = (torch.abs(d0) - shift) * (_sign(torch.ones_like(d0), d0)
                                   + shift / _safe(d0 != 0, d0))
    c1, s1, r1 = _lartg(_w(z, d0, f), e0)
    f = c1 * d0 + s1 * e0                           # shifted
    se0 = c1 * e0 - s1 * d0
    sd1 = c1 * d1
    c2, s2, r2 = _lartg(_w(z, r1, f), d1 * s1)
    f = c2 * se0 + s2 * sd1
    sd1 = c2 * sd1 - s2 * se0
    se1 = c2 * e1
    c3, s3, r3 = _lartg(_w(z, d1 * c1, f), _w(z, e1, s2 * e1))
    f = c3 * sd1 + s3 * se1
    se1 = c3 * se1 - s3 * sd1
    sd2 = c3 * d2
    c4, s4, r4 = _lartg(_w(z, c2 * r3, f), d2 * s3)
    f = c4 * se1 + s4 * sd2
    sd2 = c4 * sd2 - s4 * se1
    hh = d2 * c3                                    # zero shift
    d = [r2, r4, _w(z, hh * c4, sd2)]
    e = [_w(z, s2 * r3, r3), _w(z, hh * s4, f)]
    vec = list(w.unbind(2))
    for k, (rc, rs, lc, ls) in enumerate(((c1, s1, c2, s2),
                                          (c3, s3, c4, s4))):
        vec[k], vec[k + 1] = _lasr(vec[k], vec[k + 1], _sides(rc, lc),
                                   _sides(rs, ls))
    return d, e, torch.stack(vec, 2)


def _full(e, thresh):
    """Rows whose 3 x 3 block has not split."""
    return (torch.abs(e[0]) > thresh) & (torch.abs(e[1]) > thresh)


def _visit(consts, state):
    """One pass of sbdsqr's main loop (its label 60) on every row whose
    3 x 3 block has not split: a convergence test that zeroes an e, or a
    QR sweep. Other rows keep their state. w (rows, 2, 3, 3): w[:, 0] VT,
    w[:, 1] U^T."""
    d, e, w, thresh, oldm, idir = state
    d, e = list(d.unbind(-1)), list(e.unbind(-1))
    full = _full(e, thresh)
    zero = torch.zeros_like(d[0])
    ad, ae = [torch.abs(x) for x in d], [torch.abs(x) for x in e]
    # from the larger end diagonal entry (idir 1: top; 2: bottom, run as
    # the top-down sweep of the reversed matrix, whose rotations swap
    # sides)
    idir = _w(full & (oldm < 0), _w(ad[0] >= ad[2], 1, 2).to(idir.dtype),
              idir)
    up = idir == 2
    rd = [_w(up, d[2 - k], d[k]) for k in range(3)]
    re = [_w(up, e[1 - k], e[k]) for k in range(2)]
    upw = up[..., None, None, None]
    rw = _w(upw, w.flip(1, 2), w)
    ard, are = [torch.abs(x) for x in rd], [torch.abs(x) for x in re]
    mu0 = ard[0]
    t0 = are[1] <= TOL * ard[2]
    t1 = ~t0 & (are[0] <= TOL * mu0)
    mu1 = ard[1] * (mu0 / _safe(mu0 + are[0] > 0, mu0 + are[0]))
    t2 = ~t0 & ~t1 & (are[1] <= TOL * mu1)
    mu2 = ard[2] * (mu1 / _safe(mu1 + are[1] > 0, mu1 + are[1]))
    smin = torch.minimum(torch.minimum(mu0, mu1), mu2)
    smax = torch.maximum(torch.maximum(torch.maximum(ad[0], ad[1]), ad[2]),
                         torch.maximum(ae[0], ae[1]))
    sweep = full & ~(t0 | t1 | t2)
    shift = _las2_min(rd[1], re[1], rd[2])
    sll = ard[0]
    q = shift / _safe(sll > 0, sll)
    shift = _w((sll > 0) & (q * q < EPS), zero, shift)
    shift = _w(N_TOL * (smin / _safe(smax > 0, smax)) <= max(EPS, HNDRTH_TOL),
               zero, shift)
    sd, se, sw = _sweep(rd, re, rw, shift)
    se[1] = _w(torch.abs(se[1]) <= thresh, zero, se[1])
    # a convergence test's zero, or the sweep's result, back in place
    re = [_w(sweep, se[0], _w(full & t1, zero, re[0])),
          _w(sweep, se[1], _w(full & (t0 | t2), zero, re[1]))]
    rd = [_w(sweep, a, b) for a, b in zip(sd, rd)]
    d = [_w(up, rd[2 - k], rd[k]) for k in range(3)]
    e = [_w(up, re[1 - k], re[k]) for k in range(2)]
    w = _w(sweep[..., None, None, None], _w(upw, sw.flip(1, 2), sw), w)
    oldm = _w(sweep, torch.full_like(oldm, 3), oldm)
    return torch.stack(d, -1), torch.stack(e, -1), w, thresh, oldm, idir


def _unconverged(state):
    return _full(state[1].unbind(-1), state[3]).any()


def _split(d, e, w, thresh, done):
    """sbdsqr's passes after the 3 x 3 block split, on the rows not
    ``done``: the bottom value converged (e1 small), then the top one or
    the 2 x 2 block of rows 0, 1; or the 2 x 2 block of rows 1, 2 (e0
    small). One slasv2 at most; (d, e, w) of all rows."""
    low3 = ~done & (torch.abs(e[1]) <= thresh)
    low2 = low3 & (torch.abs(e[0]) <= thresh)
    blk3 = ~done & ~low3                      # 2 x 2 at rows 1, 2
    blk2 = low3 & ~low2                       # 2 x 2 at rows 0, 1
    f, g, h = _w(blk3, d[1], d[0]), _w(blk3, e[1], e[0]), _w(blk3, d[2], d[1])
    smin2, smax2, snr, csr, snl, csl = _lasv2(f, g, h)
    vec = list(w.unbind(2))
    b3 = blk3[..., None, None]
    x, y = _rot(_w(b3, vec[1], vec[0]), _w(b3, vec[2], vec[1]),
                _sides(csr, csl), _sides(snr, snl))
    b2 = blk2[..., None, None]
    w = torch.stack([_w(b2, x, vec[0]), _w(b3, x, _w(b2, y, vec[1])),
                     _w(b3, y, vec[2])], 2)
    d = [_w(blk2, smax2, d[0]), _w(blk3, smax2, _w(blk2, smin2, d[1])),
         _w(blk3, smin2, d[2])]
    zero = torch.zeros_like(e[0])
    e = [_w(~done, zero, e[0]), _w(~done, zero, e[1])]
    return d, e, w


def _bdsqr(d, e):
    """sbdsqr on the upper bidiagonal (d, e) with U = VT = I: (U, VT),
    (rows, 3, 3), singular values made positive and sorted descending.
    Its sweeps are a device loop while a row's 3 x 3 block has not split;
    the passes after the split follow once."""
    ad = [torch.abs(x) for x in d]
    mu = ad[0]
    sminoa = mu
    for i in (1, 2):
        mu = ad[i] * (mu / _safe(mu + torch.abs(e[i - 1]) > 0,
                                 mu + torch.abs(e[i - 1])))
        sminoa = torch.minimum(sminoa, mu)
    sminoa = _w(ad[0] == 0, torch.zeros_like(mu), sminoa) / SQRT3
    thresh = torch.clamp(TOL * sminoa, min=THRESH_FLOOR)
    rows = d[0].shape
    dev = d[0].device
    eye = torch.eye(3, dtype=d[0].dtype, device=dev).expand(
        *rows, 2, 3, 3).contiguous()
    state = (torch.stack(d, -1), torch.stack(e, -1), eye, thresh,
             torch.full(rows, -1, dtype=torch.int32, device=dev),
             torch.zeros(rows, dtype=torch.int32, device=dev))
    state, _ = loops.while_chunks("kabsch_sweeps", _visit, _unconverged, (),
                                  state, SWEEP_BOUND, SWEEP_CHUNK)
    d, e, w = list(state[0].unbind(-1)), list(state[1].unbind(-1)), state[2]
    d, e, w = _split(d, e, w, thresh, _full(e, thresh))
    s = torch.stack(d, -1)
    # positive singular values (the sign to VT's row), then sbdsqr's
    # selection sort into descending order, VT's rows and U's columns
    # swapped with them
    neg = (s < 0)[..., None]
    w = torch.stack([_w(neg, -w[..., 0, :, :], w[..., 0, :, :]),
                     w[..., 1, :, :]], -3)
    s = torch.abs(s)
    for last in (2, 1):
        smin = s[..., 0]
        sub = torch.zeros_like(smin, dtype=torch.int64)
        for j in range(1, last + 1):
            le = s[..., j] <= smin
            sub = _w(le, torch.full_like(sub, j), sub)
            smin = _w(le, s[..., j], smin)
        perm = torch.arange(3, device=dev).expand(*rows, 3)
        perm = _w(perm == last, sub[..., None], _w(
            perm == sub[..., None], torch.full_like(perm, last), perm))
        s = s.gather(-1, perm)
        w = w.gather(-2, perm[..., None, :, None].expand(*rows, 2, 3, 3))
    return w[..., 1, :, :].transpose(-1, -2), w[..., 0, :, :]


def _det_negative(a):
    """det(a) < 0 for (rows, 3, 3) a with det +-1."""
    (a0, a1, a2), (b0, b1, b2), (c0, c1, c2) = (
        r.unbind(-1) for r in a.unbind(-2))
    return (a0 * (b1 * c2 - b2 * c1) - a1 * (b0 * c2 - b2 * c0)
            + a2 * (b0 * c1 - b1 * c0)) < 0


def svd_rotation_plain(h: torch.Tensor) -> torch.Tensor:
    """R = V diag(1, 1, det) U^T of (rows, 3, 3) f32 h, U S V^T = h as
    LAPACK's sgesdd computes it, in torch operations over the rows."""
    d, e, (tq0, v), (tq1, uu), (tp0, g) = _bidiagonalize(h)
    u, vt = _bdsqr(d, e)
    # sormbr: U <- H1 H2 U (H2 on rows 1..2), VT <- VT G1 (columns 1..2)
    cols = [list(c.unbind(-1)) for c in u.unbind(-1)]
    low = _larf_left([c[1:] for c in cols], uu, tq1)
    cols = [[c[0], *lo] for c, lo in zip(cols, low)]
    cols = _larf_left(cols, v, tq0)
    rows = [list(r.unbind(-1)) for r in vt.unbind(-2)]
    right = _larf_right([r[1:] for r in rows], g, tp0)
    vrows = [[r[0], *rt] for r, rt in zip(rows, right)]
    u = torch.stack([torch.stack(c, -1) for c in cols], -1)
    vt = torch.stack([torch.stack(r, -1) for r in vrows], -2)
    v = vt.transpose(-1, -2)
    flip = _det_negative(u) ^ _det_negative(vt)
    v = torch.stack([v[..., 0], v[..., 1],
                     _w(flip[..., None], -v[..., 2], v[..., 2])], -1)
    # R = v u^T: fused multiply-adds over k from 0
    r = v[..., :, None, 0] * u[..., None, :, 0]
    for k in (1, 2):
        r = fused.fma(v[..., :, None, k], u[..., None, :, k], r)
    return r


def kabsch_rotation_plain(src, dst, weights):
    """``kabsch_rotation`` in torch operations."""
    return svd_rotation_plain(weighted_cross_plain(src, dst, weights))


def kabsch_rotation(src: torch.Tensor, dst: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """The proper rotation R with R src ~= dst of the weighted Kabsch
    problem, the JAX package's ``svd_rot3d``: src, dst (..., N, 3) and
    weights (..., N) f32; (..., 3, 3). One launch of csrc/kabsch.cu for
    all rows on the card, bit for bit ``kabsch_rotation_plain``; that plain
    version on the CPU."""
    lead = src.shape[:-2]
    n = src.shape[-2]
    src, dst, weights = (t.reshape(-1, *t.shape[len(lead):]).contiguous()
                         for t in (src, dst, weights))
    rows = src.shape[0]
    check("src", src, (rows, n, 3))
    check("dst", dst, (rows, n, 3))
    check("weights", weights, (rows, n))
    if same_device(src, dst, weights).type != "cuda":
        return kabsch_rotation_plain(src, dst, weights).reshape(*lead, 3, 3)
    out = torch.empty((rows, 3, 3), dtype=torch.float32, device=src.device)
    if rows:
        launch("kabsch", src, dst, weights, rows, n, out)
        LAUNCHES["kabsch"] += 1
    return out.reshape(*lead, 3, 3)
