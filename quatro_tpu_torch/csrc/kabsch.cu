// Weighted Kabsch rotation of the SO(3) GNC, one 3 x 3 problem per row.
//
// The counterpart of quatro_tpu/solver/rotation.py::svd_rot3d (no Pallas
// kernel there: XLA's dot and LAPACK's sgesdd under jnp.linalg.svd), bit
// for bit quatro_tpu_torch/ops/kabsch.py::kabsch_rotation_plain, which
// repeats the JAX package's CPU rounding:
//   H[i][j] = fused multiply-adds over the points k = 0..N-1, from 0, of
//             (src[k][i] w[k]) dst[k][j];
//   H = Q B P^T (sgebd2), B = U_B S VT_B (sbdsqr: implicit QR sweeps,
//   slasv2 2 x 2 blocks, slartg rotations, sign fix and sort), U = Q U_B,
//   VT = VT_B P^T (sormbr), V's last column negated where det U det V < 0,
//   R = V U^T by fused multiply-adds over k from 0.
// Every f32 operation is an _rn intrinsic, so nothing is contracted. A
// fused multiply-add is computed as the plain version computes it: the
// product of two f32 values (exact in f64) plus the f64 addend, rounded to
// f64 and then to f32. snrm2's norm is a f64 sum of squares and square root.
//
// Bound on the card: each H entry is a chain of N dependent f64 additions
// and the SVD one thread's branching scalar code (a few thousand
// operations); the bytes (src, dst, w read once) and the operations are
// far below the chains' latency.
// Design: one block of 32 threads per row; threads 0..8 each sum one entry
// of H into shared memory, then thread 0 runs the SVD and writes R.
#include <cuda_runtime.h>

namespace quatro {
namespace kabsch {

constexpr float kEps = 0x1p-24f;              // slamch('Epsilon')
constexpr float kSafmin = 0x1p-126f;          // slamch('Safe minimum')
constexpr float kSafmax = 0x1p126f;
constexpr float kTol = 0x1.4p-21f;            // 10 eps (sbdsqr's TOL)
constexpr float kRtmin = 0x1p-63f;            // sqrt(safmin)
constexpr float kRtmax = 0x1.6a09e6p62f;      // sqrt(safmax / 2)
constexpr float kHndrthTol = 0x1.999998p-28f; // 0.01 TOL
constexpr float kNTol = 0x1.ep-20f;           // 3 TOL
constexpr float kSqrt3 = 0x1.bb67aep0f;
constexpr float kThreshFloor = 0x1.bp-121f;   // 6 (3 (3 safmin))
constexpr int kSweepBound = 64;               // visits to the 3 x 3 block

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sq(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}
// Fortran's SIGN(a, b): |a| with the sign bit of b
__device__ __forceinline__ float sgn(float a, float b) {
  return signbit(b) ? -fabsf(a) : fabsf(a);
}

// slarfg on (alpha, x[0..n-1]): beta, tau and the scaled tail in x
__device__ void larfg(float alpha, float* x, int n, float& beta, float& tau) {
  double s = 0.0;
  for (int k = 0; k < n; ++k) s = __dadd_rn(s, __dmul_rn((double)x[k], (double)x[k]));
  const float xnorm = __double2float_rn(__dsqrt_rn(s));
  if (xnorm == 0.0f) {
    beta = alpha;
    tau = 0.0f;
    return;
  }
  const float a = fabsf(alpha);
  const float w = fmaxf(a, xnorm), z = fminf(a, xnorm);
  const float q = dv(z, w);
  const float norm = z == 0.0f ? w : mul(w, sq(add(1.0f, mul(q, q))));
  beta = -sgn(norm, alpha);
  tau = dv(sub(beta, alpha), beta);
  const float inv = dv(1.0f, sub(alpha, beta));
  for (int k = 0; k < n; ++k) x[k] = mul(x[k], inv);
}

// sgemv 'T' of one column of length n (2 or 3) against v (v[0] = 1)
__device__ __forceinline__ float gemv_t(const float* col, const float* v, int n,
                                        bool fused_last) {
  float t = add(mul(col[0], v[0]), mul(col[1], v[1]));
  if (n == 3) t = fused_last ? fma32(col[2], v[2], t) : add(t, mul(col[2], v[2]));
  return t;
}

// slarf from the left on columns c0..c0+nc-1, rows r0..2 of a (3 x 3,
// row-major), reflector (1, v[1..]) and tau
__device__ void larf_left(float (*a)[3], int r0, int c0, int nc, const float* v, float tau) {
  const int n = 3 - r0;
  for (int k = 0; k < nc; ++k) {
    const int j = c0 + k;
    float col[3];
    for (int i = 0; i < n; ++i) col[i] = a[r0 + i][j];
    const bool last = (nc % 2 == 1) && (k == nc - 1);
    const float tmp = mul(-tau, gemv_t(col, v, n, last));
    for (int i = 0; i < n; ++i) a[r0 + i][j] = fma32(v[i], tmp, col[i]);
  }
}

// slarf from the right on rows r0..2, columns 1..2, reflector (1, g)
__device__ void larf_right(float (*a)[3], int r0, float g, float tau) {
  for (int i = r0; i < 3; ++i) {
    const float w = fma32(a[i][2], g, mul(a[i][1], 1.0f));
    const float v[2] = {1.0f, g};
    for (int k = 0; k < 2; ++k) a[i][1 + k] = fma32(w, mul(-tau, v[k]), a[i][1 + k]);
  }
}

// slartg (LAPACK 3.10)
__device__ void lartg(float f, float g, float& c, float& s, float& r) {
  const float f1 = fabsf(f), g1 = fabsf(g);
  if (g == 0.0f) {
    c = 1.0f; s = 0.0f; r = f;
  } else if (f == 0.0f) {
    c = 0.0f; s = sgn(1.0f, g); r = g1;
  } else if (f1 > kRtmin && f1 < kRtmax && g1 > kRtmin && g1 < kRtmax) {
    const float d = sq(add(mul(f, f), mul(g, g)));
    c = dv(f1, d);
    r = sgn(d, f);
    s = dv(g, r);
  } else {
    const float u = fminf(kSafmax, fmaxf(kSafmin, fmaxf(f1, g1)));
    const float fs = dv(f, u), gs = dv(g, u);
    const float d = sq(add(mul(fs, fs), mul(gs, gs)));
    c = dv(fabsf(fs), d);
    r = sgn(d, f);
    s = dv(gs, r);
    r = mul(r, u);
  }
}

// slas2's smaller singular value of [f g; 0 h]
__device__ float las2_min(float f, float g, float h) {
  const float fa = fabsf(f), ga = fabsf(g), ha = fabsf(h);
  const float fhmn = fminf(fa, ha), fhmx = fmaxf(fa, ha);
  if (fhmn == 0.0f) return 0.0f;
  if (ga < fhmx) {
    const float as = add(1.0f, dv(fhmn, fhmx));
    const float at = dv(sub(fhmx, fhmn), fhmx);
    const float q = dv(ga, fhmx);
    const float au = mul(q, q);
    const float c = dv(2.0f, add(sq(add(mul(as, as), au)), sq(add(mul(at, at), au))));
    return mul(fhmn, c);
  }
  const float au = dv(fhmx, ga);
  if (au == 0.0f) return dv(mul(fhmn, fhmx), ga);
  const float as = add(1.0f, dv(fhmn, fhmx));
  const float at = dv(sub(fhmx, fhmn), fhmx);
  const float p = mul(as, au), q = mul(at, au);
  const float c = dv(1.0f, add(sq(add(1.0f, mul(p, p))), sq(add(1.0f, mul(q, q)))));
  const float smin = mul(mul(fhmn, c), au);
  return add(smin, smin);
}

// slasv2 of [f g; 0 h]
__device__ void lasv2(float f, float g, float h, float& ssmin, float& ssmax, float& snr,
                      float& csr, float& snl, float& csl) {
  float ft = f, fa = fabsf(f), ht = h, ha = fabsf(h);
  int pmax = 1;
  const bool swap = ha > fa;
  if (swap) {
    pmax = 3;
    float t = ft; ft = ht; ht = t;
    t = fa; fa = ha; ha = t;
  }
  const float gt = g, ga = fabsf(g);
  float clt, crt, slt, srt;
  if (ga == 0.0f) {
    ssmin = ha; ssmax = fa;
    clt = 1.0f; crt = 1.0f; slt = 0.0f; srt = 0.0f;
  } else {
    bool gasmal = true;
    if (ga > fa) {
      pmax = 2;
      if (dv(fa, ga) < kEps) {
        gasmal = false;
        ssmax = ga;
        ssmin = ha > 1.0f ? dv(fa, dv(ga, ha)) : mul(dv(fa, ga), ha);
        clt = 1.0f;
        slt = dv(ht, gt);
        srt = 1.0f;
        crt = dv(ft, gt);
      }
    }
    if (gasmal) {
      const float d = sub(fa, ha);
      float l = d == fa ? 1.0f : dv(d, fa);
      const float m = dv(gt, ft);
      float t = sub(2.0f, l);
      const float mm = mul(m, m), tt = mul(t, t);
      const float s = sq(add(tt, mm));
      const float r = l == 0.0f ? fabsf(m) : sq(add(mul(l, l), mm));
      const float a = mul(0.5f, add(s, r));
      ssmin = dv(ha, a);
      ssmax = mul(fa, a);
      if (mm == 0.0f) {
        if (l == 0.0f) t = mul(sgn(2.0f, ft), sgn(1.0f, gt));
        else t = add(dv(gt, sgn(d, ft)), dv(m, t));
      } else {
        t = mul(add(dv(m, add(s, t)), dv(m, add(r, l))), add(1.0f, a));
      }
      l = sq(add(mul(t, t), 4.0f));
      crt = dv(2.0f, l);
      srt = dv(t, l);
      clt = dv(add(crt, mul(srt, m)), a);
      slt = dv(mul(dv(ht, ft), srt), a);
    }
  }
  if (swap) {
    csl = srt; snl = crt; csr = slt; snr = clt;
  } else {
    csl = clt; snl = slt; csr = crt; snr = srt;
  }
  float tsign;
  if (pmax == 1) tsign = mul(mul(sgn(1.0f, csr), sgn(1.0f, csl)), sgn(1.0f, f));
  else if (pmax == 2) tsign = mul(mul(sgn(1.0f, snr), sgn(1.0f, csl)), sgn(1.0f, g));
  else tsign = mul(mul(sgn(1.0f, snr), sgn(1.0f, snl)), sgn(1.0f, h));
  ssmax = sgn(ssmax, tsign);
  ssmin = sgn(ssmin, mul(mul(tsign, sgn(1.0f, f)), sgn(1.0f, h)));
}

// srot on two vectors of 3: (c x + s y, c y - s x), the other product fused
__device__ __forceinline__ void rot(float* x, float* y, float c, float s) {
  for (int i = 0; i < 3; ++i) {
    const float a = x[i], b = y[i];
    x[i] = fma32(c, a, mul(s, b));
    y[i] = fma32(c, b, -mul(s, a));
  }
}

// slasr's rotation of two vectors of 3: (s y + c x, c y - s x)
__device__ __forceinline__ void lasr(float* x, float* y, float c, float s) {
  for (int i = 0; i < 3; ++i) {
    const float a = x[i], b = y[i];
    x[i] = add(mul(s, b), mul(c, a));
    y[i] = sub(mul(c, b), mul(s, a));
  }
}

// sbdsqr on upper bidiagonal (d, e) of order 3 with VT = U = I. vt[k] is
// VT's row k, ut[k] U's column k.
__device__ void bdsqr(float* d, float* e, float (*vt)[3], float (*ut)[3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) vt[i][j] = ut[i][j] = i == j ? 1.0f : 0.0f;
  float sminoa = fabsf(d[0]);
  if (sminoa != 0.0f) {
    float mu = sminoa;
    for (int i = 1; i < 3; ++i) {
      mu = mul(fabsf(d[i]), dv(mu, add(mu, fabsf(e[i - 1]))));
      sminoa = fminf(sminoa, mu);
      if (sminoa == 0.0f) break;
    }
  }
  sminoa = dv(sminoa, kSqrt3);
  const float thresh = fmaxf(mul(kTol, sminoa), kThreshFloor);
  int m = 3, oldm = -1, idir = 0, visits = 0;
  while (m > 1) {
    // find the block: split off converged bottom values
    float smax = fabsf(d[m - 1]);
    int ll = -1;                                   // 1-based, as sbdsqr
    for (int lll = 1; lll < m; ++lll) {
      const int l = m - lll;
      const float abss = fabsf(d[l - 1]), abse = fabsf(e[l - 1]);
      if (abse <= thresh) { ll = l; break; }
      smax = fmaxf(smax, fmaxf(abss, abse));
    }
    if (ll >= 0) {
      e[ll - 1] = 0.0f;
      if (ll == m - 1) { m -= 1; continue; }
    } else {
      ll = 0;
    }
    ll += 1;
    if (ll == m - 1) {                             // 2 x 2 block
      float sigmn, sigmx, sinr, cosr, sinl, cosl;
      lasv2(d[m - 2], e[m - 2], d[m - 1], sigmn, sigmx, sinr, cosr, sinl, cosl);
      d[m - 2] = sigmx; e[m - 2] = 0.0f; d[m - 1] = sigmn;
      rot(vt[m - 2], vt[m - 1], cosr, sinr);
      rot(ut[m - 2], ut[m - 1], cosl, sinl);
      m -= 2;
      continue;
    }
    // the 3 x 3 block (ll = 1, m = 3), at most kSweepBound visits, as
    // the plain version's loop (LAPACK gives up after 54 sweeps)
    if (visits++ == kSweepBound) break;
    if (oldm < 0) idir = fabsf(d[0]) >= fabsf(d[2]) ? 1 : 2;
    // the bottom-up direction runs as the top-down one on the reversed
    // matrix, whose rotations swap sides
    const bool up = idir == 2;
    float rd[3], re[2], (*xs)[3], (*ys)[3];
    float fx[3][3], fy[3][3];
    for (int k = 0; k < 3; ++k) rd[k] = up ? d[2 - k] : d[k];
    for (int k = 0; k < 2; ++k) re[k] = up ? e[1 - k] : e[k];
    for (int k = 0; k < 3; ++k)
      for (int i = 0; i < 3; ++i) {
        fx[k][i] = up ? ut[2 - k][i] : vt[k][i];
        fy[k][i] = up ? vt[2 - k][i] : ut[k][i];
      }
    xs = fx;
    ys = fy;
    // convergence tests
    const float mu0 = fabsf(rd[0]);
    bool hit = false;
    if (fabsf(re[1]) <= mul(kTol, fabsf(rd[2]))) { re[1] = 0.0f; hit = true; }
    float smin = mu0;
    if (!hit && fabsf(re[0]) <= mul(kTol, mu0)) { re[0] = 0.0f; hit = true; }
    float mu1 = 0.0f;
    if (!hit) {
      mu1 = mul(fabsf(rd[1]), dv(mu0, add(mu0, fabsf(re[0]))));
      smin = fminf(smin, mu1);
      if (fabsf(re[1]) <= mul(kTol, mu1)) { re[1] = 0.0f; hit = true; }
    }
    if (!hit) {
      const float mu2 = mul(fabsf(rd[2]), dv(mu1, add(mu1, fabsf(re[1]))));
      smin = fminf(smin, mu2);
      oldm = 3;
      // shift
      float shift;
      if (mul(kNTol, dv(smin, smax)) <= fmaxf(kEps, kHndrthTol)) {
        shift = 0.0f;
      } else {
        const float sll = fabsf(rd[0]);
        shift = las2_min(rd[1], re[1], rd[2]);
        if (sll > 0.0f) {
          const float q = dv(shift, sll);
          if (mul(q, q) < kEps) shift = 0.0f;
        }
      }
      if (shift == 0.0f) {
        float cs, sn, r, ocs, osn;
        lartg(rd[0], re[0], cs, sn, r);
        lartg(r, mul(rd[1], sn), ocs, osn, rd[0]);
        float cs2, sn2, ocs2, osn2;
        lartg(mul(rd[1], cs), re[1], cs2, sn2, r);
        re[0] = mul(osn, r);
        lartg(mul(ocs, r), mul(rd[2], sn2), ocs2, osn2, rd[1]);
        const float hh = mul(rd[2], cs2);
        rd[2] = mul(hh, ocs2);
        re[1] = mul(hh, osn2);
        lasr(xs[0], xs[1], cs, sn);
        lasr(xs[1], xs[2], cs2, sn2);
        lasr(ys[0], ys[1], ocs, osn);
        lasr(ys[1], ys[2], ocs2, osn2);
      } else {
        const float d0 = rd[0], d1 = rd[1], d2 = rd[2], e0 = re[0], e1 = re[1];
        float f = mul(sub(fabsf(d0), shift), add(sgn(1.0f, d0), dv(shift, d0)));
        float cr, sr, cl, sl, cr2, sr2, cl2, sl2, r;
        lartg(f, e0, cr, sr, r);
        f = add(mul(cr, d0), mul(sr, e0));
        float se0 = sub(mul(cr, e0), mul(sr, d0));
        float g = mul(sr, d1);
        float sd1 = mul(cr, d1);
        float sd0;
        lartg(f, g, cl, sl, sd0);
        f = add(mul(cl, se0), mul(sl, sd1));
        sd1 = sub(mul(cl, sd1), mul(sl, se0));
        g = mul(sl, e1);
        float se1 = mul(cl, e1);
        lartg(f, g, cr2, sr2, se0);
        f = add(mul(cr2, sd1), mul(sr2, se1));
        se1 = sub(mul(cr2, se1), mul(sr2, sd1));
        g = mul(sr2, d2);
        float sd2 = mul(cr2, d2);
        lartg(f, g, cl2, sl2, sd1);
        f = add(mul(cl2, se1), mul(sl2, sd2));
        sd2 = sub(mul(cl2, sd2), mul(sl2, se1));
        rd[0] = sd0; rd[1] = sd1; rd[2] = sd2; re[0] = se0; re[1] = f;
        lasr(xs[0], xs[1], cr, sr);
        lasr(xs[1], xs[2], cr2, sr2);
        lasr(ys[0], ys[1], cl, sl);
        lasr(ys[1], ys[2], cl2, sl2);
      }
      if (fabsf(re[1]) <= thresh) re[1] = 0.0f;
      for (int k = 0; k < 3; ++k)
        for (int i = 0; i < 3; ++i) {
          if (up) { ut[2 - k][i] = fx[k][i]; vt[2 - k][i] = fy[k][i]; }
          else { vt[k][i] = fx[k][i]; ut[k][i] = fy[k][i]; }
        }
    }
    for (int k = 0; k < 3; ++k) d[k] = up ? rd[2 - k] : rd[k];
    for (int k = 0; k < 2; ++k) e[k] = up ? re[1 - k] : re[k];
  }
  // positive singular values (the sign to VT's row), then the selection
  // sort into descending order
  for (int i = 0; i < 3; ++i)
    if (d[i] < 0.0f) {
      d[i] = -d[i];
      for (int j = 0; j < 3; ++j) vt[i][j] = -vt[i][j];
    }
  for (int last = 2; last >= 1; --last) {
    int isub = 0;
    float smin = d[0];
    for (int j = 1; j <= last; ++j)
      if (d[j] <= smin) { isub = j; smin = d[j]; }
    if (isub != last) {
      d[isub] = d[last];
      d[last] = smin;
      for (int j = 0; j < 3; ++j) {
        float t = vt[isub][j]; vt[isub][j] = vt[last][j]; vt[last][j] = t;
        t = ut[isub][j]; ut[isub][j] = ut[last][j]; ut[last][j] = t;
      }
    }
  }
}

__device__ __forceinline__ bool det_negative(float (*a)[3]) {
  const float t = add(sub(mul(a[0][0], sub(mul(a[1][1], a[2][2]), mul(a[1][2], a[2][1]))),
                          mul(a[0][1], sub(mul(a[1][0], a[2][2]), mul(a[1][2], a[2][0])))),
                      mul(a[0][2], sub(mul(a[1][0], a[2][1]), mul(a[1][1], a[2][0]))));
  return t < 0.0f;
}

__global__ void __launch_bounds__(32) kabsch_kernel(const float* __restrict__ src,
                                                    const float* __restrict__ dst,
                                                    const float* __restrict__ w, int n,
                                                    float* __restrict__ out) {
  __shared__ float hs[3][3];
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 9) {
    const int i = t / 3, j = t % 3;
    const float* s = src + (size_t)row * n * 3;
    const float* d = dst + (size_t)row * n * 3;
    const float* wr = w + (size_t)row * n;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc = fma32(mul(s[3 * k + i], wr[k]), d[3 * k + j], acc);
    hs[i][j] = acc;
  }
  __syncthreads();
  if (t != 0) return;
  float a[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) a[i][j] = hs[i][j];
  // sgebd2
  float d[3], e[2], tq0, tq1, tp0, beta;
  float v[3] = {1.0f, a[1][0], a[2][0]};
  larfg(a[0][0], v + 1, 2, d[0], tq0);
  larf_left(a, 0, 1, 2, v, tq0);
  float g = a[0][2];
  larfg(a[0][1], &g, 1, e[0], tp0);
  larf_right(a, 1, g, tp0);
  float u[2] = {1.0f, a[2][1]};
  larfg(a[1][1], u + 1, 1, d[1], tq1);
  larf_left(a, 1, 2, 1, u, tq1);
  d[2] = a[2][2];
  e[1] = a[1][2];
  (void)beta;
  // sbdsqr, then sormbr: U = H1 H2 U_B, VT = VT_B G1
  float vt[3][3], ut[3][3];
  bdsqr(d, e, vt, ut);
  float um[3][3];                                  // U, row-major
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) um[i][j] = ut[j][i];
  larf_left(um, 1, 0, 3, u, tq1);
  larf_left(um, 0, 0, 3, v, tq0);
  larf_right(vt, 0, g, tp0);
  // V = VT^T, its last column negated where det U det V < 0; R = V U^T
  const bool flip = det_negative(um) != det_negative(vt);
  float* o = out + (size_t)row * 9;
  for (int i = 0; i < 3; ++i) {
    const float v2 = flip ? -vt[2][i] : vt[2][i];
    for (int j = 0; j < 3; ++j) {
      float r = mul(vt[0][i], um[j][0]);
      r = fma32(vt[1][i], um[j][1], r);
      r = fma32(v2, um[j][2], r);
      o[3 * i + j] = r;
    }
  }
}

}  // namespace kabsch
}  // namespace quatro

// src, dst (rows, n, 3) and w (rows, n) f32; out (rows, 3, 3) f32. rows > 0.
extern "C" int quatro_kabsch(const float* src, const float* dst, const float* w, int rows,
                             int n, float* out, cudaStream_t stream) {
  if (rows <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  quatro::kabsch::kabsch_kernel<<<rows, 32, 0, stream>>>(src, dst, w, n, out);
  return (int)cudaGetLastError();
}
