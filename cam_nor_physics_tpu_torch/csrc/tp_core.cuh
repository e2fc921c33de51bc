// Lin-Rood FFSL/PPM stencil helpers for the Hopper stencil kernels.
//
// Device twins of the whole-slab formulas in ops/tp_core.py (and of
// cam_nor_physics_tpu/ops/tp_core.py, which the TPU kernels run in VMEM).
// Each helper evaluates ONE output point from a slab held in device memory,
// recomputing the few neighbour slopes and edge values it needs instead of
// materializing whole intermediate slabs: a PPM x-flux needs cells i-3..i+2
// of its row, a PPM y-flux rows e-3..e+2 of its column. The expressions keep
// the operand order of the PyTorch versions so that, compiled without FMA
// contraction (--fmad=false), kernel and plain version round alike.
//
// Orders: iord/jord in {1, 2, 3, 4, 5, 6, 7, -2}, scalar pole mirroring
// (iv=0): upwind, van Leer, PPM with lmppm's constraints 0-3, Yeh
// steepening (6), Huynh's constraint (7), the unlimited slope of -2. The
// order is a runtime argument, uniform over a launch, so its branches do
// not diverge. The host wrappers refuse other orders.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tpc {

constexpr double COS_UPW = 0.05;
constexpr double COS_VAN = 0.10;
constexpr double COS_PPM = 0.10;
constexpr double R3 = 1.0 / 3.0;
constexpr double R23 = 2.0 / 3.0;

template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

// sign(d) * min(|d|, qmax, qmin): the monotonic slope limiter
template <typename T>
__device__ __forceinline__ T limit(T d, T qmax, T qmin) {
  return sgn(d) * tmin(tmin(fabs(d), qmax), qmin);
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// ---------------------------------------------------------------- x row ops

// xmist(q, 2) at cell i: 4th-order slope with the monotonic limiter
template <typename T>
__device__ T xmist4(const T* r, int i, int im) {
  const T q = r[i];
  const T qp1 = r[wrap(i + 1, im)], qm1 = r[wrap(i - 1, im)];
  const T qp2 = r[wrap(i + 2, im)], qm2 = r[wrap(i - 2, im)];
  const T dm = T(1.0 / 24.0) * (T(8.0) * (qp1 - qm1) + qm2 - qp2);
  const T qmax = tmax(tmax(qm1, q), qp1) - q;
  const T qmin = q - tmin(tmin(qm1, q), qp1);
  return limit(dm, qmax, qmin);
}

// 2nd-order limited slope of the FFSL branch (tp_core.F90:392-398)
template <typename T>
__device__ T xslope2(const T* r, int i, int im) {
  const T q = r[i];
  const T qp1 = r[wrap(i + 1, im)], qm1 = r[wrap(i - 1, im)];
  const T tmp = T(0.25) * (qp1 - qm1);
  const T qmax = tmax(tmax(qm1, q), qp1) - q;
  const T qmin = q - tmin(tmin(qm1, q), qp1);
  return limit(tmp, qmax, qmin);
}

// ---------------------------------------------------------------- PPM edges

// xmist(q, id) at cell i for id < 0: the 4th-order slope, unlimited
template <typename T>
__device__ T xmist4u(const T* r, int i, int im) {
  const T qp1 = r[wrap(i + 1, im)], qm1 = r[wrap(i - 1, im)];
  const T qp2 = r[wrap(i + 2, im)], qm2 = r[wrap(i - 2, im)];
  return T(1.0 / 24.0) * (T(8.0) * (qp1 - qm1) + qm2 - qp2);
}

// steepx at cell i: Yeh's steepening of the left edge al, dmm and dm the
// slopes of cells i-1 and i; reads cells i-3..i+2 of the row
template <typename T>
__device__ T steepx_point(const T* r, int i, int im, T al, T dmm, T dm) {
  auto p = [&](int o) { return r[wrap(i + o, im)]; };
  auto dh = [&](int o) { return p(o + 1) - p(o); };
  auto d2 = [&](int o) { return dh(o) - dh(o - 1); };
  auto eta = [&](int o) {
    const T pp1 = p(o + 1), pm1 = p(o - 1);
    const T denom = pp1 == pm1 ? T(1.0) : pp1 - pm1;
    const T xxx = T(1.0) - T(0.5) * (p(o + 2) - p(o - 2)) / denom;
    const T e = xxx < T(0) ? T(0) : (xxx > T(0.5) ? T(0.5) : xxx);
    return d2(o + 1) * d2(o - 1) < T(0) && pp1 != pm1 ? e : T(0);
  };
  const T et = eta(0), etm = eta(-1);
  const T bbb = (T(2.0) * et - etm) * dmm;
  const T ccc = (T(2.0) * etm - et) * dm;
  return al + T(0.5) * (etm - et) * dh(-1) + (bbb - ccc) * T(R3);
}

// huynh at cell i: Huynh's second constraint on (al, ar), then a6
template <typename T>
__device__ void huynh_point(const T* r, int i, int im, T& al, T& ar, T& a6) {
  auto p = [&](int o) { return r[wrap(i + o, im)]; };
  auto d1 = [&](int o) { return p(o) - p(o - 1); };
  auto d2 = [&](int o) { return d1(o + 1) - d1(o); };
  const T q = p(0), d1c = d1(0), d2m = d2(-1);
  const T pmp_r = q + T(2.0) * d1c;
  const T lac_r = q + T(0.5) * (d1c + d2m) + d2m;
  T pmin = tmin(tmin(q, pmp_r), lac_r), pmax = tmax(tmax(q, pmp_r), lac_r);
  ar = tmin(pmax, tmax(ar, pmin));
  const T d1p = d1(1), d2p = d2(1);
  const T pmp_l = q - T(2.0) * d1p;
  const T lac_l = q + T(0.5) * (d2p - d1p) + d2p;
  pmin = tmin(tmin(q, pmp_l), lac_l);
  pmax = tmax(tmax(q, pmp_l), lac_l);
  al = tmin(pmax, tmax(al, pmin));
  a6 = T(3.0) * (q + q - (al + ar));
}

// lmppm with constraint lmt (0 full, 1 improved full, 2 positive
// definite, 3 quasi-monotone, other values none) on (a6, ar, al)
template <typename T>
__device__ void lmppm(T dm, T p, int lmt, T& a6, T& ar, T& al) {
  if (lmt == 0) {
    const T da1 = ar - al;
    const T da2 = da1 * da1, a6da = a6 * da1;
    const T a6_lo = T(3.0) * (al - p), ar_lo = al - a6_lo;
    const T a6_hi = T(3.0) * (ar - p), al_hi = ar - a6_hi;
    if (dm == T(0)) {
      a6 = T(0);
      ar = p;
      al = p;
    } else if (a6da < -da2) {
      a6 = a6_lo;
      ar = ar_lo;
    } else if (a6da > da2) {
      a6 = a6_hi;
      al = al_hi;
    }
  } else if (lmt == 1 || lmt == 3) {
    const T da1 = lmt == 1 ? dm + dm : T(4.0) * dm;
    const T dl = sgn(da1) * tmin(fabs(da1), fabs(al - p));
    const T dr = sgn(da1) * tmin(fabs(da1), fabs(ar - p));
    a6 = T(3.0) * (dl - dr);
    ar = p + dr;
    al = p - dl;
  } else if (lmt == 2) {
    const T d = ar - al;
    const T fmin = p + T(0.25) * (d * d) / (a6 == T(0) ? T(1e-30) : a6) +
                   a6 * T(1.0 / 12.0);
    if (!(fabs(d) >= -a6 || fmin >= T(0))) {
      if (p < ar && p < al) {
        a6 = T(0);
        ar = p;
        al = p;
      } else if (ar > al) {
        a6 = T(3.0) * (al - p);
        ar = al - a6;
      } else {
        a6 = T(3.0) * (ar - p);
        al = ar - a6;
      }
    }
  }
}

// _ppm_edges at cell i: (al, ar, a6) at order iord >= 3, the edges
// steepened at 6; SLOPE(i) gives dm at i
template <typename T, typename Slope>
__device__ void xedges(const T* r, int i, int im, Slope slope, int iord,
                       T& al, T& ar, T& a6) {
  const int im1 = wrap(i - 1, im), ip1 = wrap(i + 1, im);
  const T dmm = slope(im1), dm = slope(i), dmp = slope(ip1);
  const T p = r[i];
  al = T(0.5) * (r[im1] + p) + (dmm - dm) * T(R3);
  ar = T(0.5) * (p + r[ip1]) + (dm - dmp) * T(R3);
  if (iord == 6) {
    al = steepx_point(r, i, im, al, dmm, dm);
    ar = steepx_point(r, ip1, im, ar, dm, dmp);
  }
  if (iord == 7) {
    huynh_point(r, i, im, al, ar, a6);
    return;
  }
  a6 = iord == 3 || iord == 5 ? T(3.0) * (p + p - (al + ar)) : T(0);
  lmppm(dm, p, iord - 3, a6, ar, al);
}

// xtp at the west edge of cell i of one row. q, c, m: row pointers (im);
// cosa the row's cosine; ffsl whether the row takes the FFSL branch; K the
// integer-Courant bound. id = 0: density (m = Courant); id = 1: mixing
// ratio (the FFSL flux is rescaled by m / c).
template <typename T>
__device__ T xtp_point(const T* q, const T* c, const T* m, int i, int im,
                       T cosa, bool ffsl, int iord, int id, int K) {
  const T ci = c[i];
  if (!ffsl) {
    const bool up = ci > T(0);
    const int d = up ? wrap(i - 1, im) : i;     // the donor cell
    const T qs = q[d];
    if (iord == 1 || cosa < T(COS_UPW)) return m[i] * qs;
    // xmist(q, 2), or xmist(q, iord) off the van Leer rows for iord < 0
    const bool lim = iord > 0 || cosa < T(COS_VAN);
    auto slope = [&](int ii) {
      return lim ? xmist4(q, ii, im) : xmist4u(q, ii, im);
    };
    if (cosa < T(COS_VAN) || iord == 2 || iord == -2)
      return m[i] * (qs + slope(d) * (sgn(ci) - ci));
    T al, ar, a6;
    xedges(q, d, im, slope, iord, al, ar, a6);
    const T f = up
        ? ar + T(0.5) * ci * (al - ar + a6 * (T(1.0) - T(R23) * ci))
        : al - T(0.5) * ci * (ar - al + a6 * (T(1.0) + T(R23) * ci));
    return m[i] * f;
  }
  // FFSL branch: fractional donor cell + whole cells swept (periodic)
  int iu = (int)trunc(ci);
  iu = iu < -K ? -K : (iu > K ? K : iu);
  const T rut = ci - T(iu);
  const int g = wrap(i + (ci > T(0) ? -iu - 1 : -iu), im);
  const T qg = q[g];
  T f_frac;
  if (iord == 1 || cosa < T(COS_UPW)) {
    f_frac = rut * qg;
  } else if (iord >= 3 && cosa > T(COS_PPM)) {
    auto slope = [&](int ii) { return xslope2(q, ii, im); };
    T al, ar, a6;
    xedges(q, g, im, slope, iord, al, ar, a6);
    f_frac = ci > T(0)
        ? rut * (ar + T(0.5) * rut * (al - ar + a6 * (T(1.0) - T(R23) * rut)))
        : rut * (al - T(0.5) * rut * (ar - al + a6 * (T(1.0) + T(R23) * rut)));
  } else {
    const T dmg = xslope2(q, g, im);
    f_frac = ci > T(0) ? rut * (qg + dmg * (T(1.0) - rut))
                       : rut * (qg - dmg * (T(1.0) + rut));
  }
  T f_int = T(0);
  if (ci >= T(1)) {
    for (int n = 1; n <= iu; ++n) f_int = f_int + q[wrap(i - n, im)];
  } else if (ci <= T(-1)) {
    for (int n = 0; n < -iu; ++n) f_int = f_int + q[wrap(i + n, im)];
    f_int = -f_int;
  }
  T fx = f_frac + f_int;
  if (id != 0) {
    const T c_safe = sgn(ci) * tmax(fabs(ci), T(1e-30));
    fx = fx * (m[i] / c_safe);
  }
  return fx;
}

// ---------------------------------------------------------------- y ops

// ymist(q, jord, iv=0) at (j, i) of a (jm, im) slab
template <typename T>
__device__ T ymist_point(const T* s, int j, int i, int jm, int im, int jord) {
  const int im2 = im / 2;
  if (j == 0 || j == jm - 1) {
    // pole row: the first half from the cross-pole mirror, the second
    // half the negated first half (tp_core.F90:1149-1151)
    const int ii = i < im2 ? i : i - im2;
    const int jp = j == 0 ? 0 : jm - 1;      // the pole row
    const int jn = j == 0 ? 1 : jm - 2;      // its neighbour
    const T qp = s[jp * im + ii];
    const T qn = s[jn * im + ii];
    const T qmir = s[jn * im + wrap(ii + im2, im)];
    const T tmp = j == 0 ? T(0.25) * (qn - qmir) : T(0.25) * (qmir - qn);
    const T qmax = j == 0 ? tmax(tmax(qn, qp), qmir) - qp
                          : tmax(tmax(qmir, qp), qn) - qp;
    const T qmin = j == 0 ? qp - tmin(tmin(qn, qp), qmir)
                          : qp - tmin(tmin(qmir, qp), qn);
    const T v = limit(tmp, qmax, qmin);
    return i < im2 ? v : T(-1.0) * v;
  }
  const T qm = s[(j - 1) * im + i], q = s[j * im + i], qp = s[(j + 1) * im + i];
  T d = T(0.25) * (qp - qm);
  if (jord > 0) {
    const T qmax = tmax(tmax(qm, q), qp) - q;
    const T qmin = q - tmin(tmin(qm, q), qp);
    d = limit(d, qmin, qmax);
  }
  return d;
}

// fyppm's unconstrained south-edge value of row j >= 1
template <typename T>
__device__ T yal_full(const T* s, int j, int i, int jm, int im, int jord) {
  return T(0.5) * (s[(j - 1) * im + i] + s[j * im + i]) +
         T(R3) * (ymist_point(s, j - 1, i, jm, im, jord) -
                  ymist_point(s, j, i, jm, im, jord));
}

// ytp at the south edge of row e (iv = 0): s the advected slab, c the
// y-Courant and ym the mass flux at the edge. Upwind at jord 1, van Leer
// at |jord| = 2, fyppm with a6 at 3 and 5 and lmppm(jord - 3) from 3 up
template <typename T>
__device__ T ytp_point(const T* s, const T* c, const T* ym, int e, int i,
                       int jm, int im, int jord) {
  const int idx = e * im + i;
  if (e == 0) return T(0) * ym[idx];
  const T ce = c[idx];
  if (jord == 1) return (ce > T(0) ? s[idx - im] : s[idx]) * ym[idx];
  const int r = ce > T(0) ? e - 1 : e;          // donor row
  const T dm = ymist_point(s, r, i, jm, im, jord);
  const T q = s[r * im + i];
  if (jord > -3 && jord < 3) return (q + (sgn(ce) - ce) * dm) * ym[idx];
  const int im2 = im / 2;
  T al = r == 0 ? yal_full(s, 1, wrap(i + im2, im), jm, im, jord)
                : yal_full(s, r, i, jm, im, jord);
  T ar = r < jm - 1 ? yal_full(s, r + 1, i, jm, im, jord)
                    : yal_full(s, jm - 1, wrap(i + im2, im), jm, im, jord);
  T a6 = jord == 3 || jord == 5 ? T(3.0) * (q + q - (al + ar)) : T(0);
  lmppm(dm, q, jord - 3, a6, ar, al);
  const T f = ce > T(0)
      ? ar + T(0.5) * ce * (al - ar + a6 * (T(1.0) - T(R23) * ce))
      : al - T(0.5) * ce * (ar - al + a6 * (T(1.0) + T(R23) * ce));
  return f * ym[idx];
}

// ---------------------------------------------------------------- tp2d parts

// adx: q advanced by the first-order inner x-operator (tp_core.F90:228-256)
template <typename T>
__device__ T adx_point(const T* q, const T* crx, int j, int i, int jm, int im,
                       T cosa, bool ffsl, int K) {
  const int idx = j * im + i;
  if (j == 0 || j == jm - 1) return q[idx];
  const T* qr = q + j * im;
  const T* cr = crx + j * im;
  const int ip1 = wrap(i + 1, im);
  const T wk1 = xtp_point(qr, cr, cr, i, im, cosa, ffsl, 1, 0, K);
  const T wk1e = xtp_point(qr, cr, cr, ip1, im, cosa, ffsl, 1, 0, K);
  return q[idx] + T(0.5) * (wk1 - wk1e + q[idx] * (cr[ip1] - cr[i]));
}

// ady: q advanced by the first-order inner y-operator (tp_core.F90:260-265)
template <typename T>
__device__ T ady_point(const T* q, const T* va, int j, int i, int jm, int im) {
  const int idx = j * im + i;
  const T qc = q[idx];
  if (j == 0 || j == jm - 1) return qc;
  const T v = va[idx];
  return qc + T(0.5) * v * (v > T(0) ? q[idx - im] - qc : qc - q[idx + im]);
}

// flux divergence at (j, i) with the caps given (tp_core.F90:130-152)
template <typename T>
__device__ T div_point(const T* fx, const T* fy, int j, int i, int jm, int im,
                       T acosp, T cap_s, T cap_n) {
  if (j == 0) return cap_s;
  if (j == jm - 1) return cap_n;
  const int idx = j * im + i;
  return fx[idx] - fx[j * im + wrap(i + 1, im)] +
         (fy[idx] - fy[idx + im]) * acosp;
}

// sum of one row (one thread), accumulated in double: for float rows the
// result does not depend on the order, so it matches the plain version's
// torch.sum of the same row in float64. In index order; unrolled so that
// the loads run ahead of the dependent sum
template <typename T>
__device__ double row_sum(const T* r, int im) {
  double s = 0.0;
#pragma unroll 16
  for (int i = 0; i < im; ++i) s = s + (double)r[i];
  return s;
}

// whether a row j whose FFSL flag is `flag` takes the FFSL branch: with
// band >= 0 only `band` rows at each pole (ffsl_band in ops/tp_core.py)
__device__ __forceinline__ bool ffsl_in_band(bool flag, int j, int jm,
                                             int band) {
  if (!flag) return false;
  if (band < 0 || 2 * band >= jm) return true;
  return j < band || j >= jm - band;
}

// whether row j takes the FFSL branch, from the per-row flags
__device__ __forceinline__ bool ffsl_row(const uint8_t* ffsl, int j, int jm,
                                         int band) {
  return ffsl_in_band(ffsl[j] != 0, j, jm, band);
}

// ---------------------------------------------------------------- row form
//
// tp2c of a thickness h plus the mass-consistent tp2d of a field q (id = 1
// with the mass fluxes just computed), ONE row j of a level at a time, by
// one thread block of a (row, level) grid, kRowThreads threads over i.
// Each phase reads other rows only of what an earlier phase wrote, so the
// phase boundaries are the caller's launch boundaries:
//   1. row_ffsl_flag over the row's Courants (or the caller's flags);
//      tp_row_inner: adx/ady of the fields (h and q for tp2c + tp2d);
//   2. tp_flux_kernel<T, 0>: tp2c's mass fluxes mfy (from rows
//      j-3..j+1 of adx(h)) and mfx;
//   3. tp_q_flux_kernel: row_cap of mfy, then tp_row_div: dh; q's fluxes
//      fy (from rows j-3..j+1 of adx(q)) and fx;
//   4. tp_div_kernel: row_cap of fy, then dq = div_point(fx, fy, ...).
// transport3d (stencil_kernels.cu) runs the four; K1 and K3
// (cd_fused_kernels.cu) phases 1-3, then a phase 4 of their own with the
// floors; a tracer (tracer_div3d) phases 1, 2 with kId = 1 and the given
// mass fluxes, and 4; vort_flux3d is phase 2 on the vorticity.
// The points evaluate the same functions as the plain versions' whole-slab
// formulas, in their operand order.

constexpr int kRowThreads = 64;    // row kernels' block (a power of two)

// the FFSL flag of a row of im Courants c: some |c| above 1 (a max, exact
// in any order), by a shared-memory reduction over the block's N threads
// (a power of two). Every thread of the block calls it and gets the flag.
template <typename T, int N>
__device__ bool row_ffsl_flag(const T* c, int im) {
  __shared__ T red[N];
  T mx = T(0);
  for (int i = threadIdx.x; i < im; i += blockDim.x)
    mx = tmax(mx, (T)fabs(c[i]));
  red[threadIdx.x] = mx;
  __syncthreads();
  for (int h = N / 2; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h)
      red[threadIdx.x] = tmax(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  return red[0] > T(1);
}

// the polar cap of row j from the slab's y-fluxes fy: -sum(fy row 1) on
// row 0, +sum(fy row jm-1) on row jm-1, times rcap (one thread's row_sum);
// 0 on other rows. Every thread of the block calls it (once a kernel: it
// synchronises) and gets the cap.
template <typename T>
__device__ T row_cap(const T* fy, int j, int jm, int im, double rcap) {
  __shared__ T cap;
  if (threadIdx.x == 0) {
    if (j == 0) {
      cap = (T)(-row_sum(fy + im, im) * rcap);
    } else if (j == jm - 1) {
      cap = (T)(row_sum(fy + (jm - 1) * im, im) * rcap);
    } else {
      cap = T(0);
    }
  }
  __syncthreads();
  return cap;
}

// phase 1 at row j of NF fields q[n]: sx[n] = adx(q[n]), sy[n] =
// ady(q[n]), the fields' points side by side in one loop over i; f the
// row's FFSL branch, cosa its cosine
template <int NF, typename T>
__device__ void tp_row_inner(const T* const* q, const T* cx, const T* va,
                             bool f, T cosa, int K, int j, int jm, int im,
                             T* const* sx, T* const* sy) {
  for (int i = threadIdx.x; i < im; i += blockDim.x) {
    const int idx = j * im + i;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      sx[n][idx] = adx_point(q[n], cx, j, i, jm, im, cosa, f, K);
      sy[n][idx] = ady_point(q[n], va, j, i, jm, im);
    }
  }
}

// phases 2 and 3 at row j: the fluxes fy = ytp(sx)·ym and fx = xtp(sy)
// of a field whose inner operators are sx = adx, sy = ady. id = 0 (tp2c's
// mass fluxes of h): ym = yfx and xm = cx, the Courant number is the
// flux; id = 1 (a mixing ratio): ym, xm the mass fluxes
template <typename T>
__device__ void tp_row_fluxes(const T* sx, const T* sy, const T* cx,
                              const T* cy, const T* xm, const T* ym, int id,
                              bool f, T cosa, int iord, int jord, int K,
                              int j, int jm, int im, T* fx, T* fy) {
  const int r = j * im;
  for (int i = threadIdx.x; i < im; i += blockDim.x) {
    fy[r + i] = ytp_point(sx, cy, ym, j, i, jm, im, jord);
    fx[r + i] = xtp_point(sy + r, cx + r, xm + r, i, im, cosa, f, iord, id,
                          K);
  }
}

// the flux divergence of row j into out, cap its row_cap of fy
template <typename T>
__device__ void tp_row_div(const T* fx, const T* fy, T acosa, T cap, int j,
                           int jm, int im, T* out) {
  for (int i = threadIdx.x; i < im; i += blockDim.x)
    out[j * im + i] = div_point(fx, fy, j, i, jm, im, acosa, cap, cap);
}

// ---------------------------------------------------------------- row kernels
//
// Phases 2-4 as kernels on a (jm, km, nf) grid: blockIdx.x the row j,
// blockIdx.y the level k, blockIdx.z the field (nf = 1 but for
// tracer_div3d's tracers). Every slab argument is an (nf, km, jm, im) or
// (km, jm, im) array (a scratch slab of all levels included): the fields'
// at slab row_slab(), the winds', fluxes' and FFSL flags' ((km, jm)
// bytes) at level k; cosp and acosp are the (jm,) row factors.

// the block's slab of the fields: field blockIdx.z, level blockIdx.y
__device__ __forceinline__ size_t row_slab() {
  return (size_t)blockIdx.z * gridDim.y + blockIdx.y;
}

// phase 2: the fluxes of row j, fy = ytp(sx)·ym and fx = xtp(sy)·xm
// (tp_row_fluxes; kId = 0 for tp2c's mass fluxes, 1 for a mixing ratio).
// In float32, 32 blocks an SM (at most 32 registers): left to itself
// ptxas takes 40 for the higher orders' code, and the 25 blocks that
// leaves cost transport3d 6% at order 1 at f05 (tools/stencil_ab.py)
template <typename T, int kId>
__global__ void __launch_bounds__(kRowThreads, sizeof(T) == 4 ? 32 : 1)
tp_flux_kernel(const T* __restrict__ sx, const T* __restrict__ sy,
               const T* __restrict__ crx, const T* __restrict__ cry,
               const T* __restrict__ xm, const T* __restrict__ ym,
               const uint8_t* __restrict__ flags,
               const T* __restrict__ cosp, int iord, int jord, int band,
               int K, int jm, int im, T* __restrict__ fx,
               T* __restrict__ fy) {
  const int j = blockIdx.x, k = blockIdx.y;
  const size_t n = (size_t)jm * im, fo = row_slab() * n, wo = k * n;
  tp_row_fluxes(sx + fo, sy + fo, crx + wo, cry + wo, xm + wo, ym + wo, kId,
                ffsl_row(flags + (size_t)k * jm, j, jm, band), cosp[j], iord,
                jord, K, j, jm, im, fx + fo, fy + fo);
}

// phase 3 (nf = 1): the thickness tendency dh, the divergence of the mass
// fluxes with the caps closed, and q's fluxes from sx = adx(q), sy =
// ady(q). In float32, at least 25 blocks an SM (at most 40 registers;
// ptxas then takes 32): left to itself it takes 48, and the 21 blocks
// that leaves cost K1's call 8% at f05 (tools/stencil_ab.py)
template <typename T>
__global__ void __launch_bounds__(kRowThreads, sizeof(T) == 4 ? 25 : 1)
tp_q_flux_kernel(const T* __restrict__ sx, const T* __restrict__ sy,
                 const T* __restrict__ crx, const T* __restrict__ cry,
                 const T* __restrict__ mfx, const T* __restrict__ mfy,
                 const uint8_t* __restrict__ flags,
                 const T* __restrict__ cosp, const T* __restrict__ acosp,
                 double rcap, int iord, int jord, int band, int K, int jm,
                 int im, T* __restrict__ dh, T* __restrict__ fx,
                 T* __restrict__ fy) {
  const int j = blockIdx.x, k = blockIdx.y;
  const size_t off = (size_t)k * jm * im;
  const T cap = row_cap(mfy + off, j, jm, im, rcap);
  tp_row_div(mfx + off, mfy + off, acosp[j], cap, j, jm, im, dh + off);
  tp_row_fluxes(sx + off, sy + off, crx + off, cry + off, mfx + off,
                mfy + off, 1, ffsl_row(flags + (size_t)k * jm, j, jm, band),
                cosp[j], iord, jord, K, j, jm, im, fx + off, fy + off);
}

// phase 4: the row's cap of fy, then the flux divergence of the slab into
// out
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
tp_div_kernel(const T* __restrict__ fx, const T* __restrict__ fy,
              const T* __restrict__ acosp, double rcap, int jm, int im,
              T* __restrict__ out) {
  const int j = blockIdx.x;
  const size_t off = row_slab() * jm * im;
  const T cap = row_cap(fy + off, j, jm, im, rcap);
  tp_row_div(fx + off, fy + off, acosp[j], cap, j, jm, im, out + off);
}

}  // namespace tpc
