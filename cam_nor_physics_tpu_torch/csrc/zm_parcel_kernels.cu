// Hopper kernel for ZM's dilute parcel and its CAPE/CIN: buoyan_dilute
// with the batched parcel (the launch level, the entraining ascent, the
// LCL, the precipitation/freezing sweeps, the buoyancy and the CAPE, CIN
// and lel selection) in one launch.
//
// Replaces no Pallas TPU kernel: the JAX package's buoyan_dilute
// (cam_nor_physics_tpu/models/physics/zm_conv.py) is jnp. Its plain
// PyTorch version, the kernel's twin, is models/physics/zm_conv.py::
// buoyan_dilute with parcel_impl "batched" and the solver "newton" or
// "newton_exact" of ops/thermo.py; on a card that version issues ~6,950
// launches a call, one per elementwise operation on (ncol,) level rows.
//
// Design. One launch; each block takes a tile of neighbouring columns (16
// at 26 levels) and keeps its profiles in shared memory (5,632 values,
// static: 44 KB in float64, 22 KB in float32; each column's arrays side
// by side at an odd column stride), loaded and stored with coalesced
// accesses: (ncol, pver) is level-contiguous. The
// work that is independent per (column, level) runs one thread per
// (column, level): the environment terms, the ascent's enthalpy
// inversions, each sweep's entropy inversions, the final profiles. The
// recursions run one thread per column: the launch level, the suffix sums
// of the entrainment budget, the LCL search, each sweep's carry scan and
// the CAPE/CIN search. Phases are separated by __syncthreads(). A phase
// of inversions takes only the levels above each column's launch level,
// packed over the block's threads, and the first sweep's phase also takes
// each column's LCL inversion. 864 blocks at f19, 4 a SM in float64
// and 7 in float32 (registers). The wrapper refuses more
// than kMaxK levels. Half the shared memory in float32 took f19's call
// from 0.487 to 0.421 ms; tiles of 8 and 12 columns, or of 16 and 32
// columns with 256 threads, were slower there.
//
// Bound. The parcel reads 5 (ncol, pver) profiles (q, t, p, z, dmpdz), 2
// on interfaces and 4 column values, and writes 3 profiles and 7 column
// values: about 14 MB in float32 at f19 (13,824 columns x 26 levels), 4 us
// at 3.35 TB/s. Its arithmetic is about 2,000 operations per column and
// level (ops/cost.py's OPS_PARCEL_*: the secant inversions, each of ten
// enthalpy or entropy evaluations with a Goff-Gratch saturation of three
// powers and a logarithm), ~7e8 operations, 11 us at 67 TFLOP/s: the
// operations bound it. The kernel takes ~40 times that: a power or a
// logarithm costs tens of instructions, not one (~2e4 instructions a
// point, ~0.2 ms of the card's issue rate at f19), and the recursions run
// on a column's thread while the tile's others wait at the barrier.
//
// Numerics. The formulas and the operand order are the plain version's,
// one rounding per PyTorch operation: x / c for a Python constant c is
// x * (1/c) (PyTorch on the card multiplies by the reciprocal of a CPU
// scalar, taken in double and rounded once: 1.0f / 273.15f is an ulp off
// it), c / x is (1/x) * c (Tensor.__rtruediv__), and the library compiles
// with --fmad=false. The suffix sums add in the order of
// torch.cumsum on the card (flip, then the Sklansky network of
// ATen's innermost-dimension scan over chunks of 32 levels, the same for
// any of its widths up to 32 levels), so that the targets of the
// inversions round as the plain version's do there: in float32 the secant
// is sensitive to an ulp (a step divided by the 1e-12 guard is clamped to
// 10 K). The CAPE and CIN sums and the PBL mixing sums add in the order of
// torch.sum on the card (row_sum), so that CAPE and CIN round as the plain
// version's do there: the closure scales the mass flux by CAPE, and the
// coupled step carries an ulp of it on.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 64;       // zm_parcel_kernels.MAX_LEVELS
constexpr int kThreads = 128;
constexpr int kMaxTile = 16;    // columns a block
constexpr int kSmemElems = 5632;  // a tile's values: 44 KB of double, 22 of float
constexpr int kMaxCin = 5;      // ZMConfig: num_cin <= 5

// utils/constants.py, the same double expressions
constexpr double kRgasU = 6.02214e26 * 1.38065e-23;
constexpr double kRair = kRgasU / 28.966;
constexpr double kRh2o = kRgasU / 18.016;
constexpr double kEpsilo = 18.016 / 28.966;
constexpr double kOmeps = 1.0 - kEpsilo;
constexpr double kGrav = 9.80616;
constexpr double kCpair = 1.00464e3;
constexpr double kCpwv = 1.810e3;
constexpr double kCpliq = 4.188e3;
constexpr double kTmelt = 273.15;
constexpr double kLatvap = 2.501e6;
constexpr double kLatice = 3.337e5;
constexpr double kCdiff = kCpliq - kCpwv;            // c.CPLIQ - c.CPWV
constexpr double kLog10Water = 3.0057148979490314;   // math.log10(1013.246)
constexpr double kLwmax = 1.0e-3;                    // _parcel_finish's lwmax

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return (a > b || a != a) ? a : b; }

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return (a < b || a != a) ? a : b; }

// torch.clamp(x, lo, hi): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clampn(T x, T lo, T hi) { return tmin(tmax(x, lo), hi); }

// _safe_div: in float32 its 1e-300 is 0, a plain division
template <typename T>
__device__ __forceinline__ T safe_div(T a, T b) {
  if constexpr (sizeof(T) < sizeof(double)) {
    return a / b;
  } else {
    const T eps = T(1.0e-300);
    return a / (fabs(b) < eps ? (b >= T(0) ? eps : -eps) : b);
  }
}

// the factor x / c takes on the card: the reciprocal of the Python float c
// in double, rounded once
template <typename T>
__device__ __forceinline__ T inv(double c) { return T(1.0 / c); }

// ---- ops/saturation.py: Goff-Gratch over water, the ZM plume's qsat ----
template <typename T>
__device__ T svp_water(T t) {
  const T ts = T(373.16);
  const T a = (T(1) / t) * ts;                       // ts / t
  T e = T(-7.90298) * (a - T(1));
  e = e + T(5.02808) * log10(a);
  e = e - T(1.3816e-7) * (pow(T(10), T(11.344) * (T(1) - t * inv<T>(373.16))) - T(1));
  e = e + T(8.1328e-3) * (pow(T(10), T(-3.49149) * (a - T(1))) - T(1));
  e = e + T(kLog10Water);
  return pow(T(10), e) * T(100);
}

// qsat_water(t, p) with p in Pa: es = min(svp, p) and qs
template <typename T>
struct Sat {
  T es, qs;
};

template <typename T>
__device__ Sat<T> qsat_water(T t, T p) {
  Sat<T> s;
  s.es = tmin(svp_water(t), p);
  const T qs = (T(kEpsilo) * s.es) / (p - T(kOmeps) * s.es);
  s.qs = p - s.es <= T(0) ? T(1) : qs;
  return s;
}

// qsat_hpa's qs, p in hPa
template <typename T>
__device__ __forceinline__ T qsat_hpa(T t, T p_hpa) {
  return qsat_water(t, p_hpa * T(100)).qs;
}

// d(qsat_water)/dT, p in Pa
template <typename T>
__device__ T dqsdt_water(T t, T p) {
  const Sat<T> s = qsat_water(t, p);
  const T desdt = (T(kLatvap) * s.es) / ((T(kRh2o) * t) * t);
  return ((s.qs * p) * desdt) / (s.es * (p - T(kOmeps) * s.es));
}

// ---- ops/thermo.py: enthalpy, entropy and their inversions ----
template <typename T>
__device__ __forceinline__ T latent(T tk) {        // RL - (cl - cpv)(T - Tf)
  return T(kLatvap) - T(kCdiff) * (tk - T(kTmelt));
}

template <typename T>
__device__ T enthalpy(T tk, T p, T qt, T z) {
  const T L = latent(tk);
  const T qv = tmin(qt, qsat_hpa(tk, p));
  return ((T(kCpair) + qt * T(kCpliq)) * tk + L * qv) +
         ((T(1) + qt) * T(kGrav)) * z;
}

template <typename T>
__device__ __forceinline__ T entropy_of(T tk, T p, T qt, T L, T qv, T qst) {
  const T e = (qv * p) / (T(kEpsilo) + qv);
  return (((T(kCpair) + qt * T(kCpliq)) * log(tk * inv<T>(kTmelt)) -
           T(kRair) * log((p - e) * inv<T>(1000.0))) +
          (L * qv) / tk) -
         (qv * T(kRh2o)) * log(qv / qst);
}

template <typename T>
__device__ T entropy(T tk, T p, T qt) {
  const T qst = qsat_hpa(tk, p);
  return entropy_of(tk, p, qt, latent(tk), tmin(qt, qst), qst);
}

// (h, dh/dT) with the saturated branch's exact derivative
template <typename T>
__device__ void enthalpy_deriv(T tk, T p, T qt, T z, T& h, T& dh) {
  const T L = latent(tk);
  const T qst = qsat_hpa(tk, p);
  const bool sat = qt >= qst;
  const T qv = sat ? qst : qt;
  h = ((T(kCpair) + qt * T(kCpliq)) * tk + L * qv) +
      ((T(1) + qt) * T(kGrav)) * z;
  const T dqvdt = sat ? dqsdt_water(tk, p * T(100)) : T(0);
  dh = ((T(kCpair) + qt * T(kCpliq)) - T(kCdiff) * qv) + L * dqvdt;
}

// (s, ds/dT) with the saturated branch's exact derivative
template <typename T>
__device__ void entropy_deriv(T tk, T p, T qt, T& s, T& ds) {
  const T L = latent(tk);
  const T qst = qsat_hpa(tk, p);
  const bool sat = qt >= qst;
  const T qv = sat ? qst : qt;
  const T e = (qv * p) / (T(kEpsilo) + qv);
  s = entropy_of(tk, p, qt, L, qv, qst);
  const T qstp = dqsdt_water(tk, p * T(100));
  const T dqvdt = sat ? qstp : T(0);
  const T ee = T(kEpsilo) + qv;
  const T dedqv = (p * T(kEpsilo)) / (ee * ee);
  const T dlog = sat ? T(0) : ((qv * T(kRh2o)) * qstp) / qst;
  T d = (T(kCpair) + qt * T(kCpliq)) / tk;
  d = d + ((T(kRair) * dedqv) * dqvdt) / (p - e);
  d = d + (T(-kCdiff) * qv + L * dqvdt) / tk;
  d = d - (L * qv) / (tk * tk);
  ds = d + dlog;
}

// _newton_invert: 7 damped secant steps from the guess; *conv (when
// asked) is its convergence test
template <typename T, typename F>
__device__ T secant(F f, T target, T guess, bool* conv) {
  T tp = guess;
  T fp = f(tp) - target;
  T tc = tp + (fp > T(0) ? T(-0.5) : T(0.5));
  for (int i = 0; i < 7; ++i) {
    const T fc = f(tc) - target;
    T denom = fc - fp;
    if (fabs(denom) < T(1e-12)) denom = denom >= T(0) ? T(1e-12) : T(-1e-12);
    const T step = (fc * (tc - tp)) / denom;
    const T tn = tc - clampn(step, T(-10), T(10));
    tp = tc;
    fp = fc;
    tc = tn;
  }
  if (conv) {
    const T fc = f(tc) - target;
    *conv = fabs(fc) <= fabs(f(tc + T(0.001)) - (fc + target)) +
                            fabs(target) * T(1e-6);
  }
  return tc;
}

// _newton_exact_invert: 4 Newton steps with the analytic derivative
template <typename T, typename FDF>
__device__ T newton_exact(FDF fdf, T target, T guess, bool* conv) {
  T tc = guess, fc, dfc;
  for (int i = 0; i < 4; ++i) {
    fdf(tc, fc, dfc);
    const T step = (fc - target) / tmax(dfc, T(1e-6));
    tc = tc - clampn(step, T(-10), T(10));
  }
  if (conv) {
    fdf(tc, fc, dfc);
    *conv = fabs(fc - target) <= dfc * T(0.001) + fabs(target) * T(1e-6);
  }
  return tc;
}

// ienthalpy / ientropy: T, and (when qs is given) qsat_hpa at T where it
// converged, else at the guess
template <typename T>
__device__ T ienthalpy(T h, T p, T qt, T z, T guess, bool exact, T* qs) {
  bool conv = false;
  bool* cv = qs ? &conv : nullptr;
  const T t = exact
      ? newton_exact([&](T x, T& f, T& df) { enthalpy_deriv(x, p, qt, z, f, df); },
                     h, guess, cv)
      : secant([&](T x) { return enthalpy(x, p, qt, z); }, h, guess, cv);
  if (qs) *qs = qsat_hpa(conv ? t : guess, p);
  return t;
}

template <typename T>
__device__ T ientropy(T s, T p, T qt, T guess, bool exact, T* qs) {
  bool conv = false;
  const T t = exact
      ? newton_exact([&](T x, T& f, T& df) { entropy_deriv(x, p, qt, f, df); },
                     s, guess, &conv)
      : secant([&](T x) { return entropy(x, p, qt); }, s, guess, &conv);
  *qs = qsat_hpa(conv ? t : guess, p);
  return t;
}

// moist static energy, tht total-MSE form (buoyan_dilute's hmn)
template <typename T>
__device__ __forceinline__ T mse(T t, T q, T z) {
  return (((T(kCpair) + q * T(kCpliq)) * t) / (T(1) + q) +
          (((T(1) + q * inv<T>(kEpsilo)) / (T(1) + q)) * T(kGrav)) * z) +
         latent(t) * q;
}

// torch.sum over a row of n <= kMaxK values on the card: ATen's reduction
// along the contiguous dimension (Reduce.cuh) gives lane x of W =
// min(last_pow2(n), 32) lanes the values x and x + W, then halves the
// lanes, W / 2 first (block_x_reduce's shuffles at offsets W / 2, ..., 2,
// 1). Bit for bit with torch.sum on an H100 (PyTorch 2.11, float32 and
// float64, rows of 18 to 64). term(k) is the row's k-th value.
template <typename T, typename F>
__device__ T row_sum(int n, F term) {
  int w = 1;
  while (2 * w <= n && w < 32) w *= 2;
  T v[32];
  for (int x = 0; x < w; ++x) v[x] = x + w < n ? term(x) + term(x + w) : term(x);
  for (int off = w / 2; off > 0; off >>= 1)
    for (int x = 0; x < off; ++x) v[x] = v[x] + v[x + off];
  return v[0];
}

// ---- the block's tile in shared memory ----
//
// Each column of the tile holds the arrays below, S = pver + 1 values
// each, one after another: array a of column col at col CS + a S, with the
// column stride CS = (kArrays S) | 1 odd. Arrays change role between
// phases; their names say each role in turn.
enum : int {
  kT, kQ, kP, kZ,   // t, q, p, z
  kS,               // inc senv -> its suffix sum -> smix
  kQt,              // inc qtenv -> its suffix sum -> qtmix
  kM,               // inc -> its suffix sum -> a sweep's new entropy -> buoy
  kTm, kQs,         // tmix, qsmix; from the first sweep on tmix_c, qsmix_c
  kSe,              // entropy(tmix) -> ln(pf(k+1)/pf(k))
  kXs, kLg, kLt,    // a sweep's xsh2o, cl ln(tmix_c/Tf), Lf / tmix_c
  kArrays
};

// a column's values between the phases
template <typename T>
struct Col {
  int mx, lcl, found, n;   // launch level, LCL level, found it, levels above
  T t_launch, qs_launch, qtp0, sp0;
  T tl_fb, pl;             // tl where no LCL (or no root), pl
  T slcl, qtlcl, zl, tguess, tl;
};

template <typename T>
struct ParcelArgs {
  const T *q, *t, *p, *z, *pf, *zi, *zs, *pblt, *tpert, *dmpdz;
  int q_col, q_lev, dm_col, dm_lev;   // strides of q and dmpdz
  int ncol, pver, msg, num_cin, pbl, exact, sweeps;
  double plclmin, tiedke_add, hscale;
  T *prof;               // tp, qstp, buoy: (3, ncol, pver)
  T *colv;               // tl, cape, cin, pl: (4, ncol)
  long long* idx;        // lcl, lel, mx: (3, ncol)
};

__host__ __device__ inline int col_stride(int S) { return (kArrays * S) | 1; }

// In-place inclusive suffix sum of a[0 .. n): torch.cumsum of the flipped
// row on the card, chunks of 32 (the flipped index j = n - 1 - k) through
// the Sklansky network of ATen's innermost-dimension scan, each chunk's
// first element first adding the previous chunk's total.
template <typename T>
__device__ void suffix_sum(T* a, int n) {
  for (int j0 = 0; j0 < n; j0 += 32) {
    if (j0 > 0) a[n - 1 - j0] = a[n - 1 - j0] + a[n - j0];
    for (int m = 0; m < 5; ++m) {
      const int s = 1 << m;
      for (int u = 0; u < 16; ++u) {
        const int base = ((u >> m) << (m + 1)) | s;
        const int ti = j0 + base + (u & (s - 1)), si = j0 + base - 1;
        if (ti < n) a[n - 1 - ti] = a[n - 1 - ti] + a[n - 1 - si];
      }
    }
  }
}

// the launch level and the parcel's start (buoyan_dilute up to
// _parcel_dilute's sp0), then the entrainment budget's suffix sums
template <typename T>
__device__ void launch_column(const ParcelArgs<T>& a, T* c, Col<T>& cs,
                              int g) {
  const int pver = a.pver, S = pver + 1;
  const T* tt = c + kT * S;
  const T* qq = c + kQ * S;
  const T* pp = c + kP * S;
  const T* zz = c + kZ * S;
  auto take = [&](const T* x, int k) { return k >= 0 && k < pver ? x[k] : T(0); };
  const int pblt = (int)rint((double)a.pblt[g]);
  const int lon = pblt + 2 < pver - 1 ? pblt + 2 : pver - 1;
  int mx;
  T tl0 = T(0), qpar = T(0), pl0 = T(0);
  if (a.pbl) {
    // the PBL-mixed parcel: pressure-weighted mean MSE and q of the layers
    // below parcel_dz above the surface
    const T zs = a.zs[g];
    const T* zi = a.zi + (size_t)g * S;
    const T* pf = a.pf + (size_t)g * S;
    const T pbl_dz = take(zz, pblt) - zs;
    const T parcel_dz = tmax(zi[pver - 1], pbl_dz * T(a.hscale));
    auto w = [&](int k) {
      const T frac = k == pver - 1
          ? T(1)
          : tmin(safe_div(parcel_dz - zi[k + 1], zi[k] - zi[k + 1]), T(1));
      return zi[k + 1] <= parcel_dz ? (pf[k + 1] - pf[k]) * frac : T(0);
    };
    const T wsum = row_sum<T>(pver, w);
    const T hsum = row_sum<T>(pver, [&](int k) { return mse(tt[k], qq[k], zz[k]) * w(k); });
    const T qsum = row_sum<T>(pver, [&](int k) { return qq[k] * w(k); });
    mx = pver - 1;
    for (int k = pver - 1; k >= 0; --k)
      if (zi[k + 1] <= parcel_dz) mx = k;
    const T hpar = hsum / tmax(wsum, T(1e-30));
    qpar = qsum / tmax(wsum, T(1e-30));
    tl0 = ((hpar - T(kLatvap) * qpar) - (parcel_dz + zs) * T(kGrav)) *
          inv<T>(kCpair);
    pl0 = take(pp, mx);
  } else {
    // the largest MSE between the PBL top and lon, ties to the lowest level
    bool any = false, nan = false;
    T best = T(0);
    mx = -1;
    for (int k = pblt > 0 ? pblt : 0; k <= lon; ++k) {
      const T h = mse(tt[k], qq[k], zz[k]);
      if (h != h) nan = true;
      else if (!any || h >= best) { best = h; mx = k; }
      any = true;
    }
    if (!any) mx = lon;
    else if (nan) mx = -1;
  }
  cs.mx = mx;
  cs.t_launch = take(tt, mx);
  const T p_launch = take(pp, mx);
  if (a.pbl) {
    cs.qtp0 = qpar;
    cs.sp0 = enthalpy(tl0, pl0, qpar, T(0));
    cs.tl_fb = tl0;
    cs.pl = pl0;
  } else {
    cs.qtp0 = take(qq, mx);
    cs.sp0 = enthalpy(cs.t_launch, p_launch, cs.qtp0, take(zz, mx));
    cs.tl_fb = cs.t_launch;
    cs.pl = p_launch;
  }
  cs.qs_launch = qsat_hpa(cs.t_launch, p_launch);
  // the increments below the launch level are the plain version's zeros
  for (int k = mx > 0 ? mx : 0; k < pver; ++k)
    c[kS * S + k] = c[kQt * S + k] = c[kM * S + k] = T(0);
  suffix_sum(c + kS * S, pver);
  suffix_sum(c + kQt * S, pver);
  suffix_sum(c + kM * S, pver);
  cs.n = mx > 0 ? mx : 0;
  if (mx >= 0) {
    c[kS * S + mx] = cs.sp0;
    c[kQt * S + mx] = cs.qtp0;
    c[kTm * S + mx] = cs.t_launch;
    c[kQs * S + mx] = cs.qs_launch;
  }
}

// a sweep's per-level terms from (tmix_c, qsmix_c) at level k
template <typename T>
__device__ __forceinline__ void sweep_terms(T* c, int S, int k, T tmc, T qsc) {
  c[kXs * S + k] = tmax((c[kQt * S + k] - qsc) - T(kLwmax), T(0));
  c[kLg * S + k] = log(tmc * inv<T>(kTmelt)) * T(kCpliq);
  c[kLt * S + k] = (T(1) / tmc) * T(kLatice);
}

// the LCL: the smallest level above the launch whose parcel saturates
// there and not below, and the interpolation to it (_parcel_finish)
template <typename T>
__device__ void lcl_column(T* c, int S, Col<T>& cs) {
  const T* tt = c + kT * S;
  const T* pp = c + kP * S;
  const T* zz = c + kZ * S;
  const T* sm = c + kS * S;
  const T* qt = c + kQt * S;
  const T* tm = c + kTm * S;
  const T* qs = c + kQs * S;
  cs.lcl = cs.mx;
  cs.found = 0;
  for (int k = 0; k < cs.mx; ++k)
    if (qs[k] <= qt[k] && qs[k + 1] > qt[k + 1]) {
      cs.lcl = k;
      cs.found = 1;
      break;
    }
  if (!cs.found) return;
  const int l = cs.lcl, b = l + 1;
  const T pb = pp[b];
  const T dp_lcl = pp[l] - pb;
  const T qxsk = qt[l] - qs[l];
  const T qxskp1 = qt[b] - qs[b];
  const T dqxsdp = safe_div(qxsk - qxskp1, dp_lcl);
  cs.pl = pb - safe_div(qxskp1, dqxsdp);
  const T tenv = (tt[l] + tt[b]) * T(0.5);
  const T penv = (pp[l] + pp[b]) * T(0.5);
  const T dzdp = (-(tenv * T(kRair))) / (penv * T(kGrav));
  cs.zl = zz[b] - safe_div(qxskp1, dqxsdp) * dzdp;
  const T dsdp = safe_div(sm[l] - sm[b], dp_lcl);
  const T dqtdp = safe_div(qt[l] - qt[b], dp_lcl);
  cs.slcl = sm[b] + dsdp * (cs.pl - pb);
  cs.qtlcl = qt[b] + dqtdp * (cs.pl - pb);
  cs.tguess = tm[l];
}

// one sweep's carry scan, bottom-up over the levels above the launch: the
// new entropy target of each (smix_ent + ds_xsh2o + ds_freeze)
template <typename T>
__device__ void carry_column(T* c, int S, const Col<T>& cs) {
  T xb = T(0), dxb = T(0), dfb = T(0), qsb = cs.qs_launch;
  for (int k = cs.mx - 1; k >= 0; --k) {
    const T xsh = c[kXs * S + k];
    const T tmc = c[kTm * S + k];
    const T qsc = c[kQs * S + k];
    const T dsx = dxb - c[kLg * S + k] * tmax(xsh - xb, T(0));
    T dsf = T(0);
    if (tmc <= T(kTmelt)) {
      if (dfb == T(0))
        dsf = c[kLt * S + k] * tmax((c[kQt * S + k] - qsc) - xsh, T(0));
      else
        dsf = dfb + c[kLt * S + k] * tmax(qsb - qsc, T(0));
    }
    c[kM * S + k] = (c[kSe * S + k] + dsx) + dsf;
    xb = xsh;
    dxb = dsx;
    dfb = dsf;
    qsb = qsc;
  }
}

// the neutral-buoyancy crossings below the LCL, up to num_cin, and the
// CAPE, CIN and lel of the one with the most CAPE
template <typename T>
__device__ void cape_column(const ParcelArgs<T>& a, const T* c, int S,
                            const Col<T>& cs, int g) {
  const int pver = a.pver;
  const T* buoy = c + kM * S;
  const T* dlnp = c + kSe * S;
  const bool plge = cs.pl >= T(a.plclmin);
  int count = 0, last = -1, first[kMaxCin];
  for (int k = 0; k < pver; ++k) {
    const bool kmask = k >= a.msg + 1 && k < cs.lcl && plge;
    const T below = buoy[k < pver - 1 ? k + 1 : k];
    if (kmask && below > T(0) && buoy[k] <= T(0)) {
      ++count;
      if (count < a.num_cin) first[count - 1] = k;
      last = k;
    }
  }
  T cape = T(0), cin = T(0), best = T(-INFINITY);
  int lel = pver - 1;
  for (int n = 1; n <= a.num_cin; ++n) {
    if (count < n) break;
    const int ln = n < a.num_cin ? first[n - 1] : last;
    auto seg = [&](int k) { return k > ln && k <= cs.mx && plge; };
    const T cn = row_sum<T>(pver, [&](int k) {
      return seg(k) ? (buoy[k] * T(kRair)) * dlnp[k] : T(0);
    });
    const T ci = row_sum<T>(pver, [&](int k) {
      return seg(k) ? (tmin(buoy[k], T(0)) * T(-kRair)) * dlnp[k] : T(0);
    });
    if (cn > tmax(best, T(0))) {
      cape = cn;
      cin = ci;
      lel = ln;
      best = cn;
    }
  }
  const size_t nc = a.ncol;
  a.colv[g] = cs.tl;
  a.colv[nc + g] = tmax(cape, T(0));
  a.colv[2 * nc + g] = cin;
  a.colv[3 * nc + g] = cs.pl;
  a.idx[g] = cs.lcl;
  a.idx[nc + g] = lel;
  a.idx[2 * nc + g] = cs.mx;
}

// the item-th (column, level) of a phase of inversions: the levels above
// each column's launch level, packed
template <typename T>
__device__ __forceinline__ bool item_at(const Col<T>* cols, int nc, int i,
                                        int& col, int& k) {
  for (col = 0; col < nc; ++col) {
    if (i < cols[col].n) {
      k = i;
      return true;
    }
    i -= cols[col].n;
  }
  k = i;       // past the levels: the k-th column's LCL item
  return false;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
zm_parcel_kernel(ParcelArgs<T> a, int tc) {
  __shared__ T smem[kSmemElems];
  __shared__ Col<T> cols[kMaxTile];
  const int pver = a.pver, S = pver + 1, CS = col_stride(S);
  const int c0 = blockIdx.x * tc;
  const int nc = a.ncol - c0 < tc ? a.ncol - c0 : tc;
  const int npt = nc * pver;
  const size_t o0 = (size_t)c0 * pver;
  const size_t plane = (size_t)a.ncol * pver;
  const int tid = threadIdx.x, nth = blockDim.x;
  const bool exact = a.exact != 0;
  auto at = [&](int arr, int col) { return smem + col * CS + arr * S; };

  // phase 1: the tile's profiles, and the environment's entrainment
  // increments of each level (_parcel_dilute's inc, inc senv, inc qtenv)
  for (int i = tid; i < npt; i += nth) {
    const int col = i / pver, k = i - col * pver;
    const int g = c0 + col;
    const int kb = k < pver - 1 ? k + 1 : k;
    const size_t o = o0 + i, ob = o + (kb - k);
    const T* qc = a.q + (size_t)g * a.q_col;
    const T tk = a.t[o], tb = a.t[ob], pk = a.p[o], pb = a.p[ob];
    const T zk = a.z[o], zb = a.z[ob];
    const T qk = qc[(size_t)k * a.q_lev], qb = qc[(size_t)kb * a.q_lev];
    T* c = smem + col * CS;
    c[kT * S + k] = tk;
    c[kQ * S + k] = qk;
    c[kP * S + k] = pk;
    c[kZ * S + k] = zk;
    const T qtenv = (qk + qb) * T(0.5);
    const T tenv = (tk + tb) * T(0.5);
    const T penv = (pk + pb) * T(0.5);
    const T zenv = (zk + zb) * T(0.5);
    const T senv = enthalpy(tenv, penv, qtenv, zenv);
    const T dzdp = (-(tenv * T(kRair))) / (penv * T(kGrav));
    const T dmpdp = a.dmpdz[(size_t)g * a.dm_col + (size_t)k * a.dm_lev] * dzdp;
    const T inc = dmpdp * (pk - pb);
    c[kS * S + k] = inc * senv;
    c[kQt * S + k] = inc * qtenv;
    c[kM * S + k] = inc;
  }
  __syncthreads();

  // phase 2: each column's launch level and suffix sums
  if (tid < nc) launch_column(a, at(0, tid), cols[tid], c0 + tid);
  __syncthreads();

  // phase 3: the ascent, one enthalpy inversion a level above the launch
  int nlev = 0;
  for (int col = 0; col < nc; ++col) nlev += cols[col].n;
  for (int i = tid; i < nlev; i += nth) {
    int col, k;
    item_at(cols, nc, i, col, k);
    T* c = at(0, col);
    const Col<T>& cs = cols[col];
    const T denom = T(1) - c[kM * S + k];
    const T smix = (cs.sp0 - c[kS * S + k]) / denom;
    const T qtmix = (cs.qtp0 - c[kQt * S + k]) / denom;
    const T tk = c[kT * S + k], pk = c[kP * S + k];
    T qs;
    const T ti = ienthalpy(smix, pk, qtmix, c[kZ * S + k], tk, exact, &qs);
    const T tmix = ti != ti ? tk : ti;
    c[kS * S + k] = smix;
    c[kQt * S + k] = qtmix;
    c[kTm * S + k] = tmix;
    c[kQs * S + k] = qs;
    c[kSe * S + k] = entropy(tmix, pk, qtmix);
    sweep_terms(c, S, k, tmix, qs);
  }
  __syncthreads();

  // phases 4 and 5, once a sweep: the carry scans, then one entropy
  // inversion a level above the launch (and, in the first, the LCL's
  // enthalpy inversion)
  const int rounds = a.sweeps > 0 ? a.sweeps : 1;
  for (int r = 0; r < rounds; ++r) {
    const bool sweep = r < a.sweeps, last = r == a.sweeps - 1;
    if (tid < nc) {
      if (r == 0) lcl_column(at(0, tid), S, cols[tid]);
      if (sweep) carry_column(at(0, tid), S, cols[tid]);
    }
    __syncthreads();
    const int nitems = (sweep ? nlev : 0) + (r == 0 ? nc : 0);
    for (int i = tid; i < nitems; i += nth) {
      int col, k;
      const bool level = item_at(cols, nc, i + (sweep ? 0 : nlev), col, k);
      if (!level) {
        Col<T>& cs = cols[k];
        cs.tl = cs.tl_fb;
        if (cs.found) {
          const T tl = ienthalpy(cs.slcl, cs.pl, cs.qtlcl, cs.zl, cs.tguess,
                                 exact, (T*)nullptr);
          cs.tl = tl != tl ? cs.tl_fb : tl;
        }
        continue;
      }
      T* c = at(0, col);
      const T tmc = c[kTm * S + k];
      const T new_q = c[kQt * S + k] - c[kXs * S + k];
      T qs;
      const T ti = ientropy(c[kM * S + k], c[kP * S + k], new_q, tmc, exact,
                            &qs);
      const T t_new = ti != ti ? tmc : ti;
      c[kTm * S + k] = t_new;
      c[kQs * S + k] = qs;
      if (!last) sweep_terms(c, S, k, t_new, qs);
    }
    __syncthreads();
  }

  // phase 6: the parcel's profiles and buoyancy, stored; ln(pf) steps
  for (int i = tid; i < npt; i += nth) {
    const int col = i / pver, k = i - col * pver;
    const int g = c0 + col;
    const Col<T>& cs = cols[col];
    T* c = at(0, col);
    const T tk = c[kT * S + k], qk = c[kQ * S + k];
    T tp = tk, qstp = qk, denom_q = qk;
    if (k < cs.mx) {
      const T qsc = c[kQs * S + k], qt = c[kQt * S + k];
      const T new_q = qt - tmax((qt - qsc) - T(kLwmax), T(0));
      tp = c[kTm * S + k];
      qstp = new_q > qsc ? qsc : new_q;
      denom_q = new_q;
    } else if (k == cs.mx) {
      tp = cs.t_launch;
    }
    const T tpv = ((tp + a.tpert[g]) * (T(1) + qstp * inv<T>(kEpsilo))) /
                  (T(1) + denom_q);
    const T tv = (tk * (T(1) + qk * inv<T>(kEpsilo))) / (T(1) + qk);
    const bool in_plume = k <= cs.mx && cs.pl >= T(a.plclmin);
    const T buoy = in_plume ? (tpv - tv) + T(a.tiedke_add) : T(0);
    const size_t o = o0 + i;
    a.prof[o] = in_plume ? tp : tk;
    a.prof[plane + o] = in_plume ? qstp : qk;
    a.prof[2 * plane + o] = buoy;
    c[kM * S + k] = buoy;
    const T* pf = a.pf + (size_t)g * S;
    c[kSe * S + k] = log(pf[k + 1] / pf[k]);
  }
  __syncthreads();

  // phase 7: CAPE, CIN and the column values
  if (tid < nc) cape_column(a, at(0, tid), S, cols[tid], c0 + tid);
}

// the tile's columns: as many as fit in kSmemElems, at most kMaxTile
template <typename T>
int tile_columns(int S) {
  const int tc = kSmemElems / col_stride(S);
  return tc < kMaxTile ? tc : kMaxTile;
}

template <typename T>
int launch_zm_parcel(const ParcelArgs<T>& a, void* stream) {
  if (a.pver > kMaxK || a.pver < 2 || a.num_cin < 1 || a.num_cin > kMaxCin ||
      a.sweeps < 0)
    return (int)cudaErrorInvalidValue;
  if (a.ncol == 0) return 0;
  const int tc = tile_columns<T>(a.pver + 1);
  const int blocks = (a.ncol + tc - 1) / tc;
  zm_parcel_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a, tc);
  return (int)cudaGetLastError();
}

}  // namespace

#define CAM_ZM_PARCEL_ENTRY(SUF, T)                                           \
  extern "C" int cam_zm_parcel_##SUF(                                         \
      const T* q, const T* t, const T* p, const T* z, const T* pf,            \
      const T* zi, const T* zs, const T* pblt, const T* tpert,                \
      const T* dmpdz, int q_col, int q_lev, int dm_col, int dm_lev,           \
      int ncol, int pver, int msg, int num_cin, int pbl, int exact,           \
      int sweeps, double plclmin, double tiedke_add, double hscale, T* prof,  \
      T* colv, long long* idx, void* stream) {                                \
    const ParcelArgs<T> a{q,     t,      p,       z,       pf,     zi,       \
                          zs,    pblt,   tpert,   dmpdz,   q_col,  q_lev,    \
                          dm_col, dm_lev, ncol,   pver,    msg,    num_cin,  \
                          pbl,   exact,  sweeps,  plclmin, tiedke_add,       \
                          hscale, prof,  colv,    idx};                      \
    return launch_zm_parcel<T>(a, stream);                                    \
  }

CAM_ZM_PARCEL_ENTRY(f32, float)
CAM_ZM_PARCEL_ENTRY(f64, double)
