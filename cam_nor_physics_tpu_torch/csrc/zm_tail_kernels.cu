// Hopper kernel for the tail of ZM deep convection: zm_conv_evap, momtran
// (u and v) and convtran pass 1, fused into one launch.
//
// Replaces the Pallas TPU kernel _tail_kernel (zm_tail_pallas,
// cam_nor_physics_tpu/models/physics/zm_tail_pallas.py): the Sundqvist
// evaporation descent with snow production and melt, the convective
// momentum transport with its pressure-gradient terms and KE-dissipation
// heating, and the flux-limited convective transport of each tracer.
// Its plain PyTorch version is ops/zm_tail_kernels.py::zm_tail_ref (the
// port's zm_conv_evap, momtran and convtran_single).
//
// Design. One launch; each block takes a tile of neighbouring columns and
// one of two kinds of work. In the natural (ncol, pver) layout a tile's
// levels of one field are one contiguous run, which the block reads and
// writes with coalesced accesses and keeps in shared memory (36 KB, static,
// each column's arrays side by side at an odd column stride; 6 blocks on
// an SM). The kernel masks the ragged last tile of each kind. Phases are
// separated by __syncthreads():
// - evaporation tiles (the first blocks; 32 columns in float32, 21 in
//   float64 at 26 levels, 17 at 32): (1) threads over (column, level) load
//   the tile and compute the level-parallel parts of zm_conv_evap, the
//   Goff-Gratch
//   saturation (the powers and logarithms), the snow fraction and the rate
//   factor kem (1 - cld) evplimit; (2) the descents, one thread a column,
//   one warp for the tile; (3) the outputs, threads over (column, level),
//   from the fluxes the descent stored entering each level.
// - transport tiles (13 columns in float32 at 26 levels, 10 at 32; 6 and 5
//   in float64): (1) load the tile; (2) threads over (column, level): each
//   wind's chat and pressure-gradient terms (momtran), each tracer's
//   log-mean chat (convtran); (3) the recursions, one thread per (column,
//   chain): the updraft (first half of the block) and the downdraft
//   (second half) of u, of v and of each tracer; (4) the outputs, threads
//   over (column, level): dcondt, pgu/pgd, icwu/icwd, the KE heating (from
//   both winds' fluxes at k and k+1), convtran's tendencies. Tracers pass
//   through a tile kTrGroup at a time (phases 1-4 again for each further
//   group; the main path's 2 take one pass).
// So a column's 5 + 2 ntr recursions each have a thread. The evaporation
// descent, the longest chain (a square root and up to five divisions a
// level), fills whole warps of its own instead of idling a tile's others.
// The wrapper refuses more than kMaxK levels.
//
// Bound. The tail reads 14 (ncol, pver) fields, the tracers and 4 values
// per column once, and writes 17 (ncol, pver) fields, 2 on pver+1
// interfaces and the tracer tendencies once: about 53.5 MB in float32 at
// f19 (13,824 columns x 26 levels, 2 tracers), 16 us at 3.35 TB/s. Its
// arithmetic, a few hundred operations per column and level including
// the Goff-Gratch powers and logarithms, is about 1e8 operations, under
// 2 us at 67 TFLOP/s: the bytes bound it. What holds the kernel above that
// is the latency of the recursions, one dependent chain of divisions a
// level in each thread, and the phases' barriers: six tiles on an SM
// overlap their phases (tools/zm_tail_phases.py times the parts).
//
// Numerics. The formulas and the operand order are the plain version's,
// one rounding per PyTorch operation: x / c for a Python constant c is
// x * (1/c) (PyTorch multiplies by the reciprocal of a CPU scalar), c / x
// is (1/x) * c (Tensor.__rtruediv__), and the library compiles with
// --fmad=false. _safe_div's 1e-300 underflows to 0 in float32 as in the
// JAX package, making it a plain division there.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 64;       // zm_tail_kernels.MAX_LEVELS

constexpr double kGrav = 9.80616;
constexpr double kTmelt = 273.15;
constexpr double kLatvap = 2.501e6;
constexpr double kLatice = 3.337e5;
constexpr double kEpsilo = 18.016 / 28.966;
constexpr double kOmeps = 1.0 - kEpsilo;
constexpr double kTrice = 20.0;
constexpr double kSnowDen = kTmelt - (kTmelt - 5.0);   // cldfrc_fice's fsnow ramp
constexpr double kMbsth = 1.0e-15;
constexpr double kSmall = 1.0e-36;
constexpr double kLog10Water = 3.0057148979490314;   // math.log10(1013.246)
constexpr double kLog10Ice = 0.7858350313586662;     // math.log10(6.1071)

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return (a > b || a != a) ? a : b; }

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return (a < b || a != a) ? a : b; }

template <typename T>
__device__ __forceinline__ T clamp01(T x) { return tmin(tmax(x, T(0)), T(1)); }

template <typename T>
__device__ __forceinline__ T safe_div(T a, T b) {
  const T eps = T(1.0e-300);
  if (eps == T(0)) return a / b;
  return a / (fabs(b) < eps ? (b >= T(0) ? eps : -eps) : b);
}

template <typename T>
__device__ __forceinline__ T inv(double c) { return T(1) / T(c); }

// Goff-Gratch over water and ice, blended (ops/saturation.py::qsat)
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

template <typename T>
__device__ T svp_ice(T t) {
  const T a = (T(1) / t) * T(273.16);                // h2otrip / t
  T e = T(-9.09718) * (a - T(1));
  e = e - T(3.56654) * log10(a);
  e = e + T(0.876793) * (T(1) - t * inv<T>(273.16));
  e = e + T(kLog10Ice);
  return pow(T(10), e) * T(100);
}

template <typename T>
__device__ T qsat_blend(T t, T p) {
  const T w = clamp01((T(kTmelt) - t) * inv<T>(kTrice));
  const T es = tmin((T(1) - w) * svp_water(t) + w * svp_ice(t), p);
  const T qs = (T(kEpsilo) * es) / (p - T(kOmeps) * es);
  return p - es <= T(0) ? T(1) : qs;
}

// conu, bottom-up (zm_transport.py::_updraft_profile): src(k) = c(k) (the
// wind, or the tracer with fracis = 1); ex the pressure-gradient term,
// zero (null) for tracers
template <typename T>
__device__ void updraft(const T* c, const T* chat, const T* ex, const T* mu,
                        const T* du, const T* eu, const T* dp, int pver,
                        T* conu) {
  T conu_b = T(0), mu_b = T(0);
  for (int k = pver - 1; k >= 0; --k) {
    const T mupdudp = mu[k] + du[k] * dp[k];
    const T exk = ex ? ex[k] : T(0);
    const T val = safe_div(mu_b * conu_b + eu[k] * c[k] * dp[k] + exk * dp[k],
                           mupdudp);
    conu_b = mupdudp > T(kMbsth) ? val : chat[k];
    mu_b = mu[k];
    conu[k] = conu_b;
  }
}

// cond, top-down (zm_transport.py::_downdraft_profile): src = ed*c
template <typename T>
__device__ void downdraft(const T* c, const T* chat, const T* ex,
                          const T* md, const T* ed, const T* dp, int pver,
                          T* cond) {
  T cond_p = T(0), md_p = T(0), src_p = T(0), dp_p = T(0), ex_p = T(0);
  for (int k = 0; k < pver; ++k) {
    const T val = safe_div(md_p * cond_p - (src_p * dp_p + ex_p * dp_p), md[k]);
    cond_p = md[k] < T(-kMbsth) ? val : chat[k];
    md_p = md[k];
    src_p = ed[k] * c[k];
    dp_p = dp[k];
    ex_p = ex ? ex[k] : T(0);
    cond[k] = cond_p;
  }
}

// ---- the blocks' tiles in shared memory ----
//
// A block takes a tile of neighbouring columns. Each column of the tile
// holds its kind's arrays below, S = pver + 1 values each, one after
// another: array a of column col at base + col CS + a S, with the column
// stride CS = (arrays S) | 1 odd, so that threads on neighbouring columns
// of one level fall in different banks.
constexpr int kTrGroup = 2;      // tracers a pass of a transport tile takes
// an evaporation tile: t, pdel, rprd, the rate factor kem (1 - cld)
// evplimit, the snow fraction; the descent's fluxes entering each level
// (k = 0 .. pver) and its evaporation rate
enum : int { kT, kPdel, kRprd, kEva, kFsnow, kFlxp, kFlxs, kEvp, kEvapArrays };
// a transport tile: the mass fluxes and dp; u then v: the wind, chat, pgu,
// pgd, conu, cond (kWind + 6 w + j); each tracer of the pass: its mixing
// ratio, chat, conu, cond
enum : int {
  kMu, kMd, kDu, kEu, kEd, kDp, kWind,
  kTracer = kWind + 12,
  kTransportArrays = kTracer + 4 * kTrGroup
};
// 6 blocks of 36 KB on an SM (216 of its 228 KB), at most 80 registers a
// thread (kBlocksPerSM in __launch_bounds__)
constexpr int kSmemBytes = 36 * 1024;
constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 6;
// columns of a tile: an evaporation tile's descents fill one warp; a
// transport tile's 2 (2 + kTrGroup) tc chains fill kThreads
constexpr int kMaxEvapTile = 32;
constexpr int kMaxTransportTile = kThreads / (2 * (2 + kTrGroup));

__host__ __device__ inline int col_stride(int arrays, int S) {
  return (arrays * S) | 1;
}

// One level of the evaporation given the fluxes that enter it and its
// evaporation rate (zm_conv_evap's statements after evpprec); the descent
// and the output phase both call it
template <typename T>
struct EvapLevel {
  T work2, evpsnow, snowmlt, ntprprd, ntsnprd;
};

template <typename T>
__device__ __forceinline__ EvapLevel<T> evap_level(T t_k, T pdel_k, T rprd_k,
                                                   T fsnow_k, T flxprec,
                                                   T flxsnow, T evpprec) {
  EvapLevel<T> e;
  const bool melt = t_k > T(kTmelt);
  const T flxsntm = melt ? T(0) : flxsnow;
  e.snowmlt = melt ? (flxsnow * T(kGrav)) / pdel_k : T(0);
  const T flx_nz = flxprec == T(0) ? T(1e-30) : flxprec;
  const T work1 = flxprec > T(0) ? clamp01(flxsntm / flx_nz) : T(0);
  e.evpsnow = evpprec * work1;
  e.ntprprd = rprd_k - evpprec;
  const T work1b = flxprec > T(0) ? clamp01(flxsnow / flx_nz) : T(0);
  T work2 = tmax(fsnow_k, work1b);
  e.work2 = e.snowmlt > T(0) ? T(0) : work2;
  e.ntsnprd = rprd_k * e.work2 - e.evpsnow - e.snowmlt;
  return e;
}

// the evaporation descent of one column (zm_conv.py::zm_conv_evap): stores
// the fluxes entering each level and the bottom ones, and each level's rate
template <typename T>
__device__ void evap_descent(const T* tt, const T* pdel, const T* rprd,
                             const T* eva, const T* fsnow, T prec, int pver,
                             T* flxp, T* flxs, T* evp) {
  const T ig = inv<T>(kGrav);
  T flxprec = T(0), flxsnow = T(0), evpvint = T(0);
  flxp[0] = T(0);
  flxs[0] = T(0);
  for (int k = 0; k < pver; ++k) {
    const T pdel_k = pdel[k];
    T evpprec = eva[k] * sqrt(flxprec);
    T evplimit2 = (flxprec * T(kGrav)) / pdel_k;
    evplimit2 = tmin(evplimit2, ((prec - evpvint) * T(kGrav)) / pdel_k);
    evpprec = tmin(evplimit2, evpprec);
    evp[k] = evpprec;
    const EvapLevel<T> e = evap_level(tt[k], pdel_k, rprd[k], fsnow[k],
                                      flxprec, flxsnow, evpprec);
    evpvint = evpvint + (evpprec * pdel_k) * ig;
    flxprec = tmax(flxprec + (e.ntprprd * pdel_k) * ig, T(0));
    flxsnow = tmax(flxsnow + (e.ntsnprd * pdel_k) * ig, T(0));
    flxp[k + 1] = flxprec;
    flxs[k + 1] = flxsnow;
  }
}

// the masked momentum flux of one wind at level k (momtran's mfx)
template <typename T>
__device__ __forceinline__ T wind_mfx(const T* w, const T* mu, const T* md,
                                      int S, int k, int jt) {
  const T du_ = w[4 * S + k] - w[S + k], dd_ = w[5 * S + k] - w[S + k];
  return k >= jt ? -mu[k] * du_ - md[k] * dd_ : T(0);
}

// zm_tail's arguments, as one value the tiles take
template <typename T>
struct TailArgs {
  const T *t, *qv, *pmid, *pdel, *u, *v, *cld, *rprd, *mu, *md, *du, *eu,
      *ed, *dp, *qtr, *landfrac, *prec_in;
  const long long *jt, *mx;
  int ncol, pver, ntr, org;
  double ke, ke_lnd, momcu, momcd, dt;
  T *mid, *flx, *dq;
};

// Output rows of `mid` (each ncol x pver): 0 tend_s, 1 tend_q, 2 snwprd,
// 3 snwevmlt, 4 ntprprd, 5 ntsnprd, 6 dudt, 7 dvdt, 8 seten, 9 pgu(u),
// 10 pgu(v), 11 pgd(u), 12 pgd(v), 13 icwu(u), 14 icwu(v), 15 icwd(u),
// 16 icwd(v); `flx` holds flxprec and flxsnow (each ncol x (pver+1)).

// zm_conv_evap on the tc columns from c0: mid rows 0-5 and flx
template <typename T>
__device__ void evap_tile(const TailArgs<T>& p, T* smem, int c0, int tc,
                          int S) {
  const int pver = p.pver;
  const int nc = p.ncol - c0 < tc ? p.ncol - c0 : tc;
  const int npt = nc * pver;
  const size_t o0 = (size_t)c0 * pver;
  const size_t plane = (size_t)p.ncol * pver;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int CS = col_stride(kEvapArrays, S);
  auto at = [&](int a, int col) { return smem + col * CS + a * S; };

  // phase 1: the inputs, and the level-parallel parts of the evaporation:
  // the Goff-Gratch saturation, the snow fraction, the rate factor
  for (int i = tid; i < npt; i += nth) {
    const int col = i / pver, k = i - col * pver;
    const size_t g = o0 + i;
    const T t_k = p.t[g], q_k = p.qv[g];
    at(kT, col)[k] = t_k;
    at(kPdel, col)[k] = p.pdel[g];
    at(kRprd, col)[k] = p.rprd[g];
    const T lf = p.landfrac[c0 + col];
    const T kem = p.org ? T(p.ke) * (T(1) - lf) + T(p.ke_lnd) * lf : T(p.ke);
    const T qs_k = qsat_blend(t_k, p.pmid[g]);
    at(kFsnow, col)[k] = clamp01((T(kTmelt) - t_k) * inv<T>(kSnowDen));
    const T evplimit = tmax(T(1) - (q_k / (T(1) + q_k)) / qs_k, T(0));
    at(kEva, col)[k] = kem * (T(1) - p.cld[g]) * evplimit;
  }
  __syncthreads();
  // phase 2: the descents, one thread a column
  if (tid < nc)
    evap_descent(at(kT, tid), at(kPdel, tid), at(kRprd, tid), at(kEva, tid),
                 at(kFsnow, tid), p.prec_in[c0 + tid] * T(1000), pver,
                 at(kFlxp, tid), at(kFlxs, tid), at(kEvp, tid));
  __syncthreads();
  // phase 3: the outputs from the fluxes entering each level
  for (int i = tid; i < npt; i += nth) {
    const int col = i / pver, k = i - col * pver;
    const size_t g = o0 + i;
    const T evpprec = at(kEvp, col)[k];
    const T rprd_k = at(kRprd, col)[k];
    const EvapLevel<T> e = evap_level(
        at(kT, col)[k], at(kPdel, col)[k], rprd_k, at(kFsnow, col)[k],
        at(kFlxp, col)[k], at(kFlxs, col)[k], evpprec);
    p.mid[0 * plane + g] = -evpprec * T(kLatvap) + e.ntsnprd * T(kLatice);
    p.mid[1 * plane + g] = evpprec;
    p.mid[2 * plane + g] = rprd_k * e.work2 * T(kLatice);
    p.mid[3 * plane + g] = -(e.evpsnow + e.snowmlt) * T(kLatice);
    p.mid[4 * plane + g] = e.ntprprd;
    p.mid[5 * plane + g] = e.ntsnprd;
  }
  const int nf = nc * (pver + 1);
  const size_t fo = (size_t)c0 * (pver + 1);
  const size_t fplane = (size_t)p.ncol * (pver + 1);
  for (int i = tid; i < nf; i += nth) {
    const int col = i / (pver + 1), k = i - col * (pver + 1);
    p.flx[fo + i] = at(kFlxp, col)[k];
    p.flx[fplane + fo + i] = at(kFlxs, col)[k];
  }
}

// momtran of u and v with the KE heating (mid rows 6-16) and convtran of
// the tracers (dq) on the tc columns from c0, the tracers kTrGroup a pass
template <typename T>
__device__ void transport_tile(const TailArgs<T>& p, T* smem, int c0, int tc,
                               int S) {
  const int pver = p.pver, ntr = p.ntr;
  const int nc = p.ncol - c0 < tc ? p.ncol - c0 : tc;
  const int npt = nc * pver;
  const size_t o0 = (size_t)c0 * pver;
  const size_t plane = (size_t)p.ncol * pver;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int CS = col_stride(kTransportArrays, S);
  auto at = [&](int a, int col) { return smem + col * CS + a * S; };
  const T cu_half = T(-p.momcu * 0.5), cd_half = T(-p.momcd * 0.5);
  const T cu_full = T(-p.momcu), cd_full = T(-p.momcd);

  for (int g0 = 0;; g0 += kTrGroup) {
    const bool first = g0 == 0;          // the pass that also takes the winds
    const int ng = ntr - g0 < kTrGroup ? ntr - g0 : kTrGroup;
    const int nw = first ? 2 : 0;

    // phase 1: the tile's inputs
    if (first) {
      for (int i = tid; i < npt; i += nth) {
        const int col = i / pver, k = i - col * pver;
        const size_t g = o0 + i;
        at(kMu, col)[k] = p.mu[g];
        at(kMd, col)[k] = p.md[g];
        at(kDu, col)[k] = p.du[g];
        at(kEu, col)[k] = p.eu[g];
        at(kEd, col)[k] = p.ed[g];
        at(kDp, col)[k] = p.dp[g];
        at(kWind, col)[k] = p.u[g];
        at(kWind + 6, col)[k] = p.v[g];
      }
    }
    for (int j = tid; j < npt * ntr; j += nth) {
      const int q = j / ntr, m = j - q * ntr - g0;
      if (m >= 0 && m < ng) {
        const int col = q / pver;
        at(kTracer + 4 * m, col)[q - col * pver] = p.qtr[o0 * ntr + j];
      }
    }
    __syncthreads();

    // phase 2: chat and the pressure-gradient terms of the winds
    // (momtran), the log-mean chat of the tracers (convtran)
    for (int i = tid; i < npt * (nw + ng); i += nth) {
      const int kind = i / npt, r = i - kind * npt;
      const int col = r / pver, k = r - col * pver;
      const int ka = k > 0 ? k - 1 : 0, kb = k < pver - 1 ? k + 1 : k;
      if (kind < nw) {
        T* w = at(kWind + 6 * kind, col);
        const T* mu_ = at(kMu, col);
        const T* md_ = at(kMd, col);
        const T* dp_ = at(kDp, col);
        w[S + k] = T(0.5) * (w[k] + w[ka]);
        const T mu_b = k < pver - 1 ? mu_[k + 1] : T(0);
        const T md_b = k < pver - 1 ? md_[k + 1] : T(0);
        const T ga = safe_div(w[k] - w[ka], dp_[ka]);
        const T gb = safe_div(w[kb] - w[k], dp_[k]);
        T pu = cu_half * (mu_[k] * ga + mu_b * gb);
        T pd = cd_half * (md_[k] * ga + md_b * gb);
        if (k == pver - 1) {      // single-sided at the bottom
          pu = cu_full * (mu_[k] * ga);
          pd = cd_full * (md_[k] * ga);
        }
        if (k == 0) {
          pu = T(0);
          pd = T(0);
        }
        w[2 * S + k] = pu;
        w[3 * S + k] = pd;
      } else {
        T* c = at(kTracer + 4 * (kind - nw), col);
        const T cp = c[ka], ck = c[k];
        const T minc = tmin(cp, ck), maxc = tmax(cp, ck);
        const T cdifr = minc < T(0)
                            ? T(0)
                            : safe_div(fabs(ck - cp), tmax(maxc, T(kSmall)));
        const T cabv = tmax(cp, maxc * T(1.0e-12));
        const T cbel = tmax(ck, maxc * T(1.0e-12));
        const bool use_log = cdifr > T(1.0e-6);
        const T safe = (use_log && cabv != cbel) ? cabv - cbel : T(1);
        const T lm = log(use_log ? safe_div(cabv, cbel) : T(1)) / safe *
                     cabv * cbel;
        c[S + k] = use_log ? lm : T(0.5) * (ck + cp);
      }
    }
    __syncthreads();

    // phase 3: the updraft (first half of the block) and the downdraft
    // (second half) of each wind and tracer, one thread per (column,
    // chain)
    {
      const bool up = tid < kThreads / 2;
      const int j = up ? tid : tid - kThreads / 2;
      const int kind = j / tc, col = j - kind * tc;
      if (kind < nw + ng && col < nc) {
        const T* c;
        const T* ex = nullptr;           // the winds' pressure-gradient term
        T* prof;
        if (kind < nw) {
          T* w = at(kWind + 6 * kind, col);
          c = w;
          ex = w + (up ? 2 : 3) * S;
          prof = w + (up ? 4 : 5) * S;
        } else {
          T* tr = at(kTracer + 4 * (kind - nw), col);
          c = tr;
          prof = tr + (up ? 2 : 3) * S;
        }
        if (up)
          updraft(c, c + S, ex, at(kMu, col), at(kDu, col), at(kEu, col),
                  at(kDp, col), pver, prof);
        else
          downdraft(c, c + S, ex, at(kMd, col), at(kEd, col), at(kDp, col),
                    pver, prof);
      }
    }
    __syncthreads();

    // phase 4: the outputs
    if (first) {
      const T idt = T(1) / T(p.dt);
      for (int i = tid; i < npt; i += nth) {
        const int col = i / pver, k = i - col * pver;
        const int ka = k > 0 ? k - 1 : 0, kb = k < pver - 1 ? k + 1 : k;
        const int jt = (int)p.jt[c0 + col], mx = (int)p.mx[c0 + col];
        const size_t g = o0 + i;
        const T* mu_ = at(kMu, col);
        const T* md_ = at(kMd, col);
        const T* dp_ = at(kDp, col);
        const T mu_b = k < pver - 1 ? mu_[k + 1] : T(0);
        const T md_b = k < pver - 1 ? md_[k + 1] : T(0);
        for (int w = 0; w < 2; ++w) {
          const T* c = at(kWind + 6 * w, col);
          const T* chat = c + S;
          const T* conu = c + 4 * S;
          const T* cond = c + 5 * S;
          const T du_ = conu[k] - chat[k], dd_ = cond[k] - chat[k];
          T dc = (mu_b * (conu[kb] - chat[kb]) - mu_[k] * du_ +
                  md_b * (cond[kb] - chat[kb]) - md_[k] * dd_) / dp_[k];
          dc = k >= jt ? dc : T(0);
          const T dc_mx = (T(1) / dp_[k]) * (-mu_[k] * du_ - md_[k] * dd_);
          dc = k == mx ? dc_mx : (k > mx ? T(0) : dc);
          p.mid[(6 + w) * plane + g] = dc;
          p.mid[(9 + w) * plane + g] = -c[2 * S + k];
          p.mid[(11 + w) * plane + g] = -c[3 * S + k];
          p.mid[(13 + w) * plane + g] = conu[k];
          p.mid[(15 + w) * plane + g] = cond[k];
        }
        // KE dissipation -> heating (zm_transport.py::momtran)
        const T* uc = at(kWind, col);
        const T* vc = at(kWind + 6, col);
        const T mfxu = wind_mfx(uc, mu_, md_, S, k, jt);
        const T mfxv = wind_mfx(vc, mu_, md_, S, k, jt);
        const T mu_bf = k < pver - 1 ? wind_mfx(uc, mu_, md_, S, k + 1, jt)
                                     : T(0);
        const T mv_bf = k < pver - 1 ? wind_mfx(vc, mu_, md_, S, k + 1, jt)
                                     : T(0);
        const T fket = T(0.5) * (uc[k] + uc[ka]) * mfxu +
                       T(0.5) * (vc[k] + vc[ka]) * mfxv;
        const T fkeb = T(0.5) * (uc[k] + uc[kb]) * mu_bf +
                       T(0.5) * (vc[k] + vc[kb]) * mv_bf;
        const T kcons = (fket - fkeb) / dp_[k];
        const T uf = uc[k] - (mu_bf - mfxu) * T(p.dt) / dp_[k];
        const T vf = vc[k] - (mv_bf - mfxv) * T(p.dt) / dp_[k];
        const T ket = ((uf * uf + vf * vf) - (uc[k] * uc[k] + vc[k] * vc[k])) *
                      T(0.5) * idt;
        p.mid[8 * plane + g] = k >= jt ? kcons - ket : T(0);
      }
    }
    // convtran of each tracer of the pass (fracis = 1, wet dp)
    for (int j = tid; j < npt * ntr; j += nth) {
      const int q = j / ntr, m = j - q * ntr - g0;
      if (m < 0 || m >= ng) continue;
      const int col = q / pver, k = q - col * pver;
      const int ka = k > 0 ? k - 1 : 0, kb = k < pver - 1 ? k + 1 : k;
      const int jt = (int)p.jt[c0 + col], mx = (int)p.mx[c0 + col];
      const T* mu_ = at(kMu, col);
      const T* md_ = at(kMd, col);
      const T* dp_ = at(kDp, col);
      const T* c = at(kTracer + 4 * m, col);
      const T* conu = c + 2 * S;
      const T* cond = c + 3 * S;
      const T mu_b = k < pver - 1 ? mu_[k + 1] : T(0);
      const T md_b = k < pver - 1 ? md_[k + 1] : T(0);
      const T chat = c[S + k], chat_b = c[S + kb];
      const T fin = mu_b * conu[kb] + mu_[k] * tmin(chat, c[ka]) -
                    (md_[k] * cond[k] + md_b * tmin(chat_b, c[kb]));
      const T fout = mu_[k] * conu[k] + mu_b * tmin(chat_b, c[k]) -
                     (md_b * cond[kb] + md_[k] * tmin(chat, c[k]));
      T net = fin - fout;
      net = fabs(net) < tmax(fin, fout) * T(1.0e-12) ? T(0) : net;
      const T dc = k >= jt ? net / dp_[k] : T(0);
      const T fin_s = mu_[k] * tmin(chat, c[ka]) - md_[k] * cond[k];
      const T fout_s = mu_[k] * conu[k] - md_[k] * tmin(chat, c[k]);
      T net_s = fin_s - fout_s;
      net_s = fabs(net_s) < tmax(fin_s, fout_s) * T(1.0e-12) ? T(0) : net_s;
      p.dq[o0 * ntr + j] = k == mx ? net_s / dp_[k] : (k > mx ? T(0) : dc);
    }
    if (g0 + kTrGroup >= ntr) break;
    __syncthreads();                     // the next pass reuses the arrays
  }
}

// the tiles' columns: as many as fit in kSmemBytes, at most `most`
template <typename T>
int tile_columns(int arrays, int S, int most) {
  const int tc = (int)(kSmemBytes / sizeof(T)) / col_stride(arrays, S);
  return tc < most ? tc : most;
}

// One launch: blocks [0, n_evap) take evaporation tiles of tc_e columns,
// the rest transport tiles of tc_t columns.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
zm_tail_kernel(TailArgs<T> p, int tc_e, int tc_t, int n_evap, int S) {
  __shared__ T smem[kSmemBytes / sizeof(T)];
  const int b = blockIdx.x;
  if (b < n_evap)
    evap_tile(p, smem, b * tc_e, tc_e, S);
  else
    transport_tile(p, smem, (b - n_evap) * tc_t, tc_t, S);
}

template <typename T>
int launch_zm_tail(const TailArgs<T>& p, void* stream) {
  if (p.pver > kMaxK || p.pver < 1 || p.ntr < 0)
    return (int)cudaErrorInvalidValue;
  const int S = p.pver + 1;
  const int tc_e = tile_columns<T>(kEvapArrays, S, kMaxEvapTile);
  const int tc_t = tile_columns<T>(kTransportArrays, S, kMaxTransportTile);
  const int n_evap = (p.ncol + tc_e - 1) / tc_e;
  const int blocks = n_evap + (p.ncol + tc_t - 1) / tc_t;
  zm_tail_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, tc_e, tc_t, n_evap, S);
  return (int)cudaGetLastError();
}

}  // namespace

#define CAM_ZM_TAIL_ENTRY(SUF, T)                                             \
  extern "C" int cam_zm_tail_##SUF(                                           \
      const T* t, const T* qv, const T* pmid, const T* pdel, const T* u,      \
      const T* v, const T* cld, const T* rprd, const T* mu, const T* md,      \
      const T* du, const T* eu, const T* ed, const T* dp, const T* qtr,       \
      const T* landfrac, const T* prec_in, const long long* jt,               \
      const long long* mx, int ncol, int pver, int ntr, int org, double ke,   \
      double ke_lnd, double momcu, double momcd, double dt, T* mid, T* flx,   \
      T* dq, void* stream) {                                                  \
    const TailArgs<T> p{t,  qv,   pmid, pdel, u,      v,     cld,   rprd,     \
                        mu, md,   du,   eu,   ed,     dp,    qtr,   landfrac, \
                        prec_in, jt, mx, ncol, pver,  ntr,   org,   ke,       \
                        ke_lnd, momcu, momcd, dt, mid, flx, dq};              \
    return launch_zm_tail<T>(p, stream);                                      \
  }

CAM_ZM_TAIL_ENTRY(f32, float)
CAM_ZM_TAIL_ENTRY(f64, double)
