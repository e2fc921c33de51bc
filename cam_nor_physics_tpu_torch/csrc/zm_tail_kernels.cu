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
// Design. One thread per column, looping over levels: every recursion of
// the tail (the evaporation flux descent from k=0, the updraft profile
// bottom-up, the downdraft profile top-down) runs along one column, and
// columns are independent. The TPU kernel's (pver, 512-column) blocks and
// column padding go: a block is 128 columns and the kernel masks the
// ragged last block itself. The arrays keep the port's natural (ncol,
// pver) layout and tracers (ncol, pver, ntr); the wrapper transposes
// nothing. A column's recursion state (interface values, updraft and
// downdraft profiles, momentum fluxes) lives in local arrays bounded by
// kMaxK levels; the wrapper refuses more.
//
// Bound. The tail reads 14 (ncol, pver) fields, the tracers and 4 values
// per column once, and writes 17 (ncol, pver) fields, 2 on pver+1
// interfaces and the tracer tendencies once: about 53.5 MB in float32 at
// f19 (13,824 columns x 26 levels, 2 tracers), 16 us at 3.35 TB/s. Its
// arithmetic, a few hundred operations per column and level including
// the Goff-Gratch powers and logarithms, is about 1e8 operations, under
// 2 us at 67 TFLOP/s: the bytes bound it. This first version reads each
// level of a column at a stride of pver elements (neighbouring threads
// 4*pver bytes apart) and relies on L1/L2 to merge the lines, and runs
// 108 blocks at f19, fewer than the card's 132 SMs; staging the column
// tiles through shared memory and more threads per column are for a
// later version.
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
constexpr int kThreads = 128;

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

// ---- zm_conv_evap, old_snow path (zm_conv.py::zm_conv_evap) ----
template <typename T>
__device__ void evap_column(const T* t, const T* qv, const T* pmid,
                            const T* pdel, const T* cld, const T* rprd,
                            T kem, T prec, int pver, size_t plane,
                            T* mid, T* flxp, T* flxs) {
  const T ig = inv<T>(kGrav);
  T flxprec = T(0), flxsnow = T(0), evpvint = T(0);
  flxp[0] = T(0);
  flxs[0] = T(0);
  for (int k = 0; k < pver; ++k) {
    const T t_k = t[k], q_k = qv[k], pdel_k = pdel[k], rprd_k = rprd[k];
    const T qs_k = qsat_blend(t_k, pmid[k]);
    const T fsnow_k = clamp01((T(kTmelt) - t_k) * inv<T>(kSnowDen));
    const bool melt = t_k > T(kTmelt);
    const T flxsntm = melt ? T(0) : flxsnow;
    const T snowmlt = melt ? (flxsnow * T(kGrav)) / pdel_k : T(0);
    const T evplimit = tmax(T(1) - (q_k / (T(1) + q_k)) / qs_k, T(0));
    T evpprec = kem * (T(1) - cld[k]) * evplimit * sqrt(flxprec);
    T evplimit2 = (flxprec * T(kGrav)) / pdel_k;
    evplimit2 = tmin(evplimit2, ((prec - evpvint) * T(kGrav)) / pdel_k);
    evpprec = tmin(evplimit2, evpprec);
    const T flx_nz = flxprec == T(0) ? T(1e-30) : flxprec;
    const T work1 = flxprec > T(0) ? clamp01(flxsntm / flx_nz) : T(0);
    const T evpsnow = evpprec * work1;
    evpvint = evpvint + (evpprec * pdel_k) * ig;
    const T ntprprd = rprd_k - evpprec;
    const T work1b = flxprec > T(0) ? clamp01(flxsnow / flx_nz) : T(0);
    T work2 = tmax(fsnow_k, work1b);
    work2 = snowmlt > T(0) ? T(0) : work2;
    const T ntsnprd = rprd_k * work2 - evpsnow - snowmlt;
    mid[0 * plane + k] = -evpprec * T(kLatvap) + ntsnprd * T(kLatice);  // tend_s
    mid[1 * plane + k] = evpprec;                                       // tend_q
    mid[2 * plane + k] = rprd_k * work2 * T(kLatice);                   // snwprd
    mid[3 * plane + k] = -(evpsnow + snowmlt) * T(kLatice);             // snwevmlt
    mid[4 * plane + k] = ntprprd;
    mid[5 * plane + k] = ntsnprd;
    flxprec = tmax(flxprec + (ntprprd * pdel_k) * ig, T(0));
    flxsnow = tmax(flxsnow + (ntsnprd * pdel_k) * ig, T(0));
    flxp[k + 1] = flxprec;
    flxs[k + 1] = flxsnow;
  }
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

// per-column recursion state, at most kMaxK levels (local memory)
template <typename T>
struct ColumnScratch {
  T chat[kMaxK], pgu[kMaxK], pgd[kMaxK], conu[kMaxK], cond[kMaxK];
  T c[kMaxK], mfxu[kMaxK], mfxv[kMaxK];
};

// one wind of momtran (zm_transport.py::momtran): writes dcondt, -pgu,
// -pgd, conu and cond of the column to its output rows, and the masked
// momentum flux to mfx
template <typename T>
__device__ void momtran_wind(const T* c, const T* mu, const T* md,
                             const T* du, const T* eu, const T* ed,
                             const T* dp, int pver, int jt, int mx,
                             double momcu, double momcd,
                             ColumnScratch<T>& w, T* mfx, T* o_dc,
                             T* o_pgu, T* o_pgd, T* o_icu, T* o_icd) {
  const T cu_half = T(-momcu * 0.5), cd_half = T(-momcd * 0.5);
  const T cu_full = T(-momcu), cd_full = T(-momcd);
  for (int k = 0; k < pver; ++k) {
    const int ka = k > 0 ? k - 1 : 0, kb = k < pver - 1 ? k + 1 : k;
    w.chat[k] = T(0.5) * (c[k] + c[ka]);
    const T mu_b = k < pver - 1 ? mu[k + 1] : T(0);
    const T md_b = k < pver - 1 ? md[k + 1] : T(0);
    const T ga = safe_div(c[k] - c[ka], dp[ka]);
    const T gb = safe_div(c[kb] - c[k], dp[k]);
    T pu = cu_half * (mu[k] * ga + mu_b * gb);
    T pd = cd_half * (md[k] * ga + md_b * gb);
    if (k == pver - 1) {          // single-sided at the bottom
      pu = cu_full * (mu[k] * ga);
      pd = cd_full * (md[k] * ga);
    }
    if (k == 0) {
      pu = T(0);
      pd = T(0);
    }
    w.pgu[k] = pu;
    w.pgd[k] = pd;
  }
  updraft(c, w.chat, w.pgu, mu, du, eu, dp, pver, w.conu);
  downdraft(c, w.chat, w.pgd, md, ed, dp, pver, w.cond);
  for (int k = 0; k < pver; ++k) {
    const int kb = k < pver - 1 ? k + 1 : k;
    const T mu_b = k < pver - 1 ? mu[k + 1] : T(0);
    const T md_b = k < pver - 1 ? md[k + 1] : T(0);
    const T du_ = w.conu[k] - w.chat[k], dd_ = w.cond[k] - w.chat[k];
    T dc = (mu_b * (w.conu[kb] - w.chat[kb]) - mu[k] * du_ +
            md_b * (w.cond[kb] - w.chat[kb]) - md[k] * dd_) / dp[k];
    dc = k >= jt ? dc : T(0);
    const T dc_mx = (T(1) / dp[k]) * (-mu[k] * du_ - md[k] * dd_);
    dc = k == mx ? dc_mx : (k > mx ? T(0) : dc);
    mfx[k] = k >= jt ? -mu[k] * du_ - md[k] * dd_ : T(0);
    o_dc[k] = dc;
    o_pgu[k] = -w.pgu[k];
    o_pgd[k] = -w.pgd[k];
    o_icu[k] = w.conu[k];
    o_icd[k] = w.cond[k];
  }
}

// convtran of one tracer, fracis = 1, wet dp (zm_transport.py::
// convtran_single): c holds the column's tracer, out its tendency rows at
// stride ntr
template <typename T>
__device__ void convtran_one(const T* mu, const T* md, const T* du,
                             const T* eu, const T* ed, const T* dp, int pver,
                             int jt, int mx, ColumnScratch<T>& w,
                             T* out, int ntr) {
  const T* c = w.c;
  for (int k = 0; k < pver; ++k) {           // log-mean interface values
    const T c0 = c[k > 0 ? k - 1 : 0], ck = c[k];
    const T minc = tmin(c0, ck), maxc = tmax(c0, ck);
    const T cdifr = minc < T(0) ? T(0)
                                : safe_div(fabs(ck - c0), tmax(maxc, T(kSmall)));
    const T cabv = tmax(c0, maxc * T(1.0e-12));
    const T cbel = tmax(ck, maxc * T(1.0e-12));
    const bool use_log = cdifr > T(1.0e-6);
    const T safe = (use_log && cabv != cbel) ? cabv - cbel : T(1);
    const T lm = log(use_log ? safe_div(cabv, cbel) : T(1)) / safe * cabv * cbel;
    w.chat[k] = use_log ? lm : T(0.5) * (ck + c0);
  }
  updraft(c, w.chat, (const T*)nullptr, mu, du, eu, dp, pver, w.conu);
  downdraft(c, w.chat, (const T*)nullptr, md, ed, dp, pver, w.cond);
  for (int k = 0; k < pver; ++k) {
    const int ka = k > 0 ? k - 1 : 0, kb = k < pver - 1 ? k + 1 : k;
    const T mu_b = k < pver - 1 ? mu[k + 1] : T(0);
    const T md_b = k < pver - 1 ? md[k + 1] : T(0);
    const T chat = w.chat[k], chat_b = w.chat[kb];
    const T fin = mu_b * w.conu[kb] + mu[k] * tmin(chat, c[ka]) -
                  (md[k] * w.cond[k] + md_b * tmin(chat_b, c[kb]));
    const T fout = mu[k] * w.conu[k] + mu_b * tmin(chat_b, c[k]) -
                   (md_b * w.cond[kb] + md[k] * tmin(chat, c[k]));
    T net = fin - fout;
    net = fabs(net) < tmax(fin, fout) * T(1.0e-12) ? T(0) : net;
    const T dc = k >= jt ? net / dp[k] : T(0);
    const T fin_s = mu[k] * tmin(chat, c[ka]) - md[k] * w.cond[k];
    const T fout_s = mu[k] * w.conu[k] - md[k] * tmin(chat, c[k]);
    T net_s = fin_s - fout_s;
    net_s = fabs(net_s) < tmax(fin_s, fout_s) * T(1.0e-12) ? T(0) : net_s;
    out[k * ntr] = k == mx ? net_s / dp[k] : (k > mx ? T(0) : dc);
  }
}

// Output rows of `mid` (each ncol x pver): 0 tend_s, 1 tend_q, 2 snwprd,
// 3 snwevmlt, 4 ntprprd, 5 ntsnprd, 6 dudt, 7 dvdt, 8 seten, 9 pgu(u),
// 10 pgu(v), 11 pgd(u), 12 pgd(v), 13 icwu(u), 14 icwu(v), 15 icwd(u),
// 16 icwd(v); `flx` holds flxprec and flxsnow (each ncol x (pver+1)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
zm_tail_kernel(const T* __restrict__ t, const T* __restrict__ qv,
               const T* __restrict__ pmid, const T* __restrict__ pdel,
               const T* __restrict__ u, const T* __restrict__ v,
               const T* __restrict__ cld, const T* __restrict__ rprd,
               const T* __restrict__ mu, const T* __restrict__ md,
               const T* __restrict__ du, const T* __restrict__ eu,
               const T* __restrict__ ed, const T* __restrict__ dp,
               const T* __restrict__ qtr, const T* __restrict__ landfrac,
               const T* __restrict__ prec_in, const long long* __restrict__ jt_,
               const long long* __restrict__ mx_, int ncol, int pver,
               int ntr, int org, double ke, double ke_lnd, double momcu,
               double momcd, double dt, T* __restrict__ mid,
               T* __restrict__ flx, T* __restrict__ dq) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const size_t o = (size_t)col * pver;
  const size_t plane = (size_t)ncol * pver;
  const size_t fo = (size_t)col * (pver + 1);
  const int jt = (int)jt_[col], mx = (int)mx_[col];
  const T lf = landfrac[col];
  const T kem = org ? T(ke) * (T(1) - lf) + T(ke_lnd) * lf : T(ke);
  T* m = mid + o;

  evap_column(t + o, qv + o, pmid + o, pdel + o, cld + o, rprd + o, kem,
              prec_in[col] * T(1000), pver, plane, m, flx + fo,
              flx + (size_t)ncol * (pver + 1) + fo);

  ColumnScratch<T> w;
  momtran_wind(u + o, mu + o, md + o, du + o, eu + o, ed + o, dp + o, pver,
               jt, mx, momcu, momcd, w, w.mfxu, m + 6 * plane, m + 9 * plane,
               m + 11 * plane, m + 13 * plane, m + 15 * plane);
  momtran_wind(v + o, mu + o, md + o, du + o, eu + o, ed + o, dp + o, pver,
               jt, mx, momcu, momcd, w, w.mfxv, m + 7 * plane, m + 10 * plane,
               m + 12 * plane, m + 14 * plane, m + 16 * plane);
  // KE dissipation -> heating (zm_transport.py::momtran)
  const T* uc = u + o;
  const T* vc = v + o;
  const T* dpc = dp + o;
  const T idt = T(1) / T(dt);
  for (int k = 0; k < pver; ++k) {
    const int ka = k > 0 ? k - 1 : 0, kb = k < pver - 1 ? k + 1 : k;
    const T mu_b = k < pver - 1 ? w.mfxu[k + 1] : T(0);
    const T mv_b = k < pver - 1 ? w.mfxv[k + 1] : T(0);
    const T fket = T(0.5) * (uc[k] + uc[ka]) * w.mfxu[k] +
                   T(0.5) * (vc[k] + vc[ka]) * w.mfxv[k];
    const T fkeb = T(0.5) * (uc[k] + uc[kb]) * mu_b +
                   T(0.5) * (vc[k] + vc[kb]) * mv_b;
    const T kcons = (fket - fkeb) / dpc[k];
    const T uf = uc[k] - (mu_b - w.mfxu[k]) * T(dt) / dpc[k];
    const T vf = vc[k] - (mv_b - w.mfxv[k]) * T(dt) / dpc[k];
    const T ket = ((uf * uf + vf * vf) - (uc[k] * uc[k] + vc[k] * vc[k])) *
                  T(0.5) * idt;
    m[8 * plane + k] = k >= jt ? kcons - ket : T(0);
  }

  for (int tr = 0; tr < ntr; ++tr) {
    for (int k = 0; k < pver; ++k) w.c[k] = qtr[(o + k) * ntr + tr];
    convtran_one(mu + o, md + o, du + o, eu + o, ed + o, dp + o, pver, jt, mx,
                 w, dq + o * ntr + tr, ntr);
  }
}

template <typename T>
int launch_zm_tail(const T* t, const T* qv, const T* pmid, const T* pdel,
                   const T* u, const T* v, const T* cld, const T* rprd,
                   const T* mu, const T* md, const T* du, const T* eu,
                   const T* ed, const T* dp, const T* qtr, const T* landfrac,
                   const T* prec_in, const long long* jt, const long long* mx,
                   int ncol, int pver, int ntr, int org, double ke,
                   double ke_lnd, double momcu, double momcd, double dt,
                   T* mid, T* flx, T* dq, void* stream) {
  if (pver > kMaxK || pver < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (ncol + kThreads - 1) / kThreads;
  zm_tail_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      t, qv, pmid, pdel, u, v, cld, rprd, mu, md, du, eu, ed, dp, qtr,
      landfrac, prec_in, jt, mx, ncol, pver, ntr, org, ke, ke_lnd, momcu,
      momcd, dt, mid, flx, dq);
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
    return launch_zm_tail<T>(t, qv, pmid, pdel, u, v, cld, rprd, mu, md, du,  \
                             eu, ed, dp, qtr, landfrac, prec_in, jt, mx,      \
                             ncol, pver, ntr, org, ke, ke_lnd, momcu, momcd,  \
                             dt, mid, flx, dq, stream);                       \
  }

CAM_ZM_TAIL_ENTRY(f32, float)
CAM_ZM_TAIL_ENTRY(f64, double)
