// Hopper kernel for te_map's conservative vertical PPM remap.
//
// Replaces the Pallas TPU kernel _te_map_kernel (te_map_remap_pallas,
// cam_nor_physics_tpu/ops/remap_pallas.py): PPM edges with the kord limiter,
// then the cumulative mass of the piecewise-parabolic reconstruction at each
// target interface (a clip-integral over all source cells, no search), for the
// center fields (pt, tracers) on pe_s -> pe_t and for u / v on their own
// staggered interface sets.
//
// Design. One thread per column: a column's km source cells are independent
// of every other column, so the TPU's (km, block-of-columns) program becomes
// a thread that keeps its column's reconstruction in local arrays and loops
// over levels. In the natural (k, ncol) layout neighbouring threads read
// neighbouring addresses, so every load and store is coalesced.
//
// Bound. The kernel reads 6 interface sets ((km+1) x ncol) and nf+2 fields
// once and writes nf+2 fields once; its arithmetic is O(km * km_t) per column
// and field (about 10 flops per source-target pair, ~7k per column at km=26),
// 13,824 columns at f19: tens of MFLOP, so it is bound by the bytes, a few
// microseconds at 3.35 TB/s. With 13,824 threads it fills the card only
// partially; that and register spills of the km-long arrays are what a later
// version would tune.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 64;       // remap_kernels.MAX_LEVELS: the wrapper refuses more
constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

// Remap one field of one column: q (km values at stride ncol) from source
// interfaces ps to target interfaces pt (km + 1 values at stride ncol).
template <typename T>
__device__ void remap_column(const T* ps, const T* pt, const T* q, T* out,
                             int km, int km_t, int ncol, int kord) {
  T dp[kMaxK], qq[kMaxK], dm[kMaxK], al[kMaxK], half[kMaxK], third[kMaxK];
  for (int k = 0; k < km; ++k) {
    dp[k] = ps[(k + 1) * ncol] - ps[k * ncol];
    qq[k] = q[k * ncol];
  }
  // limited slopes (zero in the end cells)
  for (int k = 0; k < km; ++k) {
    if (k == 0 || k == km - 1) {
      dm[k] = T(0);
      continue;
    }
    const T dqc = T(0.5) * ((qq[k + 1] - qq[k]) + (qq[k] - qq[k - 1]));
    const T qmax = tmax(tmax(qq[k - 1], qq[k]), qq[k + 1]) - qq[k];
    const T qmin = qq[k] - tmin(tmin(qq[k - 1], qq[k]), qq[k + 1]);
    dm[k] = sgn(dqc) * tmin(tmin(fabs(dqc), qmax), qmin);
  }
  // edges, limiter, and the parabola coefficients
  T total = T(0);
  for (int k = 0; k < km; ++k) {
    total = total + qq[k] * dp[k];
    const T q0 = qq[k];
    T a_l, a_r, a6;
    if (kord <= 2) {
      a_l = q0 - dm[k];
      a_r = q0 + dm[k];
      a6 = T(0);
    } else {
      a_l = k == 0 ? q0
                   : qq[k - 1] + dp[k - 1] / (dp[k - 1] + dp[k]) * (q0 - qq[k - 1]) +
                         (dm[k - 1] - dm[k]) * T(1.0 / 3.0);
      a_r = k == km - 1 ? q0
                        : q0 + dp[k] / (dp[k] + dp[k + 1]) * (qq[k + 1] - q0) +
                              (dm[k] - dm[k + 1]) * T(1.0 / 3.0);
      a6 = T(3.0) * (q0 + q0 - (a_l + a_r));
      if (kord == 3) {              // lmppm lmt = 0
        const T da1 = a_r - a_l;
        const T da2 = da1 * da1;
        const T a6da = a6 * da1;
        const bool lo = a6da < -da2, hi = a6da > da2, zero = dm[k] == T(0);
        const T a6_lo = T(3.0) * (a_l - q0), ar_lo = a_l - a6_lo;
        const T a6_hi = T(3.0) * (a_r - q0), al_hi = a_r - a6_hi;
        const T a6n = zero ? T(0) : (lo ? a6_lo : (hi ? a6_hi : a6));
        const T arn = zero ? q0 : (lo ? ar_lo : a_r);
        const T aln = zero ? q0 : (hi ? al_hi : a_l);
        a6 = a6n;
        a_r = arn;
        a_l = aln;
      } else {                      // lmppm lmt >= 1
        const T da1 = dm[k] + dm[k];
        const T dl = sgn(da1) * tmin(fabs(da1), fabs(a_l - q0));
        const T dr = sgn(da1) * tmin(fabs(da1), fabs(a_r - q0));
        a_r = q0 + dr;
        a_l = q0 - dl;
        a6 = T(3.0) * (dl - dr);
      }
    }
    al[k] = a_l;
    half[k] = T(0.5) * ((a_r - a_l) + a6);
    third[k] = a6 * T(1.0 / 3.0);
  }
  // cumulative mass at each target interface; the end interfaces are the
  // column's top (0) and its full mass
  T m_prev = T(0);
  for (int kt = 1; kt <= km_t; ++kt) {
    T m;
    if (kt == km_t) {
      m = total;
    } else {
      const T x = pt[kt * ncol];
      m = T(0);
      for (int k = 0; k < km; ++k) {
        const T dps = dp[k] == T(0) ? T(1e-30) : dp[k];
        T s = (x - ps[k * ncol]) / dps;
        s = s < T(0) ? T(0) : (s > T(1) ? T(1) : s);
        m = m + dp[k] * (s * (al[k] + s * (half[k] - third[k] * s)));
      }
    }
    out[(kt - 1) * ncol] = (m - m_prev) / (pt[kt * ncol] - pt[(kt - 1) * ncol]);
    m_prev = m;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
te_map_kernel(const T* __restrict__ pe_s, const T* __restrict__ pe_t,
              const T* __restrict__ pe_su, const T* __restrict__ pe_tu,
              const T* __restrict__ pe_sv, const T* __restrict__ pe_tv,
              const T* __restrict__ cen, const T* __restrict__ u,
              const T* __restrict__ v, int nf, int km, int km_t, int ncol,
              int kord, T* __restrict__ cen_out, T* __restrict__ u_out,
              T* __restrict__ v_out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  for (int f = 0; f < nf; ++f)
    remap_column(pe_s + col, pe_t + col, cen + (size_t)f * km * ncol + col,
                 cen_out + (size_t)f * km_t * ncol + col, km, km_t, ncol,
                 kord);
  remap_column(pe_su + col, pe_tu + col, u + col, u_out + col, km, km_t, ncol,
               kord);
  remap_column(pe_sv + col, pe_tv + col, v + col, v_out + col, km, km_t, ncol,
               kord);
}

template <typename T>
int launch_te_map(const T* pe_s, const T* pe_t, const T* pe_su,
                  const T* pe_tu, const T* pe_sv, const T* pe_tv, const T* cen,
                  const T* u, const T* v, int nf, int km, int km_t, int ncol,
                  int kord, T* cen_out, T* u_out, T* v_out, void* stream) {
  const int blocks = (ncol + kThreads - 1) / kThreads;
  te_map_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv, cen, u, v, nf, km, km_t, ncol,
      kord, cen_out, u_out, v_out);
  return (int)cudaGetLastError();
}

}  // namespace

#define CAM_REMAP_ENTRY(SUF, T)                                               \
  extern "C" int cam_te_map_remap_##SUF(                                      \
      const T* pe_s, const T* pe_t, const T* pe_su, const T* pe_tu,           \
      const T* pe_sv, const T* pe_tv, const T* cen, const T* u, const T* v,   \
      int nf, int km, int km_t, int ncol, int kord, T* cen_out, T* u_out,     \
      T* v_out, void* stream) {                                               \
    return launch_te_map<T>(pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv, cen, u,   \
                            v, nf, km, km_t, ncol, kord, cen_out, u_out,      \
                            v_out, stream);                                   \
  }

CAM_REMAP_ENTRY(f32, float)
CAM_REMAP_ENTRY(f64, double)
