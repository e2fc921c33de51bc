// Hopper kernels for the fused FV small step (cd_step as K1-K4).
//
// Replace the Pallas TPU kernels of cam_nor_physics_tpu/models/fv/
// cd_pallas.py; their plain PyTorch versions are k1_ref ... k4_ref in
// models/fv/cd_fused.py, wrappers in ops/cd_fused_kernels.py:
//   K1 <- _k1_kernel: c_sw half step (D->A->C winds, C-grid Courants,
//         tp2c/tp2d at order 1, floors) + the downward pressure pass
//   K2 <- _k2_kernel: upward geopotential pass, C-grid PGF and Coriolis
//         kick, polar filter as real-DFT sums, D-grid Courants
//   K3 <- _k3_kernel: D-grid tp2c/tp2d (PPM, FFSL), floors + the downward
//         pressure pass
//   K4 <- _k4_kernel: upward geopotential pass, vector-invariant wind
//         update (vorticity with cap means, KE, ytp/xtp vorticity fluxes,
//         corner PGF), del2/del4 divergence and del2 velocity damping,
//         polar filter
//
// Design. The TPU kernels run the levels as a sequential grid and carry
// pe, pe^kappa, ln pe (K1, K3) or the interface geopotential (K2, K4) from
// one level to the next in VMEM scratch. Here the carry is a column pass,
// one thread per (j, i) looping over k with the carry in registers. K1 and
// K3 run it last (the downward pass over their thickness and pt), K2 and
// K4 first (the upward pass over the dgz of K1/K3). The level work runs
// over all SMs: row kernels, one block of kRowThreads threads per (row,
// level), whose launch boundaries are the phase boundaries. K1 and K3
// share their transport, tp_core.cuh's row form of tp2c + tp2d (four
// row kernels: inner operators, mass fluxes, dh and q's fluxes, the
// finish with the floors); K1 runs it at order 1 on the C-grid winds and
// Courants of a row kernel of its own. K3's transport and K4's vorticity
// fluxes take every order of tp_core.cuh's set, the order uniform over a
// launch. Intermediate slabs (Courants,
// advective operators, fluxes, energy, corner fields, damping, the
// increments to filter) live in a scratch tensor the wrapper allocates;
// each level's are a few hundred KB and are read back from L2. Launches a
// call: K1 6, K2 5 (2 with the filter off), K3 5, K4 6 (4 with the filter
// off).
//
// The polar filter is the TPU kernel's two-sided real DFT, written out:
// per level row, nf = im/2+1 forward sums over i of a[i]*cos and a[i]*sin,
// times the row's response, then per point the inverse sums over m, each
// sum one product and one addition per term in index order. K2 and K4 run
// it as the two tiled products of dft_filter.cuh over all km*jm level
// rows: K2 filters duc with the center response and dvc with the edge
// response, K4 du with the edge response and dv with the center response.
//
// Numerics. The plain versions are written in the order these kernels
// evaluate; row factors come in one (kNumRows, jm) table from the wrapper
// (cd_fused._metric_rows), so no point divides by a host scalar; the
// library compiles with --fmad=false; pow and log are CUDA's, as PyTorch's
// elementwise kernels call them; the polar-cap sums accumulate in double,
// one thread a sum, in index order.
// The carries start from ptop, ptop^kappa and ln ptop computed in double
// on the host.
//
// Bound. Per call each K reads and writes a few (km, jm, im) slabs: 4 to
// 10 slabs of 1.4 MB at f19 in float32, a few microseconds at 3.35 TB/s.
// The DFT sums of K2 and K4 are 8 * jm * nf * im operations per level and
// filtered field (about 16 MFLOP per level at f19), 0.4 GFLOP per call,
// bound by the FP32 lanes (dft_filter.cuh). The row kernels run km*jm
// blocks; the transport phases re-derive each point's slopes and edge
// values from the slabs in L2, so they stay well above the bytes bound.
#include "dft_filter.cuh"
#include "tp_core.cuh"

#include <stdint.h>

namespace {

using namespace tpc;

constexpr int kColThreads = 256;   // column passes: one thread per (j, i)

// rows of the metric table, in the order of cd_fused.METRIC_ROWS
enum Row {
  kCosp, kAcosp, kCose, kCosen, kF0, kFc, kDxp, kDy, kDxe, kDye, kRdx2,
  kRdy2, kArea, kC4, kNumRows
};

// physical constants and the step's scalars, as the host passes them
struct Consts {
  double cappa, cpair, rearth, dl, dp;
};

template <typename T>
struct Slab {            // a (jm, im) level slab with periodic x
  const T* a;
  int jm, im;
  __device__ T operator()(int j, int i) const {
    return a[j * im + wrap(i, im)];
  }
};

// ------------------------------------------------------------ column passes

// downward pressure pass: pe, pe^kappa and ln pe carried from the top
template <typename T>
__global__ void __launch_bounds__(kColThreads)
down_thermo_kernel(const T* __restrict__ delp, const T* __restrict__ pt,
                   double ptop, double pk_top0, double pl_top0, Consts cs,
                   int km, int n, T* __restrict__ pkz, T* __restrict__ dgz) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += blockDim.x * gridDim.x) {
    T pe_top = T(ptop), pk_top = T(pk_top0), pl_top = T(pl_top0);
    for (int k = 0; k < km; ++k) {
      const size_t idx = (size_t)k * n + p;
      const T pe_bot = pe_top + delp[idx];
      const T pk_bot = pow(pe_bot, T(cs.cappa));
      const T pl_bot = log(pe_bot);
      pkz[idx] = (pk_bot - pk_top) / (T(cs.cappa) * (pl_bot - pl_top));
      dgz[idx] = T(cs.cpair) * pt[idx] * (pk_bot - pk_top);
      pe_top = pe_bot;
      pk_top = pk_bot;
      pl_top = pl_bot;
    }
  }
}

// upward geopotential pass from phis: the layer mean 0.5 (wz_top + wz_bot)
template <typename T>
__global__ void __launch_bounds__(kColThreads)
up_geopotential_kernel(const T* __restrict__ dgz, const T* __restrict__ phis,
                       int km, int n, T* __restrict__ phi) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += blockDim.x * gridDim.x) {
    T wz_bot = phis[p];
    for (int k = km - 1; k >= 0; --k) {
      const size_t idx = (size_t)k * n + p;
      const T wz_top = wz_bot + dgz[idx];
      phi[idx] = T(0.5) * (wz_top + wz_bot);
      wz_bot = wz_top;
    }
  }
}

// ------------------------------------------------------------ shared pieces

// a center field averaged to the SW corner of (j, i); row 0 is zero
template <typename T, typename F>
__device__ T corner(F a, int j, int i) {
  if (j == 0) return T(0);
  return T(0.25) * ((a(j, i) + a(j, i - 1)) + (a(j - 1, i) + a(j - 1, i - 1)));
}

// ------------------------------------------------------------ row kernels
//
// K1-K4 run their level work over all SMs: one block of kRowThreads
// threads (tp_core.cuh) per (row, level), the threads over i, each kernel
// a phase of the TPU kernel's level program. A phase that reads another
// row's result of an earlier phase starts a new launch; the intermediates
// stay in the level scratch slabs.

// ------------------------------------------------------------ K1
//
// The C-grid winds and Courants by a row kernel of their own (the
// transport's va at row j reads cry at row j+1), then K3's transport row
// kernels at order 1 with K1's floors, then the downward pressure pass:
// 6 launches a call. Scratch slabs 0-8 are the transport's (below), 9 crx,
// 10 cry, 11 mfx, 12 mfy, 13 the floored thickness delp_h.

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
k1_winds_kernel(const T* __restrict__ u, const T* __restrict__ v,
                const T* __restrict__ M, double dt5, int jm, int im,
                T* __restrict__ uc0, T* __restrict__ vc0,
                T* __restrict__ crx, T* __restrict__ cry) {
  const int j = blockIdx.x, k = blockIdx.y;
  const size_t off = (size_t)k * jm * im;
  const Slab<T> U{u + off, jm, im}, V{v + off, jm, im};
  // A-grid winds, zero on the pole rows
  auto ua = [&](int jj, int ii) {
    return (jj == 0 || jj == jm - 1) ? T(0)
                                     : T(0.5) * (U(jj, ii) + U(jj + 1, ii));
  };
  auto va = [&](int jj, int ii) {
    return (jj == 0 || jj == jm - 1) ? T(0)
                                     : T(0.5) * (V(jj, ii) + V(jj, ii + 1));
  };
  for (int i = threadIdx.x; i < im; i += blockDim.x) {
    const size_t p = off + (size_t)j * im + i;
    const T uc = T(0.5) * (ua(j, i) + ua(j, i - 1));
    const T vc = j == 0 ? T(0) : T(0.5) * (va(j, i) + va(j - 1, i));
    uc0[p] = uc;
    vc0[p] = vc;
    crx[p] = (j == 0 || j == jm - 1) ? T(0) : uc * T(dt5) / M[kDxp * jm + j];
    cry[p] = j == 0 ? T(0) : vc * T(dt5) / M[kDy * jm + j];
  }
}

// ------------------------------------------------------------ K2
//
// After the upward pass, k2_kick_kernel computes the C-grid PGF and the
// Coriolis kick of each point. With the filter off it finishes the point
// (uc, crx, cry): 2 launches a call. With the filter on it stores the
// kicks duc and dvc; the two DFT products of dft_filter.cuh filter them
// over all km*jm level rows (duc on the center response, dvc on the edge
// response, the opposite of K4) and add them to uc0 and vc0; and
// k2_courant_kernel takes the Courants of uc and vc: 5 launches a call.

// the D-grid Courants of the point (j, i) at p from its new winds
template <typename T>
__device__ __forceinline__ void k2_courants(T uc, T vc, const T* M, double dt,
                                            int j, int jm, size_t p,
                                            T* crx, T* cry) {
  crx[p] = (j == 0 || j == jm - 1) ? T(0) : uc * T(dt) / M[kDxp * jm + j];
  cry[p] = j == 0 ? T(0) : vc * T(dt) / M[kDy * jm + j];
}

// the kicks duc, dvc of row j. The energy en = phi + cp pt pkz at (j, i),
// (j, i-1) and (j-1, i) is recomputed where it is read, not stored by a
// launch of its own: measured on the H100 (tools/k2_energy_ab.py), the
// stored form made a K2 call 3-6% slower at f19, f09 and f05
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
k2_kick_kernel(const T* __restrict__ pt_h, const T* __restrict__ pkz_h,
               const T* __restrict__ uc0, const T* __restrict__ vc0,
               const T* __restrict__ M, double dt, double dt5, Consts cs,
               int filter, int jm, int im, T* __restrict__ uc_out,
               T* __restrict__ crx_out, T* __restrict__ cry_out,
               T* __restrict__ scratch) {
  const int j = blockIdx.x, k = blockIdx.y, km = gridDim.y;
  const int n = jm * im;
  const size_t off = (size_t)k * n;
  auto S = [&](int s) { return scratch + ((size_t)s * km + k) * n; };
  T *duc = S(1), *dvc = S(2);
  const T cp = T(cs.cpair);
  const Slab<T> PHI{S(0), jm, im}, P{pt_h + off, jm, im},
      Z{pkz_h + off, jm, im}, U{uc0 + off, jm, im}, V{vc0 + off, jm, im};
  auto E = [&](int jj, int ii) {
    return PHI(jj, ii) + cp * P(jj, ii) * Z(jj, ii);
  };
  const T dxp = M[kDxp * jm + j], dy = M[kDy * jm + j];
  for (int i = threadIdx.x; i < im; i += blockDim.x) {
    const int idx = j * im + i;
    const T e = E(j, i);
    T pgf_u = T(0), pgf_v = T(0);
    if (j != 0 && j != jm - 1) {
      const T dx_en = (e - E(j, i - 1)) / dxp;
      const T dx_th = (P(j, i) - P(j, i - 1)) / dxp;
      const T pi_u = T(0.5) * (Z(j, i) + Z(j, i - 1));
      pgf_u = -(dx_en - cp * pi_u * dx_th);
    }
    if (j != 0) {
      const T dy_en = (e - E(j - 1, i)) / dy;
      const T dy_th = (P(j, i) - P(j - 1, i)) / dy;
      const T pi_v = T(0.5) * (Z(j, i) + Z(j - 1, i));
      pgf_v = -(dy_en - cp * pi_v * dy_th);
    }
    // vc at uc points and uc at vc points
    auto vcc = [&](int ii) {
      return T(0.5) * (V(j, ii) + (j == jm - 1 ? T(0) : V(j + 1, ii)));
    };
    const T vcu = T(0.5) * (vcc(i) + vcc(i - 1));
    const T ucv = j == 0 ? T(0) : T(0.5) * (U(j, i) + U(j - 1, i));
    const T du = T(dt5) * (M[kF0 * jm + j] * vcu + pgf_u);
    const T dv = T(dt5) * (-M[kFc * jm + j] * ucv + pgf_v);
    if (filter) {
      duc[idx] = du;
      dvc[idx] = dv;
    } else {
      const T uc = U(j, i) + du;
      uc_out[off + idx] = uc;
      k2_courants(uc, V(j, i) + dv, M, dt, j, jm, off + idx, crx_out,
                  cry_out);
    }
  }
}

// the Courants of row j from the filtered uc and vc
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
k2_courant_kernel(const T* __restrict__ uc, const T* __restrict__ vc,
                  const T* __restrict__ M, double dt, int jm, int im,
                  T* __restrict__ crx, T* __restrict__ cry) {
  const int j = blockIdx.x, k = blockIdx.y;
  const size_t r = ((size_t)k * jm + j) * im;
  for (int i = threadIdx.x; i < im; i += blockDim.x)
    k2_courants(uc[r + i], vc[r + i], M, dt, j, jm, r + i, crx, cry);
}

// ------------------------------------------------------------ K3
//
// The D-grid transport in tp_core.cuh's row form, one row kernel a phase
// (phases 2 and 3 are tp_core.cuh's tp_flux_kernel and tp_q_flux_kernel),
// then the downward pressure pass: 5 launches a call. K1 runs the same
// kernels at order 1. Scratch slabs: 0 yfx, 1 va, 2-5 adx(h), ady(h),
// adx(q), ady(q), 6 dh, 7 fy, 8 fx.

// phase 1: yfx, va, the row's FFSL flag (stored per (level, row) for the
// later phases), adx/ady of h and q
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
tp_inner_kernel(const T* __restrict__ delp, const T* __restrict__ pt,
                const T* __restrict__ crx, const T* __restrict__ cry,
                const T* __restrict__ M, int band, int K, int jm, int im,
                T* __restrict__ scratch, uint8_t* __restrict__ flags) {
  const int j = blockIdx.x, k = blockIdx.y, km = gridDim.y;
  const int n = jm * im;
  const size_t off = (size_t)k * n;
  auto S = [&](int s) { return scratch + ((size_t)s * km + k) * n; };
  T *yfx = S(0), *va = S(1);
  const T *cx = crx + off, *cy = cry + off;
  for (int i = threadIdx.x; i < im; i += blockDim.x) {
    const int idx = j * im + i;
    yfx[idx] = cy[idx] * M[kCose * jm + j];
    va[idx] = T(0.5) * (cy[idx] + (j == jm - 1 ? T(0) : cy[idx + im]));
  }
  // (the reduction's __syncthreads() also orders va before ady reads it)
  const bool flag = row_ffsl_flag<T, kRowThreads>(cx + (size_t)j * im, im);
  if (threadIdx.x == 0) flags[(size_t)k * jm + j] = flag ? 1 : 0;
  const T* q[2] = {delp + off, pt + off};
  T* const sx[2] = {S(2), S(4)};
  T* const sy[2] = {S(3), S(5)};
  tp_row_inner<2>(q, cx, va, ffsl_in_band(flag, j, jm, band),
                  M[kCosp * jm + j], K, j, jm, im, sx, sy);
}

// phase 4: dq, the thickness floor and pt; kFloorPt (K1) also floors pt
// at a tenth of its old value
template <typename T, bool kFloorPt>
__global__ void __launch_bounds__(kRowThreads)
tp_finish_kernel(const T* __restrict__ delp, const T* __restrict__ pt,
                 const T* __restrict__ M, double rcap, int jm, int im,
                 T* __restrict__ delp_new, T* __restrict__ pt_new,
                 T* __restrict__ scratch) {
  const int j = blockIdx.x, k = blockIdx.y, km = gridDim.y;
  const int n = jm * im;
  const size_t off = (size_t)k * n;
  auto S = [&](int s) { return scratch + ((size_t)s * km + k) * n; };
  const T *ddp = S(6), *fy = S(7), *fx = S(8);
  const T cap = row_cap(fy, j, jm, im, rcap);
  const T acosa = M[kAcosp * jm + j];
  for (int i = threadIdx.x; i < im; i += blockDim.x) {
    const int idx = j * im + i;
    const T dq = div_point(fx, fy, j, i, jm, im, acosa, cap, cap);
    const T d = delp[off + idx], p = pt[off + idx];
    const T dn = tmax(d + ddp[idx], T(0.05) * d);
    const T pn = (p * d + dq) / dn;
    delp_new[off + idx] = dn;
    pt_new[off + idx] = kFloorPt ? tmax(pn, T(0.1) * p) : pn;
  }
}

// ------------------------------------------------------------ K4
//
// After the upward pass, three row kernels, then, with the filter on, the
// two tiled DFT products of dft_filter.cuh over all level rows of du and
// dv: 6 launches a call, 4 with the filter off.

enum KeMethod { kKeCentered = 0, kKeAvgSq = 1, kKeUpwind = 2 };

// phase 1: the row's FFSL flag, the polar-cap means (rows 0 and jm-1),
// and at each point the absolute vorticity, the energy, the advecting
// winds times dt and the corner divergence of the old winds
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
k4_vort_kernel(const T* __restrict__ u, const T* __restrict__ v,
               const T* __restrict__ pt_new, const T* __restrict__ pkz,
               const T* __restrict__ crx, const T* __restrict__ ucin,
               const T* __restrict__ M, double dt, double rcirc, Consts cs,
               int ke_method, int jm, int im, T* __restrict__ scratch,
               uint8_t* __restrict__ flags) {
  const int j = blockIdx.x, k = blockIdx.y, km = gridDim.y;
  const int n = jm * im;
  const size_t off = (size_t)k * n;
  auto S = [&](int s) { return scratch + ((size_t)s * km + k) * n; };
  const T* phi = S(0);
  T *zeta = S(1), *en = S(2), *udt = S(3), *vedt = S(4), *div = S(5);
  __shared__ T cap;
  const T cp = T(cs.cpair), tdt = T(dt), tdl = T(cs.dl), tdp = T(cs.dp),
          tre = T(cs.rearth);
  const T* cose = M + kCose * jm;
  const Slab<T> U{u + off, jm, im}, V{v + off, jm, im};
  const Slab<T> PT{pt_new + off, jm, im}, PK{pkz + off, jm, im};
  const T* cx = crx + off + (size_t)j * im;

  // the polar-cap mean of the circulation, in double over i in order (one
  // thread: unrolled so that the loads run ahead of the dependent sum)
  auto cap_sum = [&](int jj) {
    const T* r = u + off + (size_t)jj * im;
    const T cj = cose[jj];
    double s = 0.0;
#pragma unroll 16
    for (int i = 0; i < im; ++i) s = s + (double)(r[i] * cj * tdl * tre);
    return s;
  };
  if (threadIdx.x == 0 && j == 0) cap = (T)(-cap_sum(1) * rcirc);
  if (threadIdx.x == 0 && j == jm - 1) cap = (T)(cap_sum(jm - 1) * rcirc);
  // the row's FFSL flag (its __syncthreads() also publishes cap)
  const bool flag = row_ffsl_flag<T, kRowThreads>(cx, im);
  if (threadIdx.x == 0) flags[(size_t)k * jm + j] = flag ? 1 : 0;

  auto a_of_v = [&](int jj, int ii) {
    return T(0.5) * (V(jj, ii) + V(jj, ii + 1));
  };
  const bool interior = j != 0 && j != jm - 1;
  for (int i = threadIdx.x; i < im; i += blockDim.x) {
    const int idx = j * im + i;
    const T uu = U(j, i), vv = V(j, i);
    const T u_n = j == jm - 1 ? T(0) : U(j + 1, i);
    const T v_e = V(j, i + 1);
    // absolute vorticity
    T z;
    if (!interior) {
      z = cap;
    } else {
      const T circ = (uu * cose[j] - u_n * M[kCosen * jm + j]) * tdl * tre +
                     (v_e - vv) * tdp * tre;
      z = circ / M[kArea * jm + j];
    }
    zeta[idx] = z + M[kF0 * jm + j];
    // kinetic energy
    const T ua = interior ? T(0.5) * (uu + u_n) : T(0);
    const T va = interior ? T(0.5) * (vv + v_e) : T(0);
    T ke;
    if (ke_method == kKeUpwind) {
      const T u_sel = va >= T(0) ? uu : u_n;
      const T v_sel = ua >= T(0) ? vv : v_e;
      ke = interior ? T(0.5) * (u_sel * u_sel + v_sel * v_sel)
                    : T(0.5) * (ua * ua + va * va);
    } else if (ke_method == kKeAvgSq) {
      const T ke_u = interior ? T(0.5) * (uu * uu + u_n * u_n) : T(0);
      const T ke_v = interior ? T(0.5) * (vv * vv + v_e * v_e) : T(0);
      ke = T(0.5) * (ke_u + ke_v);
    } else {
      ke = T(0.5) * (ua * ua + va * va);
    }
    en[idx] = ke + phi[idx] + cp * PT(j, i) * PK(j, i);
    udt[idx] = ucin[off + idx] * tdt;
    // v at the u points (through the corners) times dt
    auto vc4 = [&](int ii) { return corner<T>(a_of_v, j, ii); };
    vedt[idx] = T(0.5) * (vc4(i) + vc4(i + 1)) * tdt;
    // divergence at the SW corner from the old winds
    if (interior) {
      const T vt = vv * M[kCosp * jm + j];
      const T vt_s = V(j - 1, i) * M[kCosp * jm + j - 1];
      div[idx] = (uu - U(j, i - 1)) / M[kDxe * jm + j] +
                 (vt - vt_s) / M[kDye * jm + j];
    } else {
      div[idx] = T(0);
    }
  }
}

// phase 2: energy, pt and pkz at the corners, and the divergence damping
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
k4_corner_kernel(const T* __restrict__ pt_new, const T* __restrict__ pkz,
                 const T* __restrict__ M, const T* __restrict__ nu2,
                 int div2_on, int del4_on, int jm, int im,
                 T* __restrict__ scratch) {
  const int j = blockIdx.x, k = blockIdx.y, km = gridDim.y;
  const int n = jm * im;
  const size_t off = (size_t)k * n;
  auto S = [&](int s) { return scratch + ((size_t)s * km + k) * n; };
  const T *en = S(2), *div = S(5);
  T *enc = S(6), *thc = S(7), *pic = S(8), *damp = S(9);
  const Slab<T> PT{pt_new + off, jm, im}, PK{pkz + off, jm, im};
  const Slab<T> EN{en, jm, im}, DIV{div, jm, im};
  for (int i = threadIdx.x; i < im; i += blockDim.x) {
    const int idx = j * im + i;
    enc[idx] = corner<T>(EN, j, i);
    thc[idx] = corner<T>(PT, j, i);
    pic[idx] = corner<T>(PK, j, i);
    T d = T(0);
    if (div2_on) d = d + nu2[(size_t)k * jm + j] * div[idx];
    if (del4_on) {
      T lap = T(0);
      if (j != 0 && j != jm - 1) {
        const T dd = div[idx];
        lap = (DIV(j, i + 1) - T(2) * dd + DIV(j, i - 1)) * M[kRdx2 * jm + j] +
              (DIV(j + 1, i) - T(2) * dd + DIV(j - 1, i)) * M[kRdy2 * jm + j];
      }
      d = d - M[kC4 * jm + j] * lap;
    }
    damp[idx] = d;
  }
}

// phase 3: the wind increments (vorticity fluxes, corner PGF, damping,
// del2 velocity damping); the new winds, or with the filter on the
// increments du, dv for the DFT products. In float32, 25 blocks an SM
// (at most 40 registers): left to itself ptxas takes 56 for the
// vorticity fluxes' higher orders, which cost the kernel 18% at order 4
// at f05 (tools/stencil_ab.py)
template <typename T>
__global__ void __launch_bounds__(kRowThreads, sizeof(T) == 4 ? 25 : 1)
k4_wind_kernel(const T* __restrict__ u, const T* __restrict__ v,
               const T* __restrict__ crx, const T* __restrict__ cry,
               const T* __restrict__ M, double dt, double dtdel2, Consts cs,
               int iord, int jord, int filter, int band, int K, int jm,
               int im, T* __restrict__ u_new, T* __restrict__ v_new,
               T* __restrict__ scratch, const uint8_t* __restrict__ flags) {
  const int j = blockIdx.x, k = blockIdx.y, km = gridDim.y;
  const int n = jm * im;
  const size_t off = (size_t)k * n;
  auto S = [&](int s) { return scratch + ((size_t)s * km + k) * n; };
  const T *zeta = S(1), *udt = S(3), *vedt = S(4);
  T *du_s = S(10), *dv_s = S(11);
  const uint8_t* fl = flags + (size_t)k * jm;
  const T cp = T(cs.cpair), tdt = T(dt);
  const Slab<T> U{u + off, jm, im}, V{v + off, jm, im};
  const Slab<T> ENC{S(6), jm, im}, THC{S(7), jm, im}, PIC{S(8), jm, im},
      DAMP{S(9), jm, im};
  const T *cx = crx + off, *cy = cry + off;
  const bool interior = j != 0 && j != jm - 1;
  const T dxe = M[kDxe * jm + j], dy = M[kDy * jm + j];
  const bool ffsl = ffsl_row(fl, j, jm, band);
  for (int i = threadIdx.x; i < im; i += blockDim.x) {
    const int idx = j * im + i;
    const T fy_z = ytp_point(zeta, cy, vedt, j, i, jm, im, jord);
    const T fx_z = xtp_point(zeta + j * im, cx + j * im, udt + j * im, i, im,
                             M[kCosp * jm + j], ffsl, iord, 1, K);
    T du = T(0), dv = T(0);
    if (j != 0) {
      const T dx_en = (ENC(j, i + 1) - ENC(j, i)) / dxe;
      const T dx_th = (THC(j, i + 1) - THC(j, i)) / dxe;
      const T pi_u = T(0.5) * (PIC(j, i) + PIC(j, i + 1));
      du = fy_z - tdt * (dx_en - cp * pi_u * dx_th);
    }
    if (interior) {
      const T dy_en = (ENC(j + 1, i) - ENC(j, i)) / dy;
      const T dy_th = (THC(j + 1, i) - THC(j, i)) / dy;
      const T pi_v = T(0.5) * (PIC(j + 1, i) + PIC(j, i));
      dv = -fx_z - tdt * (dy_en - cp * pi_v * dy_th);
    }
    du = du + tdt * ((DAMP(j, i + 1) - DAMP(j, i)) / dxe);
    dv = dv + tdt * (interior ? (DAMP(j + 1, i) - DAMP(j, i)) / dy : T(0));
    if (dtdel2 > 0.0) {
      const T rdx2 = M[kRdx2 * jm + j], rdy2 = M[kRdy2 * jm + j];
      auto lap = [&](const Slab<T>& A) {
        const T a = A(j, i);
        const T d2x = (A(j, i + 1) - T(2) * a + A(j, i - 1)) * rdx2;
        const T d2y = interior
            ? (A(j + 1, i) - T(2) * a + A(j - 1, i)) * rdy2 : T(0);
        return d2x + d2y;
      };
      du = du + T(dtdel2) * lap(U);
      dv = dv + T(dtdel2) * lap(V);
    }
    if (filter) {
      du_s[idx] = du;
      dv_s[idx] = dv;
    } else {
      u_new[off + idx] = U(j, i) + du;
      v_new[off + idx] = V(j, i) + dv;
    }
  }
}

// ------------------------------------------------------------ launches

int col_blocks(int n) { return (n + kColThreads - 1) / kColThreads; }

// the transport row kernels of K1 and K3 and the downward pass over the
// new thickness and pt: 5 launches
template <typename T, bool kFloorPt>
void launch_transport_rows(const T* delp, const T* pt, const T* crx,
                           const T* cry, const T* M, double rcap,
                           double ptop, double pk0, double pl0, Consts cs,
                           int iord, int jord, int band, int K, int km,
                           int jm, int im, T* delp_new, T* pt_new, T* mfx,
                           T* mfy, T* pkz, T* dgz, T* scratch,
                           uint8_t* flags, cudaStream_t st) {
  const int n = jm * im;
  const dim3 rows(jm, km);
  tp_inner_kernel<T><<<rows, kRowThreads, 0, st>>>(
      delp, pt, crx, cry, M, band, K, jm, im, scratch, flags);
  auto S = [&](int s) { return scratch + (size_t)s * km * n; };
  tp_flux_kernel<T, 0><<<rows, kRowThreads, 0, st>>>(
      S(2), S(3), crx, cry, crx, S(0), flags, M + kCosp * jm, iord, jord,
      band, K, jm, im, mfx, mfy);
  tp_q_flux_kernel<T><<<rows, kRowThreads, 0, st>>>(
      S(4), S(5), crx, cry, mfx, mfy, flags, M + kCosp * jm,
      M + kAcosp * jm, rcap, iord, jord, band, K, jm, im, S(6), S(8), S(7));
  tp_finish_kernel<T, kFloorPt><<<rows, kRowThreads, 0, st>>>(
      delp, pt, M, rcap, jm, im, delp_new, pt_new, scratch);
  down_thermo_kernel<T><<<col_blocks(n), kColThreads, 0, st>>>(
      delp_new, pt_new, ptop, pk0, pl0, cs, km, n, pkz, dgz);
}

template <typename T>
int launch_k1(const T* u, const T* v, const T* pt, const T* delp, const T* M,
              double dt5, double rcap, double ptop, double pk0, double pl0,
              Consts cs, int band, int K, int km, int jm, int im, T* pt_h,
              T* uc0, T* vc0, T* pkz_h, T* dgz_h, T* scratch,
              uint8_t* flags, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t ns = (size_t)km * jm * im;     // one scratch slab
  T *crx = scratch + 9 * ns, *cry = scratch + 10 * ns,
    *mfx = scratch + 11 * ns, *mfy = scratch + 12 * ns,
    *delp_h = scratch + 13 * ns;
  k1_winds_kernel<T><<<dim3(jm, km), kRowThreads, 0, st>>>(
      u, v, M, dt5, jm, im, uc0, vc0, crx, cry);
  launch_transport_rows<T, true>(delp, pt, crx, cry, M, rcap, ptop, pk0, pl0,
                                 cs, 1, 1, band, K, km, jm, im, delp_h, pt_h,
                                 mfx, mfy, pkz_h, dgz_h, scratch, flags, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k2(const T* pt_h, const T* pkz_h, const T* dgz_h, const T* uc0,
              const T* vc0, const T* phis, const T* M, const T* fcm,
              const T* fsm, const T* gcm, const T* gsm, const T* rspc,
              const T* rspe, double dt, double dt5, Consts cs, int filter,
              int km, int jm, int im, T* uc, T* crx, T* cry, T* scratch,
              T* spec, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int n = jm * im;
  const dim3 rows(jm, km);
  up_geopotential_kernel<T><<<col_blocks(n), kColThreads, 0, st>>>(
      dgz_h, phis, km, n, scratch);
  k2_kick_kernel<T><<<rows, kRowThreads, 0, st>>>(
      pt_h, pkz_h, uc0, vc0, M, dt, dt5, cs, filter, jm, im, uc, crx, cry,
      scratch);
  if (filter) {
    // duc (center response) and dvc (edge response) of every level row;
    // the inverse adds them to uc0 (into uc) and vc0 (into slab 3)
    const int rows_all = km * jm;
    const size_t ns = (size_t)rows_all * dftf::spectrum_stride(im / 2 + 1);
    const T *duc = scratch + (size_t)km * n,
            *dvc = scratch + (size_t)2 * km * n;
    T* vc = scratch + (size_t)3 * km * n;
    dftf::launch_dft_filter<T>({duc, rspc, spec, spec + ns},
                               {dvc, rspe, spec + 2 * ns, spec + 3 * ns},
                               {spec, spec + ns, uc0, uc},
                               {spec + 2 * ns, spec + 3 * ns, vc0, vc}, fcm,
                               fsm, gcm, gsm, rows_all, jm, im, st);
    k2_courant_kernel<T><<<rows, kRowThreads, 0, st>>>(uc, vc, M, dt, jm, im,
                                                       crx, cry);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k3(const T* delp, const T* pt, const T* crx, const T* cry,
              const T* M, double rcap, double ptop, double pk0, double pl0,
              Consts cs, int iord, int jord, int band, int K, int km, int jm,
              int im, T* delp_new, T* pt_new, T* mfx, T* mfy, T* pkz, T* dgz,
              T* scratch, uint8_t* flags, void* stream) {
  launch_transport_rows<T, false>(delp, pt, crx, cry, M, rcap, ptop, pk0, pl0,
                                  cs, iord, jord, band, K, km, jm, im,
                                  delp_new, pt_new, mfx, mfy, pkz, dgz,
                                  scratch, flags, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k4(const T* u, const T* v, const T* pt_new, const T* pkz,
              const T* dgz, const T* phis, const T* crx, const T* cry,
              const T* uc, const T* M, const T* nu2, const T* fcm,
              const T* fsm, const T* gcm, const T* gsm, const T* rspc,
              const T* rspe, double dt, double dtdel2, double rcirc,
              Consts cs, int iord, int jord, int ke_method, int div2_on,
              int del4_on, int filter, int band, int K, int km, int jm,
              int im, T* u_new, T* v_new, T* scratch, T* spec,
              uint8_t* flags, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int n = jm * im;
  const dim3 rows(jm, km);
  up_geopotential_kernel<T><<<col_blocks(n), kColThreads, 0, st>>>(
      dgz, phis, km, n, scratch);
  k4_vort_kernel<T><<<rows, kRowThreads, 0, st>>>(
      u, v, pt_new, pkz, crx, uc, M, dt, rcirc, cs, ke_method, jm, im,
      scratch, flags);
  k4_corner_kernel<T><<<rows, kRowThreads, 0, st>>>(
      pt_new, pkz, M, nu2, div2_on, del4_on, jm, im, scratch);
  k4_wind_kernel<T><<<rows, kRowThreads, 0, st>>>(
      u, v, crx, cry, M, dt, dtdel2, cs, iord, jord, filter, band, K, jm,
      im, u_new, v_new, scratch, flags);
  if (filter) {
    // du (edge response) and dv (center response) of every level row
    const int rows_all = km * jm;
    const size_t ns = (size_t)rows_all * dftf::spectrum_stride(im / 2 + 1);
    const T *du = scratch + (size_t)10 * km * n,
            *dv = scratch + (size_t)11 * km * n;
    dftf::launch_dft_filter<T>(
        {du, rspe, spec, spec + ns}, {dv, rspc, spec + 2 * ns, spec + 3 * ns},
        {spec, spec + ns, u, u_new}, {spec + 2 * ns, spec + 3 * ns, v, v_new},
        fcm, fsm, gcm, gsm, rows_all, jm, im, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define CAM_CD_FUSED_ENTRY(SUF, T)                                            \
  extern "C" int cam_cd_k1_##SUF(                                             \
      const T* u, const T* v, const T* pt, const T* delp, const T* M,         \
      double dt5, double rcap, double ptop, double pk0, double pl0,           \
      double cappa, double cpair, int band, int K, int km, int jm, int im,    \
      T* pt_h, T* uc0, T* vc0, T* pkz_h, T* dgz_h, T* scratch,                \
      uint8_t* flags, void* stream) {                                         \
    const Consts cs{cappa, cpair, 0.0, 0.0, 0.0};                             \
    return launch_k1<T>(u, v, pt, delp, M, dt5, rcap, ptop, pk0, pl0, cs,     \
                        band, K, km, jm, im, pt_h, uc0, vc0, pkz_h, dgz_h,    \
                        scratch, flags, stream);                              \
  }                                                                           \
  extern "C" int cam_cd_k2_##SUF(                                             \
      const T* pt_h, const T* pkz_h, const T* dgz_h, const T* uc0,            \
      const T* vc0, const T* phis, const T* M, const T* fcm, const T* fsm,    \
      const T* gcm, const T* gsm, const T* rspc, const T* rspe, double dt,    \
      double dt5, double cpair, int filter, int km, int jm, int im, T* uc,    \
      T* crx, T* cry, T* scratch, T* spec, void* stream) {                    \
    const Consts cs{0.0, cpair, 0.0, 0.0, 0.0};                               \
    return launch_k2<T>(pt_h, pkz_h, dgz_h, uc0, vc0, phis, M, fcm, fsm, gcm, \
                        gsm, rspc, rspe, dt, dt5, cs, filter, km, jm, im, uc, \
                        crx, cry, scratch, spec, stream);                     \
  }                                                                           \
  extern "C" int cam_cd_k3_##SUF(                                             \
      const T* delp, const T* pt, const T* crx, const T* cry, const T* M,     \
      double rcap, double ptop, double pk0, double pl0, double cappa,         \
      double cpair, int iord, int jord, int band, int K, int km, int jm,      \
      int im, T* delp_new, T* pt_new, T* mfx, T* mfy, T* pkz, T* dgz,         \
      T* scratch, uint8_t* flags, void* stream) {                             \
    const Consts cs{cappa, cpair, 0.0, 0.0, 0.0};                             \
    return launch_k3<T>(delp, pt, crx, cry, M, rcap, ptop, pk0, pl0, cs,      \
                        iord, jord, band, K, km, jm, im, delp_new, pt_new,    \
                        mfx, mfy, pkz, dgz, scratch, flags, stream);          \
  }                                                                           \
  extern "C" int cam_cd_k4_##SUF(                                             \
      const T* u, const T* v, const T* pt_new, const T* pkz, const T* dgz,    \
      const T* phis, const T* crx, const T* cry, const T* uc, const T* M,     \
      const T* nu2, const T* fcm, const T* fsm, const T* gcm, const T* gsm,   \
      const T* rspc, const T* rspe, double dt, double dtdel2, double rcirc,   \
      double cpair, double rearth, double dl, double dp, int iord, int jord,  \
      int ke_method, int div2_on, int del4_on, int filter, int band, int K,   \
      int km, int jm, int im, T* u_new, T* v_new, T* scratch, T* spec,        \
      uint8_t* flags, void* stream) {                                         \
    const Consts cs{0.0, cpair, rearth, dl, dp};                              \
    return launch_k4<T>(u, v, pt_new, pkz, dgz, phis, crx, cry, uc, M, nu2,   \
                        fcm, fsm, gcm, gsm, rspc, rspe, dt, dtdel2, rcirc,    \
                        cs, iord, jord, ke_method, div2_on, del4_on, filter,  \
                        band, K, km, jm, im, u_new, v_new, scratch, spec,     \
                        flags, stream);                                       \
  }

CAM_CD_FUSED_ENTRY(f32, float)
CAM_CD_FUSED_ENTRY(f64, double)
