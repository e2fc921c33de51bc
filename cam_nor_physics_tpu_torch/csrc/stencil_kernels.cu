// Hopper kernels for the FV dycore's horizontal transport stencils.
//
// Replace the Pallas TPU kernels of cam_nor_physics_tpu/ops/pallas_kernels.py:
//   transport3d  <- _transport_kernel: tp2c of delp plus the mass-consistent
//                   tp2d of pt, polar caps closed
//   vort_flux3d  <- _vort_kernel: ytp/xtp fluxes of the absolute vorticity
//   tracer_div3d <- _tracer_kernel: trac2d's tracer-mass flux divergence,
//                   polar caps closed
//
// Design. The TPU kernels run one grid step per level with the whole (jm, im)
// slab in VMEM. Here each function runs over all SMs as row kernels, one
// block of kRowThreads threads per (row, level, field) on a (jm, km, nf)
// grid, through tp_core.cuh's row form, the launch boundaries its phase
// boundaries:
//   transport3d: row_inner_kernel<2> (adx, ady of delp and pt),
//     tp_flux_kernel<T, 0> (the mass fluxes mfy, mfx: outputs),
//     tp_q_flux_kernel (ddp; pt's fluxes), tp_div_kernel (dpt): 4 launches;
//   vort_flux3d: tp_flux_kernel<T, 1> on the vorticity: 1 launch;
//   tracer_div3d, nf = nq: row_inner_kernel<1>, tp_flux_kernel<T, 1> with
//     the given mass fluxes, tp_div_kernel: 3 launches.
// tp_flux_kernel and tp_q_flux_kernel are K1's and K3's phases 2 and 3
// too (cd_fused_kernels.cu). The inner operators and fluxes go to a scratch
// tensor the wrapper allocates (4 slabs a field and level); each point
// re-derives the slopes and edge values it needs from them in L2. The
// polar caps are row sums taken by one thread each, in index order in
// double.
//
// Bound. Each function reads its input slabs once and writes its outputs
// once: ~10 (transport3d), 7 (vort_flux3d), 7 (tracer_div3d: q, crx, cry,
// mfx, mfy and va read, dqm written) slabs of jm*im values per level; at
// 144x96x26 f32 that is a few MB per call, a few microseconds at 3.35 TB/s.
// The stencil arithmetic (a few hundred flops a point) is far from the
// card's peak too. The row kernels stay above the bytes bound by the
// re-derived slopes and, at f19, by a launch's fixed cost.
#include "tp_core.cuh"

#include <stdint.h>

namespace {

using namespace tpc;

// phase 1 of NF fields on a (jm, km, nf) grid: adx and ady of row j of
// slab row_slab() of each field qf (nf, km, jm, im), with the level's
// winds; field f's adx into scratch slab 2f, its ady into 2f + 1 (each
// (nf, km, jm, im)).
// In float32, 32 blocks an SM (32 registers, as K3's inner kernel): left
// to itself ptxas takes 37-39, which cost tracer_div3d's call 5% at f05
// (tools/stencil_ab.py)
template <int NF, typename T>
__global__ void __launch_bounds__(kRowThreads, sizeof(T) == 4 ? 32 : 1)
row_inner_kernel(const T* __restrict__ q0, const T* __restrict__ q1,
                 const T* __restrict__ crx, const T* __restrict__ va,
                 const uint8_t* __restrict__ ffsl,
                 const T* __restrict__ cosp, int band, int K, int jm,
                 int im, T* __restrict__ scratch) {
  const int j = blockIdx.x, k = blockIdx.y;
  const size_t n = (size_t)jm * im, fo = row_slab() * n,
               ns = (size_t)gridDim.z * gridDim.y * n;
  const T* q[2] = {q0 + fo, NF > 1 ? q1 + fo : nullptr};
  T* const sx[2] = {scratch + fo, scratch + 2 * ns + fo};
  T* const sy[2] = {scratch + ns + fo, scratch + 3 * ns + fo};
  tp_row_inner<NF>(q, crx + k * n, va + k * n,
                   ffsl_row(ffsl + (size_t)k * jm, j, jm, band), cosp[j], K,
                   j, jm, im, sx, sy);
}

// scratch slabs (each (km, jm, im)): 0 adx(delp), then pt's fx; 1
// ady(delp), then pt's fy; 2 adx(pt); 3 ady(pt)
template <typename T>
int launch_transport(const T* delp, const T* pt, const T* crx, const T* cry,
                     const T* yfx, const T* va, const uint8_t* ffsl,
                     const T* cosp, const T* acosp, double rcap, int iord,
                     int jord, int band, int K, int km, int jm, int im,
                     T* ddp, T* dpt, T* mfx, T* mfy, T* scratch,
                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 rows(jm, km);
  const size_t ns = (size_t)km * jm * im;
  T *s0 = scratch, *s1 = scratch + ns, *s2 = scratch + 2 * ns,
    *s3 = scratch + 3 * ns;
  row_inner_kernel<2, T><<<rows, kRowThreads, 0, st>>>(
      delp, pt, crx, va, ffsl, cosp, band, K, jm, im, scratch);
  tp_flux_kernel<T, 0><<<rows, kRowThreads, 0, st>>>(
      s0, s1, crx, cry, crx, yfx, ffsl, cosp, iord, jord, band, K, jm, im,
      mfx, mfy);
  tp_q_flux_kernel<T><<<rows, kRowThreads, 0, st>>>(
      s2, s3, crx, cry, mfx, mfy, ffsl, cosp, acosp, rcap, iord, jord, band,
      K, jm, im, ddp, s0, s1);
  tp_div_kernel<T><<<rows, kRowThreads, 0, st>>>(s0, s1, acosp, rcap, jm, im,
                                                  dpt);
  return (int)cudaGetLastError();
}

// fy = ytp(zeta)·vedt, fx = xtp(zeta)·udt: phase 2 on the vorticity
template <typename T>
int launch_vort(const T* zeta, const T* crx, const T* cry, const T* udt,
                const T* vedt, const uint8_t* ffsl, const T* cosp, int iord,
                int jord, int band, int K, int km, int jm, int im, T* fx,
                T* fy, void* stream) {
  tp_flux_kernel<T, 1><<<dim3(jm, km), kRowThreads, 0,
                         (cudaStream_t)stream>>>(
      zeta, zeta, crx, cry, udt, vedt, ffsl, cosp, iord, jord, band, K, jm,
      im, fx, fy);
  return (int)cudaGetLastError();
}

// scratch slabs (each (nq*km, jm, im)): 0 adx(q), 1 ady(q), 2 fx, 3 fy
template <typename T>
int launch_tracer(const T* q, const T* crx, const T* cry, const T* mfx,
                  const T* mfy, const T* va, const uint8_t* ffsl,
                  const T* cosp, const T* acosp, double rcap, int iord,
                  int jord, int band, int K, int nq, int km, int jm, int im,
                  T* dqm, T* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 rows(jm, km, nq);
  const size_t ns = (size_t)nq * km * jm * im;
  row_inner_kernel<1, T><<<rows, kRowThreads, 0, st>>>(
      q, nullptr, crx, va, ffsl, cosp, band, K, jm, im, scratch);
  tp_flux_kernel<T, 1><<<rows, kRowThreads, 0, st>>>(
      scratch, scratch + ns, crx, cry, mfx, mfy, ffsl, cosp, iord, jord, band,
      K, jm, im, scratch + 2 * ns, scratch + 3 * ns);
  tp_div_kernel<T><<<rows, kRowThreads, 0, st>>>(
      scratch + 2 * ns, scratch + 3 * ns, acosp, rcap, jm, im, dqm);
  return (int)cudaGetLastError();
}

}  // namespace

#define CAM_STENCIL_ENTRY(SUF, T)                                             \
  extern "C" int cam_transport3d_##SUF(                                       \
      const T* delp, const T* pt, const T* crx, const T* cry, const T* yfx,   \
      const T* va, const uint8_t* ffsl, const T* cosp, const T* acosp,        \
      double rcap, int iord, int jord, int band, int K, int km, int jm,       \
      int im, T* ddp, T* dpt, T* mfx, T* mfy, T* scratch, void* stream) {     \
    return launch_transport<T>(delp, pt, crx, cry, yfx, va, ffsl, cosp,       \
                               acosp, rcap, iord, jord, band, K, km, jm, im,  \
                               ddp, dpt, mfx, mfy, scratch, stream);          \
  }                                                                           \
  extern "C" int cam_vort_flux3d_##SUF(                                       \
      const T* zeta, const T* crx, const T* cry, const T* udt,                \
      const T* vedt, const uint8_t* ffsl, const T* cosp, int iord, int jord,  \
      int band, int K, int km, int jm, int im, T* fx, T* fy, void* stream) {  \
    return launch_vort<T>(zeta, crx, cry, udt, vedt, ffsl, cosp, iord, jord,  \
                          band, K, km, jm, im, fx, fy, stream);               \
  }                                                                           \
  extern "C" int cam_tracer_div3d_##SUF(                                      \
      const T* q, const T* crx, const T* cry, const T* mfx, const T* mfy,     \
      const T* va, const uint8_t* ffsl, const T* cosp, const T* acosp,        \
      double rcap, int iord, int jord, int band, int K, int nq, int km,       \
      int jm, int im, T* dqm, T* scratch, void* stream) {                     \
    return launch_tracer<T>(q, crx, cry, mfx, mfy, va, ffsl, cosp, acosp,     \
                            rcap, iord, jord, band, K, nq, km, jm, im, dqm,   \
                            scratch, stream);                                 \
  }

CAM_STENCIL_ENTRY(f32, float)
CAM_STENCIL_ENTRY(f64, double)
