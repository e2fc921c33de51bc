// Hopper kernels for the FV dycore's horizontal transport stencils.
//
// Replace the Pallas TPU kernels of cam_nor_physics_tpu/ops/pallas_kernels.py:
//   transport_kernel <- _transport_kernel (transport3d): tp2c of delp plus the
//                       mass-consistent tp2d of pt, polar caps closed
//   vort_kernel      <- _vort_kernel (vort_flux3d): ytp/xtp fluxes of the
//                       absolute vorticity
//   tracer_*_kernel  <- _tracer_kernel (tracer_div3d): trac2d's tracer-mass
//                       flux divergence, polar caps closed
//
// Design. The TPU kernels run one grid step per level with the whole (jm, im)
// slab in VMEM. Here transport_kernel and vort_kernel, which only the unfused
// "matmul" step runs, give one thread block a level: transport_kernel walks
// the slab in phases separated by __syncthreads() (tp_core.cuh's
// transport_level), the inner advective operators (adx, ady) going to a
// per-level scratch slab that the wrapper allocates, then the y- and
// x-fluxes point by point from it (each thread recomputes the slopes and
// edge values its point needs, see tp_core.cuh), then the flux divergence.
// tracer_div3d, on the main path, runs over all SMs: three row kernels on a
// (jm, nq*km) grid, one block of kRowThreads threads per (row, tracer,
// level), through tp_core.cuh's row form (adx/ady; the fluxes; the cap and
// the divergence), the launch boundaries its phase boundaries. The polar
// caps are row sums taken by one thread each, in index order in double.
//
// Bound. Each kernel reads its input slabs once and writes its outputs once:
// ~10 (transport), 7 (vort), 7 (tracer: q, crx, cry, mfx, mfy and va read,
// dqm written) slabs of jm*im values per level; at 144x96x26 f32
// that is a few MB per call, a few microseconds at 3.35 TB/s. The stencil
// arithmetic (a few hundred flops a point) is far from the card's peak too.
// The one-block-per-level kernels are latency-bound (km of the 132 SMs
// busy); the tracer's row kernels re-derive each point's slopes from the
// scratch slabs in L2.
#include "tp_core.cuh"

#include <stdint.h>

namespace {

using namespace tpc;

constexpr int kThreads = 512;      // transport, vort: one block a level

template <typename T>
__global__ void __launch_bounds__(kThreads)
transport_kernel(const T* __restrict__ delp, const T* __restrict__ pt,
                 const T* __restrict__ crx, const T* __restrict__ cry,
                 const T* __restrict__ yfx, const T* __restrict__ va,
                 const uint8_t* __restrict__ ffsl, const T* __restrict__ cosp,
                 const T* __restrict__ acosp, double rcap, int iord, int jord,
                 int band, int K, int jm, int im, T* __restrict__ ddp,
                 T* __restrict__ dpt, T* __restrict__ mfx,
                 T* __restrict__ mfy, T* __restrict__ scratch) {
  const int k = blockIdx.x;
  const int km = gridDim.x;
  const int n = jm * im;
  const size_t off = (size_t)k * n;
  const T *dl = delp + off, *p = pt + off, *cx = crx + off, *cy = cry + off,
          *yf = yfx + off, *v = va + off;
  const uint8_t* fl = ffsl + (size_t)k * jm;
  T *o_ddp = ddp + off, *o_dpt = dpt + off, *o_mfx = mfx + off,
    *o_mfy = mfy + off;
  transport_level(dl, p, cx, cy, yf, v, fl, cosp, acosp, rcap, iord, jord,
                  band, K, jm, im, o_ddp, o_dpt, o_mfx, o_mfy,
                  scratch + ((size_t)0 * km + k) * n,
                  scratch + ((size_t)1 * km + k) * n,
                  scratch + ((size_t)2 * km + k) * n,
                  scratch + ((size_t)3 * km + k) * n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
vort_kernel(const T* __restrict__ zeta, const T* __restrict__ crx,
            const T* __restrict__ cry, const T* __restrict__ udt,
            const T* __restrict__ vedt, const uint8_t* __restrict__ ffsl,
            const T* __restrict__ cosp, int iord, int jord, int band, int K,
            int jm, int im, T* __restrict__ fx, T* __restrict__ fy) {
  const int k = blockIdx.x;
  const int n = jm * im;
  const size_t off = (size_t)k * n;
  const T *z = zeta + off, *cx = crx + off, *cy = cry + off, *ud = udt + off,
          *vd = vedt + off;
  const uint8_t* fl = ffsl + (size_t)k * jm;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / im, i = idx - j * im;
    const bool f = ffsl_row(fl, j, jm, band);
    fy[off + idx] = ytp_point(z, cy, vd, j, i, jm, im, jord);
    fx[off + idx] = xtp_point(z + j * im, cx + j * im, ud + j * im, i, im,
                              cosp[j], f, iord, 1, K);
  }
}

// tracer_div3d: three row kernels on a (jm, nq*km) grid, blockIdx.y =
// tracer * km + level. Scratch slabs of each (tracer, level): 0 adx(q),
// 1 ady(q), 2 fy, 3 fx.
struct TracerRow {
  int j, b, k;         // row, (tracer, level), level
  size_t n;            // points of a level slab
  __device__ TracerRow(int km, int jm, int im)
      : j(blockIdx.x), b(blockIdx.y), k(blockIdx.y % km),
        n((size_t)jm * im) {}
  template <typename T>
  __device__ T* slab(T* scratch, int s) const {   // scratch slab s
    return scratch + ((size_t)s * gridDim.y + b) * n;
  }
};

// phase 1: adx and ady of the row
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
tracer_inner_kernel(const T* __restrict__ q, const T* __restrict__ crx,
                    const T* __restrict__ va,
                    const uint8_t* __restrict__ ffsl,
                    const T* __restrict__ cosp, int band, int K, int km,
                    int jm, int im, T* __restrict__ scratch) {
  const TracerRow r(km, jm, im);
  const T* qr = q + r.b * r.n;
  T *sx = r.slab(scratch, 0), *sy = r.slab(scratch, 1);
  tp_row_inner<1>(&qr, crx + r.k * r.n, va + r.k * r.n,
                  ffsl_row(ffsl + (size_t)r.k * jm, r.j, jm, band),
                  cosp[r.j], K, r.j, jm, im, &sx, &sy);
}

// phase 2: the row's fluxes fy = ytp(adx)·mfy and fx = xtp(ady)·mfx
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
tracer_flux_kernel(const T* __restrict__ crx, const T* __restrict__ cry,
                   const T* __restrict__ mfx, const T* __restrict__ mfy,
                   const uint8_t* __restrict__ ffsl,
                   const T* __restrict__ cosp, int iord, int jord, int band,
                   int K, int km, int jm, int im, T* __restrict__ scratch) {
  const TracerRow r(km, jm, im);
  const size_t off = r.k * r.n;
  tp_row_fluxes(r.slab(scratch, 0), r.slab(scratch, 1), crx + off,
                cry + off, mfx + off, mfy + off, 1,
                ffsl_row(ffsl + (size_t)r.k * jm, r.j, jm, band), cosp[r.j],
                iord, jord, K, r.j, jm, im, r.slab(scratch, 3),
                r.slab(scratch, 2));
}

// phase 3: the row's cap of fy, then the flux divergence
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
tracer_div_kernel(const T* __restrict__ acosp, double rcap, int km, int jm,
                  int im, T* __restrict__ dqm, T* __restrict__ scratch) {
  const TracerRow r(km, jm, im);
  const T* fy = r.slab(scratch, 2);
  const T cap = row_cap(fy, r.j, jm, im, rcap);
  tp_row_div(r.slab(scratch, 3), fy, acosp[r.j], cap, r.j, jm, im,
             dqm + r.b * r.n);
}

template <typename T>
int launch_transport(const T* delp, const T* pt, const T* crx, const T* cry,
                     const T* yfx, const T* va, const uint8_t* ffsl,
                     const T* cosp, const T* acosp, double rcap, int iord,
                     int jord, int band, int K, int km, int jm, int im,
                     T* ddp, T* dpt, T* mfx, T* mfy, T* scratch,
                     void* stream) {
  transport_kernel<T><<<km, kThreads, 0, (cudaStream_t)stream>>>(
      delp, pt, crx, cry, yfx, va, ffsl, cosp, acosp, rcap, iord, jord,
      band, K, jm, im, ddp, dpt, mfx, mfy, scratch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vort(const T* zeta, const T* crx, const T* cry, const T* udt,
                const T* vedt, const uint8_t* ffsl, const T* cosp, int iord,
                int jord, int band, int K, int km, int jm, int im, T* fx,
                T* fy, void* stream) {
  vort_kernel<T><<<km, kThreads, 0, (cudaStream_t)stream>>>(
      zeta, crx, cry, udt, vedt, ffsl, cosp, iord, jord, band, K, jm, im, fx,
      fy);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tracer(const T* q, const T* crx, const T* cry, const T* mfx,
                  const T* mfy, const T* va, const uint8_t* ffsl,
                  const T* cosp, const T* acosp, double rcap, int iord,
                  int jord, int band, int K, int nq, int km, int jm, int im,
                  T* dqm, T* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 rows(jm, nq * km);
  tracer_inner_kernel<T><<<rows, kRowThreads, 0, st>>>(
      q, crx, va, ffsl, cosp, band, K, km, jm, im, scratch);
  tracer_flux_kernel<T><<<rows, kRowThreads, 0, st>>>(
      crx, cry, mfx, mfy, ffsl, cosp, iord, jord, band, K, km, jm, im,
      scratch);
  tracer_div_kernel<T><<<rows, kRowThreads, 0, st>>>(acosp, rcap, km, jm, im,
                                                      dqm, scratch);
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
