// Hopper kernels for the FV dycore's horizontal transport stencils.
//
// Replace the Pallas TPU kernels of cam_nor_physics_tpu/ops/pallas_kernels.py:
//   transport_kernel <- _transport_kernel (transport3d): tp2c of delp plus the
//                       mass-consistent tp2d of pt, polar caps closed
//   vort_kernel      <- _vort_kernel (vort_flux3d): ytp/xtp fluxes of the
//                       absolute vorticity
//   tracer_kernel    <- _tracer_kernel (tracer_div3d): trac2d's tracer-mass
//                       flux divergence, polar caps closed
//
// Design. The TPU kernels run one grid step per level with the whole (jm, im)
// slab in VMEM. Here one thread block owns one level (one (tracer, level) for
// the tracer kernel) and walks the slab in phases separated by
// __syncthreads(): the inner advective operators (adx, ady) are written to a
// per-level scratch slab that the wrapper allocates, then the y- and x-fluxes
// are evaluated point by point from it (each thread recomputes the slopes and
// edge values its point needs, see tp_core.cuh), then the flux divergence.
// The polar caps are row sums taken by one thread each. Scratch and fields of
// one level are a few hundred KB, so the phases read them back from L2.
//
// Bound. Each kernel reads its input slabs once and writes its outputs once:
// ~10 (transport), 7 (vort), 6 (tracer) slabs of jm*im values per level; at
// 144x96x26 f32 that is a few MB per call, a few microseconds at 3.35 TB/s.
// The stencil arithmetic (a few hundred flops a point) is far from the card's
// peak too. This first version is latency-bound: one block per level keeps
// only km of the 132 SMs busy, and the phases serialize on L2 round trips.
// Making it fast (row bands with halos, shared-memory slabs) is later work.
#include "tp_core.cuh"

#include <stdint.h>

namespace {

using namespace tpc;

constexpr int kThreads = 512;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
tracer_kernel(const T* __restrict__ q, const T* __restrict__ crx,
              const T* __restrict__ cry, const T* __restrict__ mfx,
              const T* __restrict__ mfy, const T* __restrict__ va,
              const uint8_t* __restrict__ ffsl, const T* __restrict__ cosp,
              const T* __restrict__ acosp, double rcap, int iord, int jord,
              int band, int K, int km, int jm, int im, T* __restrict__ dqm,
              T* __restrict__ scratch) {
  const int b = blockIdx.x;          // tracer * km + level
  const int k = b % km;
  const int n = jm * im;
  const size_t off = (size_t)k * n;
  const T* qk = q + (size_t)b * n;
  const T *cx = crx + off, *cy = cry + off, *fxm = mfx + off,
          *fym = mfy + off, *v = va + off;
  const uint8_t* fl = ffsl + (size_t)k * jm;
  const size_t nb = gridDim.x;
  T* s0 = scratch + ((size_t)0 * nb + b) * n;   // adx
  T* s1 = scratch + ((size_t)1 * nb + b) * n;   // ady
  T* s2 = scratch + ((size_t)2 * nb + b) * n;   // fy
  T* s3 = scratch + ((size_t)3 * nb + b) * n;   // fx
  __shared__ T caps[2];

  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / im, i = idx - j * im;
    s0[idx] = adx_point(qk, cx, j, i, jm, im, cosp[j],
                        ffsl_row(fl, j, jm, band), K);
    s1[idx] = ady_point(qk, v, j, i, jm, im);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / im, i = idx - j * im;
    s2[idx] = ytp_point(s0, cy, fym, j, i, jm, im, jord);
    s3[idx] = xtp_point(s1 + j * im, cx + j * im, fxm + j * im, i, im,
                        cosp[j], ffsl_row(fl, j, jm, band), iord, 1, K);
  }
  __syncthreads();
  if (threadIdx.x == 0) caps[0] = (T)(-row_sum(s2 + im, im) * rcap);
  if (second_lane()) caps[1] = (T)(row_sum(s2 + (jm - 1) * im, im) * rcap);
  __syncthreads();
  T* out = dqm + (size_t)b * n;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / im, i = idx - j * im;
    out[idx] = div_point(s3, s2, j, i, jm, im, acosp[j], caps[0], caps[1]);
  }
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
  tracer_kernel<T><<<nq * km, kThreads, 0, (cudaStream_t)stream>>>(
      q, crx, cry, mfx, mfy, va, ffsl, cosp, acosp, rcap, iord, jord, band,
      K, km, jm, im, dqm, scratch);
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
