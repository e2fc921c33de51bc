// Hopper kernel of the bench's health check: o = 2 x on one (8, 128)
// float32 block.
//
// Replaces the Pallas TPU kernel _k of bench.py's _PALLAS_PROBE, which the
// JAX bench ran once to learn whether the TPU executes a Mosaic kernel at
// all. Here it shows that nvcc built the port's kernels from csrc/ and
// that the card launches a hand-written kernel and returns its result:
// cam_nor_physics_tpu_torch.bench runs it once before any timing and
// raises unless the output is exactly 2 x the input. Its plain PyTorch
// version is ops/probe_kernels.py::probe_ref (x * 2.0).
//
// Design. One block of kThreads threads strides over the n elements (the
// (8, 128) block is 1,024 of them), as the Pallas kernel's grid is one
// block. The product by 2 is exact in float32 and float64 (exported as
// cam_probe_f32 and cam_probe_f64, as every library of the port is), so
// kernel and plain version agree bitwise. Bound in float32: 8,192 bytes
// moved, 2.4 ns at 3.35 TB/s; the measured time is the launch latency.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const T* __restrict__ x, T* __restrict__ o, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = x[i] * T(2);
}

}  // namespace

#define CAM_PROBE_ENTRY(SUF, T)                                              \
  extern "C" int cam_probe_##SUF(const T* x, T* o, int n, void* stream) {    \
    if (n < 1) return (int)cudaErrorInvalidValue;                            \
    probe_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>(x, o, n);      \
    return (int)cudaGetLastError();                                          \
  }

CAM_PROBE_ENTRY(f32, float)
CAM_PROBE_ENTRY(f64, double)
