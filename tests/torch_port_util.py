"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The port's tests feed the same numpy inputs, made from a seeded
np.random.default_rng, to a JAX function and to its twin in
cam_nor_physics_tpu_torch, on the CPU in float64, and compare the outputs
with a tolerance relative to each output's largest magnitude.
"""

import re

import numpy as np
import torch


def t64(a):
    """numpy -> float64 CPU tensor (bool arrays stay bool)."""
    a = np.array(a)
    return torch.from_numpy(a if a.dtype == bool else a.astype(np.float64))


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, tol, name="", scale=None):
    """|got - want| <= tol·|want| + tol·scale elementwise; `scale` defaults
    to max|want|."""
    got, want = npy(got), npy(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


def slab_fields(km, jm, im, seed, ffsl_rows=3, cmax=0.9, cmax_ffsl=2.5):
    """Random-but-smooth (km, jm, im) transport inputs with an FV-like
    latitude structure: |crx| up to `cmax_ffsl` in `ffsl_rows` rows next to
    each pole (the FFSL branch), up to `cmax` elsewhere."""
    rng = np.random.default_rng(seed)
    dp = np.pi / (jm - 1)
    lat = -0.5 * np.pi + dp * np.arange(jm)
    x = 2.0 * np.pi * np.arange(im) / im
    smooth = np.sin(x)[None, None, :] * np.cos(lat)[None, :, None]
    delp = 1.0 + 0.3 * smooth + 0.1 * rng.uniform(size=(km, jm, im))
    pt = 300.0 + 20.0 * smooth + 5.0 * rng.standard_normal((km, jm, im))
    crx = rng.uniform(-cmax, cmax, (km, jm, im))
    polar = list(range(1, 1 + ffsl_rows)) + \
        list(range(jm - 1 - ffsl_rows, jm - 1))
    crx[:, polar] = rng.uniform(-cmax_ffsl, cmax_ffsl,
                                (km, len(polar), im))
    crx[:, 0] = crx[:, -1] = 0.0
    cry = rng.uniform(-0.5, 0.5, (km, jm, im))
    cry[:, 0] = 0.0
    return dict(delp=delp, pt=pt, crx=crx, cry=cry,
                zeta=1e-4 * rng.standard_normal((km, jm, im)),
                q=rng.uniform(0.0, 1e-2, (2, km, jm, im)))


# A CUDA source of the port's csrc/ (with the headers it includes) as host
# C++: stub CUDA qualifiers; each launch runs its blocks one after another,
# each block's blockDim threads as std::threads that share the block's
# __shared__ (static) data and meet at __syncthreads() (a std::barrier);
# cp.async copies are plain copies (the sources' host branch).
_HOST_STUBS = """
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
using std::pow; using std::log; using std::log10; using std::sqrt;
using std::fabs; using std::trunc;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1)
      : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* cam_block_barrier = nullptr;
inline void __syncthreads() { cam_block_barrier->arrive_and_wait(); }
inline long cam_host_launch_count = 0;
extern "C" long cam_host_launches() { return cam_host_launch_count; }
template <typename F>
void cam_host_launch(F body, dim3 grid, dim3 block, size_t = 0,
                     cudaStream_t = nullptr) {
  ++cam_host_launch_count;
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x * block.y * block.z;
  std::barrier<> bar(nt);
  cam_block_barrier = &bar;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t % block.x, t / block.x % block.y,
                       t / (block.x * block.y));
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx = dim3(x, y, z);
            body();
            bar.arrive_and_wait();   // the block's shared data is free
          }
    });
  for (auto& th : threads) th.join();
}
"""

# a launch `name<T...><<<grid, block, ...>>>(args);`
_LAUNCH = re.compile(r"(\w+<[\w, ]+>)<<<(.*?)>>>\((.*?)\);", re.S)


def host_build(lib, tmp, n_launches):
    """Build library `lib` of cuda_build.SOURCES as host C++ (g++
    -std=c++20) in the directory `tmp`, each `<<<...>>>` launch rewritten
    to `cam_host_launch(lambda, grid, block, ...)`; the sources must hold
    `n_launches` launch sites. Returns the ctypes library with the
    argtypes of cuda_build.SIGNATURES[lib] declared and
    `cam_host_launches()`, the launches made so far. Skips without a host
    compiler."""
    import ctypes
    import shutil
    import subprocess

    import pytest

    from cam_nor_physics_tpu_torch.ops import cuda_build

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    n = 0
    for name in cuda_build.SOURCES[lib]:
        src, k = _LAUNCH.subn(r"cam_host_launch([&] { \1(\3); }, \2);",
                              (cuda_build.CSRC / name).read_text())
        (tmp / name).write_text(src)
        n += k
    assert n == n_launches, n
    (tmp / "cuda_runtime.h").write_text(_HOST_STUBS)
    out = tmp / f"lib{lib}_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-I", str(tmp), "-o", str(out),
                    "-x", "c++", str(tmp / cuda_build.SOURCES[lib][0])],
                   check=True, timeout=300)
    dll = ctypes.CDLL(str(out))
    dll.cam_host_launches.restype = ctypes.c_long
    for stem, argtypes in cuda_build.SIGNATURES[lib]:
        for suf in ("f32", "f64"):
            fn = getattr(dll, f"{stem}_{suf}")
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return dll
