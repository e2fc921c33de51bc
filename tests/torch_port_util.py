"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The port's tests feed the same numpy inputs, made from a seeded
np.random.default_rng, to a JAX function and to its twin in
cam_nor_physics_tpu_torch, on the CPU in float64, and compare the outputs
with a tolerance relative to each output's largest magnitude.
"""

import fcntl
import hashlib
import importlib
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# the op-by-op JAX references that one test computes for all three files:
# mode -> (test module, its function returning the numpy inputs, the
# reference processes that compute it: tests/torch_port_microp_ref.py's
# modes, merged)
SHARED_REFERENCES = {"zm": ("test_torch_zm_microp", "_cases",
                            ("zm", "zm_tend")),
                     "aero": ("test_torch_aerosol", "_cases", ("aero",)),
                     "scam": ("test_torch_modes", "scam_cases",
                              ("scam_run", "scam_iop"))}


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


def reference_processes(root, script, jobs, port, port_cases,
                        timeout=1500):
    """Each job (mode, cases) of tests/`script` in a fresh interpreter of
    its own (root/job<i>/in.pkl in, out.pkl out), all started at once;
    port(port_cases) runs here meanwhile. Returns (port's result, the
    jobs' results in order)."""
    tests = Path(__file__).resolve().parent
    procs = []
    try:
        for i, (mode, cases) in enumerate(jobs):
            d = Path(root) / f"job{i}"
            d.mkdir(parents=True, exist_ok=True)
            with open(d / "in.pkl", "wb") as f:
                pickle.dump({"mode": mode, "cases": cases}, f)
            procs.append(subprocess.Popen(
                [sys.executable, str(tests / script), str(d)],
                cwd=tests.parent,
                env=dict(os.environ, PYTHONPATH=str(tests.parent)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        got = port(port_cases)
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-4000:]
        with open(Path(root) / f"job{i}" / "out.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return got, outs


def shared_jax_reference(tmp_path_factory, mode, port):
    """(port(cases), JAX's results) of `mode`, one of SHARED_REFERENCES.

    The first test of a session to ask runs every mode's JAX reference
    (tests/torch_port_microp_ref.py), in fresh interpreters all at once
    (the microphysics' and SCAM's in two each), running its own port
    side meanwhile, and
    leaves the results
    in the session's temporary directory, which xdist workers share; a
    later test, in this process or another worker, waits on the lock and
    reads them. The directory is named by a hash of every mode's
    inputs."""
    cases = {m: getattr(importlib.import_module(mod), fn)()
             for m, (mod, fn, _) in SHARED_REFERENCES.items()}
    key = hashlib.sha256(pickle.dumps(cases)).hexdigest()[:16]
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent          # the workers' common root
    root = base / f"jax_reference_{key}"
    root.mkdir(parents=True, exist_ok=True)
    jobs = [(m, job) for m, (_, _, js) in SHARED_REFERENCES.items()
            for job in js]
    got = None
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (root / "done").exists():
            got, outs = reference_processes(
                root, "torch_port_microp_ref.py",
                [(job, cases[m]) for m, job in jobs], port, cases[mode])
            merged = {m: {} for m in cases}
            for (m, _), out in zip(jobs, outs):
                merged[m].update(out)
            for m, out in merged.items():
                with open(root / f"{m}.pkl", "wb") as f:
                    pickle.dump(out, f)
            (root / "done").touch()
    if got is None:
        got = port(cases[mode])
    with open(root / f"{mode}.pkl", "rb") as f:
        return got, pickle.load(f)
