#!/usr/bin/env python3
"""The port's HS-step kernels on the H100: an older checkout's builds
against this one's, in turns on the same inputs; and vort_flux3d as a
shared-memory row tile.

    python3 tools/stencil_ab.py PARENT_DIR [f19 f09 f05]

PARENT_DIR is a checkout of the repo (e.g. `git archive` of the parent
commit unpacked into a git-ignored directory). Builds, each with this
checkout's nvcc flags (ops/cuda_build.py):

- "parent": PARENT_DIR's stencil_kernels, cd_fused_kernels and
  remap_kernels (cam_nor_physics_tpu_torch/csrc/);
- "change": this checkout's (the libraries the port loads);
- "tile": this checkout's stencil_kernels with vort_flux3d's launch
  replaced, by a text patch, by a kernel that first stages the rows of the
  vorticity its block reads (rows j-3..j+2, all of im) in static shared
  memory (im up to TILE_MAX_IM) and evaluates the same point functions
  from there.

Their C entries take the same arguments, so each build is called through
this checkout's wrappers with the build swapped into cuda_build's loaded
libraries. At each grid, float32, on the arguments of the last calls in
one HS step (build_step with FVConfig(), the bench's initial state):
transport3d at iord 1 and 4 and vort_flux3d of the unfused step
(filter_impl="matmul"), K1-K4, tracer_div3d and te_map_remap of the fused
one. Each build's outputs are compared with the plain version (max abs
error); the builds are timed in turns, parent, change[, tile, tile],
change, parent, twice (CUDA events, REPS calls a turn, the wrapper's host
path included), and each build's device time a call is read under
torch.profiler, split by the kernels it launches. At f19 the whole
unfused HS step runs under torch.profiler with each build in turns
(parent, change, change, parent), and its device busy time (the kernels'
summed durations) is printed. Every line carries the card (nvidia-smi's
name and power limit). Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from cam_nor_physics_tpu_torch.bench import GRIDS, card_label  # noqa: E402
from cam_nor_physics_tpu_torch.entry import build_step  # noqa: E402
from cam_nor_physics_tpu_torch.models.fv import cd_core  # noqa: E402
from cam_nor_physics_tpu_torch.models.fv import dyn_comp  # noqa: E402
from cam_nor_physics_tpu_torch.ops import cd_fused_kernels as ck  # noqa: E402
from cam_nor_physics_tpu_torch.ops import cuda_build  # noqa: E402
from cam_nor_physics_tpu_torch.ops import remap_kernels as rk  # noqa: E402
from cam_nor_physics_tpu_torch.ops import stencil_kernels as sk  # noqa: E402
from cam_nor_physics_tpu_torch.utils.config import FVConfig  # noqa: E402

DEVICE = "cuda"
LIBS = ("stencil_kernels", "cd_fused_kernels", "remap_kernels")
ROUNDS = 2
REPS = {"f19": 50, "f09": 20, "f05": 10}
PROFILE_REPS = 5
TILE_MAX_IM = 768
# each kernel: its module (the wrapper, its plain version `<name>_ref`),
# the module whose attribute the HS step calls, and the step it runs in
KERNELS = {"transport3d": (sk, cd_core, "matmul"),
           "vort_flux3d": (sk, cd_core, "matmul"),
           "tracer_div3d": (sk, dyn_comp, "fft"),
           "te_map_remap": (rk, dyn_comp, "fft"),
           **{k: (ck, ck, "fft") for k in ("k1", "k2", "k3", "k4")}}

# the tile form of vort_flux3d: a kernel staged through shared memory,
# launched in place of tp_flux_kernel
TILE_KERNEL = """
constexpr int kTileRows = 6;       // rows j-3..j+2
constexpr int kTileMaxIm = %d;

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
vort_tile_kernel(const T* __restrict__ zeta, const T* __restrict__ crx,
                 const T* __restrict__ cry, const T* __restrict__ udt,
                 const T* __restrict__ vedt, const uint8_t* __restrict__ ffsl,
                 const T* __restrict__ cosp, int iord, int jord, int band,
                 int K, int jm, int im, T* __restrict__ fx,
                 T* __restrict__ fy) {
  __shared__ T tile[kTileRows * kTileMaxIm];
  const int j = blockIdx.x, k = blockIdx.y;
  const size_t off = (size_t)k * jm * im;
  const int lo = j - 3 < 0 ? 0 : j - 3;
  const int hi = j + 2 > jm - 1 ? jm - 1 : j + 2;
  const T* z = zeta + off + (size_t)lo * im;
  for (int idx = threadIdx.x; idx < (hi - lo + 1) * im; idx += blockDim.x)
    tile[idx] = z[idx];
  __syncthreads();
  const T* s = tile - lo * im;     // s[r * im + i] for rows lo..hi
  tp_row_fluxes(s, s, crx + off, cry + off, udt + off, vedt + off, 1,
                ffsl_row(ffsl + (size_t)k * jm, j, jm, band), cosp[j], iord,
                jord, K, j, jm, im, fx + off, fy + off);
}

// fy = ytp(zeta)""" % TILE_MAX_IM

TILE_LAUNCH = """  if (im > kTileMaxIm) return (int)cudaErrorInvalidValue;
  vort_tile_kernel<T><<<dim3(jm, km), kRowThreads, 0,
                        (cudaStream_t)stream>>>(
      zeta, crx, cry, udt, vedt, ffsl, cosp, iord, jord, band, K, jm, im,
      fx, fy);"""


def load(lib: str, path: Path) -> ctypes.CDLL:
    """The library at path with the argtypes of lib's C entries declared."""
    dll = ctypes.CDLL(str(path))
    for stem, argtypes in cuda_build.SIGNATURES[lib]:
        for suf in ("f32", "f64"):
            fn = getattr(dll, f"{stem}_{suf}")
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return dll


def tile_source() -> str:
    """This checkout's stencil_kernels.cu with the tile kernel added before
    launch_vort's comment and launch_vort's launch (from its kernel name
    to its closing `fx, fy);`) replaced by TILE_LAUNCH."""
    src = (cuda_build.CSRC / "stencil_kernels.cu").read_text()
    head, sep, vort = src.partition("int launch_vort(")
    a = vort.find("  tp_flux_kernel<")
    b = vort.find("fx, fy);", a)
    if not sep or a < 0 or b < 0 or src.count("\n// fy = ytp(zeta)") != 1:
        raise RuntimeError("tile patch: launch_vort's launch not found")
    vort = vort[:a] + TILE_LAUNCH + vort[b + len("fx, fy);"):]
    return (head + sep + vort).replace("\n// fy = ytp(zeta)", TILE_KERNEL)


def build_others(parent: Path, tmp: Path) -> dict:
    """{"parent": {lib: dll}, "tile": {"stencil_kernels": dll}}: the parent
    checkout's libraries and this checkout's stencil_kernels with the tile
    patch, built together in tmp."""
    tile_dir = tmp / "tile"
    tile_dir.mkdir()
    for name in cuda_build.SOURCES["stencil_kernels"][1:]:
        shutil.copy(cuda_build.CSRC / name, tile_dir / name)
    (tile_dir / "stencil_kernels.cu").write_text(tile_source())
    jobs = [("tile", "stencil_kernels", tile_dir / "stencil_kernels.cu")]
    jobs += [("parent", lib, parent / "cam_nor_physics_tpu_torch" / "csrc" /
              cuda_build.SOURCES[lib][0]) for lib in LIBS]
    procs = []
    for b, lib, path in jobs:
        out = tmp / f"lib{lib}_{b}.so"
        procs.append((b, lib, out, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    builds = defaultdict(dict)
    for b, lib, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {b} {lib}:\n{log}")
        builds[b][lib] = load(lib, out)
    return dict(builds)


def use(builds: dict, b: str) -> None:
    """Point the port's wrappers at build b's libraries (this checkout's
    where b has none of its own)."""
    for lib in LIBS:
        cuda_build._loaded[lib] = builds[b].get(lib, builds["change"][lib])


def hs_step(gname: str, impl: str):
    im, jm, km, _ = GRIDS[gname]
    return build_step(im, jm, km, torch.float32, DEVICE, filter_impl=impl,
                      cfg=FVConfig())


def captured_inputs(gname: str) -> dict:
    """{label: (name, args, kwargs)} of the last call of each kernel in one
    HS step of the path that runs it (transport3d: the last at each
    order)."""
    seen = {}
    for impl in ("matmul", "fft"):
        step, state, grid, coord, phis = hs_step(gname, impl)
        names = [n for n, (_, _, i) in KERNELS.items() if i == impl]
        real = {n: getattr(KERNELS[n][1], n) for n in names}

        def rec(name):
            def f(*a, **kw):
                key = (f"{name}[iord={a[10]}]" if name == "transport3d"
                       else name)
                seen[key] = (name, a, kw)
                return real[name](*a, **kw)
            f.launches = 0
            return f

        for n in names:
            setattr(KERNELS[n][1], n, rec(n))
        try:
            step(state, grid, coord, phis)
        finally:
            for n in names:
                setattr(KERNELS[n][1], n, real[n])
        torch.cuda.synchronize()
    return seen


def flat(out):
    res = []
    for x in (out if isinstance(out, (tuple, list)) else (out,)):
        res.extend(flat(x) if isinstance(x, (tuple, list)) else [x])
    return res


def time_ms(call, reps: int) -> float:
    for _ in range(2):
        call()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        call()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_us(call, reps: int):
    """({device kernel: µs summed}, wall s) of `reps` calls under
    torch.profiler after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    return by_name, wall


def short(kernel_name: str) -> str:
    """A device kernel's name without its namespace and arguments."""
    name = kernel_name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].replace("void ", "").split("::")[-1]


def compare_grid(gname, builds, card):
    inputs = captured_inputs(gname)
    for label, (name, a, kw) in sorted(inputs.items()):
        mod = KERNELS[name][0]
        fn, ref = getattr(mod, name), getattr(mod, name + "_ref")
        want = flat(ref(*a, **kw))
        names = [b for b in builds if name == "vort_flux3d" or b != "tile"]
        errs, dev, split = {}, {}, {}
        for b in names:
            use(builds, b)
            got = flat(fn(*a, **kw))
            errs[b] = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            us, _ = device_us(lambda: fn(*a, **kw), PROFILE_REPS)
            dev[b] = sum(us.values()) / PROFILE_REPS / 1e3
            split[b] = ", ".join(
                f"{short(n)} {v / PROFILE_REPS / 1e3:.4f}"
                for n, v in sorted(us.items(), key=lambda x: -x[1]))
        turns = {b: [] for b in names}
        for _ in range(ROUNDS):
            for b in names + names[::-1]:
                use(builds, b)
                turns[b].append(time_ms(lambda: fn(*a, **kw), REPS[gname]))
        use(builds, "change")
        med = {b: float(np.median(t)) for b, t in turns.items()}
        print(f"{label} {gname} float32: "
              + "; ".join(f"{b} {med[b]:.4f} ms (turns "
                          + ", ".join(f"{t:.4f}" for t in turns[b])
                          + f"; device {dev[b]:.4f} ms; max_abs_err "
                          f"{errs[b]:.3e})" for b in names)
              + f"; parent/change {med['parent'] / med['change']:.2f} "
              f"(device {dev['parent'] / dev['change']:.3f})"
              + (f"; tile/change {med['tile'] / med['change']:.3f} (device "
                 f"{dev['tile'] / dev['change']:.3f})"
                 if "tile" in names else "")
              + f" [{card}]", flush=True)
        for b in names:
            print(f"    {b:<6} device ms a call by kernel: {split[b]}",
                  flush=True)
    del inputs
    torch.cuda.empty_cache()


def unfused_step_device(builds, card):
    """The f19 unfused HS step under torch.profiler with the parent's
    libraries and with this one's, in turns: device busy ms a step."""
    step, state, grid, coord, phis = hs_step("f19", "matmul")
    busy = {b: [] for b in ("parent", "change")}
    for b in ("parent", "change", "change", "parent"):
        use(builds, b)
        us, wall = device_us(lambda: step(state, grid, coord, phis), 1)
        busy[b].append(sum(us.values()) / 1e3)
        print(f"unfused HS step f19 ({b}): device busy {busy[b][-1]:.3f} ms"
              f", wall under the profiler {1e3 * wall:.2f} ms [{card}]",
              flush=True)
    use(builds, "change")
    print("unfused HS step f19 device busy a step: "
          + "; ".join(f"{b} " + ", ".join(f"{v:.3f}" for v in busy[b])
                      + f" ms (median {np.median(busy[b]):.3f})"
                      for b in busy) + f" [{card}]", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent, grids = Path(argv[0]).resolve(), argv[1:] or ["f19", "f09",
                                                         "f05"]
    card = card_label()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"parent": None,
                  "change": {lib: cuda_build.library(lib) for lib in LIBS}}
        builds.update(build_others(parent, Path(tmp)))
        if "f19" in grids:
            unfused_step_device(builds, card)
        for gname in grids:
            compare_grid(gname, builds, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
