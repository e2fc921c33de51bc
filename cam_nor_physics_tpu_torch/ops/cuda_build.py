"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (sm_90a) into its own
shared library with a plain C interface, loaded with `ctypes`. The build
runs at first use, one `nvcc` process per source started together, into
`build/` next to `csrc/` (git ignores it). A library's file name carries a
hash of its sources and flags, so an edited source is never served by a
stale build. Nothing here runs at import: the CPU tests import every module
on machines without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

# source files of each library (the .cu first, then the headers it includes)
SOURCES = {
    "stencil_kernels": ("stencil_kernels.cu", "tp_core.cuh"),
    "remap_kernels": ("remap_kernels.cu",),
    "zm_tail_kernels": ("zm_tail_kernels.cu",),
    "cd_fused_kernels": ("cd_fused_kernels.cu", "dft_filter.cuh",
                         "tp_core.cuh"),
    "probe_kernels": ("probe_kernels.cu",),
    "span_kernels": ("span_kernels.cu",),
}

# --fmad=false: no multiply-add contraction, so the kernels round like
# their plain PyTorch versions (which run one operation per kernel)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

# C signatures: (function stem, argtypes); each stem exists as _f32 and _f64,
# but in the libraries of UNTYPED, whose entry points take no float data
SIGNATURES = {
    "stencil_kernels": (
        ("cam_transport3d", [_P] * 9 + [_D] + [_I] * 7 + [_P] * 6),
        ("cam_vort_flux3d", [_P] * 7 + [_I] * 7 + [_P] * 3),
        ("cam_tracer_div3d", [_P] * 9 + [_D] + [_I] * 8 + [_P] * 3),
    ),
    "remap_kernels": (
        ("cam_te_map_remap", [_P] * 9 + [_I] * 5 + [_P] * 4),
    ),
    "zm_tail_kernels": (
        ("cam_zm_tail", [_P] * 19 + [_I] * 4 + [_D] * 5 + [_P] * 4),
    ),
    "cd_fused_kernels": (
        ("cam_cd_k1", [_P] * 5 + [_D] * 7 + [_I] * 5 + [_P] * 8),
        ("cam_cd_k2", [_P] * 13 + [_D] * 3 + [_I] * 4 + [_P] * 6),
        ("cam_cd_k3", [_P] * 5 + [_D] * 6 + [_I] * 7 + [_P] * 9),
        ("cam_cd_k4", [_P] * 17 + [_D] * 7 + [_I] * 11 + [_P] * 6),
    ),
    "probe_kernels": (
        ("cam_probe", [_P] * 2 + [_I] + [_P]),
    ),
    "span_kernels": (
        ("cam_span_mark", [_I, _I, _P]),
    ),
}
UNTYPED = frozenset({"span_kernels"})

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc of $CUDA_HOME, /usr/local/cuda or PATH; raises if none."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the libraries in `names` (default all) that are not built yet,
    one nvcc each, all started together. Returns {name: seconds}; raises
    RuntimeError with nvcc's output if one fails. ptxas' register and
    spill report goes to build/<name>.log."""
    names = list(SOURCES) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    times = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        (BUILD / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc={proc.returncode}):\n"
                          f"{log[-4000:]}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


_GLOBAL = re.compile(r"__global__\s+void\s+"
                     r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(\w+)\s*\(")


def kernel_names() -> frozenset:
    """The names of the device kernels that csrc/ defines (each
    `__global__` function's)."""
    return frozenset(name for f in sorted(CSRC.iterdir())
                     if f.suffix in (".cu", ".cuh")
                     for name in _GLOBAL.findall(f.read_text()))


def entry_points(name: str) -> list:
    """(C function name, argtypes) of each entry point of library
    `name`."""
    sufs = ("",) if name in UNTYPED else ("_f32", "_f64")
    return [(stem + suf, argtypes) for stem, argtypes in SIGNATURES[name]
            for suf in sufs]


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed, with the argtypes
    of its entry points declared."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fname, argtypes in entry_points(name):
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
