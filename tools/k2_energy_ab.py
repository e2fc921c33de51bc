#!/usr/bin/env python3
"""K2's energy on the H100: recomputed where it is read, or stored first.

    python3 tools/k2_energy_ab.py [f19 f09 f05]

K2's kick kernel (csrc/cd_fused_kernels.cu, k2_kick_kernel) needs the
energy en = phi + cp pt pkz at (j, i), (j, i-1) and (j-1, i). The library
recomputes it at each of the three; the other form stores it by a launch
of its own (a row kernel over (row, level) blocks) into a fifth scratch
slab that the kick kernel reads. This script builds both from
csrc/ (the second by a text patch of the first, in a temporary
directory), takes K2's inputs from the last call of one bench HS step at
each grid (FVConfig(), float32, polar filter on), checks that the two
give bitwise the same outputs, and times one K2 call of each (CUDA
events, 20 calls a turn) in turns: recompute, store, store, recompute,
twice. Prints the medians and the card (nvidia-smi's name and power
limit). Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from cam_nor_physics_tpu_torch.bench import GRIDS, card_label  # noqa: E402
from cam_nor_physics_tpu_torch.entry import build_step  # noqa: E402
from cam_nor_physics_tpu_torch.ops import cd_fused_kernels as ck  # noqa: E402
from cam_nor_physics_tpu_torch.ops import cuda_build  # noqa: E402
from cam_nor_physics_tpu_torch.utils.config import FVConfig  # noqa: E402

REPS = 20
ROUNDS = 2

# the stored form: a launch writes en into scratch slab 4, the kick kernel
# reads it there
PATCH = (
    ("""  auto E = [&](int jj, int ii) {
    return PHI(jj, ii) + cp * P(jj, ii) * Z(jj, ii);
  };""",
     """  const Slab<T> EN{S(4), jm, im};
  auto E = [&](int jj, int ii) { return EN(jj, ii); };"""),
    ("""template <typename T>
__global__ void __launch_bounds__(kRowThreads)
k2_kick_kernel(""",
     """template <typename T>
__global__ void __launch_bounds__(kRowThreads)
k2_energy_kernel(const T* __restrict__ pt_h, const T* __restrict__ pkz_h,
                 double cpair, int jm, int im, T* __restrict__ scratch) {
  const int j = blockIdx.x, k = blockIdx.y, km = gridDim.y;
  const int n = jm * im;
  const size_t off = (size_t)k * n;
  auto S = [&](int s) { return scratch + ((size_t)s * km + k) * n; };
  const T *phi = S(0);
  T* en = S(4);
  for (int i = threadIdx.x; i < im; i += blockDim.x) {
    const int idx = j * im + i;
    en[idx] = phi[idx] + T(cpair) * pt_h[off + idx] * pkz_h[off + idx];
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
k2_kick_kernel("""),
    ("""  k2_kick_kernel<T><<<rows, kRowThreads, 0, st>>>(""",
     """  k2_energy_kernel<T><<<rows, kRowThreads, 0, st>>>(
      pt_h, pkz_h, cs.cpair, jm, im, scratch);
  k2_kick_kernel<T><<<rows, kRowThreads, 0, st>>>("""),
)


def build_stored(tmp: Path):
    """The stored form of the cd_fused library, built in tmp."""
    for name in cuda_build.SOURCES["cd_fused_kernels"]:
        src = (cuda_build.CSRC / name).read_text()
        if name == "cd_fused_kernels.cu":
            for old, new in PATCH:
                if src.count(old) != 1:
                    raise RuntimeError(f"patch does not apply: {old[:40]!r}")
                src = src.replace(old, new)
        (tmp / name).write_text(src)
    lib = tmp / "libstored.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(lib), str(tmp / "cd_fused_kernels.cu")], check=True,
                   capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    fn = dll.cam_cd_k2_f32
    fn.argtypes = dict(cuda_build.SIGNATURES["cd_fused_kernels"])["cam_cd_k2"]
    fn.restype = ctypes.c_int
    return fn


def k2_inputs(gname: str):
    """K2's arguments in the last small step of one bench HS step."""
    im, jm, km, _ = GRIDS[gname]
    step, state, grid, coord, phis = build_step(
        im, jm, km, torch.float32, "cuda", cfg=FVConfig())
    seen = []
    real = ck.k2

    def rec(*a):
        seen.append(a)
        return real(*a)

    # the wrapper adds its launches to its module's name for it
    rec.launches = 0
    ck.k2 = rec
    try:
        step(state, grid, coord, phis)
    finally:
        ck.k2 = real
    torch.cuda.synchronize()
    return seen[-1]


def run(fn, scratch, a):
    """One K2 call through the C entry fn with `scratch` slabs."""
    saved = ck._SCRATCH["k2"]
    ck._SCRATCH["k2"] = scratch
    try:
        return ck._run_k2(fn, torch.cuda.current_stream().cuda_stream, *a)
    finally:
        ck._SCRATCH["k2"] = saved


def time_ms(fn, scratch, a) -> float:
    for _ in range(2):
        run(fn, scratch, a)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(REPS):
        run(fn, scratch, a)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def main(grids) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = card_label()
    recompute = cuda_build.library("cd_fused_kernels").cam_cd_k2_f32
    forms = {"recompute": (recompute, ck._SCRATCH["k2"])}
    with tempfile.TemporaryDirectory() as tmp:
        forms["store"] = (build_stored(Path(tmp)), ck._SCRATCH["k2"] + 1)
        for gname in grids:
            a = k2_inputs(gname)
            outs = {f: run(fn, ns, a) for f, (fn, ns) in forms.items()}
            same = all(torch.equal(x, y) for x, y in
                       zip(outs["recompute"], outs["store"]))
            if not same:
                raise RuntimeError(f"{gname}: the two forms differ")
            turns = {f: [] for f in forms}
            for _ in range(ROUNDS):
                for f in ("recompute", "store", "store", "recompute"):
                    turns[f].append(time_ms(*forms[f], a))
            med = {f: float(np.median(t)) for f, t in turns.items()}
            print(f"k2 {gname} {tuple(a[0].shape)} float32, filter on: "
                  + "; ".join(f"{f} {med[f]:.4f} ms (turns "
                              + ", ".join(f"{t:.4f}" for t in turns[f])
                              + ")" for f in forms)
                  + f"; outputs bitwise equal: {same} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["f19", "f09", "f05"]))
