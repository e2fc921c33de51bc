#!/usr/bin/env python3
"""te_map_remap and zm_tail on the H100: an older checkout's kernels
against this one's, in turns, on the same inputs.

    python3 tools/tail_remap_ab.py PARENT_DIR [f19 f09 f05]

PARENT_DIR is a checkout of the repo (e.g. `git archive` of the parent
commit unpacked into a git-ignored directory). Its
cam_nor_physics_tpu_torch/csrc/remap_kernels.cu and zm_tail_kernels.cu
are built with this checkout's nvcc flags (ops/cuda_build.py) in a
temporary directory; their C entries take the same arguments as this
checkout's, so both are called through this checkout's launch functions
(`remap_kernels._run`, `zm_tail_kernels._run`). At each grid, float32:

- te_map_remap on the arguments of its call in one bench HS step
  (build_step with FVConfig(), the bench's initial state);
- zm_tail on the arguments of its call in one zm_conv_tend on
  entry.varied_zm_inputs at the grid's columns and levels (im jm x km),
  captured through the plain tail.

Each kernel's outputs are compared with its plain version (max abs error,
and max error relative to each output's max), then the two builds are
timed in turns, parent, change, change, parent, twice (CUDA events, REPS
calls a turn); the medians are printed with the card (nvidia-smi's name
and power limit). Needs one CUDA card and nvcc.
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

from cam_nor_physics_tpu_torch.models.fv import dyn_comp  # noqa: E402
from cam_nor_physics_tpu_torch.models.physics import \
    zm_conv_intr as intr  # noqa: E402
from cam_nor_physics_tpu_torch.bench import GRIDS, card_label  # noqa: E402
from cam_nor_physics_tpu_torch.entry import (build_step,  # noqa: E402
                                             varied_zm_inputs)
from cam_nor_physics_tpu_torch.models.physics.constituents import \
    default_registry  # noqa: E402
from cam_nor_physics_tpu_torch.ops import cuda_build  # noqa: E402
from cam_nor_physics_tpu_torch.ops import remap_kernels as rk  # noqa: E402
from cam_nor_physics_tpu_torch.ops import zm_tail_kernels as tk  # noqa: E402
from cam_nor_physics_tpu_torch.utils.config import (FVConfig,  # noqa: E402
                                                    ZMConfig)

DEVICE = "cuda"
ROUNDS = 2
REPS = {"f19": 50, "f09": 20, "f05": 10}
# library, its C entry (float32), the launch function, the plain version
KERNELS = {
    "te_map_remap": ("remap_kernels", "cam_te_map_remap_f32", rk._run,
                     rk.te_map_remap_ref),
    "zm_tail": ("zm_tail_kernels", "cam_zm_tail_f32", tk._run,
                tk.zm_tail_ref),
}


def entry(dll, lib, fname):
    fn = getattr(dll, fname)
    fn.argtypes = dict(cuda_build.SIGNATURES[lib])[fname[:-4]]
    fn.restype = ctypes.c_int
    return fn


def build_parent(parent: Path, tmp: Path) -> dict:
    """{kernel: C entry} of the parent checkout's sources, built in tmp."""
    csrc = parent / "cam_nor_physics_tpu_torch" / "csrc"
    procs = {}
    for name, (lib, fname, _, _) in KERNELS.items():
        out = tmp / f"lib{lib}_parent.so"
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
             str(csrc / cuda_build.SOURCES[lib][0])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out, lib, fname)
    fns = {}
    for name, (proc, out, lib, fname) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {lib}:\n{log}")
        fns[name] = entry(ctypes.CDLL(str(out)), lib, fname)
    return fns


def te_map_inputs(gname: str):
    """te_map_remap's (args, kwargs) in one bench HS step."""
    im, jm, km, _ = GRIDS[gname]
    step, state, grid, coord, phis = build_step(
        im, jm, km, torch.float32, DEVICE, cfg=FVConfig())
    seen = []
    real = dyn_comp.te_map_remap

    def rec(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)

    dyn_comp.te_map_remap = rec
    try:
        step(state, grid, coord, phis)
    finally:
        dyn_comp.te_map_remap = real
    torch.cuda.synchronize()
    a, kw = seen[-1]
    # the launch function takes the stacked center fields
    return (*a[:6], torch.stack(list(a[6])), *a[7:]), kw


def zm_tail_inputs(gname: str):
    """zm_tail's (args, kwargs) in one zm_conv_tend on varied_zm_inputs,
    through the plain tail."""
    im, jm, km, _ = GRIDS[gname]
    pstate, pbuf, forcing = varied_zm_inputs(im * jm, km, torch.float32,
                                             DEVICE)
    seen = []
    real = intr.zm_tail

    def rec(*a, **kw):
        seen.append((a, kw))
        return tk.zm_tail_ref(*a, **kw)

    intr.zm_tail = rec
    try:
        intr.zm_conv_tend(ZMConfig(), default_registry(), pstate, pbuf,
                          forcing["pblh"], forcing["tpert"],
                          forcing["landfrac"], 1800.0)
    finally:
        intr.zm_tail = real
    torch.cuda.synchronize()
    return seen[-1]


def flat(out, path=""):
    """{path: tensor} of a nest of dicts, tuples and lists."""
    items = (out.items() if isinstance(out, dict) else enumerate(out))
    res = {}
    for k, x in items:
        if isinstance(x, (tuple, list, dict)):
            res.update(flat(x, f"{path}/{k}"))
        else:
            res[f"{path}/{k}"] = x
    return res


def plain_args(name, a):
    """The plain version's arguments from the launch function's."""
    if name == "te_map_remap":
        return (*a[:6], list(a[6].unbind(0)), *a[7:])
    return a


def errors(got, want):
    abs_err, rel = 0.0, 0.0
    got, want = flat(got), flat(want)
    if set(got) != set(want):
        raise RuntimeError(f"outputs differ: {set(got) ^ set(want)}")
    for k, w in want.items():
        g = got[k]
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError("non-finite output")
        d = float((g.double() - w.double()).abs().max())
        abs_err = max(abs_err, d)
        rel = max(rel, d / max(float(w.double().abs().max()), 1e-30))
    return abs_err, rel


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
    change = {name: entry(cuda_build.library(lib), lib, fname)
              for name, (lib, fname, _, _) in KERNELS.items()}
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"parent": build_parent(parent, Path(tmp)),
                  "change": change}
        for gname in grids:
            for name, (_, _, run, ref) in KERNELS.items():
                a, kw = (te_map_inputs if name == "te_map_remap"
                         else zm_tail_inputs)(gname)
                want = ref(*plain_args(name, a), **kw)
                calls = {b: (lambda fn=fns[name]: run(fn, stream, *a, **kw))
                         for b, fns in builds.items()}
                errs = {b: errors(c(), want) for b, c in calls.items()}
                turns = {b: [] for b in calls}
                for _ in range(ROUNDS):
                    for b in ("parent", "change", "change", "parent"):
                        turns[b].append(time_ms(calls[b], REPS[gname]))
                med = {b: float(np.median(t)) for b, t in turns.items()}
                print(f"{name} {gname} float32: "
                      + "; ".join(
                          f"{b} {med[b]:.4f} ms (turns "
                          + ", ".join(f"{t:.4f}" for t in turns[b])
                          + f"; max_abs_err {errs[b][0]:.3e}, rel "
                          f"{errs[b][1]:.3e})" for b in calls)
                      + f"; parent/change {med['parent'] / med['change']:.2f}"
                      f" [{card}]", flush=True)
                del a, kw, want, calls
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
