#!/usr/bin/env python3
"""Where zm_tail's time goes on the H100: the kernel with phases cut out.

    python3 tools/zm_tail_phases.py [f19 f09 f05]

Builds csrc/zm_tail_kernels.cu as it is and in variants made by text
patches (in a temporary directory, with ops/cuda_build.py's nvcc flags),
each variant leaving out one part of the kernel's work or sizing its
tiles otherwise:

- no_qsat:      the evaporation tiles without the Goff-Gratch saturation
                (qs = p 1e-5);
- no_evap:      the evaporation tiles without their descents;
- no_updown:    the transport tiles without their updraft and downdraft
                chains;
- no_chains:    no chain at all;
- no_outputs:   both kinds of tile without their output phase;
- smem46:       46 KB of shared memory a block and 4 blocks on an SM;
- smem23:       23 KB a block (fewer columns a tile), 6 blocks on an SM;
- smem26_min8:  26 KB a block, registers capped for 8 blocks on an SM.
The library's own build has 36 KB a block and registers capped for 6
blocks on an SM (kSmemBytes, kBlocksPerSM).

Takes zm_tail's float32 arguments from one zm_conv_tend on
entry.varied_zm_inputs at each grid's columns and levels (captured
through the plain tail), and times every variant in turns (CUDA events,
REPS calls a turn, ROUNDS rounds in order and reversed); prints the
medians and each variant's difference to the full kernel, with the card
(nvidia-smi's name and power limit), after each build's ptxas registers
and spills (float32 and float64). Only the full kernel's outputs are
right; the variants are for timing. Needs one CUDA card and nvcc.
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
sys.path.insert(0, str(REPO / "tools"))

from cam_nor_physics_tpu_torch.bench import card_label  # noqa: E402
from cam_nor_physics_tpu_torch.ops import cuda_build  # noqa: E402
from cam_nor_physics_tpu_torch.ops import zm_tail_kernels as tk  # noqa: E402
from tail_remap_ab import entry, time_ms, zm_tail_inputs  # noqa: E402

ROUNDS = 2
REPS = {"f19": 50, "f09": 20, "f05": 10}
LIB = "zm_tail_kernels"

_NO_QSAT = (("const T qs_k = qsat_blend(t_k, p.pmid[g]);",
             "const T qs_k = p.pmid[g] * T(1e-5);"),)
_NO_EVAP = (("  if (tid < nc)\n    evap_descent(",
             "  if (false)\n    evap_descent("),)
_NO_UPDOWN = (("      if (kind < nw + ng && col < nc) {",
               "      if (false) {"),)
PATCHES = {
    "full": (),
    "no_qsat": _NO_QSAT,
    "no_evap": _NO_EVAP,
    "no_updown": _NO_UPDOWN,
    "no_chains": _NO_EVAP + _NO_UPDOWN,
    "no_outputs": (
        ("  // phase 3: the outputs from the fluxes entering each level\n"
         "  for (int i = tid; i < npt; i += nth) {",
         "  // phase 3: the outputs from the fluxes entering each level\n"
         "  for (int i = tid; i < 0; i += nth) {"),
        ("    // phase 4: the outputs\n    if (first) {",
         "    // phase 4: the outputs\n    if (false) {"),
        ("    for (int j = tid; j < npt * ntr; j += nth) {\n"
         "      const int q = j / ntr, m = j - q * ntr - g0;\n"
         "      if (m < 0 || m >= ng) continue;",
         "    for (int j = tid; j < 0; j += nth) {\n"
         "      const int q = j / ntr, m = j - q * ntr - g0;\n"
         "      if (m < 0 || m >= ng) continue;")),
    "smem46": (("constexpr int kSmemBytes = 36 * 1024;",
                "constexpr int kSmemBytes = 46 * 1024;"),
               ("constexpr int kBlocksPerSM = 6;",
                "constexpr int kBlocksPerSM = 4;")),
    "smem23": (("constexpr int kSmemBytes = 36 * 1024;",
                "constexpr int kSmemBytes = 23 * 1024;"),),
    "smem26_min8": (("constexpr int kSmemBytes = 36 * 1024;",
                     "constexpr int kSmemBytes = 26 * 1024;"),
                    ("constexpr int kBlocksPerSM = 6;",
                     "constexpr int kBlocksPerSM = 8;")),
}


def build(tmp: Path) -> dict:
    """{variant: float32 C entry}, one nvcc each, all started together."""
    src = (cuda_build.CSRC / cuda_build.SOURCES[LIB][0]).read_text()
    procs = {}
    for name, patch in PATCHES.items():
        text = src
        for old, new in patch:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: patch does not apply: "
                                   f"{old[:50]!r}")
            text = text.replace(old, new)
        cu = tmp / f"{name}.cu"
        cu.write_text(text)
        out = tmp / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out)
    fns = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        fns[name] = entry(ctypes.CDLL(str(out)), LIB, "cam_zm_tail_f32")
        print(f"ptxas {name}: " + " | ".join(
            ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
    return fns


def main(grids) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = card_label()
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(Path(tmp))
        for gname in grids:
            a, kw = zm_tail_inputs(gname)
            order = list(fns)
            for n in order:              # one checked call of each first
                tk._run(fns[n], stream, *a, **kw)
                torch.cuda.synchronize()
            turns = {n: [] for n in order}
            for r in range(ROUNDS):
                for n in (order if r % 2 == 0 else order[::-1]):
                    turns[n].append(time_ms(
                        lambda f=fns[n]: tk._run(f, stream, *a, **kw),
                        REPS[gname]))
            med = {n: float(np.median(t)) for n, t in turns.items()}
            print(f"zm_tail phases {gname} float32 {tuple(a[1].shape)}: "
                  + "; ".join(f"{n} {med[n]:.4f} ms "
                              f"({med[n] - med['full']:+.4f})" for n in order)
                  + f" [{card}]", flush=True)
            del a, kw
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["f19", "f05"]))
