"""The readings the limits of `correct` are set from: for each seed, the
cell's run (its window at --seconds), then the compared numbers of the
program and of the control (the reference computed in float32 with its
state held in bfloat16 between steps, put in the program's place), each
against the float64 reference; with --solvers plain32 also the reference in
float32 (a witness of float32 rounding alone), and with --dtype float64
the program in float64 (a witness that its kernels agree).

    python benchmark/tools/readings.py aqua_f19.monthly_hist \
        --seeds 101 102 103 --seconds 20 --solvers control plain32

Prints one JSON line per seed with both sets of numbers and field
errors."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness import spec as specs  # noqa: E402
from benchmark.harness.cell import Context  # noqa: E402
from benchmark.harness.compare import numbers  # noqa: E402


def readings(workload, seed, seconds, solvers=("control",), device="cuda",
             overrides=None):
    cell, config, traffic = specs.load_cell(workload)
    config = dict(config, **(overrides or {}))
    entry = specs.entry_module(traffic)
    ctx = Context(config=config, traffic=traffic, seed=seed,
                  seconds=seconds, trace=False, device=torch.device(device),
                  t_start=time.perf_counter())
    m = entry.measure(ctx)
    out = {"seed": seed, "steps": m.steps, "sypd": m.end_to_end(config)}
    for solver in ["program"] + list(solvers):
        t0 = time.perf_counter()
        errors = entry.check(ctx, m, solver)
        out[solver] = numbers(errors, config["compared"])
        out[solver + "_fields"] = errors
        out[solver + "_s"] = time.perf_counter() - t0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--solvers", nargs="*", default=["control"],
                    help="besides the program: control, plain32")
    ap.add_argument("--dtype", default=None,
                    help="run the program in this dtype (a witness)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        over = {"dtype": args.dtype} if args.dtype else None
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  args.solvers, overrides=over)), flush=True)


if __name__ == "__main__":
    main()
