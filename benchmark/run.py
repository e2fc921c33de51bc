"""Run one cell of the port's benchmark once and print its result line.

    python benchmark/run.py --workload aqua_f19.monthly_hist --seed 7 \
        --seconds 20 --trace 0

The cell (BENCHMARK.json's `workloads`) names a configuration
(configs/<config>.json) and a traffic mix (traffic/<traffic>.json) whose
"entry" is a module of entries/. The entry builds the program
(cam_nor_physics_tpu_torch) from the seed, warms up every shape it will
run, steps it for about --seconds, and keeps what the check compares.
With --trace 0 the line holds the cell's end-to-end metrics (sypd,
setup_s); with --trace 1 the steps run under torch.profiler and the line
holds the cell's per-layer metrics, each read from the traced window by
metrics/<name>.py. Then the reference (reference/, plain PyTorch in
float64) follows the program from the same states, and `correct` says
whether every compared number is within its limit (harness/compare.py).

The last line on standard output is one JSON object; the last lines on
standard error name each compared number beside its limit. Exits 4
without a result where a JAX module was loaded; where there is no CUDA
device, or fewer than the cell asks for, or any other fault (a missing
module of the port among them), it exits 1 without a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the names of JAX and of the JAX package: none may be loaded here
FORBIDDEN = {"jax", "jaxlib", "flax", "cam_nor_physics_tpu"}


class ForbiddenModules(RuntimeError):
    """A JAX module, or one of the JAX package, was loaded."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(args, device=None, t_start=None, overrides=None):
    """Run the cell of `args` once; returns (result dict, stderr lines).

    `device` None means the card, which must be there; tests pass "cpu"
    and shrink the configuration through `overrides` (a dict merged into
    the configuration's file)."""
    import torch

    from benchmark.harness import spec as specs
    from benchmark.harness.cell import Context
    from benchmark.harness.compare import (limit_lines, limits_of, numbers,
                                           verdict)
    from benchmark.harness.trace import breakdown

    spec = specs.load_spec()
    cell, config, traffic = specs.load_cell(args.workload, spec)
    config = dict(config, **(overrides or {}))
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("benchmark: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"benchmark: {cell['name']} needs "
                             f"{cell['chips']} CUDA devices, found "
                             f"{torch.cuda.device_count()}")
        device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = specs.entry_module(traffic)
    ctx = Context(config=config, traffic=traffic, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device(device),
                  t_start=T_START if t_start is None else t_start)

    if ctx.device.type == "cuda":
        torch.zeros(1, device=ctx.device)       # the CUDA context
    measured = entry.measure(ctx)
    on_card = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules("benchmark: JAX modules loaded: " +
                               ", ".join(found))
    if args.trace:
        names = specs.metric_names(spec, cell, "per_layer")
        record = dict(measured.record, config=config,
                      host_steps=measured.steps,
                      host_window_s=measured.window_s,
                      device_name=(torch.cuda.get_device_name()
                                   if on_card else "cpu"))
        metrics = {}
        for name in names:
            unit = specs.find(spec["per_layer"], name, "metric")["unit"]
            value = specs.metric_reader(name)(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        names = specs.metric_names(spec, cell, "end_to_end")
        values = measured.end_to_end(config)
        metrics = {n: {"value": values[n], "unit": specs.find(
            spec["end_to_end"], n, "metric")["unit"]} for n in names}

    compared = numbers(entry.check(ctx, measured), config["compared"])
    limits = limits_of(config["compared"])
    correct = verdict(compared, limits)
    result = {
        "correct": correct,
        "attempted": measured.steps,
        "failed": 0 if correct else measured.steps,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name() if on_card
                            else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": peak},
    }
    if args.trace:
        result["device"].update(busy_s=measured.record["busy_s"],
                                window_s=measured.record["window_s"])
        result["breakdown"] = breakdown(measured.record)
    result["compared"] = {k: {"value": _finite(compared[k]),
                              "limit": limits[k]} for k in limits}
    lines = [f"setup phases s: {json.dumps(measured.phases)}"]
    lines += [f"field errors {k}: {json.dumps(v)}"
              for k, v in measured.field_errors.items()]
    return result, lines + limit_lines(compared, limits)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result, lines = run_cell(args)
    except ForbiddenModules as err:
        print(err, file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print("benchmark: JAX modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
