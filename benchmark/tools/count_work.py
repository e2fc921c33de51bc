"""The operations and bytes one step of a configuration needs, counted
once over the frozen reference (harness/work.py), for the configuration
file's "work":

    python benchmark/tools/count_work.py aqua_f19 hs_f05 [--device cuda]

A step is the coupled `atm_step` (not the first) for a configuration
with "q_init", else the HS large step (dyn_run and hs_forcing); it is
counted from the seed-0 start state after `--warm` steps, in the
configuration's dtype, each kernel equivalent at its frozen kernel_work
and every other aten op by aten_work. The count depends on the shapes
and, through the FFSL sums, a little on the state; not on the device.
Prints one JSON object per configuration: ops_per_step, bytes_per_step
and kernels ({name: [calls, bytes, operations]})."""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.harness import spec as specs, states  # noqa: E402
from benchmark.harness.work import counting  # noqa: E402


def count(config: dict, device, warm: int = 2) -> dict:
    dtype = getattr(torch, config["dtype"])
    dyn0 = states.map_tensors(states.initial_dyn(config, 0, device),
                              lambda t: t.to(dtype))
    with torch.no_grad():
        if config.get("q_init"):
            from benchmark.entries.driver_chunked import build
            model, atm, state, cam_in = build(states.REF, config, dyn0,
                                              dtype, device)
            state = atm.atm_step(model, state, cam_in, first_step=True)[0]
            for _ in range(warm - 1):
                state = atm.atm_step(model, state, cam_in)[0]
            with counting() as c:
                atm.atm_step(model, state, cam_in)
        else:
            from benchmark.entries.hs_loop import reference_step
            step = reference_step(config, dtype, device)
            state = dyn0
            for _ in range(warm):
                state = step(state)
            with counting() as c:
                step(state)
    return {"ops_per_step": c.ops, "bytes_per_step": c.bytes,
            "kernels": c.kernels}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="+")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warm", type=int, default=2)
    args = ap.parse_args(argv)
    spec = specs.load_spec()
    for name in args.configs:
        entry = specs.find(spec["configs"], name, "configuration")
        with open(specs.ROOT / entry["file"]) as f:
            config = json.load(f)
        print(json.dumps({name: count(config, torch.device(args.device),
                                      args.warm)}), flush=True)


if __name__ == "__main__":
    main()
