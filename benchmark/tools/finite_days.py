"""How many simulated days the aquaplanet configuration stays finite and
bounded, by seed: the program's coupled step (as the cell builds it) in
CUDA graphs of `chunk` steps, max|u| and finiteness read once a day.

    python benchmark/tools/finite_days.py aqua_f19 --seeds 11 12 --days 40

Prints one JSON line per seed: {"seed", "days": [[day, max|u| m/s,
finite]], "wall_s"}. Stops a seed at its first non-finite day."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.entries.driver_chunked import build  # noqa: E402
from benchmark.harness import spec as specs, states  # noqa: E402


def days_of(config, seed, days, chunk=8, device="cuda"):
    from cam_nor_physics_tpu_torch.bench import ChainGraph
    dtype = getattr(torch, config["dtype"])
    dev = torch.device(device)
    dyn0 = states.to_port(states.initial_dyn(config, seed, dev), dtype)
    model, atm, state, cam_in = build(states.PORT, config, dyn0, dtype, dev)
    state = atm.atm_step(model, state, cam_in, first_step=True)[0]

    def step(s):
        return (atm.atm_step(model, s, cam_in)[0],)
    carry = (step(state)[0],)
    graph = ChainGraph(step, carry, chunk)
    per_day = int(round(86400.0 / config["dt"])) // chunk
    out, t0 = [], time.perf_counter()
    for day in range(1, days + 1):
        for _ in range(per_day):
            graph.replay()
        u = graph.static[0].dyn.u
        finite = bool(torch.isfinite(u).all()
                      & torch.isfinite(graph.static[0].dyn.pt).all())
        out.append([day, float(u.abs().max()), finite])
        if not finite:
            break
    return {"seed": seed, "days": out, "wall_s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--days", type=int, default=40)
    args = ap.parse_args(argv)
    entry = specs.find(specs.load_spec()["configs"], args.config,
                       "configuration")
    with open(specs.ROOT / entry["file"]) as f:
        config = json.load(f)
    for seed in args.seeds:
        print(json.dumps(days_of(config, seed, args.days)), flush=True)


if __name__ == "__main__":
    main()
