"""Held-Suarez climatology run: the HS94 structure validation on the port.

Twin of the JAX package's tools/hs_climate.py. Runs the dry FV dycore
(dyn_run with FVConfig()'s auto splits and the fused fft small step) and
the HS forcing for `days` (default 60: 20 spin-up + 40 averaged), one step
a dispatch, accumulating the zonal-time-mean climate on pressure surfaces
every `sample_every` steps after the spin-up (utils/climatology.py), and
checking that u is finite every 96 steps; then evaluates the HS94
structure criteria. On the card by default (float32, as the JAX tool):

    python -m cam_nor_physics_tpu_torch.tools.hs_climate --days 60 \
        --spinup 20
    python -m cam_nor_physics_tpu_torch.tools.hs_climate --device cpu \
        --im 24 --jm 16 --km 4 --days 1 --spinup 0.5 --out /tmp/c.npz

`main` prints the JAX tool's JSON line and saves the climatology to
`--out`; on a blow-up it prints {"status": "blowup", "day": ...} and
exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.fv.cd_core import d2a_winds, pressure_vars
from ..models.fv.ctem import default_ctem_levels
from ..models.fv.dyn_comp import dyn_run
from ..models.fv.grid import make_grid
from ..models.fv.held_suarez import hs_forcing, hs_initial_state
from ..models.fv.vertical import hybrid_coefficients
from ..utils.climatology import (climo_init, climo_resolve, climo_update,
                                 hs94_checks)
from ..utils.config import FVConfig
from ..utils.device import resolve_device

CHECK_EVERY = 96           # steps between the finiteness checks of u


def hs_climate(days: float = 60.0, spinup: float = 20.0, im: int = 144,
               jm: int = 96, km: int = 26, dt: float = 1800.0,
               sample_every: int = 4, flag: int | None = None,
               del2coef: float | None = None, device="cuda",
               dtype=torch.float32, log=sys.stderr) -> dict:
    """The run; returns what the JAX tool prints, unrounded: status ("ok",
    "structure-mismatch" or "blowup"), days, spinup, nsamples, checks
    ({name: {"value", "ok"}}) and wall_s, or on a blow-up status, day (of
    the first check that found u not finite), days, spinup and wall_s;
    besides, "umax_ms", max|u| at each check, and "climo", the arrays the
    JAX tool saves. `flag` and `del2coef` override FVConfig's
    div24del2flag and del2coef (the stability ladder)."""
    dev = resolve_device(device)
    grid = make_grid(im, jm, km, dtype=dtype, device=dev)
    coord = hybrid_coefficients(km, dtype=dtype, device=dev)
    phis = torch.zeros((jm, im), dtype=dtype, device=dev)
    over = {}
    if flag is not None:
        over["div24del2flag"] = flag
    if del2coef is not None:
        over["del2coef"] = del2coef
    cfg = FVConfig(**over)
    plev = default_ctem_levels(km)

    def step(state):
        state = dyn_run(state, grid, coord, phis, cfg, dt)
        return hs_forcing(state, grid, coord.ptop, dt)

    def sample(state, acc):
        ua, va = d2a_winds(state.u, state.v)
        pe, _pk, pkz, _peln = pressure_vars(state.delp, coord.ptop)
        pmid = 0.5 * (pe[1:] + pe[:-1])
        # dry HS: pt is scaled (virtual = dry) potential temperature
        return climo_update(acc, ua, va, state.pt * pkz, pmid, plev)

    state = hs_initial_state(grid, coord, pert=1.0)
    nsteps = int(days * 86400 / dt)
    nspin = int(spinup * 86400 / dt)
    acc = climo_init(km, jm, dtype=dtype, device=dev)
    umax = []
    run = {"days": days, "spinup": spinup, "umax_ms": umax}

    t0 = time.perf_counter()
    for i in range(nsteps):
        state = step(state)
        if i >= nspin and i % sample_every == 0:
            acc = sample(state, acc)
        if (i + 1) % CHECK_EVERY == 0:
            day = (i + 1) * dt / 86400
            if not bool(torch.isfinite(state.u).all()):
                return dict(run, status="blowup", day=day,
                            wall_s=time.perf_counter() - t0)
            umax.append(float(state.u.abs().max()))
            print(f"day {day:6.1f}  umax {umax[-1]:6.1f} m/s  "
                  f"({time.perf_counter() - t0:7.1f}s)", file=log)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    climo = climo_resolve(acc)
    lats_deg = np.degrees(grid.lats.cpu().numpy())
    checks = hs94_checks(climo, lats_deg, plev)
    ok = all(v[1] for v in checks.values())
    return dict(run, status="ok" if ok else "structure-mismatch",
                nsamples=climo["nsamples"],
                checks={k: {"value": v[0], "ok": bool(v[1])}
                        for k, v in checks.items()},
                wall_s=time.perf_counter() - t0, climo=climo)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Held-Suarez climatology run of the PyTorch/CUDA port "
                    "with the HS94 structure checks")
    ap.add_argument("--days", type=float, default=60.0)
    ap.add_argument("--spinup", type=float, default=20.0)
    ap.add_argument("--im", type=int, default=144)
    ap.add_argument("--jm", type=int, default=96)
    ap.add_argument("--km", type=int, default=26)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--sample-every", type=int, default=4)
    ap.add_argument("--flag", type=int, default=None,
                    help="div24del2flag override (2/4/22/24/42) for the "
                         "stability-ladder runs")
    ap.add_argument("--del2coef", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--out", default="/tmp/hs_climo.npz",
                    help="where the climatology is saved (numpy .npz)")
    args = ap.parse_args(argv)
    res = hs_climate(args.days, args.spinup, args.im, args.jm, args.km,
                     args.dt, args.sample_every, args.flag, args.del2coef,
                     args.device)
    if res["status"] == "blowup":
        print(json.dumps({"status": "blowup", "day": res["day"]}))
        return 1
    print(json.dumps({
        "status": res["status"], "days": res["days"],
        "spinup": res["spinup"], "nsamples": res["nsamples"],
        "checks": {k: {"value": round(v["value"], 3), "ok": v["ok"]}
                   for k, v in res["checks"].items()},
        "wall_s": round(res["wall_s"], 1)}))
    np.savez(args.out, **res["climo"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
