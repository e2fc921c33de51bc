"""Jablonowski-Williamson (2006) baroclinic wave on the port.

Twin of the JAX package's tools/jw_baroclinic.py (`jw_baroclinic`: the
perturbed JW06 case at FVConfig() for `days`, default 12, with the daily
global minimum surface pressure and max|u|, whether the wave is quiet
through day 4 and the first day below 960 hPa) and of the nine-day
envelope of tests/test_baroclinic_wave.py (`jw06_envelope`: f19, float32,
div24del2flag = 2, the reference's damping, held to that test's
thresholds). One dyn_run a dispatch, on the card by default:

    python -m cam_nor_physics_tpu_torch.tools.jw_baroclinic
    python -m cam_nor_physics_tpu_torch.tools.jw_baroclinic --device cpu \
        --im 24 --jm 16 --km 6 --days 1

`main` prints the JAX tool's JSON line; on a blow-up it prints
{"status": "blowup", "day": ...} and exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from ..models.fv.baroclinic_wave import jw_baroclinic_wave
from ..models.fv.cd_core import pressure_vars
from ..models.fv.dyn_comp import dyn_run
from ..models.fv.grid import make_grid
from ..models.fv.vertical import hybrid_coefficients
from ..utils.config import FVConfig
from ..utils.device import resolve_device


def jw_series(days: float, im: int, jm: int, km: int, dt: float,
              cfg: FVConfig, device, dtype, log=sys.stderr):
    """The perturbed JW06 wave for `days`, one dyn_run a step: (the daily
    {"day", "ps_min_hpa", "umax_ms", "eke"} in order, the day of a
    blow-up or None, wall seconds). eke is the mass-weighted eddy kinetic
    energy (zonal means removed, tests/test_baroclinic_wave.py). The run
    stops at the first day whose ps_min is not finite."""
    dev = resolve_device(device)
    grid = make_grid(im, jm, km, dtype=dtype, device=dev)
    coord = hybrid_coefficients(km, dtype=dtype, device=dev)
    state, phis = jw_baroclinic_wave(grid, coord, perturb=True, dtype=dtype,
                                     device=dev)
    phis = phis.to(dtype)
    steps_per_day = int(86400 / dt)
    series = []
    t0 = time.perf_counter()
    for i in range(int(days * steps_per_day)):
        state = dyn_run(state, grid, coord, phis, cfg, dt)
        if (i + 1) % steps_per_day:
            continue
        day = (i + 1) / steps_per_day
        pe = pressure_vars(state.delp, coord.ptop)[0]
        up = state.u - state.u.mean(-1, keepdim=True)
        vp = state.v - state.v.mean(-1, keepdim=True)
        eke = torch.sum(0.5 * (up * up + vp * vp) * state.delp) / \
            torch.sum(state.delp)
        pmin = float(pe[-1].min()) / 100.0
        series.append({"day": day, "ps_min_hpa": pmin,
                       "umax_ms": float(state.u.abs().max()),
                       "eke": float(eke)})
        print(f"day {day:5.1f}  ps_min {pmin:7.2f} hPa  umax "
              f"{series[-1]['umax_ms']:6.1f}  "
              f"({time.perf_counter() - t0:6.1f}s)", file=log)
        if not math.isfinite(pmin):
            return series, day, time.perf_counter() - t0
    return series, None, time.perf_counter() - t0


def jw_baroclinic(days: float = 12.0, im: int = 144, jm: int = 96,
                  km: int = 26, dt: float = 1800.0, flag: int | None = None,
                  device="cuda", dtype=torch.float32,
                  log=sys.stderr) -> dict:
    """The JAX tool's run at FVConfig() (div24del2flag `flag` where
    given); returns what it prints, unrounded: status ("ok" or
    "blowup"), series, quiet_through_day4, first_day_below_960 and
    wall_s (on a blow-up also day); the series' days carry eke too."""
    cfg = FVConfig() if flag is None else FVConfig(div24del2flag=flag)
    series, blowup, wall = jw_series(days, im, jm, km, dt, cfg, device,
                                     dtype, log)
    out = {"status": "ok" if blowup is None else "blowup", "series": series,
           "quiet_through_day4": all(s["ps_min_hpa"] > 985.0
                                     for s in series if s["day"] <= 4),
           "first_day_below_960": next((s["day"] for s in series
                                        if s["ps_min_hpa"] < 960.0), None),
           "wall_s": wall}
    if blowup is not None:
        out["day"] = blowup
    return out


def jw06_envelope(im: int = 144, jm: int = 96, km: int = 26,
                  dt: float = 1800.0, days: int = 9, device="cuda",
                  dtype=torch.float32, log=sys.stderr) -> dict:
    """The nine-day cyclogenesis envelope of tests/test_baroclinic_wave.py
    at the reference's damping (div24del2flag = 2): the daily ps_min (hPa)
    and eke, d78 and d89 (the day-over-day deepening), the test's checks
    by name and `ok`, their conjunction (False on a blow-up)."""
    series, blowup, wall = jw_series(days, im, jm, km, dt,
                                     FVConfig(div24del2flag=2), device,
                                     dtype, log)
    ps = {int(s["day"]): s["ps_min_hpa"] for s in series}
    eke = {int(s["day"]): s["eke"] for s in series}
    out = {"ps_min": ps, "eke": eke, "wall_s": wall, "blowup_day": blowup}
    if blowup is not None or len(ps) < 9:
        return dict(out, checks={}, ok=False)
    d78, d89 = ps[7] - ps[8], ps[8] - ps[9]
    checks = {
        # quiet phase (JW06: ps_min 995-1000 hPa through day ~4-6)
        "quiet_days_1_4_above_985": all(ps[d] > 985.0 for d in (1, 2, 3, 4)),
        "deepening_days_6_to_9": ps[9] < ps[8] < ps[7] < ps[6],
        "accelerating_d89_gt_d78_gt_2": d89 > d78 > 2.0,
        "ps_min_day9_in_930_980": 930.0 < ps[9] < 980.0,
        # near-exponential eddy-KE growth, orders above the seed
        "eke_day9_gt_10x_day5": eke[9] > 10.0 * eke[5] > 0.0,
        "eke_day9_gt_1": eke[9] > 1.0,
    }
    return dict(out, d78=d78, d89=d89, checks=checks,
                ok=all(checks.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="JW06 baroclinic wave on the PyTorch/CUDA port")
    ap.add_argument("--days", type=float, default=12.0)
    ap.add_argument("--im", type=int, default=144)
    ap.add_argument("--jm", type=int, default=96)
    ap.add_argument("--km", type=int, default=26)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    res = jw_baroclinic(args.days, args.im, args.jm, args.km, args.dt,
                        device=args.device)
    if res["status"] == "blowup":
        print(json.dumps({"status": "blowup", "day": res["day"]}))
        return 1
    print(json.dumps({
        "status": "ok",
        "series": [{"day": s["day"], "ps_min_hpa": round(s["ps_min_hpa"], 2),
                    "umax_ms": round(s["umax_ms"], 1)}
                   for s in res["series"]],
        "quiet_through_day4": res["quiet_through_day4"],
        "first_day_below_960": res["first_day_below_960"],
        "wall_s": round(res["wall_s"], 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
