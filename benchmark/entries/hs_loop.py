"""Entry `hs_loop`: the Held-Suarez large step of the port, one step a
dispatch, as the port's tools/hs_climate.py runs it.

A step is `dyn_run` (FVConfig with the configuration's overrides, the
fused K1-K4 small steps, trac2d's tracer_div3d, te_map's te_map_remap)
then `hs_forcing`; every `sample_every` steps the zonal-mean climatology
takes a sample (utils/climatology.climo_update on d2a winds and T on
pressure levels), and every `check_every` steps the host reads whether u
is finite, as the tool does. Set-up makes the seed's state, runs the
first `warm_steps` steps (one of them sampled) and times `calib_steps`
more to size the window; the window then runs a fixed number of steps.

The check follows the program twice with the reference (float64): from
the seed's state through the first step (start_err), and from the
program's state before the window's last step through that step
(end_err).
"""

from __future__ import annotations

import time

import torch

from ..harness import states
from ..harness.cell import (Context, Measured, Phases, check_with, span,
                            window)
from ..harness.compare import SOLVERS, solver_cast


def _port(config, ctx):
    from cam_nor_physics_tpu_torch.models.fv.cd_core import (d2a_winds,
                                                            pressure_vars)
    from cam_nor_physics_tpu_torch.models.fv.ctem import default_ctem_levels
    from cam_nor_physics_tpu_torch.models.fv.dyn_comp import dyn_run
    from cam_nor_physics_tpu_torch.models.fv.grid import make_grid
    from cam_nor_physics_tpu_torch.models.fv.held_suarez import hs_forcing
    from cam_nor_physics_tpu_torch.models.fv.vertical import \
        hybrid_coefficients
    from cam_nor_physics_tpu_torch.utils.climatology import (climo_init,
                                                             climo_update)
    from cam_nor_physics_tpu_torch.utils.config import FVConfig
    g, dt, dtype, dev = config["grid"], config["dt"], ctx.dtype, ctx.device
    grid = make_grid(g["im"], g["jm"], g["km"], dtype=dtype, device=dev)
    coord = hybrid_coefficients(g["km"], dtype=dtype, device=dev)
    phis = torch.zeros((g["jm"], g["im"]), dtype=dtype, device=dev)
    cfg = FVConfig(**config["fv"])
    plev = default_ctem_levels(g["km"])

    def step(state):
        state = dyn_run(state, grid, coord, phis, cfg, dt)
        return hs_forcing(state, grid, coord.ptop, dt)

    def sample(state, acc):
        ua, va = d2a_winds(state.u, state.v)
        pe, _pk, pkz, _peln = pressure_vars(state.delp, coord.ptop)
        pmid = 0.5 * (pe[1:] + pe[:-1])
        return climo_update(acc, ua, va, state.pt * pkz, pmid, plev)

    return step, sample, climo_init(g["km"], g["jm"], dtype=dtype,
                                    device=dev)


def reference_step(config, dtype, device):
    """The reference's HS large step in dtype on device."""
    from ..reference.models.fv.dyn_comp import dyn_run
    from ..reference.models.fv.grid import make_grid
    from ..reference.models.fv.held_suarez import hs_forcing
    from ..reference.models.fv.vertical import hybrid_coefficients
    from ..reference.utils.config import FVConfig
    g, dt = config["grid"], config["dt"]
    grid = make_grid(g["im"], g["jm"], g["km"], dtype=dtype, device=device)
    coord = hybrid_coefficients(g["km"], dtype=dtype, device=device)
    phis = torch.zeros((g["jm"], g["im"]), dtype=dtype, device=device)
    cfg = FVConfig(**config["fv"])

    def step(state):
        state = dyn_run(state, grid, coord, phis, cfg, dt)
        return hs_forcing(state, grid, coord.ptop, dt)
    return step


def measure(ctx: Context) -> Measured:
    tr = ctx.traffic
    ph = Phases(ctx)
    dyn0 = states.initial_dyn(ctx.config, ctx.seed, ctx.device)
    ph.mark("inputs")
    with span("bench.build"):
        step, sample, acc = _port(ctx.config, ctx)
        state = states.to_port(dyn0, ctx.dtype)
    ph.mark("build")
    i = 0

    def advance(state, acc, n):
        nonlocal i
        prev = state
        for _ in range(n):
            prev = state
            with span("bench.step"):
                state = step(state)
            if i % tr["sample_every"] == 0:
                with span("bench.sample"):
                    acc = sample(state, acc)
            i += 1
            if i % tr["check_every"] == 0:
                with span("bench.sentinel"):
                    if not bool(torch.isfinite(state.u).all()):
                        raise FloatingPointError(
                            f"hs_loop: u not finite at step {i}")
        return prev, state, acc

    with span("bench.warm_up"):
        _, state, acc = advance(state, acc, 1)
        ph.mark("first_step")
        first = states.to_ref(state, torch.float64)
        _, state, acc = advance(state, acc, tr["warm_steps"] - 1)
        ph.mark("warm_steps")
        t0 = time.perf_counter()
        _, state, acc = advance(state, acc, tr["calib_steps"])
        ctx.sync()
        step_s = (time.perf_counter() - t0) / tr["calib_steps"]
        ph.mark("calibrate")
    n = max(2, round(ctx.seconds / step_s))
    with window(ctx) as w:
        prev, state, acc = advance(state, acc, n)
    m = Measured(steps=n, window_s=w["t1"] - w["t0"],
                 setup_s=w["t0"] - ctx.t_start, phases=ph.seconds)
    if ctx.trace:
        with window(ctx, traced=True) as w:
            prev, state, acc = advance(state, acc, tr["trace_steps"])
        m.record = dict(w["record"], steps=tr["trace_steps"])
    m.kept = {"start": (dyn0, first),
              "end": (states.to_ref(prev, torch.float64),
                      states.to_ref(state, torch.float64))}
    return m


def _follow(ctx: Context, m: Measured, solver: str) -> dict:
    """{check: the state after the check's step from its start}, as
    `solver` computes it (compare.SOLVERS)."""
    cast = solver_cast(solver)
    with torch.no_grad():
        step = reference_step(ctx.config, SOLVERS[solver][0], ctx.device)
        return {name: cast(step(cast(start)))
                for name, (start, _) in m.kept.items()}


def check(ctx: Context, m: Measured, solver: str = "program") -> dict:
    """harness.cell.check_with for this entry's checks."""
    return check_with(_follow, ctx, m, solver)
