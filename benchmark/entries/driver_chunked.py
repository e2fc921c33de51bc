"""Entry `driver_chunked`: the port's run driver, `driver.run`, on the
coupled aquaplanet step with `chunk` steps a dispatch (one CUDA graph a
chunk on the card).

The model is `AtmModel.create` with the configuration's FV, physics and
ZM settings; the state is `atm_init` of the seed's dycore state, with
zero surface geopotential; the surface input, fixed for the run, is
`bulk_surface_fluxes` of that start state over the aquaplanet SSTs
(`aquaplanet_sst`, Neale and Hoskins 2000).

Set-up runs the first step (`atm_step(first_step=True)`, which leaves the
energy fixer out) itself, so that every chunk after it has the same
length, then a calibration call of `calib_chunks` chunks, whose replays
(the driver timer's "atm_step" region) time a chunk. The window is one
more `driver.run` call of one chunk more than the window holds: the
driver captures its graph in that call's first chunk (its eager check,
the capture and the first replay: the timer's "graph_capture" region);
the window opens where that region ends and closes where the call's
last replay ends, so that the call's preamble is set-up and its close
(the history writer's flush and join) falls outside. The history tape
(every `hist_every` steps) and the sentinels (every `check_every`) run
as the traffic sets them.

The check follows the program twice with the reference (float64): from
the seed's state through atm_init and the first step (start_err), and
from the program's state at the window's end through one more
`driver.run` chunk, a graph replay as in the window (end_err).
"""

from __future__ import annotations

import contextlib
import importlib
import shutil
import tempfile
import time

import torch

from ..harness import states
from ..harness.cell import (Context, Measured, Phases, check_with, span,
                            window)
from ..harness.compare import SOLVERS, solver_cast

CAPTURE_REGION = "graph_capture"
REPLAY_REGION = "atm_step"


@contextlib.contextmanager
def _marking_timer(driver):
    """driver.run's PhaseTimer, for the block, as a subclass that notes
    the host clock at the end of each timed region (`ended`, after the
    region's device synchronise). The window opens where the call's graph
    capture region ends and closes where its last replay region ends: the
    call's preamble (the tapes' buffers, the writer, the carry's copy) and
    its close (the writer's flush and join) are once-a-run work, as the
    set-up is, and a year-long run pays them once."""
    base = driver.PhaseTimer

    class MarkingTimer(base):
        def __init__(self):
            super().__init__()
            self.ended = {}

        def timed(self, name, fn, *args, **kwargs):
            out = super().timed(name, fn, *args, **kwargs)
            self.ended[name] = time.perf_counter()
            return out

    driver.PhaseTimer = MarkingTimer
    try:
        yield
    finally:
        driver.PhaseTimer = base


def edges(timer, on_card: bool) -> None:
    """Raise unless `timer`, the one a driver.run call returned, marks
    the window's edges: the end of its one graph capture (on the card; on
    the CPU the driver steps eagerly and the window opens at the call) and
    the end of its last replay. A driver that timed with another class,
    renamed a region or kept its graph from an earlier call would
    otherwise move the window without a word."""
    if not hasattr(timer, "ended"):
        raise RuntimeError("driver_chunked: driver.run did not time with "
                           "the harness's marking PhaseTimer")
    captures = timer.counts.get(CAPTURE_REGION, 0)
    replays = timer.counts.get(REPLAY_REGION, 0)
    if captures != (1 if on_card else 0) or replays == 0:
        raise RuntimeError(
            f"driver_chunked: driver.run timed {captures} {CAPTURE_REGION!r}"
            f" and {replays} {REPLAY_REGION!r} regions; the window's edges "
            f"are not where the harness puts them")


def _model(pkg, config, dtype, device):
    """(model, state0, cam_in) of package `pkg` (the program or the
    reference) from the seed's dycore state `config['_dyn0']`."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    atm = mod("models.atm_comp")
    sf = mod("models.coupling.surface_fluxes")
    cfgs = mod("utils.config")
    reg = mod("models.physics.constituents").default_registry()
    g = config["grid"]
    model = atm.AtmModel.create(
        g["im"], g["jm"], g["km"], dt=config["dt"], registry=reg,
        fv_cfg=cfgs.FVConfig(**config["fv"]),
        phys_cfg=cfgs.PhysConfig(**config["phys"]),
        zm_cfg=cfgs.ZMConfig(**config["zm"]), dtype=dtype, device=device)
    return model, atm, sf


def build(pkg, config, dyn0, dtype, device):
    model, atm, sf = _model(pkg, config, dtype, device)
    g = config["grid"]
    phis = torch.zeros((g["jm"], g["im"]), dtype=dtype, device=device)
    state0 = atm.atm_init(model, dyn0, phis)
    sst = sf.aquaplanet_sst(state0.phys.lat)
    cam_in = sf.bulk_surface_fluxes(state0.phys, sst, model.registry.pcnst)
    return model, atm, state0, cam_in


def measure(ctx: Context) -> Measured:
    from cam_nor_physics_tpu_torch import driver
    tr, cfg = ctx.traffic, ctx.config
    chunk = tr["chunk"]
    ph = Phases(ctx)
    dyn0 = states.initial_dyn(cfg, ctx.seed, ctx.device)
    ph.mark("inputs")
    with span("bench.build"):
        model, atm, state0, cam_in = build(
            states.PORT, cfg, states.to_port(dyn0, ctx.dtype), ctx.dtype,
            ctx.device)
    ph.mark("build")
    with span("bench.first_step"):
        state1, _, _ = atm.atm_step(model, state0, cam_in, first_step=True)
    ph.mark("first_step")
    first = states.to_ref(state1.dyn, torch.float64)
    out_dir = tempfile.mkdtemp(prefix="bench-driver-")
    kw = dict(out_dir=out_dir, hist_every=tr["hist_every"], ckpt_every=0,
              check_every=tr["check_every"], chunk=chunk)

    def call(state, chunks):
        """driver.run of `chunks` chunks, its timer the program's
        PhaseTimer noting when each of its timed regions ends: (state,
        timer, the host clock at the call and at the return)."""
        t0 = time.perf_counter()
        with _marking_timer(driver):
            state, timer = driver.run(model, state, cam_in, chunks * chunk,
                                      **kw)
        ctx.sync()
        return state, timer, t0, time.perf_counter()

    def run(state, chunks):
        """call() of `chunks` chunks, one graph capture and its replays:
        (state, seconds from the end of the capture to the end of the
        last replay, the steps between, the capture's seconds, the timer,
        and the host clock at the call, the window's opening and closing,
        and the return)."""
        state, timer, t0, t1 = call(state, chunks)
        edges(timer, ctx.device.type == "cuda")
        captured = timer.counts.get(CAPTURE_REGION, 0)
        opened = timer.ended.get(CAPTURE_REGION, t0)
        closed = timer.ended[REPLAY_REGION]
        return (state, closed - opened, (chunks - captured) * chunk,
                timer.totals.get(CAPTURE_REGION, 0.0), timer,
                (t0, opened, closed, t1))

    try:
        with span("bench.calibrate"):
            state, _, _, capture, timer, _ = run(state1, tr["calib_chunks"])
        ph.mark("calibrate")
        ph.seconds["calibrate_capture"] = capture
        # a chunk's replay, from the driver's replay region
        chunk_s = (timer.totals[REPLAY_REGION]
                   / timer.counts[REPLAY_REGION])
        chunks = max(1, round(ctx.seconds / chunk_s))
        with window(ctx):
            state, window_s, steps, capture, _, (t0, opened, closed, t1) = \
                run(state, chunks + 1)
        ph.seconds["window_call_to_open"] = opened - t0
        ph.seconds["window_capture"] = capture
        ph.seconds["window_close_to_return"] = t1 - closed
        m = Measured(steps=steps, window_s=window_s,
                     setup_s=opened - ctx.t_start, phases=ph.seconds)
        if ctx.trace:
            with window(ctx, traced=True, cut_after=CAPTURE_REGION) as w:
                state, _, traced, _, _, _ = run(
                    state, tr["trace_steps"] // chunk + 1)
            m.record = dict(w["record"], steps=traced)
        end = states.to_ref(state, torch.float64)
        with span("bench.check_run"):
            state = call(state, 1)[0]
        m.kept = {"start": (dyn0, first),
                  "end": (end, states.to_ref(state.dyn, torch.float64))}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return m


def _follow(ctx: Context, m: Measured, solver: str) -> dict:
    """{check: the dycore state after the check's steps}, as `solver`
    computes it (compare.SOLVERS: the float64 "reference", the "control"
    with its state held in bfloat16 between steps, ...)."""
    cast = solver_cast(solver)
    dtype = SOLVERS[solver][0]
    with torch.no_grad():
        model, atm, state0, cam_in = build(states.REF, ctx.config,
                                           cast(m.kept["start"][0]), dtype,
                                           ctx.device)
        first = cast(atm.atm_step(model, cast(state0), cam_in,
                                  first_step=True)[0])
        state = cast(m.kept["end"][0])
        for _ in range(ctx.traffic["chunk"]):
            state = cast(atm.atm_step(model, state, cam_in)[0])
    return {"start": first.dyn, "end": state.dyn}


def check(ctx: Context, m: Measured, solver: str = "program") -> dict:
    """harness.cell.check_with for this entry's checks."""
    return check_with(_follow, ctx, m, solver)
