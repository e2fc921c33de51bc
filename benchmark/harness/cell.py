"""What an entry (entries/<name>.py) takes and gives: the run's context,
and what its measurement leaves for the metrics and the check."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import torch

from .compare import field_errors
from .trace import WINDOW_SPAN, events_of, profiler, reduce_events

SECONDS_PER_YEAR = 365.0 * 86400.0


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float              # the process's start on the host clock

    @property
    def dtype(self):
        return getattr(torch, self.config["dtype"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Measured:
    steps: int                  # model steps inside the window
    window_s: float             # the window's wall seconds
    setup_s: float              # process start until the window opened
    record: dict | None = None  # the traced window (trace.reduce_events)
    kept: dict = dataclasses.field(default_factory=dict)
    field_errors: dict = dataclasses.field(default_factory=dict)
    phases: dict = dataclasses.field(default_factory=dict)  # set-up's, s

    def end_to_end(self, config: dict) -> dict:
        """The end-to-end metrics: simulated years per wall-clock day
        (CPMIP's SYPD: the steps' simulated time over the window's wall
        time) and the set-up seconds."""
        years = self.steps * config["dt"] / SECONDS_PER_YEAR
        return {"sypd": years / (self.window_s / 86400.0),
                "setup_s": self.setup_s}


def span(name: str):
    """A host span of the harness's own, seen by the profiler."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def window(ctx: Context, traced: bool = False, cut_after: str | None = None):
    """A window: a device synchronise at both ends, the `bench.window`
    span around it and, where `traced`, the profiler. Yields a dict that
    holds, once the block has ended, t0 and t1 (host clock) and, where
    traced, `record` (trace.reduce_events of the window, cut after the
    program's span `cut_after`).

    A traced run measures its window untraced first, as a run with
    --trace 0 does, and then a traced window of its own: the profiler's
    cost (on graph replays CUPTI's, a few microseconds a kernel) would
    otherwise be in the host-clock numbers."""
    out = {}
    prof = profiler() if traced else contextlib.nullcontext()
    with prof:
        ctx.sync()
        with span(WINDOW_SPAN):
            out["t0"] = time.perf_counter()
            yield out
            ctx.sync()
            out["t1"] = time.perf_counter()
    if traced:
        out["record"] = reduce_events(*events_of(prof), cut_after=cut_after)


class Phases:
    """Set-up split by phase on the host clock: `mark(name)` closes the
    phase that ran since the last mark."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.t = time.perf_counter()
        self.seconds = {"process_to_entry": self.t - ctx.t_start}

    def mark(self, name: str):
        self.ctx.sync()
        t = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + t - self.t
        self.t = t


def free_device_memory():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check_with(follow, ctx: Context, m: Measured, solver: str) -> dict:
    """{check: {field: error}} of the program (or of another solver of
    compare.SOLVERS put in its place) against the float64 reference, for
    each check of m.kept ({check: (start state, the program's dycore
    state after it)}); `follow(ctx, m, solver)` gives {check: a solver's
    dycore state}. Also kept in m.field_errors. Frees the program's
    device memory first."""
    free_device_memory()
    ref = follow(ctx, m, "reference")
    cand = (follow(ctx, m, solver) if solver != "program"
            else {k: prog for k, (_, prog) in m.kept.items()})
    m.field_errors = {
        name: field_errors(getattr(start, "dyn", start), cand[name],
                           ref[name])
        for name, (start, _) in m.kept.items()}
    return m.field_errors
