"""Phase timing: the perf_mod (GPTL t_startf/t_stopf) role, and the
port's spans.

Twin of `cam_nor_physics_tpu.utils.timing`. `PhaseTimer` keeps a host-side
wall-time table by named region, as the reference prints one. `region`
tags the block for torch.profiler traces (through `span`); `timed` runs
a function and waits for the device before it stops the clock
(`torch.cuda.synchronize` of every CUDA device its outputs live on), so
a region times the work and not only its launches.

`span(name)` is the port's one span primitive (`spanned(name)` wraps a
whole function in it). The modules that do the work open it around each
phase of a step (`SPANS`), so that every caller (the driver, the CLI,
the tools, a benchmark) gets it. With no profiler recording it makes
one check and does nothing else: no profiler op, no kernel, no
allocation. While a profiler records it opens
`torch.profiler.record_function(name)` and, where CUDA is in use and the
name is one of `SPANS`, enqueues a marker kernel on the current stream
at its entry and at its exit (csrc/span_kernels.cu:
`span_mark_kernel<S, E>`, S the name's index in `SPANS`, E 0 at the entry
and 1 at the exit). The device's kernels between a span's two markers
are the span's, on the device's clock.

In a CUDA graph the markers follow the profiler's state at capture: a
graph captured while a profiler records holds the markers as nodes and
launches them in every replay; a graph captured without one holds none,
whatever records its replays. The run driver captures its graphs anew at
every `driver.run` call, so a call made under a profiler is marked and
every other call is not. There is no other switch.
"""

from __future__ import annotations

import contextlib
import functools
import re
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _profiler

# the port's spans, each opened by the module that does the work; a
# name's index is its markers' S (fixed: a trace reads it back by index)
SPANS = (
    "phys_run1",            # physpkg.phys_run1
    "zm_conv_tend",         # zm_conv_intr.zm_conv_tend, inside phys_run1
    "phys_run2",            # physpkg.phys_run2
    "p_d_coupling",         # dp_coupling.p_d_coupling
    "dyn_run",              # dyn_comp.dyn_run_whole
    "cd_core",              # dyn_run's loop of nsplit cd_step calls
    "trac2d",               # dyn_comp.trac2d, inside dyn_run
    "te_map",               # dyn_comp.te_map, inside dyn_run
    "d_p_coupling",         # dp_coupling.d_p_coupling and _diags
    "atm_diagnostics",      # atm_comp.atm_step's tail
    "history_accumulate",   # the driver's payload and outfld_many
    "hs_forcing",           # held_suarez.hs_forcing
    "climo_update",         # climatology.climo_update
)
MAX_SPANS = 32              # csrc/span_kernels.cu's kMaxSpans
_INDEX = {name: i for i, name in enumerate(SPANS)}
_MARKER = re.compile(r"span_mark_kernel<\s*(\d+)\s*,\s*(\d+)\s*>")

_OFF = contextlib.nullcontext()
_ENTRY = []         # the marker's C entry point, resolved at first use


def marker_name(name: str, edge: int) -> str:
    """The marker kernel's name (without its return type and parameters)
    at the entry (edge 0) or the exit (edge 1) of span `name`."""
    return f"span_mark_kernel<{_INDEX[name]}, {edge}>"


def parse_marker(kernel: str):
    """(span name, edge) of a device kernel's name if it is a span's
    marker, else None."""
    m = _MARKER.search(kernel)
    if m is None or int(m.group(1)) >= len(SPANS):
        return None
    return SPANS[int(m.group(1))], int(m.group(2))


def _mark(index: int, edge: int) -> None:
    """Enqueue the marker of span `index`'s `edge` on the current stream."""
    if not _ENTRY:
        from ..ops import cuda_build
        _ENTRY.append(cuda_build.library("span_kernels").cam_span_mark)
    rc = _ENTRY[0](index, edge, torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device()))
    if rc != 0:
        raise RuntimeError(f"span: marker launch failed with cudaError {rc}")


class _Span:
    """A span while a profiler records: the host annotation, and the
    markers of a name of SPANS where CUDA is in use."""

    __slots__ = ("name", "index", "annotation")

    def __init__(self, name: str):
        self.name = name
        self.index = _INDEX.get(name)
        if self.index is not None and not torch.cuda.is_initialized():
            self.index = None
        self.annotation = torch.profiler.record_function(name)

    def __enter__(self):
        self.annotation.__enter__()
        if self.index is not None:
            _mark(self.index, 0)
        return self

    def __exit__(self, *exc):
        if self.index is not None:
            _mark(self.index, 1)
        return self.annotation.__exit__(*exc)


def span(name: str):
    """A context manager around one phase (see the module docstring): a
    shared null context unless a profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class PhaseTimer:
    """Accumulating region timer (t_startf/t_stopf role)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def region(self, name: str):
        """Time a block on the host clock; the block waits for the device
        itself where it must (a host read does)."""
        with span(name):
            t0 = time.perf_counter()
            yield
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait until its outputs are ready on the device, record
        the wall time; returns fn's result."""
        from ..bench import tensors
        with span(name):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            for dev in {t.device for t in tensors(out) if t.is_cuda}:
                torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
        return out

    def table(self) -> str:
        """The per-region report (the reference's GPTL timing table role)."""
        lines = [f"{'region':<24}{'calls':>8}{'total_s':>12}{'ms/call':>12}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot, n = self.totals[name], self.counts[name]
            lines.append(f"{name:<24}{n:>8}{tot:>12.3f}{tot/n*1e3:>12.2f}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
