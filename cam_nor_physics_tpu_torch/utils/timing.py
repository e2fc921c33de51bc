"""Phase timing: the perf_mod (GPTL t_startf/t_stopf) role.

Twin of `cam_nor_physics_tpu.utils.timing`. `PhaseTimer` keeps a host-side
wall-time table by named region, as the reference prints one. `region`
tags the block for torch.profiler traces (`record_function`); `timed`
runs a function and waits for the device before it stops the clock
(`torch.cuda.synchronize` of every CUDA device its outputs live on), so
a region times the work and not only its launches.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class PhaseTimer:
    """Accumulating region timer (t_startf/t_stopf role)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def region(self, name: str):
        """Time a block on the host clock; the block waits for the device
        itself where it must (a host read does)."""
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait until its outputs are ready on the device, record
        the wall time; returns fn's result."""
        from ..bench import tensors
        with torch.profiler.record_function(name):
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
