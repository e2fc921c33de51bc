"""The traced window: torch.profiler over it, and the reduction of its
device activity to the record that metrics/ read.

Device time is the union of the intervals of the device's kernels,
copies and fills inside the window; the window is the span
`bench.window` that the entry opens around its steps (after a device
synchronise at both ends), cut where the program's own span `cut_after`
(the driver's "graph_capture") last ends inside it.
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch

WINDOW_SPAN = "bench.window"
_BUSY = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler():
    """The profiler of a traced run: host spans and device activity, no
    shapes or stacks."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False)


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: "void k4_wind_kernel<float>(...)" -> "k4_wind_kernel"."""
    name = re.sub(r"^void\s+", "", name.strip())
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).split("::")[-1].strip() or name


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce_events(device, spans, cut_after: str | None = None) -> dict:
    """The record of one traced window from raw events.

    device: [(kind, name, start_ns, end_ns)] of the device's activity
    (kind "kernel", "gpu_memcpy", "gpu_memset"); spans: [(name, start_ns,
    end_ns)] of the host's spans. Returns window_s, busy_s, kernels (count
    in the window), kernel_s ({short name: [calls, seconds]}) and
    idle_gaps ([[host span, seconds]], the idle time under each innermost
    host span, longest first)."""
    win = [s for s in spans if s[0] == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    w0, w1 = win[-1][1], win[-1][2]
    if cut_after:
        ends = [e for n, s, e in spans if n == cut_after and w0 <= e <= w1]
        if ends:
            w0 = max(ends)
    inside = [(k, n, max(s, w0), min(e, w1)) for k, n, s, e in device
              if e > w0 and s < w1]
    kernel_s = defaultdict(lambda: [0, 0.0])
    n_kernels = 0
    for k, n, s, e in inside:
        if k == "kernel":
            n_kernels += 1
            row = kernel_s[short_name(n)]
            row[0] += 1
            row[1] += (e - s) * 1e-9
    merged = _union([(s, e) for _, _, s, e in inside if e > s])
    busy = sum(e - s for s, e in merged)
    gaps, t = [], w0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    host = sorted((s, e, n) for n, s, e in spans if n != WINDOW_SPAN)
    idle = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        under = [(hs, n) for hs, he, n in host if hs <= mid <= he]
        idle[max(under)[1] if under else WINDOW_SPAN] += (e - s) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "kernels": n_kernels, "kernel_s": dict(kernel_s),
            "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                key=lambda r: -r[1])}


def _kind(e) -> str | None:
    """A device event's kind: "kernel", "gpu_memcpy" or "gpu_memset";
    None for the device's spans. Older profilers have no activity_type:
    copies and fills are then told by their names."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return kind if kind in _BUSY else None
    if e.is_user_annotation():
        return None
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def events_of(prof):
    """(device, spans) of a finished torch.profiler run, as reduce_events
    takes them."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kind = _kind(e)
            if kind is not None:
                device.append((kind, e.name(), e.start_ns(), e.end_ns()))
        elif e.is_user_annotation():
            spans.append((e.name(), e.start_ns(), e.end_ns()))
    return device, spans


def breakdown(record: dict) -> dict:
    """The result line's breakdown: the ten device operations that took
    most time and the ten host spans with most idle device time under
    them."""
    ops = sorted(([n, r[1]] for n, r in record["kernel_s"].items()),
                 key=lambda r: -r[1])
    return {"device_ops": ops[:10], "idle_gaps": record["idle_gaps"][:10]}
