"""The program's spans on the device: a traced window's span table, read
from the marker kernels that the port's `utils/timing.span` enqueues at
a span's entry and exit while a profiler records. tools/span_table.py
adds it to a traced run's record as "spans", which the span metrics of
metrics/ read; cell.window reduces every event of its window, markers
included, and adds no table.

A marker is a kernel named `span_mark_kernel<S, E>`: S is the span's
index in the program's table `timing.SPANS`, E 0 at the entry and 1 at
the exit. On one stream the kernels between a span's two markers are the
span's, in an eager step and in a CUDA graph's replay alike. The markers
are split off the device's events first (`split_markers`), so that the
window's other numbers (trace.reduce_events of the rest) are those of a
trace without them. A span's interval runs from the start of its entry
marker to the end of its exit marker; its intervals are cut to the
window as reduce_events cuts it (after the program's span `cut_after`).

For each span: `calls` (its intervals whose midpoint lies inside the
window: the device's clock, as the profiler converts it, and the host's
differ by up to about a millisecond, so an edge is not counted by where
it lies), `kernels` (kernels that start inside its intervals), `busy_s`
(the union of the device's kernels, copies and fills inside its
intervals), `idle_s` (the rest of its intervals) and `parent` (the
innermost other span around it, None at the top). `outside`: the device's `busy_s` and `idle_s`
outside every span, and `between_idle_s`, the part of that idle time
between the window's first span and its last: the window's head and
tail (the profiler's first launches, a driver call's close after its
last replay) are once a window, not once a step. A program without
markers in the window gives {}.
"""

from __future__ import annotations

import bisect
import re

from .trace import WINDOW_SPAN, _union

MARKER = re.compile(r"span_mark_kernel<\s*(\d+)\s*,\s*(\d+)\s*>")
OUTSIDE = "outside"


def program_spans() -> tuple:
    """The program's table of span names (`timing.SPANS`), () where it has
    none."""
    try:
        from cam_nor_physics_tpu_torch.utils import timing
    except ImportError:
        return ()
    return tuple(getattr(timing, "SPANS", ()))


def split_markers(device):
    """(markers, the other events) of reduce_events' device events;
    markers as [(span index, edge, start_ns, end_ns)]."""
    markers, rest = [], []
    for ev in device:
        m = MARKER.search(ev[1]) if ev[0] == "kernel" else None
        if m is None:
            rest.append(ev)
        else:
            markers.append((int(m.group(1)), int(m.group(2)), ev[2], ev[3]))
    return markers, rest


def window_edges(spans, cut_after: str | None = None):
    """(start, end) in ns of the window as reduce_events takes it."""
    win = [s for s in spans if s[0] == WINDOW_SPAN]
    if not win:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    w0, w1 = win[-1][1], win[-1][2]
    if cut_after:
        ends = [e for n, s, e in spans if n == cut_after and w0 <= e <= w1]
        if ends:
            w0 = max(ends)
    return w0, w1


def _intervals(markers, names, w0=None):
    """{span name: [(open start, close end)]}, entries paired with exits
    in time order. The profiler now and then drops the first records of
    its session: an exit that is its span's first marker and ends inside
    the window opens at the window's start `w0`. Any other edge without
    its pair is dropped."""
    open_, out, seen = {}, {}, set()
    for i, edge, s, e in sorted(markers, key=lambda m: (m[2], m[3])):
        name = names[i] if i < len(names) else f"span{i}"
        first = name not in seen
        seen.add(name)
        if edge == 0:
            open_.setdefault(name, []).append(s)
        elif open_.get(name):
            out.setdefault(name, []).append((open_[name].pop(), e))
        elif first and w0 is not None and e > w0:
            out.setdefault(name, []).append((w0, e))
    return out


class _Busy:
    """The device's busy intervals (merged, sorted) with their running
    length, for the busy time inside any interval in O(log n)."""

    def __init__(self, merged):
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.cum = [0]
        for s, e in merged:
            self.cum.append(self.cum[-1] + e - s)

    def within(self, s, e) -> int:
        """Busy ns inside [s, e)."""
        i = bisect.bisect_right(self.ends, s)
        j = bisect.bisect_left(self.starts, e)
        if i >= j:
            return 0
        return (self.cum[j] - self.cum[i] - max(0, s - self.starts[i])
                - max(0, self.ends[j - 1] - e))


def _parent(first, intervals, own):
    """The innermost other span whose interval holds `first`."""
    s, e = first
    around = [(s2, n) for n, ivs in intervals.items() if n != own
              for s2, e2 in ivs if s2 <= s and e <= e2]
    return max(around)[1] if around else None


def table(markers, device, spans, cut_after: str | None = None,
          names: tuple | None = None) -> dict:
    """The record's "spans" from the window's markers and other device
    events (split_markers) and the host's spans (as reduce_events takes
    them); `names` defaults to the program's table."""
    if not markers:
        return {}
    names = program_spans() if names is None else names
    w0, w1 = window_edges(spans, cut_after)
    busy = _Busy(_union([(max(s, w0), min(e, w1)) for _, _, s, e in device
                         if e > w0 and s < w1]))
    starts = sorted(s for k, _, s, _ in device
                    if k == "kernel" and w0 <= s < w1)
    intervals = _intervals(markers, names, w0)

    def cut(ivs):
        return _union([(max(s, w0), min(e, w1)) for s, e in ivs
                       if e > w0 and s < w1])
    out = {}
    for name, ivs in intervals.items():
        mine = cut(ivs)
        if not mine:
            continue
        length = sum(e - s for s, e in mine)
        inside = sum(busy.within(s, e) for s, e in mine)
        out[name] = {
            "calls": sum(w0 <= (s + e) // 2 < w1 for s, e in ivs),
            "kernels": sum(bisect.bisect_left(starts, e)
                           - bisect.bisect_left(starts, s) for s, e in mine),
            "busy_s": inside * 1e-9, "idle_s": (length - inside) * 1e-9,
            "parent": _parent(ivs[0], intervals, name)}
    every = cut([iv for ivs in intervals.values() for iv in ivs])
    if not every:
        return {}
    outside = busy.cum[-1] - sum(busy.within(s, e) for s, e in every)
    idle = w1 - w0 - sum(e - s for s, e in every) - outside
    first, last = every[0][0], every[-1][1]
    edges = (first - w0 - busy.within(w0, first)
             + w1 - last - busy.within(last, w1))
    out[OUTSIDE] = {"busy_s": outside * 1e-9, "idle_s": idle * 1e-9,
                    "between_idle_s": (idle - edges) * 1e-9}
    return out
