"""One traced run of a cell, as `benchmark/run.py --trace 1` makes it,
and the program's span table of its traced window beside the result
line: for each span of the program (the port's `utils/timing.SPANS`,
read from their marker kernels by harness/spans.py) its calls, kernels,
device busy and idle ms a step and the span around it, the device's
time outside every span, and the window's busy, idle, kernels and
markers a step; the span metrics of metrics/ (`zm_device_ms`,
`dyn_run_device_ms`, `host_gap_ms`) read from that table; and where the
idle time outside every span lies: each stretch between two top-level
spans, grouped by the spans before and after it, and the largest.

    python3 benchmark/tools/span_table.py --workload aqua_f19.monthly_hist \
        --seed 7 --seconds 15 [--out spans_aqua_7.json]

The run's markers are split off the device's events before the window
is reduced (harness/spans.split_markers), so that the result line's
metrics are those of a trace without them; run.py itself, whose
harness/cell.window reduces every event of the window, counts each
marker as a kernel ("markers" a step in the table says how many).

Prints run.py's lines (standard error), its result line, then one JSON
line with the table; --out writes both to a file too. A program that
marks no spans gives an empty table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import run  # noqa: E402
from benchmark.harness import cell, spans, trace  # noqa: E402
from benchmark.harness import spec as specs  # noqa: E402

SPAN_METRICS = ("zm_device_ms", "dyn_run_device_ms", "host_gap_ms")


def span_table(record: dict) -> dict:
    """The traced window's span table, in ms a step."""
    n = record["steps"]
    rows = {name: {k: (1e3 * v / n if k.endswith("_s") else v)
                   for k, v in row.items()}
            for name, row in record.get("spans", {}).items()}
    top = sum(r["busy_s"] for name, r in rows.items()
              if name != "outside" and r.get("parent") is None)
    return {"steps": n, "busy_ms": 1e3 * record["busy_s"] / n,
            "window_ms": 1e3 * record["window_s"] / n,
            "kernels": record["kernels"] / n,
            "markers": record.get("markers", 0) / n,
            "metrics": {m: specs.metric_reader(m)(record)
                        for m in SPAN_METRICS},
            "outermost_plus_outside_busy_ms":
                top + rows.get("outside", {}).get("busy_s", 0.0),
            "spans": rows,
            "outside_gaps": record.get("outside_gaps"),
            "idle_gaps_ms": [[k, 1e3 * v / n]
                             for k, v in record["idle_gaps"]]}


def outside_gaps(markers, device, host, cut_after=None, names=None,
                 steps=1, largest=8) -> dict:
    """The device's idle time outside every span, stretch by stretch:
    {"by_pair": [[span before, span after, stretches, idle ms a step]],
    "largest": [[idle ms, span before, span after]]}; "window start" and
    "window end" stand for the window's edges."""
    names = spans.program_spans() if names is None else names
    w0, w1 = spans.window_edges(host, cut_after)
    busy = spans._Busy(trace._union([(max(s, w0), min(e, w1))
                                     for _, _, s, e in device
                                     if e > w0 and s < w1]))
    flat = sorted((max(s, w0), min(e, w1), n)
                  for n, ivs in spans._intervals(markers, names, w0).items()
                  for s, e in ivs if e > w0 and s < w1)
    gaps, t, prev = [], w0, "window start"
    for s, e, n in flat:
        if s > t:
            gaps.append((t, s, prev, n))
        if e > t:
            t, prev = e, n
    if w1 > t:
        gaps.append((t, w1, prev, "window end"))
    idle = [((e - s - busy.within(s, e)) * 1e-6, a, b)
            for s, e, a, b in gaps]
    pairs = {}
    for ms, a, b in idle:
        row = pairs.setdefault((a, b), [a, b, 0, 0.0])
        row[2] += 1
        row[3] += ms / steps
    return {"by_pair": sorted(pairs.values(), key=lambda r: -r[3]),
            "largest": sorted(([ms, a, b] for ms, a, b in idle),
                              reverse=True)[:largest]}


def traced_run(args, device=None, overrides=None):
    """run.run_cell of `args` with --trace 1, the markers split off the
    traced window's device events before cell.window reduces them, and
    the entry's traced record kept with its "spans" (spans.table),
    "markers" (in the window) and "outside_gaps" added: (result, stderr
    lines, record)."""
    _, _, traffic = specs.load_cell(args.workload)
    entry = specs.entry_module(traffic)
    measure, reduce_events, kept = entry.measure, cell.reduce_events, {}

    def keeping(ctx):
        m = measure(ctx)
        kept["record"] = m.record
        return m

    def splitting(device, host, cut_after=None):
        markers, rest = spans.split_markers(device)
        kept["events"] = (markers, rest, host, cut_after)
        return reduce_events(rest, host, cut_after=cut_after)
    entry.measure, cell.reduce_events = keeping, splitting
    try:
        result, lines = run.run_cell(args, device=device,
                                     overrides=overrides)
    finally:
        entry.measure, cell.reduce_events = measure, reduce_events
    record = kept["record"]
    markers, rest, host, cut = kept["events"]
    w0, w1 = spans.window_edges(host, cut)
    record["spans"] = spans.table(markers, rest, host, cut)
    record["markers"] = sum(w0 <= s < w1 for _, _, s, _ in markers)
    record["outside_gaps"] = outside_gaps(markers, rest, host, cut,
                                          steps=record["steps"])
    return result, lines, record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    args = run.parse_args(["--workload", a.workload, "--seed", str(a.seed),
                           "--seconds", str(a.seconds), "--trace", "1"])
    result, lines, record = traced_run(args)
    for line in lines:
        print(line, file=sys.stderr)
    table = dict(span_table(record), workload=a.workload, seed=a.seed)
    print(json.dumps(result), flush=True)
    print(json.dumps(table), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"result": result, "table": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
