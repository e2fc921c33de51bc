"""The program's spans in the traced window (harness/spans.py) and the
metrics that read them: nested spans, a span cut by the window's
`cut_after`, idle time outside every span, several calls a step; the
markers leave every other number of the record as it was; the metrics'
arithmetic and their None where there is nothing to read. On the card
(`cuda`), a traced run of each cell at a tiny grid marks every span of
its step."""

import types

import pytest
import torch

from benchmark.harness import spans, trace
from benchmark.harness.spec import metric_reader

from .conftest import TINY

NAMES = ("outer", "inner", "other")


def _ns(ms):
    return int(ms * 1e6)


def _mark(i, edge, at_ms):
    # a marker of 0.001 ms, named as the profiler names it
    return ("kernel", f"void span_mark_kernel<{i}, {edge}>()", _ns(at_ms),
            _ns(at_ms + 0.001))


def _k(s_ms, e_ms, kind="kernel", name="k4_wind_kernel"):
    return (kind, name, _ns(s_ms), _ns(e_ms))


def _events():
    """Two steps of 10 ms in a window of 0-20 ms, cut after a capture
    that ends at 1 ms. A step: "outer" 1-6 ms (a copy 1.5-2, kernels
    2-3 and 4.5-5.5) holds "inner" twice, 2-3.5 and 4-5 (a kernel 4.5-5.5
    crossing its exit); "other" 7-8 (a kernel 7-7.5); a kernel outside
    every span at 9-9.5. The first step's "outer" opens at 0.5, before
    the cut; "other" runs at 0.1-0.3 too, wholly before it."""
    device = [_mark(2, 0, 0.1), _mark(2, 1, 0.3)]
    for step, t in enumerate((0.0, 10.0)):
        o0 = 0.5 if step == 0 else t + 1.0
        device += [_mark(0, 0, o0), _mark(0, 1, t + 6.0),
                   _mark(1, 0, t + 2.0), _mark(1, 1, t + 3.5),
                   _mark(1, 0, t + 4.0), _mark(1, 1, t + 5.0),
                   _mark(2, 0, t + 7.0), _mark(2, 1, t + 8.0),
                   _k(t + 1.5, t + 2.0, "gpu_memcpy", "Memcpy DtoD"),
                   _k(t + 2.2, t + 3.0), _k(t + 4.5, t + 5.5),
                   _k(t + 7.0, t + 7.5), _k(t + 9.0, t + 9.5)]
    host = [(trace.WINDOW_SPAN, 0, _ns(20.0)),
            ("graph_capture", 0, _ns(1.0))]
    return device, host


def _table():
    device, host = _events()
    markers, rest = spans.split_markers(device)
    return spans.table(markers, rest, host, "graph_capture", names=NAMES)


def test_split_markers_keeps_the_record_as_without_them():
    device, host = _events()
    markers, rest = spans.split_markers(device)
    assert len(markers) == 18 and len(rest) == 10
    assert rest == [e for e in device if "span_mark" not in e[1]]
    assert trace.reduce_events(rest, host, "graph_capture") == \
        trace.reduce_events([e for e in device if "span_mark" not in e[1]],
                            host, "graph_capture")
    # the markers in the window (all but the first three) would count
    assert trace.reduce_events(device, host, "graph_capture")["kernels"] \
        == 8 + 15


def test_nested_spans_and_calls():
    t = _table()
    assert set(t) == {"outer", "inner", "other", "outside"}
    # outer: 1-6.001 ms in step 1 (cut at 1 ms), 11-16.001 in step 2: two
    # calls (the first's midpoint lies after the cut); "other" at 0.1-0.3
    # ms lies before the cut: neither a call nor time
    assert t["outer"]["calls"] == 2 and t["outer"]["parent"] is None
    assert t["outer"]["busy_s"] == pytest.approx(2 * 2.3e-3)
    assert t["outer"]["idle_s"] == pytest.approx(2 * 5.001e-3 - 2 * 2.3e-3)
    assert t["outer"]["kernels"] == 4
    # inner: twice a step; its busy time stops at its exit marker (5.001)
    assert t["inner"]["calls"] == 4 and t["inner"]["parent"] == "outer"
    assert t["inner"]["busy_s"] == pytest.approx(2 * (0.8 + 0.501) * 1e-3)
    assert t["inner"]["kernels"] == 4
    assert t["other"]["calls"] == 2 and t["other"]["parent"] is None
    assert t["other"]["busy_s"] == pytest.approx(2 * 0.5e-3)


def test_outside_every_span_and_the_sum():
    device, host = _events()
    markers, rest = spans.split_markers(device)
    rec = trace.reduce_events(rest, host, "graph_capture")
    t = _table()
    # outside every span: the kernel at 9-9.5 ms of each step
    assert t["outside"]["busy_s"] == pytest.approx(2 * 0.5e-3)
    top = sum(r["busy_s"] for n, r in t.items()
              if n != "outside" and r["parent"] is None)
    assert top + t["outside"]["busy_s"] == pytest.approx(rec["busy_s"])
    spanned = 2 * 5.001e-3 + 2 * 1.001e-3
    assert t["outside"]["idle_s"] == pytest.approx(
        rec["window_s"] - spanned - t["outside"]["busy_s"])
    # between the first span (1 ms) and the last (18.001 ms): 6.001-7,
    # 8.001-11 less the kernel at 9-9.5, 16.001-17; the tail 18.001-20
    # (less 19-19.5) is the window's
    assert t["outside"]["between_idle_s"] == pytest.approx(4.497e-3)


def test_no_markers_no_table():
    device, host = _events()
    _, rest = spans.split_markers(device)
    assert spans.table([], rest, host, "graph_capture", names=NAMES) == {}
    # markers only before the cut
    assert spans.table([(0, 0, 1, 2), (0, 1, 3, 4)], rest, host,
                       "graph_capture", names=NAMES) == {}
    # an index past the table keeps a name of its own; an entry without
    # its exit drops
    assert set(spans.table([(7, 0, 1, 2), (7, 1, 3, 4), (1, 0, 5, 6)],
                           rest, host, names=NAMES)) == {"span7", "outside"}


def test_a_dropped_first_entry_opens_at_the_window_start():
    # the profiler lost the first marker of a window with no cut: "outer"
    # then opens at the window's start, 0 ms; its later calls pair as ever
    device, host = _events()
    host = host[:1]
    device = [e for e in device if e[2] != _ns(0.5)]
    markers, rest = spans.split_markers(device)
    t = spans.table(markers, rest, host, names=NAMES)
    assert t["outer"]["calls"] == 2
    assert t["outer"]["busy_s"] == pytest.approx(2 * 2.3e-3)
    assert t["outer"]["idle_s"] == pytest.approx(
        6.001e-3 + 5.001e-3 - 2 * 2.3e-3)
    # a lost entry later on loses that call only
    device = [e for e in _events()[0] if e[2] != _ns(11.0)]
    markers, rest = spans.split_markers(device)
    t = spans.table(markers, rest, host, names=NAMES)
    assert t["outer"]["calls"] == 1 and t["inner"]["calls"] == 4


def test_marker_names_agree_with_the_program():
    from cam_nor_physics_tpu_torch.utils import timing
    assert spans.program_spans() == timing.SPANS
    for i, name in enumerate(timing.SPANS):
        for edge in (0, 1):
            kernel = f"void {timing.marker_name(name, edge)}()"
            assert spans.split_markers([("kernel", kernel, 1, 2)]) == (
                [(i, edge, 1, 2)], [])


def _record(steps=2):
    device, host = _events()
    markers, rest = spans.split_markers(device)
    rec = trace.reduce_events(rest, host, "graph_capture")
    rec["spans"] = spans.table(markers, rest, host, "graph_capture",
                               names=("zm_conv_tend", "dyn_run", "x"))
    rec.update(steps=steps, device_name="cpu", config={})
    return rec


def test_span_metrics_arithmetic():
    rec = _record()
    # zm_conv_tend plays "outer", dyn_run "inner": busy ms a step
    assert metric_reader("zm_device_ms")(rec) == pytest.approx(2.3)
    assert metric_reader("dyn_run_device_ms")(rec) == pytest.approx(1.301)
    assert metric_reader("host_gap_ms")(rec) == pytest.approx(4.497 / 2)


@pytest.mark.parametrize("name", ["zm_device_ms", "dyn_run_device_ms",
                                  "host_gap_ms"])
def test_span_metrics_read_none_without_their_span(name):
    assert metric_reader(name)(_record(steps=0)) is None
    rec = _record()
    rec["spans"] = {}
    assert metric_reader(name)(rec) is None
    del rec["spans"]
    assert metric_reader(name)(rec) is None
    rec = _record()
    rec["spans"] = {"x": rec["spans"]["x"]}
    assert metric_reader(name)(rec) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload,config,expect", [
    ("aqua_f19.monthly_hist", "aqua_f19",
     ("zm_device_ms", "dyn_run_device_ms", "host_gap_ms")),
    ("hs_f05.climate", "hs_f05", ("dyn_run_device_ms", "host_gap_ms"))])
def test_traced_run_on_the_card_reads_every_span(workload, config, expect):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import run
    from benchmark.tools.span_table import span_table, traced_run
    from cam_nor_physics_tpu_torch.utils import timing
    args = run.parse_args(["--workload", workload, "--seed", "2147483663",
                           "--seconds", "2", "--trace", "1"])
    result, lines, record = traced_run(args, device="cuda",
                                       overrides={"grid": TINY[config]})
    assert result["correct"] is True, lines
    t = span_table(record)
    assert all(t["metrics"][m] is not None for m in expect)
    assert t["markers"] > 0
    steps = (("phys_run1", "zm_conv_tend", "phys_run2", "p_d_coupling",
              "d_p_coupling", "atm_diagnostics", "history_accumulate")
             if workload.startswith("aqua") else ("hs_forcing",))
    for name in steps + ("dyn_run", "te_map"):
        assert name in timing.SPANS
        assert t["spans"][name]["calls"] == t["steps"], name
    assert t["outermost_plus_outside_busy_ms"] == pytest.approx(
        t["busy_ms"], rel=1e-3)


def test_span_table_tool_splits_the_markers_off(monkeypatch):
    # the tool's run reduces the window without its markers, keeps them
    # for the span table, and leaves the harness as it found it
    from benchmark import run
    from benchmark.harness import cell
    from benchmark.harness import spec as specs
    from benchmark.tools import span_table as tool
    device, host = _events()
    entry = specs.entry_module(specs.load_cell("aqua_f19.monthly_hist")[2])

    def measure(ctx):
        rec = cell.reduce_events(device, host, cut_after="graph_capture")
        return types.SimpleNamespace(record=dict(rec, steps=2))
    monkeypatch.setattr(entry, "measure", measure)
    monkeypatch.setattr(run, "run_cell", lambda args, device=None,
                        overrides=None: (entry.measure(None), ["line"]))
    reduce_events = cell.reduce_events
    args = run.parse_args(["--workload", "aqua_f19.monthly_hist", "--seed",
                           "1", "--seconds", "1", "--trace", "1"])
    _, lines, record = tool.traced_run(args)
    assert cell.reduce_events is reduce_events and entry.measure is measure
    markers, rest = spans.split_markers(device)
    assert record["kernels"] == 8 and record["markers"] == 15
    assert {k: v for k, v in record.items() if k in trace.reduce_events(
        rest, host, "graph_capture")} == trace.reduce_events(
            rest, host, "graph_capture")
    assert record["spans"] == spans.table(markers, rest, host,
                                          "graph_capture")
    t = tool.span_table(record)
    assert t["markers"] == 7.5 and set(t["metrics"]) == set(
        tool.SPAN_METRICS)
