"""The arithmetic of the metrics: sypd, mfu, the idle share from
intervals, the roofline share, launches and the dycore's kernel time."""

import pytest

from benchmark.harness import trace
from benchmark.harness.cell import Measured
from benchmark.harness.spec import metric_reader
from benchmark.harness.work import bound_s, peaks

H100 = "NVIDIA H100 80GB HBM3"


def test_sypd_is_simulated_years_per_wall_day():
    # 48 steps of 1800 s are a day: a year of steps in a wall day is 1
    m = Measured(steps=48 * 365, window_s=86400.0, setup_s=3.0)
    e2e = m.end_to_end({"dt": 1800.0})
    assert e2e["sypd"] == pytest.approx(1.0)
    assert e2e["setup_s"] == 3.0
    m = Measured(steps=200, window_s=10.0, setup_s=0.0)
    assert m.end_to_end({"dt": 1800.0})["sypd"] == pytest.approx(
        200 * 1800 / (365 * 86400) / (10.0 / 86400))


def _ns(s):
    return int(s * 1e9)


def _record():
    # a 1 s window: two overlapping kernels 0.1-0.3 and 0.2-0.4 s, a copy
    # 0.6-0.7 s; the host in "h_write" 0.4-0.6 s, in "h_step" after
    device = [("kernel", "void k4_wind_kernel<float>(float*, int)",
               _ns(0.1), _ns(0.3)),
              ("kernel", "void zm_tail_kernel<float>(Args)", _ns(0.2),
               _ns(0.4)),
              ("gpu_memcpy", "Memcpy DtoH", _ns(0.6), _ns(0.7)),
              ("kernel", "void k1_winds_kernel<float>()", _ns(1.5),
               _ns(1.6))]
    spans = [(trace.WINDOW_SPAN, 0, _ns(1.0)),
             ("h_write", _ns(0.4), _ns(0.6)),
             ("h_step", _ns(0.7), _ns(1.0))]
    return trace.reduce_events(device, spans)


def test_idle_share_from_the_union_of_intervals():
    r = _record()
    assert r["window_s"] == pytest.approx(1.0)
    assert r["busy_s"] == pytest.approx(0.4)      # 0.1-0.4 and 0.6-0.7
    assert r["kernels"] == 2                      # the third is outside
    gaps = dict(r["idle_gaps"])
    assert gaps["h_write"] == pytest.approx(0.2)
    assert gaps["h_step"] == pytest.approx(0.3)
    assert gaps[trace.WINDOW_SPAN] == pytest.approx(0.1)
    r.update(steps=2, device_name=H100, config={})
    assert metric_reader("device_idle_pct")(r) == pytest.approx(60.0)


def test_cut_after_the_programs_span():
    device = [("kernel", "k4_wind_kernel", _ns(0.1), _ns(0.2)),
              ("kernel", "k4_wind_kernel", _ns(0.6), _ns(0.8))]
    spans = [(trace.WINDOW_SPAN, 0, _ns(1.0)),
             ("graph_capture", _ns(0.05), _ns(0.5))]
    r = trace.reduce_events(device, spans, cut_after="graph_capture")
    assert r["window_s"] == pytest.approx(0.5)
    assert r["busy_s"] == pytest.approx(0.2) and r["kernels"] == 1


def test_kernel_names_and_per_step_metrics():
    assert trace.short_name("void k4_wind_kernel<float, 3>(float*, "
                            "int)") == "k4_wind_kernel"
    assert trace.short_name("at::native::vectorized_elementwise_kernel<4,"
                            " Op>(int, Op)") == "vectorized_elementwise_kernel"
    r = _record()
    r.update(steps=2, device_name=H100, config={})
    assert metric_reader("launches_per_step")(r) == 1.0
    # k4_wind_kernel is the dycore's, 0.2 s over 2 steps
    assert metric_reader("dycore_kernel_ms")(r) == pytest.approx(100.0)


def test_mfu_and_roofline_share():
    pk = peaks(H100)
    r = _record()
    work = {"ops_per_step": 67e12 * 0.01,
            "kernels": {"k4": [2, 2 * 3.35e12 * 0.01, 1.0],
                        "zm_tail": [1, 0.0, 67e12 * 0.02]}}
    # mfu reads the untraced window: 4 steps of 1% of a second's peak
    # operations in 2 s; the roofline the traced one (2 steps)
    r.update(steps=2, device_name=H100, config={"work": work},
             host_steps=4, host_window_s=2.0)
    assert metric_reader("mfu")(r) == pytest.approx(2.0)
    # bounds a step: 2 x 0.01 s (bytes) + 0.02 s (operations) = 0.04 s;
    # over 2 steps 0.08 s against the port's kernels' 0.4 s
    assert bound_s(3.35e12 * 0.01, 1.0, pk) == pytest.approx(0.01)
    assert metric_reader("kernels_roofline_pct")(r) == pytest.approx(20.0)


def test_nothing_to_read_reads_none():
    r = trace.reduce_events([], [(trace.WINDOW_SPAN, 0, _ns(1.0))])
    r.update(steps=3, device_name="cpu", host_steps=3, host_window_s=1.0,
             config={"work": {"ops_per_step": 1.0,
                              "kernels": {"k1": [1, 1, 1.0]}}})
    for name in ("mfu", "launches_per_step", "dycore_kernel_ms",
                 "kernels_roofline_pct", "device_idle_pct"):
        assert metric_reader(name)(r) is None
