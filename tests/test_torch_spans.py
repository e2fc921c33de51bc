"""The port's spans (utils/timing.span) and their device markers.

- Under the CPU profiler, one driver.run step of the coupled aquaplanet
  (history on) and one HS large step with a climatology sample open every
  span of `timing.SPANS`, once a step, nested as the table says
  (zm_conv_tend inside phys_run1; cd_core, trac2d and te_map inside
  dyn_run; the others outside every span).
- With no profiler a span is one shared null context: no profiler op, no
  marker. With one, a name of SPANS launches its two markers where CUDA
  is in use and none where it is not; other names none.
- Every span's marker names round-trip to (span, edge); the marker
  library, built as host C++ with g++, launches exactly one kernel for
  every (span, edge) and refuses the rest.
- On the card (`cuda`): a two-step ChainGraph captured under the
  profiler replays two markers per span and step; one captured without
  it replays none. This file imports no JAX, so on a card without JAX:
  `python -c "import sys; sys.path[:0] = ['.', 'tests']; import
  test_torch_spans as t; t.test_graph_markers_follow_the_profiler()"`.
"""

import tempfile
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cam_nor_physics_tpu_torch.utils import timing
from cam_nor_physics_tpu_torch.utils.config import FVConfig

pytest_plugins = ("torch_port_plugin",)

# each span's enclosing span of SPANS (None: outside every span)
PARENT = {"zm_conv_tend": "phys_run1", "cd_core": "dyn_run",
          "trac2d": "dyn_run", "te_map": "dyn_run"}
# the spans of one coupled step (atm_step), and of one HS step with its
# sample; the driver adds history_accumulate
DYCORE_SPANS = ("dyn_run", "cd_core", "trac2d", "te_map")
STEP_SPANS = ("phys_run1", "zm_conv_tend", "phys_run2", "p_d_coupling",
              *DYCORE_SPANS, "d_p_coupling", "atm_diagnostics")
HS_SPANS = (*DYCORE_SPANS, "hs_forcing", "climo_update")
# one cd_core and one trac2d call a step (n2 = 1, nv = 1)
SPLITS = FVConfig(nsplit=2, nspltrac=1)


def _annotations(prof):
    """[(name, start_ns, end_ns)] of the profiler's host spans of SPANS."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name() in timing.SPANS]


def _parent(span, spans):
    """The innermost other span of `spans` that holds `span`, or None."""
    name, s, e = span
    outer = [(s2, n2) for n2, s2, e2 in spans
             if (s2, e2) != (s, e) and s2 <= s and e <= e2]
    return max(outer)[1] if outer else None


def _coupled(device):
    from cam_nor_physics_tpu_torch.entry import build_coupled
    from cam_nor_physics_tpu_torch.models.coupling.surface_fluxes import \
        bulk_surface_fluxes
    dtype = torch.float64 if device == "cpu" else torch.float32
    model, step, state, sst = build_coupled(12, 8, 4, dtype, device,
                                            fv_cfg=SPLITS)
    cam_in = bulk_surface_fluxes(state.phys, sst, model.registry.pcnst)
    return model, step, state, cam_in


def _hs_step_and_sample():
    from cam_nor_physics_tpu_torch.entry import build_step
    from cam_nor_physics_tpu_torch.models.fv.cd_core import (d2a_winds,
                                                            pressure_vars)
    from cam_nor_physics_tpu_torch.utils.climatology import (climo_init,
                                                             climo_update)
    step, state, grid, coord, phis = build_step(12, 8, 4, torch.float64,
                                                "cpu", cfg=SPLITS)
    state = step(state, grid, coord, phis)
    ua, va = d2a_winds(state.u, state.v)
    pe, _, pkz, _ = pressure_vars(state.delp, coord.ptop)
    acc = climo_update(climo_init(4, 8, dtype=torch.float64, device="cpu"),
                       ua, va, state.pt * pkz, 0.5 * (pe[1:] + pe[:-1]))
    assert float(acc["count"]) == 1.0


def test_every_span_opens_once_a_step_where_the_table_says():
    from cam_nor_physics_tpu_torch import driver
    model, _, state, cam_in = _coupled("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            tempfile.TemporaryDirectory() as out_dir:
        driver.run(model, state, cam_in, 1, out_dir=out_dir, hist_every=2,
                   check_every=0)
        _hs_step_and_sample()
    spans = _annotations(prof)
    for span in spans:
        assert _parent(span, spans) == PARENT.get(span[0]), span[0]
    assert Counter(n for n, _, _ in spans) == Counter(
        STEP_SPANS + ("history_accumulate",) + HS_SPANS)
    assert set(STEP_SPANS + HS_SPANS) | {"history_accumulate"} == \
        set(timing.SPANS)


@pytest.fixture
def no_markers(monkeypatch):
    """timing._mark replaced by a recorder of its calls."""
    marks = []
    monkeypatch.setattr(timing, "_mark", lambda i, e: marks.append((i, e)))
    return marks


def test_span_off_the_profiler_does_nothing(monkeypatch, no_markers):
    def refused(*a, **k):
        raise AssertionError("a profiler op ran with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert timing.span("dyn_run") is timing.span("no_such_span")

    @timing.spanned("te_map")
    def work(x):
        return x + 1
    with timing.span("dyn_run"):
        assert work(1) == 2
    timer = timing.PhaseTimer()
    with timer.region("atm_step"):
        timer.timed("outfld", work, 2)
    assert no_markers == [] and timer.counts == {"atm_step": 1, "outfld": 1}


@pytest.mark.parametrize("cuda_in_use", [False, True])
def test_span_under_the_profiler_marks_names_of_spans(monkeypatch,
                                                      no_markers,
                                                      cuda_in_use):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda_in_use)
    i = timing.SPANS.index("cd_core")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("cd_core"):
            no_markers.append("inside")
        with timing.span("no_such_span"):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names == ["cd_core", "no_such_span"]
    assert no_markers == ([(i, 0), "inside", (i, 1)] if cuda_in_use
                          else ["inside"])


@pytest.mark.parametrize("name", timing.SPANS)
def test_marker_names_round_trip(name):
    for edge in (0, 1):
        short = timing.marker_name(name, edge)
        for full in (f"void {short}()",
                     f"void (anonymous namespace)::{short}()", short):
            assert timing.parse_marker(full) == (name, edge)
    assert timing.parse_marker(f"void {name}_kernel<float>()") is None


def test_marker_library_launches_one_kernel_a_mark(tmp_path):
    from cam_nor_physics_tpu_torch.ops import cuda_build
    from torch_port_util import host_build
    src = (cuda_build.CSRC / "span_kernels.cu").read_text()
    assert f"kMaxSpans = {timing.MAX_SPANS};" in src
    assert len(timing.SPANS) <= timing.MAX_SPANS
    assert len(set(timing.SPANS)) == len(timing.SPANS)
    assert "span_mark_kernel" in cuda_build.kernel_names()
    lib = host_build("span_kernels", tmp_path, 2)
    # the count is the process's (an inline variable, shared by every
    # host-built library a test worker has loaded)
    before = lib.cam_host_launches()
    for span in range(timing.MAX_SPANS):
        for edge in (0, 1):
            assert lib.cam_span_mark(span, edge, None) == 0
    assert lib.cam_host_launches() == before + 2 * timing.MAX_SPANS
    for span, edge in ((-1, 0), (timing.MAX_SPANS, 0), (0, 2)):
        assert lib.cam_span_mark(span, edge, None) != 0
    assert lib.cam_host_launches() == before + 2 * timing.MAX_SPANS


def _replay_markers(graph) -> dict:
    """{(span, edge): markers} of one replay of `graph` under the
    profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            key = timing.parse_marker(e.name())
            if key is not None:
                out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.cuda
def test_graph_markers_follow_the_profiler():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cam_nor_physics_tpu_torch.bench import ChainGraph
    _, step, state, _ = _coupled("cuda")
    state = step(state, first_step=True)[0]

    def one(s):
        return (step(s)[0],)
    one(state)                          # every library loaded
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        marked = ChainGraph(one, (state,), 2)
    unmarked = ChainGraph(one, (state,), 2)
    assert _replay_markers(marked) == {(name, edge): 2
                                       for name in STEP_SPANS
                                       for edge in (0, 1)}
    assert _replay_markers(unmarked) == {}
