"""The port's long runs (cam_nor_physics_tpu_torch/tools/) against the
JAX package's, on the CPU in float64.

- hs_climate (the twin of tools/hs_climate.py) at 24x16x4 for 1 day
  with 0.5 days of spin-up and a sample every 4 steps, at
  div24del2flag 22 (FVConfig()'s) and 2: every climatology field within
  1e-9 of its max, each HS94 check's value within 1e-9 relative and the
  same ok flags.
- jw_baroclinic (the twin of tools/jw_baroclinic.py) at 24x16x6 for 1
  day at FVConfig() and at flag 2: ps_min, max|u| and the mass-weighted
  eddy kinetic energy within 1e-9 relative.
- main() of both tools at a tiny size on the CPU prints one JSON line
  with the JAX tools' keys.
- On the card only (marked cuda and slow): jw06_envelope, the twin of
  tests/test_baroclinic_wave.py::test_nine_day_cyclogenesis_envelope,
  passes that test's checks.

JAX's side is the tools' loops in float64 (tests/torch_port_long_ref.py,
four fresh interpreters started at once, one a configuration, ~20 s warm)
while the port runs its four; the results are computed once a session
(torch_port_util.session_result) for all four parity cases. The port
runs its default fused fft small step (the kernels' plain versions on
the CPU), JAX its unfused XLA step with the same filter; measured errors
are 1e-11 or less (printed with pytest -s).
"""

import json

import numpy as np
import pytest
import torch

from cam_nor_physics_tpu_torch.tools import hs_climate as ths
from cam_nor_physics_tpu_torch.tools import jw_baroclinic as tjw
from torch_port_util import reference_processes, session_result

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

TOL = 1e-9
DT = 1800.0
HS = dict(shape=(24, 16, 4), dt=DT, sample_every=4, days=1.0, spinup=0.5)
JW = dict(shape=(24, 16, 6), dt=DT, days=1.0)
HS_FLAGS = (22, 2)
JW_FLAGS = (None, 2)
# the keys of the JAX tools' JSON lines (tools/hs_climate.py:106-113,
# tools/jw_baroclinic.py:84-90)
HS_KEYS = {"status", "days", "spinup", "nsamples", "checks", "wall_s"}
JW_KEYS = {"status", "series", "quiet_through_day4", "first_day_below_960",
           "wall_s"}
JOBS = [("hs", dict(HS, flags=(f,))) for f in HS_FLAGS] + \
    [("jw", dict(JW, flags=(f,))) for f in JW_FLAGS]


def _port(_cases):
    im, jm, km = HS["shape"]
    hs = {f: ths.hs_climate(HS["days"], HS["spinup"], im, jm, km, DT,
                            HS["sample_every"], f, None, "cpu",
                            torch.float64)
          for f in HS_FLAGS}
    im, jm, km = JW["shape"]
    jw = {f: tjw.jw_baroclinic(JW["days"], im, jm, km, DT, f, "cpu",
                               torch.float64)
          for f in JW_FLAGS}
    return {"hs": hs, "jw": jw}


@pytest.fixture(scope="module")
def long_runs(tmp_path_factory):
    """(the port's runs, JAX's) of every parity case."""
    def compute(root):
        got, outs = reference_processes(root, "torch_port_long_ref.py",
                                        JOBS, _port, None)
        want = {"hs": {}, "jw": {}}
        for (mode, _), out in zip(JOBS, outs):
            want[mode].update(out)
        return got, want
    return session_result(tmp_path_factory, "long_runs_reference", compute)


@pytest.mark.parametrize("flag", HS_FLAGS)
def test_hs_climate_matches_jax(long_runs, flag):
    got, want = (r["hs"][flag] for r in long_runs)
    assert got["status"] != "blowup"
    assert got["nsamples"] == want["climo"]["nsamples"] > 0
    rel = {}
    for k, w in want["climo"].items():
        g = np.asarray(got["climo"][k])
        assert g.shape == np.shape(w) and np.isfinite(g).all(), k
        scale = max(float(np.abs(w).max()), 1e-300)
        rel[k] = float(np.abs(g - w).max()) / scale
        assert rel[k] <= TOL, (k, rel[k])
    assert set(got["checks"]) == set(want["checks"])
    for k, (value, ok) in want["checks"].items():
        g = got["checks"][k]
        assert abs(g["value"] - value) <= TOL * abs(value), (k, g, value)
        assert g["ok"] == ok, (k, g, value)
    assert got["status"] == ("ok" if all(ok for _, ok in
                                         want["checks"].values())
                             else "structure-mismatch")
    print(flag, {k: f"{e:.1e}" for k, e in rel.items()})


@pytest.mark.parametrize("flag", JW_FLAGS)
def test_jw_baroclinic_matches_jax(long_runs, flag):
    got, want = (r["jw"][flag]["series"] for r in long_runs)
    assert [s["day"] for s in got] == [s["day"] for s in want] == [1.0]
    for g, w in zip(got, want):
        rel = {k: abs(g[k] - w[k]) / abs(w[k])
               for k in ("ps_min_hpa", "umax_ms", "eke")}
        assert max(rel.values()) <= TOL, (rel, g, w)
        print(flag, {k: f"{e:.1e}" for k, e in rel.items()})
    assert long_runs[0]["jw"][flag]["status"] == "ok"


def test_hs_climate_main_prints_the_jax_tools_line(tmp_path, capsys):
    out = tmp_path / "climo.npz"
    assert ths.main(["--im", "16", "--jm", "8", "--km", "3", "--days",
                     "0.25", "--spinup", "0.1", "--device", "cpu",
                     "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == HS_KEYS
    assert rec["days"] == 0.25 and rec["spinup"] == 0.1
    assert rec["nsamples"] == 2.0            # steps 4 and 8 of 12
    assert len(rec["checks"]) == 6 and all(
        set(v) == {"value", "ok"} for v in rec["checks"].values())
    with np.load(out) as climo:
        assert set(climo.files) == {"u", "v", "t", "u_var", "t_var",
                                    "nsamples"}
        assert climo["u"].shape == (3, 8)


def test_jw_baroclinic_main_prints_the_jax_tools_line(capsys):
    assert tjw.main(["--im", "16", "--jm", "8", "--km", "3", "--days",
                     "1", "--dt", "3600", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == JW_KEYS and rec["status"] == "ok"
    assert [set(s) for s in rec["series"]] == [{"day", "ps_min_hpa",
                                                "umax_ms"}]
    assert rec["series"][0]["day"] == 1.0
    assert 900.0 < rec["series"][0]["ps_min_hpa"] < 1100.0


@pytest.mark.cuda
@pytest.mark.slow
def test_jw06_envelope_on_the_card():
    """The nine-day JW06 wave at f19 in float32 at flag 2 on the card
    inside tests/test_baroclinic_wave.py's envelope."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    res = tjw.jw06_envelope()
    assert res["ok"], res
