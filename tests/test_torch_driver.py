"""The port's run driver, history tapes, checkpoints and restart against the
JAX package's, float64 on the CPU, and the driver's own contracts.

- JAX's `driver.run(model, state, cam_in, 4, hist_every=2, ckpt_every=2)`
  at 32 x 16 x 6 with FVConfig(nsplit=2, nspltrac=1) and the unfused small
  step on both sides (tests/test_driver_chunked.py:29-40's setup: q = 1e-4,
  zero phis, CamIn.zeros with shf = 5 W/m2) runs once in a fresh
  interpreter (tests/torch_port_driver_ref.py; ROADMAP R1) while the port
  runs the same. The final state is within 1e-9 of each field's max, each
  tape field within 1e-6 of its max (float32 on disk), the port's
  ckpt_000002 has JAX's leaves (count, shapes, dtypes, order) within 1e-9,
  the port resumes from JAX's ckpt_000002 to JAX's final state within 1e-9,
  and JAX's restore_checkpoint reads the port's ckpt_000002. Every
  constituent starts uniform (q = 1e-4, vapour too), so the water species'
  tendencies (DQCORE, ZMDQ, DCQ, DCCLDLIQ, DCCLDICE; about 1e-23 /s) are
  differences of nearly equal fluxes: they are held to the rate that
  changes the tracer by its max in a step (tests/test_torch_atm_comp.py's
  rule). JAX's driver traces the grid, which its matmul polar filter
  cannot take, so JAX runs the XLA (unfused) step with the FFT filter and
  the port its unfused step with the matmul filter.
- The port alone: 4 steps bitwise equal to 2 steps, a checkpoint and 2
  resumed steps at chunk 1 and 2 (tests/test_restart.py:17-82); chunk 2
  bitwise equal to chunk 1 on the CPU, the tapes too, with a partial tail
  chunk; the cadence errors; the sentinel abort at the start and mid-run
  with its exact step (tests/test_driver_chunked.py:117-165); the caller's
  state unchanged by a run.
- diag_phys_writeout, diag_cloud, diag_surf and diag_export on one
  physics state within 1e-12 of JAX's; HistoryRegistry/outfld_many/
  history_resolve exactly JAX's with all four avgflags; the catalog and
  snapshot registrations equal JAX's; physics_state_check, check_tracers
  and geopotential_dse within 1e-12 of JAX's.
- PhysicsBuffer.global_fields/reset_physpkg and config_from_dict/
  config_from_toml as JAX's (a Pallas switch is an unknown key here).
- The native writers build into the package's build/ directory and write
  nothing under native/.
- cli.run_main(["--device", "cpu", ...]) runs 2 steps.
- On a card (`cuda` marker): the chunk = 4 CUDA-graph run bitwise equal to
  the eager run, state and tapes, and a resume bitwise equal to the
  uninterrupted run.
"""

import glob
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch import driver as drv
from cam_nor_physics_tpu_torch.bench import bitwise_equal, clone_tree
from cam_nor_physics_tpu_torch.models.atm_comp import AtmModel, atm_init
from cam_nor_physics_tpu_torch.models.coupling.camsrfexch import (CamIn,
                                                                  CamOut)
from cam_nor_physics_tpu_torch.models.fv.held_suarez import hs_initial_state
from cam_nor_physics_tpu_torch.utils.checkpoint import restore_checkpoint
from cam_nor_physics_tpu_torch.utils.config import FVConfig
from torch_port_util import assert_close

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

IM, JM, KM = 32, 16, 6
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
TOL = 1e-9
TAPE_TOL = 1e-6
# tendencies of the (uniform) constituents on the tapes
TRACER_TENDS = ("DQCORE", "ZMDQ", "DCQ", "DCCLDLIQ", "DCCLDICE")


def _setup(device="cpu", dtype=torch.float64, im=IM, jm=JM, km=KM):
    model = AtmModel.create(im, jm, km, dt=1800.0,
                            fv_cfg=FVConfig(nsplit=2, nspltrac=1),
                            filter_impl="matmul", dtype=dtype, device=device)
    dyn0 = hs_initial_state(model.grid, model.coord, pert=1.0,
                            nq=model.registry.pcnst)
    state0 = atm_init(model, dyn0.replace(q=torch.full_like(dyn0.q, 1e-4)),
                      torch.zeros((jm, im), dtype=dtype, device=device))
    ncol = jm * im
    cam_in = CamIn.zeros(ncol, model.registry.pcnst, dtype=dtype,
                         device=device)
    cam_in = cam_in.replace(shf=torch.full((ncol,), 5.0, dtype=dtype,
                                           device=device))
    return model, state0, cam_in


def _zeros_like(state):
    return convert.atmstate_from_leaves(
        state, [torch.zeros_like(t)
                for _, t in convert.atmstate_named_leaves(state)])


def _npz(path):
    with np.load(os.path.join(path, "state.npz")) as d:
        return [d[f"leaf_{i}"] for i in range(len(d.files))]


def _read_tape(path):
    from scipy.io import netcdf_file
    with netcdf_file(path, mmap=False) as nc:
        return {k: np.array(v.data) for k, v in nc.variables.items()}


def _assert_state_close(got, want, names):
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        g = convert._np(g)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "nstep":
            assert int(g) == int(w)
        else:
            assert_close(g, w, TOL, name)


# ------------------------------------------------------ against JAX's driver
def test_driver_matches_jax(tmp_path):
    from cam_nor_physics_tpu.utils.checkpoint import \
        restore_checkpoint as jrestore
    model, state0, cam_in = _setup()
    init = {"shape": (IM, JM, KM),
            "state": convert.atmstate_to_numpy(state0),
            "cam_in": convert.camin_to_numpy(cam_in)}
    with open(tmp_path / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    ref = subprocess.Popen(
        [sys.executable, str(TESTS / "torch_port_driver_ref.py"),
         str(tmp_path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port_dir = tmp_path / "port"
        final, _ = drv.run(model, state0, cam_in, 4, out_dir=str(port_dir),
                           hist_every=2, ckpt_every=2)
        log, _ = ref.communicate(timeout=900)
    finally:
        ref.kill()
    assert ref.returncode == 0, log[-4000:]
    jax_dir = tmp_path / "jax"

    names = [n for n, _ in convert.atmstate_named_leaves(final)]
    with open(jax_dir / "leaf_names.json") as f:
        jnames = json.load(f)
    # '.dyn.u' / ".pbuf.fields['CLD']" -> 'dyn.u' / 'pbuf.CLD'
    assert [n.lstrip(".").replace(".fields['", ".").rstrip("']")
            for n in jnames] == names

    # the final state
    want = _npz(jax_dir / "final")
    _assert_state_close([t for _, t in convert.atmstate_named_leaves(final)],
                        want, names)

    # the checkpoints: JAX's layout, and JAX's values
    assert sorted(os.listdir(port_dir)) == sorted(
        n for n in os.listdir(jax_dir) if n not in ("final",
                                                    "leaf_names.json"))
    for ck in ("ckpt_000002", "ckpt_000004"):
        _assert_state_close(_npz(port_dir / ck), _npz(jax_dir / ck), names)
        with open(port_dir / ck / "meta.json") as f, \
                open(jax_dir / ck / "meta.json") as g:
            assert json.load(f) == json.load(g)

    # the tapes
    state_max = {n: float(np.abs(a).max()) for n, a in zip(names, want)}
    for tape in ("h0.0000.nc", "h0.0001.nc"):
        got, exp = _read_tape(port_dir / tape), _read_tape(jax_dir / tape)
        assert set(got) == set(exp) and len(got) > 150, set(got) ^ set(exp)
        for k in exp:
            assert got[k].dtype == exp[k].dtype, k
            scale = None
            if k in TRACER_TENDS:
                scale = state_max["phys.q"] / 1800.0
            assert_close(got[k], exp[k], TAPE_TOL, f"{tape} {k}", scale)

    # the port resumes from JAX's checkpoint to JAX's final state
    res, _ = drv.run(model, _zeros_like(state0), cam_in, 2,
                     out_dir=str(tmp_path / "resumed"),
                     resume_from=str(jax_dir / "ckpt_000002"))
    _assert_state_close([t for _, t in convert.atmstate_named_leaves(res)],
                        want, names)

    # JAX restores the port's checkpoint
    jtemplate = _jax_state(convert.atmstate_to_numpy(final))
    import jax
    restored = jax.tree.leaves(jrestore(str(port_dir / "ckpt_000002"),
                                        jtemplate))
    _assert_state_close(restored, _npz(jax_dir / "ckpt_000002"), names)


def _jax_state(fields):
    sys.path.insert(0, str(TESTS))
    from torch_port_driver_ref import jax_state
    return jax_state(fields)


# ------------------------------------------------------- the port alone
@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.mark.parametrize("chunk", [1, 2])
def test_restart_bitwise_continuation(setup, tmp_path, chunk):
    model, state0, cam_in = setup
    keep = clone_tree(state0)
    ref, _ = drv.run(model, state0, cam_in, 4, out_dir=str(tmp_path / "a"),
                     check_every=0, chunk=chunk)
    mid, _ = drv.run(model, state0, cam_in, 2, out_dir=str(tmp_path / "b"),
                     ckpt_every=2, check_every=0, chunk=chunk)
    ck = drv.latest_checkpoint(str(tmp_path / "b"))
    assert ck.endswith("ckpt_000002")
    res, _ = drv.run(model, _zeros_like(mid), cam_in, 2,
                     out_dir=str(tmp_path / "b"), resume_from=ck,
                     check_every=0, chunk=chunk)
    assert int(res.nstep) == int(ref.nstep) == 4
    assert bitwise_equal(res, ref)
    assert bitwise_equal(state0, keep)          # the caller's state


def test_chunked_bitwise_equal_to_stepwise(setup, tmp_path):
    """chunk 2 against chunk 1 over 5 steps (the first step alone, then
    chunks of 1, 2 and a partial 1... of the 2-step cadence), state and
    tapes, bitwise."""
    model, state0, cam_in = setup
    runs = {}
    for chunk in (1, 2):
        out = tmp_path / f"c{chunk}"
        runs[chunk], _ = drv.run(model, state0, cam_in, 5, out_dir=str(out),
                                 hist_every=2, check_every=0, chunk=chunk)
    assert bitwise_equal(runs[1], runs[2])
    tapes = [sorted(glob.glob(str(tmp_path / f"c{c}" / "h0.*.nc")))
             for c in (1, 2)]
    assert [os.path.basename(p) for p in tapes[0]] == \
        [os.path.basename(p) for p in tapes[1]] == ["h0.0000.nc",
                                                    "h0.0001.nc"]
    for a, b in zip(*tapes):
        ta, tb = _read_tape(a), _read_tape(b)
        assert set(ta) == set(tb)
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def test_chunked_cadence_validation(setup, tmp_path):
    model, state0, cam_in = setup
    with pytest.raises(ValueError, match="multiple of chunk"):
        drv.run(model, state0, cam_in, 4, out_dir=str(tmp_path / "x"),
                hist_every=3, check_every=0, chunk=2)
    with pytest.raises(ValueError, match="multiple of chunk"):
        drv.run(model, state0, cam_in, 4, out_dir=str(tmp_path / "y"),
                ckpt_every=3, check_every=0, chunk=2)


def _poison(state):
    u = state.dyn.u.clone()
    u[0, 4, 4] = float("nan")
    return state.replace(dyn=state.dyn.replace(u=u))


@pytest.mark.parametrize("chunk", [1, 2])
def test_sentinel_abort(setup, tmp_path, chunk):
    """A NaN in the initial state: the run raises and ABORT.json names
    step 1. chunk 2 detects it at the check boundary (step 2) and
    localises it by the per-step flags; chunk 1 checks every step."""
    model, state0, cam_in = setup
    check_every = 2 if chunk == 2 else 1
    with pytest.raises(drv.BlowupError, match="non-finite"):
        drv.run(model, _poison(state0), cam_in, 4,
                out_dir=str(tmp_path / "z"), check_every=check_every,
                chunk=chunk)
    with open(tmp_path / "z" / "ABORT.json") as f:
        rec = json.load(f)
    assert rec["failed_step"] == 1
    assert rec["detected_step"] == check_every
    assert rec["exact"] is (chunk == 2)
    assert rec["failed_within"] == [0, 1]
    assert rec["last_good_checkpoint"] is None


@pytest.mark.parametrize("chunk", [1, 2])
def test_sentinel_abort_midrun(setup, tmp_path, chunk):
    """Two clean steps leave a checkpoint; a NaN put into their state fails
    the next run's first step, and ABORT.json points at the checkpoint."""
    model, state0, cam_in = setup
    out = str(tmp_path / "m")
    mid, _ = drv.run(model, state0, cam_in, 2, out_dir=out, ckpt_every=2,
                     check_every=2, chunk=chunk)
    with pytest.raises(drv.BlowupError):
        drv.run(model, _poison(mid), cam_in, 2, out_dir=out,
                check_every=2, chunk=chunk)
    with open(os.path.join(out, "ABORT.json")) as f:
        rec = json.load(f)
    assert rec["failed_step"] == (1 if chunk == 2 else 2)
    assert rec["detected_step"] == 2
    assert rec["exact"] is (chunk == 2)
    assert rec["last_good_checkpoint"].endswith("ckpt_000002")


def test_umax_guard_trips(setup):
    model, state0, _ = setup
    drv._check_state(state0, 1)
    u = state0.dyn.u.clone()
    u[0, 3, 3] = drv.UMAX_GUARD + 200.0
    bad = state0.replace(dyn=state0.dyn.replace(u=u))
    with pytest.raises(drv.BlowupError, match="exceeds"):
        drv._check_state(bad, 1)
    assert bool(drv._state_ok(state0)) and not bool(drv._state_ok(bad))


def test_restore_rejects_other_shapes(setup, tmp_path):
    from cam_nor_physics_tpu_torch.utils.checkpoint import save_checkpoint
    model, state0, _ = setup
    save_checkpoint(str(tmp_path / "ck"), state0, {"nstep": 0})
    other = _setup(im=16, jm=8)[1]
    with pytest.raises(ValueError, match="checkpoint shape"):
        restore_checkpoint(str(tmp_path / "ck"), other)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path / "ck"), (state0, state0.phis))


def test_run_coupled_on_cpu(tmp_path):
    from cam_nor_physics_tpu_torch.models.coupling.surface_fluxes import \
        aquaplanet_sst
    model, state0, _ = _setup(im=16, jm=8, km=4)
    sst = aquaplanet_sst(state0.phys.lat)
    state, sst2, timer = drv.run_coupled(model, state0, sst, 2,
                                         out_dir=str(tmp_path),
                                         hist_every=2, ckpt_every=2)
    assert int(state.nstep) == 2 and torch.isfinite(state.dyn.u).all()
    tape = _read_tape(tmp_path / "h0.0000.nc")
    assert {"SST", "T850", "CLDTOT", "US", "VS"} <= set(tape)
    assert all(np.isfinite(v).all() for v in tape.values())
    assert len(_npz(tmp_path / "ckpt_000002")) == \
        len(convert.atmstate_named_leaves(state)) + 1
    assert timer.counts["atm_step"] == 2


def test_cli_runs_two_steps(tmp_path, capsys):
    from cam_nor_physics_tpu_torch.cli import run_main
    run_main(["--device", "cpu", "--im", "16", "--jm", "8", "--km", "4",
              "--nsteps", "2", "--hist-every", "2", "--ckpt-every", "2",
              "--out", str(tmp_path)])
    assert "completed step 2" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["ckpt_000002", "h0.0000.nc"]


def test_native_writers_build_into_the_package(tmp_path, monkeypatch):
    from cam_nor_physics_tpu_torch.utils import histio_native
    assert histio_native.native_library("histio").parent == \
        REPO / "cam_nor_physics_tpu_torch" / "build"
    native = REPO / "native"
    before = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    monkeypatch.setattr(histio_native, "BUILD", tmp_path)
    for stem in ("histio", "ckptio"):
        lib = histio_native.native_library(stem)
        assert lib.parent == tmp_path and lib.name.startswith(f"lib{stem}-")
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == before


def test_native_writer_failure_raises(tmp_path, monkeypatch):
    from cam_nor_physics_tpu_torch.utils import histio_native
    monkeypatch.setattr(histio_native, "BUILD", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        histio_native.AsyncHistoryWriter(None, [0.0], [0.0], 1)


# ------------------------------------------------------------ diagnostics
@pytest.fixture(scope="module")
def columns():
    """One physics state with variety (the setup's after d_p_coupling) and
    seeded cam_in/cam_out arrays."""
    _, state0, _ = _setup()
    rng = np.random.default_rng(3)
    ncol, pcnst = JM * IM, 3
    cam_in = {f: rng.uniform(0.0, 1.0, (ncol,)) for f in
              convert.CAMIN_FIELDS}
    cam_in["cflx"] = rng.uniform(0.0, 1e-4, (ncol, pcnst))
    cam_in["ts"] = 280.0 + 20.0 * cam_in["ts"]
    cam_out = {f: rng.uniform(0.0, 1.0, (ncol,)) for f in
               convert.CAMOUT_FIELDS}
    cam_out["qbot"] = rng.uniform(0.0, 1e-2, (ncol, pcnst))
    phys = convert.physstate_to_numpy(state0.phys)
    cld = rng.uniform(0.0, 1.0, (ncol, KM))
    return phys, cam_in, cam_out, cld


def test_diagnostics_match_jax(columns):
    import jax.numpy as jnp

    from cam_nor_physics_tpu.models.coupling import camsrfexch as jx
    from cam_nor_physics_tpu.models.physics import cam_diagnostics as jd
    from cam_nor_physics_tpu.models.physics.state import \
        PhysicsState as JState
    from cam_nor_physics_tpu_torch.models.physics import \
        cam_diagnostics as td
    phys, cin, cout, cld = columns
    area = np.linspace(1e9, 2e9, JM * IM)
    tstate = convert.physstate_from_numpy(phys, "cpu")
    jstate = JState(**{k: jnp.asarray(v) for k, v in phys.items()})
    tin = CamIn(**{k: torch.from_numpy(v) for k, v in cin.items()})
    tout = CamOut(**{k: torch.from_numpy(v) for k, v in cout.items()})
    jin = jx.CamIn(**{k: jnp.asarray(v) for k, v in cin.items()})
    jout = jx.CamOut(**{k: jnp.asarray(v) for k, v in cout.items()})
    got = {**td.diag_phys_writeout(tstate, nstep=torch.tensor(7),
                                   area=torch.from_numpy(area)),
           **td.diag_cloud(torch.from_numpy(cld), tstate.pmid),
           **td.diag_surf(tin, tout), **td.diag_export(tout)}
    want = {**jd.diag_phys_writeout(jstate, nstep=7,
                                    area=jnp.asarray(area)),
            **jd.diag_cloud(jnp.asarray(cld), jstate.pmid),
            **jd.diag_surf(jin, jout), **jd.diag_export(jout)}
    assert set(got) == set(want) and len(got) > 100
    for k in want:
        assert_close(got[k], want[k], 1e-12, k)
    assert td.amwg_core_fields() == jd.amwg_core_fields()
    assert td._CATALOG == jd._CATALOG and td._IC_FIELDS == jd._IC_FIELDS


def _registries():
    """The driver's registry and the budget and snapshot tapes, in both
    packages."""
    from cam_nor_physics_tpu.models.physics import cam_diagnostics as jd
    from cam_nor_physics_tpu.models.physics import physpkg as jp
    from cam_nor_physics_tpu.utils import history as jh
    from cam_nor_physics_tpu_torch.models.physics import \
        cam_diagnostics as td
    from cam_nor_physics_tpu_torch.models.physics import physpkg as tp
    from cam_nor_physics_tpu_torch.utils import history as th
    out = []
    for h, d, p in ((th, td, tp), (jh, jd, jp)):
        reg = h.default_registry_atm()
        d.diag_register(reg)
        for name in d.amwg_core_fields() + ["US", "VS", "PRECCMX"]:
            reg.add_default(name)
        d.budget_register(reg, tape=1, cnst_names=("Q", "CLDLIQ", "CLDICE"))
        p.snapshot_register(reg, 3, tape=2)
        out.append(reg)
    return out


def test_history_matches_jax():
    import jax.numpy as jnp

    from cam_nor_physics_tpu.utils import history as jh
    from cam_nor_physics_tpu_torch.utils import history as th
    treg, jreg = _registries()
    assert {k: v.__dict__ for k, v in treg.fields.items()} == \
        {k: v.__dict__ for k, v in jreg.fields.items()}
    assert treg.defaults == jreg.defaults
    reg = th.HistoryRegistry()
    jr = jh.HistoryRegistry()
    for r in (reg, jr):
        for flag in "AIXM":
            r.addfld(f"F{flag}", "1", flag, avgflag=flag)
            r.addfld(f"S{flag}", "1", flag, vdim="srf", avgflag=flag)
            r.add_default(f"F{flag}")
            r.add_default(f"S{flag}")
        r.addfld("US", "m/s", "u", gridname="fv_u_stagger")
        r.addfld("NEVER", "1", "never sampled", avgflag="X")
        r.add_default("US")
        r.add_default("NEVER")
    rng = np.random.default_rng(5)
    ncol, pver = 12, KM
    tbuf = reg.buffer(ncol, pver, torch.float64, jm=4, im=3)
    jbuf = jr.buffer(ncol, pver, jnp.float64, jm=4, im=3)
    for _ in range(3):
        payload = {f"F{f}": rng.standard_normal((ncol, pver)) for f in "AIXM"}
        payload.update({f"S{f}": rng.standard_normal(ncol) for f in "AIXM"})
        payload["US"] = rng.standard_normal((pver, 3, 3))
        payload["OTHER"] = rng.standard_normal(ncol)
        th.outfld_many(tbuf, {k: torch.from_numpy(v)
                              for k, v in payload.items()}, reg)
        jbuf = jh.outfld_many(jbuf, {k: jnp.asarray(v)
                                     for k, v in payload.items()}, jr)
    got, want = th.history_resolve(reg, tbuf), jh.history_resolve(jr, jbuf)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not got["NEVER"].any()


def test_state_check_tracers_geopotential_match_jax(columns):
    import jax.numpy as jnp

    from cam_nor_physics_tpu.models.physics import check_tracers as jct
    from cam_nor_physics_tpu.models.physics.state import \
        PhysicsState as JState
    from cam_nor_physics_tpu.models.physics.state import \
        physics_state_check as jcheck
    from cam_nor_physics_tpu.ops.geopotential import geopotential_dse as jg
    from cam_nor_physics_tpu_torch.models.physics import check_tracers as tct
    from cam_nor_physics_tpu_torch.models.physics.state import \
        physics_state_check
    from cam_nor_physics_tpu_torch.ops.geopotential import geopotential_dse
    phys = columns[0]
    tstate = convert.physstate_from_numpy(phys, "cpu")
    jstate = JState(**{k: jnp.asarray(v) for k, v in phys.items()})
    bad = dict(phys, t=phys["t"].copy())
    bad["t"][3, 2] = np.nan
    for fields in (phys, bad):
        got = physics_state_check(convert.physstate_from_numpy(fields, "cpu"))
        want = jcheck(JState(**{k: jnp.asarray(v)
                                for k, v in fields.items()}))
        assert {k: bool(v) for k, v in got.items()} == \
            {k: bool(v) for k, v in want.items()}
    assert not bool(got["ok"]) and bool(physics_state_check(tstate)["ok"])

    cflx = np.random.default_rng(4).uniform(0, 1e-5, phys["q"].shape[::2])
    tr, jtr = tct.check_tracers_init(tstate), jct.check_tracers_init(jstate)
    assert_close(tr.mass, jtr.mass, 1e-12, "mass")
    moved = tstate.replace(q=tstate.q * 1.01)
    got = tct.check_tracers_chng(moved, tr, torch.from_numpy(cflx), 1800.0)
    want = jct.check_tracers_chng(jstate.replace(q=jstate.q * 1.01), jtr,
                                  jnp.asarray(cflx), 1800.0)
    assert_close(got[0].mass, want[0].mass, 1e-12, "mass")
    assert_close(got[1], want[1], 1e-12, "resid")

    args = ("lnpint", "lnpmid", "pint", "pmid", "pdel", "rpdel", "s")
    q1 = phys["q"][:, :, 0]
    got = geopotential_dse(*(torch.from_numpy(phys[a]) for a in args),
                           torch.from_numpy(q1),
                           torch.from_numpy(phys["phis"]))
    want = jg(*(jnp.asarray(phys[a]) for a in args), jnp.asarray(q1),
              jnp.asarray(phys["phis"]))
    for name, g, w in zip(("t", "zi", "zm"), got, want):
        assert_close(g, w, 1e-12, name)
    assert_close(got[0], phys["t"], 1e-10, "t from s")


def test_physics_buffer_lifetimes_match_jax(setup):
    import jax.numpy as jnp

    from cam_nor_physics_tpu.models.physics.physics_buffer import \
        PhysicsBuffer as JBuffer
    _, state0, _ = setup
    pb = state0.pbuf.update(**{k: torch.ones_like(v)
                               for k, v in state0.pbuf.fields.items()})
    jpb = JBuffer(fields={k: jnp.asarray(v.numpy())
                          for k, v in pb.fields.items()},
                  lifetimes=pb.lifetimes)
    assert set(pb.global_fields()) == set(jpb.global_fields()) and \
        {"CLD", "PBLH"} <= set(pb.global_fields())
    got, want = pb.reset_physpkg(), jpb.reset_physpkg()
    for k in want.fields:
        np.testing.assert_array_equal(got.get(k).numpy(),
                                      np.asarray(want.get(k)), err_msg=k)
    assert got.lifetimes == pb.lifetimes


def test_model_config_matches_jax(tmp_path):
    import dataclasses

    from cam_nor_physics_tpu.utils import config as jc
    from cam_nor_physics_tpu_torch.utils import config as tc
    data = {"grid": {"im": 72, "jm": 46, "km": 10},
            "fv": {"nsplit": 4, "iord": 1}, "zm": {"c0_ocn": 0.02},
            "phys": {"radiation_scheme": "gray"}}
    (tmp_path / "cfg.toml").write_text(
        "[grid]\nim = 72\njm = 46\nkm = 10\n[fv]\nnsplit = 4\n"
        "iord = 1\n[zm]\nc0_ocn = 0.02\n[phys]\n"
        "radiation_scheme = \"gray\"\n")
    got = tc.config_from_toml(str(tmp_path / "cfg.toml"))
    assert got == tc.config_from_dict(data)
    want = jc.config_from_dict(data)
    for sub in ("grid", "fv", "zm", "phys"):
        g, w = dataclasses.asdict(getattr(got, sub)), \
            dataclasses.asdict(getattr(want, sub))
        w = {k: v for k, v in w.items() if k in g}    # the Pallas switches
        assert g == w, sub
    with pytest.raises(KeyError, match="use_pallas"):
        tc.config_from_dict({"fv": {"use_pallas": True}})
    got.echo()


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_chunked_graph_and_resume_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    model, state0, cam_in = _setup("cuda", torch.float32)
    runs = {}
    for chunk in (1, 4):
        runs[chunk], _ = drv.run(model, state0, cam_in, 8,
                                 out_dir=str(tmp_path / f"c{chunk}"),
                                 hist_every=4, ckpt_every=4, check_every=4,
                                 chunk=chunk)
    assert bitwise_equal(runs[1], runs[4])
    for name in ("h0.0000.nc", "h0.0001.nc"):
        ta = _read_tape(tmp_path / "c1" / name)
        tb = _read_tape(tmp_path / "c4" / name)
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    res, _ = drv.run(model, _zeros_like(state0), cam_in, 4,
                     out_dir=str(tmp_path / "r"), chunk=4,
                     resume_from=str(tmp_path / "c1" / "ckpt_000004"))
    assert bitwise_equal(res, runs[1])
