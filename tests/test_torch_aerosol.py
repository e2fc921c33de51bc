"""The modal aerosol of the PyTorch port (modal_aero_wateruptake,
modal_aer_opt, oslo_aero and physpkg's aerosol branch), float64 on the
CPU.

- Against the JAX package (tests/torch_port_microp_ref.py, in a fresh
  interpreter while the port computes, shared with the ZM microphysics'
  and SCAM's references: torch_port_util.shared_jax_reference; ROADMAP
  R1), on inputs made here
  from numpy seeds, within 1e-12 of each output's max:
  modal_aero_calcsize with the default size and with a number mixing
  ratio (clipped into the mode's size range), modal_aero_wateruptake
  over relative humidities across the hysteresis ramp, and the optics of
  tests/test_aero_integration.py's accumulation mode
  (modal_aero_optics_all: the shortwave sums, the longwave absorption, the
  AOD and burden diagnostics), sizes spread across the tables' radius
  range and beyond it (the geometric-optics branch).
- phys_run1 with that mode and ZMConfig(microp=True), two steps (nstep 0,
  then 1 from the first step's state and pbuf), on 16 columns of
  test_torch_physpkg's inputs with so4_a1 and pom_a1 added: every field
  of the state, the pbuf, the tendencies, cam_out and the diagnostics
  (the key sets equal) within 1e-10 of its max, ZM's indices equal. The
  activation lags a step: the first step's ZM reads the registration's
  zero NAER (no droplets activate), the second the first step's.
- On the port alone: the NetCDF loaders against the JAX package's on a
  file written here, the pbuf registration with two modes, the oslo
  stubs, one warning per mode without species_hygro, and two coupled
  steps of entry.build_coupled(microp=True, aerosol=True) at 24 x 16 x 6
  that read no device value on the host and copy no host value to the
  device after the first (CUDA graph capture). On a card (marked cuda,
  skipped here): a CUDA graph of those steps bitwise to eager steps.
"""

import warnings

import numpy as np
import pytest
import torch

from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import accum_mode, build_coupled
from cam_nor_physics_tpu_torch.models.physics import modal_aer_opt as tmo
from cam_nor_physics_tpu_torch.models.physics import \
    modal_aero_wateruptake as twu
from cam_nor_physics_tpu_torch.models.physics import oslo_aero as tos
from cam_nor_physics_tpu_torch.models.physics import physpkg as tpp
from cam_nor_physics_tpu_torch.models.physics.check_energy import \
    check_energy_timestep_init
from cam_nor_physics_tpu_torch.models.physics.constituents import (
    Constituent, default_registry)
from cam_nor_physics_tpu_torch.models.physics.physics_buffer import \
    pbuf_register
from cam_nor_physics_tpu_torch.utils.config import (FVConfig, PhysConfig,
                                                     ZMConfig)
from test_torch_atm_comp import _HostReads
from test_torch_physpkg import _flat, _inputs
from test_torch_zm_microp import check
from torch_port_util import npy, shared_jax_reference

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

NCOL, PVER = 16, 26
DT = 1800.0
TOL = 1e-12
TOL_PKG = 1e-10
SPECIES = ("so4_a1", "pom_a1")
# the AeroMode of tests/test_aero_integration.py, less its table
MODE = dict(name="accum", species_names=SPECIES,
            species_density=(1770.0, 1000.0),
            species_refindex_sw=(complex(1.43, 1e-8), complex(1.55, 5e-3)),
            species_refindex_lw=(complex(1.35, 0.2), complex(1.5, 0.1)))


def _registry():
    reg = default_registry()
    for n in SPECIES:
        reg = reg.add(Constituent(name=n, longname=n, qmin=0.0,
                                  mixtype="wet"))
    return reg


def _phys_inputs(rng):
    """test_torch_physpkg's state, pbuf and cam_in with the two species
    (2e-9 and 1e-9 kg/kg, +-50%) added."""
    st, pb, ci = _inputs()
    reg = _registry()
    aer = torch.from_numpy(np.stack(
        [m * rng.uniform(0.5, 1.5, (NCOL, PVER)) for m in (2e-9, 1e-9)], -1))
    st = check_energy_timestep_init(st.replace(q=torch.cat([st.q, aer], -1)),
                                    reg)
    pbuf = pbuf_register(tpp.physpkg_pbuf_specs(NCOL, PVER,
                                                pcnst=reg.pcnst))
    pbuf = pbuf.update(**{k: v for k, v in pb.fields.items()
                          if k != "DQCOND_QINI"})
    ci = ci.replace(cflx=torch.cat([ci.cflx, torch.zeros(NCOL, 2,
                                                         dtype=ci.cflx.dtype)],
                                   -1))
    return st, pbuf, ci


def _cases():
    rng = np.random.default_rng(31)
    shape = (NCOL, PVER)
    specmmr = [m * rng.uniform(0.0, 2.0, shape) for m in (2e-9, 1e-9)]
    specmmr[0][0, :4] = 0.0              # a dry-volume-free corner
    specmmr[1][0, :4] = 0.0
    size = dict(specmmr=specmmr, num=rng.uniform(1e6, 1e9, shape),
                rh=rng.uniform(0.0, 1.0, shape), hygro=(0.5, 0.1))
    optics = dict(specmmr=[m * rng.uniform(0.5, 1.5, shape)
                           for m in (2e-9, 1e-9)],
                  dgnumwet=np.exp(rng.uniform(np.log(0.005e-6),
                                              np.log(60e-6), shape))[..., None],
                  qaerwat=rng.uniform(-1e-10, 5e-9, shape)[..., None],
                  mass=rng.uniform(50.0, 500.0, shape))
    st, pbuf, ci = _phys_inputs(rng)
    phys = dict(names=_registry().names,
                state=convert.physstate_to_numpy(st),
                pbuf=convert.pbuf_to_numpy(pbuf),
                cam_in=convert.camin_to_numpy(ci), dt=DT)
    return dict(mode=MODE, size=size, optics=optics, phys=phys)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(cases):
    """The port's counterpart of torch_port_microp_ref.run_aero."""
    out = {}
    mode = tmo.AeroMode(table=tmo.make_synthetic_table(), **MODE)
    s = cases["size"]
    spec = [_t(a) for a in s["specmmr"]]
    for tag, num in (("default", None), ("num", s["num"])):
        dg, naer, dryvol = twu.modal_aero_calcsize(
            spec, mode.species_density, mode.sigma_logr, mode.dgnum,
            mode.dgnumlo, mode.dgnumhi, None if num is None else _t(num))
        wu = twu.modal_aero_wateruptake(
            spec, mode.species_density, s["hygro"], mode.sigma_logr, dg,
            naer, _t(s["rh"]), mode.rhcrystal, mode.rhdeliques)
        out[f"size.{tag}"] = dict(dgnum=npy(dg), naer=npy(naer),
                                  dryvol=npy(dryvol),
                                  **{k: npy(v) for k, v in wu.items()})
    o = cases["optics"]
    sw_tot, lw, diags = tmo.modal_aero_optics_all(
        (mode,), ([_t(a) for a in o["specmmr"]],), _t(o["dgnumwet"]),
        _t(o["qaerwat"]), _t(o["mass"]))
    out["optics"] = {**{f"sw.{k}": npy(v) for k, v in sw_tot.items()},
                     "lw": npy(lw), **{k: npy(v) for k, v in diags.items()}}
    p = cases["phys"]
    pcfg = PhysConfig(aero_modes=(mode,), radiation_scheme="gray")
    st = convert.physstate_from_numpy(p["state"], "cpu")
    pb = convert.pbuf_from_numpy(*p["pbuf"], "cpu")
    ci = convert.camin_from_numpy(p["cam_in"], "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for step, nstep in ((1, 0), (2, 1)):
            res = tpp.phys_run1(pcfg, ZMConfig(microp=True), _registry(), st,
                                pb, ci, DT, nstep=nstep)
            out[f"phys.{step}"] = _flat(res)
            st, pb = res.state, res.pbuf
    return out


INDEX_KEYS = ("pbuf.ZM_IDEEP", "pbuf.ZM_JT", "pbuf.ZM_MAXG", "diag.CLDTOP",
              "diag.CLDBOT")


def test_aerosol_matches_jax(tmp_path_factory):
    got, want = shared_jax_reference(tmp_path_factory, "aero", _port)
    assert set(got) == set(want)
    for tag in ("default", "num"):
        check(got[f"size.{tag}"], want[f"size.{tag}"], TOL, f"size {tag}")
    w = want["size.num"]
    assert w["qaerwat"].max() > 0 and (w["qaerwat"] == 0).any()
    check(got["optics"], want["optics"], TOL, "optics")
    assert (want["optics"]["AODVIS_accum"] > 0).all()
    for step in (1, 2):
        w = want[f"phys.{step}"]
        te_scale = float(np.abs(w["state.te_cur"]).max())
        check(got[f"phys.{step}"], w, TOL_PKG, f"phys_run1 step {step}",
              scales={"diag.ZM_TE_ERR": te_scale})
        for k in INDEX_KEYS:
            np.testing.assert_array_equal(got[f"phys.{step}"][k], w[k])
        assert (w["diag.AODVIS_accum"] > 0).all()
        assert w["pbuf.NAER"].min() > 0 and w["pbuf.DGNUMWET"].min() > 0
    # the one-step lag: the first step activates from the registration's
    # zero NAER, the second from the first step's
    w1, w2 = want["phys.1"], want["phys.2"]
    assert w1["pbuf.ZM_IDEEP"].sum() > 0
    assert w1["diag.QNLZM"].max() == 0.0 and w2["diag.QNLZM"].max() > 0.0


def test_netcdf_loaders_match_jax(tmp_path):
    """load_modal_optics_netcdf (a (ncoef, prefr, prefi, nband) file with
    1-D grids) and read_water_refindex read what the JAX package's read."""
    from scipy.io import netcdf_file

    from cam_nor_physics_tpu.models.physics import modal_aer_opt as jmo
    rng = np.random.default_rng(5)
    path, wpath = tmp_path / "optics.nc", tmp_path / "water.nc"
    with netcdf_file(path, "w") as nc:
        for name, n in (("ncoef", tmo.NCOEF), ("prefr", tmo.PREFR),
                        ("prefi", tmo.PREFI), ("nsw", tmo.NSWBANDS),
                        ("nlw", tmo.NLWBANDS)):
            nc.createDimension(name, n)
        for v, nb in (("extpsw", "nsw"), ("abspsw", "nsw"),
                      ("asmpsw", "nsw"), ("absplw", "nlw")):
            var = nc.createVariable(v, "d", ("ncoef", "prefr", "prefi", nb))
            var[:] = rng.standard_normal(var.shape)
        for v, dim in (("refrtabsw", "prefr"), ("refitabsw", "prefi"),
                       ("refrtablw", "prefr"), ("refitablw", "prefi")):
            var = nc.createVariable(v, "d", (dim,))
            var[:] = np.sort(rng.uniform(0.0, 2.0, var.shape))
    with netcdf_file(wpath, "w") as nc:
        nc.createDimension("nsw", tmo.NSWBANDS)
        nc.createDimension("nlw", tmo.NLWBANDS)
        for v, dim in (("refindex_real_water_sw", "nsw"),
                       ("refindex_im_water_sw", "nsw"),
                       ("refindex_real_water_lw", "nlw"),
                       ("refindex_im_water_lw", "nlw")):
            var = nc.createVariable(v, "d", (dim,))
            var[:] = rng.uniform(-1.0, 1.5, var.shape)
    got, want = (m.load_modal_optics_netcdf(str(path)) for m in (tmo, jmo))
    for f in ("extpsw", "abspsw", "asmpsw", "absplw", "refrtabsw",
              "refitabsw", "refrtablw", "refitablw", "rmmin", "rmmax"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.extpsw.shape == (tmo.NSWBANDS, tmo.PREFR, tmo.PREFI,
                                tmo.NCOEF)
    for g, w in zip(tmo.read_water_refindex(str(wpath)),
                    jmo.read_water_refindex(str(wpath))):
        np.testing.assert_array_equal(g, w)
        assert (g.imag >= 0).all()


def test_pbuf_modes_oslo_and_tables_match_jax():
    """physpkg_pbuf_specs with two modes; the oslo stubs' contract; the
    synthetic tables and the water indices are the JAX package's."""
    from cam_nor_physics_tpu.models.physics import modal_aer_opt as jmo
    from cam_nor_physics_tpu.models.physics import oslo_aero as jos
    from cam_nor_physics_tpu.models.physics import physpkg as jpp
    assert tpp.physpkg_pbuf_specs(7, 26, 2, pcnst=5) == \
        jpp.physpkg_pbuf_specs(7, 26, 2, pcnst=5)
    assert tpp.physpkg_pbuf_specs(7, 26)["NAER"] == ((7, 26, 1), "global")
    assert (tos.USE_OSLO_AERO, tos.NBMODES) == (jos.USE_OSLO_AERO,
                                                jos.NBMODES)
    sentinel = object()
    assert tos.oslo_aero_microp_run(1, 2, 3, sentinel) == (1, 2, sentinel)
    assert tos.oslo_aero_ocean_adv(None, sentinel) is sentinel
    a, b = tmo.make_synthetic_table(seed=3), jmo.make_synthetic_table(seed=3)
    for f in a.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    np.testing.assert_array_equal(tmo.CREFWSW, jmo.CREFWSW)
    np.testing.assert_array_equal(tmo.CREFWLW, jmo.CREFWLW)


def test_aerosol_branch_switches_and_warns_once():
    """use_oslo_aero or prog_modal_aero=False skip the branch (no AOD
    diagnostics); a mode without species_hygro warns once, not at every
    step, and the results are the same."""
    rng = np.random.default_rng(2)
    st, pbuf, ci = _phys_inputs(rng)
    reg, zm = _registry(), ZMConfig()
    mode = tmo.AeroMode(table=tmo.make_synthetic_table(),
                        **dict(MODE, name="hygroless"))
    for kw in (dict(use_oslo_aero=True), dict(prog_modal_aero=False)):
        out = tpp.phys_run1(PhysConfig(aero_modes=(mode,), **kw), zm, reg,
                            st, pbuf, ci, DT)
        assert not any(k.startswith("AOD") for k in out.diagnostics)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        outs = [tpp.phys_run1(PhysConfig(aero_modes=(mode,)), zm, reg, st,
                              pbuf, ci, DT) for _ in range(2)]
    hits = [w for w in seen if "species_hygro" in str(w.message)]
    assert len(hits) == 1 and "hygroless" in str(hits[0].message)
    for k in ("AODVIS_hygroless", "AER_TAU_SW", "AER_TAU_LW"):
        assert torch.equal(outs[0].diagnostics[k], outs[1].diagnostics[k])
    hygro = dict(MODE, name="hygro", species_hygro=(0.5, 0.2))
    out = tpp.phys_run1(
        PhysConfig(aero_modes=(tmo.AeroMode(
            table=tmo.make_synthetic_table(), **hygro),)),
        zm, reg, st, pbuf, ci, DT)
    assert float(out.pbuf.get("QAERWAT").max()) > float(
        outs[0].pbuf.get("QAERWAT").max())


def test_coupled_microp_aerosol_steps_read_no_host_values():
    """entry.build_coupled(microp=True, aerosol=True): two coupled steps,
    finite, the AOD family and NAER filled; the second step reads no
    device value on the host and makes no tensor from host data but the
    ZM code's float(torch.tensor(eps, dtype)) CPU constants (the optics
    tables became tensors in the first step)."""
    class _Reads(_HostReads):
        WATCH = _HostReads.WATCH + ("aten.lift_fresh.default",)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model, step, state, _ = build_coupled(
            24, 16, 6, torch.float64, "cpu",
            fv_cfg=FVConfig(nsplit=4, nspltrac=1), microp=True, aerosol=True)
        mode0 = model.phys_cfg.aero_modes[0]
        assert (mode0.name, mode0.species_names) == (
            accum_mode().name, ("so4_a1", "pom_a1"))
        state, _, d1 = step(state, first_step=True)
        with _Reads() as mode:
            state, cam_out, d2 = step(state)
    import linecache
    for op, frame in mode.sites:
        assert frame is not None, op
        line = linecache.getline(frame.filename, frame.lineno)
        assert "float(torch.tensor(" in line, (op, frame.filename,
                                               frame.lineno, line)
    for t in (state.dyn.u, state.dyn.q, cam_out.precc, d2["AODVIS_accum"],
              d2["ZMFRZ"], state.pbuf.get("NAER")):
        assert bool(torch.isfinite(t).all())
    assert float(d2["AODVIS_accum"].min()) > 0.0
    assert float(state.pbuf.get("NAER").min()) > 0.0
    assert float(d1["QNLZM"].max()) == 0.0


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_microp_aerosol_graph_on_the_card():
    """build_coupled(microp=True, aerosol=True) at 48 x 24 x 10, float32,
    on the card: after two eager steps (the optics tables become device
    tensors in the first), a CUDA graph of 2 steps whose first replay is
    bitwise equal to 2 eager steps (bench.chain_graph), the AOD family
    finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    from cam_nor_physics_tpu_torch.bench import chain_graph
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, step, state, _ = build_coupled(
            48, 24, 10, torch.float32, "cuda",
            fv_cfg=FVConfig(nsplit=4, nspltrac=1), microp=True,
            aerosol=True)
        state, _, _ = step(state, first_step=True)
        state, _, diags = step(state)
        chain_graph(lambda s: (step(s)[0],), (state,), 2)
    assert bool(torch.isfinite(diags["AODVIS_accum"]).all())
    assert float(state.pbuf.get("NAER").min()) > 0.0
