"""The model's other modes in the port against the JAX package, float64 on
the CPU: the JW06 baroclinic wave, IC files, the offline dynamics' met
files, the single-column model, Rayleigh friction, the TEM diagnostics
and the climatology accumulator; and their physical checks on the port.

- scam_run and scam_run_iop, 3 steps each, and one scam_step on
  tests/test_torch_physpkg.py's 16 columns (land and ocean soundings,
  every other one unstable aloft) with forcing drawn from a seed: state,
  physics buffer, series, cam_out and the diagnostics within 1e-10 of
  each field's max, ZM's trigger and level indices equal. The forcing
  and the IOP series reach the port through convert.scamforcing_* and
  convert.iopdata_*. JAX's side runs op by op in the fresh interpreter it
  shares with the ZM microphysics' and the aerosol's references
  (torch_port_util.shared_jax_reference): one column shape, so its
  primitives compile once.
- IC, met and IOP files written by either package read back in the other
  bitwise (the file's variables; the IC state's pt goes through
  pressure_vars, whose log and pow differ from XLA's by an ulp, so it is
  held at 1e-15); met_state_at, offline_dyn_run (on a MetData converted
  from JAX's) and iop_forcing_at within 1e-15.
- jw_baroclinic_wave, dry and moist, perturbed and not, within 1e-12;
  rayleigh_friction_tend and ctem_diags (with JAX's NaN where a column
  holds a NaN or an inf) within 1e-12; the climatology accumulator over
  three samples within 1e-12.
- The physical checks of tests/test_baroclinic_wave.py (not the nine-day
  case), tests/test_rayleigh.py, tests/test_climatology.py,
  tests/test_inidat_scam.py and tests/test_dyn_extras.py's offline mode,
  on the port.
- On a card (marked cuda, skipped here): SCAM on 16 columns in float64
  through the zm_tail kernel against the CPU's plain tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cam_nor_physics_tpu.models.fv import baroclinic_wave as jbw
from cam_nor_physics_tpu.models.fv import ctem as jctem
from cam_nor_physics_tpu.models.fv import grid as jgrid
from cam_nor_physics_tpu.models.fv import inidat as jini
from cam_nor_physics_tpu.models.fv import metdata as jmet
from cam_nor_physics_tpu.models.fv import vertical as jvert
from cam_nor_physics_tpu.models import scam as jscam
from cam_nor_physics_tpu.models.physics import rayleigh_friction as jrf
from cam_nor_physics_tpu.utils import climatology as jclimo
from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.models import scam as tscam
from cam_nor_physics_tpu_torch.models.coupling.camsrfexch import CamIn
from cam_nor_physics_tpu_torch.models.fv import baroclinic_wave as tbw
from cam_nor_physics_tpu_torch.models.fv import ctem as tctem
from cam_nor_physics_tpu_torch.models.fv import dyn_comp as tdc
from cam_nor_physics_tpu_torch.models.fv import grid as tgrid
from cam_nor_physics_tpu_torch.models.fv import inidat as tini
from cam_nor_physics_tpu_torch.models.fv import metdata as tmet
from cam_nor_physics_tpu_torch.models.fv import vertical as tvert
from cam_nor_physics_tpu_torch.models.fv.cd_core import pressure_vars
from cam_nor_physics_tpu_torch.models.physics import rayleigh_friction as trf
from cam_nor_physics_tpu_torch.models.physics.constituents import \
    default_registry
from cam_nor_physics_tpu_torch.models.physics.state import \
    make_state_from_profiles
from cam_nor_physics_tpu_torch.utils import climatology as tclimo
from cam_nor_physics_tpu_torch.utils import constants as c
from cam_nor_physics_tpu_torch.utils.config import (FVConfig, PhysConfig,
                                                     ZMConfig)
from torch_port_util import assert_close, npy, shared_jax_reference, t64

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

IM, JM, KM = 32, 16, 6
DT = 1800.0
TOL = 1e-10
TOL_LEAF = 1e-12
INDEX_KEYS = ("pbuf.ZM_IDEEP", "pbuf.ZM_JT", "pbuf.ZM_MAXG", "diag.CLDTOP",
              "diag.CLDBOT")


def _grids(im=IM, jm=JM, km=KM):
    return (tgrid.make_grid(im, jm, km, device="cpu"),
            tvert.hybrid_coefficients(km, device="cpu"),
            jgrid.make_grid(im, jm, km), jvert.hybrid_coefficients(km))


# ---------------------------------------------------------------------------
# SCAM against JAX
# ---------------------------------------------------------------------------

def scam_cases():
    """tests/test_torch_physpkg.py's 16 columns, forcing and an IOP series
    (3 records, 1 h apart) drawn from a seed."""
    from test_torch_physpkg import _inputs
    st, _, ci = _inputs()
    ncol, pver = st.t.shape
    rng = np.random.default_rng(11)
    forcing = dict(dtdt_ls=-2e-5 * rng.uniform(0.0, 1.0, (ncol, pver)),
                   dqdt_ls=np.zeros((ncol, pver)),
                   omega=-0.1 * rng.uniform(0.0, 1.0, (ncol, pver)))
    forcing["dqdt_ls"][:, -5:] = 2e-8
    iop = dict(tsec=np.array([0.0, 3600.0, 7200.0]),
               divT=-1e-5 * rng.uniform(0.0, 1.0, (3, pver)),
               divq=1e-8 * rng.uniform(0.0, 1.0, (3, pver)),
               omega=-0.05 * rng.uniform(0.0, 1.0, (3, pver)),
               shflx=np.array([10.0, 25.0, 40.0]),
               lhflx=np.array([60.0, 90.0, 120.0]))
    return dict(state=convert.physstate_to_numpy(st),
                cam_in=convert.camin_to_numpy(ci), forcing=forcing, iop=iop,
                dt=DT, nsteps=3)


def _flat(st, pbuf, series):
    res = {f"state.{k}": v for k, v in convert.physstate_to_numpy(st).items()}
    res.update({f"pbuf.{k}": v
                for k, v in convert.pbuf_to_numpy(pbuf)[0].items()})
    res.update({f"series.{k}": npy(v) for k, v in series.items()})
    return res


def _scam_port(cases):
    reg = default_registry()
    st = convert.physstate_from_numpy(cases["state"], "cpu")
    ci = convert.camin_from_numpy(cases["cam_in"], "cpu")
    forcing = convert.scamforcing_from_numpy(cases["forcing"], "cpu")
    iop = convert.iopdata_from_numpy(cases["iop"], "cpu")
    dt, n = cases["dt"], cases["nsteps"]
    out = {"run": _flat(*tscam.scam_run(PhysConfig(), ZMConfig(), reg, st,
                                        ci, forcing, dt, n)),
           "iop": _flat(*tscam.scam_run_iop(PhysConfig(), ZMConfig(), reg,
                                            st, ci, iop, dt, n))}
    pbuf = tscam.scam_init_pbuf(st.ncol, st.pver, device="cpu")
    s1, pb, cam_out, diags = tscam.scam_step(PhysConfig(), ZMConfig(), reg,
                                             st, pbuf, ci, forcing, dt)
    res = _flat(s1, pb, {})
    res.update({f"cam_out.{k}": v
                for k, v in convert.camout_to_numpy(cam_out).items()})
    res.update({f"diag.{k}": npy(v) for k, v in diags.items()})
    out["step"] = res
    return out


def test_scam_matches_jax(tmp_path_factory):
    got, want = shared_jax_reference(tmp_path_factory, "scam", _scam_port)
    assert set(got) == set(want) == {"run", "iop", "step"}
    for tag in want:
        g, w = got[tag], want[tag]
        assert set(g) == set(w), (tag, set(g) ^ set(w))
        te = float(np.abs(w["state.te_cur"]).max())
        for k in sorted(w):
            if k in INDEX_KEYS:
                np.testing.assert_array_equal(g[k], w[k], f"{tag} {k}")
            else:
                assert_close(g[k], w[k], TOL, f"{tag} {k}",
                             scale=te if k == "diag.ZM_TE_ERR" else None)
    # convection ran in some columns and not all; the series hold the
    # steps after scam_run's first (JAX's scan) and all of scam_run_iop's
    for tag, n in (("run", 2), ("iop", 3)):
        assert want[tag]["series.precc"].shape == (n, 16)
        assert want[tag]["series.precc"].max() > 0
    assert 0 < want["step"]["pbuf.ZM_IDEEP"].sum() < 16


def test_scam_forced_column_convects():
    """tests/test_inidat_scam.py::TestScam on the port: a weakly moistened
    unstable column precipitates over 3 steps."""
    ncol, pver = 4, 26
    reg = default_registry()
    eta = np.linspace(0.003, 1.0, pver + 1) ** 1.2
    pint = t64(eta[None, :] * 1.0e5 * np.ones((ncol, 1)))
    pmid = 0.5 * (pint[:, 1:] + pint[:, :-1])
    t = torch.clamp(300.0 * (pmid / 1.0e5) ** 0.19, min=195.0)
    t[:, -1] += 2.0
    q = torch.zeros((ncol, pver, reg.pcnst), dtype=torch.float64)
    q[:, :, 0] = 0.017 * (pmid / pmid[:, -1:]) ** 2.5 + 1e-6
    z = torch.zeros((ncol, pver), dtype=torch.float64)
    st = make_state_from_profiles(pint, t, z, z, q,
                                  torch.zeros(ncol, dtype=torch.float64))
    cam_in = CamIn.zeros(ncol, reg.pcnst).replace(
        landfrac=torch.ones(ncol, dtype=torch.float64))
    forcing = tscam.ScamForcing.zeros(ncol, pver, device="cpu")
    dq = torch.zeros((ncol, pver), dtype=torch.float64)
    dq[:, -5:] = 2e-8
    forcing = forcing.replace(dqdt_ls=dq)
    state, _, series = tscam.scam_run(PhysConfig(), ZMConfig(), reg, st,
                                      cam_in, forcing, 1800.0, nsteps=3)
    assert bool(torch.isfinite(state.t).all())
    assert float(series["precc"].max()) > 0.0


def test_iop_files_cross_packages_bitwise(tmp_path):
    rng = np.random.default_rng(1)
    ntime, pver = 4, 26
    args = (np.arange(ntime) * 1800.0,
            1e-5 * rng.standard_normal((ntime, pver)),
            1e-9 * rng.standard_normal((ntime, pver)),
            0.1 * rng.standard_normal((ntime, pver)),
            20.0 + rng.standard_normal(ntime),
            80.0 + rng.standard_normal(ntime))
    jscam.save_iop_netcdf(str(tmp_path / "j.nc"), *args)
    tscam.save_iop_netcdf(str(tmp_path / "t.nc"), *map(t64, args))
    for name in ("j.nc", "t.nc"):
        got = tscam.load_iop_netcdf(str(tmp_path / name), device="cpu")
        want = jscam.load_iop_netcdf(str(tmp_path / name))
        for f, a in convert.iopdata_to_numpy(got).items():
            np.testing.assert_array_equal(a, np.asarray(getattr(want, f)))
            np.testing.assert_array_equal(a, args[convert.IOP_FIELDS.index(f)])
        for t in (-100.0, 0.0, 900.0, 3600.0, 5000.0, 9e9):
            g = tscam.iop_forcing_at(got, t, 3)
            w = jscam.iop_forcing_at(want, t, 3)
            for f in convert.FORCING_FIELDS:
                assert_close(getattr(g, f), getattr(w, f), 1e-15, f)
    f = tscam.iop_forcing_at(got, 900.0, 3)
    np.testing.assert_allclose(npy(f.dtdt_ls)[0],
                               0.5 * (args[1][0] + args[1][1]), rtol=1e-12)


# ---------------------------------------------------------------------------
# IC and met files, the offline dynamics
# ---------------------------------------------------------------------------

def _jw(grid, coord, jg, jc, **kw):
    st, phis = tbw.jw_baroclinic_wave(grid, coord, device="cpu", **kw)
    jst, jphis = jbw.jw_baroclinic_wave(jg, jc, **kw)
    return st, phis, jst, jphis


@pytest.mark.parametrize("kw", [dict(), dict(perturb=False),
                                dict(moist=True, nq=2)],
                         ids=["perturbed", "steady", "moist"])
def test_jw_baroclinic_wave_matches_jax(kw):
    st, phis, jst, jphis = _jw(*_grids(), **kw)
    for f in convert.STATE_FIELDS:
        assert_close(getattr(st, f), getattr(jst, f), TOL_LEAF, f)
        assert getattr(st, f).is_contiguous()
    assert_close(phis, jphis, TOL_LEAF, "phis")


def test_ic_files_cross_packages(tmp_path):
    grid, coord, jg, jc = _grids()
    st, phis, _, _ = _jw(grid, coord, jg, jc, moist=True, nq=2)
    jst = jbw.DynState(**{k: jnp.asarray(v) for k, v in
                          convert.dynstate_to_numpy(st).items()})
    jphis = jnp.asarray(npy(phis))
    names = ("Q", "CLDLIQ")
    tini.write_inidat(str(tmp_path / "t.nc"), st, phis, grid, coord, names)
    jini.write_inidat(str(tmp_path / "j.nc"), jst, jphis, jg, jc, names)
    from scipy.io import netcdf_file
    with netcdf_file(str(tmp_path / "t.nc"), "r", mmap=False) as a, \
            netcdf_file(str(tmp_path / "j.nc"), "r", mmap=False) as b:
        assert set(a.variables) == set(b.variables)
        for v in a.variables:
            x, y = np.array(a.variables[v][:]), np.array(b.variables[v][:])
            if v == "T":             # pt·pkz: pressure_vars' log and pow
                assert_close(x, y, 1e-15, v)
            else:
                np.testing.assert_array_equal(x, y, v)
    for name in ("t.nc", "j.nc"):
        got, gphis = tini.read_inidat(str(tmp_path / name), grid, coord,
                                      names, pertlim=1e-3, device="cpu")
        want, wphis = jini.read_inidat(str(tmp_path / name), jg, jc, names,
                                       pertlim=1e-3)
        for f in convert.STATE_FIELDS:
            if f == "pt":
                assert_close(got.pt, want.pt, 1e-15, f)
            else:
                np.testing.assert_array_equal(npy(getattr(got, f)),
                                              np.asarray(getattr(want, f)),
                                              f"{name} {f}")
        np.testing.assert_array_equal(npy(gphis), np.asarray(wphis))
    # the round trip of tests/test_inidat_scam.py
    st2, _ = tini.read_inidat(str(tmp_path / "t.nc"), grid, coord, names,
                              device="cpu")
    np.testing.assert_allclose(npy(st2.u[:, 1:]), npy(st.u[:, 1:]),
                               atol=1e-12)
    np.testing.assert_allclose(npy(st2.delp), npy(st.delp), rtol=1e-12)
    np.testing.assert_allclose(npy(st2.pt), npy(st.pt), rtol=1e-10)
    np.testing.assert_allclose(npy(st2.q), npy(st.q), atol=1e-15)
    st3, _ = tini.read_inidat(str(tmp_path / "t.nc"), grid, coord,
                              ("Q", "DUST"), device="cpu")
    assert float(st3.q[1].abs().max()) == 0.0


def test_pole_average_and_pertlim_match_jax():
    a = np.random.default_rng(2).standard_normal((3, 4, 6))
    b = tini.pole_average(a)
    np.testing.assert_array_equal(b, jini.pole_average(a))
    assert (b[:, 0] == b[:, 0, :1]).all() and (b[:, -1] == b[:, -1, :1]).all()
    np.testing.assert_array_equal(b[:, 1:-1], a[:, 1:-1])
    t = np.full((3, 4), 250.0)
    t1 = tini.apply_pertlim(t, 1e-3, seed=1)
    np.testing.assert_array_equal(t1, jini.apply_pertlim(t, 1e-3, seed=1))
    np.testing.assert_array_equal(t1, tini.apply_pertlim(t, 1e-3, seed=1))
    assert np.abs(t1 / t - 1.0).max() <= 1e-3
    assert tini.apply_pertlim(t, 0.0) is t


def _met_series(st, ptop):
    """A met series of three records from a JW state: winds, T and ps
    scaled from record to record."""
    pe, _, pkz, _ = pressure_vars(st.delp, ptop)
    t = npy(st.pt * pkz / (1.0 + c.ZVIR * st.q[0]))
    ps = npy(pe[-1])
    sc = np.array([1.0, 1.1, 1.2])[:, None, None, None]
    return (np.arange(3) * 1800.0, npy(st.u)[None] * sc,
            npy(st.v)[None] + sc, t[None] * (1.0 + 0.01 * (sc - 1.0)),
            ps[None] * (1.0 + 1e-3 * (sc[..., 0] - 1.0)),
            [npy(st.q[0])[None] * sc, npy(st.q[1])[None] * sc])


def test_met_files_cross_packages_and_offline_dyn_run(tmp_path):
    grid, coord, jg, jc = _grids()
    st, _, jst, _ = _jw(grid, coord, jg, jc, moist=True, nq=2)
    args = _met_series(st, coord.ptop)
    jmet.save_metdata_netcdf(str(tmp_path / "j.nc"), *args)
    tmet.save_metdata_netcdf(str(tmp_path / "t.nc"), *args[:5],
                             [t64(q) for q in args[5]])
    for name in ("j.nc", "t.nc"):
        got = tmet.load_metdata_netcdf(str(tmp_path / name), coord,
                                       device="cpu")
        want = jmet.load_metdata_netcdf(str(tmp_path / name), jc)
        wnp = convert.metdata_to_numpy(want)
        for f, a in convert.metdata_to_numpy(got).items():
            np.testing.assert_array_equal(a, wnp[f], f"{name} {f}")
    # a MetData converted from JAX's drives the port's offline step
    met = convert.metdata_from_numpy(wnp, "cpu")
    for t in (-600.0, 0.0, 900.0, 1800.0, 2700.0, 1e6):
        g, w = tmet.met_state_at(met, t), jmet.met_state_at(want, t)
        for f in convert.STATE_FIELDS:
            assert_close(getattr(g, f), getattr(w, f), 1e-15, f"{t} {f}")
    for rlx in (0.0, 0.3):
        g = tmet.offline_dyn_run(st, met, 0.0, 900.0, met_rlx=rlx)
        w = jmet.offline_dyn_run(jst, want, 0.0, 900.0, met_rlx=rlx)
        for f in convert.STATE_FIELDS:
            assert_close(getattr(g, f), getattr(w, f), 1e-15, f"{rlx} {f}")
    # tests/test_dyn_extras.py's offline checks: midway interpolation,
    # clamping, overwrite, tracers untouched
    mid = tmet.met_state_at(met, 900.0)
    np.testing.assert_allclose(npy(mid.u), 0.5 * (args[1][0] + args[1][1]),
                               rtol=1e-12)
    np.testing.assert_allclose(npy(tmet.met_state_at(met, -500.0).u),
                               args[1][0], rtol=1e-12)
    out = tmet.offline_dyn_run(st, met, 0.0, 1800.0)
    np.testing.assert_allclose(npy(out.u), args[1][1], rtol=1e-12)
    assert torch.equal(out.q, st.q)


# ---------------------------------------------------------------------------
# Rayleigh friction, TEM, climatology
# ---------------------------------------------------------------------------

class _Cols:
    def __init__(self, u, v):
        self.u, self.v = u, v


@pytest.fixture(scope="module")
def cols():
    ncol, pver = 4, 20
    pint = torch.linspace(1e2, 1e5, pver + 1,
                          dtype=torch.float64).expand(ncol, pver + 1)
    st = make_state_from_profiles(
        pint, torch.full((ncol, pver), 260.0, dtype=torch.float64),
        torch.full((ncol, pver), 30.0, dtype=torch.float64),
        torch.full((ncol, pver), -10.0, dtype=torch.float64),
        torch.full((ncol, pver, 1), 1e-5, dtype=torch.float64),
        torch.zeros(ncol, dtype=torch.float64))
    return st


def test_rayleigh_friction_matches_jax():
    rng = np.random.default_rng(4)
    u, v = 30.0 * rng.standard_normal((5, 26)), 10 * rng.standard_normal(
        (5, 26))
    for kw in (dict(), dict(rayk0=5, raykrange=2.0, raytau0=0.5),
               dict(raytau0=0.0)):
        got = trf.rayleigh_friction_tend(_Cols(t64(u), t64(v)), DT, **kw)
        want = jrf.rayleigh_friction_tend(_Cols(jnp.asarray(u),
                                                jnp.asarray(v)), DT, **kw)
        for g, w, n in zip(got, want, ("dudt", "dvdt", "dsdt")):
            assert_close(g, w, TOL_LEAF, f"{kw} {n}")


def test_rayleigh_physics(cols):
    """tests/test_rayleigh.py on the port: zero when disabled, drag at
    the top only and decaying with depth, kinetic energy into heat,
    never overshooting."""
    st = cols
    du, _, _ = trf.rayleigh_friction_tend(st, DT, raytau0=0.0)
    assert float(du.abs().max()) == 0.0
    du = npy(trf.rayleigh_friction_tend(st, DT, rayk0=2, raytau0=2.0)[0])
    assert du[0, 0] < 0.0 and abs(du[0, -1]) < 1e-3 * abs(du[0, 0])
    assert (np.diff(np.abs(du[0, :6])) <= 1e-12).all()
    du, dv, ds = trf.rayleigh_friction_tend(st, DT, rayk0=3, raytau0=1.0)
    u1, v1 = st.u + du * DT, st.v + dv * DT
    dke = 0.5 * ((u1 ** 2 + v1 ** 2) - (st.u ** 2 + st.v ** 2))
    np.testing.assert_allclose(npy(ds) * DT, -npy(dke), rtol=1e-12)
    du, _, _ = trf.rayleigh_friction_tend(st, DT, rayk0=5, raytau0=1e-4)
    u1 = npy(st.u + du * DT)
    assert (u1 >= 0.0).all() and (u1 <= npy(st.u) + 1e-12).all()


def test_ctem_diags_match_jax():
    rng = np.random.default_rng(5)
    f = {k: s * rng.standard_normal((KM, JM, IM))
         for k, s in (("u", 20.0), ("v", 5.0), ("om", 0.5))}
    f["t"] = 250.0 + 20.0 * rng.standard_normal((KM, JM, IM))
    grid, coord, jg, jc = _grids()
    st, _, _, _ = _jw(grid, coord, jg, jc)
    pe = npy(pressure_vars(st.delp, coord.ptop)[0])
    pm = 0.5 * (pe[1:] + pe[:-1])
    args = (f["u"], f["v"], f["om"], f["t"], pm)
    got = tctem.ctem_diags(*map(t64, args))
    want = jctem.ctem_diags(*map(jnp.asarray, args))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == (KM, JM)
        assert_close(got[k], want[k], TOL_LEAF, k)
    # a NaN and an inf: NaN in every target of their columns, as JAX's
    # one-hot contraction gives
    u = f["u"].copy()
    u[3, 4, 5], u[0, 7, 8], u[KM - 1, 2, 3] = np.nan, np.inf, -np.inf
    plev = jctem.default_ctem_levels(KM)
    g = npy(tctem.interp_to_pressure(t64(u), t64(pm), t64(plev)))
    w = np.asarray(jctem.interp_to_pressure(jnp.asarray(u), jnp.asarray(pm),
                                            plev))
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)])
    ok = np.isfinite(w)
    assert np.isnan(w).sum() > 0 and ok.sum() > 0
    assert_close(g[ok], w[ok], TOL_LEAF, "finite targets")


def _hs_like(km, jm, im):
    """tests/test_climatology.py's synthetic HS94-shaped fields."""
    plev = jctem.default_ctem_levels(km)
    lats = np.linspace(-90, 90, jm)
    pmid = np.broadcast_to(plev[:, None, None], (km, jm, im)).copy()
    lat3 = np.broadcast_to(lats[None, :, None], (km, jm, im))
    pnorm = pmid / 1.0e5
    u = 30.0 * np.exp(-((np.abs(lat3) - 45.0) / 12.0) ** 2) * \
        np.exp(-((pnorm - 0.25) / 0.25) ** 2) - \
        5.0 * np.exp(-(lat3 / 12.0) ** 2) * pnorm ** 2
    t = np.maximum((315.0 - 60.0 * np.sin(np.radians(lat3)) ** 2) *
                   pnorm ** 0.28, 200.0)
    return u, np.zeros_like(u), t, pmid, plev, lats


def test_climatology_matches_jax_and_checks():
    km, jm, im = 26, 48, 72
    u, v, t, pmid, plev, lats = _hs_like(km, jm, im)
    acc = tclimo.climo_init(km, jm, dtype=torch.float64, device="cpu")
    jacc = jclimo.climo_init(km, jm, dtype=jnp.float64)
    for s in (0.9, 1.0, 1.1):
        acc = tclimo.climo_update(acc, t64(u * s), t64(v), t64(t),
                                  t64(pmid))
        jacc = jclimo.climo_update(jacc, jnp.asarray(u * s), jnp.asarray(v),
                                   jnp.asarray(t), jnp.asarray(pmid))
    for k in jacc:
        assert_close(acc[k], jacc[k], TOL_LEAF, k)
    out, jout = tclimo.climo_resolve(acc), jclimo.climo_resolve(jacc)
    for k in jout:
        # a variance is a difference of two means of squares: held to
        # their scale
        scale = float(np.abs(jout[k[0]]).max()) ** 2 \
            if k.endswith("_var") else None
        assert_close(out[k], jout[k], TOL_LEAF, k, scale=scale)
    assert out["nsamples"] == 3.0
    np.testing.assert_allclose(out["u"], np.mean(u, -1), rtol=1e-12)
    checks = tclimo.hs94_checks(out, lats, plev)
    jchecks = jclimo.hs94_checks(jout, lats, plev)
    assert list(checks) == list(jchecks)
    for name, (val, ok) in checks.items():
        assert ok and jchecks[name][1], f"{name}: {val}"
        assert val == pytest.approx(jchecks[name][0], rel=1e-12)
    z = np.zeros_like(u)
    rest = tclimo.climo_update(
        tclimo.climo_init(km, jm, device="cpu"),
        *(torch.as_tensor(a, dtype=torch.float32)
          for a in (z, z, np.full_like(u, 250.0), pmid)), plev)
    assert not all(ok for _, ok in tclimo.hs94_checks(
        tclimo.climo_resolve(rest), lats, plev).values())


# ---------------------------------------------------------------------------
# JW06 physical checks on the port (tests/test_baroclinic_wave.py)
# ---------------------------------------------------------------------------

def test_jw_analytic_fields():
    u = float(tbw._u_balanced(t64(0.252), t64(np.pi / 4)))
    assert u == pytest.approx(35.0, abs=1e-10)
    assert float(tbw._u_balanced(t64(0.252), t64(0.0))) == \
        pytest.approx(0.0)
    t_eq = npy(tbw._temperature(t64(np.linspace(0.01, 1.0, 40)), t64(0.0)))
    assert t_eq[-1] == pytest.approx(309.95, abs=0.5) and t_eq.min() < 215.0
    assert float(tbw._temperature(t64(1.0), t64(np.deg2rad(60.0)))) < \
        t_eq[-1]
    phis = npy(tbw._phis(t64(np.linspace(-np.pi / 2, np.pi / 2, 19))))
    assert phis[0] == pytest.approx(-3093.5, abs=2.0)
    assert phis[-1] == pytest.approx(phis[0], abs=1e-6)
    assert phis[9] == pytest.approx(phis.max()) and phis.max() > 1000.0


def test_jw_state_balanced_and_moist():
    grid = tgrid.make_grid(48, 25, 12, device="cpu")
    coord = tvert.hybrid_coefficients(12, device="cpu")
    st, phis = tbw.jw_baroclinic_wave(grid, coord, perturb=True,
                                      device="cpu")
    for a in (st.u, st.v, st.pt, st.delp, phis):
        assert bool(torch.isfinite(a).all())
    assert float(st.u.max()) > 30.0 and float(st.v.abs().max()) == 0.0
    np.testing.assert_allclose(npy(pressure_vars(st.delp, coord.ptop)[0][-1]),
                               1.0e5, rtol=1e-12)
    q = npy(tbw.jw_baroclinic_wave(grid, coord, moist=True, nq=2,
                                   device="cpu")[0].q[0])
    assert q.max() > 5e-3 and q.min() >= 0.0
    assert q[:, 0, :].max() < 1e-4 and q[0].max() < 1e-4


def test_jw_unperturbed_jet_holds():
    """JW06 §4a on the port: 8 steps (4 h) of the balanced jet keep ps
    near p0, its zonal asymmetry small and the jet intact."""
    grid = tgrid.make_grid(72, 37, 16, device="cpu")
    coord = tvert.hybrid_coefficients(16, device="cpu")
    st, phis = tbw.jw_baroclinic_wave(grid, coord, perturb=False,
                                      device="cpu")
    u0max = float(st.u.max())
    for _ in range(8):
        st = tdc.dyn_run(st, grid, coord, phis,
                         FVConfig(nsplit=8, nspltrac=1), 1800.0)
    ps = npy(pressure_vars(st.delp, coord.ptop)[0][-1])
    assert np.abs(ps - 1.0e5).max() < 400.0
    assert np.abs(ps - ps.mean(-1, keepdims=True)).max() < 5.0
    assert abs(float(st.u.max()) - u0max) < 3.0
    assert float(st.v.abs().max()) < 1.5


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_scam_on_the_card():
    """scam_run_iop, 3 steps on test_torch_physpkg's 16 columns, float64,
    through the zm_tail kernel (one launch a step) against the CPU's plain
    tail: every field within 1e-9 of its max, ZM's indices equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    from cam_nor_physics_tpu_torch.ops import zm_tail_kernels
    cases = scam_cases()
    runs = {}
    for dev in ("cpu", "cuda"):
        reg = default_registry()
        st = convert.physstate_from_numpy(cases["state"], dev)
        ci = convert.camin_from_numpy(cases["cam_in"], dev)
        iop = convert.iopdata_from_numpy(cases["iop"], dev)
        zm_tail_kernels.zm_tail.launches = 0
        runs[dev] = _flat(*tscam.scam_run_iop(PhysConfig(), ZMConfig(), reg,
                                              st, ci, iop, DT, 3))
    assert zm_tail_kernels.zm_tail.launches == 3
    for k, w in runs["cpu"].items():
        if k in INDEX_KEYS:
            np.testing.assert_array_equal(runs["cuda"][k], w, k)
        else:
            assert_close(runs["cuda"][k], w, 1e-9, k)
