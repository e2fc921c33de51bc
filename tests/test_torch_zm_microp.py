"""ZM's in-plume microphysics and the PBL-mixed parcel in the PyTorch port,
float64 on the CPU.

- Against the JAX package (tests/torch_port_microp_ref.py, in a fresh
  interpreter that runs while the port computes, shared with the
  aerosol's and SCAM's references: torch_port_util.shared_jax_reference;
  ROADMAP R1), on inputs
  made here from numpy seeds:
  - zm_convr(ZMConfig(microp=True)) on 16 columns of
    test_zm_conv.make_sounding(unstable=True, seed=3), the last 8 over
    ocean: every ZMConvOut field within 1e-10 of its max, the trigger and
    the level indices equal, mrates with JAX's keys and values;
  - buoyan_dilute with parcel_pbl for both parcel forms (batched with
    newton, scan with brent), PBL heights spread over 300-2000 m: 1e-10;
  - zm_mphy alone on a synthetic plume, with and without an aerosol
    bundle, zm_conv_evap with prdsnow (the microp snow path, partial melt
    under warm levels) and activated_number: 1e-12;
  - zm_conv_tend(microp=True) on 16 columns of entry.varied_zm_inputs,
    with and without an aerosol bundle: every ptend, state, pbuf, coupler
    and diagnostic field (the key sets equal) within 1e-10 of its max.
  Tolerances as tests/test_zm_microphysics.py and
  tests/test_torch_zm_slice.py state them; a field whose values are all
  far below the scale of the flux they come from (the snow-rate residue
  of ROADMAP's notes) is held to that flux's scale.
- The physical checks of tests/test_zm_microphysics.py, on the port
  alone: frz only on cold plume levels, its heat in q1q2 exactly, dcape
  > 0 and in the reported CAPE, no negative projected vapour, prec with
  the detrained ice, ice and crystal detrainment, droplet number under
  the activation cap, ocean with fewer droplets than land, an aerosol
  bundle controlling the activation, the updraft velocity, the rates
  family, and the energy closure through tphysbc.
- A TOML with microp = true through config_from_toml and driver.run:
  chunk 2 bitwise to chunk 1, the microp family on the tape.
- On a card (marked cuda, skipped here): two coupled microp steps in
  float64, kernels against the CPU's plain versions within 1e-9, no
  zm_tail launch.
"""

import numpy as np
import pytest
import torch

from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import varied_zm_inputs
from cam_nor_physics_tpu_torch.models.physics import zm_conv as tzm
from cam_nor_physics_tpu_torch.models.physics import zm_conv_intr as tzi
from cam_nor_physics_tpu_torch.models.physics.constituents import \
    default_registry
from cam_nor_physics_tpu_torch.models.physics.zm_microphysics import (
    NACT_LND, NACT_OCN, activated_number)
from cam_nor_physics_tpu_torch.utils import constants as c
from cam_nor_physics_tpu_torch.utils.config import ZMConfig
from test_zm_conv import MSG, make_sounding
from torch_port_util import npy, shared_jax_reference

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

SOUNDING = ("t", "q", "pmid", "pint", "pdel", "zm", "geos", "zi", "pblh",
            "tpert", "landfrac")
TOL = 1e-10
TOL_LEAF = 1e-12
INT_KEYS = {"jt", "maxg", "jctop", "jcbot", "ideep", "lcl", "lel", "mx",
            "pbuf.ZM_JT", "pbuf.ZM_MAXG", "pbuf.ZM_IDEEP", "jcbot", "jctop"}
PBL_CFGS = {"batched": dict(parcel_pbl=True),
            "scan": dict(parcel_pbl=True, parcel_impl="scan",
                         inversion_solver="brent")}
MPHY_ORDER = ("su", "qu", "mu", "du", "eu", "cmel", "cmei", "dz", "zf_top",
              "p", "t", "q", "jt", "jb", "active", "landfrac")
EVAP_ORDER = ("t", "pmid", "pdel", "q", "landfrac", "prdprec", "cldfrc")
DT = 1800.0


def _sounding(ncol=16, seed=3):
    s = {k: np.array(v) for k, v in make_sounding(
        ncol=ncol, pver=26, unstable=True, seed=seed).items()}
    s["landfrac"][ncol // 2:] = 0.0
    return s


def _pbl_case(s, rng):
    """buoyan_dilute's arguments as zm_convr forms them (zm_conv.F90:
    822-858), PBL heights spread."""
    ncol, pver = s["t"].shape
    pblh = rng.uniform(300.0, 2000.0, ncol)
    zs = s["geos"] / c.GRAVIT
    z, zf = s["zm"] + zs[:, None], s["zi"] + zs[:, None]
    dz = zf[:, :-1] - zf[:, 1:]
    k = np.arange(pver)[None, :]
    near = (np.abs(z - zs[:, None] - pblh[:, None]) < dz * 0.5) & \
        (k >= MSG) & (k <= pver - 2)
    pblt = np.where(near.any(1), near.argmax(1), pver - 1).astype(float)
    return dict(msg=MSG, q=s["q"], t=s["t"], p=s["pmid"] * 0.01, z=z,
                pf=s["pint"] * 0.01, zi=s["zi"], zs=zs, pblt=pblt,
                tpert=s["tpert"], landfrac=s["landfrac"],
                dmpdz=np.full_like(s["t"], -ZMConfig().tentrm),
                cfgs=PBL_CFGS)


def _aero(rng, shape, hygro):
    return dict(num=rng.uniform(0.5e8, 5e8, shape),
                dgnum=rng.uniform(0.05e-6, 0.3e-6, shape), hygro=hygro)


def _mphy_case(s, rng):
    """A synthetic plume on the sounding: plume T 0-2 K above the
    environment, mass flux, entrainment, detrainment and condensation in
    [jt, jb], 2 of 16 columns inactive."""
    ncol, pver = s["t"].shape
    k = np.arange(pver)[None, :]
    jt = rng.integers(3, 8, ncol)
    jb = np.full(ncol, pver - 3)
    inw = (k >= jt[:, None]) & (k <= jb[:, None])
    zf_top = s["zi"][:, :-1]
    qu = s["q"] * 1.05
    cu = np.where(inw, 5e-7 * rng.uniform(0.2, 1.0, (ncol, pver)), 0.0)
    fice = np.clip((c.TMELT - s["t"]) / 40.0, 0.0, 1.0)
    active = np.ones(ncol, bool)
    active[[2, 9]] = False
    return dict(
        su=s["t"] + rng.uniform(0.0, 2.0, (ncol, pver)) +
        (c.GRAVIT / c.CPAIR) * zf_top / (1.0 + c.CPVIR * qu),
        qu=qu, mu=np.where(inw, rng.uniform(0.2, 1.0, (ncol, pver)), 0.0),
        du=np.where(inw, 2e-4 * rng.uniform(size=(ncol, pver)), 0.0),
        eu=np.where(inw, 3e-4 * rng.uniform(size=(ncol, pver)), 0.0),
        cmel=cu * (1.0 - fice), cmei=cu * fice,
        dz=s["zi"][:, :-1] - s["zi"][:, 1:], zf_top=zf_top,
        p=s["pmid"] * 0.01, t=s["t"], q=s["q"], jt=jt, jb=jb,
        active=active, landfrac=s["landfrac"],
        aero=_aero(rng, (ncol, pver, 1), (0.5,)), order=MPHY_ORDER)


def _evap_case(s, rng):
    """Rain and snow produced aloft, some of the snow falling through
    levels warmer than tmelt (the partial melt)."""
    ncol, pver = s["t"].shape
    k = np.arange(pver)[None, :]
    prdprec = np.where((k >= 6) & (k <= pver - 4),
                       1e-8 * rng.uniform(0.1, 1.0, (ncol, pver)), 0.0)
    prdsnow = prdprec * 0.8 * np.clip((c.TMELT - s["t"]) / 10.0, 0.0, 1.0)
    prec_in = 0.9 * (prdprec * s["pdel"]).sum(1) / c.GRAVIT / 1000.0
    return dict(t=s["t"], pmid=s["pmid"], pdel=s["pdel"], q=s["q"],
                landfrac=s["landfrac"], prdprec=prdprec,
                cldfrc=0.2 * rng.uniform(size=(ncol, pver)), deltat=DT,
                prec_in=prec_in, prdsnow=prdsnow, order=EVAP_ORDER)


def _tend_case(rng):
    pstate, pbuf, forcing = varied_zm_inputs(16, 26, torch.float64, "cpu")
    return dict(state=convert.physstate_to_numpy(pstate),
                pbuf=convert.pbuf_to_numpy(pbuf),
                **{k: v.numpy() for k, v in forcing.items()}, dt=DT,
                aero=_aero(rng, (16, 26, 1), (0.1,)))


def _cases():
    rng = np.random.default_rng(20)
    s = _sounding()
    return dict(convr=dict(s, msg=MSG), pbl=_pbl_case(s, rng),
                mphy=_mphy_case(s, rng), evap=_evap_case(s, rng),
                act=_aero(rng, (16, 26, 2), (0.5, 0.0005)),
                tend=_tend_case(rng))


def _t(a):
    return torch.from_numpy(np.array(a))


def _taero(a):
    return None if a is None else dict(num=_t(a["num"]), dgnum=_t(a["dgnum"]),
                                       hygro=tuple(a["hygro"]))


def _flat_convr(out):
    res = {f: npy(getattr(out, f)) for f in tzm.ZMCONV_FIELDS
           if f != "mrates"}
    res.update({f"mr.{k}": npy(v) for k, v in out.mrates.items()})
    return res


def _port(cases):
    """The port's counterpart of torch_port_microp_ref.run_zm."""
    out = {}
    cv = cases["convr"]
    out["convr"] = _flat_convr(tzm.zm_convr(
        ZMConfig(microp=True), MSG, *[_t(cv[k]) for k in SOUNDING], 900.0))
    b = cases["pbl"]
    for tag, kw in PBL_CFGS.items():
        res = tzm.buoyan_dilute(
            ZMConfig(**kw), MSG,
            *[_t(b[k]) for k in ("q", "t", "p", "z", "pf", "zi", "zs",
                                 "pblt", "tpert", "landfrac", "dmpdz")])
        out[f"pbl.{tag}"] = {f: npy(getattr(res, f))
                             for f in res.__dataclass_fields__}
    m = cases["mphy"]
    for tag, aero in (("clean", None), ("aero", m["aero"])):
        res = tzm.zm_mphy(ZMConfig(microp=True),
                          *[_t(m[k]) for k in MPHY_ORDER], aero=_taero(aero))
        flat = {f: npy(getattr(res, f)) for f in res.__dataclass_fields__
                if f != "rates"}
        flat.update({f"mr.{k}": npy(v) for k, v in res.rates.items()})
        out[f"mphy.{tag}"] = flat
    e = cases["evap"]
    out["evap"] = {k: npy(v) for k, v in tzm.zm_conv_evap(
        ZMConfig(), *[_t(e[k]) for k in EVAP_ORDER], DT, _t(e["prec_in"]),
        prdsnow=_t(e["prdsnow"])).items()}
    out["act"] = {"nact": npy(activated_number(_taero(cases["act"])))}
    t = cases["tend"]
    for tag, aero in (("clean", None), ("aero", t["aero"])):
        res = tzi.zm_conv_tend(
            ZMConfig(microp=True), default_registry(),
            convert.physstate_from_numpy(t["state"], "cpu"),
            convert.pbuf_from_numpy(*t["pbuf"], "cpu"),
            *[_t(t[k]) for k in ("pblh", "tpert", "landfrac")], DT,
            aero=_taero(aero))
        out[f"tend.{tag}"] = convert.zmtend_to_numpy(res)
    return out


def check(got, want, tol, tag, scales=None):
    """Every key of `want` in `got`, the key sets equal; integers and
    booleans equal, floats within tol of the field's max (or of
    scales[key])."""
    assert set(got) == set(want), (tag, set(got) ^ set(want))
    for k in sorted(want):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (tag, k, g.shape, w.shape)
        if k in INT_KEYS or w.dtype.kind in "bi":
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), f"{tag} {k}")
            continue
        scale = (scales or {}).get(k) or max(float(np.abs(w).max()), 1e-300)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                   err_msg=f"{tag} {k}")


def test_microp_matches_jax(tmp_path_factory):
    got, want = shared_jax_reference(tmp_path_factory, "zm", _port)
    assert set(got) == set(want)
    conv = want["convr"]
    assert conv["ideep"].all() and conv["frz"].max() > 0
    assert conv["dcape"].min() > 0 and conv["mr.BERGN_M"].max() > 0
    check(got["convr"], conv, TOL, "zm_convr")
    for tag in PBL_CFGS:
        check(got[f"pbl.{tag}"], want[f"pbl.{tag}"], TOL, f"pbl {tag}")
    # the PBL-mixed parcel launches elsewhere than the max-MSE level in
    # some columns and both forms trigger
    assert (want["pbl.batched"]["cape"] > 70.0).all()
    for tag in ("clean", "aero"):
        check(got[f"mphy.{tag}"], want[f"mphy.{tag}"], TOL_LEAF,
              f"zm_mphy {tag}")
    assert want["mphy.aero"]["qnl"].max() != want["mphy.clean"]["qnl"].max()
    assert want["mphy.clean"]["frz"].max() > 0
    # the surface rates are the bottom fluxes after melt and evaporation:
    # held to their column fluxes' scale (/1000: kg/m2/s -> m/s)
    ev = want["evap"]
    check(got["evap"], ev, TOL_LEAF, "zm_conv_evap(prdsnow)",
          scales={"prec": np.abs(ev["flxprec"]).max() / 1000.0,
                  "snow": np.abs(ev["flxsnow"]).max() / 1000.0})
    assert want["evap"]["snow"].max() > 0
    assert (want["evap"]["tend_s_snwevmlt"] < 0).any()
    check(got["act"], want["act"], TOL_LEAF, "activated_number")
    for tag in ("clean", "aero"):
        w = want[f"tend.{tag}"]
        check(got[f"tend.{tag}"], w, TOL, f"zm_conv_tend {tag}")
        assert {"diag.ZMFRZ", "diag.WUZM", "diag.ACTIV_N", "pbuf.DNLFZM",
                "pbuf.DP_CLDICE"} <= set(w)
        assert 0 < w["pbuf.ZM_IDEEP"].sum() < 16
    assert not np.array_equal(want["tend.aero"]["diag.QNLZM"],
                              want["tend.clean"]["diag.QNLZM"])


# ---------------------------------------------------------------------------
# the physical checks of tests/test_zm_microphysics.py, on the port alone
# ---------------------------------------------------------------------------

def _run(cfg=None, landfrac=None, aero=None, ncol=8):
    s = {k: _t(v) for k, v in make_sounding(ncol=ncol, pver=26,
                                            unstable=True, seed=3).items()}
    if landfrac is not None:
        s["landfrac"] = torch.full((ncol,), landfrac, dtype=torch.float64)
    out = tzm.zm_convr(cfg or ZMConfig(microp=True), MSG,
                       *[s[k] for k in SOUNDING], 900.0, aero=aero)
    return s, out


@pytest.fixture(scope="module")
def on():
    return _run()


@pytest.fixture(scope="module")
def off():
    return _run(ZMConfig())


def test_frz_localized_to_cold_plume_levels(on):
    s, out = on
    frz = npy(out.frz)
    assert frz.min() >= 0.0 and frz.max() > 0.0
    karr = np.arange(frz.shape[1])[None, :]
    in_plume = (karr >= npy(out.jt)[:, None]) & \
        (karr < npy(out.maxg)[:, None])
    assert (frz[~in_plume] == 0.0).all()
    assert (frz[npy(s["t"]) > c.TMELT + 10.0] == 0.0).all()


def test_freezing_heat_enters_at_freezing_levels(on):
    """q1q2's dsdt with the microp extras is exactly latice/cp frz where
    every mass-flux term is zero (zm_conv.F90:4378)."""
    s, out = on
    ncol, pver = out.frz.shape
    z = torch.zeros((ncol, pver), dtype=torch.float64)
    _, dsdt, _, _ = tzm.q1q2_pjr(
        MSG, z, z, z, z, z, z, z, torch.ones_like(z), z, z, z, z, z,
        torch.ones(ncol, dtype=torch.float64), out.jt, out.maxg, (z, z),
        microp_extra=(out.frz, z, z, z))
    karr = np.arange(pver)[None, :]
    jt, mx = npy(out.jt)[:, None], npy(out.maxg)[:, None]
    in_main = (karr >= jt) & (karr <= pver - 2) & (karr < mx)
    np.testing.assert_array_equal(npy(dsdt)[in_main],
                                  npy(c.LATICE / c.CPAIR * out.frz)[in_main])
    assert (npy(dsdt)[karr < jt] == 0.0).all()


def test_dcape_positive_and_boosts_cape(on, off):
    _, o = on
    _, f = off
    assert bool(o.ideep.all()) and float(o.dcape.max()) > 0.0
    np.testing.assert_allclose(npy(o.cape), npy(f.cape) + npy(o.dcape),
                               rtol=1e-10, atol=1e-8)


def test_no_negative_vapor_projection_and_prec(on):
    """The vapour fixer keeps q + 2 delt qtnd >= 0, and prec is the column
    moisture change with the detrained liquid and ice (zm_conv.F90:
    1400-1470, 1628-1639)."""
    s, out = on
    delt = 900.0
    q_new = npy(s["q"]) + 2.0 * delt * npy(out.qtnd)
    assert q_new.min() >= -1e-15
    dpp = npy(s["pdel"])
    acc = np.sum(-dpp * 2.0 * delt * npy(out.qtnd) -
                 dpp * (npy(out.dlf) + npy(out.dif)) * 2.0 * delt, 1)
    np.testing.assert_allclose(npy(out.prec), np.maximum(acc, 0.0) /
                               c.GRAVIT / (2.0 * delt) / 1000.0,
                               rtol=1e-10, atol=1e-18)
    assert (npy(out.rice) <= npy(out.rliq) + 1e-20).all()


def test_cold_plume_detrains_ice_and_numbers(on):
    _, out = on
    assert float(out.dif.max()) > 0.0 and float(out.dnif.max()) > 0.0
    assert float(out.sprd.min()) >= 0.0
    r, sp = npy(out.rprd), npy(out.sprd)
    assert (sp[r >= 0.0] <= r[r >= 0.0] + 1e-20).all()
    assert float(out.qnl.max()) <= NACT_LND * (1.0 + 1e-12)
    assert float(out.wu[out.ideep].max()) > 0.5
    assert bool(torch.isfinite(out.wu).all())


def test_ocean_fewer_droplets_and_aero_bundle():
    """Ocean columns activate fewer droplets than land ones, and a sparse
    aerosol bundle fewer than the land constants (the zm_aero_t path)."""
    _, lnd = _run(landfrac=1.0)
    _, ocn = _run(landfrac=0.0)
    assert float(ocn.qnl.max()) < float(lnd.qnl.max())
    assert float(ocn.qnl.max()) <= NACT_OCN * (1.0 + 1e-12)
    aero = dict(num=torch.full((8, 26, 1), 5.0e6, dtype=torch.float64),
                dgnum=torch.full((8, 26, 1), 0.1e-6, dtype=torch.float64),
                hygro=(0.5,))
    _, clean = _run(aero=aero)
    assert float(clean.qnl.max()) < float(lnd.qnl.max())


def test_rate_family_and_off_path(on, off):
    """The rates family (zm_conv_intr.F90:1292-1390): nonnegative, with
    the production bounding the evaporation-reduced rprd; microp off
    leaves every microp field zero and no rates."""
    s, out = on
    r = out.mrates
    assert tuple(r) == tzm.MPHY_RATE_KEYS
    for k, v in r.items():
        assert float(v.min()) >= 0.0, k
    for k in ("ACTIV_N", "BERGN_M"):
        assert float(r[k].max()) > 0.0, k
    assert float(r["FHTIM_M"].max()) + float(r["FHTCT_M"].max()) > 0.0
    dpm = npy(s["pdel"])
    prod = npy(r["AUTOL_M"]) + npy(r["ACCRL_M"]) + npy(out.sprd)
    assert (np.sum(prod * dpm, 1) >= np.sum(npy(out.rprd) * dpm, 1) -
            1e-12).all()
    _, f = off
    assert f.mrates == {}
    for name in ("dif", "dnlf", "dnif", "sprd", "frz", "qliq", "qice", "qnl",
                 "qni", "wu", "dcape"):
        assert float(getattr(f, name).abs().max()) == 0.0, name


def test_energy_closure_through_tphysbc():
    """tphysbc with microp: its check_energy budget (flx_cnd = prec +
    rliq, flx_ice = snow + rice) closes to roundoff, and the state stays
    finite (TestConservation of tests/test_zm_microphysics.py)."""
    from test_torch_physpkg import DT as PDT
    from test_torch_physpkg import _inputs
    from cam_nor_physics_tpu_torch.models.physics import physpkg as tpp
    from cam_nor_physics_tpu_torch.utils.config import PhysConfig
    st, pbuf, ci = _inputs()
    out = tpp.phys_run1(PhysConfig(radiation_scheme="gray"),
                        ZMConfig(microp=True), default_registry(), st, pbuf,
                        ci, PDT, nstep=1)
    assert float(out.diagnostics["ZM_TE_ERR"].abs().max()) < 1.0e-4
    assert float(out.diagnostics["ZMFRZ"].max()) > 0.0
    for f, a in convert.physstate_to_numpy(out.state).items():
        assert np.isfinite(a).all(), f


def test_toml_microp_runs_through_driver(tmp_path):
    """A TOML with microp = true (config_from_toml) runs through
    driver.run: chunk 2 bitwise equal to chunk 1 in state and tapes, and
    the microp family of the history catalog on the tape, finite, with
    freezing (the catalog is the JAX package's: tests/test_torch_driver.py
    holds it)."""
    from scipy.io import netcdf_file

    from cam_nor_physics_tpu_torch import driver as drv
    from cam_nor_physics_tpu_torch.bench import bitwise_equal
    from cam_nor_physics_tpu_torch.models.atm_comp import AtmModel, atm_init
    from cam_nor_physics_tpu_torch.models.coupling.camsrfexch import CamIn
    from cam_nor_physics_tpu_torch.models.fv.held_suarez import \
        hs_initial_state
    from cam_nor_physics_tpu_torch.utils.config import config_from_toml
    path = tmp_path / "microp.toml"
    path.write_text("[grid]\nim = 16\njm = 8\nkm = 10\n\n"
                    "[fv]\nnsplit = 2\nnspltrac = 1\n\n"
                    "[zm]\nmicrop = true\n\n"
                    "[phys]\nradiation_scheme = \"gray\"\n")
    cfg = config_from_toml(str(path))
    assert cfg.zm.microp and cfg.grid.im == 16
    g = cfg.grid
    model = AtmModel.create(g.im, g.jm, g.km, dt=g.dtime, fv_cfg=cfg.fv,
                            phys_cfg=cfg.phys, zm_cfg=cfg.zm, device="cpu")
    dyn = hs_initial_state(model.grid, model.coord, pert=1.0,
                           nq=model.registry.pcnst)
    q = torch.full_like(dyn.q, 1e-4)
    q[0] = 1.2e-2 * (dyn.delp / dyn.delp.max()) ** 2
    state0 = atm_init(model, dyn.replace(q=q),
                      torch.zeros((g.jm, g.im), dtype=torch.float64))
    ncol = g.jm * g.im
    cam_in = CamIn.zeros(ncol, model.registry.pcnst).replace(
        landfrac=torch.full((ncol,), 0.3, dtype=torch.float64))
    runs, tapes = {}, {}
    for chunk in (1, 2):
        out = tmp_path / f"c{chunk}"
        runs[chunk], _ = drv.run(model, state0, cam_in, 2, out_dir=str(out),
                                 hist_every=2, check_every=0, chunk=chunk)
        with netcdf_file(str(out / "h0.0000.nc"), mmap=False) as nc:
            tapes[chunk] = {k: np.array(v.data)
                            for k, v in nc.variables.items()}
    assert bitwise_equal(runs[1], runs[2])
    assert set(tapes[1]) == set(tapes[2])
    for k in tapes[1]:
        np.testing.assert_array_equal(tapes[1][k], tapes[2][k], err_msg=k)
    tape = tapes[1]
    for k in ("ZMFRZ", "ZMDCAPE", "WUZM", "DNLFZM", "CLDICEZM", "ACTIV_N",
              "FRZZM", "ZMSPRD"):
        assert k in tape and np.isfinite(tape[k]).all(), k
    assert tape["ZMFRZ"].max() > 0.0 and tape["ZMDCAPE"].max() > 0.0


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_microp_coupled_step_on_the_card():
    """Two coupled microp steps at 48 x 24 x 10, float64, on the card
    (the kernels) against the same steps on the CPU (their plain
    versions): each dycore and physics field within 1e-9 of its max, ZM's
    indices equal; the zm_tail kernel never launched (the plain tail runs
    under microp, as in the JAX package), K1 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    import dataclasses

    from cam_nor_physics_tpu_torch.entry import build_coupled
    from cam_nor_physics_tpu_torch.ops import cd_fused_kernels, \
        zm_tail_kernels
    from cam_nor_physics_tpu_torch.utils.config import FVConfig
    runs = {}
    for dev in ("cpu", "cuda"):
        _, step, state, _ = build_coupled(48, 24, 10, torch.float64, dev,
                                          fv_cfg=FVConfig(nsplit=4,
                                                          nspltrac=1),
                                          microp=True)
        zm_tail_kernels.zm_tail.launches = 0
        cd_fused_kernels.k1.launches = 0
        for i in range(2):
            state, _, _ = step(state, first_step=i == 0)
        runs[dev] = state
    assert zm_tail_kernels.zm_tail.launches == 0
    assert cd_fused_kernels.k1.launches > 0
    for grp in ("dyn", "phys"):
        g, w = getattr(runs["cuda"], grp), getattr(runs["cpu"], grp)
        for f in dataclasses.fields(w):
            x, y = npy(getattr(g, f.name)), npy(getattr(w, f.name))
            np.testing.assert_allclose(
                x, y, rtol=0, atol=1e-9 * max(float(np.abs(y).max()),
                                              1e-300), err_msg=f.name)
    for k in ("ZM_IDEEP", "ZM_JT", "ZM_MAXG"):
        np.testing.assert_array_equal(npy(runs["cuda"].pbuf.get(k)),
                                      npy(runs["cpu"].pbuf.get(k)), k)
