"""The coupled step's coupling and bookkeeping modules of the PyTorch port
against the JAX package, float64 on the CPU.

- dp_coupling on a 48 x 24 x 8 grid (jm != im, so a transposed column
  index cannot pass) with an asymmetric state: hs_initial_state plus
  seeded D-grid winds, tracers and a negative vapour value in some
  surface cells (the borrow fix). d_p_coupling within 1e-12 of each
  field's max; p_d_coupling of a perturbed physics state at the
  tolerances of tests/test_dp_coupling.py:65-87 (u, v atol 1e-12; delp
  rtol 1e-13; pt rtol 1e-12; q atol 1e-15), and the round trip
  p_d(d_p(state)) back to the state at the same tolerances;
  d_p_coupling_diags with use_gw_front and qbo_use_forcing at 1e-12.
- check_energy (column_energy, timestep_init, chng with every flux, fix,
  gmean), the physics-state helpers (set_wet_to_dry, set_dry_to_wet with
  a dry-type tracer, physics_dme_adjust "tht", ptend_scale, the
  tendency accumulator, exner), qneg4, cam_export and the surface fluxes
  (aquaplanet_sst's three profiles, bulk_surface_fluxes,
  slab_ocean_step), each within 1e-12 of each output's max.

None of these compiles zm_convr, so JAX runs in process.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cam_nor_physics_tpu.models.coupling import camsrfexch as jcx
from cam_nor_physics_tpu.models.coupling import dp_coupling as jdp
from cam_nor_physics_tpu.models.coupling import surface_fluxes as jsf
from cam_nor_physics_tpu.models.fv.cd_core import DynState as JDyn
from cam_nor_physics_tpu.models.fv.grid import make_grid as jmake_grid
from cam_nor_physics_tpu.models.fv.vertical import \
    hybrid_coefficients as jhybrid
from cam_nor_physics_tpu.models.physics import check_energy as jce
from cam_nor_physics_tpu.models.physics import constituents as jcn
from cam_nor_physics_tpu.models.physics import state as jst
from cam_nor_physics_tpu.ops import fill as jfill
from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.models.coupling import camsrfexch as tcx
from cam_nor_physics_tpu_torch.models.coupling import dp_coupling as tdp
from cam_nor_physics_tpu_torch.models.coupling import surface_fluxes as tsf
from cam_nor_physics_tpu_torch.models.fv.grid import make_grid
from cam_nor_physics_tpu_torch.models.fv.held_suarez import hs_initial_state
from cam_nor_physics_tpu_torch.models.fv.vertical import hybrid_coefficients
from cam_nor_physics_tpu_torch.models.physics import check_energy as tce
from cam_nor_physics_tpu_torch.models.physics import constituents as tcn
from cam_nor_physics_tpu_torch.models.physics import state as tst
from cam_nor_physics_tpu_torch.ops import fill as tfill
from cam_nor_physics_tpu_torch.utils import constants as tc
from torch_port_util import assert_close, npy, t64

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

IM, JM, KM = 48, 24, 8
TOL = 1e-12
DT = 1800.0
# tests/test_dp_coupling.py:65-87
DYN_TOL = {"u": ("atol", 1e-12), "v": ("atol", 1e-12),
           "delp": ("rtol", 1e-13), "pt": ("rtol", 1e-12),
           "q": ("atol", 1e-15)}


def _dyn_close(got, want, tag):
    for f, (kind, tol) in DYN_TOL.items():
        g, w = npy(getattr(got, f)), npy(getattr(want, f))
        assert g.shape == w.shape, (tag, f)
        if kind == "atol":
            np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                       err_msg=f"{tag} {f}")
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=0,
                                       err_msg=f"{tag} {f}")


@functools.cache
def _setup():
    """The port's and JAX's grid, coordinate and registry, and an
    asymmetric dycore state as numpy arrays."""
    grid = make_grid(IM, JM, KM, dtype=torch.float64, device="cpu")
    coord = hybrid_coefficients(KM, dtype=torch.float64, device="cpu")
    reg = tcn.default_registry()
    st = hs_initial_state(grid, coord, nq=reg.pcnst, pert=1.0)
    rng = np.random.default_rng(5)
    fields = convert.dynstate_to_numpy(st)
    fields["u"] = rng.normal(0.0, 15.0, (KM, JM, IM))
    fields["v"] = rng.normal(0.0, 10.0, (KM, JM, IM))
    q = rng.uniform(1e-6, 1e-3, (reg.pcnst, KM, JM, IM))
    q[0] = 1e-2 * (fields["delp"] / fields["delp"].max()) ** 2
    q[0, -1, 3:7, 10:20] = -2e-6            # the bottom-layer borrow
    q[1, 2, 5, :4] = -1e-9                  # below qmin: qneg3
    fields["q"] = q
    phis = rng.uniform(0.0, 2e3, (JM, IM))
    jgrid, jcoord = jmake_grid(IM, JM, KM), jhybrid(KM)
    return (grid, coord, reg, fields, phis, jgrid, jcoord,
            jcn.default_registry())


def _tdyn(fields):
    return convert.dynstate_from_numpy(fields, "cpu")


def _jdyn(fields):
    return JDyn(**{f: jnp.asarray(a) for f, a in fields.items()})


def _jphys(pstate):
    return jst.PhysicsState(**{f: jnp.asarray(a) for f, a in
                               convert.physstate_to_numpy(pstate).items()})


@functools.cache
def _exports():
    grid, coord, reg, fields, phis, jgrid, jcoord, jreg = _setup()
    omega = np.random.default_rng(6).normal(0.0, 0.1, (KM, JM, IM))
    got = tdp.d_p_coupling(_tdyn(fields), grid, t64(phis), coord.ptop, reg,
                           omega=t64(omega))
    want = jax.jit(lambda s, ph, om: jdp.d_p_coupling(
        s, jgrid, ph, jcoord.ptop, jreg, omega=om))(
        _jdyn(fields), jnp.asarray(phis), jnp.asarray(omega))
    return got, want


def test_column_layout_is_row_major():
    """Column j*im + i, level k holds a[k, j, i], and back."""
    a = np.random.default_rng(1).standard_normal((2, KM, JM, IM))
    cols = tdp._to_cols(t64(a)).numpy()
    assert cols.shape == (2, JM * IM, KM)
    j, i, k = 7, 31, 5
    assert cols[1, j * IM + i, k] == a[1, k, j, i]
    np.testing.assert_array_equal(cols, np.asarray(jdp._to_cols(a)))
    back = tdp._from_cols(t64(cols), JM, IM)
    np.testing.assert_array_equal(back.numpy(), a)
    assert back.is_contiguous()


def test_d_p_coupling_matches_jax():
    got, want = _exports()
    g, w = convert.physstate_to_numpy(got), convert.physstate_to_numpy(want)
    assert set(g) == set(w)
    for f in g:
        assert_close(g[f], w[f], TOL, f)
    # the borrow fix and qneg3 did their work
    assert (g["q"] >= 1e-12).all()
    # the level fields and tracers are contiguous (psdry and the
    # bookkeeping columns may be slices)
    for f in ("t", "u", "v", "s", "omega", "pmid", "pdel", "pint", "q",
              "zi", "zm"):
        assert getattr(got, f).is_contiguous(), f


def _physics_changes(pstate, rng):
    """The exported state with physics-like increments of T, u, v, q and
    pdel."""
    ncol, pver, _ = pstate.q.shape
    return pstate.replace(
        t=pstate.t + t64(rng.normal(0.0, 0.5, (ncol, pver))),
        u=pstate.u + t64(rng.normal(0.0, 1.0, (ncol, pver))),
        v=pstate.v + t64(rng.normal(0.0, 1.0, (ncol, pver))),
        q=pstate.q * t64(1.0 + rng.uniform(-0.05, 0.05, pstate.q.shape)),
        pdel=pstate.pdel * t64(1.0 + rng.uniform(-1e-4, 1e-4,
                                                 (ncol, pver))))


def test_p_d_coupling_matches_jax():
    grid, coord, reg, fields, phis, jgrid, jcoord, jreg = _setup()
    exported, _ = _exports()
    changed = _physics_changes(exported, np.random.default_rng(7))
    got = tdp.p_d_coupling(_tdyn(fields), changed, grid, coord.ptop, DT,
                           reg)
    want = jax.jit(lambda s, ps: jdp.p_d_coupling(
        s, ps, jgrid, jcoord.ptop, DT, jreg))(_jdyn(fields),
                                             _jphys(changed))
    _dyn_close(got, want, "p_d_coupling")
    for f in convert.STATE_FIELDS:
        assert getattr(got, f).is_contiguous(), f


def test_round_trip_identity():
    """p_d_coupling(d_p_coupling(state)) with no physics tendencies gives
    the state back (tests/test_dp_coupling.py::test_round_trip_identity),
    on the all-positive tracers."""
    grid, coord, reg, fields, phis, _, _, _ = _setup()
    fields = dict(fields, q=np.abs(fields["q"]) + 1e-6)
    st = _tdyn(fields)
    ps = tdp.d_p_coupling(st, grid, t64(phis), coord.ptop, reg)
    ps = tst.set_dry_to_wet(ps, reg)
    back = tdp.p_d_coupling(st, ps, grid, coord.ptop, DT, reg)
    _dyn_close(back, st, "round trip")


def test_d_p_coupling_diags_match_jax():
    grid, coord, reg, fields, phis, jgrid, jcoord, jreg = _setup()
    om = np.random.default_rng(9).standard_normal((KM, JM, IM))
    got = tdp.d_p_coupling_diags(_tdyn(fields), grid, coord.ptop,
                                 omega=t64(om), use_gw_front=True,
                                 qbo_use_forcing=True,
                                 do_circulation_diags=True)
    want = jax.jit(lambda s, o: jdp.d_p_coupling_diags(
        s, jgrid, jcoord.ptop, omega=o, use_gw_front=True,
        qbo_use_forcing=True, do_circulation_diags=True))(
        _jdyn(fields), jnp.asarray(om))
    assert set(got) == set(want) == {"FRONTGF", "FRONTGA", "UZM", "ctem"}
    for k in ("FRONTGF", "FRONTGA", "UZM"):
        assert got[k].shape == (JM * IM, KM)
        assert_close(got[k], want[k], TOL, k)
    # the TEM diagnostics (fv/ctem), ported since they raised
    assert set(got["ctem"]) == set(want["ctem"]) == {
        "U2d", "V2d", "W2d", "TH2d", "VTH2d", "WTH2d", "UV2d", "UW2d"}
    for k, w in want["ctem"].items():
        assert got["ctem"][k].shape == (KM, JM)
        assert_close(got["ctem"][k], w, TOL, k)
    assert tdp.d_p_coupling_diags(_tdyn(fields), grid, coord.ptop) == {}


# ---- check_energy ----

def _fluxes(ncol, seed):
    rng = np.random.default_rng(seed)
    return {"flx_vap": rng.uniform(0, 1e-4, ncol),
            "flx_cnd": rng.uniform(0, 1e-7, ncol),
            "flx_ice": rng.uniform(0, 1e-8, ncol),
            "flx_sen": rng.normal(0, 50.0, ncol)}


def test_check_energy_matches_jax():
    exported, jexported = _exports()
    reg, jreg = tcn.default_registry(), jcn.default_registry()
    for g, w in zip(tce.column_energy(exported, reg),
                    jce.column_energy(jexported, jreg)):
        assert_close(g, w, TOL, "column_energy")
    got = tce.check_energy_timestep_init(exported, reg)
    want = jce.check_energy_timestep_init(jexported, jreg)
    for f in ("te_ini", "te_cur", "tw_ini", "tw_cur"):
        assert_close(getattr(got, f), getattr(want, f), TOL, f)
    heated = got.replace(t=got.t + 0.3)
    jheated = want.replace(t=want.t + 0.3)
    fl = _fluxes(got.ncol, 3)
    s1, d1 = tce.check_energy_chng(heated, reg, DT,
                                   **{k: t64(v) for k, v in fl.items()})
    s2, d2 = jce.check_energy_chng(jheated, jreg, DT,
                                   **{k: jnp.asarray(v)
                                      for k, v in fl.items()})
    for f in ("te", "tw"):
        assert_close(getattr(d1, f), getattr(d2, f), TOL, f)
    # the residuals are differences of ~1e9 J/m2: held to te's scale
    for f, scale in (("te_err", d2.te), ("tw_err", d2.tw)):
        assert_close(getattr(d1, f), getattr(d2, f), TOL, f,
                     scale=float(np.abs(npy(scale)).max()))
    assert_close(s1.te_cur, s2.te_cur, TOL, "te_cur after chng")
    teout = npy(got.te_cur) * (1.0 + 1e-5)
    assert_close(tce.check_energy_fix(got, reg, t64(teout)),
                 jce.check_energy_fix(want, jreg, jnp.asarray(teout)), TOL,
                 "check_energy_fix")
    assert_close(tce.check_energy_gmean(got, reg),
                 jce.check_energy_gmean(want, jreg), TOL, "gmean")


# ---- state helpers ----

def _dry_registry(mod):
    return mod.default_registry().add(
        mod.Constituent("DRYT", qmin=0.0, mixtype="dry"))


def _state_with_dry_tracer():
    exported, _ = _exports()
    extra = t64(np.random.default_rng(8).uniform(1e-9, 1e-7,
                                                 exported.q.shape[:2]))
    st = exported.replace(q=torch.cat([exported.q, extra[:, :, None]], -1))
    return st, _jphys(st)


@pytest.mark.parametrize("fn", ["set_wet_to_dry", "set_dry_to_wet"])
def test_wet_dry_conversion_matches_jax(fn):
    st, jst_ = _state_with_dry_tracer()
    got = getattr(tst, fn)(st, _dry_registry(tcn))
    want = getattr(jst, fn)(jst_, _dry_registry(jcn))
    assert_close(got.q, want.q, TOL, fn)
    # only the dry-type tracer moved
    np.testing.assert_array_equal(got.q[:, :, :3].numpy(),
                                  st.q[:, :, :3].numpy())
    assert not torch.equal(got.q[:, :, 3], st.q[:, :, 3])


def test_physics_dme_adjust_matches_jax():
    st, jst_ = _state_with_dry_tracer()
    qini = npy(st.q[:, :, 0]) * (1.0 - 0.02)
    got = tst.physics_dme_adjust(st, t64(qini), _dry_registry(tcn))
    want = jst.physics_dme_adjust(jst_, jnp.asarray(qini),
                                  _dry_registry(jcn), "tht")
    g, w = convert.physstate_to_numpy(got), convert.physstate_to_numpy(want)
    for f in g:
        assert_close(g[f], w[f], TOL, f)


def test_physics_dme_adjust_keeps_column_enthalpy():
    """The tht correction restores each column's
    sum(pdel (cp T + (Lv + Li) qv)) across the mass change."""
    st, _ = _state_with_dry_tracer()
    qini = npy(st.q[:, :, 0]) * (1.0 - 0.02)
    got = tst.physics_dme_adjust(st, t64(qini), _dry_registry(tcn))

    def enthalpy(s):
        return torch.sum(s.pdel * (tc.CPAIR * s.t + (tc.LATVAP + tc.LATICE)
                                   * s.q[:, :, 0]), -1)

    e0, e1 = enthalpy(st), enthalpy(got)
    assert not torch.equal(got.pdel, st.pdel)
    assert torch.max(torch.abs(e1 - e0) / torch.abs(e0)) < 1e-14


def test_ptend_scale_tend_accumulator_and_exner_match_jax():
    st, jst_ = _state_with_dry_tracer()
    ncol, pver, pcnst = st.q.shape
    rng = np.random.default_rng(9)
    vals = {"s": rng.normal(0, 0.05, (ncol, pver)),
            "u": rng.normal(0, 1e-3, (ncol, pver)),
            "v": rng.normal(0, 1e-3, (ncol, pver)),
            "q": rng.normal(0, 1e-9, (ncol, pver, pcnst)),
            "cflx_srf": rng.normal(0, 1e-5, (ncol, pcnst))}
    tp = tst.ptend_init("x", ncol, pver, pcnst, ls=True, lu=True, lv=True)
    tp = tp.replace(**{k: t64(v) for k, v in vals.items()},
                    bot_level=pver - 3)
    jp = jst.ptend_init("x", ncol, pver, pcnst, ls=True, lu=True, lv=True)
    jp = jp.replace(**{k: jnp.asarray(v) for k, v in vals.items()},
                    bot_level=pver - 3)
    got, want = tst.ptend_scale(tp, 0.25), jst.ptend_scale(jp, 0.25)
    for f in tst.PTEND_FIELDS:
        assert_close(getattr(got, f), getattr(want, f), TOL, f)
    tend0 = tst.PhysicsTend.zeros(ncol, pver)
    jtend0 = jst.PhysicsTend.zeros(ncol, pver)
    tend = tst.tend_update(tst.tend_update(tend0, tp), got)
    _, jtend = jst.physics_update(jst_, jp, DT, _dry_registry(jcn), jtend0)
    _, jtend = jst.physics_update(jst_, want, DT, _dry_registry(jcn), jtend)
    for f in tst.TEND_FIELDS:
        assert_close(getattr(tend, f), getattr(jtend, f), TOL, f)
    assert float(tend.dtdt[:, -1].abs().max()) == 0.0   # bot_level
    assert_close(st.exner, jst_.exner, TOL, "exner")


def test_qneg4_matches_jax():
    rng = np.random.default_rng(10)
    cflx = rng.normal(0.0, 1e-4, (40, 3))
    qbot = rng.uniform(0.0, 1e-6, (40, 3))
    pdel = rng.uniform(500.0, 2000.0, (40, 3))
    got = tfill.qneg4(t64(cflx), t64(qbot), t64(pdel), DT, 9.80616)
    want = jfill.qneg4(jnp.asarray(cflx), jnp.asarray(qbot),
                       jnp.asarray(pdel), DT, 9.80616)
    assert_close(got, want, TOL, "qneg4")
    assert (npy(got) != cflx).any()                  # the limiter bit


# ---- surface exchange ----

def test_cam_export_and_camin_match_jax():
    exported, jexported = _exports()
    rng = np.random.default_rng(11)
    ncol = exported.ncol
    prec, snow = rng.uniform(0, 1e-7, ncol), rng.uniform(0, 1e-8, ncol)
    got = tcx.cam_export(exported, t64(prec), t64(snow))
    want = jcx.cam_export(jexported, jnp.asarray(prec), jnp.asarray(snow))
    g, w = convert.camout_to_numpy(got), convert.camout_to_numpy(want)
    for f in g:
        assert_close(g[f], w[f], TOL, f)
    gz = convert.camin_to_numpy(tcx.CamIn.zeros(ncol, 3))
    wz = convert.camin_to_numpy(jcx.CamIn.zeros(ncol, 3))
    for f in gz:
        np.testing.assert_array_equal(gz[f], wz[f], f)
    back = convert.camin_to_numpy(convert.camin_from_numpy(wz, "cpu"))
    for f in gz:
        np.testing.assert_array_equal(back[f], wz[f], f)


@pytest.mark.parametrize("profile", ["control", "flat", "qobs"])
def test_aquaplanet_sst_matches_jax(profile):
    lat = np.linspace(-np.pi / 2, np.pi / 2, 97)
    assert_close(tsf.aquaplanet_sst(t64(lat), profile),
                 jsf.aquaplanet_sst(jnp.asarray(lat), profile), TOL,
                 profile)


def test_bulk_surface_fluxes_and_slab_ocean_match_jax():
    exported, jexported = _exports()
    sst = tsf.aquaplanet_sst(exported.lat)
    jsst = jnp.asarray(npy(sst))
    got = tsf.bulk_surface_fluxes(exported, sst, 3)
    want = jsf.bulk_surface_fluxes(jexported, jsst, 3)
    g, w = convert.camin_to_numpy(got), convert.camin_to_numpy(want)
    for f in g:
        assert_close(g[f], w[f], TOL, f)
    assert (g["lhf"] > 0).any() and (g["shf"] != 0).any()
    rng = np.random.default_rng(12)
    ncol = exported.ncol
    out = {f: rng.uniform(0, 300.0, ncol) for f in ("netsw", "flwds")}
    out.update({f: rng.uniform(0, 1e-8, ncol) for f in ("precsc", "precsl")})
    tout = tcx.cam_export(exported, t64(np.zeros(ncol)),
                          t64(np.zeros(ncol))).replace(
        **{k: t64(v) for k, v in out.items()})
    jout = jcx.cam_export(jexported, jnp.zeros(ncol),
                          jnp.zeros(ncol)).replace(
        **{k: jnp.asarray(v) for k, v in out.items()})
    qflux = rng.normal(0, 20.0, ncol)
    assert_close(tsf.slab_ocean_step(sst, got, tout, DT, q_flux=t64(qflux)),
                 jsf.slab_ocean_step(jsst, want, jout, DT,
                                     q_flux=jnp.asarray(qflux)),
                 TOL, "slab_ocean_step")
