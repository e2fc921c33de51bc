"""The coupled step's physics package of the PyTorch port against the JAX
package, float64 on the CPU.

- The column schemes on 16 columns x 26 levels of entry.varied_zm_inputs
  (bench.py's sounding with per-column noise, winds and cloud tracers;
  latitudes spread from -75 to 75 degrees; the top layers of every other
  column made unstable for the dry adjustment): dadadj, the Thomas solve,
  the eddy diffusivities and vertical_diffusion_tend, the gray
  radiation's fluxes and radiation_tend, cldfrc with a convective mass
  flux and with a quiet one, and convect_diagnostics_calc, each within 1e-12
  of each output's max (JAX jitted in process: none of them reaches
  zm_convr).
- phys_run1 (tphysbc plus TEGMEAN) and phys_run2 (tphysac) on the same
  columns, with a physics buffer whose TEOUT is valid (so the energy
  fixer fires and the dynamics tendencies are formed), cam_in from
  bulk_surface_fluxes over aquaplanet_sst with the inputs' land mask.
  phys_run2 with radiation_scheme "gray" and the "rrtmg" stub, snapshots
  on, from the port's phys_run1 output against JAX's: every field of the
  state, the physics buffer, the tendency accumulator, cam_out and the
  diagnostics (the key sets equal) within 1e-10 of the field's max. The
  energy residual ZM_TE_ERR, a difference of two column energies of
  ~1e9 J/m2, is held to the column energy's scale. JAX's phys_run2 is
  jitted in process (it reaches no zm_convr). tphysbc is held to JAX's
  through the coupled step (test_torch_atm_comp.py, whose diagnostics
  carry tphysbc's snapshots); here phys_run1 with "rrtmg", and both
  phys_run1 and phys_run2 with snapshots off, are bitwise the "gray"
  snapshot run less its snapshots.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cam_nor_physics_tpu.models.coupling import camsrfexch as jcx
from cam_nor_physics_tpu.models.physics import cloud_fraction as jcf
from cam_nor_physics_tpu.models.physics import convect_diagnostics as jcd
from cam_nor_physics_tpu.models.physics import dadadj as jda
from cam_nor_physics_tpu.models.physics import physics_buffer as jpb
from cam_nor_physics_tpu.models.physics import radiation as jrad
from cam_nor_physics_tpu.models.physics import state as jst
from cam_nor_physics_tpu.models.physics import vertical_diffusion as jvd
from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import varied_zm_inputs
from cam_nor_physics_tpu_torch.models.coupling import camsrfexch as tcx
from cam_nor_physics_tpu_torch.models.coupling.surface_fluxes import (
    aquaplanet_sst, bulk_surface_fluxes)
from cam_nor_physics_tpu_torch.models.physics import cloud_fraction as tcf
from cam_nor_physics_tpu_torch.models.physics import \
    convect_diagnostics as tcd
from cam_nor_physics_tpu_torch.models.physics import dadadj as tda
from cam_nor_physics_tpu_torch.models.physics import physics_buffer as tpb
from cam_nor_physics_tpu_torch.models.physics import physpkg as tpp
from cam_nor_physics_tpu_torch.models.physics import radiation as trad
from cam_nor_physics_tpu_torch.models.physics import \
    vertical_diffusion as tvd
from cam_nor_physics_tpu_torch.models.physics.check_energy import \
    check_energy_timestep_init
from cam_nor_physics_tpu_torch.models.physics.constituents import \
    default_registry
from cam_nor_physics_tpu_torch.models.physics.state import TEND_FIELDS
from cam_nor_physics_tpu_torch.utils.config import PhysConfig, ZMConfig
from torch_port_util import assert_close, npy, t64

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

NCOL, PVER = 16, 26
TOL = 1e-12
TOL_PKG = 1e-10
DT = 1800.0
INDEX_KEYS = ("pbuf.ZM_IDEEP", "pbuf.ZM_JT", "pbuf.ZM_MAXG", "diag.CLDTOP",
              "diag.CLDBOT")


@functools.cache
def _inputs():
    """(state, pbuf, cam_in) of the port, float64 on the CPU."""
    pstate, zpbuf, forcing = varied_zm_inputs(NCOL, PVER, torch.float64,
                                              "cpu")
    lat = torch.linspace(-1.3, 1.3, NCOL, dtype=torch.float64)
    t = pstate.t.clone()
    # every other column unstable in its top layers: theta falling with
    # height
    exn = (pstate.pmid / 1.0e5) ** 0.2857
    t[::2, 0] = t[::2, 1] * exn[::2, 0] / exn[::2, 1] * 0.97
    t[::2, 1] = t[::2, 2] * exn[::2, 1] / exn[::2, 2] * 0.98
    pstate = check_energy_timestep_init(
        pstate.replace(t=t, lat=lat, lon=torch.linspace(0.0, 6.0, NCOL,
                                                        dtype=torch.float64)),
        default_registry())
    reg = default_registry()
    pbuf = tpb.pbuf_register(tpp.physpkg_pbuf_specs(NCOL, PVER,
                                                    pcnst=reg.pcnst))
    pbuf = pbuf.update(
        CLD=zpbuf.get("CLD"), PBLH=forcing["pblh"], TPERT=forcing["tpert"],
        TEOUT=pstate.te_cur * (1.0 - 2e-6),
        TEOUT_VALID=torch.ones(1, dtype=torch.float64),
        DTCORE=pstate.t - 0.2, DQCORE=pstate.q[:, :, 0] * 0.99,
        DUCORE=pstate.u - 0.5, DVCORE=pstate.v + 0.5)
    cam_in = bulk_surface_fluxes(pstate, aquaplanet_sst(lat), reg.pcnst)
    cam_in = cam_in.replace(landfrac=forcing["landfrac"],
                            ocnfrac=1.0 - forcing["landfrac"])
    return pstate, pbuf, cam_in


def _jstate(pstate):
    return jst.PhysicsState(**{f: jnp.asarray(a) for f, a in
                               convert.physstate_to_numpy(pstate).items()})


@functools.cache
def _jx(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def test_dadadj_matches_jax():
    st, _, _ = _inputs()
    args = [st.t, st.q[:, :, 0], st.pmid, st.pdel]
    got = tda.dadadj(*args)
    want = _jx(jda.dadadj)(*[jnp.asarray(npy(a)) for a in args])
    for g, w, name in zip(got, want, ("t", "q")):
        assert_close(g, w, TOL, name)
    assert not torch.equal(got[0], st.t)          # something was mixed
    for g, w, name in zip(tda.dadadj_tend(st, DT),
                          _jx(jda.dadadj_tend, dt=DT)(_jstate(st)),
                          ("tend_s", "tend_q")):
        assert_close(g, w, TOL, name)


def test_tridiag_solve_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(-1.0, 0.0, (NCOL, PVER))
    c = rng.uniform(-1.0, 0.0, (NCOL, PVER))
    b = 1.0 - a - c + rng.uniform(0.0, 0.5, (NCOL, PVER))
    d = rng.standard_normal((NCOL, PVER))
    got = tvd.tridiag_solve(t64(a), t64(b), t64(c), t64(d))
    want = _jx(jvd.tridiag_solve)(*map(jnp.asarray, (a, b, c, d)))
    assert_close(got, want, TOL, "tridiag_solve")
    # a leading axis of right-hand sides shares the elimination
    both = tvd.tridiag_solve(t64(a), t64(b), t64(c), t64(np.stack([d, -d])))
    assert torch.equal(both[0], got) and torch.equal(both[1], -got)


def test_vertical_diffusion_matches_jax():
    st, pbuf, ci = _inputs()
    pblh = pbuf.get("PBLH")
    assert_close(tvd.eddy_diffusivity(st, pblh),
                 _jx(jvd.eddy_diffusivity)(_jstate(st),
                                           jnp.asarray(npy(pblh))),
                 TOL, "kv")
    args = (ci.shf, ci.cflx, ci.wsx, ci.wsy, pblh)
    got = tvd.vertical_diffusion_tend(st, *args, DT)
    want = _jx(jvd.vertical_diffusion_tend, ztodt=DT)(
        _jstate(st), *[jnp.asarray(npy(a)) for a in args])
    assert set(got) == set(want)
    for k in got:
        assert_close(got[k], want[k], TOL, k)


def _jcam_in(cam_in):
    return jcx.CamIn(**{k: jnp.asarray(v) for k, v in
                        convert.camin_to_numpy(cam_in).items()})


def test_gray_radiation_matches_jax():
    st, _, ci = _inputs()
    tau = np.cumsum(np.random.default_rng(4).uniform(0, 0.4,
                                                     (NCOL, PVER + 1)), 1)
    tau[:, 0] = 0.0
    for g, w, name in zip(trad.lw_gray_fluxes(st.t, ci.ts, t64(tau)),
                          _jx(jrad.lw_gray_fluxes)(
                              jnp.asarray(npy(st.t)), jnp.asarray(npy(ci.ts)),
                              jnp.asarray(tau)), ("up", "dn")):
        assert_close(g, w, TOL, name)
    got = trad.radiation_tend(st, ci)
    want = _jx(jrad.radiation_tend)(_jstate(st), _jcam_in(ci))
    assert set(got) == set(want)
    for k in got:
        assert_close(got[k], want[k], TOL, k)


def _cmfmc(seed=6):
    """An interface mass flux with some quiet columns."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.0, 0.05, (NCOL, PVER + 1))
    m[:, :8] = 0.0
    m[::3] = 0.0
    m[:, -1] = 0.0
    return m


def test_cloud_fraction_matches_jax():
    st, _, _ = _inputs()
    m = _cmfmc()
    # a quiet mass flux: JAX's cldfrc without one
    assert_close(tcf.cldfrc(st, t64(np.zeros_like(m))),
                 _jx(jcf.cldfrc)(_jstate(st)), TOL, "cldfrc")
    assert_close(tcf.cldfrc(st, t64(m)),
                 _jx(jcf.cldfrc)(_jstate(st), jnp.asarray(m)), TOL,
                 "cldfrc with cmfmc")


def test_convect_diagnostics_matches_jax():
    st, pbuf, _ = _inputs()
    m = _cmfmc(7)
    rprd = np.random.default_rng(8).uniform(0, 1e-6, (NCOL, PVER))
    tb = pbuf.update(CMFMC_DP=t64(m), RPRDDP=t64(rprd))
    jb = jpb.PhysicsBuffer(fields={k: jnp.asarray(npy(v))
                                   for k, v in tb.fields.items()},
                           lifetimes=dict(tb.lifetimes))
    got = tcd.convect_diagnostics_calc(st, tb)
    want = jcd.convect_diagnostics_calc(_jstate(st), jb)
    assert set(got) == set(want)
    for k in got:
        assert_close(got[k], want[k], TOL, k)
    top = npy(got["CLDTOP"])
    assert (top[::3] == PVER - 1).all() and (top[1::3] < PVER - 1).all()


# ---- tphysbc / tphysac ----

def _flat(out):
    """{key: array} of a PhysRunOut of either package."""
    res = {f"state.{f}": a
           for f, a in convert.physstate_to_numpy(out.state).items()}
    res.update({f"pbuf.{k}": a
                for k, a in convert.pbuf_to_numpy(out.pbuf)[0].items()})
    res.update({f"tend.{f}": npy(getattr(out.tend, f)) for f in TEND_FIELDS})
    res.update({f"cam_out.{f}": a
                for f, a in convert.camout_to_numpy(out.cam_out).items()})
    res.update({f"diag.{k}": npy(v) for k, v in out.diagnostics.items()})
    return res


def _check(got, want, tag, drop_snap=False):
    if drop_snap:
        want = {k: v for k, v in want.items()
                if not k.startswith("diag.SNAP_")}
    assert set(got) == set(want), (tag, set(got) ^ set(want))
    te_scale = float(np.abs(want["state.te_cur"]).max())
    for k in sorted(got):
        g, w = got[k], want[k]
        assert g.shape == w.shape, (tag, k, g.shape, w.shape)
        if k in INDEX_KEYS:
            np.testing.assert_array_equal(g, w, f"{tag} {k}")
            continue
        scale = te_scale if k == "diag.ZM_TE_ERR" else None
        assert_close(g, w, TOL_PKG, f"{tag} {k}", scale=scale)


def _jax_phys_run2(o1, cam_in):
    """JAX's phys_run2 for "gray" and "rrtmg", snapshots on, from the
    port's phys_run1 output, as one jitted program (tphysac reaches no
    zm_convr, so it compiles in process)."""
    from cam_nor_physics_tpu.models.physics import constituents as jcn
    from cam_nor_physics_tpu.models.physics import physpkg as jpp
    from cam_nor_physics_tpu.utils.config import PhysConfig as JPhys
    reg = jcn.default_registry()
    pbuf_np, lifetimes = convert.pbuf_to_numpy(o1.pbuf)

    @jax.jit
    def run(st, fields, ci):
        pb = jpb.PhysicsBuffer(fields=fields, lifetimes=lifetimes)
        return tuple(jpp.phys_run2(JPhys(radiation_scheme=scheme,
                                         cam_snapshot=True),
                                   reg, st, pb, ci, DT)
                     for scheme in ("gray", "rrtmg"))

    return run(_jstate(o1.state),
               {k: jnp.asarray(v) for k, v in pbuf_np.items()},
               _jcam_in(cam_in))


def _bitwise(got, want, tag):
    assert set(got) == set(want), (tag, set(got) ^ set(want))
    for k in got:
        assert np.array_equal(got[k], want[k], equal_nan=True), (tag, k)


def _no_snap(flat):
    return {k: v for k, v in flat.items() if not k.startswith("diag.SNAP_")}


def test_tphysbc_tphysac_match_jax():
    st, pbuf, ci = _inputs()
    reg, zm = default_registry(), ZMConfig()
    gray = PhysConfig(radiation_scheme="gray", cam_snapshot=True)
    rrtmg = PhysConfig(radiation_scheme="rrtmg", cam_snapshot=True)
    nosnap = PhysConfig(radiation_scheme="gray")
    o1 = tpp.phys_run1(gray, zm, reg, st, pbuf, ci, DT, nstep=1)
    o2g = tpp.phys_run2(gray, reg, o1.state, o1.pbuf, ci, DT)
    o2r = tpp.phys_run2(rrtmg, reg, o1.state, o1.pbuf, ci, DT)
    j2g, j2r = (_flat(o) for o in _jax_phys_run2(o1, ci))
    got1, got2g = _flat(o1), _flat(o2g)
    _check(got2g, j2g, "phys_run2 gray")
    _check(_flat(o2r), j2r, "phys_run2 rrtmg")
    # tphysbc is held to JAX's through atm_step, whose diagnostics carry
    # its snapshots (test_torch_atm_comp.py); here: it does not read the
    # radiation scheme, and the snapshots only add diagnostics
    _bitwise(_flat(tpp.phys_run1(rrtmg, zm, reg, st, pbuf, ci, DT,
                                 nstep=1)), got1, "phys_run1 rrtmg")
    q1 = tpp.phys_run1(nosnap, zm, reg, st, pbuf, ci, DT, nstep=1)
    q2 = tpp.phys_run2(nosnap, reg, q1.state, q1.pbuf, ci, DT)
    _bitwise(_flat(q1), _no_snap(got1), "phys_run1 no snapshots")
    _bitwise(_flat(q2), _no_snap(got2g), "phys_run2 no snapshots")
    # the sequence did its work: the fixer fired, ZM triggered in some
    # columns but not all, radiation heated, the rrtmg stub did not
    assert np.abs(got1["diag.EFIX"]).max() > 0
    ideep = got1["pbuf.ZM_IDEEP"]
    assert 0 < ideep.sum() < NCOL
    assert np.abs(j2g["diag.QRS"]).max() > 0 and "diag.QRS" not in j2r
    assert got1["pbuf.TEOUT_VALID"][0] == 1.0
    n_snap = sum(k.startswith("diag.SNAP_") for k in got1)
    assert n_snap > 0 and any(k.startswith("diag.SNAP_") for k in j2g)
    assert set(tpp.SNAPSHOT_SITES) >= {
        k.split("_", 1)[1].rsplit("_", 1)[0]
        for k in got1 if k.startswith("diag.SNAP_") and k.endswith("_T")}


@pytest.mark.parametrize("field", ["aero_modes", "raytau0"])
def test_unported_physics_options_raise(field):
    """cam_physpkg="cam3" raises. aero_modes and raytau0 > 0, which
    raised until they were ported, run: tphysbc's aerosol branch fills
    the per-mode stacks and emits the AOD family (JAX parity:
    tests/test_torch_aerosol.py); tphysac with Rayleigh friction
    (raytau0 = 1 day, snapshots on) matches JAX's phys_run2 at 1e-10,
    with the rayleigh_before/after snapshots, the drag decelerating the
    top levels."""
    st, pbuf, ci = _inputs()
    reg, zm = default_registry(), ZMConfig()
    if field == "aero_modes":
        from cam_nor_physics_tpu_torch.entry import accum_mode
        from cam_nor_physics_tpu_torch.models.physics.constituents import \
            Constituent
        for n in ("so4_a1", "pom_a1"):
            reg = reg.add(Constituent(n, qmin=0.0))
        aer = torch.full((NCOL, PVER, 2), 1e-9, dtype=torch.float64)
        st = st.replace(q=torch.cat([st.q, aer], -1))
        pbuf = tpb.pbuf_register(tpp.physpkg_pbuf_specs(
            NCOL, PVER, pcnst=reg.pcnst)).update(
            **{k: v for k, v in pbuf.fields.items() if k != "DQCOND_QINI"})
        ci = ci.replace(cflx=torch.cat([ci.cflx, ci.cflx[:, :2] * 0.0], -1))
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = tpp.phys_run1(PhysConfig(aero_modes=(accum_mode(),)), zm,
                                reg, st, pbuf, ci, DT)
        assert float(out.diagnostics["AODVIS_accum"].min()) > 0.0
        assert float(out.pbuf.get("NAER").min()) > 0.0
        assert out.diagnostics["AER_TAU_SW"].shape == (NCOL, PVER, 14)
    else:
        from cam_nor_physics_tpu.models.physics import constituents as jcn
        from cam_nor_physics_tpu.models.physics import physpkg as jpp
        from cam_nor_physics_tpu.utils.config import PhysConfig as JPhys
        cfg = dict(radiation_scheme="gray", cam_snapshot=True, raytau0=1.0)
        got = _flat(tpp.phys_run2(PhysConfig(**cfg), reg, st, pbuf, ci, DT))
        pbuf_np, lifetimes = convert.pbuf_to_numpy(pbuf)
        want = _flat(jax.jit(lambda s, f, c: jpp.phys_run2(
            JPhys(**cfg), jcn.default_registry(), s,
            jpb.PhysicsBuffer(fields=f, lifetimes=lifetimes), c, DT))(
            _jstate(st), {k: jnp.asarray(v) for k, v in pbuf_np.items()},
            _jcam_in(ci)))
        _check(got, want, "phys_run2 raytau0")
        assert "diag.SNAP_rayleigh_after_U" in want
        du = got["diag.SNAP_rayleigh_after_U"] - \
            got["diag.SNAP_rayleigh_before_U"]
        u0 = got["diag.SNAP_rayleigh_before_U"]
        assert (du[:, 0] * u0[:, 0] <= 0).all() and np.abs(du[:, 0]).max() > 0
    with pytest.raises(NotImplementedError, match="cam_physpkg"):
        PhysConfig(cam_physpkg="cam3")


def test_physpkg_pbuf_specs_match_jax():
    from cam_nor_physics_tpu.models.physics import physpkg as jpp
    assert tpp.physpkg_pbuf_specs(7, 26, pcnst=3) == \
        jpp.physpkg_pbuf_specs(7, 26, pcnst=3)
    assert tpp.SNAPSHOT_SITES == jpp.SNAPSHOT_SITES
    assert tcx.CAMOUT_FIELDS == tuple(jcx.CamOut.__dataclass_fields__)
