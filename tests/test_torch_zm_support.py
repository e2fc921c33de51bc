"""The ZM slice's support modules of the PyTorch port against the JAX
package, float64 on the CPU, at 1e-12 relative to each output's largest
magnitude: saturation (Goff-Gratch qsat and friends), geopotential_t,
thermo (entropy/enthalpy, their derivatives and both inversion solvers,
plus the unbracketable case), the physics state, ptend and physics_update
machinery, the physics buffer and the constituent registry. None of these
compiles zm_convr, so JAX runs in process: jitted where one compile is
cheaper than running the function op by op, eagerly for the inversions
(which share most of their operations).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cam_nor_physics_tpu.models.physics import constituents as jcn
from cam_nor_physics_tpu.models.physics import physics_buffer as jpb
from cam_nor_physics_tpu.models.physics import state as jst
from cam_nor_physics_tpu.ops import geopotential as jgeo
from cam_nor_physics_tpu.ops import saturation as jsat
from cam_nor_physics_tpu.ops import thermo as jth
from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import zm_profiles
from cam_nor_physics_tpu_torch.models.physics import constituents as tcn
from cam_nor_physics_tpu_torch.models.physics import physics_buffer as tpb
from cam_nor_physics_tpu_torch.models.physics import state as tst
from cam_nor_physics_tpu_torch.ops import geopotential as tgeo
from cam_nor_physics_tpu_torch.ops import saturation as tsat
from cam_nor_physics_tpu_torch.ops import thermo as tth
from torch_port_util import assert_close, t64

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

TOL = 1e-12


@functools.cache
def _jx(fn, **static):
    """The JAX function `fn` jitted, with the keyword arguments `static`
    bound."""
    return jax.jit(functools.partial(fn, **static))


def _temps_pressures(seed=0, n=(8, 26)):
    """T from 180 to 320 K (both sides of the ice band and of freezing),
    p from 5 hPa to 1050 hPa (Pa), including p <= es at the warm/low end."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(180.0, 320.0, n)
    p = np.exp(rng.uniform(np.log(500.0), np.log(1.05e5), n))
    p[0, :4] = [900.0, 1200.0, 2500.0, 8000.0]
    t[0, :4] = [315.0, 318.0, 320.0, 316.0]
    return t, p


@pytest.mark.parametrize("name", ["svp_water", "svp_ice", "svp_trans"])
def test_svp_matches_jax(name):
    t, _ = _temps_pressures()
    assert_close(getattr(tsat, name)(t64(t)),
                 _jx(getattr(jsat, name))(jnp.asarray(t)), TOL, name)


@pytest.mark.parametrize("name", ["qsat", "qsat_water", "qsat_ice",
                                  "qsat_hpa"])
def test_qsat_matches_jax(name):
    t, p = _temps_pressures(1)
    if name == "qsat_hpa":
        p = p * 0.01
    got = getattr(tsat, name)(t64(t), t64(p))
    want = _jx(getattr(jsat, name))(jnp.asarray(t), jnp.asarray(p))
    for g, w, part in zip(got, want, ("es", "qs")):
        assert_close(g, w, TOL, f"{name} {part}")
    assert (got[1].numpy() == 1.0).any(), "the p <= es cap is not exercised"


def test_dqsdt_water_matches_jax():
    t, p = _temps_pressures(2)
    assert_close(tsat.dqsdt_water(t64(t), t64(p)),
                 _jx(jsat.dqsdt_water)(jnp.asarray(t), jnp.asarray(p)), TOL)


def _column_pressures(ncol=6, pver=26, seed=3):
    rng = np.random.default_rng(seed)
    pint, t, q = zm_profiles(ncol, pver)
    t = t + rng.normal(0.0, 2.0, t.shape)
    pmid = 0.5 * (pint[:, 1:] + pint[:, :-1])
    pdel = pint[:, 1:] - pint[:, :-1]
    return pint, pmid, pdel, t, q


@pytest.mark.parametrize("dycore", ["LR", "EUL"])
def test_geopotential_t_matches_jax(dycore):
    pint, pmid, pdel, t, q = _column_pressures()
    args = (np.log(pint), np.log(pmid), pint, pmid, pdel, 1.0 / pdel, t, q)
    got = tgeo.geopotential_t(*map(t64, args), dycore=dycore)
    want = _jx(jgeo.geopotential_t, dycore=dycore)(*map(jnp.asarray, args))
    for g, w, name in zip(got, want, ("zi", "zm")):
        assert_close(g, w, TOL, name)


def _thermo_inputs(seed=4):
    """Parcel-like (T, p hPa, qt, z): saturated and unsaturated lanes."""
    rng = np.random.default_rng(seed)
    n = (6, 26)
    t = rng.uniform(200.0, 305.0, n)
    p = rng.uniform(100.0, 1000.0, n)
    qt = rng.uniform(1e-5, 0.02, n)
    z = rng.uniform(0.0, 15000.0, n)
    return t, p, qt, z


def test_entropy_enthalpy_and_derivatives_match_jax():
    t, p, qt, z = _thermo_inputs()
    tt, tp, tq, tz = map(t64, (t, p, qt, z))
    jt_, jp, jq, jz = map(jnp.asarray, (t, p, qt, z))
    assert_close(tth.entropy(tt, tp, tq), _jx(jth.entropy)(jt_, jp, jq),
                 TOL)
    assert_close(tth.enthalpy(tt, tp, tq, tz),
                 _jx(jth.enthalpy)(jt_, jp, jq, jz), TOL)
    for g, w in zip(tth._entropy_and_deriv(tt, tp, tq),
                    _jx(jth._entropy_and_deriv)(jt_, jp, jq)):
        assert_close(g, w, TOL, "entropy deriv")
    for g, w in zip(tth._enthalpy_and_deriv(tt, tp, tq, tz),
                    _jx(jth._enthalpy_and_deriv)(jt_, jp, jq, jz)):
        assert_close(g, w, TOL, "enthalpy deriv")


@pytest.mark.parametrize("solver", ["newton", "newton_exact", "brent"])
@pytest.mark.parametrize("which", ["ientropy", "ienthalpy"])
def test_inversions_match_jax(solver, which):
    """Targets from temperatures 0.5-8 K away from the guess."""
    t, p, qt, z = _thermo_inputs(5)
    rng = np.random.default_rng(6)
    guess = t + rng.uniform(-8.0, 8.0, t.shape)
    if which == "ientropy":
        target = np.asarray(jth.entropy(jnp.asarray(t), jnp.asarray(p),
                                        jnp.asarray(qt)))
        got = tth.ientropy(t64(target), t64(p), t64(qt), t64(guess),
                           solver=solver)
        want = jth.ientropy(*map(jnp.asarray, (target, p, qt, guess)),
                            solver=solver)
    else:
        target = np.asarray(jth.enthalpy(*map(jnp.asarray, (t, p, qt, z))))
        got = tth.ienthalpy(t64(target), t64(p), t64(qt), t64(z),
                            t64(guess), solver=solver)
        want = jth.ienthalpy(*map(jnp.asarray, (target, p, qt, z, guess)),
                             solver=solver)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].numpy().all()
    assert_close(got[0], want[0], TOL, f"{which} {solver} T")
    assert_close(got[1], want[1], TOL, f"{which} {solver} qst")
    # the converged roots sit within the solver tolerance of the truth
    np.testing.assert_allclose(got[0].numpy(), t, atol=2e-3)


def test_brent_unbracketable_target_returns_nan():
    """A target no temperature within 160 K of the guess reaches: NaN and
    converged=False, never the bracket edge, in both packages."""
    p, qt = np.full(4, 500.0), np.full(4, 1e-3)
    guess = np.full(4, 250.0)
    target = np.array([1e7, -1e7, 1e7, 1e7])
    got = tth.ientropy(t64(target), t64(p), t64(qt), t64(guess),
                       solver="brent")
    want = _jx(jth.ientropy, solver="brent")(
        *map(jnp.asarray, (target, p, qt, guess)))
    assert torch.isnan(got[0]).all() and not got[2].any()
    assert np.isnan(np.asarray(want[0])).all()
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _both_states(ncol=5, pver=26, seed=7):
    """The same PhysicsState in both packages (3 constituents)."""
    pint, _, pdel, t, q0 = _column_pressures(ncol, pver, seed)
    rng = np.random.default_rng(seed)
    q = np.stack([q0, rng.uniform(0, 1e-5, q0.shape),
                  rng.uniform(0, 1e-6, q0.shape)], -1)
    u = rng.normal(0, 10, t.shape)
    v = rng.normal(0, 10, t.shape)
    phis = rng.uniform(0, 2000.0, ncol)
    jstate = _jx(jst.make_state_from_profiles)(
        *map(jnp.asarray, (pint, t, u, v, q, phis)))
    tstate = tst.make_state_from_profiles(*map(t64, (pint, t, u, v, q,
                                                     phis)))
    return jstate, tstate


def test_make_state_from_profiles_matches_jax():
    jstate, tstate = _both_states()
    got = convert.physstate_to_numpy(tstate)
    want = convert.physstate_to_numpy(jstate)
    assert set(got) == set(want)
    for f in got:
        assert_close(got[f], want[f], TOL, f)


def _ptends(ncol, pver, pcnst, seed):
    """Heating, vapor/tracer and wind tendencies; the tracer update drives
    some values below qmin."""
    rng = np.random.default_rng(seed)
    s = rng.normal(0, 0.05, (ncol, pver))
    q = rng.normal(0, 1e-8, (ncol, pver, pcnst))
    q[:, :3, 1] = -1.0                 # push CLDLIQ far below zero
    u = rng.normal(0, 1e-3, (ncol, pver))
    return s, q, u


@pytest.mark.parametrize("refresh", [True, False])
def test_ptend_and_physics_update_match_jax(refresh):
    ncol, pver, pcnst = 5, 26, 3
    jstate, tstate = _both_states(ncol, pver, seed=8)
    jreg, treg = jcn.default_registry(), tcn.default_registry()
    s, q, u = _ptends(ncol, pver, pcnst, seed=9)
    lq = (True, True, False)
    jp = jst.ptend_init("zm_conv_tend", ncol, pver, pcnst, ls=True, lu=True,
                        lq=lq)
    jp = jp.replace(s=jnp.asarray(s), q=jnp.asarray(q), u=jnp.asarray(u))
    tp = tst.ptend_init("zm_conv_tend", ncol, pver, pcnst, ls=True, lu=True,
                        lq=lq)
    tp = tp.replace(s=t64(s), q=t64(q), u=t64(u))
    jsum = jst.ptend_sum(jst.ptend_init("a", ncol, pver, pcnst), jp)
    tsum = tst.ptend_sum(tst.ptend_init("a", ncol, pver, pcnst), tp)
    for f in tst.PTEND_FIELDS:
        assert_close(getattr(tsum, f), getattr(jsum, f), TOL, f)
    assert (tsum.ls, tsum.lu, tsum.lv, tsum.lq, tsum.name) == \
        (jsum.ls, jsum.lu, jsum.lv, jsum.lq, jsum.name)
    jnew, _ = _jx(jst.physics_update, dt=1800.0, registry=jreg,
                  refresh=refresh)(jstate, jp)
    tnew = tst.physics_update(tstate, tp, 1800.0, treg, refresh=refresh)
    got, want = convert.physstate_to_numpy(tnew), \
        convert.physstate_to_numpy(jnew)
    for f in got:
        assert_close(got[f], want[f], TOL, f)
    assert (got["q"][:, :3, 1] == 1e-12).all()  # the qneg3 floor ran


def test_refresh_dse_and_level_mask_match_jax():
    jstate, tstate = _both_states(seed=10)
    tstate = tstate.replace(t=tstate.t + 1.5)
    jstate = jstate.replace(t=jstate.t + 1.5)
    got = tst.refresh_dse(tstate)
    want = _jx(jst.refresh_dse)(jstate)
    for f in ("zi", "zm", "s"):
        assert_close(getattr(got, f), getattr(want, f), TOL, f)
    np.testing.assert_array_equal(
        tst._level_mask(26, 3, -2, torch.float64).numpy(),
        np.asarray(jst._level_mask(26, 3, -2, jnp.float64)))


def test_physics_buffer_and_registry_match_jax():
    specs_t, specs_j = tpb.zm_pbuf_specs(7, 26), jpb.zm_pbuf_specs(7, 26)
    assert specs_t == specs_j
    tb = tpb.pbuf_register(specs_t).set("CLD", torch.full((7, 26), 0.2))
    assert tb.get("CLD").dtype == torch.float32
    tb = tpb.pbuf_register(specs_t).update(PBLH=t64(np.arange(7.0)))
    jb = jpb.pbuf_register(specs_j).update(PBLH=jnp.arange(7.0))
    assert tb.lifetimes == jb.lifetimes
    assert set(tb.fields) == set(jb.fields)
    np.testing.assert_array_equal(tb.get("PBLH").numpy(),
                                  np.asarray(jb.get("PBLH")))
    with pytest.raises(KeyError):
        tb.set("NOPE", t64(np.zeros(7)))
    treg, jreg = tcn.default_registry(2), jcn.default_registry(2)
    assert treg.names == jreg.names
    for attr in ("is_convtran1", "is_convtran2"):
        assert treg.mask(attr) == jreg.mask(attr)
    np.testing.assert_array_equal(treg.qmin_array(), jreg.qmin_array())
    with pytest.raises(ValueError):
        tcn.ConstituentRegistry((tcn.Constituent("CLDLIQ"),))
