"""The port's grid, vertical coordinate and cd_step against the JAX package,
float64 on the CPU.

Grid and coordinate tables are compared exactly. The small-step pieces and
cd_step itself are compared at 1e-12 relative to each field's largest
magnitude: the port repeats the JAX formulas, but log and pow come from
another math library (about one ulp apart) and the pressure-gradient
cancellation amplifies that pkz difference to ~1e-12 in the winds after one
step (measured 9e-13 for u at 36x24x6; with JAX's own pressure_vars
substituted the difference falls to 1e-13).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cam_nor_physics_tpu.models.fv import cd_core as jcd
from cam_nor_physics_tpu.models.fv import grid as jgrid
from cam_nor_physics_tpu.models.fv import vertical as jvert
from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import build_step
from cam_nor_physics_tpu_torch.models.fv import cd_core as tcd
from cam_nor_physics_tpu_torch.models.fv import grid as tgrid
from cam_nor_physics_tpu_torch.models.fv import vertical as tvert
from cam_nor_physics_tpu_torch.parallel.mesh import make_mesh
from torch_port_util import assert_close, npy, t64

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

TOL = 1e-12
IM, JM, KM = 36, 24, 6


def test_grid_tables_equal_jax():
    for im, jm in ((IM, JM), (144, 96)):
        jg = jgrid.make_grid(im, jm, KM)
        tg = tgrid.make_grid(im, jm, KM, device="cpu")
        for f in convert.GRID_TABLES:
            np.testing.assert_array_equal(npy(getattr(tg, f)),
                                          np.asarray(getattr(jg, f)), f)
        for f in convert.GRID_SCALARS:
            assert getattr(tg, f) == getattr(jg, f), f
    np.testing.assert_array_equal(npy(tg.circ_edge()), jg.circ_edge(
        np.float64))


def test_hybrid_coefficients_equal_jax():
    jc, tc = jvert.hybrid_coefficients(26), \
        tvert.hybrid_coefficients(26, device="cpu")
    np.testing.assert_array_equal(npy(tc.ak), np.asarray(jc.ak))
    np.testing.assert_array_equal(npy(tc.bk), np.asarray(jc.bk))
    assert (tc.ptop, tc.ps0) == (jc.ptop, jc.ps0)
    ps = np.random.default_rng(1).uniform(9e4, 1.05e5, (4, 5))
    assert_close(tc.pint(t64(ps)), jc.pint(ps), 1e-15)


@pytest.mark.parametrize("impl", ["fft", "matmul"])
def test_polar_filters_match_jax(impl):
    jg = jgrid.make_grid(IM, JM, KM)
    tg = tgrid.make_grid(IM, JM, KM, device="cpu")
    x = np.random.default_rng(2).standard_normal((KM, JM, IM))
    if impl == "fft":
        got = tgrid.polar_filter(t64(x), tg.pft_edge)
        want = jgrid.polar_filter(x, jg.pft_edge)
    else:
        got = tgrid.polar_filter_matmul(t64(x), tg.circ_center())
        want = jgrid.polar_filter_matmul(x, jg.circ_center(np.float64))
    assert_close(got, want, 1e-13)
    # the two forms are the same filter
    assert_close(tgrid.polar_filter_matmul(t64(x), tg.circ_edge()),
                 tgrid.polar_filter(t64(x), tg.pft_edge), 1e-13)


def _spun_up_state():
    """A Held-Suarez state three unfused small steps (dt=450 s) from rest,
    made by the port, as numpy arrays."""
    _, st, tg, tc, phis = build_step(IM, JM, KM, torch.float64, "cpu")
    for _ in range(3):
        st, _ = tcd.cd_step(st, tg, tc.ptop, phis, 450.0, c_sw_pgf=True,
                            del2_velocity=6e5, fused=False)
    return convert.dynstate_to_numpy(st), tg, tc, phis


def _jax_state(fields):
    return jcd.DynState(**{f: jnp.asarray(v) for f, v in fields.items()})


def test_small_step_pieces_match_jax():
    fields, tg, tc, _ = _spun_up_state()
    jg = jgrid.make_grid(IM, JM, KM)
    u, v, pt, delp = (fields[f] for f in ("u", "v", "pt", "delp"))
    for a, b in zip(tcd.pressure_vars(t64(delp), tc.ptop),
                    jcd.pressure_vars(delp, tc.ptop)):
        assert_close(a, b, 1e-14)
    pk = np.asarray(jcd.pressure_vars(delp, tc.ptop)[1])
    phis = np.zeros((JM, IM))
    assert_close(tcd.geopotential_k(t64(pt), t64(pk), t64(phis)),
                 jcd.geopotential_k(pt, pk, phis), 1e-14)
    for a, b in zip(tcd.d2a_winds(t64(u), t64(v)), jcd.d2a_winds(u, v)):
        assert_close(a, b, 1e-15)
    assert_close(tcd.absolute_vorticity(t64(u), t64(v), tg),
                 jcd.absolute_vorticity(u, v, jg), 1e-14)
    assert_close(tcd.divergence_corner(t64(u), t64(v), tg),
                 jcd.divergence_corner(u, v, jg), 1e-14)


@pytest.mark.parametrize("filter_impl,flags", [
    ("fft", {}), ("matmul", {}),
    ("fft", dict(div4_coef_nd=0.02, ke_method="avg_sq", filter_dm=True,
                 filter_csw_dm=True))])
def test_cd_step_matches_jax(filter_impl, flags):
    fields, tg, tc, phis = _spun_up_state()
    jg = jgrid.make_grid(IM, JM, KM)
    taper = np.linspace(0.06, 0.01, KM)
    kw = dict(c_sw_pgf=True, del2_velocity=6e5, filter_impl=filter_impl,
              div_taper=taper, **flags)
    # the unfused formulation, JAX's use_pallas=False (the fused step has
    # its own tests, test_torch_cd_fused.py)
    new, diag = tcd.cd_step(convert.dynstate_from_numpy(fields, "cpu"), tg,
                            tc.ptop, phis, 450.0, fused=False, **kw)
    ref, rdiag = jcd.cd_step(_jax_state(fields), jg, tc.ptop,
                             jnp.zeros((JM, IM)), 450.0, use_pallas=False,
                             **kw)
    for f in ("u", "v", "pt", "delp"):
        assert_close(getattr(new, f), getattr(ref, f), TOL, f)
    for f in ("cx", "cy", "mfx", "mfy", "pe", "pkz", "wz"):
        assert_close(diag[f], rdiag[f], TOL, f)


def test_unported_options_raise():
    """mesh and return_debug, which raised until they were ported, run.
    A mesh of one rank gives the step without a mesh bitwise, fused and
    unfused; an object that is not a mesh raises TypeError
    (tests/test_torch_parallel.py holds meshes of several ranks).
    return_debug runs the unfused step: its state and diagnostics
    bitwise those of the step without it, and its terms finite
    (test_torch_dyn_options.py holds them to JAX's)."""
    fields, tg, tc, phis = _spun_up_state()
    st = convert.dynstate_from_numpy(fields, "cpu")
    one = make_mesh(device="cpu")
    for kw in (dict(c_sw_pgf=True), dict(c_sw_pgf=True, fused=False)):
        a, da = tcd.cd_step(st, tg, tc.ptop, phis, 450.0, mesh=one, **kw)
        b, db = tcd.cd_step(st, tg, tc.ptop, phis, 450.0, **kw)
        for f in ("u", "v", "pt", "delp", "q"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (kw, f)
        assert all(torch.equal(da[k], db[k]) for k in db)
    with pytest.raises(TypeError, match="Mesh"):
        tcd.cd_step(st, tg, tc.ptop, phis, 450.0, mesh=object())
    new, diags = tcd.cd_step(st, tg, tc.ptop, phis, 450.0, c_sw_pgf=True,
                             return_debug=True)
    ref, rdiags = tcd.cd_step(st, tg, tc.ptop, phis, 450.0, c_sw_pgf=True,
                              fused=False)
    for f in ("u", "v", "pt", "delp", "q"):
        assert torch.equal(getattr(new, f), getattr(ref, f)), f
    dbg = diags.pop("debug")
    assert set(diags) == set(rdiags)
    for k in rdiags:
        assert torch.equal(diags[k], rdiags[k]), k
    assert {"uc0", "duc", "pgf_u_c", "delp_h", "fy_z", "du_pgf", "fx_z",
            "dv_pgf", "ke", "zeta_a", "du", "dv"} <= set(dbg)
    for k, v in dbg.items():
        assert torch.isfinite(v).all(), k
