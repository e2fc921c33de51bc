"""The dycore's options in the port against the JAX package, float64 on the
CPU, and their physical checks on the port alone.

- dyn_run with each option set at 32 x 16 x 6 (FVConfig(nsplit=2,
  nspltrac=1), dt = 1800 s) from the JW06 state with four tracers and a
  zonally varying phis (the JW topography plus tests/test_am_flags.py's
  mountain), three option sets: the AM fixer global (tapered, as the
  reference forces) with high_altitude and the species O, O2, H; level by
  level with the taper and high_altitude with no species; the AM
  correction with the level-by-level fixer, untapered; am_diag's four
  outputs in each. Both packages run the unfused small step ("matmul";
  JAX's XLA cd_step). State and diagnostics within 1e-9 of each field's
  max, the floor count equal. The unfused cd_step with
  return_debug on the same state: the state and the diagnostics within
  1e-12 of each field's max (tests/test_torch_cd_core.py's margin, 9.2e-13
  of max|u|), the wind terms within 1e-12 of max|u|, and the pressure
  terms (the C-grid and D-grid PGF pieces, delp_h, pt_h) within 1e-10 of
  their max: the PGF's cancellation amplifies the one-ulp difference of
  log and pow. JAX's side runs jitted in fresh interpreters, one a
  program, all at once while the port runs
  (tests/torch_port_modes_ref.py "dyn").
- axial_angular_momentum, am_taper, am_fixer (the fixer's increment held
  as a wind, to 1e-12 of max|u|), mountain_torque, benergy, calc_kappav,
  sigma_coefficients, ffsl_flags and remap_state against JAX at 1e-12;
  ycc and tpcc against JAX at 1e-12 and against the line-faithful oracle
  (tests/oracles/tp_core_oracle.py) at tests/test_oracle_parity.py's
  tolerances.
- The physical checks of tests/test_dyn_extras.py (the fixer restores the
  AM globally and level by level, the taper's shape, a fixed dyn_run
  conserves AM, benergy, ω) and tests/test_am_flags.py (high_altitude
  with constant composition is a no-op, the correction closes the AM
  budget, over topography against the torque), on the port.
- On a card (marked cuda, skipped here): the fixer and high_altitude
  steps in float64 through the kernels against the CPU's plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cam_nor_physics_tpu.models.fv import dyn_comp as jdc
from cam_nor_physics_tpu.models.fv import grid as jgrid
from cam_nor_physics_tpu.models.fv import vertical as jvert
from cam_nor_physics_tpu.ops import remap as jremap
from cam_nor_physics_tpu.ops import thermo as jthermo
from cam_nor_physics_tpu.ops import tp_core as jtp
from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.models.fv import cd_core as tcd
from cam_nor_physics_tpu_torch.models.fv import dyn_comp as tdc
from cam_nor_physics_tpu_torch.models.fv import grid as tgrid
from cam_nor_physics_tpu_torch.models.fv import vertical as tvert
from cam_nor_physics_tpu_torch.models.fv.baroclinic_wave import \
    jw_baroclinic_wave
from cam_nor_physics_tpu_torch.models.fv.held_suarez import hs_initial_state
from cam_nor_physics_tpu_torch.ops import remap as tremap
from cam_nor_physics_tpu_torch.ops import thermo as tthermo
from cam_nor_physics_tpu_torch.ops import tp_core as ttp
from cam_nor_physics_tpu_torch.utils.config import FVConfig
from oracles import tp_core_oracle as orc
from torch_port_util import assert_close, npy, reference_processes, t64

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

IM, JM, KM = 32, 16, 6
DT = 1800.0
TOL = 1e-9
TOL_LEAF = 1e-12
SPECIES = (("O", 1), ("O2", 2), ("H", 3))
# three option sets (JAX traces each dyn_run for about 5 s): between them
# every fixer form, the correction, am_diag and high_altitude with and
# without species (am_fixer's untapered global form, the correction's
# without the fixer, is held in test_am_pieces_match_jax)
CONFIGS = {
    "fixer_global": dict(am_fixer=True, am_diag=True, high_altitude=True,
                         major_species=SPECIES),
    "fixer_lbl_taper": dict(am_fixer=True, am_fix_lbl=True,
                            am_fix_taper=True, am_diag=True,
                            high_altitude=True),
    "correction_fixer_lbl": dict(am_correction=True, am_fixer=True,
                                 am_fix_lbl=True, am_diag=True),
}
DEBUG_DT = 450.0
PRESSURE_TERMS = ("pgf_u_c", "pgf_v_c", "du_pgf", "dv_pgf", "delp_h",
                  "pt_h")
WIND_TERMS = ("uc0", "vc0", "duc", "dvc", "fy_z", "fx_z", "du", "dv")


def _grids(im=IM, jm=JM, km=KM):
    return (tgrid.make_grid(im, jm, km, device="cpu"),
            tvert.hybrid_coefficients(km, device="cpu"))


def mountain(jm, im):
    """tests/test_am_flags.py:147-151's mountain (m2/s2)."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, jm)
    lon = np.linspace(0, 2 * np.pi, im, endpoint=False)
    return 1500.0 * 9.80616 * np.exp(-((lat[:, None] - 0.7) / 0.3) ** 2) * \
        (1.0 + np.cos(lon)[None, :])


def _cases():
    """The JW06 state (perturbed) with 1e-3 vapour and three species
    drawn from a seed, and the JW topography plus the mountain."""
    grid, coord = _grids()
    st, phis = jw_baroclinic_wave(grid, coord, perturb=True, nq=4,
                                  device="cpu")
    q = npy(st.q).copy()
    q[0] = 1e-3
    q[1:] = np.random.default_rng(7).uniform(0.0, 0.2, q[1:].shape)
    fields = convert.dynstate_to_numpy(st.replace(q=t64(q)))
    return dict(shape=(IM, JM, KM), state=fields,
                phis=npy(phis) + mountain(JM, IM), dt=DT,
                configs={k: dict(nsplit=2, nspltrac=1, **v)
                         for k, v in CONFIGS.items()},
                debug=dict(dt=DEBUG_DT, filter_impl="fft"))


def _port(cases):
    grid, coord = _grids()
    state = convert.dynstate_from_numpy(cases["state"], "cpu")
    phis = t64(cases["phis"])
    out = {}
    for name, kw in cases["configs"].items():
        new, diags = tdc.dyn_run(state, grid, coord, phis, FVConfig(**kw),
                                 cases["dt"], filter_impl="matmul",
                                 return_diags=True)
        out[name] = {**convert.dynstate_to_numpy(new),
                     **{f"diag.{k}": npy(v) for k, v in diags.items()}}
    new, diags = tcd.cd_step(state, grid, coord.ptop, phis, DEBUG_DT,
                             filter_impl="fft", c_sw_pgf=True, fused=False,
                             return_debug=True)
    out["debug"] = {**convert.dynstate_to_numpy(new),
                    **{f"debug.{k}": npy(v)
                       for k, v in diags.pop("debug").items()},
                    **{f"diag.{k}": npy(v) for k, v in diags.items()}}
    return out


def test_dyn_run_options_match_jax(tmp_path):
    cases = _cases()
    # one interpreter a JAX program (tracing each takes seconds), all at
    # once while the port runs
    jobs = [("dyn", dict(cases, configs={k: v}, debug=None))
            for k, v in cases["configs"].items()]
    jobs.append(("dyn", dict(cases, configs={})))
    got, outs = reference_processes(tmp_path, "torch_port_modes_ref.py",
                                    jobs, _port, cases)
    want = {k: v for out in outs for k, v in out.items()}
    assert set(got) == set(want)
    for name in CONFIGS:
        g, w = got[name], want[name]
        assert set(g) == set(w), (name, set(g) ^ set(w))
        for k in w:
            if k == "diag.floor_activations":
                assert int(g[k]) == int(w[k]) == 0, (name, k)
            else:
                assert_close(g[k], w[k], TOL, f"{name} {k}")
        if CONFIGS[name].get("am_diag"):
            assert {"diag.AM_DU3S", "diag.AM_DUFIX", "diag.AM_TOTAL",
                    "diag.du_fix_s"} <= set(w)
            assert np.abs(w["diag.du_fix_s"]).max() > 0, name
    g, w = got["debug"], want["debug"]
    assert set(g) == set(w)
    umax = float(np.abs(w["u"]).max())
    for k in w:
        term = k.split(".", 1)[-1]
        if term in PRESSURE_TERMS:
            assert_close(g[k], w[k], 1e-10, k)
        elif term in WIND_TERMS:
            assert_close(g[k], w[k], TOL_LEAF, k, scale=umax)
        else:
            assert_close(g[k], w[k], TOL_LEAF, k)


# ---------------------------------------------------------------------------
# the pieces, against JAX in this process
# ---------------------------------------------------------------------------

def _jw_pair():
    grid, coord = _grids()
    st, phis = jw_baroclinic_wave(grid, coord, perturb=True, device="cpu")
    jst = jdc.DynState(**{k: jnp.asarray(v) for k, v in
                          convert.dynstate_to_numpy(st).items()})
    return (grid, coord, st, npy(phis)), (jgrid.make_grid(IM, JM, KM),
                                          jvert.hybrid_coefficients(KM), jst)


def test_am_pieces_match_jax():
    (grid, coord, st, phis), (jg, jc, jst) = _jw_pair()
    for per_level in (False, True):
        assert_close(tdc.axial_angular_momentum(st, grid, per_level),
                     jdc.axial_angular_momentum(jst, jg, per_level),
                     TOL_LEAF, f"AM {per_level}")
    assert_close(tdc.benergy(st, grid, coord.ptop),
                 jdc.benergy(jst, jg, jc.ptop), TOL_LEAF, "benergy")
    ph = phis + mountain(JM, IM)
    # a zonally varying ps, so that the torque is not zero
    delp = npy(st.delp) * (1.0 + 0.01 * np.cos(np.arange(IM)))[None, None]
    st2 = st.replace(delp=t64(delp))
    tq = tdc.mountain_torque(st2, t64(ph), grid, coord.ptop)
    assert float(tq) != 0.0
    assert_close(tq, jdc.mountain_torque(jst.replace(delp=jnp.asarray(delp)),
                                         jnp.asarray(ph), jg, jc.ptop),
                 TOL_LEAF, "torque")
    for hot in (False, True):
        assert_close(tdc.am_taper(coord, 95e2, 10e2, KM, hot),
                     jdc.am_taper(jc, 95e2, 10e2, KM, hot), TOL_LEAF,
                     f"taper {hot}")
    am0 = jdc.axial_angular_momentum(jst, jg, per_level=True)
    umax = float(np.abs(npy(st.u)).max())
    for lbl in (False, True):
        for taper in (False, True):
            tt = tdc.am_taper(coord, 95e2, 10e2, KM, False) if taper \
                else None
            jt = jdc.am_taper(jc, 95e2, 10e2, KM, False) if taper else None
            got, gdu = tdc.am_fixer(st.replace(u=st.u + 0.5), grid,
                                    t64(np.asarray(am0)), tt, lbl)
            want, wdu = jdc.am_fixer(jst.replace(u=jst.u + 0.5), jg, am0,
                                     jt, lbl)
            assert_close(got.u, want.u, TOL_LEAF, f"fixer u {lbl} {taper}")
            assert_close(gdu, wdu, TOL_LEAF, f"du_k {lbl} {taper}",
                         scale=umax)


@pytest.mark.parametrize("species", [(), (("O", 1),), SPECIES])
def test_calc_kappav_matches_jax(species):
    q = np.random.default_rng(len(species)).uniform(0.0, 0.3, (4, 3, 5, 6))
    got = tthermo.calc_kappav(t64(q), species)
    assert got.shape == q.shape[1:]
    assert_close(got, jthermo.calc_kappav(jnp.asarray(q), species),
                 TOL_LEAF, "kappa")
    assert tthermo.MAJOR_SPECIES == jthermo.MAJOR_SPECIES


def test_sigma_coefficients_ffsl_flags_remap_state_match_jax():
    jc, tc = jvert.sigma_coefficients(KM), \
        tvert.sigma_coefficients(KM, device="cpu")
    np.testing.assert_array_equal(npy(tc.ak), np.asarray(jc.ak))
    np.testing.assert_array_equal(npy(tc.bk), np.asarray(jc.bk))
    assert (tc.ptop, tc.ps0) == (jc.ptop, jc.ps0)
    rng = np.random.default_rng(3)
    crx = rng.uniform(-1.3, 1.3, (KM, JM, IM))
    grid, _ = _grids()
    np.testing.assert_array_equal(
        npy(tgrid.ffsl_flags(grid, t64(crx))),
        np.asarray(jgrid.ffsl_flags(jgrid.make_grid(IM, JM, KM),
                                    jnp.asarray(crx))))
    ncol = 12
    pe_s = np.cumsum(rng.uniform(100.0, 2000.0, (ncol, KM + 1)), 1)
    pe_t = pe_s.copy()
    pe_t[:, 1:-1] = np.sort(rng.uniform(pe_s[:, :1], pe_s[:, -1:],
                                        (ncol, KM - 1)), 1)
    fields = {n: rng.standard_normal((ncol, KM)) for n in ("a", "b", "c")}
    for kord in (2, 4):
        got = tremap.remap_state(t64(pe_s), t64(pe_t),
                                 {k: t64(v) for k, v in fields.items()}, kord)
        want = jremap.remap_state(jnp.asarray(pe_s), jnp.asarray(pe_t),
                                  {k: jnp.asarray(v)
                                   for k, v in fields.items()}, kord)
        assert list(got) == list(want)
        for k in want:
            assert_close(got[k], want[k], TOL_LEAF, f"remap {k} {kord}")


@pytest.mark.parametrize("jord", [1, 2, -2, 3])
@pytest.mark.parametrize("iv", [0, 1])
def test_ycc_matches_jax_and_oracle(jord, iv):
    """tests/test_oracle_parity.py::test_ycc_parity's inputs."""
    jm, im = 17, 24
    rng = np.random.default_rng(abs(jord) * 3 + iv + 31)
    q = rng.standard_normal((jm, im))
    vc = rng.uniform(-0.9, 0.9, (jm, im))
    ymass = vc * (1.0 + 0.2 * rng.standard_normal((jm, im)))
    got = ttp.ycc(t64(q), t64(vc), t64(ymass), jord, iv)
    assert_close(got, jtp.ycc(q, vc, ymass, jord, iv), TOL_LEAF, "ycc")
    np.testing.assert_allclose(npy(got), orc.ycc_oracle(q, vc, ymass, jord,
                                                        iv),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("iord,jord", [(1, 1), (2, 2), (4, 4), (4, -2),
                                       (7, 3)])
def test_tpcc_matches_jax_and_oracle(iord, jord):
    """tests/test_oracle_parity.py::test_tpcc_parity's inputs."""
    jm, im = 19, 24
    rng = np.random.default_rng(iord * 13 + jord + 7)
    dp = np.pi / (jm - 1)
    late = -0.5 * np.pi + dp * (np.arange(jm) - 0.5)
    cose = np.maximum(np.cos(late), 1e-10)
    x = 2.0 * np.pi * np.arange(im) / im
    q = (2.0 + np.sin(x)[None, :] * np.cos(late)[:, None]
         + 0.3 * rng.standard_normal((jm, im)))
    ffsl = np.zeros(jm, bool)
    ffsl[:4] = True
    ffsl[-4:] = True
    crx = rng.uniform(-0.9, 0.9, (jm, im))
    crx[ffsl] = rng.uniform(-2.5, 2.5, (8, im))
    va = rng.uniform(-0.9, 0.9, (jm, im))
    cry = rng.uniform(-0.9, 0.9, (jm, im))
    ymass = cry * (1.0 + 0.2 * rng.standard_normal((jm, im)))
    gfx, gfy = ttp.tpcc(t64(va), t64(q), t64(crx), t64(cry), t64(ymass),
                        iord, jord, t64(cose), torch.as_tensor(ffsl))
    jfx, jfy = jtp.tpcc(va, q, crx, cry, ymass, iord, jord, cose, ffsl)
    assert_close(gfx, jfx, TOL_LEAF, "fx")
    assert_close(gfy, jfy, TOL_LEAF, "fy")
    wfx, wfy = orc.tpcc_oracle(va, q, crx, cry, ymass, iord, jord, cose,
                               ffsl)
    np.testing.assert_allclose(npy(gfx)[1:], wfx[1:], rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(npy(gfy), wfy, rtol=1e-12, atol=1e-13)


# ---------------------------------------------------------------------------
# physical checks on the port (tests/test_dyn_extras.py,
# tests/test_am_flags.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hs():
    grid, coord = _grids(48, 24, 6)
    return grid, coord, hs_initial_state(grid, coord, pert=1.0)


def test_fixer_restores_am_globally_and_by_level(hs):
    grid, coord, st = hs
    am0 = tdc.axial_angular_momentum(st, grid, per_level=True)
    st2 = st.replace(u=st.u + 0.5)
    am_tot = float(am0.sum())
    scale = abs(float(tdc.axial_angular_momentum(st2, grid)) - am_tot)
    assert scale > 0.0
    st3, du_k = tdc.am_fixer(st2, grid, am0)       # untapered: exact
    assert abs(float(tdc.axial_angular_momentum(st3, grid)) - am_tot) < \
        1e-12 * scale
    assert du_k.shape == (st.km,)
    st4, _ = tdc.am_fixer(st2, grid, am0, lbl=True)
    lvl_scale = float((tdc.axial_angular_momentum(st2, grid, True) -
                       am0).abs().max())
    np.testing.assert_allclose(
        npy(tdc.axial_angular_momentum(st4, grid, True)), npy(am0),
        atol=lvl_scale * 1e-12)
    assert float(tdc.benergy(st, grid, coord.ptop)) > 0.0


def test_taper_shape():
    coord = tvert.hybrid_coefficients(26, device="cpu")
    tpr = npy(tdc.am_taper(coord, 95e2, 10e2, 26, high_order_top=False))
    assert tpr.shape == (26,)
    assert np.all(tpr[:26 // 8] == 0.0)
    assert tpr[-1] > 0.99
    assert np.all(np.diff(tpr[26 // 8:]) >= -1e-12)


def test_dyn_run_fixer_conserves_am_and_omega(hs):
    grid, coord, st = hs
    st = st.replace(u=st.u + 20.0 * grid.cose[None, :, None])
    phis = torch.zeros((24, 48), dtype=torch.float64)
    am0 = float(tdc.axial_angular_momentum(st, grid))
    am = {}
    for fix in (True, False):
        cfg = FVConfig(nsplit=2, nspltrac=1, am_fixer=fix,
                       am_fix_tpr_h=1.0, am_fix_tpr_w=0.5)
        new, d = tdc.dyn_run(st, grid, coord, phis, cfg, 1800.0,
                             return_diags=True)
        am[fix] = float(tdc.axial_angular_momentum(new, grid))
    assert abs(am[True] - am0) < 0.2 * abs(am[False] - am0) + \
        1e-10 * abs(am0)
    om = npy(d["omega"])
    assert om.shape == tuple(st.delp.shape) and np.isfinite(om).all()
    assert 0.0 < np.abs(om).max() < 50.0


@pytest.fixture(scope="module")
def hs8():
    grid, coord = _grids(48, 32, 8)
    return grid, coord, hs_initial_state(grid, coord, pert=1.0)


def test_high_altitude_constant_composition_noop(hs8):
    grid, coord, st = hs8
    phis = torch.zeros((32, 48), dtype=torch.float64)
    base = tdc.dyn_run(st, grid, coord, phis, FVConfig(), 900.0)
    ha = tdc.dyn_run(st, grid, coord, phis, FVConfig(high_altitude=True),
                     900.0)
    np.testing.assert_allclose(npy(ha.pt), npy(base.pt), rtol=1e-9)
    np.testing.assert_allclose(npy(ha.q), npy(base.q), rtol=1e-12)


def test_am_correction_budget_with_topography(hs8):
    """Over the mountain, ΔAM of one small step with the correction is
    dt·torque to the remap's roundoff, much closer than without."""
    grid, coord, st0 = hs8
    phis = t64(mountain(32, 48))
    for _ in range(2):
        st0 = tdc.dyn_run(st0, grid, coord, phis, FVConfig(), 900.0)
    am0 = float(tdc.axial_angular_momentum(st0, grid))
    tq = float(tdc.mountain_torque(st0, phis, grid, coord.ptop))
    assert tq != 0.0
    mism = {}
    for flag in (False, True):
        st = tdc.dyn_run(st0, grid, coord, phis,
                         FVConfig(am_correction=flag, nsplit=1, nspltrac=1),
                         900.0)
        mism[flag] = abs(float(tdc.axial_angular_momentum(st, grid)) - am0 -
                         900.0 * tq)
        if flag:
            assert torch.equal(st.delp, base.delp)
        base = st
    assert mism[True] < 0.25 * mism[False], mism


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_fixer_and_high_altitude_on_the_card():
    """One dyn_run with the fixer, the correction and am_diag, and one
    with high_altitude (species), 48 x 24 x 6 float64, through the kernels
    (the fused K1-K4, tracer_div3d with five tracers, te_map_remap)
    against the CPU's plain versions within 1e-9 of each field's max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    from cam_nor_physics_tpu_torch.ops import stencil_kernels
    cfgs = (dict(am_fixer=True, am_correction=True, am_diag=True),
            dict(high_altitude=True, major_species=SPECIES))
    runs = {}
    for dev in ("cpu", "cuda"):
        grid = tgrid.make_grid(48, 24, 6, device=dev)
        coord = tvert.hybrid_coefficients(6, device=dev)
        st, phis = jw_baroclinic_wave(grid, coord, nq=4, device=dev)
        q = st.q.clone()
        q[1:] = 0.1
        st = st.replace(q=q)
        stencil_kernels.tracer_div3d.launches = 0
        runs[dev] = [tdc.dyn_run(st, grid, coord, phis, FVConfig(**kw),
                                 1800.0, return_diags=True) for kw in cfgs]
    assert stencil_kernels.tracer_div3d.launches > 0
    for (gs, gd), (ws, wd) in zip(runs["cuda"], runs["cpu"]):
        for f in ("u", "v", "pt", "delp", "q"):
            assert_close(getattr(gs, f), getattr(ws, f), TOL, f)
        for k in wd:
            if k != "floor_activations":
                assert_close(gd[k], wd[k], TOL, k)
