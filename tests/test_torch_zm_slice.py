"""The port's ZM step and ZM core against the JAX package's, float64 on
the CPU, from one JAX run:

- zm_conv_tend on 16 columns x 26 levels of entry.varied_zm_inputs
  (bench.py's sounding with per-column temperature noise, winds, cloud
  tracers, cloud fraction, land/ocean and every fourth column stable),
  dt = 1800 s, ZMConfig() and default_registry(). Compared: every field
  of the summed ptend, the updated state, every pbuf field, the coupler
  outputs and every diagnostic (the key sets must be equal), each within
  1e-10 of the field's max; level indices equal.
- zm_convr as zm_conv_tend calls it (the default pair: batched parcel,
  newton solver, second_call on), its output captured inside the same
  JAX step, against the port's zm_convr on the step's input state.
- zm_convr with the reference-shaped pair (parcel_impl="scan",
  inversion_solver="brent") and second_call off (the branch the default
  configuration skips), on test_zm_conv.make_sounding's soundings,
  unstable and stable columns mixed (test_torch_zm_core._soundings).

For both zm_convr runs the trigger mask and the level indices (jt, maxg,
lel, jctop, jcbot) must be equal and every float output within 1e-10 of
its max: the cldprp oracle parity tolerance of
tests/test_zm_oracle_parity.py (measured ~1e-12; the two packages' libm
differ by an ulp in log/pow, and the Brent loops stop on the same pass).

On the CPU the port's tail runs the plain zm_conv_evap/momtran/convtran,
as the JAX package's does off the TPU. The JAX programs compile in a
fresh interpreter (conftest.run_test_in_subprocess), never inside a shared
xdist worker, with XLA's optimisations off to keep the compile short
(that changes how fast JAX computes, not what). Most of the test's time
is XLA loading the two executables from the persistent compile cache, so
the two load on threads of their own while the port runs.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import build_zm_step, varied_zm_inputs
from cam_nor_physics_tpu_torch.models.physics import zm_conv as tzm
from cam_nor_physics_tpu_torch.models.physics import zm_conv_intr as tzi
from cam_nor_physics_tpu_torch.models.physics.constituents import (
    Constituent, default_registry)
from cam_nor_physics_tpu_torch.utils.config import ZMConfig
from conftest import run_test_in_subprocess
from test_torch_zm_core import SCAN_CFG, SOUNDING, _soundings
from test_zm_conv import MSG

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

NCOL, PVER = 16, 26
TOL = 1e-10
INT_KEYS = {"jctop", "jcbot"}
CORE_FIELDS = [f for f in tzm.ZMCONV_FIELDS if f != "mrates"]


def _start_jax(pool, state_np, pbuf_np, lifetimes, forcing_np, snd,
               monkeypatch):
    """Lower the JAX side and load its two executables on `pool`'s
    threads; returns a function that waits for them and gives
    ((zm_conv_tend's output, the zm_convr output inside it) on the step
    inputs, zm_convr (scan/brent, second_call off) on the soundings
    `snd`)."""
    import jax
    import jax.numpy as jnp

    from cam_nor_physics_tpu.models.physics import zm_conv as jzm
    from cam_nor_physics_tpu.models.physics import zm_conv_intr as jzi
    from cam_nor_physics_tpu.models.physics.constituents import \
        default_registry
    from cam_nor_physics_tpu.models.physics.physics_buffer import \
        PhysicsBuffer
    from cam_nor_physics_tpu.models.physics.state import PhysicsState
    from cam_nor_physics_tpu.utils.config import ZMConfig as JCfg
    jax.config.update("jax_disable_most_optimizations", True)
    cfg, reg, scan_cfg = JCfg(), default_registry(), JCfg(**SCAN_CFG)
    core = []

    def capture(*a, **kw):
        out = jzm.zm_convr(*a, **kw)
        core.append(out)
        return out

    monkeypatch.setattr(jzi, "zm_convr", capture)

    @jax.jit
    def step(st, fields, pblh, tpert, landfrac):
        pb = PhysicsBuffer(fields=fields, lifetimes=lifetimes)
        out = jzi.zm_conv_tend(cfg, reg, st, pb, pblh, tpert, landfrac,
                               1800.0)
        return out, core[-1]

    scan = jax.jit(lambda *a: jzm.zm_convr(scan_cfg, MSG, *a, 900.0))
    scan_args = [jnp.asarray(snd[k]) for k in SOUNDING]
    step_args = (
        PhysicsState(**{k: jnp.asarray(v) for k, v in state_np.items()}),
        {k: jnp.asarray(v) for k, v in pbuf_np.items()},
        *[jnp.asarray(forcing_np[k]) for k in ("pblh", "tpert", "landfrac")])
    scan_exe = pool.submit(scan.lower(*scan_args).compile)
    step_exe = pool.submit(step.lower(*step_args).compile)
    return lambda: (step_exe.result()(*step_args),
                    scan_exe.result()(*scan_args))


def _check(got, want, tag):
    assert set(got) == set(want), (tag, set(got) ^ set(want))
    for k in sorted(got):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (tag, k, g.shape, w.shape)
        if k in INT_KEYS or w.dtype.kind in "bi":
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), f"{tag} {k}")
            continue
        scale = max(float(np.abs(w).max()), 1e-300)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                                   err_msg=f"{tag} {k}")


def _check_core(got, want, tag):
    assert got.mrates == {} and want.mrates == {}
    _check({f: convert._np(getattr(got, f)) for f in CORE_FIELDS},
           {f: np.asarray(getattr(want, f)) for f in CORE_FIELDS}, tag)


def test_zm_conv_tend_matches_jax(request, monkeypatch):
    if run_test_in_subprocess(request, timeout=900):
        return
    step, _, _, _ = build_zm_step(NCOL, PVER, torch.float64, "cpu")
    pstate, pbuf, forcing = varied_zm_inputs(NCOL, PVER, torch.float64,
                                             "cpu")
    state_np = convert.physstate_to_numpy(pstate)
    pbuf_np, lifetimes = convert.pbuf_to_numpy(pbuf)
    forcing_np = {k: v.numpy() for k, v in forcing.items()}
    snd = _soundings()
    with ThreadPoolExecutor(2) as pool:
        jax_results = _start_jax(pool, state_np, pbuf_np, lifetimes,
                                 forcing_np, snd, monkeypatch)

        # the port, from the same numpy arrays, while JAX loads
        pstate = convert.physstate_from_numpy(state_np, "cpu")
        pbuf = convert.pbuf_from_numpy(pbuf_np, lifetimes, "cpu")
        forcing = {k: torch.from_numpy(v) for k, v in forcing_np.items()}
        out = tzi.zm_conv_tend(ZMConfig(), default_registry(), pstate, pbuf,
                               forcing["pblh"], forcing["tpert"],
                               forcing["landfrac"], 1800.0)
        # zm_convr as zm_conv_tend calls it (batched, newton, second_call)
        core = tzm.zm_convr(ZMConfig(), 0, pstate.t, pstate.q[:, :, 0],
                            pstate.pmid, pstate.pint, pstate.pdel, pstate.zm,
                            pstate.phis, pstate.zi, forcing["pblh"],
                            forcing["tpert"], forcing["landfrac"], 900.0)
        # zm_convr with the scan parcel and the Brent solver
        scan = tzm.zm_convr(ZMConfig(**SCAN_CFG), MSG,
                            *[torch.from_numpy(snd[k]) for k in SOUNDING],
                            900.0)
        s1, pb1 = step(pstate, pbuf, forcing)
        (jout, jcore), jscan = jax_results()

    got, want = convert.zmtend_to_numpy(out), convert.zmtend_to_numpy(jout)
    _check(got, want, "zm_conv_tend")
    ideep = want["pbuf.ZM_IDEEP"]
    assert 0 < ideep.sum() < NCOL and ideep[3::4].sum() == 0
    assert np.abs(want["diag.ZMDLIQ"]).max() > 0      # convtran moved CLDLIQ
    assert np.abs(want["ptend.u"]).max() > 0          # momtran moved u

    _check_core(core, jcore, "zm_convr batched/newton")
    # the step the entry point builds is this same call
    assert torch.equal(s1.t, out.state1.t)
    assert torch.equal(pb1.get("ZM_MU"), out.pbuf.get("ZM_MU"))
    _check_core(scan, jscan, "zm_convr scan/brent")
    ideep = convert._np(scan.ideep)
    assert ideep[:6].sum() >= 4 and not ideep[6:].any()


def test_zm_org_feedback_and_tendency():
    """The ZM_ORG branch of zm_conv_tend (org on, ZM_ORG registered): the
    launch perturbation grows by clip(50 * mean organization of the lowest
    5 levels, 0, 2) K, and organization is sourced from the evaporation
    moistening with a 3 h decay: dorg = 1e3 max(evap dq, 0) - org / 10800
    (zm_conv_intr.F90:101-172, 773-777), in the port's own float64 run."""
    reg = default_registry().add(Constituent("ZM_ORG", qmin=0.0))
    pstate, pbuf, forcing = varied_zm_inputs(8, PVER, torch.float64, "cpu")
    org = torch.full((8, PVER, 1), 0.01, dtype=torch.float64)
    org[:, -5:, 0] = torch.linspace(0.0, 0.1, 8, dtype=torch.float64)[:, None]
    pstate = pstate.replace(q=torch.cat([pstate.q, org], -1))
    cfg = ZMConfig(org=True)
    out = tzi.zm_conv_tend(cfg, reg, pstate, pbuf, forcing["pblh"],
                           forcing["tpert"], forcing["landfrac"], 1800.0)
    low = org[:, -5:, 0].mean(-1)
    np.testing.assert_allclose(out.diagnostics["ZM_ORG2D"].numpy(),
                               low.numpy(), rtol=1e-15)
    # the same call with the boosted tpert and no ZM_ORG gives the same ZM
    # core, so the same evaporation
    ref = tzi.zm_conv_tend(cfg, default_registry(),
                           pstate.replace(q=pstate.q[:, :, :3]), pbuf,
                           forcing["pblh"],
                           forcing["tpert"] + torch.clamp(50.0 * low, 0, 2),
                           forcing["landfrac"], 1800.0)
    evap_dq = ref.diagnostics["EVAPQZM"]
    assert float(evap_dq.max()) > 0
    want = 1e3 * torch.clamp(evap_dq, min=0.0) - org[:, :, 0] / 10800.0
    np.testing.assert_allclose(out.ptend_all.q[:, :, 3].numpy(),
                               want.numpy(), rtol=1e-12, atol=1e-18)
    assert torch.equal(out.ptend_all.s, ref.ptend_all.s)
