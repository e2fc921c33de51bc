"""The port's coupled atm_step against the JAX package's, float64 on the
CPU, and the step's own contracts.

- atm_step at 48 x 24 x 10 with FVConfig(nsplit=4, nspltrac=1), the
  initial state of tests/test_atm_comp.py:16-30 (hs_initial_state, q =
  1e-4 but vapour 3e-3 delp / max delp, zero phis), bench.py's physics
  (gray radiation, ZMConfig()) with cam_snapshot on, and cam_in from
  bulk_surface_fluxes over aquaplanet_sst each step: the first step
  (first_step=True, JAX's nstep == 0 branch of tphysbc) and 2 more. Both
  packages run the unfused small step (filter_impl="matmul"; JAX's XLA
  cd_step, whose fused form the port's other tests hold:
  test_torch_slice.py, test_torch_cd_fused.py). After each step the
  dycore state, the physics export, the physics buffer, cam_out and
  every diagnostic (the key sets equal) are within 1e-9 of each field's
  max, and ZM's trigger and level indices are equal. The diagnostics
  carry the snapshots of tphysbc's and tphysac's sites, so this holds
  tphysbc's state at each site too. The energy residual ZM_TE_ERR, a
  difference of two column energies of ~1e9 J/m2, is held to the column
  energy's scale, and the tendencies of the cloud tracers (which start
  uniform, so that their transport is a difference of nearly equal
  fluxes: ZMDLIQ, ZMDICE, DCCLDLIQ, DCCLDICE and the snapshots' PTEND_Q)
  to the rate that changes the tracer by its max in a step. JAX's step is lowered twice (first_step True and
  False) and compiled on a second thread while the port runs, in a fresh
  interpreter (conftest.run_test_in_subprocess).
- Dry-air mass over one step at rtol 5e-7 (tests/test_atm_comp.py:48-65).
- With FVConfig(nsplit=8, nspltrac=2) (f09's splits: trac2d twice a step,
  the second on the first's output) two steps run, finite, with the
  kernels' input checks (the same on CPU tensors) passed.
- The step reads no device value on the host and copies no host value
  to the device, so a CUDA graph can capture it: under a dispatch mode
  that logs every _local_scalar_dense, nonzero and index.Tensor, the
  only ones are the float(torch.tensor(eps, dtype=...)) constants of the
  ZM code (CPU scalars, never on the card).
- cam_physpkg="cam3" raises; a non-empty aero_modes, raytau0 > 0 and
  do_circulation_diags (ported since they raised) run: the TEM fields
  join the step's diagnostics, and Rayleigh friction does not speed up
  the top level's winds.
"""

import linecache
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import build_coupled
from cam_nor_physics_tpu_torch.models.atm_comp import (AtmModel, atm_init,
                                                       atm_step)
from cam_nor_physics_tpu_torch.models.coupling.surface_fluxes import (
    aquaplanet_sst, bulk_surface_fluxes)
from cam_nor_physics_tpu_torch.models.fv.held_suarez import hs_initial_state
from cam_nor_physics_tpu_torch.utils.config import (FVConfig, PhysConfig,
                                                     ZMConfig)
from conftest import run_test_in_subprocess
from torch_port_util import assert_close

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

IM, JM, KM = 48, 24, 10
DT = 1800.0
TOL = 1e-9
NSTEPS = 3                 # the first step and 2 more
INDEX_KEYS = ("ZM_IDEEP", "ZM_JT", "ZM_MAXG", "CLDTOP", "CLDBOT")


def _model(fv_cfg=None, im=IM, jm=JM, km=KM, **phys):
    return AtmModel.create(
        im, jm, km, dt=DT, fv_cfg=fv_cfg or FVConfig(nsplit=4, nspltrac=1),
        phys_cfg=PhysConfig(radiation_scheme="gray", **phys),
        zm_cfg=ZMConfig(), filter_impl="matmul", device="cpu")


def _initial(model):
    """tests/test_atm_comp.py's coupled state, and the SST."""
    pcnst = model.registry.pcnst
    dyn = hs_initial_state(model.grid, model.coord, pert=1.0, nq=pcnst)
    q = torch.full_like(dyn.q, 1e-4)
    q[0] = 3e-3 * (dyn.delp / dyn.delp.max())
    jm, im = model.grid.jm, model.grid.im
    state = atm_init(model, dyn.replace(q=q),
                     torch.zeros((jm, im), dtype=torch.float64))
    return state, aquaplanet_sst(state.phys.lat)


def _step(model, state, sst, first_step=False):
    cam_in = bulk_surface_fluxes(state.phys, sst, model.registry.pcnst)
    return atm_step(model, state, cam_in, first_step=first_step)


def _start_jax(pool, fields, sst):
    """Lower JAX's coupled step for the first step and for the others and
    compile both on `pool`; returns a function that waits and runs NSTEPS
    steps from `fields`, giving each step's (state, cam_out, diags)."""
    import jax
    import jax.numpy as jnp

    from cam_nor_physics_tpu.models.atm_comp import AtmModel as JModel
    from cam_nor_physics_tpu.models.atm_comp import AtmState
    from cam_nor_physics_tpu.models.atm_comp import atm_step as jstep
    from cam_nor_physics_tpu.models.coupling.surface_fluxes import \
        bulk_surface_fluxes as jbulk
    from cam_nor_physics_tpu.models.fv.cd_core import DynState
    from cam_nor_physics_tpu.models.physics.physics_buffer import \
        PhysicsBuffer
    from cam_nor_physics_tpu.models.physics.state import PhysicsState
    from cam_nor_physics_tpu.utils import config as jc
    jax.config.update("jax_disable_most_optimizations", True)
    model = JModel.create(
        IM, JM, KM, dt=DT,
        fv_cfg=jc.FVConfig(nsplit=4, nspltrac=1, use_pallas=False),
        phys_cfg=jc.PhysConfig(radiation_scheme="gray", cam_snapshot=True),
        zm_cfg=jc.ZMConfig(), filter_impl="matmul")
    jsst = jnp.asarray(sst)
    pb, lifetimes = fields["pbuf"]
    state = AtmState(
        dyn=DynState(**{k: jnp.asarray(v) for k, v in fields["dyn"].items()}),
        phys=PhysicsState(**{k: jnp.asarray(v)
                             for k, v in fields["phys"].items()}),
        pbuf=PhysicsBuffer(fields={k: jnp.asarray(v) for k, v in pb.items()},
                           lifetimes=lifetimes),
        phis=jnp.asarray(fields["phis"]),
        nstep=jnp.asarray(fields["nstep"], jnp.int32))

    def step(s, first_step):
        return jstep(model, s, jbulk(s.phys, jsst, model.registry.pcnst),
                     first_step=first_step)

    step = jax.jit(step, static_argnums=1)
    exes = [pool.submit(step.lower(state, first).compile)
            for first in (True, False)]

    def run():
        out, s = [], state
        for i in range(NSTEPS):
            res = exes[min(i, 1)].result()(s)
            out.append(res)
            s = res[0]
        return out
    return run


def _flat(state, cam_out, diags):
    f = convert.atmstate_to_numpy(state)
    res = {f"dyn.{k}": v for k, v in f["dyn"].items()}
    res.update({f"phys.{k}": v for k, v in f["phys"].items()})
    res.update({f"pbuf.{k}": v for k, v in f["pbuf"][0].items()})
    res.update({f"cam_out.{k}": v
                for k, v in convert.camout_to_numpy(cam_out).items()})
    res.update({f"diag.{k}": np.asarray(convert._np(v))
                for k, v in diags.items()})
    res["nstep"] = np.asarray(f["nstep"])
    return res


# tendencies of the cloud tracers, by the tracer's index: CLDLIQ and
# CLDICE start uniform, so these are differences of nearly equal fluxes
TRACER_TENDS = {"ZMDLIQ": 1, "DCCLDLIQ": 1, "ZMDICE": 2, "DCCLDICE": 2}


def _scale(want, key):
    """The magnitude a field is held to: its max, but the column energy's
    for ZM's energy residual (a difference of two column energies), and
    for a tracer's tendency the rate that changes the tracer by its max in
    one step."""
    name = key.split(".", 1)[1]
    if name == "ZM_TE_ERR":
        return float(np.abs(want["phys.te_cur"]).max())
    m = TRACER_TENDS.get(name)
    if name.startswith("SNAP_") and "_PTEND_Q" in name:
        m = int(name[-2:])
    if m is not None:
        return float(np.abs(want["phys.q"][..., m]).max()) / DT
    return None


def test_atm_step_matches_jax(request):
    if run_test_in_subprocess(request, timeout=900):
        return
    model = _model(cam_snapshot=True)
    state, sst = _initial(model)
    fields = convert.atmstate_to_numpy(state)
    with ThreadPoolExecutor(1) as pool:
        jax_run = _start_jax(pool, fields, sst.numpy())
        got = []
        s = convert.atmstate_from_numpy(fields, "cpu")
        for i in range(NSTEPS):
            res = _step(model, s, sst, first_step=i == 0)
            got.append(_flat(*res))
            s = res[0]
        want = [_flat(*res) for res in jax_run()]
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (i, set(g) ^ set(w))
        for k in g:
            try:
                if k == "nstep" or k.split(".", 1)[1] in INDEX_KEYS:
                    np.testing.assert_array_equal(g[k], w[k])
                else:
                    assert_close(g[k], w[k], TOL, k, scale=_scale(w, k))
            except AssertionError as e:
                bad.append(f"step {i} {k}: {str(e).splitlines()[:6]}")
        assert int(g["nstep"]) == i + 1
    assert not bad, "\n".join(bad)
    # the first step took tphysbc's nstep == 0 branch, the others not;
    # convection, the energy fixer and the snapshots were active
    assert "diag.DTCORE" not in want[0] and "diag.DTCORE" in want[1]
    assert any(k.startswith("diag.SNAP_") for k in want[0])
    assert want[-1]["diag.CAPE"].max() > 0 and want[-1]["pbuf.ZM_IDEEP"].any()
    assert np.abs(want[-1]["diag.EFIX"]).max() > 0


def _dry_mass(model, state):
    g = model.grid
    w = g.cosp.clone()
    w[0] = w[-1] = g.acap / g.im
    d = state.dyn
    return float((w[:, None] * d.delp * (1.0 - d.q[0])).sum())


def test_dry_air_mass_conserved():
    model = _model()
    state, sst = _initial(model)
    m0 = _dry_mass(model, state)
    state, _, _ = _step(model, state, sst, first_step=True)
    np.testing.assert_allclose(_dry_mass(model, state), m0, rtol=5e-7)


def test_tracer_subcycled_coupled_steps():
    model = _model(FVConfig(nsplit=8, nspltrac=2), 24, 16, 6)
    state, sst = _initial(model)
    m0 = _dry_mass(model, state)
    for i in range(2):
        state, cam_out, _ = _step(model, state, sst, first_step=i == 0)
    for t in (state.dyn.u, state.dyn.pt, state.dyn.q, state.phys.t,
              cam_out.precc):
        assert torch.isfinite(t).all()
        assert t.is_contiguous() or t.ndim == 1
    np.testing.assert_allclose(_dry_mass(model, state), m0, rtol=5e-6)


class _HostReads(TorchDispatchMode):
    """Logs the operations that read a tensor's value on the host or
    index with a host tensor, with the port's source line."""

    WATCH = ("aten._local_scalar_dense.default", "aten.nonzero.default",
             "aten.index.Tensor")

    def __init__(self):
        super().__init__()
        self.sites = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in self.WATCH:
            frames = [f for f in traceback.extract_stack()
                      if "cam_nor_physics_tpu_torch" in f.filename]
            self.sites.append((str(func), frames[-1] if frames else None))
        return func(*args, **(kwargs or {}))


def test_coupled_step_reads_no_device_value_on_host():
    model, step, state, _ = build_coupled(24, 16, 6, torch.float64, "cpu",
                                          fv_cfg=FVConfig(nsplit=4,
                                                          nspltrac=1))
    state, _, _ = step(state, first_step=True)
    with _HostReads() as mode:
        step(state)
    assert mode.sites
    for op, frame in mode.sites:
        assert frame is not None, op
        line = linecache.getline(frame.filename, frame.lineno)
        assert op == "aten._local_scalar_dense.default" and \
            "float(torch.tensor(" in line, (op, frame.filename,
                                             frame.lineno, line)


@pytest.mark.parametrize("option", ["cam_physpkg", "aero_modes", "raytau0",
                                    "do_circulation_diags"])
def test_unported_options_raise(option):
    """The options the port does not implement raise. aero_modes, which
    raised until the modal aerosol was ported, runs: the coupled step of
    entry.build_coupled(aerosol=True) emits the AOD family and fills
    NAER (tests/test_torch_aerosol.py holds the branch to JAX)."""
    if option == "aero_modes":
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, step, state, _ = build_coupled(
                12, 8, 4, torch.float64, "cpu",
                fv_cfg=FVConfig(nsplit=2, nspltrac=1), aerosol=True)
            state, _, diags = step(state, first_step=True)
        assert float(diags["AODVIS_accum"].min()) > 0.0
        assert float(state.pbuf.get("NAER").min()) > 0.0
        return
    if option == "cam_physpkg":
        with pytest.raises(NotImplementedError, match=option):
            _model(FVConfig(nsplit=2, nspltrac=1), 12, 8, 4,
                   cam_physpkg="cam3")
        return
    value = {"raytau0": 1.0, "do_circulation_diags": True}[option]
    model = _model(FVConfig(nsplit=2, nspltrac=1), 12, 8, 4,
                   cam_snapshot=True, **{option: value})
    state, sst = _initial(model)
    state, _, diags = _step(model, state, sst, first_step=True)
    for t in (state.dyn.u, state.dyn.pt, state.phys.t):
        assert torch.isfinite(t).all()
    if option == "do_circulation_diags":
        for k in ("U2d", "V2d", "W2d", "TH2d", "VTH2d", "WTH2d", "UV2d",
                  "UW2d"):
            assert diags[k].shape == (4, 8) and torch.isfinite(
                diags[k]).all(), k
    else:
        u0 = diags["SNAP_rayleigh_before_U"][:, 0]
        u1 = diags["SNAP_rayleigh_after_U"][:, 0]
        assert (u1.abs() <= u0.abs()).all()
