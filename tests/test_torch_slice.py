"""The port's Held-Suarez large step against the JAX package's, end to end.

- The unfused step: two HS large steps (dyn_run with FVConfig(nsplit=4,
  nspltrac=1), filter_impl="matmul", then hs_forcing; dt = 1800 s) from
  the same initial state, float64 on the CPU: the JAX step jitted with
  use_pallas=False, the port's build_step(device="cpu",
  filter_impl="matmul"). Tolerance 1e-7 relative to each field's largest
  magnitude: the two packages evaluate log/pow with different math
  libraries, and the pressure-gradient cancellation amplifies those ulps
  (the fused-vs-XLA argument of tests/test_cd_pallas.py:48-58); measured
  ~1e-12.
- The fused step, the default: one HS large step with filter_impl="fft"
  at 36x24x6, the port's build_step against JAX's dyn_run with
  FVConfig(use_pallas=True), its cd_pallas gate opened and cd_step_fused
  run in interpret mode (patched in the test process only; trac2d and
  te_map stay on XLA on the CPU). Both take the fused small step four
  times. Tolerance 1e-9 of each field's max (ps, pt, u, v, delp, q).

The initial state is hs_initial_state plus a seeded positive tracer, so
trac2d and the filler do real work. The JAX steps compile in a fresh
interpreter (conftest.run_test_in_subprocess), never inside a shared xdist
worker.
"""

import numpy as np
import torch

from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import build_step
from conftest import run_test_in_subprocess
from torch_port_util import assert_close

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

IM, JM, KM = 24, 16, 6
NSTEPS = 2
TOL = 1e-7
FUSED_SHAPE = (36, 24, 6)
TOL_FUSED = 1e-9


def _initial_fields(im, jm, km, filter_impl):
    """The port's HS step and its initial state with a seeded positive
    tracer, as numpy arrays."""
    step, state, grid, coord, phis = build_step(
        im, jm, km, torch.float64, "cpu", filter_impl=filter_impl)
    rng = np.random.default_rng(11)
    fields = convert.dynstate_to_numpy(state)
    fields["q"] = 1e-3 * (1.0 + 0.5 * rng.uniform(size=fields["q"].shape))
    return step, fields, grid, coord, phis


def _jax_steps(fields, nsteps):
    import jax
    import jax.numpy as jnp

    from cam_nor_physics_tpu.models.fv.cd_core import DynState
    from cam_nor_physics_tpu.models.fv.dyn_comp import dyn_run
    from cam_nor_physics_tpu.models.fv.grid import make_grid
    from cam_nor_physics_tpu.models.fv.held_suarez import hs_forcing
    from cam_nor_physics_tpu.models.fv.vertical import hybrid_coefficients
    from cam_nor_physics_tpu.utils.config import FVConfig

    grid = make_grid(IM, JM, KM)
    coord = hybrid_coefficients(KM)
    phis = jnp.zeros((JM, IM))
    cfg = FVConfig(nsplit=4, nspltrac=1, use_pallas=False)

    @jax.jit
    def step(state):
        state = dyn_run(state, grid, coord, phis, cfg, 1800.0,
                        filter_impl="matmul")
        return hs_forcing(state, grid, coord.ptop, 1800.0)

    state = DynState(**{f: jnp.asarray(a) for f, a in fields.items()})
    for _ in range(nsteps):
        state = step(state)
    return {f: np.asarray(getattr(state, f)) for f in fields}


def test_hs_large_steps_match_jax(request):
    if run_test_in_subprocess(request, timeout=300):
        return
    step, fields, grid, coord, phis = _initial_fields(IM, JM, KM, "matmul")
    state = convert.dynstate_from_numpy(fields, "cpu")
    for _ in range(NSTEPS):
        state = step(state, grid, coord, phis)
    got = convert.dynstate_to_numpy(state)
    want = _jax_steps(fields, NSTEPS)
    for f in convert.STATE_FIELDS:
        assert np.isfinite(got[f]).all(), f
        assert_close(got[f], want[f], TOL, f)


def _jax_fused_step(fields, monkeypatch):
    """One JAX HS large step with the fused small step in interpret mode;
    returns the state and the number of fused small steps traced."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from cam_nor_physics_tpu.models.fv import cd_pallas
    from cam_nor_physics_tpu.models.fv.cd_core import DynState
    from cam_nor_physics_tpu.models.fv.dyn_comp import dyn_run
    from cam_nor_physics_tpu.models.fv.grid import make_grid
    from cam_nor_physics_tpu.models.fv.held_suarez import hs_forcing
    from cam_nor_physics_tpu.models.fv.vertical import hybrid_coefficients
    from cam_nor_physics_tpu.utils.config import FVConfig

    traced = []
    fused = partial(cd_pallas.cd_step_fused, interpret=True)

    def counted(*a, **kw):
        traced.append(1)
        return fused(*a, **kw)

    monkeypatch.setattr(cd_pallas, "use_pallas", lambda *a, **kw: True)
    monkeypatch.setattr(cd_pallas, "cd_step_fused", counted)
    im, jm, km = FUSED_SHAPE
    grid = make_grid(im, jm, km)
    coord = hybrid_coefficients(km)
    phis = jnp.zeros((jm, im))
    cfg = FVConfig(nsplit=4, nspltrac=1, use_pallas=True)

    @jax.jit
    def step(state):
        state = dyn_run(state, grid, coord, phis, cfg, 1800.0,
                        filter_impl="fft")
        return hs_forcing(state, grid, coord.ptop, 1800.0)

    state = step(DynState(**{f: jnp.asarray(a) for f, a in fields.items()}))
    return {f: np.asarray(getattr(state, f)) for f in fields}, len(traced)


def test_hs_fft_large_step_matches_jax_fused(request, monkeypatch):
    if run_test_in_subprocess(request, timeout=300):
        return
    from cam_nor_physics_tpu_torch.models.fv import cd_fused

    calls = []
    real = cd_fused.cd_step_fused
    monkeypatch.setattr(cd_fused, "cd_step_fused",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    step, fields, grid, coord, phis = _initial_fields(*FUSED_SHAPE, "fft")
    state = step(convert.dynstate_from_numpy(fields, "cpu"), grid, coord,
                 phis)
    assert len(calls) == 4
    got = convert.dynstate_to_numpy(state)
    want, traced = _jax_fused_step(fields, monkeypatch)
    assert traced >= 1      # the JAX step went through cd_step_fused
    got["ps"], want["ps"] = (coord.ptop + f["delp"].sum(0)
                             for f in (got, want))
    for f in ("ps",) + convert.STATE_FIELDS:
        assert np.isfinite(got[f]).all(), f
        assert_close(got[f], want[f], TOL_FUSED, f)
