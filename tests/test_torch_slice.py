"""The port's Held-Suarez large step against the JAX package's, end to end.

Two HS large steps (dyn_run with FVConfig(nsplit=4, nspltrac=1),
filter_impl="matmul", then hs_forcing; dt = 1800 s) from the same initial
state, float64 on the CPU: the JAX step jitted with use_pallas=False, the
port's build_step(device="cpu"). The initial state is hs_initial_state plus
a seeded positive tracer, so trac2d and the filler do real work. Tolerance
1e-7 relative to each field's largest magnitude: the two packages evaluate
log/pow with different math libraries, and the pressure-gradient
cancellation amplifies those ulps (the fused-vs-XLA argument of
tests/test_cd_pallas.py:48-58); measured ~1e-12.

The JAX step's compile runs in a fresh interpreter
(conftest.run_test_in_subprocess), never inside a shared xdist worker.
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
    step, state, grid, coord, phis = build_step(IM, JM, KM, torch.float64,
                                                "cpu")
    rng = np.random.default_rng(11)
    fields = convert.dynstate_to_numpy(state)
    fields["q"] = 1e-3 * (1.0 + 0.5 * rng.uniform(size=fields["q"].shape))
    state = convert.dynstate_from_numpy(fields, "cpu")
    for _ in range(NSTEPS):
        state = step(state, grid, coord, phis)
    got = convert.dynstate_to_numpy(state)
    want = _jax_steps(fields, NSTEPS)
    for f in convert.STATE_FIELDS:
        assert np.isfinite(got[f]).all(), f
        assert_close(got[f], want[f], TOL, f)
