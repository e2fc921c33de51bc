"""The JAX package's single-device runs that the port's multi-process
tests (tests/test_torch_parallel.py, tests/test_torch_distributed.py)
hold their reassembled strips to.

    python tests/torch_port_parallel_ref.py DIR

Runs in a fresh interpreter (ROADMAP R1: JAX's big programs stay out of
the xdist workers), with the test suite's JAX settings (tests/conftest.py:
CPU, float64, the persistent compile cache). DIR/in.pkl holds {"mode",
"cases"} of numpy inputs made by tests/torch_port_parallel_cases.py; the
script writes DIR/out.pkl, {case: {key: numpy array}}. "cases" is a dict
of {case name: (mode, inputs)}, each run in turn:

- "stencils": transport3d, vort_flux3d and tracer_div3d of
  ops/pallas_kernels on the whole slab (on the CPU the XLA path, which
  tests/test_parallel.py:128-158 holds JAX's strips to);
- "dyn": dyn_run, one large step per option set (tests/
  torch_port_modes_ref.py's run_dyn: FVConfig(use_pallas=False), the
  unfused step, with the set's filter_impl);
- "hs": n steps of dyn_run + hs_forcing (FVConfig(use_pallas=False),
  "matmul"), as tests/test_parallel.py:30-58 steps;
- "coupled": atm_step (FVConfig(use_pallas=False), "matmul", the other
  configurations' defaults), the first step and the others, as
  tests/test_parallel.py:66-117; the dycore fields, phys.t and TEGMEAN
  after each.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402,F401  (CPU, float64)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cam_nor_physics_tpu.utils.config import FVConfig  # noqa: E402
from torch_port_modes_ref import DYN, run_dyn  # noqa: E402


def _grids(shape):
    from cam_nor_physics_tpu.models.fv.grid import make_grid
    from cam_nor_physics_tpu.models.fv.vertical import hybrid_coefficients
    im, jm, km = shape
    return make_grid(im, jm, km), hybrid_coefficients(km)


def run_stencils(cases):
    from cam_nor_physics_tpu.ops import pallas_kernels as pk
    out = {}
    for name, args in cases.items():
        res = getattr(pk, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                  else a for a in args])
        res = res if isinstance(res, tuple) else (res,)
        out.update({f"{name}{i}": np.asarray(r) for i, r in enumerate(res)})
    return out


def run_hs(cases):
    from cam_nor_physics_tpu.models.fv.cd_core import DynState
    from cam_nor_physics_tpu.models.fv.dyn_comp import dyn_run
    from cam_nor_physics_tpu.models.fv.held_suarez import hs_forcing
    jax.config.update("jax_disable_most_optimizations", True)
    grid, coord = _grids(cases["shape"])
    cfg = FVConfig(use_pallas=False, **cases["config"])
    dt, phis = cases["dt"], jnp.asarray(cases["phis"])
    step = jax.jit(lambda s: hs_forcing(
        dyn_run(s, grid, coord, phis, cfg, dt, filter_impl="matmul"), grid,
        coord.ptop, dt))
    st = DynState(**{f: jnp.asarray(cases["state"][f]) for f in DYN})
    for _ in range(cases["nsteps"]):
        st = step(st)
    return {f: np.asarray(getattr(st, f)) for f in DYN}


def run_coupled(cases):
    from cam_nor_physics_tpu.models.atm_comp import (AtmModel, AtmState,
                                                     atm_step)
    from cam_nor_physics_tpu.models.coupling.camsrfexch import CamIn
    from cam_nor_physics_tpu.models.fv.cd_core import DynState
    from cam_nor_physics_tpu.models.physics.physics_buffer import \
        PhysicsBuffer
    from cam_nor_physics_tpu.models.physics.state import PhysicsState
    jax.config.update("jax_disable_most_optimizations", True)
    im, jm, km = cases["shape"]
    model = AtmModel.create(
        im, jm, km, dt=cases["dt"],
        fv_cfg=FVConfig(use_pallas=False, **cases["config"]),
        filter_impl="matmul")
    fields = cases["state"]
    pb, lifetimes = fields["pbuf"]
    state = AtmState(
        dyn=DynState(**{k: jnp.asarray(v) for k, v in fields["dyn"].items()}),
        phys=PhysicsState(**{k: jnp.asarray(v)
                             for k, v in fields["phys"].items()}),
        pbuf=PhysicsBuffer(fields={k: jnp.asarray(v) for k, v in pb.items()},
                           lifetimes=lifetimes),
        phis=jnp.asarray(fields["phis"]),
        nstep=jnp.asarray(fields["nstep"], jnp.int32))
    cam_in = CamIn(**{k: jnp.asarray(v) for k, v in cases["cam_in"].items()})
    step = jax.jit(lambda s, first: atm_step(model, s, cam_in,
                                             first_step=first),
                   static_argnums=1)
    out = {}
    for n in range(cases["nsteps"]):
        state, _, diags = step(state, n == 0)
        out.update({f"{f}.{n}": np.asarray(getattr(state.dyn, f))
                    for f in DYN})
        out[f"phys.t.{n}"] = np.asarray(state.phys.t)
        out[f"TEGMEAN.{n}"] = np.asarray(diags["TEGMEAN"])
    return out


RUNS = {"stencils": run_stencils, "dyn": run_dyn, "hs": run_hs,
        "coupled": run_coupled}


def main(root):
    with open(os.path.join(root, "in.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {name: RUNS[mode](cases)
           for name, (mode, cases) in inp["cases"].items()}
    with open(os.path.join(root, "out.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
