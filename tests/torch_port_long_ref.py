"""The JAX package's long runs as the reference of
tests/test_torch_long_runs.py.

    python tests/torch_port_long_ref.py DIR

Runs in a fresh interpreter (ROADMAP R1: JAX's programs stay out of the
xdist workers), with the test suite's JAX settings (tests/conftest.py:
CPU, float64, the persistent compile cache). DIR/in.pkl holds {"mode":
"hs" or "jw", "cases": {...}} of the test's settings; the script writes
DIR/out.pkl, {flag: {key: value}}.

The loops are those of the JAX package's tools, written out here (the
tools are scripts, not imported), in float64, jitted as the tools jit
them: "hs" is tools/hs_climate.py's (dyn_run then hs_forcing a step, a
climatology sample every `sample_every` steps after the spin-up; the
resolved climatology and hs94_checks' values), "jw" tools/jw_baroclinic.py's
(dyn_run a step from the perturbed JW06 state; each day's ps_min, max|u|
and the mass-weighted eddy kinetic energy of
tests/test_baroclinic_wave.py). A flag of None is FVConfig()'s default.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402,F401  (CPU, float64)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cam_nor_physics_tpu.models.fv.cd_core import (d2a_winds,  # noqa: E402
                                                   pressure_vars)
from cam_nor_physics_tpu.models.fv.dyn_comp import dyn_run  # noqa: E402
from cam_nor_physics_tpu.models.fv.grid import make_grid  # noqa: E402
from cam_nor_physics_tpu.models.fv.vertical import \
    hybrid_coefficients  # noqa: E402
from cam_nor_physics_tpu.utils.config import FVConfig  # noqa: E402


def _cfg(flag):
    return FVConfig() if flag is None else FVConfig(div24del2flag=flag)


def run_hs(cases):
    from cam_nor_physics_tpu.models.fv.ctem import default_ctem_levels
    from cam_nor_physics_tpu.models.fv.held_suarez import (hs_forcing,
                                                           hs_initial_state)
    from cam_nor_physics_tpu.utils.climatology import (climo_init,
                                                       climo_resolve,
                                                       climo_update,
                                                       hs94_checks)
    im, jm, km = cases["shape"]
    dt, every = cases["dt"], cases["sample_every"]
    grid, coord = make_grid(im, jm, km), hybrid_coefficients(km)
    phis = jnp.zeros((jm, im), jnp.float64)
    plev = default_ctem_levels(km)
    out = {}
    for flag in cases["flags"]:
        cfg = _cfg(flag)

        @jax.jit
        def step(state):
            state = dyn_run(state, grid, coord, phis, cfg, dt)
            return hs_forcing(state, grid, coord.ptop, dt)

        @jax.jit
        def sample(state, acc):
            ua, va = d2a_winds(state.u, state.v)
            pe, _pk, pkz, _peln = pressure_vars(state.delp, coord.ptop)
            pmid = 0.5 * (pe[1:] + pe[:-1])
            return climo_update(acc, ua, va, state.pt * pkz, pmid, plev)

        state = hs_initial_state(grid, coord, pert=1.0, dtype=jnp.float64)
        acc = climo_init(km, jm, dtype=jnp.float64)
        nspin = int(cases["spinup"] * 86400 / dt)
        for i in range(int(cases["days"] * 86400 / dt)):
            state = step(state)
            if i >= nspin and (i % every) == 0:
                acc = sample(state, acc)
        climo = climo_resolve(acc)
        checks = hs94_checks(climo, np.degrees(grid.lats), plev)
        out[flag] = {"climo": {k: np.asarray(v) for k, v in climo.items()},
                     "checks": {k: (float(v[0]), bool(v[1]))
                                for k, v in checks.items()}}
    return out


def run_jw(cases):
    from cam_nor_physics_tpu.models.fv.baroclinic_wave import \
        jw_baroclinic_wave
    im, jm, km = cases["shape"]
    dt = cases["dt"]
    grid, coord = make_grid(im, jm, km), hybrid_coefficients(km)
    per_day = int(86400 / dt)
    out = {}
    for flag in cases["flags"]:
        cfg = _cfg(flag)
        state, phis = jw_baroclinic_wave(grid, coord, perturb=True,
                                         dtype=jnp.float64)
        phis = jnp.asarray(phis.astype(jnp.float64))

        @jax.jit
        def step(s):
            return dyn_run(s, grid, coord, phis, cfg, dt)

        @jax.jit
        def metrics(s):
            pe = pressure_vars(s.delp, coord.ptop)[0]
            up = s.u - jnp.mean(s.u, axis=-1, keepdims=True)
            vp = s.v - jnp.mean(s.v, axis=-1, keepdims=True)
            eke = jnp.sum(0.5 * (up * up + vp * vp) * s.delp) / \
                jnp.sum(s.delp)
            return jnp.min(pe[-1]) / 100.0, jnp.max(jnp.abs(s.u)), eke

        series = []
        for i in range(int(cases["days"] * per_day)):
            state = step(state)
            if (i + 1) % per_day == 0:
                p, u, e = (float(x) for x in metrics(state))
                series.append({"day": (i + 1) / per_day, "ps_min_hpa": p,
                               "umax_ms": u, "eke": e})
        out[flag] = {"series": series}
    return out


def main(d):
    jax.config.update("jax_disable_most_optimizations", True)
    with open(os.path.join(d, "in.pkl"), "rb") as f:
        job = pickle.load(f)
    out = {"hs": run_hs, "jw": run_jw}[job["mode"]](job["cases"])
    with open(os.path.join(d, "out.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
