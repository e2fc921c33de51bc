"""The JAX package's dycore options, fused small step and single-column
model as the reference of tests/test_torch_dyn_options.py,
tests/test_torch_cd_fused.py and tests/test_torch_modes.py.

    python tests/torch_port_modes_ref.py DIR

Runs in a fresh interpreter (ROADMAP R1: JAX's big programs stay out of
the xdist workers), with the test suite's JAX settings (tests/conftest.py:
CPU, float64, the persistent compile cache). DIR/in.pkl holds {"mode":
"cd_fused", "dyn" or "scam", "cases": {...}} of numpy inputs made by the
test; the script writes DIR/out.pkl, {case: {key: numpy array}}.

"cd_fused": tests/test_torch_cd_fused.py's JAX
cd_step_fused(interpret=True) for one of its flag sets, jitted. "dyn":
dyn_run with each option set of cases["configs"]
(FVConfig(use_pallas=False) and filter_impl="matmul", the unfused step
the port's "matmul" runs, unless the set names another filter_impl),
jitted, and, unless cases["debug"] is None,
one unfused cd_step with return_debug. "scam" (run by
tests/torch_port_microp_ref.py): scam_run, scam_run_iop and one
scam_step, op by op under jax.disable_jit() (jitted, SCAM's phys_run1 and
phys_run2 take minutes to compile on the CPU).
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
from cam_nor_physics_tpu.utils.config import PhysConfig  # noqa: E402
from cam_nor_physics_tpu.utils.config import ZMConfig  # noqa: E402

DYN = ("u", "v", "pt", "delp", "q")


def run_dyn(cases):
    from cam_nor_physics_tpu.models.fv.cd_core import DynState, cd_step
    from cam_nor_physics_tpu.models.fv.dyn_comp import dyn_run
    from cam_nor_physics_tpu.models.fv.grid import make_grid
    from cam_nor_physics_tpu.models.fv.vertical import hybrid_coefficients
    jax.config.update("jax_disable_most_optimizations", True)
    im, jm, km = cases["shape"]
    grid, coord = make_grid(im, jm, km), hybrid_coefficients(km)
    state = DynState(**{f: jnp.asarray(cases["state"][f]) for f in DYN})
    phis = jnp.asarray(cases["phis"])
    out = {}
    for name, kw in cases["configs"].items():
        kw = dict(kw)
        filter_impl = kw.pop("filter_impl", "matmul")
        cfg = FVConfig(use_pallas=False, **kw)
        new, diags = jax.jit(lambda s, p: dyn_run(
            s, grid, coord, p, cfg, cases["dt"], filter_impl=filter_impl,
            return_diags=True))(state, phis)
        out[name] = {**{f: np.asarray(getattr(new, f)) for f in DYN},
                     **{f"diag.{k}": np.asarray(v) for k, v in diags.items()}}
    dbg = cases["debug"]
    if dbg is None:
        return out
    new, diags = jax.jit(lambda s, p: cd_step(
        s, grid, coord.ptop, p, dbg["dt"], filter_impl=dbg["filter_impl"],
        c_sw_pgf=True, use_pallas=False, return_debug=True))(state, phis)
    out["debug"] = {**{f: np.asarray(getattr(new, f)) for f in DYN},
                    **{f"debug.{k}": np.asarray(v)
                       for k, v in diags.pop("debug").items()},
                    **{f"diag.{k}": np.asarray(v) for k, v in diags.items()}}
    return out


def run_scam(cases, parts=("run", "iop", "step")):
    from cam_nor_physics_tpu.models.coupling.camsrfexch import CamIn
    from cam_nor_physics_tpu.models.physics.constituents import \
        default_registry
    from cam_nor_physics_tpu.models.physics.state import PhysicsState
    from cam_nor_physics_tpu.models.scam import (IopData, ScamForcing,
                                                 scam_init_pbuf, scam_run,
                                                 scam_run_iop, scam_step)
    reg = default_registry()
    state = PhysicsState(**{k: jnp.asarray(v)
                            for k, v in cases["state"].items()})
    cam_in = CamIn(**{k: jnp.asarray(v) for k, v in cases["cam_in"].items()})
    forcing = ScamForcing(**{k: jnp.asarray(v)
                             for k, v in cases["forcing"].items()})
    iop = IopData(**{k: jnp.asarray(v) for k, v in cases["iop"].items()})
    dt, n = cases["dt"], cases["nsteps"]
    out = {}

    def flat(st, pbuf, series):
        res = {f"state.{k}": np.asarray(getattr(st, k))
               for k in cases["state"]}
        res.update({f"pbuf.{k}": np.asarray(v)
                    for k, v in pbuf.fields.items()})
        res.update({f"series.{k}": np.asarray(v) for k, v in series.items()})
        return res

    with jax.disable_jit():
        if "run" in parts:
            out["run"] = flat(*scam_run(PhysConfig(), ZMConfig(), reg,
                                        state, cam_in, forcing, dt, n))
        if "iop" in parts:
            out["iop"] = flat(*scam_run_iop(PhysConfig(), ZMConfig(), reg,
                                            state, cam_in, iop, dt, n))
        if "step" not in parts:
            return out
        pbuf = scam_init_pbuf(state.ncol, state.pver)
        st, pb, cam_out, diags = scam_step(PhysConfig(), ZMConfig(), reg,
                                           state, pbuf, cam_in, forcing, dt)
        res = flat(st, pb, {})
        res.update({f"cam_out.{k}": np.asarray(getattr(cam_out, k))
                    for k in cam_out.__dataclass_fields__})
        res.update({f"diag.{k}": np.asarray(v) for k, v in diags.items()})
        out["step"] = res
    return out


def run_cd_fused(cases):
    from test_torch_cd_fused import FLAG_SETS, _jax_fused
    state, diag = _jax_fused(cases["fields"], FLAG_SETS[cases["flags"]])
    return dict(state, **diag)


def main(root):
    with open(os.path.join(root, "in.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"dyn": run_dyn, "scam": run_scam,
           "cd_fused": run_cd_fused}[inp["mode"]](inp["cases"])
    with open(os.path.join(root, "out.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
