"""Every transport order of the port's dycore against the JAX package's
dyn_run, float64 on the CPU at 24x16x4.

FVConfig(iord=o, jord=o) for o in 2, 3, 5, 6, 7 and -2, and the mixed
pairs (3, 5) and (6, 2), through both small steps: filter_impl="fft", the
fused K1-K4 (K3's transport and K4's vorticity fluxes at the orders; on
CPU tensors their plain versions), and "matmul", the unfused step
(transport3d, vort_flux3d), with trac2d's tracer_div3d at the orders in
both. JAX's dyn_run runs its unfused step with the same filter
(FVConfig(use_pallas=False)), the sixteen programs in JOBS fresh
interpreters (tests/torch_port_modes_ref.py "dyn"; tracing and compiling
one takes ~9 s) started at once while the port runs.
Every field within 1e-9 of its max: the fused step carries the pressure
sum where JAX's unfused step takes a cumsum, which the pressure-gradient
cancellation amplifies (tests/test_torch_cd_fused.py); measured errors
are printed (pytest -s). The state is the perturbed JW06 wave with
vapour and three seeded species over the JW topography, so every order
sees winds, gradients and FFSL-free rows alike.
"""

import numpy as np
import torch

from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.models.fv import dyn_comp as tdc
from cam_nor_physics_tpu_torch.models.fv import grid as tgrid
from cam_nor_physics_tpu_torch.models.fv import vertical as tvert
from cam_nor_physics_tpu_torch.models.fv.baroclinic_wave import \
    jw_baroclinic_wave
from cam_nor_physics_tpu_torch.utils.config import FVConfig
from torch_port_util import (assert_close, npy, reference_processes,
                             t64)

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

IM, JM, KM = 24, 16, 4
DT = 1800.0
TOL = 1e-9
ORDERS = [(2, 2), (3, 3), (5, 5), (6, 6), (7, 7), (-2, -2), (3, 5), (6, 2)]
PATHS = ("fft", "matmul")
FIELDS = ("u", "v", "pt", "delp", "q")
JOBS = 4


def _grids():
    return (tgrid.make_grid(IM, JM, KM, device="cpu"),
            tvert.hybrid_coefficients(KM, device="cpu"))


def _cases():
    grid, coord = _grids()
    st, phis = jw_baroclinic_wave(grid, coord, perturb=True, nq=4,
                                  device="cpu")
    q = npy(st.q).copy()
    q[0] = 1e-3
    q[1:] = np.random.default_rng(5).uniform(0.0, 0.2, q[1:].shape)
    configs = {f"{path} {i} {j}": dict(nsplit=2, nspltrac=1, iord=i, jord=j,
                                       filter_impl=path)
               for path in PATHS for i, j in ORDERS}
    return dict(shape=(IM, JM, KM), dt=DT, phis=npy(phis), configs=configs,
                state=convert.dynstate_to_numpy(st.replace(q=t64(q))),
                debug=None)


def _port(cases):
    grid, coord = _grids()
    state = convert.dynstate_from_numpy(cases["state"], "cpu")
    phis = t64(cases["phis"])
    out = {}
    for name, kw in cases["configs"].items():
        kw = dict(kw)
        path = kw.pop("filter_impl")
        new = tdc.dyn_run(state, grid, coord, phis, FVConfig(**kw),
                          cases["dt"], filter_impl=path)
        out[name] = convert.dynstate_to_numpy(new)
    return out


def test_dyn_run_at_every_order_matches_jax(tmp_path):
    cases = _cases()
    names = list(cases["configs"])
    jobs = [("dyn", dict(cases, configs={k: cases["configs"][k]
                                         for k in names[i::JOBS]}))
            for i in range(JOBS)]
    got, outs = reference_processes(tmp_path, "torch_port_modes_ref.py",
                                    jobs, _port, cases)
    want = {k: v for out in outs for k, v in out.items()}
    assert set(got) == set(want) == set(cases["configs"])
    base = cases["state"]
    for name in cases["configs"]:
        rel = {}
        for f in FIELDS:
            g, w = got[name][f], want[name][f]
            assert np.isfinite(g).all(), (name, f)
            assert_close(g, w, TOL, f"{name} {f}")
            rel[f] = np.abs(g - w).max() / np.abs(w).max()
        # the step moved the state
        assert not np.array_equal(got[name]["pt"], base["pt"]), name
        print(name, {f: f"{e:.1e}" for f, e in rel.items()})
    # the orders change the answer
    for path in PATHS:
        assert not np.array_equal(got[f"{path} 3 3"]["q"],
                                  got[f"{path} 6 6"]["q"])
