"""The cases of the port's multi-process tests, for the ranks
(tests/torch_port_parallel_worker.py: each rank's strip), for the test
process (the port's single-rank runs) and, as numpy inputs, for the JAX
package's single-device runs (tests/torch_port_parallel_ref.py). No JAX.
"""

import numpy as np
import torch

from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.models.atm_comp import (AtmModel, atm_init,
                                                       atm_step)
from cam_nor_physics_tpu_torch.models.coupling.camsrfexch import CamIn
from cam_nor_physics_tpu_torch.models.fv.dyn_comp import dyn_run
from cam_nor_physics_tpu_torch.models.fv.grid import make_grid
from cam_nor_physics_tpu_torch.models.fv.held_suarez import (hs_forcing,
                                                            hs_initial_state)
from cam_nor_physics_tpu_torch.models.fv.vertical import hybrid_coefficients
from cam_nor_physics_tpu_torch.ops import stencil_kernels as sk
from cam_nor_physics_tpu_torch.ops import tp_core as tp
from cam_nor_physics_tpu_torch.parallel import distributed as pdist
from cam_nor_physics_tpu_torch.parallel import mesh as pmesh
from cam_nor_physics_tpu_torch.parallel import shard_stencil as ss
from cam_nor_physics_tpu_torch.utils.config import FVConfig

STENCIL_SHAPE = (48, 64, 4)          # im, jm, km
DYN_SHAPE = (48, 64, 4)
HS_SHAPE = (32, 24, 4)
COUPLED_SHAPE = (32, 24, 4)          # 6 rows a rank of 4: whole slab
COUPLED_STRIP_SHAPE = (32, 32, 4)    # 8 rows a rank of 4: strips
TWO_RANK_SHAPE = (24, 16, 4)
ORDERS = (4, 4)
DT = 1800.0
SPLITS = dict(nsplit=2, nspltrac=1)
NSTEPS = 2                           # HS and coupled steps
FIELDS = ("u", "v", "pt", "delp", "q")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def stencil_inputs():
    """The three stencils' whole operands at STENCIL_SHAPE, float64
    (tests/test_parallel.py:128-158's, with FFSL rows at the poles)."""
    im, jm, km = STENCIL_SHAPE
    g = make_grid(im, jm, km, device="cpu")
    rng = np.random.default_rng(3)
    delp = _t(1e3 + 50 * rng.standard_normal((km, jm, im)))
    pt = _t(300 + 30 * rng.standard_normal((km, jm, im)))
    crx = 0.6 * rng.standard_normal((km, jm, im))
    crx[:, :3] *= 3.0
    crx[:, -3:] *= 3.0
    crx = _t(crx)
    cry = tp.wset_row(_t(0.4 * rng.standard_normal((km, jm, im))), 0, 0.0)
    yfx = (cry * g.cose[:, None]).contiguous()
    va = (0.5 * (cry + tp.edge_north(cry))).contiguous()
    ffsl = torch.amax(torch.abs(crx), -1) > 1.0
    zeta = _t(1e-4 * rng.standard_normal((km, jm, im)))
    q = _t(rng.uniform(0.0, 1e-2, (2, km, jm, im)))
    udt, vdt = (450.0 * crx).contiguous(), (450.0 * cry).contiguous()
    return dict(
        transport3d=[delp, pt, crx, cry, yfx, va, ffsl, g.cosp, g.acosp,
                     g.rcap, *ORDERS],
        vort_flux3d=[zeta, crx, cry, udt, vdt, ffsl, g.cosp, *ORDERS],
        tracer_div3d=[q, crx, cry, udt, yfx, va, ffsl, g.cosp, g.acosp,
                      g.rcap, *ORDERS])


def stencil_jax_cases():
    """stencil_inputs as numpy arrays and Python scalars."""
    return {name: [a.numpy() if isinstance(a, torch.Tensor) else a
                   for a in args]
            for name, args in stencil_inputs().items()}


def outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


def stencil_whole():
    """{name: outputs} of the whole-slab stencils (no band)."""
    return {name: outputs(getattr(sk, name)(*args))
            for name, args in stencil_inputs().items()}


def stencil_strips(mesh):
    """{name: outputs} of the sharded stencils on the rank's strip."""
    out = {}
    for name, args in stencil_inputs().items():
        strip = [mesh.take_rows(a, ss.row_axis(a))
                 if isinstance(a, torch.Tensor) else a for a in args]
        out[name] = outputs(getattr(ss, f"sharded_{name}")(mesh, *strip))
    return out


def _dyn_setup(im, jm, km):
    grid = make_grid(im, jm, km, device="cpu")
    coord = hybrid_coefficients(km, device="cpu")
    st = hs_initial_state(grid, coord, pert=1.0)
    rng = np.random.default_rng(4)
    st = st.replace(q=_t(1e-3 * (1.0 + 0.5 * rng.uniform(
        size=tuple(st.q.shape)))))
    return grid, coord, st, torch.zeros((jm, im), dtype=torch.float64)


def _fields(st):
    return {f: getattr(st, f) for f in FIELDS}


def dyn_whole(shape, filter_impl="matmul"):
    """One dyn_run large step (FVConfig(nsplit=2, nspltrac=1), as
    tests/test_parallel.py:160-184) without a mesh."""
    grid, coord, st, phis = _dyn_setup(*shape)
    new, diags = dyn_run(st, grid, coord, phis, FVConfig(**SPLITS), DT,
                         filter_impl=filter_impl, return_diags=True)
    return dict(_fields(new), omega=diags["omega"])


def dyn_strip(mesh, shape, filter_impl="matmul"):
    """dyn_run(mesh=) on the rank's strip of dyn_whole's state."""
    grid, coord, st, phis = _dyn_setup(*shape)
    new, diags = dyn_run(pmesh.shard_state(st, mesh), grid, coord,
                         mesh.take_rows(phis), FVConfig(**SPLITS), DT,
                         filter_impl=filter_impl, mesh=mesh,
                         return_diags=True)
    new = pmesh.constrain(new, mesh)
    return dict(_fields(new), omega=diags["omega"])


def dyn_jax_cases(shape, filter_impls=("matmul",)):
    """dyn_whole's inputs for tests/torch_port_modes_ref.py's run_dyn, one
    option set per filter."""
    _, _, st, phis = _dyn_setup(*shape)
    return dict(shape=shape, dt=DT, phis=phis.numpy(),
                state=convert.dynstate_to_numpy(st), debug=None,
                configs={f: dict(SPLITS, filter_impl=f)
                         for f in filter_impls})


def _hs_step(st, grid, coord, phis, mesh=None):
    cfg = FVConfig(**SPLITS)
    if mesh is None:
        st = dyn_run(st, grid, coord, phis, cfg, DT, filter_impl="matmul")
        return hs_forcing(st, grid, coord.ptop, DT)
    st = dyn_run(st, grid, coord, phis, cfg, DT, filter_impl="matmul",
                 mesh=mesh)
    # hs_forcing averages the friction of rows j-1 and j: on the whole
    # state, as JAX's runs on the global array
    whole = hs_forcing(pmesh.gather_state(st, mesh), grid, coord.ptop, DT)
    return pmesh.shard_state(whole, mesh)


def hs_steps_whole():
    """NSTEPS HS steps (dyn_run + hs_forcing) at HS_SHAPE without a mesh
    (tests/test_parallel.py:48-58)."""
    grid, coord, st, phis = _dyn_setup(*HS_SHAPE)
    for _ in range(NSTEPS):
        st = _hs_step(st, grid, coord, phis)
    return _fields(st)


def hs_steps_strip(mesh):
    grid, coord, st, phis = _dyn_setup(*HS_SHAPE)
    st = pmesh.shard_state(st, mesh)
    phis = mesh.take_rows(phis)
    for _ in range(NSTEPS):
        st = _hs_step(st, grid, coord, phis, mesh)
    return _fields(st)


def hs_jax_cases():
    _, _, st, phis = _dyn_setup(*HS_SHAPE)
    return dict(shape=HS_SHAPE, dt=DT, phis=phis.numpy(), config=SPLITS,
                state=convert.dynstate_to_numpy(st), nsteps=NSTEPS)


def _coupled_setup(shape):
    im, jm, km = shape
    model = AtmModel.create(im, jm, km, dt=DT, fv_cfg=FVConfig(**SPLITS),
                            filter_impl="matmul", device="cpu")
    dyn0 = hs_initial_state(model.grid, model.coord, pert=0.0,
                            nq=model.registry.pcnst)
    q = torch.full_like(dyn0.q, 1e-4)
    q[0] = 3e-3 * (dyn0.delp / dyn0.delp.max())
    state = atm_init(model, dyn0.replace(q=q),
                     torch.zeros((jm, im), dtype=torch.float64))
    ncol = jm * im
    cam_in = CamIn.zeros(ncol, model.registry.pcnst)
    cam_in = cam_in.replace(shf=torch.full((ncol,), 10.0, dtype=torch.float64),
                            landfrac=torch.full((ncol,), 0.3,
                                                dtype=torch.float64))
    return model, state, cam_in


def _coupled_out(state, diags):
    return dict(_fields(state.dyn), **{"phys.t": state.phys.t,
                                       "TEGMEAN": diags["TEGMEAN"]})


def coupled_whole(shape=COUPLED_SHAPE):
    """The coupled atm_step (tests/test_parallel.py:66-117), the first
    step and one more (the energy fixer's sums)."""
    model, state, cam_in = _coupled_setup(shape)
    out = {}
    for n in range(NSTEPS):
        state, _, diags = atm_step(model, state, cam_in, first_step=n == 0)
        out.update({f"{k}.{n}": v for k, v in
                    _coupled_out(state, diags).items()})
    return out


def coupled_strip(mesh, shape=COUPLED_SHAPE):
    model, state, cam_in = _coupled_setup(shape)
    im, jm = model.grid.im, model.grid.jm
    state = pmesh.shard_state(state, mesh)
    cam_in = pmesh.shard_state(cam_in, mesh, jm, im)
    out = {}
    for n in range(NSTEPS):
        state, _, diags = atm_step(model, state, cam_in, first_step=n == 0,
                                   mesh=mesh)
        out.update({f"{k}.{n}": v for k, v in
                    _coupled_out(state, diags).items()})
    return out


def coupled_jax_cases(shape):
    _, state, cam_in = _coupled_setup(shape)
    return dict(shape=shape, dt=DT, config=SPLITS, nsteps=NSTEPS,
                state=convert.atmstate_to_numpy(state),
                cam_in=convert.camin_to_numpy(cam_in))


HOST_LOCAL = (3, 16, 12)


def host_local_full():
    km, jm, im = HOST_LOCAL
    return np.arange(km * jm * im, dtype=np.float32).reshape(km, jm, im)


def host_local(mesh):
    """host_local_state: each rank builds only its rows of
    host_local_full's array (tests/test_distributed.py:88-)."""
    km, jm, im = HOST_LOCAL

    def make_local(pidx, pcount):
        rows = jm // pcount
        lo = pidx * rows
        block = host_local_full()
        return {"delp": block[:, lo:lo + rows, :].copy()}

    out = pdist.host_local_state(mesh, make_local,
                                 lambda leaf, p, n: (km, jm, im))
    return {"strip": out["delp"],
            "whole": mesh.gather_rows(out["delp"])}


def strip_of(whole, rank, ny, axis=-2):
    """Rank `rank`'s rows of a whole numpy array (x unsharded)."""
    n = whole.shape[axis] // ny
    return np.take(whole, range(rank * n, (rank + 1) * n), axis=axis)

