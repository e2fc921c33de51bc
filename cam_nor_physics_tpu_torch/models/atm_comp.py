"""Top-level atmosphere component (cam_comp): the coupled step.

Twin of `cam_nor_physics_tpu.models.atm_comp`. Per time step the
reference's driver runs

    phys_run1 -> surface coupler -> phys_run2 -> p_d_coupling -> dyn_run
    -> d_p_coupling

`atm_step` is that sequence over the coupled state (dycore state,
physics export, physics buffer); the surface coupler is an input, the
CamIn of each step. On CUDA tensors it launches the port's kernels: the
fused cd_step K1-K4 in every small step, tracer_div3d in trac2d,
te_map_remap in te_map and zm_tail in zm_conv_tend. The step reads no
device value on the host, so a CUDA graph can capture it: the step
counter `nstep` is a device tensor, and `first_step` is a Python flag.

On a mesh (`atm_step(..., mesh=)`, parallel/mesh.py) the state is the
rank's strip state: the physics runs on the rank's own columns with its
global sums all-reduced; the physics export and the dycore's winds are
gathered whole for p_d_coupling, the dycore advances every rank's whole
state (its stencils on latitude strips where they apply), and the rank
keeps its rows and columns after d_p_coupling.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..parallel import shard_stencil as ss
from ..parallel.mesh import shard_state, take_cols
from ..utils.config import FVConfig, PhysConfig, ZMConfig
from ..utils.device import resolve_device
from ..utils.timing import span
from .coupling.camsrfexch import CamIn, CamOut
from .coupling.dp_coupling import (d_p_coupling, d_p_coupling_diags,
                                   p_d_coupling)
from .fv.cd_core import DynState
from .fv.dyn_comp import dyn_run_whole
from .fv.grid import FVGrid, make_grid
from .fv.vertical import HybridCoord, hybrid_coefficients
from .physics.cam_diagnostics import (constituent_burdens, diag_conv_tidal,
                                      diag_phys_tend_writeout, tidal_coeffs)
from .physics.constituents import ConstituentRegistry, default_registry
from .physics.physics_buffer import PhysicsBuffer, pbuf_register
from .physics.physpkg import (PhysRunOut, phys_run1, phys_run2,
                              physpkg_pbuf_specs)
from .physics.state import PhysicsState


@dataclass(frozen=True)
class AtmModel:
    """Model description (grids, configurations, registry): the
    dyn_init/phys_init role. The grid's and coordinate's tensors set the
    model's dtype and device."""

    grid: FVGrid
    coord: HybridCoord
    registry: ConstituentRegistry
    fv_cfg: FVConfig
    phys_cfg: PhysConfig
    zm_cfg: ZMConfig
    dt: float                      # coupling (large) time step (s)
    # polar filter of the small step: "fft" (the fused K1-K4) or
    # "matmul" (the unfused step)
    filter_impl: str = "fft"

    @classmethod
    def create(cls, im: int, jm: int, km: int, dt: float = 1800.0,
               registry: ConstituentRegistry | None = None,
               fv_cfg: FVConfig | None = None,
               phys_cfg: PhysConfig | None = None,
               zm_cfg: ZMConfig | None = None,
               filter_impl: str = "fft", dtype=torch.float64,
               device="cuda") -> "AtmModel":
        """The model at im x jm x km in `dtype` on `device` (a CUDA device
        by default; raises where there is none)."""
        dev = resolve_device(device)
        return cls(grid=make_grid(im, jm, km, dtype=dtype, device=dev),
                   coord=hybrid_coefficients(km, dtype=dtype, device=dev),
                   registry=registry or default_registry(),
                   fv_cfg=fv_cfg or FVConfig(),
                   phys_cfg=phys_cfg or PhysConfig(),
                   zm_cfg=zm_cfg or ZMConfig(), dt=dt,
                   filter_impl=filter_impl)


@dataclass
class AtmState:
    """Coupled prognostic and persistent state: the dycore state, the
    physics export of the current step, the physics buffer, the surface
    geopotential and the step counter (a 0-d int32 tensor)."""

    dyn: DynState
    phys: PhysicsState
    pbuf: PhysicsBuffer
    phis: torch.Tensor            # (jm, im) surface geopotential
    nstep: torch.Tensor

    def replace(self, **kw) -> "AtmState":
        return replace(self, **kw)


def atm_init(model: AtmModel, dyn_state: DynState, phis) -> AtmState:
    """The coupled state from a dycore initial state (dyn_init and the
    first d_p_coupling; read_inidat's analytic-IC role,
    dyn_comp.F90:2889-3081)."""
    ncol = model.grid.jm * model.grid.im
    dtype, dev = dyn_state.delp.dtype, dyn_state.delp.device
    pbuf = pbuf_register(
        physpkg_pbuf_specs(ncol, model.grid.km, pcnst=model.registry.pcnst),
        dtype, dev)
    pbuf = pbuf.update(
        CLD=torch.full((ncol, model.grid.km), 0.1, dtype=dtype, device=dev),
        PBLH=torch.full((ncol,), 500.0, dtype=dtype, device=dev))
    phys = d_p_coupling(dyn_state, model.grid, phis, model.coord.ptop,
                        model.registry)
    return AtmState(dyn=dyn_state, phys=phys, pbuf=pbuf, phis=phis,
                    nstep=torch.zeros((), dtype=torch.int32, device=dev))


def _gather_export(pstate: PhysicsState, mesh):
    """The fields of the physics export p_d_coupling reads (t, u, v,
    pdel, q), gathered over every rank's columns in one all-gather."""
    n, km = pstate.t.shape
    packed = torch.cat([pstate.t, pstate.u, pstate.v, pstate.pdel,
                        pstate.q.reshape(n, -1)], 1)
    t, u, v, pdel, q = mesh.gather_rows(packed, 0).split(
        [km, km, km, km, pstate.q[0].numel()], 1)
    return pstate.replace(t=t, u=u, v=v, pdel=pdel,
                          q=q.reshape(-1, km, pstate.q.shape[-1]))


def atm_step(model: AtmModel, state: AtmState, cam_in: CamIn,
             first_step: bool = False,
             mesh=None) -> tuple[AtmState, CamOut, dict]:
    """One coupled time step (the cam_comp run sequence). `first_step`
    leaves out the energy fixer (no TEOUT yet), the reference's nstep == 0
    branch (physpkg.F90:2899). Returns the new state, the surface export
    and the merged diagnostics.

    `mesh` (a parallel.mesh.Mesh; anything else raises TypeError): `state`
    and `cam_in` are the rank's strip (parallel.mesh.shard_state), and so
    are the returned state, export and column diagnostics; the global
    sums and the dycore's TEM and AM diagnostics are whole."""
    ss.check_mesh(mesh)
    g, coord, reg = model.grid, model.coord, model.registry

    # pre-coupler physics on the current export
    o1: PhysRunOut = phys_run1(model.phys_cfg, model.zm_cfg, reg,
                               state.phys, state.pbuf, cam_in, model.dt,
                               nstep=0 if first_step else 1, mesh=mesh)
    # (the surface coupler runs here in the host model; cam_in is its
    # product)
    o2: PhysRunOut = phys_run2(model.phys_cfg, reg, o1.state, o1.pbuf,
                               cam_in, model.dt)

    # physics -> dycore, the large dynamics step, dycore -> physics; the
    # dycore's kernels take contiguous tensors, and p_d_coupling gives
    # them
    dyn, export, phis = state.dyn, o2.state, state.phis
    if mesh is not None:
        dyn = dyn.replace(u=mesh.gather_rows(dyn.u),
                          v=mesh.gather_rows(dyn.v))
        export = _gather_export(export, mesh)
        phis = mesh.gather_rows(phis)
    dyn = p_d_coupling(dyn, export, g, coord.ptop, model.dt, reg)
    dyn, dyn_diags = dyn_run_whole(dyn, g, coord, phis, model.fv_cfg,
                                   model.dt, model.filter_impl, None, mesh,
                                   True)
    phys = d_p_coupling(dyn, g, phis, coord.ptop, reg,
                        omega=dyn_diags["omega"])
    # the diagnostic side of d_p_coupling (dp_coupling.F90:274-320): the
    # gravity-wave frontogenesis sources and the QBO zonal mean into the
    # pbuf, the TEM diagnostics and the dycore's AM payload into the
    # diagnostics
    pc = model.phys_cfg
    cdiag = d_p_coupling_diags(
        dyn, g, coord.ptop, omega=dyn_diags["omega"],
        use_gw_front=pc.use_gw_front, qbo_use_forcing=pc.qbo_use_forcing,
        do_circulation_diags=pc.do_circulation_diags)
    if mesh is not None:
        phys = shard_state(phys, mesh, g.jm, g.im)
        cdiag = {k: v if k == "ctem" else take_cols(v, mesh, g.jm, g.im)
                 for k, v in cdiag.items()}
        dyn = shard_state(dyn, mesh)

    with span("atm_diagnostics"):
        diags = dict(o1.diagnostics)
        diags.update(o2.diagnostics)

        # before/after-physics snapshots and the total physics tendencies
        # (cam_diagnostics.F90:246-298, 2696), the column burdens
        diags.update(diag_phys_tend_writeout(state.phys, o2.state, model.dt,
                                             cnst_names=reg.names))
        diags.update(constituent_burdens(o2.state, reg.names))

        # migrating-tide products (cam_diagnostics.F90:2156-2161): DTCOND
        # times the local-solar-time harmonics of this step
        if "DTCOND" in diags:
            dtype = diags["DTCOND"].dtype
            time_days = (state.nstep.to(dtype) + 1.0) * (model.dt / 86400.0)
            diags.update(diag_conv_tidal(diags["DTCOND"],
                                         tidal_coeffs(g.lons.to(dtype),
                                                      time_days)))
        ctem = cdiag.pop("ctem", None)
        if ctem is not None:
            diags.update(ctem)
        if model.fv_cfg.am_diag:
            diags.update({k: v for k, v in dyn_diags.items()
                          if k.startswith("AM_")})
    pbuf = o2.pbuf.update(**cdiag) if cdiag else o2.pbuf

    new = AtmState(dyn=dyn, phys=phys, pbuf=pbuf, phis=state.phis,
                   nstep=state.nstep + 1)
    return new, o2.cam_out, diags
