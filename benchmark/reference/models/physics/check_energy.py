"""Column energy and water bookkeeping (upstream `check_energy`).

Twin of `cam_nor_physics_tpu.models.physics.check_energy`. The reference
wraps every parameterization with check_energy_chng and runs a global
check_energy_gmean each step (physpkg.F90:1115, 2726-2781, 2867). Total
energy in the constant-cp, moist-pressure-coordinate enthalpy form:

    te = sum_k pdel/g [cp T + (u^2+v^2)/2 + (Lv+Li) qv + Li ql]
         + phis (ps - ptop)/g
    tw = sum_k pdel/g [qv + ql + qi]

Residuals are returned, never acted on. The global sums of
check_energy_fix and check_energy_gmean reduce over every column in the
state's dtype, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...utils import constants as c
from .constituents import ConstituentRegistry
from .state import PhysicsState


@dataclass
class EnergyDiag:
    """Residuals of one check_energy_chng call (per column)."""

    te: torch.Tensor          # new total energy
    tw: torch.Tensor          # new total water
    te_err: torch.Tensor      # te - (te_cur + dt * expected flux)
    tw_err: torch.Tensor


def column_energy(state: PhysicsState, registry: ConstituentRegistry):
    """(te, tw) vertical integrals per column."""
    w = state.pdel / c.GRAVIT
    ke = 0.5 * (state.u ** 2 + state.v ** 2)
    qv = state.q[:, :, 0]
    ixliq = registry.index("CLDLIQ")
    ixice = registry.index("CLDICE")
    ql = state.q[:, :, ixliq] if ixliq > 0 else torch.zeros_like(qv)
    qi = state.q[:, :, ixice] if ixice > 0 else torch.zeros_like(qv)
    te = (torch.sum(w * (c.CPAIR * state.t + ke + (c.LATVAP + c.LATICE) * qv
                         + c.LATICE * ql), -1)
          + state.phis * (state.pint[:, -1] - state.pint[:, 0]) / c.GRAVIT)
    tw = torch.sum(w * (qv + ql + qi), -1)
    return te, tw


def check_energy_timestep_init(state: PhysicsState,
                               registry: ConstituentRegistry
                               ) -> PhysicsState:
    """te_ini/te_cur and tw_ini/tw_cur at the start of the physics step
    (check_energy_timestep_init, called from d_p_coupling,
    dp_coupling.F90:655)."""
    te, tw = column_energy(state, registry)
    return state.replace(te_ini=te, te_cur=te, tw_ini=tw, tw_cur=tw)


def check_energy_chng(state: PhysicsState, registry: ConstituentRegistry,
                      dt: float, flx_vap=None, flx_cnd=None, flx_ice=None,
                      flx_sen=None) -> tuple[PhysicsState, EnergyDiag]:
    """The energy and water change against the boundary fluxes, and
    te_cur/tw_cur updated (check_energy_chng). flx_vap: vapour flux in
    (kg/m2/s); flx_cnd: total condensate flux out (m/s of liquid water,
    snow included); flx_ice: its frozen part; flx_sen: sensible heat in
    (W/m2)."""
    zero = torch.zeros((state.ncol,), dtype=state.t.dtype,
                       device=state.t.device)
    flx_vap = zero if flx_vap is None else flx_vap
    flx_cnd = zero if flx_cnd is None else flx_cnd
    flx_ice = zero if flx_ice is None else flx_ice
    flx_sen = zero if flx_sen is None else flx_sen

    te, tw = column_energy(state, registry)
    te_xpd = state.te_cur + dt * (
        flx_sen
        + (c.LATVAP + c.LATICE) * flx_vap
        - (c.LATICE * c.RHOH2O) * (flx_cnd - flx_ice))
    tw_xpd = state.tw_cur + dt * (flx_vap - c.RHOH2O * flx_cnd)
    diag = EnergyDiag(te=te, tw=tw, te_err=te - te_xpd, tw_err=tw - tw_xpd)
    return state.replace(te_cur=te, tw_cur=tw), diag


def check_energy_fix(state: PhysicsState, registry: ConstituentRegistry,
                     teout_prev):
    """Global energy fixer (check_energy_fix, physpkg.F90:2726-2781): the
    uniform heating per unit mass (J/kg, (ncol, pver); the caller divides
    by dt) whose global integral is the cos(lat)-weighted global-mean
    difference between the energy exported at the end of the previous
    physics step (teout_prev) and the current energy."""
    te, _ = column_energy(state, registry)
    w = torch.clamp(torch.cos(state.lat), min=0.0)
    wsum = torch.clamp(torch.sum(w), min=1e-30)
    deficit_glob = torch.sum(w * (teout_prev - te)) / wsum
    mass_glob = torch.sum(w * (state.pint[:, -1] - state.pint[:, 0])) / \
        (wsum * c.GRAVIT)                                          # kg/m2
    heat = deficit_glob / torch.clamp(mass_glob, min=1e-30)        # J/kg
    return heat.expand(state.t.shape)


def check_energy_gmean(state: PhysicsState, registry: ConstituentRegistry):
    """Area-weighted global-mean total energy (check_energy_gmean role,
    physpkg.F90:1115), cos(lat) weights."""
    te, _ = column_energy(state, registry)
    w = torch.clamp(torch.cos(state.lat), min=0.0)
    return torch.sum(w * te) / torch.clamp(torch.sum(w), min=1e-30)
