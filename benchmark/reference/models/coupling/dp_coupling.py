"""Dynamics <-> physics coupling: d_p_coupling and p_d_coupling.

Twin of `cam_nor_physics_tpu.models.coupling.dp_coupling` (reference
dp_coupling.F90). Physics works on the dycore's own layout with columns
flattened to a batch axis, ncol = j*im + i; `_to_cols` and `_from_cols`
map (..., km, jm, im) to (ncol, km) and back, and both return contiguous
tensors, so the physics state and the dycore state that come out of the
coupling are contiguous (the kernels of the dycore and the ZM tail take
contiguous tensors only).

d_p_coupling (dp_coupling.F90:71-671): D-grid winds to the A grid,
t = pt pkz / (1 + zvir q), the derived pressure fields, the bottom-layer
negative-tracer borrow, geopotential and dry static energy, the dry
pressure set with the wet-to-dry conversion, qneg3 and
check_energy_timestep_init.

p_d_coupling (dp_coupling.F90:679-958): T to pt, the A-grid wind
increments to D-grid staggered updates (uv3s_update), the pressure
fields re-derived from the new delp.
"""

from __future__ import annotations

import torch

from ...ops.fill import qneg3
from ...ops.geopotential import geopotential_t
from ...ops.tp_core import _rollx, _rolly, wset_row
from ...utils import constants as c
from ..fv.cd_core import DynState, d2a_winds, pressure_vars
from ..fv.ctem import ctem_diags
from ..fv.grid import FVGrid
from ..physics.check_energy import check_energy_timestep_init
from ..physics.constituents import ConstituentRegistry
from ..physics.state import (PhysicsState, qmin_vector, set_state_pdry,
                             set_wet_to_dry)


def _to_cols(a):
    """(..., km, jm, im) -> (..., jm*im, km); (jm, im) -> (jm*im,)."""
    if a.ndim == 2:
        return a.reshape(-1).contiguous()
    return a.reshape(a.shape[:-2] + (-1,)).movedim(-2, -1).contiguous()


def _from_cols(a, jm: int, im: int):
    """(..., ncol, km) -> (..., km, jm, im); (ncol,) -> (jm, im)."""
    if a.ndim == 1:
        return a.reshape(jm, im).contiguous()
    return a.movedim(-1, -2).reshape(
        a.shape[:-2] + (a.shape[-1], jm, im)).contiguous()


def d_p_coupling(state: DynState, grid: FVGrid, phis, ptop: float,
                 registry: ConstituentRegistry, omega=None) -> PhysicsState:
    """Dycore export -> physics state (d_p_coupling, dp_coupling.F90:
    71-671), ncol = jm*im columns, row-major."""
    jm, im = grid.jm, grid.im
    pe, pk, pkz, peln = pressure_vars(state.delp, ptop)
    ua, va = d2a_winds(state.u, state.v)

    # temperature from the scaled virtual potential temperature
    qv = state.q[0]
    t3 = state.pt * pkz / (1.0 + c.ZVIR * qv)

    # derived pressure fields; pmid is the FV log-mean (pdel / dln p)
    pdel = state.delp
    pmid = pdel / (peln[1:] - peln[:-1])

    ps = _to_cols(pe[-1])
    pint = _to_cols(pe)
    lnpint = _to_cols(peln)
    pmid_c = _to_cols(pmid)
    pdel_c = _to_cols(pdel)
    t_c = _to_cols(t3)
    u_c = _to_cols(ua)
    v_c = _to_cols(va)
    q_c = _to_cols(state.q).movedim(0, -1)               # (ncol, km, nq)
    phis_c = _to_cols(phis)
    omega_c = _to_cols(omega) if omega is not None else torch.zeros_like(t_c)

    # bottom-layer negative-tracer borrow (dp_coupling.F90:561-591): where
    # the surface layer went negative, borrow from the layer above
    qbot = q_c[:, -1, :]
    qnxt = q_c[:, -2, :]
    ratio = (pdel_c[:, -1] / pdel_c[:, -2])[:, None]
    need = qbot < 0.0
    q_c = torch.cat([q_c[:, :-2, :],
                     torch.where(need, qnxt + qbot * ratio, qnxt)[:, None],
                     torch.where(need, 0.0, qbot)[:, None]], 1)

    lnpmid = torch.log(pmid_c)
    rpdel = 1.0 / pdel_c
    zi, zm = geopotential_t(lnpint, lnpmid, pint, pmid_c, pdel_c, rpdel,
                            t_c, q_c[:, :, 0])
    s = t_c * c.CPAIR + c.GRAVIT * zm + phis_c[:, None]

    lats = grid.lats[:, None].expand(jm, im).reshape(-1)
    lons = grid.lons[None, :].expand(jm, im).reshape(-1)

    z1 = torch.zeros_like(ps)
    pstate = PhysicsState(
        ps=ps, phis=phis_c, t=t_c, u=u_c, v=v_c, s=s, omega=omega_c,
        pmid=pmid_c, pdel=pdel_c, rpdel=rpdel, lnpmid=lnpmid,
        pint=pint, lnpint=lnpint, q=q_c, zi=zi, zm=zm,
        psdry=ps, pmiddry=pmid_c, pdeldry=pdel_c, rpdeldry=rpdel,
        lnpmiddry=lnpmid, pintdry=pint, lnpintdry=lnpint,
        te_ini=z1, te_cur=z1, tw_ini=z1, tw_cur=z1, lat=lats, lon=lons)

    pstate = set_state_pdry(pstate)                       # (:634)
    pstate = set_wet_to_dry(pstate, registry)             # (:635)
    # qneg3 repair on every tracer (:642-649)
    q_fixed, _, _ = qneg3(pstate.q, qmin_vector(registry, pstate.q))
    pstate = pstate.replace(q=q_fixed)
    return check_energy_timestep_init(pstate, registry)   # (:655)


def gws_src_fnct(ua, va, t3, pmid, grid: FVGrid):
    """Frontogenesis function and angle for the gravity-wave frontal
    source (gws_src_fnct role, dp_coupling.F90:313-316): the kinematic 2-D
    frontogenesis function on the A grid,
        F = -[(th_x)^2 u_x + th_x th_y (v_x + u_y) + (th_y)^2 v_y],
    with spherical-metric centred derivatives, and the gradient angle
    atan2(th_y, th_x). Pole rows are zero. Inputs (km, jm, im); returns
    (frontgf, frontga)."""
    safe_cosp = torch.where(grid.cosp > 0, grid.cosp, 1.0)[:, None]
    rdx = 1.0 / (2.0 * c.REARTH * safe_cosp * grid.dl)
    rdy = 1.0 / (2.0 * c.REARTH * grid.dp)

    theta = t3 * (1.0e5 / pmid) ** c.CAPPA

    def ddx(a):
        return (_rollx(a, -1) - _rollx(a, 1)) * rdx

    def ddy(a):
        # centred in the interior; pole rows zeroed below
        return (_rolly(a, -1) - _rolly(a, 1)) * rdy

    tx, ty = ddx(theta), ddy(theta)
    ux, uy = ddx(ua), ddy(ua)
    vx, vy = ddx(va), ddy(va)
    frontgf = -(tx * tx * ux + tx * ty * (vx + uy) + ty * ty * vy)
    frontga = torch.atan2(ty, tx + torch.where(tx == 0.0, 1e-30, 0.0))
    for row in (0, -1):
        frontgf = wset_row(frontgf, row, 0.0)
        frontga = wset_row(frontga, row, 0.0)
    return frontgf, frontga


def zonal_mean_3d(a):
    """Zonal mean of a (km, jm, im) field broadcast back over x
    (zonal_mean_3D role, dp_coupling.F90:318-320)."""
    return torch.mean(a, -1, keepdim=True).expand(a.shape)


def d_p_coupling_diags(state: DynState, grid: FVGrid, ptop: float,
                       omega=None, *, use_gw_front: bool = False,
                       qbo_use_forcing: bool = False,
                       do_circulation_diags: bool = False) -> dict:
    """Diagnostic side of d_p_coupling (dp_coupling.F90:274-320): the
    gravity-wave frontogenesis sources FRONTGF/FRONTGA and the QBO
    zonal-mean wind UZM, as (ncol, km) pbuf payloads, and with
    `do_circulation_diags` the TEM diagnostics of fv/ctem, (npl, jm)
    zonal means under "ctem"."""
    out = {}
    if not (use_gw_front or qbo_use_forcing or do_circulation_diags):
        return out
    pe, pk, pkz, peln = pressure_vars(state.delp, ptop)
    ua, va = d2a_winds(state.u, state.v)
    t3 = state.pt * pkz / (1.0 + c.ZVIR * state.q[0])
    pmid = state.delp / (peln[1:] - peln[:-1])
    if use_gw_front:
        fgf, fga = gws_src_fnct(ua, va, t3, pmid, grid)
        out["FRONTGF"] = _to_cols(fgf)
        out["FRONTGA"] = _to_cols(fga)
    if qbo_use_forcing:
        out["UZM"] = _to_cols(zonal_mean_3d(ua))
    if do_circulation_diags:
        om = omega if omega is not None else torch.zeros_like(t3)
        out["ctem"] = ctem_diags(ua, va, om, t3, pmid)
    return out


def p_d_coupling(state: DynState, pstate: PhysicsState, grid: FVGrid,
                 ptop: float, dt: float,
                 registry: ConstituentRegistry) -> DynState:
    """Physics state -> dycore import (p_d_coupling, dp_coupling.F90:
    679-958): the physics-updated T and q, and the A-grid wind increments
    (pstate.u/v against the exported A winds) as D-grid staggered updates
    (uv3s_update, two-row averages). Every field of the result is
    contiguous."""
    jm, im = grid.jm, grid.im
    t_new = _from_cols(pstate.t, jm, im)
    q_new = _from_cols(pstate.q.movedim(-1, 0), jm, im)

    # wind increments on the A grid
    ua0, va0 = d2a_winds(state.u, state.v)
    du_a = _from_cols(pstate.u, jm, im) - ua0
    dv_a = _from_cols(pstate.v, jm, im) - va0

    # uv3s_update (dp_coupling.F90:928-936): D-u at the south edge of row
    # j averages the A increments of rows j and j-1; D-v at the west edge
    # of column i averages i and i-1
    du_d = wset_row(0.5 * (du_a + _rolly(du_a, 1)), 0, 0.0)
    dv_d = 0.5 * (dv_a + _rollx(dv_a, 1))
    dv_d = wset_row(wset_row(dv_d, 0, 0.0), -1, 0.0)
    u_new = state.u + du_d
    v_new = state.v + dv_d

    # delp from the (dme-adjusted) physics pdel; pt from T
    delp_new = _from_cols(pstate.pdel, jm, im)
    pe, pk, pkz, peln = pressure_vars(delp_new, ptop)     # p_d_adjust role
    pt_new = t_new * (1.0 + c.ZVIR * q_new[0]) / pkz

    return state.replace(u=u_new.contiguous(), v=v_new.contiguous(),
                         pt=pt_new.contiguous(), delp=delp_new, q=q_new)
