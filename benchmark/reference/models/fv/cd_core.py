"""C/D-grid Lagrangian shallow-water solver (cd_core equivalent).

PyTorch twin of `cam_nor_physics_tpu.models.fv.cd_core`: the same D-grid
staggering (u at cell south edges, v at cell west edges, scalars at
centers), C-grid half step with Coriolis and pressure-gradient kicks,
tp2c/tp2d transport of delp and pt, hydrostatic geopotential, and the
vector-invariant wind update with del2/del4 divergence damping, del2
velocity damping and the polar filter. Fields are (km, jm, im) tensors, k=0
the model top.

`cd_step` runs the fused four-kernel step (cd_fused.py, K1-K4 of
ops.cd_fused_kernels) when its flags allow it: the c_sw half step with the
DFT-form polar filter (filter_impl "fft" or "dft"), as the JAX package's
cd_step does on one chip. Otherwise it runs the unfused step below, whose
transport and vorticity fluxes go through `ops.stencil_kernels`
(transport3d, vort_flux3d); filter_impl="matmul" always takes it. Either
way CUDA tensors launch the CUDA kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ...ops import tp_core as tp
from ...ops.stencil_kernels import transport3d, vort_flux3d
from ...ops.tp_core import _rollx, _rolly, edge_north, wset_interior, wset_row
from ...utils import constants as c
from .grid import FVGrid, polar_filter, polar_filter_matmul


@dataclass
class DynState:
    """Prognostic dycore state: (km, jm, im) fields, k=0 the model top;
    tracers (nq, km, jm, im)."""

    u: torch.Tensor       # D-grid zonal wind at south edges (m/s)
    v: torch.Tensor       # D-grid meridional wind at west edges (m/s)
    pt: torch.Tensor      # scaled virtual potential temperature Tv / pkz
    delp: torch.Tensor    # layer pressure thickness (Pa)
    q: torch.Tensor       # tracers (mixing ratio w.r.t. moist air)

    @property
    def km(self):
        return self.delp.shape[0]

    def replace(self, **kw) -> "DynState":
        return replace(self, **kw)


def pressure_vars(delp, ptop: float):
    """pe (km+1, ...), pk = pe^κ, pkz = Δ(p^κ)/(κ Δln p), peln from delp."""
    top = torch.full((1,) + tuple(delp.shape[1:]), ptop, dtype=delp.dtype,
                     device=delp.device)
    pe = torch.cat([top, ptop + torch.cumsum(delp, 0)], 0)
    peln = torch.log(pe)
    pk = pe ** c.CAPPA
    pkz = (pk[1:] - pk[:-1]) / (c.CAPPA * (peln[1:] - peln[:-1]))
    return pe, pk, pkz, peln


def geopotential_k(pt, pk, phis):
    """Interface geopotential by upward integration:
    Φ(k) = Φ(k+1) + cp·pt(k)·(pk(k+1) − pk(k)). Returns wz (km+1, jm, im)."""
    dgz = c.CPAIR * pt * (pk[1:] - pk[:-1])
    wz_top = phis[None] + torch.flip(torch.cumsum(torch.flip(dgz, (0,)), 0),
                                     (0,))
    return torch.cat([wz_top, phis[None]], 0)


def d2a_winds(u, v):
    """D-grid -> A-grid (cell-center) winds; pole rows get zero A winds."""
    ua = wset_interior(torch.zeros_like(u), 0.5 * (u + _rolly(u, -1)))
    va = 0.5 * (v + _rollx(v, -1))
    va = wset_row(wset_row(va, 0, 0.0), -1, 0.0)
    return ua, va


def _corner_from_center(a):
    """Average a center field to SW corners; row 0 zeroed."""
    a_w = _rollx(a, 1)
    cor = 0.25 * ((a + a_w) + _rolly(a + a_w, 1))
    return wset_row(cor, 0, 0.0)


def absolute_vorticity(u, v, grid: FVGrid):
    """Relative + planetary vorticity at cell centers from D winds; the
    pole rows carry the cap-mean circulation."""
    im = u.shape[-1]
    dl, dp = grid.dl, grid.dp
    cose, cosp = grid.cose, grid.cosp
    u_n = wset_row(_rolly(u, -1), -1, 0.0)
    cose_n = torch.cat([cose[1:], cose[-1:]])
    v_e = _rollx(v, -1)
    circ = (u * cose[:, None] - u_n * cose_n[:, None]) * dl * c.REARTH + \
        (v_e - v) * dp * c.REARTH
    area = c.REARTH ** 2 * cosp[:, None] * dl * dp
    zeta = circ / torch.where(area == 0.0, 1.0, area)
    cap_area = c.REARTH ** 2 * grid.acap * dp * dl / im
    circ_s = -torch.sum(u[..., 1, :] * cose[1] * dl * c.REARTH, dim=-1,
                        keepdim=True) / (im * cap_area)
    circ_n = torch.sum(u[..., -1, :] * cose[-1] * dl * c.REARTH, dim=-1,
                       keepdim=True) / (im * cap_area)
    zeta = wset_row(zeta, 0, circ_s)
    zeta = wset_row(zeta, -1, circ_n)
    return zeta + grid.f0[:, None]


def divergence_corner(u, v, grid: FVGrid):
    """Horizontal divergence at SW corners from D winds."""
    u_w = _rollx(u, 1)
    vterm = v * grid.cosp[:, None]
    cose_s = torch.where(grid.cose > 0, grid.cose, 1.0)[:, None]
    full = (u - u_w) / (c.REARTH * cose_s * grid.dl) + \
        (vterm - _rolly(vterm, 1)) / (c.REARTH * cose_s * grid.dp)
    return wset_interior(torch.zeros_like(u), full)


def vc_at_uc(vc):
    """Average vc (south edges) to uc points (west edges, center rows)."""
    vc_c = 0.5 * (vc + edge_north(vc))
    return 0.5 * (vc_c + _rollx(vc_c, 1))


def uc_at_vc(uc):
    """Average uc (west edges, center rows) to vc points (south edges)."""
    return wset_row(0.5 * (uc + _rolly(uc, 1)), 0, 0.0)


def _filter(field, grid: FVGrid, rows: str, filter_impl: str):
    """Polar filter of a field on center ("center") or edge ("edge") rows."""
    if filter_impl == "matmul":
        circ = grid.circ_center() if rows == "center" else grid.circ_edge()
        return polar_filter_matmul(field, circ)
    resp = grid.pft_center if rows == "center" else grid.pft_edge
    return polar_filter(field, resp)


def cd_step(state: DynState, grid: FVGrid, ptop: float, phis, dt: float,
            iord: int = 4, jord: int = 4, div2_coef_nd: float = 0.08,
            dyn_filter: bool = True, filter_impl: str = "fft",
            ke_method: str = "centered", del2_velocity: float = 0.0,
            c_sw_pgf: bool = False, filter_dm: bool = False,
            filter_csw_dm: bool = False, return_debug: bool = False, div2_on: bool = True,
            div4_coef_nd: float = 0.0, div_taper=None, fused: bool = True):
    """One small Lagrangian step. Returns (new_state, diagnostics dict with
    cx, cy, mfx, mfy, pe, pk, pkz, peln, wz).

    `return_debug` adds diagnostics["debug"], the wind update's terms (the
    C-grid kicks, vorticity fluxes, PGF pieces, the filtered increments)
    for stability forensics; it takes the unfused step, whose state it
    leaves unchanged. With `fused` (the JAX package's use_pallas) and no
    filter_dm or filter_csw_dm, flags that `cd_fused.use_fused_cd` accept
    take the fused K1-K4 step; fused=False keeps the unfused formulation.
    Whether the CUDA kernels or their plain versions run is decided by
    the tensors' device, not here."""
    if fused and not filter_dm and not filter_csw_dm:
        # imported here: cd_fused builds on this module's helpers
        from .cd_fused import cd_step_fused, use_fused_cd
        if use_fused_cd(grid, dyn_filter, c_sw_pgf, ke_method, filter_impl,
                        return_debug):
            return cd_step_fused(state, grid, ptop, phis, dt, iord, jord,
                                 div2_coef_nd, dyn_filter, ke_method,
                                 del2_velocity, div2_on=div2_on,
                                 div4_coef_nd=div4_coef_nd,
                                 div_taper=div_taper)
    dbg = {}
    u, v, pt, delp = state.u, state.v, state.pt, state.delp
    km, jm, im = delp.shape
    band5 = tp.ffsl_band(jm, grid.dl, 0.5 * dt)
    band1 = tp.ffsl_band(jm, grid.dl, dt)
    dl, dp_ = grid.dl, grid.dp
    cosp, cose, acosp = grid.cosp, grid.cose, grid.acosp
    fc_e = grid.fc

    # ---- C-grid advective winds (d2a2c + c_sw half step) ----
    ua, va = d2a_winds(u, v)
    uc0 = 0.5 * (ua + _rollx(ua, 1))
    vc0 = wset_row(0.5 * (va + _rolly(va, 1)), 0, 0.0)
    f_c = grid.f0[:, None]
    dt5 = 0.5 * dt
    safe_cosp = torch.where(cosp > 0, cosp, 1.0)[:, None]

    if c_sw_pgf:
        # full c_sw half step: advance delp/pt dt/2 on the C grid, then kick
        # uc/vc with Coriolis + the PGF of the half-advanced state; the
        # polar filtering of the increments is load-bearing
        crx_c = uc0 * dt5 / (c.REARTH * safe_cosp * dl)
        crx_c = wset_row(wset_row(crx_c, 0, 0.0), -1, 0.0)
        cry_c = wset_row(vc0 * dt5 / (c.REARTH * dp_), 0, 0.0)
        yfx_c = cry_c * cose[:, None]
        va_c2 = 0.5 * (cry_c + edge_north(cry_c))
        ffsl_c = torch.amax(torch.abs(crx_c), dim=-1) > 1.0
        ddp_c, dpt_c, _, _ = transport3d(
            delp, pt, crx_c, cry_c, yfx_c, va_c2, ffsl_c, cosp, acosp,
            grid.rcap, 1, 1, band=band5)
        if dyn_filter and filter_csw_dm:
            ddp_c = _filter(ddp_c, grid, "center", filter_impl)
            dpt_c = _filter(dpt_c, grid, "center", filter_impl)
        delp_h = torch.maximum(delp + ddp_c, 0.05 * delp)
        pt_h = (pt * delp + dpt_c) / delp_h
        pt_h = torch.maximum(pt_h, 0.1 * pt)

        pe_h, pk_h, pkz_h, _ = pressure_vars(delp_h, ptop)
        wz_h = geopotential_k(pt_h, pk_h, phis)
        phi_h = 0.5 * (wz_h[1:] + wz_h[:-1])
        en_h = phi_h + c.CPAIR * pt_h * pkz_h

        dx_en = (en_h - _rollx(en_h, 1)) / (c.REARTH * safe_cosp * dl)
        dx_th = (pt_h - _rollx(pt_h, 1)) / (c.REARTH * safe_cosp * dl)
        pi_u = 0.5 * (pkz_h + _rollx(pkz_h, 1))
        pgf_u = -(dx_en - c.CPAIR * pi_u * dx_th)
        pgf_u = wset_row(wset_row(pgf_u, 0, 0.0), -1, 0.0)

        dy_en = wset_row((en_h - _rolly(en_h, 1)) / (c.REARTH * dp_), 0, 0.0)
        dy_th = wset_row((pt_h - _rolly(pt_h, 1)) / (c.REARTH * dp_), 0, 0.0)
        pi_v = wset_row(0.5 * (pkz_h + _rolly(pkz_h, 1)), 0,
                        pkz_h[..., 0, :])
        pgf_v = wset_row(-(dy_en - c.CPAIR * pi_v * dy_th), 0, 0.0)

        duc = dt5 * (f_c * vc_at_uc(vc0) + pgf_u)
        dvc = dt5 * (-fc_e[:, None] * uc_at_vc(uc0) + pgf_v)
        if dyn_filter:
            # filtcw role: uc lives on center rows (like v), vc on edge rows
            duc = _filter(duc, grid, "center", filter_impl)
            dvc = _filter(dvc, grid, "edge", filter_impl)
        uc = uc0 + duc
        vc = vc0 + dvc
        if return_debug:
            dbg.update(uc0=uc0, vc0=vc0, duc=duc, dvc=dvc, pgf_u_c=pgf_u,
                       pgf_v_c=pgf_v, delp_h=delp_h, pt_h=pt_h)
    else:
        # Coriolis-only half rotation
        uc = uc0 + dt5 * f_c * vc_at_uc(vc0)
        vc = vc0 - dt5 * fc_e[:, None] * uc_at_vc(uc)

    # Courant numbers / background fluxes at D-flux positions
    crx = uc * dt / (c.REARTH * safe_cosp * dl)
    crx = wset_row(wset_row(crx, 0, 0.0), -1, 0.0)
    cry = wset_row(vc * dt / (c.REARTH * dp_), 0, 0.0)
    yfx = cry * cose[:, None]
    va_c = 0.5 * (cry + edge_north(cry))
    ffsl = torch.amax(torch.abs(crx), dim=-1) > 1.0

    # ---- transport delp (mass) and pt with tp2c/tp2d ----
    ddp, dpt, mfx, mfy = transport3d(
        delp, pt, crx, cry, yfx, va_c, ffsl, cosp, acosp, grid.rcap,
        iord, jord, band=band1)
    if dyn_filter and filter_dm:
        ddp = _filter(ddp, grid, "center", filter_impl)
        dpt = _filter(dpt, grid, "center", filter_impl)
    delp_new = torch.maximum(delp + ddp, 0.05 * delp)
    pt_new = (pt * delp + dpt) / delp_new

    # ---- thermodynamics from the UPDATED mass/pt fields (geopk role) ----
    pe, pk, pkz, peln = pressure_vars(delp_new, ptop)
    wz = geopotential_k(pt_new, pk, phis)
    phi_m = 0.5 * (wz[1:] + wz[:-1])

    # ---- vector-invariant wind update ----
    zeta_a = absolute_vorticity(u, v, grid)
    if ke_method == "upwind":
        u_n = wset_row(_rolly(u, -1), -1, 0.0)
        u_sel = torch.where(va >= 0.0, u, u_n)
        v_e = _rollx(v, -1)
        v_sel = torch.where(ua >= 0.0, v, v_e)
        ke = wset_interior(0.5 * (ua ** 2 + va ** 2),
                           0.5 * (u_sel ** 2 + v_sel ** 2))
    elif ke_method == "avg_sq":
        u_n = wset_row(_rolly(u, -1), -1, 0.0)
        ke_u = wset_interior(torch.zeros_like(u), 0.5 * (u ** 2 + u_n ** 2))
        ke_v = 0.5 * (v ** 2 + _rollx(v, -1) ** 2)
        ke_v = wset_row(wset_row(ke_v, 0, 0.0), -1, 0.0)
        ke = 0.5 * (ke_u + ke_v)
    else:
        ke = 0.5 * (ua ** 2 + va ** 2)
    # PGF from the POST-transport state (backward evaluation; load-bearing)
    energy = ke + phi_m + c.CPAIR * pt_new * pkz
    pi_ = pkz
    theta = pt_new

    v_c4 = _corner_from_center(0.5 * (v + _rollx(v, -1)))
    v_edge = 0.5 * (v_c4 + _rollx(v_c4, -1))
    fx_z, fy_z = vort_flux3d(zeta_a, crx, cry, uc * dt, v_edge * dt, ffsl,
                           cosp, iord, jord, band=band1)

    cose_s = torch.where(cose[:, None] > 0, cose[:, None], 1.0)
    en_c = _corner_from_center(energy)
    th_c = _corner_from_center(theta)
    pi_c = _corner_from_center(pi_)
    dx_en = (_rollx(en_c, -1) - en_c) / (c.REARTH * cose_s * dl)
    dx_th = (_rollx(th_c, -1) - th_c) / (c.REARTH * cose_s * dl)
    pi_u = 0.5 * (pi_c + _rollx(pi_c, -1))

    du = fy_z - dt * (dx_en - c.CPAIR * pi_u * dx_th)
    du = wset_row(du, 0, 0.0)
    if return_debug:
        dbg.update(fy_z=fy_z, du_pgf=-dt * (dx_en - c.CPAIR * pi_u * dx_th))

    def dy_of(ac):
        return wset_interior(torch.zeros_like(v),
                             (_rolly(ac, -1) - ac) / (c.REARTH * dp_))

    dy_en = dy_of(en_c)
    dy_th = dy_of(th_c)
    pi_v = wset_interior(torch.zeros_like(v), 0.5 * (_rolly(pi_c, -1) + pi_c))

    dv = -fx_z - dt * (dy_en - c.CPAIR * pi_v * dy_th)
    dv = wset_row(wset_row(dv, 0, 0.0), -1, 0.0)
    if return_debug:
        dbg.update(fx_z=fx_z, dv_pgf=-dt * (dy_en - c.CPAIR * pi_v * dy_th),
                   crx=crx, cry=cry, ke=ke, zeta_a=zeta_a)

    # ---- divergence damping (div24del2flag family) ----
    cose_sf = torch.where(cose[:, None] > 0, cose[:, None], 1.0)
    div = divergence_corner(u, v, grid)
    damp = torch.zeros_like(div)
    if div_taper is not None:
        c2 = torch.clamp(torch.as_tensor(div_taper, dtype=div.dtype,
                                         device=div.device),
                         min=div2_coef_nd)[:, None, None]
    else:
        c2 = div2_coef_nd
    if div2_on:
        nu = c2 * (c.REARTH * dp_) ** 2 / dt
        damp = damp + nu * div
    if div4_coef_nd > 0.0:
        rdx2 = 1.0 / (c.REARTH * cose_sf * dl) ** 2
        rdy2 = 1.0 / (c.REARTH * dp_) ** 2
        lap_div = (_rollx(div, -1) - 2.0 * div + _rollx(div, 1)) * rdx2
        lap_div = lap_div + wset_interior(
            torch.zeros_like(div),
            (_rolly(div, -1) - 2.0 * div + _rolly(div, 1)) * rdy2)
        lap_div = wset_interior(torch.zeros_like(div), lap_div)
        # biharmonic coefficient follows the local grid scale
        l4 = (c.REARTH * torch.clamp(cose_sf * dl, max=dp_)) ** 4
        nu4 = (div4_coef_nd / dt) * l4
        damp = damp - nu4 * lap_div
    ddiv_x = (_rollx(damp, -1) - damp) / (c.REARTH * cose_sf * dl)
    du = du + dt * ddiv_x
    ddiv_y = wset_interior(torch.zeros_like(v),
                           (_rolly(damp, -1) - damp) / (c.REARTH * dp_))
    dv = dv + dt * ddiv_y

    if del2_velocity > 0.0:
        cs = torch.where(cose[:, None] > 0, cose[:, None], 1.0)
        rdx2 = 1.0 / (c.REARTH * cs * dl) ** 2
        rdy2 = 1.0 / (c.REARTH * dp_) ** 2

        def lap(a):
            d2x = (_rollx(a, -1) - 2.0 * a + _rollx(a, 1)) * rdx2
            d2y = wset_interior(
                torch.zeros_like(a),
                (_rolly(a, -1) - 2.0 * a + _rolly(a, 1)) * rdy2)
            return d2x + d2y

        du = du + dt * del2_velocity * lap(u)
        dv = dv + dt * del2_velocity * lap(v)

    # ---- polar filter on wind tendencies ----
    if dyn_filter:
        du = _filter(du, grid, "edge", filter_impl)
        dv = _filter(dv, grid, "center", filter_impl)

    new_state = state.replace(u=u + du, v=v + dv, pt=pt_new, delp=delp_new)
    diags = dict(cx=crx, cy=cry, mfx=mfx, mfy=mfy, pe=pe, pk=pk, pkz=pkz,
                 peln=peln, wz=wz)
    if return_debug:
        dbg.update(du=du, dv=dv)
        diags["debug"] = dbg
    return new_state, diags
