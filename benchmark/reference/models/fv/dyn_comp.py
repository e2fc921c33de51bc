"""FV dycore component: dyn_run orchestration, trac2d, te_map.

PyTorch twin of `cam_nor_physics_tpu.models.fv.dyn_comp`:

    for iv in 1..nv (vertical-remap subcycle):
      for n in 1..n2 (tracer subcycle):
        save dp0; zero cx/cy/mfx/mfy
        for it in 1..nsplit: cd_step (accumulating Courants and fluxes)
        trac2d: large-step tracer transport with the accumulated fluxes
      te_map: conservative vertical remap back to the hybrid coordinate

The subcycles are Python loops. Each small step is cd_step: the fused
K1-K4 for filter_impl "fft"/"dft" with the default c_sw half step, the
unfused step (transport3d, vort_flux3d) for "matmul". tracer_div3d and
te_map_remap launch their CUDA kernels for CUDA tensors.

The options: the axial angular-momentum fixer (global, tapered or level
by level) after each small step, the AM correction that closes the small
step's AM budget against the mountain torque, the am_diag payload, and
WACCM-X high-altitude κ, advected by trac2d as one more tracer slot.
"""

from __future__ import annotations

import math

import torch

from ...ops import tp_core as tp
from ...ops.fill import fillz
from ...ops.remap_kernels import te_map_remap
from ...ops.stencil_kernels import tracer_div3d
from ...ops.thermo import calc_kappav
from ...ops.tp_core import _rollx, _rolly, edge_north, wset_row
from ...utils import constants as c
from ...utils.config import FVConfig
from .cd_core import DynState, cd_step, d2a_winds, pressure_vars
from .grid import FVGrid
from .vertical import HybridCoord


def trac2d(q, dp0, cx, cy, mfx, mfy, grid: FVGrid, iord: int, jord: int,
           fill: bool = True):
    """Large-timestep tracer transport with accumulated Courant numbers and
    mass fluxes. q: (nq, km, jm, im); dp0: (km, jm, im) pre-step thickness.
    The new thickness is diagnosed from the same mass fluxes, so mixing
    ratios stay consistent with the continuity equation. Returns
    (q_new, dp_new)."""
    ffsl = torch.amax(torch.abs(cx), dim=-1) > 1.0
    va = 0.5 * (cy + edge_north(cy))
    ddp = tp.flux_divergence(mfx, mfy, grid.acosp, grid.rcap)
    # guard rail: floor the flux-implied thickness (te_map restores the
    # coordinate afterwards)
    dp_new = torch.maximum(dp0 + ddp, 0.05 * dp0)
    dqm = tracer_div3d(q, cx, cy, mfx, mfy, va, ffsl, grid.cosp,
                       grid.acosp, grid.rcap, iord, jord)
    q_new = (q * dp0[None] + dqm) / dp_new[None]
    if fill:
        qk, _ = fillz(q_new.movedim(1, -1), dp_new.movedim(0, -1)[None])
        # contiguous: the next tracer cycle's tracer_div3d takes it as is
        q_new = qk.movedim(-1, 1).contiguous()
    return q_new, dp_new


def _south_shift(a):
    """a[..., j-1, :] with row 0 kept."""
    return wset_row(_rolly(a, 1), 0, a[..., 0, :])


def _layer_te(pt, u, v, pk):
    """Layer total energy KE + Montgomery streamfunction
    (Φ at the layer's lower edge + cp·pt·pk there), surface Φ taken as 0."""
    ua, va = d2a_winds(u, v)
    ke = 0.5 * (ua ** 2 + va ** 2)
    contrib = c.CPAIR * pt * (pk[1:] - pk[:-1])
    phi_edge = torch.flip(torch.cumsum(torch.flip(contrib, (0,)), 0), (0,))
    phi_below = phi_edge - contrib
    return ke + phi_below + c.CPAIR * pt * pk[1:]


def te_map(state: DynState, coord: HybridCoord, grid: FVGrid, ptop: float,
           kord: int = 4, consv: bool = False):
    """Vertical remap from Lagrangian surfaces to the hybrid coordinate:
    pt (mass-weighted), tracers, and u/v on edge-averaged pressure
    thickness; column air mass is preserved exactly. consv=True remaps the
    layer total energy and recovers pt from it bottom-up."""
    km, jm, im = state.delp.shape
    nq = state.q.shape[0]
    pe, pk, _, _ = pressure_vars(state.delp, ptop)
    pe_tgt = coord.pint(pe[-1]).movedim(-1, 0).contiguous()  # (km+1, jm, im)
    ncol = jm * im

    def r2(a):
        return a.reshape(a.shape[0], ncol).contiguous()

    cen_fields = [state.pt] + [state.q[m] for m in range(nq)]
    if consv:
        cen_fields.append(_layer_te(state.pt, state.u, state.v, pk))
    cen, u2, v2 = te_map_remap(
        r2(pe), r2(pe_tgt),
        r2(0.5 * (pe + _south_shift(pe))),
        r2(0.5 * (pe_tgt + _south_shift(pe_tgt))),
        r2(0.5 * (pe + _rollx(pe, 1))),
        r2(0.5 * (pe_tgt + _rollx(pe_tgt, 1))),
        [r2(f) for f in cen_fields], r2(state.u), r2(state.v), kord)
    cen = [f.reshape(km, jm, im) for f in cen]
    u_new = u2.reshape(km, jm, im)
    v_new = v2.reshape(km, jm, im)
    pt_new = cen[0]
    q_new = torch.stack(cen[1:1 + nq], 0)
    delp_new = pe_tgt[1:] - pe_tgt[:-1]

    if consv:
        # te_k = ke_k + Φ_{k+1} + cp·pt_k·pk_{k+1} on the new coordinate
        te_new = cen[1 + nq]
        pk_t = pe_tgt ** c.CAPPA
        ua, va = d2a_winds(u_new, v_new)
        ke_new = 0.5 * (ua ** 2 + va ** 2)
        phi_below = torch.zeros_like(pt_new[0])
        rows = [None] * km
        for k in range(km - 1, -1, -1):
            pt_k = (te_new[k] - ke_new[k] - phi_below) / \
                (c.CPAIR * pk_t[k + 1])
            phi_below = phi_below + c.CPAIR * pt_k * (pk_t[k + 1] - pk_t[k])
            rows[k] = pt_k
        pt_new = torch.stack(rows, 0)

    return state.replace(u=u_new, v=v_new, pt=pt_new, delp=delp_new,
                         q=q_new)


def compute_vdot_gradp(state: DynState, grid: FVGrid, ptop: float):
    """v·∇p at layer midpoints (the advective part of ω), centered
    differences on A-grid winds, pole rows zeroed."""
    pe = pressure_vars(state.delp, ptop)[0]
    pmid = 0.5 * (pe[1:] + pe[:-1])
    ua, va = d2a_winds(state.u, state.v)
    safe_cosp = torch.where(grid.cosp > 0, grid.cosp, 1.0)[None, :, None]
    dpdx = (_rollx(pmid, -1) - _rollx(pmid, 1)) / \
        (2.0 * c.REARTH * safe_cosp * grid.dl)
    dpdy = (_rolly(pmid, -1) - _rolly(pmid, 1)) / (2.0 * c.REARTH * grid.dp)
    vgp = ua * dpdx + va * dpdy
    return wset_row(wset_row(vgp, 0, 0.0), -1, 0.0)


def _am_weight(grid: FVGrid):
    """(cosφ_e, cosφ_e·dλ·dφ) at u's edge rows, shaped (1, jm, 1)."""
    cose = grid.cose[None, :, None]
    return cose, cose * grid.dl * grid.dp


def axial_angular_momentum(state: DynState, grid: FVGrid,
                           per_level: bool = False):
    """Axial relative angular momentum Σ u·cosφ·delp·(cell area) over the
    sphere (dyn_comp.F90:1952-2069), u weighted at its edge rows;
    `per_level` gives the (km,) level sums instead."""
    cose, w = _am_weight(grid)
    integrand = state.u * cose * state.delp * w
    if per_level:
        return torch.sum(integrand, (-2, -1))
    return torch.sum(integrand)


def am_taper(coord: HybridCoord, tpr_h: float, tpr_w: float, km: int,
             high_order_top: bool):
    """The AM fixer's pressure taper (dyn_comp.F90:1268-1272, 1960-1982):
    taper(k) = 1/(1 + (ptapk/avgpk(k))^xdlt2), ptap = tpr_h − tpr_w/2,
    ptapk = ptap^κ, xdlt2 = 2/(κ·ln((ptap+tpr_w/2)/(ptap−tpr_w/2))),
    avgpk from the hybrid reference pressures. Levels below km//8 are 0
    unless high_order_top."""
    ptap = tpr_h - 0.5 * tpr_w
    ptapk = ptap ** c.CAPPA
    xdlt2 = 2.0 / (math.log((ptap + 0.5 * tpr_w) / (ptap - 0.5 * tpr_w)) *
                   c.CAPPA)
    pref = coord.ak + coord.bk * coord.ps0
    avgpk = (0.5 * (pref[1:] + pref[:-1])) ** c.CAPPA
    taper = 1.0 / (1.0 + (ptapk / avgpk) ** xdlt2)
    if not high_order_top:
        k = torch.arange(km, device=taper.device)
        taper = torch.where(k < km // 8, 0.0, taper)
    return taper


def am_fixer(state: DynState, grid: FVGrid, am0, taper=None,
             lbl: bool = False):
    """Restore the axial AM `am0` ((km,) per-level sums) by a cosφ-shaped
    wind increment (dyn_comp.F90:1994-2051): level by level with `lbl`,
    else one global ratio shaped by taper(k)·cosφ. Returns (new state,
    the (km,) increment coefficients du_k). Everything stays on the
    device: no value is read on the host."""
    cose, w = _am_weight(grid)
    don_k = axial_angular_momentum(state, grid, per_level=True) - am0
    dod_k = torch.sum(cose * cose * state.delp * w, (-2, -1))
    tpr = torch.ones_like(don_k) if taper is None else taper
    if lbl:
        du_k = -(don_k / dod_k) * tpr
    else:
        am1 = torch.sum(don_k * tpr)
        me0 = torch.clamp(torch.sum(dod_k * tpr), min=1e-30)
        du_k = -(am1 / me0) * tpr
    u_new = (state.u + du_k[:, None, None] * cose) * (cose > 0)
    return state.replace(u=u_new), du_k


def mountain_torque(state: DynState, phis, grid: FVGrid, ptop: float):
    """Σ Φs·δx(ps) over the sphere, the resolved mountain torque in the
    units of axial_angular_momentum per second: the only AM source the
    continuous equations allow between physics updates."""
    ps = pressure_vars(state.delp, ptop)[0][-1]
    cosp = grid.cosp[:, None]
    dpsdx = (_rollx(ps, -1) - _rollx(ps, 1)) * 0.5 / \
        (c.REARTH * torch.where(cosp > 0, cosp, 1.0) * grid.dl)
    w_c = cosp * grid.dl * grid.dp
    return torch.sum(phis * dpsdx * cosp * w_c * (cosp > 0))


def benergy(state: DynState, grid: FVGrid, ptop: float):
    """Global total energy Σ w·delp·(cp·Tv + K) before the dynamics
    (benergy, dyn_comp.F90:1327-1329), the pole rows weighted by their
    cap's share."""
    _, _, pkz, _ = pressure_vars(state.delp, ptop)
    ua, va = d2a_winds(state.u, state.v)
    ke = 0.5 * (ua ** 2 + va ** 2)
    w = grid.cosp.clone()
    w[0] = w[-1] = grid.acap / grid.im
    return torch.sum(w[None, :, None] * state.delp *
                     (c.CPAIR * state.pt * pkz + ke))


def _floor_count(delp_new, delp_old):
    """Thickness-floor activations: cells clamped at 0.05·delp_old."""
    return torch.sum(delp_new <= 0.05 * delp_old * (1.0 + 1e-10))


def dyn_run(state: DynState, grid: FVGrid, coord: HybridCoord, phis,
            cfg: FVConfig, ndt: float, filter_impl: str = "fft",
            c_sw_pgf: bool | None = None, return_diags: bool = False):
    """One large dynamics timestep. Subcycles (dyn_comp.F90:1497-1524):
    n2 = (nspltrac + nv - 1)//nv; nsplit = (ns + n2*nv - 1)//(n2*nv);
    dt = ndt/(nsplit*n2*nv). With `return_diags` also returns
    {"omega": ω of the last remap cycle, "floor_activations": count}, and
    with am_diag AM_DU3S, AM_DUFIX, AM_TOTAL, du3s and du_fix_s."""
    if cfg.filtcw < 0:
        raise NotImplementedError(
            "FVConfig.filtcw < 0 (disable the C-grid wind filter) is not "
            "supported: the filter is load-bearing for the c_sw half step")
    if c_sw_pgf is None:
        c_sw_pgf = cfg.c_sw_pgf
    ns, nspltrac, nv = cfg.resolved_splits(ndt, grid.im, grid.jm)
    n2 = (nspltrac + nv - 1) // nv
    nsplit = (ns + n2 * nv - 1) // (n2 * nv)
    dt = ndt / (nsplit * n2 * nv)
    ptop = coord.ptop

    flag = cfg.div24del2flag
    if flag not in (2, 4, 22, 24, 42):
        raise ValueError(f"div24del2flag must be one of 2/4/24/42 "
                         f"(or repo extension 22), got {flag}")
    div2_on = flag in (2, 22, 24)
    div4_nd = cfg.div4_coef_nd if flag in (4, 24, 42) else 0.0
    del2_vel = cfg.del2coef if flag in (22, 42) else 0.0
    if div2_on and cfg.div_damp_top_taper:
        # sponge tau/128, tau = max(1, 8(1+tanh ln(ptop/p))), at the hybrid
        # reference mid-pressures
        pref = coord.ak + coord.bk * coord.ps0
        pmid_ref = 0.5 * (pref[1:] + pref[:-1])
        tau = torch.clamp(8.0 * (1.0 + torch.tanh(torch.log(ptop / pmid_ref))),
                          min=1.0)
        div_taper = tau / 128.0
    else:
        div_taper = None

    # the fixer's taper; duf sums the fixer's coefficients for am_diag (a
    # scalar 0 when am_diag is off)
    if cfg.am_fixer and (cfg.am_fix_taper or not cfg.am_fix_lbl):
        fix_taper = am_taper(coord, cfg.am_fix_tpr_h, cfg.am_fix_tpr_w,
                             state.km, cfg.high_order_top)
    else:
        fix_taper = None
    duf = state.u.new_zeros((state.km,) if cfg.am_diag else ())
    u_in = state.u

    n_floor = torch.zeros((), dtype=torch.int64, device=state.delp.device)
    omega = None
    for _ in range(nv):
        pe0 = pressure_vars(state.delp, ptop)[0]
        pmid0 = 0.5 * (pe0[1:] + pe0[:-1])
        for _ in range(n2):
            dp0 = state.delp
            acc = None
            for _ in range(nsplit):
                delp_before = state.delp
                am0 = (axial_angular_momentum(state, grid, per_level=True)
                       if cfg.am_fixer or cfg.am_correction else None)
                tq = (mountain_torque(state, phis, grid, ptop)
                      if cfg.am_correction else None)
                state, d = cd_step(
                    state, grid, ptop, phis, dt, iord=cfg.iord,
                    jord=cfg.jord, dyn_filter=cfg.fft_flt >= 0,
                    filter_impl=filter_impl, c_sw_pgf=c_sw_pgf,
                    filter_dm=cfg.filter_dm, filter_csw_dm=cfg.filter_csw_dm,
                    ke_method=cfg.ke_method, div2_coef_nd=cfg.div2_coef_nd,
                    div2_on=div2_on, div4_coef_nd=div4_nd,
                    div_taper=div_taper, del2_velocity=del2_vel)
                if cfg.am_correction:
                    # close the step's AM budget: AM_after = AM_before +
                    # dt·torque, the torque entering at the surface layer;
                    # with the fixer on, this one projection serves both
                    am_tgt = torch.cat([am0[:-1], am0[-1:] + dt * tq])
                    state, du_k = am_fixer(
                        state, grid, am_tgt,
                        taper=fix_taper if cfg.am_fixer else None,
                        lbl=cfg.am_fixer and cfg.am_fix_lbl)
                    if cfg.am_diag:
                        duf = duf + du_k
                elif cfg.am_fixer:
                    state, du_k = am_fixer(state, grid, am0, taper=fix_taper,
                                           lbl=cfg.am_fix_lbl)
                    if cfg.am_diag:
                        duf = duf + du_k
                step = {k: d[k] for k in ("cx", "cy", "mfx", "mfy")}
                acc = step if acc is None else \
                    {k: acc[k] + step[k] for k in acc}
                n_floor = n_floor + _floor_count(state.delp, delp_before)
            if cfg.high_altitude:
                # κ of the cycle's entry composition rides trac2d as one
                # more tracer slot (dyn_comp.F90:2371-2383); cat gives the
                # contiguous stack the tracer kernel takes
                q_tr = torch.cat([state.q, calc_kappav(
                    state.q, cfg.major_species)[None]], 0)
            else:
                q_tr = state.q
            q_new, dp_tr = trac2d(q_tr, dp0, acc["cx"], acc["cy"],
                                  acc["mfx"], acc["mfy"], grid, cfg.iord,
                                  cfg.jord)
            n_floor = n_floor + _floor_count(dp_tr, dp0)
            if cfg.high_altitude:
                # correct pt first-order for κ of the advected species
                # against the advected κ (dyn_comp.F90:2461-2486):
                # pt *= 1 − ln(p_mid)·(κ_new − κ_adv)
                q_new, kap_adv = q_new[:-1], q_new[-1]
                kap_new = calc_kappav(q_new, cfg.major_species)
                pe_ha = pressure_vars(state.delp, ptop)[0]
                lnpm = 0.5 * (torch.log(pe_ha[1:]) + torch.log(pe_ha[:-1]))
                state = state.replace(
                    pt=state.pt * (1.0 - lnpm * (kap_new - kap_adv)))
            state = state.replace(q=q_new)
        pe1 = pressure_vars(state.delp, ptop)[0]
        pmid1 = 0.5 * (pe1[1:] + pe1[:-1])
        # ω = ∂p/∂t of the material layer + v·∇p
        omega = (pmid1 - pmid0) * (nv / ndt) + \
            compute_vdot_gradp(state, grid, ptop)
        state = te_map(state, coord, grid, ptop, kord=cfg.kord,
                       consv=cfg.conserve)
    if return_diags:
        diags = {"omega": omega, "floor_activations": n_floor}
        if cfg.am_diag:
            # the am_diag payload (dp_coupling.F90:281-310): the step's
            # wind increment, the fixer's coefficients, their AM integrals
            du3s = state.u - u_in
            cose, w = _am_weight(grid)
            diags["AM_DU3S"] = torch.sum(du3s * cose * state.delp * w)
            diags["AM_DUFIX"] = torch.sum(
                duf[:, None, None] * cose * cose * state.delp * w)
            diags["AM_TOTAL"] = axial_angular_momentum(state, grid)
            diags["du3s"] = du3s
            diags["du_fix_s"] = duf
        return state, diags
    return state
