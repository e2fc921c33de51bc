"""The fused small step: cd_step as four kernels K1-K4.

PyTorch twin of `cam_nor_physics_tpu.models.fv.cd_pallas`, which runs one
small step as four Pallas programs:

    K1  c_sw half step: D->A->C winds, C-grid Courants, tp2c/tp2d transport
        at order 1, the thickness/pt floors, then the DOWNWARD pressure
        pass carrying pe, pe^kappa and ln pe
                                         -> pt_h, uc0, vc0, pkz_h, dgz_h
    K2  the UPWARD geopotential pass seeded with phis, the C-grid PGF and
        Coriolis kick, the polar filter as real-DFT sums, the D Courants
                                                 -> uc, crx, cry
    K3  D-grid tp2c/tp2d transport, floors, downward pressure pass
                                         -> delp', pt', mfx, mfy, pkz, dgz
    K4  upward wz pass to phi_m, vector-invariant wind update (vorticity
        with polar-cap means, KE, ytp/xtp vorticity fluxes, corner PGF),
        del2/del4 divergence damping, del2 velocity damping, polar filter
                                                 -> u', v'

`k1_ref`...`k4_ref` are the plain versions of the four kernels, with the
kernels' inputs and outputs; `ops.cd_fused_kernels.k1`...`k4` launch the
hand-written CUDA kernels for CUDA tensors and take these for CPU tensors.
`cd_step_fused` runs the four in order and returns what `cd_core.cd_step`
returns.

Rounding. Each plain version is written in the order its CUDA kernel
evaluates, so that the two round alike in float32:
- every quantity that depends on the row only (metric factors, areas,
  damping coefficients) is one (jm,) table from `_metric_rows`, which the
  wrappers pass to the kernels; a division by a Python scalar, which
  PyTorch evaluates as a multiply by its reciprocal on CUDA only, never
  occurs at a grid point;
- the pressure and geopotential passes are sequential loops over k, the
  kernels' carry, not cumsum;
- the polar filter's sums run over i (forward) and m (inverse) in order,
  one product and one addition per term, as the kernels sum them;
- the polar-cap sums accumulate in float64.
"""

from __future__ import annotations

import math

import torch

from ...ops import tp_core as tp
from ...ops.stencil_kernels import transport3d_ref
from ...ops.tp_core import _rollx, _rolly, edge_north, wset_interior, wset_row
from ...utils import constants as c
from .cd_core import _corner_from_center
from .cd_core import d2a_winds as _d2a
from .cd_core import geopotential_k, pressure_vars
from .cd_core import uc_at_vc as _uc_at_vc
from .cd_core import vc_at_uc as _vc_at_uc
from .grid import FVGrid

KE_METHODS = ("centered", "avg_sq", "upwind")

# rows of the (len(METRIC_ROWS), jm) table from `_metric_rows`, in the
# order csrc/cd_fused_kernels.cu reads them
METRIC_ROWS = ("cosp", "acosp", "cose", "cosen", "f0", "fc", "dxp", "dy",
               "dxe", "dye", "rdx2", "rdy2", "area", "c4")


def use_fused_cd(grid: FVGrid, dyn_filter: bool, c_sw_pgf: bool,
                 ke_method: str, filter_impl: str, return_debug: bool) -> bool:
    """Whether cd_step takes the fused path for these flags (the flag
    conditions of the JAX gate): the c_sw half step, the DFT-form polar
    filter ("fft" or "dft"; "matmul" stays on the unfused step), a known
    KE form, no debug payload."""
    if return_debug or not c_sw_pgf:
        return False
    if filter_impl not in ("fft", "dft"):
        return False
    return ke_method in KE_METHODS


def _metric_rows(cosp, acosp, cose, f0, fc, dl: float, dp: float,
                 nu4: float = 0.0):
    """The (len(METRIC_ROWS), jm) table of per-row factors, in the grid's
    dtype: the rows themselves, cose shifted north (cosen), the x and y
    spacings at centers (dxp, dy) and edges (dxe, dye), the Laplacian
    weights 1/dxe², 1/dy², the cell area (1 where it vanishes) and the
    del4 coefficient nu4·L(j)⁴."""
    safe_cosp = torch.where(cosp > 0, cosp, 1.0)
    cose_s = torch.where(cose > 0, cose, 1.0)
    cosen = torch.cat([cose[1:], cose[-1:]])
    dy = torch.full_like(cosp, c.REARTH * dp)
    dxe = c.REARTH * cose_s * dl
    area = c.REARTH ** 2 * cosp * dl * dp
    l4 = (c.REARTH * torch.clamp(cose_s * dl, max=dp)) ** 4
    rows = dict(cosp=cosp, acosp=acosp, cose=cose, cosen=cosen, f0=f0,
                fc=fc, dxp=c.REARTH * safe_cosp * dl, dy=dy, dxe=dxe,
                dye=c.REARTH * cose_s * dp, rdx2=1.0 / dxe ** 2,
                rdy2=1.0 / dy ** 2,
                area=torch.where(area == 0.0, 1.0, area), c4=nu4 * l4)
    return torch.stack([rows[r] for r in METRIC_ROWS])


_R = {name: n for n, name in enumerate(METRIC_ROWS)}


def _row(m, name):
    """One metric row as a (jm, 1) column for broadcasting over i."""
    return m[_R[name]][:, None]


def _dft_filter(a, fc, fs, gc, gs, resp):
    """Polar filter of a (..., jm, im) field as two-sided real-DFT sums:
    ((a·Fc)∘resp)·Gc + ((a·Fs)∘resp)·Gs, each sum taken term by term in
    index order (the kernels' order)."""
    im = a.shape[-1]
    nf = fc.shape[1]
    sr = torch.zeros(a.shape[:-1] + (nf,), dtype=a.dtype, device=a.device)
    si = torch.zeros_like(sr)
    for i in range(im):
        ai = a[..., i:i + 1]
        sr = sr + ai * fc[i]
        si = si + ai * fs[i]
    sr = sr * resp
    si = si * resp
    out_c = torch.zeros_like(a)
    out_s = torch.zeros_like(a)
    for m in range(nf):
        out_c = out_c + sr[..., m:m + 1] * gc[m]
        out_s = out_s + si[..., m:m + 1] * gs[m]
    return out_c + out_s


def _down_thermo(delp, pt, ptop: float):
    """Downward hydrostatic pass over k: (pe, pe^κ, ln pe) carried from the
    model top (ptop, ptop^κ and ln ptop in float64 on the host); returns
    the layer pkz = Δpe^κ/(κ Δln pe) and dgz = cp·pt·Δpe^κ."""
    shape = delp.shape[1:]
    pe_top = torch.full(shape, ptop, dtype=delp.dtype, device=delp.device)
    pk_top = torch.full_like(pe_top, ptop ** c.CAPPA)
    pl_top = torch.full_like(pe_top, math.log(ptop))
    pkz, dgz = [], []
    for k in range(delp.shape[0]):
        pe_bot = pe_top + delp[k]
        pk_bot = pe_bot ** c.CAPPA
        pl_bot = torch.log(pe_bot)
        pkz.append((pk_bot - pk_top) / (c.CAPPA * (pl_bot - pl_top)))
        dgz.append(c.CPAIR * pt[k] * (pk_bot - pk_top))
        pe_top, pk_top, pl_top = pe_bot, pk_bot, pl_bot
    return torch.stack(pkz), torch.stack(dgz)


def _up_geopotential(dgz, phis):
    """Upward pass over k from the surface geopotential: the layer-mean
    phi_m = 0.5·(wz_top + wz_bot)."""
    wz_bot = phis
    phi = [None] * dgz.shape[0]
    for k in range(dgz.shape[0] - 1, -1, -1):
        wz_top = wz_bot + dgz[k]
        phi[k] = 0.5 * (wz_top + wz_bot)
        wz_bot = wz_top
    return torch.stack(phi)


def _ffsl_rows(crx):
    """Per-row FFSL switch (km, jm): some |Courant| of the row exceeds 1."""
    return torch.amax(torch.abs(crx), dim=-1) > 1.0


def c_grid_courants(u, v, metrics, dt5: float):
    """K1's C-grid winds and their half-step Courant numbers from the
    D-grid winds: (uc0, vc0, crx_c, cry_c)."""
    ua, va = _d2a(u, v)
    uc0 = 0.5 * (ua + _rollx(ua, 1))
    vc0 = wset_row(0.5 * (va + _rolly(va, 1)), 0, 0.0)
    crx_c = uc0 * dt5 / _row(metrics, "dxp")
    crx_c = wset_row(wset_row(crx_c, 0, 0.0), -1, 0.0)
    cry_c = wset_row(vc0 * dt5 / _row(metrics, "dy"), 0, 0.0)
    return uc0, vc0, crx_c, cry_c


def k1_ref(u, v, pt, delp, metrics, dt5: float, rcap: float, ptop: float,
           band: int | None):
    """Plain version of K1: the c_sw half step and the downward pressure
    pass. Returns (pt_h, uc0, vc0, pkz_h, dgz_h)."""
    uc0, vc0, crx_c, cry_c = c_grid_courants(u, v, metrics, dt5)
    yfx_c = cry_c * _row(metrics, "cose")
    va_c2 = 0.5 * (cry_c + edge_north(cry_c))

    # transport3d_ref is the JAX kernels' _tp_pair
    ddp_c, dpt_c, _, _ = transport3d_ref(
        delp, pt, crx_c, cry_c, yfx_c, va_c2, _ffsl_rows(crx_c),
        metrics[_R["cosp"]], metrics[_R["acosp"]], rcap, 1, 1, band)
    delp_h = torch.maximum(delp + ddp_c, 0.05 * delp)
    pt_h = (pt * delp + dpt_c) / delp_h
    pt_h = torch.maximum(pt_h, 0.1 * pt)
    pkz_h, dgz_h = _down_thermo(delp_h, pt_h, ptop)
    return pt_h, uc0, vc0, pkz_h, dgz_h


def k2_ref(pt_h, pkz_h, dgz_h, uc0, vc0, phis, metrics, dft, dt: float,
           dt5: float, dyn_filter: bool):
    """Plain version of K2: the upward geopotential pass, the C-grid PGF
    and Coriolis kick, the polar filter (duc on center rows, dvc on edge
    rows) and the D-grid Courants. `dft` = (fc, fs, gc, gs, resp_center,
    resp_edge). Returns (uc, crx, cry)."""
    phi_h = _up_geopotential(dgz_h, phis)
    en_h = phi_h + c.CPAIR * pt_h * pkz_h
    dxp, dy = _row(metrics, "dxp"), _row(metrics, "dy")

    dx_en = (en_h - _rollx(en_h, 1)) / dxp
    dx_th = (pt_h - _rollx(pt_h, 1)) / dxp
    pi_u = 0.5 * (pkz_h + _rollx(pkz_h, 1))
    pgf_u = -(dx_en - c.CPAIR * pi_u * dx_th)
    pgf_u = wset_row(wset_row(pgf_u, 0, 0.0), -1, 0.0)

    dy_en = wset_row((en_h - _rolly(en_h, 1)) / dy, 0, 0.0)
    dy_th = wset_row((pt_h - _rolly(pt_h, 1)) / dy, 0, 0.0)
    pi_v = 0.5 * (pkz_h + _rolly(pkz_h, 1))
    pgf_v = wset_row(-(dy_en - c.CPAIR * pi_v * dy_th), 0, 0.0)

    duc = dt5 * (_row(metrics, "f0") * _vc_at_uc(vc0) + pgf_u)
    dvc = dt5 * (-_row(metrics, "fc") * _uc_at_vc(uc0) + pgf_v)
    if dyn_filter:
        fc, fs, gc, gs, rspc, rspe = dft
        duc = _dft_filter(duc, fc, fs, gc, gs, rspc)
        dvc = _dft_filter(dvc, fc, fs, gc, gs, rspe)
    uc = uc0 + duc
    vc = vc0 + dvc

    crx = uc * dt / dxp
    crx = wset_row(wset_row(crx, 0, 0.0), -1, 0.0)
    cry = wset_row(vc * dt / dy, 0, 0.0)
    return uc, crx, cry


def k3_ref(delp, pt, crx, cry, metrics, iord: int, jord: int, rcap: float,
           ptop: float, band: int | None):
    """Plain version of K3: the D-grid transport, the thickness floor and
    the downward pressure pass. Returns (delp', pt', mfx, mfy, pkz, dgz)."""
    yfx = cry * _row(metrics, "cose")
    va_c = 0.5 * (cry + edge_north(cry))
    ddp, dpt, mfx, mfy = transport3d_ref(
        delp, pt, crx, cry, yfx, va_c, _ffsl_rows(crx), metrics[_R["cosp"]],
        metrics[_R["acosp"]], rcap, iord, jord, band)
    delp_new = torch.maximum(delp + ddp, 0.05 * delp)
    pt_new = (pt * delp + dpt) / delp_new
    pkz, dgz = _down_thermo(delp_new, pt_new, ptop)
    return delp_new, pt_new, mfx, mfy, pkz, dgz


def k4_ref(u, v, pt_new, pkz, dgz, phis, crx, cry, uc, metrics, nu2_rows,
           dft, dt: float, dl: float, dp: float, iord: int, jord: int,
           ke_method: str, div2_on: bool, nu4: float, del2_velocity: float,
           dyn_filter: bool, rcirc: float, band: int | None):
    """Plain version of K4: the upward pass to phi_m and the
    vector-invariant wind update with damping and the polar filter (du on
    edge rows, dv on center rows). `nu2_rows` (km, jm) is the per-level
    del2 coefficient; `rcirc` = 1/(im·cap_area) scales the polar-cap
    circulation sums. Returns (u', v')."""
    phi_m = _up_geopotential(dgz, phis)
    ua, va = _d2a(u, v)
    cose, dxe, dy = (_row(metrics, r) for r in ("cose", "dxe", "dy"))

    # absolute vorticity at centers with polar-cap means
    u_n = wset_row(_rolly(u, -1), -1, 0.0)
    v_e = _rollx(v, -1)
    circ = (u * cose - u_n * _row(metrics, "cosen")) * dl * c.REARTH + \
        (v_e - v) * dp * c.REARTH
    zeta = circ / _row(metrics, "area")
    ucose = u * cose * dl * c.REARTH
    circ_s = -torch.sum(ucose[..., 1, :].double(), -1, keepdim=True) * rcirc
    circ_n = torch.sum(ucose[..., -1, :].double(), -1, keepdim=True) * rcirc
    zeta = wset_row(wset_row(zeta, 0, circ_s), -1, circ_n)
    zeta_a = zeta + _row(metrics, "f0")

    if ke_method == "upwind":
        u_sel = torch.where(va >= 0.0, u, u_n)
        v_sel = torch.where(ua >= 0.0, v, v_e)
        ke = wset_interior(0.5 * (ua ** 2 + va ** 2),
                           0.5 * (u_sel ** 2 + v_sel ** 2))
    elif ke_method == "avg_sq":
        ke_u = wset_interior(torch.zeros_like(u), 0.5 * (u ** 2 + u_n ** 2))
        ke_v = 0.5 * (v ** 2 + v_e ** 2)
        ke_v = wset_row(wset_row(ke_v, 0, 0.0), -1, 0.0)
        ke = 0.5 * (ke_u + ke_v)
    else:
        ke = 0.5 * (ua ** 2 + va ** 2)
    energy = ke + phi_m + c.CPAIR * pt_new * pkz

    v_c4 = _corner_from_center(0.5 * (v + v_e))
    v_edge = 0.5 * (v_c4 + _rollx(v_c4, -1))
    fy_z = tp.ytp(zeta_a, cry, v_edge * dt, jord, 0)
    fx_z = tp.xtp(zeta_a, crx, uc * dt, metrics[_R["cosp"]], _ffsl_rows(crx),
                  iord, 1, band=band)

    en_c = _corner_from_center(energy)
    th_c = _corner_from_center(pt_new)
    pi_c = _corner_from_center(pkz)
    dx_en = (_rollx(en_c, -1) - en_c) / dxe
    dx_th = (_rollx(th_c, -1) - th_c) / dxe
    pi_u = 0.5 * (pi_c + _rollx(pi_c, -1))
    du = wset_row(fy_z - dt * (dx_en - c.CPAIR * pi_u * dx_th), 0, 0.0)

    def dy_of(ac):
        return wset_interior(torch.zeros_like(v), (_rolly(ac, -1) - ac) / dy)

    dy_en = dy_of(en_c)
    dy_th = dy_of(th_c)
    pi_v = wset_interior(torch.zeros_like(v), 0.5 * (_rolly(pi_c, -1) + pi_c))
    dv = -fx_z - dt * (dy_en - c.CPAIR * pi_v * dy_th)
    dv = wset_row(wset_row(dv, 0, 0.0), -1, 0.0)

    # divergence damping on the corner divergence of the OLD winds
    vterm = v * _row(metrics, "cosp")
    div = (u - _rollx(u, 1)) / dxe + \
        (vterm - _rolly(vterm, 1)) / _row(metrics, "dye")
    div = wset_interior(torch.zeros_like(u), div)
    damp = torch.zeros_like(div)
    if div2_on:
        damp = damp + nu2_rows[..., None] * div
    if nu4 > 0.0:
        lap_div = (_rollx(div, -1) - 2.0 * div + _rollx(div, 1)) * \
            _row(metrics, "rdx2")
        lap_div = lap_div + wset_interior(
            torch.zeros_like(div),
            (_rolly(div, -1) - 2.0 * div + _rolly(div, 1)) *
            _row(metrics, "rdy2"))
        lap_div = wset_interior(torch.zeros_like(div), lap_div)
        damp = damp - _row(metrics, "c4") * lap_div
    du = du + dt * ((_rollx(damp, -1) - damp) / dxe)
    dv = dv + dt * wset_interior(torch.zeros_like(v),
                                 (_rolly(damp, -1) - damp) / dy)

    if del2_velocity > 0.0:
        rdx2, rdy2 = _row(metrics, "rdx2"), _row(metrics, "rdy2")

        def lap(a):
            d2x = (_rollx(a, -1) - 2.0 * a + _rollx(a, 1)) * rdx2
            d2y = wset_interior(
                torch.zeros_like(a),
                (_rolly(a, -1) - 2.0 * a + _rolly(a, 1)) * rdy2)
            return d2x + d2y

        du = du + dt * del2_velocity * lap(u)
        dv = dv + dt * del2_velocity * lap(v)

    if dyn_filter:
        fc, fs, gc, gs, rspc, rspe = dft
        du = _dft_filter(du, fc, fs, gc, gs, rspe)
        dv = _dft_filter(dv, fc, fs, gc, gs, rspc)
    return u + du, v + dv


def cd_step_fused(state, grid: FVGrid, ptop: float, phis, dt: float,
                  iord: int, jord: int, div2_coef_nd: float,
                  dyn_filter: bool, ke_method: str, del2_velocity: float,
                  div2_on: bool = True, div4_coef_nd: float = 0.0,
                  div_taper=None):
    """The fused small step (c_sw half step on, no filter_dm/filter_csw_dm)
    through K1-K4. Same returns as cd_core.cd_step: (new_state, diags with
    cx, cy, mfx, mfy, pe, pk, pkz, peln, wz)."""
    # the wrapper module imports this one's plain versions
    from ...ops import cd_fused_kernels as ck

    u, v, pt, delp = state.u, state.v, state.pt, state.delp
    km, jm, im = delp.shape
    dl, dp = grid.dl, grid.dp
    dt5 = 0.5 * dt
    if div_taper is not None:
        c2_k = torch.clamp(torch.as_tensor(div_taper, dtype=delp.dtype,
                                           device=delp.device),
                           min=div2_coef_nd)
    else:
        c2_k = torch.full((km,), div2_coef_nd, dtype=delp.dtype,
                          device=delp.device)
    nu2_rows = (c2_k * (c.REARTH * dp) ** 2 / dt)[:, None].expand(
        km, jm).contiguous()
    nu4 = div4_coef_nd / dt          # multiplies the local L(j)⁴
    metrics = _metric_rows(grid.cosp, grid.acosp, grid.cose, grid.f0,
                           grid.fc, dl, dp, nu4)
    dft = (grid.dft_fc, grid.dft_fs, grid.dft_gc, grid.dft_gs,
           grid.pft_center, grid.pft_edge)
    cap_area = c.REARTH ** 2 * grid.acap * dp * dl / im
    rcirc = 1.0 / (im * cap_area)
    band5 = tp.ffsl_band(jm, dl, dt5)
    band1 = tp.ffsl_band(jm, dl, dt)
    phis = phis.contiguous()

    pt_h, uc0, vc0, pkz_h, dgz_h = ck.k1(u, v, pt, delp, metrics, dt5,
                                         grid.rcap, ptop, band5)
    uc, crx, cry = ck.k2(pt_h, pkz_h, dgz_h, uc0, vc0, phis, metrics, dft,
                         dt, dt5, dyn_filter)
    delp_new, pt_new, mfx, mfy, pkz, dgz = ck.k3(delp, pt, crx, cry,
                                                 metrics, iord, jord,
                                                 grid.rcap, ptop, band1)
    u_new, v_new = ck.k4(u, v, pt_new, pkz, dgz, phis, crx, cry, uc,
                         metrics, nu2_rows, dft, dt, dl, dp, iord, jord,
                         ke_method, div2_on, nu4, del2_velocity, dyn_filter,
                         rcirc, band1)

    new_state = state.replace(u=u_new, v=v_new, pt=pt_new, delp=delp_new)
    # edge-pressure diagnostics derived from delp', as the JAX package
    # derives them outside its kernels
    pe, pk, _, peln = pressure_vars(delp_new, ptop)
    wz = geopotential_k(pt_new, pk, phis)
    diags = dict(cx=crx, cy=cry, mfx=mfx, mfy=mfy, pe=pe, pk=pk, pkz=pkz,
                 peln=peln, wz=wz)
    return new_state, diags
