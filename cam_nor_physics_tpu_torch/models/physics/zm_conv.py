"""Zhang-McFarlane deep convection core (NorESM "tht" variant).

Twin of `cam_nor_physics_tpu.models.physics.zm_conv`, in the (ncol, pver)
layout (reference zm_conv.F90). Every column is computed
and non-triggered columns are masked at the end; level recursions are
Python loops over levels on (ncol,) rows (`_scan`, the JAX package's
`lax.scan`), so a call issues thousands of small launches on a card and
no host synchronisation on the default path. zm_convr's two parcel calls
go through ops.zm_parcel_kernels.zm_parcel: on a card, one CUDA kernel
launch each in place of buoyan_dilute's ~6,950. Level indices (mx, lcl, lel,
jt, j0, jd, jlcl) are int64 tensors; `_take_col` gathers with them.

Level k=0 is the model top, k=pver-1 the surface layer; `msg` is the
number of excluded top levels. Units follow the reference internals:
pressure in hPa (mb), heights in m including surface elevation, mass
fluxes normalized by the cloud-base flux until scaled by `mb` (mb/s).

With cfg.microp the in-plume two-moment microphysics (`zm_mphy`, one more
level scan) runs inside cldprp's plume iteration, twice: the second pass
re-ascends with the first pass's freezing heat in the hu budget. Every
mask of it is a tensor, so a microp step too reads no device value on the
host and is captured as a CUDA graph. cfg.parcel_pbl launches the parcel
from the PBL-mixed layer instead of the level of largest MSE.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ...ops.saturation import qsat as qsat_blend
from ...ops.saturation import qsat_hpa
from ...ops.thermo import enthalpy, entropy, ienthalpy, ientropy
from ...utils import constants as c
from ...utils.config import ZMConfig
from .zm_microphysics import (AIMM, BIMM, COOPER_A, COOPER_B, KK_A,
                              KK_ACC, M_ACT, M_ICE0, NACT_LND, NACT_OCN,
                              NI_MAX, QI0_SNOW, RHO_LIQ, T_BERG_PEAK,
                              T_BERG_WIDTH, T_HOM, TAU_BERG, TAU_SNOW,
                              activated_number)
from .zm_transport import _safe_div

CP = c.CPAIR
RGAS = c.RAIR
GRAV = c.GRAVIT
RGRAV = 1.0 / c.GRAVIT
RL = c.LATVAP
EPS1 = c.EPSILO
TFREEZ = c.TMELT
CPVIR = c.CPVIR
DCOL = (c.CPLIQ - c.CPWV) / c.LATVAP   # zm_conv.F90:106-108


# ---------------------------------------------------------------------------
# level-axis helpers ((ncol, nk) arrays, levels on axis 1)
# ---------------------------------------------------------------------------

def _c(v):
    """Column scalar (ncol,) -> (ncol, 1)."""
    return v[:, None]


def _karr(nk, like):
    return torch.arange(nk, device=like.device)[None, :]


def _below(a):
    """a(k+1) with the bottom level repeated."""
    return torch.cat([a[:, 1:], a[:, -1:]], 1)


def _above(a):
    """a(k-1) with the top level repeated."""
    return torch.cat([a[:, :1], a[:, :-1]], 1)


def _full(ncol, value, like, dtype=None):
    return torch.full((ncol,), value, dtype=dtype or like.dtype,
                      device=like.device)


def _take_col(arr, idx):
    """arr[i, idx[i]]; 0 where idx is outside the level range (the JAX
    package's one-hot sum)."""
    nk = arr.shape[1]
    got = torch.gather(arr, 1, idx.clamp(0, nk - 1)[:, None])[:, 0]
    return torch.where((idx >= 0) & (idx < nk), got, torch.zeros_like(got))


def _first_true_from_bottom(mask, default):
    """Largest k with mask true per column, else `default`."""
    idx = torch.where(mask, _karr(mask.shape[1], mask), -1).amax(1)
    found = idx >= 0
    return torch.where(found, idx, default), found


def _first_true_from_top(mask, default):
    """Smallest k with mask true per column, else `default`."""
    nk = mask.shape[1]
    idx = torch.where(mask, _karr(nk, mask), nk).amin(1)
    found = idx < nk
    return torch.where(found, idx, default), found


def _cumsum_lvl(x, reverse: bool = False):
    """Prefix (suffix if `reverse`) sum along levels. torch.cumsum, in the
    tensor's own precision on every device: the JAX package's triangular
    matmul runs at Precision.HIGHEST because reduced-precision passes
    flip trigger decisions, and a cumsum has no such passes."""
    if reverse:
        return torch.flip(torch.cumsum(torch.flip(x, (1,)), 1), (1,))
    return torch.cumsum(x, 1)


def _scan(step, carry, xs: dict, reverse: bool = False):
    """Level scan: step(carry, x_row, k) -> (carry, ys) with x_row the
    (ncol,) rows at level k; `reverse` walks bottom-up (k = nk-1 .. 0).
    Returns (carry, ys stacked at their own level on axis 1)."""
    nk = next(iter(xs.values())).shape[1]
    rows = {n: v.T.contiguous() for n, v in xs.items()}
    outs = [None] * nk
    for k in (range(nk - 1, -1, -1) if reverse else range(nk)):
        carry, outs[k] = step(carry, {n: r[k] for n, r in rows.items()}, k)
    return carry, tuple(torch.stack([o[i] for o in outs], 1)
                        for i in range(len(outs[0])))


def _log_mean_interface(x, thresh=1.0e-6):
    """xhat(k) = log-mean of (x(k-1), x(k)) on upper interfaces, k >= 1
    (the shat/qhat construction, zm_conv.F90:1007-1027):
    x0*x1*ln(x0/x1)/(x0-x1) where the relative difference exceeds 1e-6,
    else the arithmetic mean; xhat(0) = x(0)."""
    x0 = x[:, :-1]
    x1 = x[:, 1:]
    big = float(torch.tensor(1e-300, dtype=x.dtype))   # 0 in float32
    diff = torch.abs(_safe_div(x0 - x1,
                               torch.clamp(torch.maximum(x0, x1), min=big)))
    use_log = (diff > thresh) & (x0 > 0) & (x1 > 0) & (torch.abs(x0 - x1) > 0)
    logmean = _safe_div(torch.log(torch.where(use_log, _safe_div(x0, x1),
                                              1.0)), x0 - x1) * x0 * x1
    xhat = torch.where(use_log, logmean, 0.5 * (x0 + x1))
    return torch.cat([x[:, :1], xhat], 1)


def cldfrc_fice(t):
    """Ice/snow fraction ramps (cldfrc_fice, zm_conv.F90:1810): fice ramps
    0->1 over [Tmelt-40, Tmelt-10]; fsnow over [Tmelt-5, Tmelt]."""
    tmax_fice, tmin_fice = TFREEZ - 10.0, TFREEZ - 40.0
    tmax_fsnow, tmin_fsnow = TFREEZ, TFREEZ - 5.0
    fice = torch.clamp((tmax_fice - t) / (tmax_fice - tmin_fice), 0.0, 1.0)
    fsnow = torch.clamp((tmax_fsnow - t) / (tmax_fsnow - tmin_fsnow),
                        0.0, 1.0)
    return fice, fsnow


# =============================================================================
# buoyan_dilute + parcel_dilute  (zm_conv.F90:4425-5277)
# =============================================================================

@dataclass
class BuoyanOut:
    tp: torch.Tensor       # parcel temperature (ncol, pver)
    qstp: torch.Tensor     # parcel sat mixing ratio (q below lcl)
    tl: torch.Tensor       # parcel T at LCL (ncol,)
    cape: torch.Tensor     # (ncol,)
    cin: torch.Tensor      # (ncol,)
    lcl: torch.Tensor      # level indices (ncol,)
    lel: torch.Tensor
    mx: torch.Tensor       # launch level
    buoy: torch.Tensor     # parcel buoyancy tpv - tv + tiedke_add (ncol, pver)
    pl: torch.Tensor       # parcel LCL pressure (ncol,) hPa


def _parcel_dilute(cfg: ZMConfig, klaunch, p, z, t, q, tpert, dmpdz,
                   pbl=None):
    """Entraining-plume parcel ascent (parcel_dilute, zm_conv.F90:
    4824-5277), tht path, launched at klaunch. With cfg.parcel_pbl, `pbl`
    is the PBL-mixed parcel (tl0, ql0, pl0): its enthalpy and total water
    start the ascent, and its temperature and pressure stand in where no
    LCL is found. Returns (tp, qstp, tpv, tl, pl, lcl)."""
    ncol, pver = t.shape
    t_launch = _take_col(t, klaunch)
    p_launch = _take_col(p, klaunch)
    if cfg.parcel_pbl:
        tl0, qtp0, pl0 = pbl
        sp0 = enthalpy(tl0, pl0, qtp0, torch.zeros_like(tl0))
    else:
        qtp0 = _take_col(q, klaunch)
        sp0 = enthalpy(t_launch, p_launch, qtp0, _take_col(z, klaunch))
    mp0 = torch.ones((ncol,), dtype=t.dtype, device=t.device)
    _, qs_launch = qsat_hpa(t_launch, p_launch)

    karr = _karr(pver, t)
    above_all = karr < _c(klaunch)
    at_launch_all = karr == _c(klaunch)

    if cfg.parcel_impl == "batched":
        # the entrainment budget (sp, qtp, mp) is a masked suffix sum of
        # per-level environment increments, so the ascent inverts once,
        # batched over (ncol, pver), from the environment temperature
        dp_l = p - _below(p)
        qtenv = 0.5 * (q + _below(q))
        tenv = 0.5 * (t + _below(t))
        penv = 0.5 * (p + _below(p))
        zenv = 0.5 * (z + _below(z))
        senv = enthalpy(tenv, penv, qtenv, zenv)
        dzdp_l = -(RGAS * tenv) / (penv * GRAV)      # m/mb
        dmpdp = dmpdz * dzdp_l

        inc = torch.where(above_all, dmpdp * dp_l, 0.0)
        sp_s = -_cumsum_lvl(inc * senv, reverse=True)
        qtp_s = -_cumsum_lvl(inc * qtenv, reverse=True)
        mp_s = -_cumsum_lvl(inc, reverse=True)
        denom = _c(mp0) + mp_s
        smix_a = (_c(sp0) + sp_s) / denom
        qtmix_a = (_c(qtp0) + qtp_s) / denom
        t_inv, qs_inv, _ = ienthalpy(smix_a, p, qtmix_a, z, t,
                                     solver=cfg.inversion_solver)
        t_inv = torch.where(torch.isnan(t_inv), t, t_inv)

        smix = torch.where(at_launch_all, _c(sp0),
                           torch.where(above_all, smix_a, senv))
        qtmix = torch.where(at_launch_all, _c(qtp0),
                            torch.where(above_all, qtmix_a, q))
        tmix = torch.where(at_launch_all, _c(t_launch),
                           torch.where(above_all, t_inv, t))
        qsmix = torch.where(at_launch_all, _c(qs_launch),
                            torch.where(above_all, qs_inv, q))
        return _parcel_finish(cfg, klaunch, p, z, t, q, tpert, t_launch,
                              qs_launch, qtp0, smix, qtmix, tmix, qsmix,
                              dzdp_l, pbl)

    xs = dict(p=p, z=z, t=t, q=q, p_b=_below(p), z_b=_below(z),
              t_b=_below(t), q_b=_below(q), dmpdz=dmpdz)

    def ascent_step(cy, x, k):
        at_launch = k == klaunch
        above = k < klaunch
        dp = x["p"] - x["p_b"]
        qtenv = 0.5 * (x["q"] + x["q_b"])
        tenv = 0.5 * (x["t"] + x["t_b"])
        penv = 0.5 * (x["p"] + x["p_b"])
        zenv = 0.5 * (x["z"] + x["z_b"])
        senv = enthalpy(tenv, penv, qtenv, zenv)
        dpdz = -(penv * GRAV) / (RGAS * tenv)   # mb/m, zm_conv.F90:5065
        dzdp = 1.0 / dpdz
        dmpdp = x["dmpdz"] * dzdp

        sp = torch.where(above, cy["sp"] - dmpdp * dp * senv, cy["sp"])
        qtp = torch.where(above, cy["qtp"] - dmpdp * dp * qtenv, cy["qtp"])
        mp = torch.where(above, cy["mp"] - dmpdp * dp, cy["mp"])

        smix_a = (sp0 + sp) / (mp0 + mp)
        qtmix_a = (qtp0 + qtp) / (mp0 + mp)
        t_inv, qs_inv, _ = ienthalpy(smix_a, x["p"], qtmix_a, x["z"],
                                     cy["tmix_b"],
                                     solver=cfg.inversion_solver)
        t_inv = torch.where(torch.isnan(t_inv), cy["tmix_b"], t_inv)

        smix = torch.where(at_launch, sp0, torch.where(above, smix_a, senv))
        qtmix = torch.where(at_launch, qtp0,
                            torch.where(above, qtmix_a, x["q"]))
        tmix = torch.where(at_launch, t_launch,
                           torch.where(above, t_inv, x["t"]))
        qsmix = torch.where(at_launch, qs_launch,
                            torch.where(above, qs_inv, x["q"]))
        new_cy = dict(sp=sp, qtp=qtp, mp=mp, tmix_b=tmix)
        return new_cy, (smix, qtmix, tmix, qsmix, dzdp)

    z1 = torch.zeros_like(t_launch)
    _, (smix, qtmix, tmix, qsmix, dzdp_l) = _scan(
        ascent_step, dict(sp=z1, qtp=z1, mp=z1, tmix_b=t_launch), xs,
        reverse=True)
    return _parcel_finish(cfg, klaunch, p, z, t, q, tpert, t_launch,
                          qs_launch, qtp0, smix, qtmix, tmix, qsmix, dzdp_l,
                          pbl)


def _precip_terms(cy, xsh2o, tmix, qsmix, qtmix):
    """The entropy carry terms of one level of the precipitation/freezing
    adjustment (zm_conv.F90:5160-5270), shared by both parcel forms:
    returns (ds_xsh2o, ds_freeze)."""
    lwmax_free = torch.clamp(xsh2o - cy["xsh2o_b"], min=0.0)
    ds_xsh2o = cy["ds_xsh2o_b"] - c.CPLIQ * torch.log(tmix / TFREEZ) * \
        lwmax_free
    cold = tmix <= TFREEZ + 0.0
    first_frz = cold & (cy["ds_freeze_b"] == 0.0)
    cont_frz = cold & (cy["ds_freeze_b"] != 0.0)
    ds_freeze = torch.where(
        first_frz,
        (c.LATICE / tmix) * torch.clamp(qtmix - qsmix - xsh2o, min=0.0),
        torch.where(cont_frz,
                    cy["ds_freeze_b"] + (c.LATICE / tmix) *
                    torch.clamp(cy["qsmix_b"] - qsmix, min=0.0), 0.0))
    return ds_xsh2o, ds_freeze


def _parcel_finish(cfg: ZMConfig, klaunch, p, z, t, q, tpert, t_launch,
                   qs_launch, qtp0, smix, qtmix, tmix, qsmix, dzdp_l,
                   pbl=None):
    """LCL detection + precipitation/freezing adjustment on the ascent
    profiles (zm_conv.F90:5100-5270); shared tail of both parcel forms.
    `pbl` as in _parcel_dilute."""
    ncol, pver = t.shape
    lwmax = 1.0e-3
    nit_lheat = 2

    # ---- LCL detection + interpolation (zm_conv.F90:5100-5135) ----
    p_launch = _take_col(p, klaunch)
    karr = _karr(pver, t)
    above_m = karr < _c(klaunch)
    qsmix_b = torch.cat([qsmix[:, 1:], _c(qs_launch)], 1)
    qtmix_b = torch.cat([qtmix[:, 1:], _c(qtp0)], 1)
    crossing = above_m & (qsmix <= qtmix) & (qsmix_b > qtmix_b)
    # the reference loop runs k decreasing: the last write is the smallest k
    lcl_idx, found = _first_true_from_top(crossing, klaunch)
    lcl = torch.where(found, lcl_idx, klaunch)

    def at(arr):
        return _take_col(arr, lcl)

    p_b_full = _below(p)
    z_b_full = _below(z)
    smix_bf = _below(smix)
    dp_lcl = at(p) - at(p_b_full)
    qxsk = at(qtmix) - at(qsmix)
    qxskp1 = at(qtmix_b) - at(qsmix_b)
    dqxsdp = _safe_div(qxsk - qxskp1, dp_lcl)
    pl = torch.where(found, at(p_b_full) - _safe_div(qxskp1, dqxsdp),
                     pbl[2] if cfg.parcel_pbl else p_launch)
    zl = torch.where(found, at(z_b_full) - _safe_div(qxskp1, dqxsdp) *
                     at(dzdp_l), torch.zeros_like(pl))
    dsdp = _safe_div(at(smix) - at(smix_bf), dp_lcl)
    dqtdp = _safe_div(at(qtmix) - at(qtmix_b), dp_lcl)
    slcl = at(smix_bf) + dsdp * (pl - at(p_b_full))
    qtlcl = at(qtmix_b) + dqtdp * (pl - at(p_b_full))
    tl_inv, _, _ = ienthalpy(slcl, pl, qtlcl, zl, at(tmix),
                             solver=cfg.inversion_solver)
    tl = torch.where(found & ~torch.isnan(tl_inv), tl_inv,
                     pbl[0] if cfg.parcel_pbl else t_launch)

    # ---- precipitation / freezing adjustment (zm_conv.F90:5160-5270) ----
    smix_ent = entropy(tmix, p, qtmix)
    z1 = torch.zeros_like(qs_launch)
    carry0 = dict(xsh2o_b=z1, ds_xsh2o_b=z1, ds_freeze_b=z1,
                  qsmix_b=qs_launch)

    if cfg.parcel_impl == "batched":
        # fixed-point sweeps: given the current (tmix, qsmix) profiles the
        # carry terms follow from an arithmetic-only scan; the entropy
        # inversion then runs once, batched over (ncol, pver)
        at_launch_m = karr == _c(klaunch)
        tmix_c, qsmix_c = tmix, qsmix
        for _ in range(cfg.precip_sweeps):
            xsh2o = torch.clamp(qtmix - qsmix_c - lwmax, min=0.0)
            xsC = dict(above=above_m.to(t.dtype),
                       at_launch=at_launch_m.to(t.dtype),
                       xsh2o=xsh2o, tmix=tmix_c, qsmix=qsmix_c, qtmix=qtmix)

            def carry_step(cy, x, k):
                above = x["above"] > 0.5
                at_launch = x["at_launch"] > 0.5
                ds_xsh2o, ds_freeze = _precip_terms(
                    cy, x["xsh2o"], x["tmix"], x["qsmix"], x["qtmix"])
                new_cy = dict(
                    xsh2o_b=torch.where(above, x["xsh2o"], 0.0),
                    ds_xsh2o_b=torch.where(above, ds_xsh2o, 0.0),
                    ds_freeze_b=torch.where(above, ds_freeze, 0.0),
                    qsmix_b=torch.where(above | at_launch, x["qsmix"],
                                        cy["qsmix_b"]))
                return new_cy, (ds_xsh2o, ds_freeze)

            _, (dsx, dsf) = _scan(carry_step, carry0, xsC, reverse=True)
            new_s = smix_ent + dsx + dsf
            new_q = qtmix - xsh2o
            t_i, qs_i, _ = ientropy(new_s, p, new_q, tmix_c,
                                    solver=cfg.inversion_solver)
            tmix_c = torch.where(above_m & ~torch.isnan(t_i), t_i, tmix_c)
            qsmix_c = torch.where(above_m, qs_i, qsmix_c)

        tp = torch.where(above_m, tmix_c, tmix)
        new_q = qtmix - torch.clamp(qtmix - qsmix_c - lwmax, min=0.0)
        qstp = torch.where(above_m,
                           torch.where(new_q > qsmix_c, qsmix_c, new_q), q)
        denom_q = torch.where(above_m, new_q, qstp)
        tpv = (tp + _c(tpert)) * (1.0 + qstp / EPS1) / (1.0 + denom_q)
        below_m = karr > _c(klaunch)
        tp = torch.where(below_m, t, tp)
        qstp = torch.where(below_m, q, qstp)
        return tp, qstp, tpv, tl, pl, lcl

    xsP = dict(p=p, q=q, smix=smix_ent, qtmix=qtmix, tmix0=tmix,
               qsmix0=qsmix)

    def precip_step(cy, x, k):
        at_launch = k == klaunch
        above = k < klaunch
        tmix_k = x["tmix0"]
        qsmix_k = x["qsmix0"]
        xsh2o = ds_xsh2o = ds_freeze = torch.zeros_like(tmix_k)
        new_q = x["qtmix"]
        for _ in range(nit_lheat):
            xsh2o = torch.clamp(x["qtmix"] - qsmix_k - lwmax, min=0.0)
            ds_xsh2o, ds_freeze = _precip_terms(cy, xsh2o, tmix_k, qsmix_k,
                                                x["qtmix"])
            new_s = x["smix"] + ds_xsh2o + ds_freeze
            new_q = x["qtmix"] - xsh2o
            t_i, qs_i, _ = ientropy(new_s, x["p"], new_q, tmix_k,
                                    solver=cfg.inversion_solver)
            tmix_k = torch.where(above & ~torch.isnan(t_i), t_i, tmix_k)
            qsmix_k = torch.where(above, qs_i, qsmix_k)

        tp_k = torch.where(above, tmix_k, x["tmix0"])
        qstp_k = torch.where(above,
                             torch.where(new_q > qsmix_k, qsmix_k, new_q),
                             x["q"])
        denom_q = torch.where(above, new_q, qstp_k)
        tpv_k = (tp_k + tpert) * (1.0 + qstp_k / EPS1) / (1.0 + denom_q)
        new_cy = dict(
            xsh2o_b=torch.where(above, xsh2o, cy["xsh2o_b"] * 0.0),
            ds_xsh2o_b=torch.where(above, ds_xsh2o, cy["ds_xsh2o_b"] * 0.0),
            ds_freeze_b=torch.where(above, ds_freeze,
                                    cy["ds_freeze_b"] * 0.0),
            qsmix_b=torch.where(above | at_launch, qsmix_k, cy["qsmix_b"]))
        return new_cy, (tp_k, qstp_k, tpv_k)

    _, (tp, qstp, tpv) = _scan(precip_step, carry0, xsP, reverse=True)
    below_m = karr > _c(klaunch)
    tp = torch.where(below_m, t, tp)
    qstp = torch.where(below_m, q, qstp)
    return tp, qstp, tpv, tl, pl, lcl


def buoyan_dilute(cfg: ZMConfig, msg: int, q, t, p, z, pf, zi_, zs,
                  pblt, tpert, landfrac, dmpdz) -> BuoyanOut:
    """Dilute CAPE/CIN (buoyan_dilute, zm_conv.F90:4425-4819). p/pf in
    hPa, z/zi_ heights incl. surface elevation zs (m), pblt the 0-based
    PBL-top level (float), dmpdz (ncol, pver) entrainment rate (/m).
    zi_ (above the surface) and zs serve the PBL-mixed parcel
    (cfg.parcel_pbl)."""
    ncol, pver = t.shape
    karr = _karr(pver, t)
    pblt_i = torch.round(pblt).long()
    lon = torch.clamp(pblt_i + 2, max=pver - 1)   # zm_conv.F90:4578

    # moist static energy (tht total-MSE form, zm_conv.F90:4668-4672)
    hmn = ((CP + q * c.CPLIQ) * t / (1.0 + q)
           + (1.0 + q / EPS1) / (1.0 + q) * GRAV * z
           + (RL - (c.CPLIQ - c.CPWV) * (t - TFREEZ)) * q)

    pbl = None
    if cfg.parcel_pbl:
        # PBL-mixed parcel (zm_conv.F90:4639-4702): the pressure-weighted
        # mean MSE and q of the layers below parcel_dz above the surface
        pbl_dz = _take_col(z, pblt_i) - zs
        parcel_dz = torch.maximum(zi_[:, pver - 1],
                                  cfg.parcel_hscale * pbl_dz)
        dp_lev = pf[:, 1:] - pf[:, :-1]
        zi_top = zi_[:, :-1]
        zi_bot = zi_[:, 1:]
        in_mix = zi_bot <= _c(parcel_dz)
        frac = torch.where(karr == pver - 1, 1.0, torch.clamp(
            _safe_div(_c(parcel_dz) - zi_bot, zi_top - zi_bot), max=1.0))
        w = torch.where(in_mix, dp_lev * frac, 0.0)
        wsum = w.sum(1)
        hpar = (hmn * w).sum(1) / torch.clamp(wsum, min=1e-30)
        qpar = (q * w).sum(1) / torch.clamp(wsum, min=1e-30)
        mx, _ = _first_true_from_top(in_mix, pver - 1)
        tl0 = (hpar - RL * qpar - GRAV * (parcel_dz + zs)) / CP
        pbl = (tl0, qpar, _take_col(p, mx))
    else:
        # launch at max MSE between the PBL top and lon; Fortran scans
        # bottom-up with strict >, so ties pick the lowest level
        mask = (karr >= _c(pblt_i)) & (karr <= _c(lon))
        hmn_m = torch.where(mask, hmn, -torch.inf)
        vmax = hmn_m.amax(1)
        mx = torch.where(hmn_m == _c(vmax), karr, -1).amax(1)
        mx = torch.where(mask.any(1), mx, lon)
    tp, qstp, tpv, tl, pl, lcl = _parcel_dilute(cfg, mx, p, z, t, q, tpert,
                                                dmpdz, pbl)

    plge600 = pl >= cfg.plclmin   # zm_conv.F90:4755

    # env virtual temperature and buoyancy (zm_conv.F90:4763-4780)
    tv = t * (1.0 + q / EPS1) / (1.0 + q)
    in_plume = (karr <= _c(mx)) & _c(plge600)
    buoy = torch.where(in_plume, tpv - tv + cfg.tiedke_add, 0.0)
    tp = torch.where(in_plume, tp, t)
    qstp = torch.where(in_plume, qstp, q)

    # neutral-buoyancy crossings, top-down, up to num_cin (:4786-4797)
    kmask = (karr >= msg + 1) & (karr < _c(lcl)) & _c(plge600)
    crossing = kmask & (_below(buoy) > 0.0) & (buoy <= 0.0)
    order = _cumsum_lvl(crossing.to(t.dtype))     # crossing ordinal

    dlnp = torch.log(pf[:, 1:] / pf[:, :-1])      # ln(pf(k+1)/pf(k)) > 0
    cape = torch.zeros_like(tl)
    cin = torch.zeros_like(tl)
    lel = _full(ncol, pver - 1, t, torch.long)
    best = _full(ncol, -torch.inf, t)
    for n in range(1, cfg.num_cin + 1):
        if n < cfg.num_cin:
            sel = crossing & (torch.abs(order - n) < 0.5)
            lel_n, found_n = _first_true_from_top(sel, pver - 1)
        else:
            # once the reference's knt saturates (knt = min(num_cin,
            # knt+1), :4779) every lower crossing overwrites the last slot
            sel = crossing & (order > n - 0.5)
            lel_n, found_n = _first_true_from_bottom(sel, pver - 1)
        seg = (karr <= _c(mx)) & (karr > _c(lel_n)) & _c(plge600)
        cape_n = torch.where(seg, RGAS * buoy * dlnp, 0.0).sum(1)
        cin_n = torch.where(seg, -RGAS * torch.clamp(buoy, max=0.0) * dlnp,
                            0.0).sum(1)
        better = found_n & (cape_n > torch.clamp(best, min=0.0))
        cape = torch.where(better, cape_n, cape)
        cin = torch.where(better, cin_n, cin)
        lel = torch.where(better, lel_n, lel)
        best = torch.where(better, cape_n, best)

    return BuoyanOut(tp=tp, qstp=qstp, tl=tl, cape=torch.clamp(cape, min=0.0),
                     cin=cin, lcl=lcl, lel=lel, mx=mx, buoy=buoy, pl=pl)


# =============================================================================
# in-plume two-moment updraft microphysics (the zm_mphy call inside
# cldprp's iteration, zm_conv.F90:3782-3793)
# =============================================================================

@dataclass
class ZMMphyOut:
    """Per-level updraft microphysics state (the loc_conv role), in
    cldprp's normalized units."""

    qliq: torch.Tensor     # in-plume cloud liquid (kg/kg)
    qice: torch.Tensor     # in-plume cloud ice
    qnl: torch.Tensor      # in-plume droplet number (1/kg)
    qni: torch.Tensor      # in-plume crystal number
    qcde: torch.Tensor     # detrainable liquid (q1q2: dl = du qcde(k+1))
    qide: torch.Tensor     # detrainable ice
    qncde: torch.Tensor    # detrainable droplet number
    qnide: torch.Tensor    # detrainable crystal number
    rprd: torch.Tensor     # rain production (cu units)
    sprd: torch.Tensor     # snow production (cu units)
    frz: torch.Tensor      # liquid->ice freezing rate (cu units)
    wu: torch.Tensor       # updraft vertical velocity (m/s)
    rates: dict            # per-process rates (conv% family, the JAX keys)


def zm_mphy(cfg: ZMConfig, su, qu, mu, du, eu, cmel, cmei, dz, zf_top, p,
            t, q, jt, jb, active, landfrac, aero=None) -> ZMMphyOut:
    """In-plume two-moment updraft microphysics (the zm_mphy call inside
    cldprp, zm_conv.F90:3782-3793; the JAX package's formulation of the
    Song & Zhang 2011 scheme, run inside the plume ascent).

    One bottom-up level scan carrying the four condensate fluxes (mu ql,
    mu qi, mu nl, mu ni) and the updraft w^2. Per level the reference's ql
    budget differencing (zm_conv.F90:3848-3857) for two phases and two
    numbers, G_x = mu(k+1) x(k+1) - dz du x(k+1) + dz src_x(k), then the
    processes on the in-plume mixing ratios over the residence time
    dz/max(wu, 0.5): Bigg immersion, Cooper contact/deposition, WBF and
    homogeneous freezing (-> frz), KK2000 autoconversion and accretion
    (-> rprd), ice to snow above a threshold (-> sprd). w^2 follows
    d(w^2)/dz = 2 B/3 - 2 (eu/mu) w^2 with B = g (Tu - T)/T. `aero` is the
    modal activation bundle (activated_number); without it the land and
    ocean activation constants apply."""
    ncol, pver = t.shape
    karr = _karr(pver, t)
    eps = 1.0e-12

    # plume temperature from the updraft s (tug, zm_conv.F90:3712-3718)
    tug = su - (GRAV / CP) * zf_top / (1.0 + CPVIR * qu)
    rho = p * 100.0 / (c.RAIR * t)                   # p in mb
    if aero is not None:
        nact = activated_number(aero)
    else:
        nact = _c(NACT_LND * landfrac + NACT_OCN * (1.0 - landfrac)).expand(
            ncol, pver)
    in_plume = (karr >= _c(jt)) & (karr < _c(jb)) & _c(active)

    xs = dict(tug=tug, t=t, dz=dz, mu=mu, du=du, eu=eu, cmel=cmel,
              cmei=cmei, rho=rho, nact=nact, inp=in_plume.to(t.dtype))
    z4 = torch.zeros_like(t[:, 0])
    carry0 = dict(f_ql=z4, f_qi=z4, f_nl=z4, f_ni=z4, w2=z4, mu_b=z4)

    def step(cy, x, k):
        live = x["inp"] > 0.5
        mu_k = x["mu"]
        pos = mu_k > 0.0
        mu_s = torch.clamp(mu_k, min=eps)

        # updraft w^2 (buoyancy - entrainment drag)
        buoy = GRAV * (x["tug"] - x["t"]) / torch.clamp(x["t"], min=1.0)
        lam = x["eu"] / mu_s
        w2 = torch.clamp(cy["w2"] + 2.0 * x["dz"] *
                         ((1.0 / 3.0) * buoy - lam * cy["w2"]), min=0.0)
        wu = torch.sqrt(w2)
        tau = x["dz"] / torch.clamp(wu, min=0.5)

        # budget step (reference differencing) for all four species: the
        # flux from below, less the detrainment of the level-below value,
        # plus the level source (flux units)
        def g(x_b, src):
            return cy["mu_b"] * x_b - x["dz"] * x["du"] * x_b + \
                x["dz"] * src

        has_b = cy["mu_b"] > 0
        mu_bs = torch.clamp(cy["mu_b"], min=eps)
        ql_b, qi_b, nl_b, ni_b = (
            torch.where(has_b, _safe_div(cy[f], mu_bs), 0.0)
            for f in ("f_ql", "f_qi", "f_nl", "f_ni"))

        cmel_p = torch.clamp(x["cmel"], min=0.0)
        cmei_p = torch.clamp(x["cmei"], min=0.0)
        Gl = g(ql_b, cmel_p)
        Gi = g(qi_b, cmei_p)
        # activation: new liquid at the activation radius; deposition ice
        # at the fresh-crystal size
        Gnl = g(nl_b, cmel_p / M_ACT)
        Gni = g(ni_b, cmei_p / M_ICE0)

        ql_u = torch.where(pos, torch.clamp(Gl, min=0.0) / mu_s, 0.0)
        qi_u = torch.where(pos, torch.clamp(Gi, min=0.0) / mu_s, 0.0)
        nl_u = torch.where(pos, torch.minimum(
            torch.clamp(Gnl, min=0.0) / mu_s, x["nact"]), 0.0)
        ni_u = torch.where(pos, torch.clamp(Gni, min=0.0) / mu_s, 0.0)

        # the activation-number source in mixing-ratio units (ACTIV_N; the
        # budget took it in through Gnl)
        dn_act = torch.where(pos, x["dz"] * cmel_p / M_ACT / mu_s, 0.0)

        # ---- freezing: Bigg immersion + Cooper + WBF + homogeneous ----
        cold = x["tug"] < TFREEZ
        dT = torch.clamp(TFREEZ - x["tug"], 0.0, 40.0)
        frz_imm = BIMM * torch.expm1(AIMM * dT) * x["rho"] * ql_u * ql_u / \
            torch.clamp(nl_u * RHO_LIQ * M_ACT, min=eps) * M_ACT
        frz_imm = torch.where(cold, frz_imm, 0.0)
        dq_imm = torch.minimum(ql_u, frz_imm * tau)
        dq_frz = dq_imm
        n_cooper = torch.clamp(COOPER_A * torch.exp(COOPER_B * dT) /
                               x["rho"], max=NI_MAX)
        n_cooper = torch.where(cold, n_cooper, 0.0)
        dn_nuc = torch.clamp(n_cooper - ni_u, min=0.0)
        dq_nuc = torch.minimum(torch.clamp(ql_u - dq_frz, min=0.0),
                               dn_nuc * M_ICE0)
        dn_nuc = dq_nuc / M_ICE0
        dq_ct = dq_nuc
        dq_frz = dq_frz + dq_nuc
        # Wegener-Bergeron-Findeisen: where ice already exists in mixed
        # phase, deposition grows it at the liquid's expense (a liquid->
        # ice transfer releasing latice like freezing), with a Gaussian
        # efficiency peaking near -15 C
        eff_berg = torch.exp(-((x["tug"] - T_BERG_PEAK) / T_BERG_WIDTH) ** 2)
        eff_berg = torch.where(cold & (qi_u > 1.0e-10), eff_berg, 0.0)
        dq_berg = torch.minimum(torch.clamp(ql_u - dq_frz, min=0.0),
                                eff_berg * ql_u / TAU_BERG * tau)
        dq_frz = dq_frz + dq_berg
        hom = x["tug"] <= T_HOM
        dq_hom = torch.where(hom, torch.clamp(ql_u - dq_frz, min=0.0), 0.0)
        dq_frz = torch.where(hom, ql_u, dq_frz)
        frac_frz = dq_frz / torch.clamp(ql_u, min=eps)
        dn_l = torch.minimum(nl_u * frac_frz, nl_u)
        dn_i = dn_l + torch.clamp(dn_nuc - dn_l, min=0.0)
        # droplet-number loss split for FHTIM_N/FHTCT_N
        dn_imm_n = dn_l * dq_imm / torch.clamp(dq_frz, min=eps)
        dn_ct_n = dn_nuc
        ql_u = ql_u - dq_frz
        qi_u = qi_u + dq_frz
        nl_u = nl_u - dn_l
        ni_u = ni_u + dn_i

        # ---- autoconversion + accretion (KK2000) ----
        nc_cm3 = torch.clamp(nl_u * x["rho"] * 1.0e-6, min=1.0)
        auto = KK_A * torch.clamp(ql_u, min=0.0) ** 2.47 * nc_cm3 ** (-1.79)
        dq_auto = torch.minimum(ql_u, auto * tau)
        dq_rain = dq_auto
        frac_rain = dq_rain / torch.clamp(ql_u, min=eps)
        dn_auto_n = nl_u * frac_rain
        nl_u = nl_u * (1.0 - frac_rain)
        ql_u = ql_u - dq_rain
        accr = KK_ACC * (torch.clamp(ql_u, min=0.0) *
                         torch.clamp(dq_rain, min=0.0)) ** 1.15
        dq_accr = torch.minimum(ql_u, accr * tau)
        frac_accr = dq_accr / torch.clamp(ql_u, min=eps)
        dn_accr_n = nl_u * frac_accr
        nl_u = nl_u * (1.0 - frac_accr)
        ql_u = ql_u - dq_accr
        dq_rain = dq_rain + dq_accr

        # ---- ice -> snow ----
        conv = torch.clamp(qi_u - QI0_SNOW, min=0.0) / TAU_SNOW
        dq_snow = torch.minimum(qi_u, conv * tau)
        frac_snow = dq_snow / torch.clamp(qi_u, min=eps)
        ni_u = ni_u * (1.0 - frac_snow)
        qi_u = qi_u - dq_snow

        lp = live & pos
        dz_s = torch.clamp(x["dz"], min=eps)

        def sel(v):
            return torch.where(lp, v, 0.0)

        def rate(dq):
            return torch.where(lp, dq * mu_k / dz_s, 0.0)

        new_cy = dict(f_ql=sel(ql_u * mu_k), f_qi=sel(qi_u * mu_k),
                      f_nl=sel(nl_u * mu_k), f_ni=sel(ni_u * mu_k),
                      w2=torch.where(live, w2, 0.0), mu_b=mu_k)
        # frz carries the whole latent-ice release of the level: droplet
        # freezing plus direct vapour->ice deposition (the cmei share of
        # the new condensate); the hu and q1q2 budgets heat by latice frz
        return new_cy, (sel(ql_u), sel(qi_u), sel(nl_u), sel(ni_u),
                        rate(dq_rain), rate(dq_snow),
                        rate(dq_frz) + sel(cmei_p),
                        torch.where(live, wu, 0.0),
                        rate(dq_auto), rate(dq_accr), rate(dq_imm),
                        rate(dq_ct), rate(dq_hom), rate(dq_berg),
                        rate(dn_act), rate(dn_auto_n), rate(dn_accr_n),
                        rate(dn_imm_n), rate(dn_ct_n))

    _, (qliq, qice, qnl, qni, rprd, sprd, frz, wu, *rs) = _scan(
        step, carry0, xs, reverse=True)
    rates = dict(zip(MPHY_RATE_KEYS, rs))
    return ZMMphyOut(qliq=qliq, qice=qice, qnl=qnl, qni=qni, qcde=qliq,
                     qide=qice, qncde=qnl, qnide=qni, rprd=rprd, sprd=sprd,
                     frz=frz, wu=wu, rates=rates)


# the per-process rates of zm_mphy, in its output order (the JAX keys)
MPHY_RATE_KEYS = ("AUTOL_M", "ACCRL_M", "FHTIM_M", "FHTCT_M", "HMPI_M",
                  "BERGN_M", "ACTIV_N", "AUTOL_N", "ACCRL_N", "FHTIM_N",
                  "FHTCT_N")


# =============================================================================
# cldprp  (zm_conv.F90:3024-4026)
# =============================================================================

@dataclass
class CldprpOut:
    mu: torch.Tensor
    eu: torch.Tensor
    du: torch.Tensor
    md: torch.Tensor
    ed: torch.Tensor
    sd: torch.Tensor
    qd: torch.Tensor
    mc: torch.Tensor
    qu: torch.Tensor
    su: torch.Tensor
    qst: torch.Tensor
    hmn: torch.Tensor
    hsat: torch.Tensor
    ql: torch.Tensor
    qcde: torch.Tensor
    cu: torch.Tensor
    evp: torch.Tensor
    cmeg: torch.Tensor
    rprd: torch.Tensor
    pflx: torch.Tensor     # (ncol, pver+1)
    jt: torch.Tensor
    jlcl: torch.Tensor
    j0: torch.Tensor
    jd: torch.Tensor
    # --- the microp extension (zeros, and mrates {}, when it is off) ---
    qide: torch.Tensor     # detrainable ice (q1q2: di = du qide(k+1))
    qncde: torch.Tensor    # detrainable droplet number
    qnide: torch.Tensor    # detrainable crystal number
    sprd: torch.Tensor     # snow production (cu units until zm_convr scales)
    frz: torch.Tensor      # freezing rate (cu units)
    qliq: torch.Tensor     # in-plume liquid
    qice: torch.Tensor     # in-plume ice
    qnl: torch.Tensor
    qni: torch.Tensor
    wu: torch.Tensor       # updraft vertical velocity (m/s)
    dcape: torch.Tensor    # (ncol,) freezing-CAPE increment
    mrates: dict           # per-process rates


def cldprp(cfg: ZMConfig, msg: int, q, t, p, z, s, zf, shat, qhat, jb, lel,
           landfrac, eu_only: bool = False, aero: dict | None = None):
    """Updraft/downdraft plume properties (cldprp, zm_conv.F90:3024-4026).
    Mass fluxes normalized by the cloud-base flux; eu/du/ed in 1/m.
    `eu_only=True` returns just the final entrainment profile eu (all the
    second_call diagnosis consumes of the first call).

    With cfg.microp the updraft window opens at lel, and the plume is
    computed twice: the first pass runs zm_mphy for its freezing rate,
    the second re-ascends with that heat in the hu budget and gives the
    freezing-CAPE increment dcape against the first pass's virtual
    temperature. Under eu_only the two passes run too, as eu depends on
    the freezing. `aero` is zm_mphy's activation bundle."""
    ncol, pver = t.shape
    karr = _karr(pver, t)
    small = 1.0e-20

    c0mask = cfg.c0_ocn * (1.0 - landfrac) + cfg.c0_lnd * landfrac
    tiedke_msk = cfg.tiedke_add * (1.0 - landfrac) + \
        cfg.tiedke_lnd * landfrac
    dz = zf[:, :-1] - zf[:, 1:]

    est, qst = qsat_hpa(t, p)
    qst = torch.where(p - est <= 0.0, 1.0, qst)

    # tht moist-thermo effective constants (zm_conv.F90:3290-3300)
    mrd = (1.0 + c.ZVIR * q) * RGAS
    mcp = (1.0 + CPVIR * q) * CP
    mrl = (1.0 - DCOL * (t - TFREEZ)) * RL
    gamma = qst * (1.0 + qst / EPS1) * EPS1 * mrl / (mrd * t * t) * mrl / mcp
    hmn = mcp * t + GRAV * z + mrl * q
    hsat = mcp * t + GRAV * z + mrl * qst

    # interface log-means (zm_conv.F90:3355-3380)
    qsthat = _log_mean_interface(qst)
    gamhat = _log_mean_interface(gamma)
    hsthat = mcp * shat + mrl * qsthat
    if msg + 1 > 0:
        topm = karr <= msg
        qsthat = torch.where(topm, qst, qsthat)
        gamhat = torch.where(topm, gamma, gamhat)
        hsthat = torch.where(topm, hsat, hsthat)

    # initial jt and j0 (zm_conv.F90:3385-3416)
    jt0 = torch.clamp(torch.clamp(lel, min=msg + 1), max=pver - 1)
    in_jtjb = (karr >= _c(jt0)) & (karr <= _c(jb)) & (karr >= msg)
    hsat_m = torch.where(in_jtjb, hsat, torch.inf)
    # Fortran keeps the LAST k attaining the min
    vmin = hsat_m.amin(1)
    j0 = torch.where(hsat_m == _c(vmin), karr, -1).amax(1)
    j0 = torch.minimum(torch.maximum(j0, jt0 + 2), jb - 2)
    j0 = torch.clamp(j0, max=pver - 1)

    hmn_mx = _take_col(hmn, jb)

    # Taylor-series integrals (zm_conv.F90:3430-3442), bottom-up
    def taylor_step(cy, x, k):
        inw = (k < jb) & (k >= jt0)
        k1 = torch.where(inw, cy["k1"] + (hmn_mx - x["hmn"]) * x["dz"], 0.0)
        ihat = 0.5 * (cy["k1"] + k1)
        i2 = torch.where(inw, cy["i2"] + ihat * x["dz"], 0.0)
        idag = 0.5 * (cy["i2"] + i2)
        i3 = torch.where(inw, cy["i3"] + idag * x["dz"], 0.0)
        iprm = 0.5 * (cy["i3"] + i3)
        i4 = torch.where(inw, cy["i4"] + iprm * x["dz"], 0.0)
        return dict(k1=k1, i2=i2, i3=i3, i4=i4), (k1, i2, i3, i4)

    z4 = torch.zeros_like(hmn_mx)
    _, (k1a, i2a, i3a, i4a) = _scan(taylor_step,
                                    dict(k1=z4, i2=z4, i3=z4, i4=z4),
                                    dict(hmn=hmn, dz=dz), reverse=True)

    # hmin over [j0, jb] and expdif (zm_conv.F90:3448-3456)
    in_j0jb = (karr >= _c(j0)) & (karr <= _c(jb)) & (karr >= msg)
    hmin2 = torch.where(in_j0jb, hmn, torch.inf).amin(1)
    expdif = hmn_mx - hmin2

    # eps(z) Taylor series (zm_conv.F90:3463-3487)
    z_b = _above(z)
    hsat_b = _above(hsat)
    zf_top = zf[:, :-1]
    expnum = _c(hmn_mx) - (hsat_b * (zf_top - z) + hsat * (z_b - zf_top)) / \
        torch.where(z_b - z == 0, 1e-30, z_b - z)
    in_win = (karr >= _c(jt0)) & (karr < _c(jb))
    expnum = torch.where(in_win, expnum, 0.0)
    cond_f = (_c(expdif) > 100.0) & (expnum > 0.0) & \
        (k1a > expnum * dz) & in_win
    ftemp = torch.where(cond_f, _safe_div(expnum, k1a), 0.0)
    f = ftemp + _safe_div(i2a, k1a) * ftemp ** 2 + \
        _safe_div(2.0 * i2a ** 2 - k1a * i3a, k1a ** 2) * ftemp ** 3 + \
        _safe_div(-5.0 * k1a * i2a * i3a + 5.0 * i2a ** 3 + k1a ** 2 * i4a,
                  k1a ** 3) * ftemp ** 4
    f = torch.where(cond_f, torch.clamp(f, 0.0, cfg.entrmn), 0.0)

    # j0 bump (zm_conv.F90:3488-3492)
    f_j0 = _take_col(f, j0)
    f_j0p1 = _take_col(f, torch.clamp(j0 + 1, max=pver - 1))
    bump = (j0 < jb) & (f_j0 < 1.0e-6) & (f_j0p1 > f_j0)
    j0 = torch.where(bump, j0 + 1, j0)

    # running max of f for jt <= k <= j0 (zm_conv.F90:3493-3498), top-down
    def cummax_step(prev, x, k):
        inw = (k >= jt0) & (k <= j0)
        newf = torch.where(inw, torch.maximum(x["f"], prev), x["f"])
        return newf, (newf,)

    _, (f,) = _scan(cummax_step, torch.zeros_like(hmn_mx), dict(f=f))

    eps0 = _take_col(f, j0)
    in_j0jb2 = (karr >= _c(j0)) & (karr <= _c(jb))
    in_jtj0 = (karr < _c(j0)) & (karr >= _c(jt0))
    eps = torch.where(in_j0jb2, _c(eps0), torch.where(in_jtj0, f, 0.0))
    active = eps0 > 0.0

    # updraft mass flux profile (zm_conv.F90:3547-3569); with microp the
    # window opens at lel instead of the initial jt (the reference's
    # tmplel, :3545-3560) and the ascent below decides the final jt
    microp = bool(cfg.microp)
    zf_jb = _take_col(zf, jb)
    zuef = zf[:, :-1] - _c(zf_jb)
    eps_b = _below(eps)
    safe_zuef = torch.where(zuef == 0.0, 1e-30, zuef)
    inv_eps0 = _c(_safe_div(torch.ones_like(eps0), eps0))
    rmue = inv_eps0 * (torch.exp(eps_b * zuef) - 1.0) / safe_zuef
    mu_f = inv_eps0 * (torch.exp(eps * zuef) - 1.0) / safe_zuef

    in_upd = (karr >= _c(lel if microp else jt0)) & (karr < _c(jb)) & \
        _c(active)
    mu0 = torch.where(in_upd, mu_f, 0.0)
    at_jb = karr == _c(jb)
    mu0 = torch.where(at_jb & _c(active), 1.0, mu0)
    eu0 = torch.where(in_upd, (rmue - _below(mu0)) / dz, 0.0)
    eu0 = torch.where(at_jb & _c(active),
                      _safe_div(torch.ones_like(dz), dz), eu0)
    du0 = torch.where(in_upd, (rmue - mu0) / dz, 0.0)

    hu0 = torch.where((karr >= _c(jt0)) & (karr <= _c(jb)),
                      _c(hmn_mx) + CP * _c(tiedke_msk), hmn)
    hu_jb = hmn_mx + CP * tiedke_msk
    q_mx = _take_col(q, jb)
    p_b3 = _above(p)   # p(k-1)
    # default for levels the ascent never writes: the reference's
    # tiedke-perturbed su = s(mx) + tiedke/(1+cpvir q) inside [jt0, jb]
    # (zm_conv.F90:3417-3421) and the environment s elsewhere
    su_dflt = torch.where((karr >= _c(jt0)) & (karr <= _c(jb)),
                          _c(_take_col(s, jb)) +
                          _c(tiedke_msk) / (1.0 + CPVIR * q), s)
    zc = torch.zeros_like(hu_jb)

    # ---- plume iteration (zm_conv.F90:3526-3874): one pass without
    # microphysics; two with it (pass 1 computes the plume and its
    # freezing rate, pass 2 re-ascends with the freezing heat in hu) ----
    frz = torch.zeros_like(t)
    # dcape's reference profile: the environment's interface virtual
    # temperature everywhere (zm_conv.F90:3304-3307), overwritten inside
    # pass 1's plume window; levels only pass 2's window reaches
    # difference against the environment
    tvuo = (shat - GRAV / mcp * zf_top) * (1.0 + c.ZVIR * qhat) \
        if microp else None
    dcape = zc
    jto = mp = None
    for itr in range(2 if microp else 1):
        totfrz = (frz * dz).sum(1)

        # hu ascent with mu < 0.02 cutoff (zm_conv.F90:3571-3599), bottom-up
        def hu_step(cy, x, k):
            inw = (k <= jb - 1) & (k >= lel) & active
            weak = x["mu"] < 0.02
            mu_k = torch.where(inw & weak, 0.0, x["mu"])
            eu_k = torch.where(inw & weak, 0.0, x["eu"])
            du_k = torch.where(inw & weak, cy["mu_b"] / x["dz"], x["du"])
            if microp:
                # freezing heat enters the plume MSE budget; detrainment
                # carries hu itself (zm_conv.F90:3588-3591)
                hu_full = (cy["mu_b"] * cy["hu_b"] + x["dz"] *
                           (eu_k * x["hmn"] + c.LATICE * x["frz"])) / \
                    torch.clamp(mu_k + x["dz"] * du_k, min=1e-30)
            else:
                hu_full = _safe_div(cy["mu_b"], mu_k) * cy["hu_b"] + \
                    _safe_div(x["dz"], mu_k) * (eu_k * x["hmn"] -
                                                du_k * x["hsat"])
            hu_k = torch.where(inw, torch.where(weak, x["hmn"], hu_full),
                               x["hu0"])
            at_base = k == jb
            mu_out = torch.where(at_base, x["mu"], mu_k)
            hu_out = torch.where(at_base, x["hu0"], hu_k)
            new_cy = dict(mu_b=mu_out,
                          hu_b=torch.where(inw | at_base, hu_out,
                                           cy["hu_b"]))
            return new_cy, (mu_out, torch.where(at_base, x["eu"], eu_k),
                            torch.where(at_base, x["du"], du_k), hu_out)

        xsH = dict(mu=mu0, eu=eu0, du=du0, dz=dz, hmn=hmn, hsat=hsat,
                   hu0=hu0)
        if microp:
            xsH["frz"] = frz
        _, (mu, eu, du, hu) = _scan(
            hu_step, dict(mu_b=torch.zeros_like(hu_jb), hu_b=hu_jb), xsH,
            reverse=True)

        # jt detection (zm_conv.F90:3606-3629): first k from the bottom in
        # [lel-1, jb-2] matching either condition; a plume whose column
        # has freezing heat (totfrz > 0) is not stopped by the hu
        # overshoot (:3622)
        hu_at_jb = _take_col(hu, jb)
        in_det = (karr <= _c(jb) - 2) & (karr >= _c(lel) - 1)
        cond1 = (hu <= hsthat) & (_below(hu) > _below(hsthat)) & (mu >= 0.02)
        cond2 = ((hu > _c(hu_at_jb)) & _c(totfrz <= 0.0)) | (mu < 0.02)
        anyc = in_det & (cond1 | cond2)
        jt_cand = torch.where(cond1,
                              torch.where(hu - hsthat < -2000.0, karr + 1,
                                          karr),
                              karr + 1)
        det_k, det_found = _first_true_from_bottom(anyc, 0)
        jt = torch.where(det_found, _take_col(jt_cand, det_k), jt0)

        # zero the region above jt (zm_conv.F90:3633-3648)
        above_jt = (karr >= _c(lel)) & (karr <= _c(jt)) & _c(active)
        mu_below2 = _below(mu)
        at_jt = (karr == _c(jt)) & _c(active)
        mu = torch.where(above_jt, 0.0, mu)
        eu = torch.where(above_jt | at_jt, 0.0, eu)
        hu = torch.where(above_jt, hmn, hu)
        du = torch.where(above_jt, 0.0, du)
        du = torch.where(at_jt, mu_below2 / dz, du)
        if eu_only and not microp:
            return eu

        # tu initialisation (zm_conv.F90:3652-3657) with environment qu
        tu = (hu - GRAV * zf_top - (1.0 + DCOL * TFREEZ) * RL * q) / \
            (CP * (1.0 + (CPVIR - DCOL * (RL / CP)) * q))

        # su/qu ascent + jlcl detection (zm_conv.F90:3659-3706), bottom-up
        def suqu_step(cy, x, k):
            at_base = (k == jb) & active
            tu_base = (x["hu"] - GRAV * x["zf"] -
                       (1.0 + DCOL * TFREEZ) * RL * q_mx) / \
                (CP * (1.0 + (CPVIR - DCOL * (RL / CP)) * q_mx))
            su_base = (x["hu"] - (1.0 - DCOL * (tu_base - TFREEZ)) * RL *
                       q_mx) / ((1.0 + CPVIR * q_mx) * CP)
            not_done = cy["done"] < 0.5
            inw = not_done & (k > jt) & (k < jb) & active
            su_k = _safe_div(cy["mu_b"], x["mu"]) * cy["su_b"] + \
                _safe_div(x["dz"], x["mu"]) * (x["eu"] - x["du"]) * x["s"]
            qu_k = _safe_div(cy["mu_b"], x["mu"]) * cy["qu_b"] + \
                _safe_div(x["dz"], x["mu"]) * (x["eu"] * x["q"] -
                                               x["du"] * x["qst"])
            tu_k = su_k - GRAV / ((1.0 + 0.85 * qu_k) * CP) * x["zf"]
            _, qstu = qsat_hpa(tu_k, 0.5 * (x["p"] + x["pm1"]))
            sat = inw & (qu_k >= qstu)
            su_out = torch.where(at_base, su_base,
                                 torch.where(inw, su_k, x["su0"]))
            qu_out = torch.where(at_base, q_mx,
                                 torch.where(inw, qu_k, x["q"]))
            tu_out = torch.where(at_base, tu_base,
                                 torch.where(inw, tu_k, x["tu0"]))
            done = torch.where(sat, 1.0, cy["done"])
            jlcl = torch.where(sat & not_done, k, cy["jlcl"])
            new_cy = dict(
                su_b=torch.where(at_base | inw, su_out, cy["su_b"]),
                qu_b=torch.where(at_base | inw, qu_out, cy["qu_b"]),
                mu_b=x["mu"], done=done, jlcl=jlcl)
            return new_cy, (su_out, qu_out, tu_out)

        cyS, (su, qu, tu) = _scan(
            suqu_step, dict(su_b=zc, qu_b=zc, mu_b=zc, done=zc, jlcl=lel),
            dict(mu=mu, eu=eu, du=du, dz=dz, s=s, q=q, qst=qst, hu=hu,
                 zf=zf_top, p=p, pm1=p_b3, tu0=tu, su0=su_dflt),
            reverse=True)
        jlcl = cyS["jlcl"]

        # saturated portion jt < k <= jlcl (zm_conv.F90:3708-3722)
        in_sat = (karr > _c(jt)) & (karr <= _c(jlcl)) & _c(active)
        qu_sat = qsthat + gamhat * (hu - hsthat) / \
            ((1.0 - DCOL * (tu - TFREEZ)) * RL * (1.0 + gamhat))
        su_sat = shat + (hu - hsthat) / ((1.0 + CPVIR * qu_sat) * CP *
                                         (1.0 + gamhat))
        tu_sat = su_sat - GRAV / ((1.0 + CPVIR * qu_sat) * CP) * zf_top
        qu = torch.where(in_sat, qu_sat, qu)
        su = torch.where(in_sat, su_sat, su)
        tu = torch.where(in_sat, tu_sat, tu)

        # condensation in the updraft (zm_conv.F90:3730-3759); microp
        # bounds it at jlcl (tmplel, :3725-3729) and takes the freezing
        # term out of the vapour condensation
        if microp:
            in_cu = (karr >= _c(jt)) & (karr <= _c(jlcl)) & _c(active)
            cu = ((mu * su - _below(mu) * _below(su)) / dz - eu * s +
                  du * su) / (RL / CP) * \
                ((1.0 + CPVIR * qu) / (1.0 - DCOL * (tu - TFREEZ))) - \
                c.LATICE * frz / RL
        else:
            in_cu = (karr >= _c(jt)) & (karr < _c(jb)) & _c(active)
            cu = ((mu * su - _below(mu) * _below(su)) / dz -
                  (eu - du) * s) / (RL / CP) * \
                ((1.0 + CPVIR * qu) / (1.0 - DCOL * (tu - TFREEZ)))
        cu = torch.where(in_cu & (karr != _c(jt)), torch.clamp(cu, min=0.0),
                         0.0)

        if microp:
            # ice fraction of the new condensate from the in-plume T of
            # the level below (tug, zm_conv.F90:3710-3737)
            tug_b = _below(su - (GRAV / CP) * zf_top / (1.0 + CPVIR * qu))
            fice = torch.where(tug_b > TFREEZ, 0.0,
                               torch.where(tug_b < 233.15, 1.0,
                                           (TFREEZ - tug_b) / 40.0))
            fice = torch.where(karr == pver - 1, 0.0, fice)
            mp = zm_mphy(cfg, su, qu, mu, du, eu, cu * (1.0 - fice),
                         cu * fice, dz, zf_top, p, t, q, jt, jb, active,
                         landfrac, aero=aero)
            frz = mp.frz
            ql = mp.qliq + mp.qice
            if itr == 0:
                jto = jt
                # virtual T of the plume without freezing (dcape's
                # reference, zm_conv.F90:3822-3824)
                in_dc = (karr > _c(jt)) & (karr <= _c(jlcl)) & _c(active)
                tvuo = torch.where(in_dc, (su - GRAV / CP * zf_top) *
                                   (1.0 + 0.608 * qu), tvuo)
            else:
                # a top lower than pass 1's: no frz or cu in [jto, jt]
                # (zm_conv.F90:3804-3810)
                fix = _c((jt > jto) & active) & (karr <= _c(jt)) & \
                    (karr >= _c(jto))
                frz = torch.where(fix, 0.0, frz)
                cu = torch.where(fix, 0.0, cu)
                # freezing-CAPE increment (zm_conv.F90:3822-3836)
                in_dc2 = (karr > _c(torch.maximum(jt, jto))) & \
                    (karr <= _c(jlcl)) & _c(active)
                tvu = torch.where(
                    in_dc2, (su - GRAV / (CP * (1.0 + CPVIR * qu)) * zf_top)
                    * (1.0 + 0.608 * qu), 0.0)
                dcape = torch.where(in_dc2, RGAS * (tvu - tvuo) *
                                    torch.log(p / p_b3), 0.0).sum(1)
            # totpcp with the two-phase detrainment (zm_conv.F90:3814-3820)
            det_b = _below(mp.qcde + mp.qide)
            in_tp = (karr >= _c(jt)) & (karr < _c(jb)) & _c(active) & \
                (mu >= 0.0)
            totpcp = torch.where(in_tp, dz * (cu - du * det_b), 0.0).sum(1)
            # rprd is the total production, sprd its snow part; after the
            # downdraft evaporation below rprd can drop under sprd, as in
            # the reference (:4190)
            rprd = mp.rprd + mp.sprd
            qcde = mp.qcde
        else:
            # liquid water + rain production (zm_conv.F90:3953-3975),
            # bottom-up
            def ql_step(cy, x, k):
                inw = (k >= jt) & (k < jb) & active & (x["mu"] >= 0.0)
                pos = x["mu"] > 0.0
                ql1 = _safe_div(cy["mu_b"] * cy["ql_b"] - x["dz"] * x["du"] *
                                cy["ql_b"] + x["dz"] * x["cu"], x["mu"])
                ql_k = torch.where(inw & pos, ql1 / (1.0 + x["dz"] * c0mask),
                                   0.0)
                totpcp = cy["totpcp"] + torch.where(
                    inw, x["dz"] * (x["cu"] - x["du"] * cy["ql_b"]), 0.0)
                rprd_k = torch.where(inw, c0mask * x["mu"] * ql_k, 0.0)
                new_cy = dict(ql_b=torch.where(
                    inw, ql_k, torch.where(k == jb, 0.0, cy["ql_b"])),
                    mu_b=x["mu"], totpcp=totpcp)
                return new_cy, (ql_k, rprd_k)

            cyQ, (ql, rprd) = _scan(ql_step,
                                    dict(ql_b=zc, mu_b=zc, totpcp=zc),
                                    dict(mu=mu, du=du, cu=cu, dz=dz),
                                    reverse=True)
            totpcp = cyQ["totpcp"]
            qcde = ql
    if eu_only:
        # microp: eu is final after both passes; the downdraft, the
        # evaporation and pflx below do not feed it
        return eu
    totpcp = torch.clamp(totpcp, min=0.0)

    # ---- downdraft (zm_conv.F90:4030-4106) ----
    alfa = cfg.alfadet
    jt = torch.minimum(jt, jb - 1)
    jd = torch.minimum(torch.maximum(j0, jt + 1), jb)
    zf_jd = _take_col(zf, jd)
    zdef = _c(zf_jd) - zf_top
    in_dd = (karr > _c(jd)) & (karr <= _c(jb)) & _c(active)
    safe_zdef = torch.where(zdef == 0.0, 1e-30, zdef)
    md = torch.where(in_dd,
                     _c(-alfa / (2.0 * torch.where(eps0 == 0, 1e-30, eps0))) *
                     (torch.exp(2.0 * _c(eps0) * zdef) - 1.0) / safe_zdef,
                     0.0)
    at_jd = (karr == _c(jd)) & _c(jd < jb) & _c(active)
    md = torch.where(at_jd, -alfa, md)

    mu_jb = _take_col(mu, jb)
    md_jb = _take_col(md, jb)
    ratmjb = torch.clamp(torch.abs(_safe_div(mu_jb, md_jb)), max=1.0)
    in_scale = (karr >= _c(jt)) & (karr <= _c(jb)) & _c(active) & \
        _c(jd < jb)
    md = torch.where(in_scale, md * _c(ratmjb), md)

    # ed(j) = (md(j) - md(j+1)) / dz(j) for j >= jt-1 (zm_conv.F90:4108-4118)
    md_b4 = _below(md)
    in_ed = (karr >= _c(jt) - 1) & _c(active)
    ed = torch.where(in_ed, (md - md_b4) / dz, 0.0)

    # hd(j) = (md(j-1) hd(j-1) - dz(j-1) ed(j-1) hmn(j-1)) / min(md(j), -small)
    # for j >= jt, top-down
    def hd_step(cy, x, k):
        inw = (k >= jt) & active
        mdt = torch.clamp(x["md"], max=-small)
        hd_k = torch.where(inw, (cy["md_p"] * cy["hd_p"] -
                                 cy["dz_p"] * cy["ed_p"] * cy["hmn_p"]) / mdt,
                           x["hmn"])
        return dict(hd_p=hd_k, md_p=x["md"], ed_p=x["ed"], hmn_p=x["hmn"],
                    dz_p=x["dz"]), (hd_k,)

    _, (hd,) = _scan(hd_step,
                     dict(hd_p=hmn[:, 0], md_p=zc, ed_p=zc, hmn_p=hmn[:, 0],
                          dz_p=dz[:, 0]),
                     dict(md=md, ed=ed, dz=dz, hmn=hmn))

    # qds + td (zm_conv.F90:4122-4137)
    in_qds = (karr >= _c(jd)) & (karr <= _c(jb)) & _c(active) & _c(jd < jb)
    qds0 = qsthat + gamhat * (hd - hsthat) / (RL * (1.0 + gamhat))
    td = (hd - GRAV * zf_top - (1.0 + DCOL * TFREEZ) * RL * qds0) / \
        (CP * (1.0 + (CPVIR - DCOL * (RL / CP)) * qds0))
    qds = torch.where(in_qds,
                      qsthat + gamhat * (hd - hsthat) /
                      ((1.0 - DCOL * (td - TFREEZ)) * RL * (1.0 + gamhat)), q)

    # sd/qd/evp descent (zm_conv.F90:4139-4171), top-down
    qd_jd = _take_col(qds, jd)
    sd_jd_t = _take_col(td, jd)
    hd_jd = _take_col(hd, jd)
    sd_jd = (hd_jd - (1.0 - DCOL * (sd_jd_t - TFREEZ)) * RL * qd_jd) / \
        ((1.0 + CPVIR * qd_jd) * CP)
    # the reference overwrites td(jd) after setting sd(jd) (zm_conv.F90:
    # 3947, "BUG FIX 2019 05 24"): the first descent step uses this value
    td_jd = sd_jd - GRAV / ((1.0 + CPVIR * qd_jd) * CP) * zf_jd

    def evp_step(cy, x, k):
        at_jd_k = k == jd
        sd_k = torch.where(at_jd_k, sd_jd, cy["sd_c"])
        td_k = torch.where(at_jd_k, td_jd, x["td"])
        inw = (k >= jd) & (k < jb) & active
        qd_k = torch.where(at_jd_k, qd_jd, x["qds"])
        evp_k = -x["ed"] * x["q"] + (x["md"] * qd_k -
                                     x["md_b"] * x["qds_b"]) / x["dz"]
        evp_k = torch.where(inw, torch.clamp(evp_k, min=0.0), 0.0)
        mdt = torch.clamp(x["md_b"], max=-small)
        sd_next = ((1.0 - DCOL * (td_k - TFREEZ)) * RL /
                   ((1.0 + CPVIR * qd_k) * CP) * evp_k - x["ed"] * x["s"]) * \
            x["dz"] + x["md"] * sd_k
        sd_next = torch.where(inw, sd_next / mdt, cy["sd_c"])
        totevp = cy["totevp"] - torch.where(inw, x["dz"] * x["ed"] * x["q"],
                                            0.0)
        return dict(sd_c=torch.where(inw, sd_next, sd_k),
                    totevp=totevp), (sd_k, qd_k, evp_k)

    cyE, (sd, qd, evp) = _scan(
        evp_step, dict(sd_c=sd_jd, totevp=zc),
        dict(md=md, md_b=md_b4, ed=ed, dz=dz, q=q, s=s, td=td, qds=qds,
             qds_b=_below(qds)))
    # levels outside [jd, jb]: environment values
    out_dd = ~((karr >= _c(jd)) & (karr <= _c(jb)))
    sd = torch.where(out_dd, s, sd)
    qd = torch.where(out_dd, q, qd)

    totevp = cyE["totevp"] + _take_col(md, jd) * qd_jd - \
        _take_col(md, jb) * _take_col(qd, jb)
    totevp = torch.clamp(totevp, min=0.0)

    # evap/precip consistency scaling (zm_conv.F90:4183-4200)
    both = (totevp > 0.0) & (totpcp > 0.0)
    fac = torch.where(both, torch.clamp(
        totpcp / torch.where(totevp + totpcp == 0, 1e-30, totevp + totpcp),
        max=1.0), 0.0)
    in_all = karr >= msg + 1
    md = torch.where(in_all, md * _c(fac), md)
    ed = torch.where(in_all, ed * _c(fac), ed)
    evp = torch.where(in_all, evp * _c(fac), evp)
    cmeg = torch.where(in_all, cu - evp, 0.0)
    rprd = torch.where(in_all, rprd - evp, rprd)

    # precipitation flux through interfaces (zm_conv.F90:4203-4208)
    pflx = torch.cat([torch.zeros_like(rprd[:, :1]),
                      _cumsum_lvl(rprd * dz)], 1)

    if microp:
        ext = dict(qide=mp.qide, qncde=mp.qncde, qnide=mp.qnide,
                   sprd=mp.sprd, frz=frz, qliq=mp.qliq, qice=mp.qice,
                   qnl=mp.qnl, qni=mp.qni, wu=mp.wu, mrates=mp.rates)
    else:
        z2 = torch.zeros_like(t)
        ext = dict(qide=z2, qncde=z2, qnide=z2, sprd=z2, frz=z2, qliq=z2,
                   qice=z2, qnl=z2, qni=z2, wu=z2, mrates={})
    return CldprpOut(mu=mu, eu=eu, du=du, md=md, ed=ed, sd=sd, qd=qd,
                     mc=mu + md, qu=qu, su=su, qst=qst, hmn=hmn, hsat=hsat,
                     ql=ql, qcde=qcde, cu=cu, evp=evp, cmeg=cmeg, rprd=rprd,
                     pflx=pflx, jt=jt, jlcl=jlcl, j0=j0, jd=jd, dcape=dcape,
                     **ext)


# =============================================================================
# closure  (zm_conv.F90:4028-4260)
# =============================================================================

def closure(cfg: ZMConfig, msg: int, q, t, p, z, s, tp, qs, qu, su, mc, du,
            mu, md, qd, sd, qhat, shat, dp, qstp, zf, ql, dsubcld, cape, tl,
            lcl, lel, jt, mx):
    """CAPE-relaxation cloud-base mass flux (closure, zm_conv.F90:
    4028-4260). Returns mb (ncol,) in mb/s per unit normalized mass flux."""
    pver = t.shape[1]
    karr = _karr(pver, t)

    q_mx = _take_col(q, mx)
    p_mx = _take_col(p, mx)
    t_mx = _take_col(t, mx)
    mu_mx = _take_col(mu, mx)
    md_mx = _take_col(md, mx)
    shat_mx = _take_col(shat, mx)
    su_mx = _take_col(su, mx)
    sd_mx = _take_col(sd, mx)
    qhat_mx = _take_col(qhat, mx)
    qu_mx = _take_col(qu, mx)
    qd_mx = _take_col(qd, mx)

    # subcloud-layer tendencies per unit mb (zm_conv.F90:4131-4143)
    dsub = torch.where(dsubcld <= 0, 1e-30, dsubcld)
    eb = p_mx * q_mx / (EPS1 + q_mx)
    dtbdt = (1.0 / dsub) * (mu_mx * (shat_mx - su_mx) +
                            md_mx * (shat_mx - sd_mx))
    dqbdt = (1.0 / dsub) * (mu_mx * (qhat_mx - qu_mx) +
                            md_mx * (qhat_mx - qd_mx))
    debdt = EPS1 * p_mx / (EPS1 + q_mx) ** 2 * dqbdt
    dtldt = -2840.0 * (3.5 / t_mx * dtbdt - debdt / eb) / \
        (3.5 * torch.log(t_mx) - torch.log(eb) - 4.805) ** 2

    # cumulus heating/drying per unit mb (zm_conv.F90:4150-4185)
    mu_b, md_b, mc_b = _below(mu), _below(md), _below(mc)
    su_b, sd_b, qu_b, qd_b = _below(su), _below(sd), _below(qu), _below(qd)
    shat_b, qhat_b, ql_b = _below(shat), _below(qhat), _below(ql)

    at_jt = karr == _c(jt)
    dtmdt_jt = (1.0 / dp) * (mu_b * (su_b - shat_b - RL / CP * ql_b) +
                             md_b * (sd_b - shat_b))
    dqmdt_jt = (1.0 / dp) * (mu_b * (qu_b - qhat_b + ql_b) +
                             md_b * (qd_b - qhat_b))
    beta = 0.0
    in_mid = (karr > _c(jt)) & (karr < _c(mx))
    dtmdt_mid = (mc * (shat - s) - mc_b * (shat_b - s)) / dp - \
        RL / CP * du * (beta * ql + (1.0 - beta) * ql_b)
    dqmdt_mid = (mu_b * (qu_b - qhat_b + CP / RL * (su_b - s)) -
                 mu * (qu - qhat + CP / RL * (su - s)) +
                 md_b * (qd_b - qhat_b + CP / RL * (sd_b - s)) -
                 md * (qd - qhat + CP / RL * (sd - s))) / dp + \
        du * (beta * ql + (1.0 - beta) * ql_b)
    dtmdt = torch.where(at_jt, dtmdt_jt, torch.where(in_mid, dtmdt_mid, 0.0))
    dqmdt = torch.where(at_jt, dqmdt_jt, torch.where(in_mid, dqmdt_mid, 0.0))

    # dboydt integrand (zm_conv.F90:4188-4238)
    in_cape = (karr >= _c(lel)) & (karr <= _c(lcl))
    thetavp1 = tp * (1000.0 / p) ** (RGAS / CP) * \
        (1.0 + 1.608 * qstp - _c(q_mx))
    thetavm = t * (1000.0 / p) ** (RGAS / CP) * (1.0 + 0.608 * q)
    dqsdtp = qstp * (1.0 + qstp / EPS1) * EPS1 * RL / (RGAS * tp ** 2)
    tl_s = _c(torch.where(tl <= 0, 1e-30, tl))
    dtpdt = tp / (1.0 + RL / CP * (dqsdtp - qstp / tp)) * \
        (_c(dtbdt) / _c(t_mx) +
         RL / CP * (_c(dqbdt) / tl_s - _c(q_mx) / tl_s ** 2 * _c(dtldt)))
    dboydt1 = ((dtpdt / tp + 1.0 / (1.0 + 1.608 * qstp - _c(q_mx)) *
                (1.608 * dqsdtp * dtpdt - _c(dqbdt))) -
               (dtmdt / t + 0.608 / (1.0 + 0.608 * q) * dqmdt)) * \
        GRAV * thetavp1 / thetavm

    in_sub = (karr > _c(lcl)) & (karr < _c(mx))
    thetavp2 = tp * (1000.0 / p) ** (RGAS / CP) * (1.0 + 0.608 * _c(q_mx))
    dboydt2 = (_c(dtbdt) / _c(t_mx) +
               0.608 / (1.0 + 0.608 * _c(q_mx)) * _c(dqbdt) -
               dtmdt / t - 0.608 / (1.0 + 0.608 * q) * dqmdt) * \
        GRAV * thetavp2 / thetavm
    dboydt = torch.where(in_cape, dboydt1, torch.where(in_sub, dboydt2, 0.0))

    # integrate dA/dt and close (zm_conv.F90:4243-4257)
    dzf = zf[:, :-1] - zf[:, 1:]
    seg = (karr >= _c(lel)) & (karr <= _c(mx) - 1)
    dadt = torch.where(seg, dboydt * dzf, 0.0).sum(1)
    dltaa = -(cape - cfg.capelmt)
    return torch.where(dadt != 0.0,
                       torch.clamp(dltaa / (cfg.tau * dadt), min=0.0), 0.0)


# =============================================================================
# q1q2_pjr  (zm_conv.F90:4262-4421)
# =============================================================================

def q1q2_pjr(msg: int, q, qs, qu, su, du, qhat, shat, dp, mu, md, sd, qd, ql,
             dsubcld, jt, mx, dl_evp_cu, microp_extra=None):
    """Heating/drying tendencies from the mass-flux profiles (q1q2_pjr,
    zm_conv.F90:4262-4421); dl_evp_cu = (evp, cu). `microp_extra`, with
    microp: (frz, qide, qncde, qnide) in the mb-scaled 1/mb units, adding
    the freezing heat latice/cp frz to dsdt (:4378) and the ice and number
    detrainment di/dnl/dni = du (qide/qncde/qnide)(k+1) (:4392-4396).
    Returns (dqdt, dsdt, dl, (di, dnl, dni)), units /s (dsdt in
    normalized dry static energy); the extras are zeros without
    microp_extra."""
    evp, cu = dl_evp_cu
    pver = q.shape[1]
    karr = _karr(pver, q)
    mu_b, md_b = _below(mu), _below(md)
    su_b, sd_b, qu_b, qd_b = _below(su), _below(sd), _below(qu), _below(qd)
    shat_b, qhat_b, ql_b = _below(shat), _below(qhat), _below(ql)

    emc = -cu + evp
    in_main = (karr >= _c(jt)) & (karr <= pver - 2)
    dsdt = torch.where(in_main,
                       -RL / CP * emc +
                       (mu_b * (su_b - shat_b) - mu * (su - shat) +
                        md_b * (sd_b - shat_b) - md * (sd - shat)) / dp, 0.0)
    dqdt = torch.where(in_main,
                       emc + (mu_b * (qu_b - qhat_b) - mu * (qu - qhat) +
                              md_b * (qd_b - qhat_b) - md * (qd - qhat)) / dp,
                       0.0)
    dl = torch.where(in_main, du * ql_b, 0.0)
    if microp_extra is not None:
        frz, qide, qncde, qnide = microp_extra
        dsdt = dsdt + torch.where(in_main, c.LATICE / CP * frz, 0.0)
        di, dnl, dni = (torch.where(in_main, du * _below(x), 0.0)
                        for x in (qide, qncde, qnide))
    else:
        di = dnl = dni = torch.zeros_like(dl)

    # subcloud layer (zm_conv.F90:4396-4415): value at mx, copied downward
    dsub = torch.where(dsubcld <= 0, 1e-30, dsubcld)
    mu_mx, md_mx = _take_col(mu, mx), _take_col(md, mx)
    su_mx, sd_mx = _take_col(su, mx), _take_col(sd, mx)
    qu_mx, qd_mx = _take_col(qu, mx), _take_col(qd, mx)
    shat_mx, qhat_mx = _take_col(shat, mx), _take_col(qhat, mx)
    dsdt_sub = (1.0 / dsub) * (-mu_mx * (su_mx - shat_mx) -
                               md_mx * (sd_mx - shat_mx))
    dqdt_sub = (1.0 / dsub) * (-mu_mx * (qu_mx - qhat_mx) -
                               md_mx * (qd_mx - qhat_mx))
    below = karr >= _c(mx)
    dsdt = torch.where(below, _c(dsdt_sub), dsdt)
    dqdt = torch.where(below, _c(dqdt_sub), dqdt)
    return dqdt, dsdt, dl, (di, dnl, dni)


# =============================================================================
# zm_convr — main driver  (zm_conv.F90:231-1709)
# =============================================================================

@dataclass
class ZMConvOut:
    """Outputs of the ZM deep convection core (full columns). The microp
    fields (dif ... mrates) are zeros, and mrates {}, when microp is
    off."""

    qtnd: torch.Tensor     # specific humidity tendency (kg/kg/s)
    heat: torch.Tensor     # heating rate (J/kg/s)
    prec: torch.Tensor     # precipitation rate (m/s)
    jctop: torch.Tensor    # top-of-convection level index
    jcbot: torch.Tensor    # base-of-convection level index
    cape: torch.Tensor
    cin: torch.Tensor
    mcon: torch.Tensor     # net convective mass flux, interfaces (mb/s)
    dlf: torch.Tensor      # detrained cloud water tendency (kg/kg/s)
    pflx: torch.Tensor     # precip flux (interfaces, kg/m2/s)
    cme: torch.Tensor      # condensation - evaporation (kg/kg/s)
    zdu: torch.Tensor      # detrainment du (/s)
    rprd: torch.Tensor     # rain production (kg/kg/s)
    mu: torch.Tensor       # updraft mass flux (mb/s)
    eu: torch.Tensor
    du: torch.Tensor
    md: torch.Tensor
    ed: torch.Tensor
    dp: torch.Tensor       # layer thickness (mb)
    dsubcld: torch.Tensor  # subcloud thickness (mb)
    jt: torch.Tensor       # top level
    maxg: torch.Tensor     # base (launch) level
    ideep: torch.Tensor    # bool triggered mask
    eurt: torch.Tensor     # diagnosed entrainment rate (/m)
    ql: torch.Tensor       # updraft cloud water
    rliq: torch.Tensor     # reserved liquid (m/s)
    rice: torch.Tensor
    dif: torch.Tensor      # detrained cloud-ice tendency (kg/kg/s)
    dnlf: torch.Tensor     # detrained droplet-number tendency (1/kg/s)
    dnif: torch.Tensor     # detrained crystal-number tendency (1/kg/s)
    sprd: torch.Tensor     # snow production (kg/kg/s; part of rprd)
    frz: torch.Tensor      # freezing rate (kg/kg/s; its heat is in heat)
    qliq: torch.Tensor     # in-plume liquid
    qice: torch.Tensor
    qnl: torch.Tensor
    qni: torch.Tensor
    wu: torch.Tensor       # updraft vertical velocity (m/s)
    dcape: torch.Tensor    # (ncol,) freezing-CAPE increment
    mrates: dict           # per-process rates, mb-scaled (kg/kg/s family)


ZMCONV_FIELDS = tuple(f.name for f in fields(ZMConvOut))


def zm_convr(cfg: ZMConfig, msg: int, t, qh, pap, paph, dpp, zm_, geos, zi_,
             pblh, tpert, landfrac, delt,
             aero: dict | None = None) -> ZMConvOut:
    """Main ZM driver (zm_convr, zm_conv.F90:231-1709), tht path
    (second_call / retrigger / use_cin per config). Inputs are SI (Pa, m,
    K); `delt` is the reference's half step (the interface passes
    0.5*ztodt). With cfg.microp the in-plume microphysics runs inside
    cldprp: freezing heat in the plume budget, the dcape closure boost,
    the vapour fixer, and the ice and number detrainment streams
    (zm_conv.F90:3526-3874, 4378-4396); `aero` is its modal activation
    bundle (zm_aero_t role). buoyan_dilute runs through
    ops.zm_parcel_kernels.zm_parcel: its CUDA kernel for CUDA tensors it
    takes, else the plain function."""
    from ...ops.zm_parcel_kernels import zm_parcel
    ncol, pver = t.shape
    karr = _karr(pver, t)

    # geometry in mb / m incl. surface elevation (zm_conv.F90:822-843)
    zs = geos * RGRAV
    p = pap * 0.01
    pf = paph * 0.01
    z = zm_ + _c(zs)
    zf = zi_ + _c(zs)
    dp = 0.01 * dpp
    dz = zf[:, :-1] - zf[:, 1:]

    # PBL top level: smallest k whose midpoint is within half a layer of
    # the PBL height (zm_conv.F90:845-849)
    near = torch.abs(z - _c(zs) - _c(pblh)) < dz * 0.5
    near = near & (karr >= msg) & (karr <= pver - 2)
    pblt, _ = _first_true_from_top(near, pver - 1)
    pblt = pblt.to(t.dtype)

    q = qh
    # scaled dry static energy s = T + g z /((1+zvir q) cp)  (tht, :855-858)
    s = t + (GRAV / ((1.0 + c.ZVIR * q) * CP)) * z
    dmpdz0 = torch.full_like(t, -cfg.tentrm)

    b1 = zm_parcel(cfg, msg, q, t, p, z, pf, zi_, zs, pblt, tpert, landfrac,
                   dmpdz0)

    def trigger(cape, cin):
        trig = cape > cfg.capelmt
        if cfg.use_cin:
            trig = trig & (cin < cape * cfg.cin_threshd)
        return trig

    ideep = trigger(b1.cape, b1.cin)
    shat = _log_mean_interface(s)
    qhat = _log_mean_interface(q)
    # under second_call only eu of this first plume call survives
    # (zm_conv.F90:1046-1078)
    c1 = cldprp(cfg, msg, q, t, p, z, s, zf, shat, qhat, b1.mx, b1.lel,
                landfrac, eu_only=cfg.second_call, aero=aero)
    eurt = torch.zeros_like(t)

    if cfg.second_call:
        # diagnose entrainment from eu: mean of eu > 0 (zm_conv.F90:
        # 1046-1078)
        has_eu = (c1 > 0.0) & _c(ideep)
        cnt = has_eu.sum(1)
        dmsm = -torch.where(has_eu, c1, 0.0).sum(1) / \
            torch.where(cnt == 0, 1, cnt)
        dmpdz2_col = torch.where(ideep, torch.where(cnt > 0, dmsm, -1.0),
                                 -cfg.tentrm)
        dmpdz2 = dmpdz2_col[:, None].expand(ncol, pver)
        b2 = zm_parcel(cfg, msg, q, t, p, z, pf, zi_, zs, pblt, tpert,
                       landfrac, dmpdz2)
        if cfg.retrigger:
            ideep = trigger(b2.cape, b2.cin)
        cld = cldprp(cfg, msg, q, t, p, z, s, zf, shat, qhat, b2.mx, b2.lel,
                     landfrac, aero=aero)
        bu = b2
        eurt = -dmpdz2
    else:
        bu = b1
        cld = c1

    mask = ideep
    maskf = _c(mask.to(t.dtype))
    mx = bu.mx
    jt = cld.jt

    # subcloud thickness (zm_conv.F90:990-997)
    dsubcld = torch.where((karr >= _c(mx)) & (karr >= msg), dp, 0.0).sum(1)

    # 1/m -> 1/mb (zm_conv.F90:1252-1262)
    fac_mb = dz / dp
    du = cld.du * fac_mb
    eu = cld.eu * fac_mb
    ed = cld.ed * fac_mb
    cu = cld.cu * fac_mb
    cmeg = cld.cmeg * fac_mb
    rprdg = cld.rprd * fac_mb
    evpg = cld.evp * fac_mb
    sprdg = cld.sprd * fac_mb          # (zm_conv.F90:1264-1271)
    frzg = cld.frz * fac_mb

    # the freezing-CAPE increment boosts the closure on the triggered
    # (the reference's gathered) columns (capeg += dcape, :1242-1246)
    cape = bu.cape + cld.dcape * mask.to(t.dtype) if cfg.microp else bu.cape
    mb = closure(cfg, msg, q, t, p, z, s, bu.tp, cld.qst, cld.qu, cld.su,
                 cld.mc, du, cld.mu, cld.md, cld.qd, cld.sd, qhat, shat, dp,
                 bu.qstp, zf, cld.ql, dsubcld, cape, bu.tl, bu.lcl, bu.lel,
                 jt, mx)

    # CFL cap (zm_conv.F90:1285-1300)
    mumax = torch.where(karr >= msg + 1, cld.mu / dp, 0.0).amax(1)
    mb = torch.where(mumax > 0.0,
                     torch.minimum(mb, 0.5 / (delt * torch.where(
                         mumax <= 0, 1e30, mumax))), 0.0)
    if cfg.no_deep_pbl:
        mb = torch.where(_take_col(zm_, jt) < pblh, 0.0, mb)
    mb = torch.where(mask, mb, 0.0)

    # scale by mb (zm_conv.F90:1319-1331) and mask to triggered columns
    mbk = _c(mb)
    mu = cld.mu * mbk
    md = cld.md * mbk
    mc = cld.mc * mbk
    du = du * mbk
    eu = eu * mbk
    ed = ed * mbk
    cmeg = cmeg * mbk
    rprdg = rprdg * mbk
    cu = cu * mbk
    evpg = evpg * mbk
    sprdg = sprdg * mbk                # (zm_conv.F90:1310-1316)
    frzg = frzg * mbk
    pflxg = torch.cat([torch.zeros_like(mbk),
                       cld.pflx[:, 1:] * mbk * 100.0 / GRAV], 1)

    dqdt, dsdt, dlg, (dig, dnlg, dnig) = q1q2_pjr(
        msg, q, cld.qst, cld.qu, cld.su, du, qhat, shat, dp, mu, md, cld.sd,
        cld.qd, cld.qcde, dsubcld, jt, mx, (evpg, cu),
        microp_extra=((frzg, cld.qide, cld.qncde, cld.qnide) if cfg.microp
                      else None))
    dqdt = dqdt * maskf
    dsdt = dsdt * maskf
    dlg = dlg * maskf
    mu = mu * maskf
    md = md * maskf
    mc = mc * maskf
    du = du * maskf
    eu = eu * maskf
    ed = ed * maskf
    cmeg = cmeg * maskf
    rprdg = rprdg * maskf
    pflxg = pflxg * maskf
    qlg = cld.ql * maskf

    if cfg.microp:
        dig, dnlg, dnig = dig * maskf, dnlg * maskf, dnig * maskf
        sprdg, frzg = sprdg * maskf, frzg * maskf
        # vapour-negativity fixer (zm_conv.F90:1400-1470, the JAX
        # package's local form): where the projected q would go negative,
        # cap dqdt with latent-heat compensation and take the condensate
        # out of the same level's precipitation production, snow last
        # (rprdg may be negative, downdraft evaporation exceeding
        # production; red never removes from such levels)
        q_proj = qh + 2.0 * delt * dqdt
        deficit = torch.where(q_proj < 0.0,
                              (dqdt + 0.5 * qh / delt) / 0.9999, 0.0)
        dqdt = dqdt - deficit
        dsdt = dsdt + deficit * RL / CP
        red = torch.clamp(torch.minimum(-deficit, rprdg), min=0.0)
        rain_avail = torch.clamp(rprdg - sprdg, min=0.0)
        from_snow = torch.clamp(red - rain_avail, min=0.0)
        rprdg = rprdg - red
        sprdg = sprdg - from_snow
        dsdt = dsdt - from_snow * c.LATICE / CP
        dl_all = dlg + dig        # the detrained ice counts too (:1516)
    else:
        dl_all = dlg

    # precipitation from the column moisture change (zm_conv.F90:1495-1640)
    q_new = qh + 2.0 * delt * dqdt
    prec = (-dpp * (q_new - qh) - dpp * dl_all * 2.0 * delt).sum(1)
    prec = RGRAV * torch.clamp(prec, min=0.0) / (2.0 * delt) / 1000.0
    # reserved liquid/ice (zm_conv.F90:1645-1652)
    rliq = (dl_all * dpp / GRAV).sum(1) / 1000.0
    out = dict(
        qtnd=dqdt, heat=dsdt * CP, prec=prec,
        jctop=torch.where(mask, jt, pver - 1),
        jcbot=torch.where(mask, mx, 0),
        cape=cape, cin=bu.cin,
        mcon=torch.cat([mc * maskf, torch.zeros_like(mbk)], 1),
        dlf=dlg, pflx=pflxg, cme=cmeg, zdu=du, rprd=rprdg, mu=mu, eu=eu,
        du=du, md=md, ed=ed, dp=dp, dsubcld=dsubcld, jt=jt, maxg=mx,
        ideep=mask, eurt=eurt, ql=qlg, rliq=rliq)
    if not cfg.microp:
        z2 = torch.zeros_like(t)
        return ZMConvOut(**out, rice=torch.zeros_like(prec), dif=z2,
                         dnlf=z2, dnif=z2, sprd=z2, frz=z2, qliq=z2,
                         qice=z2, qnl=z2, qni=z2, wu=z2,
                         dcape=torch.zeros_like(prec), mrates={})
    maskc = mask.to(t.dtype)
    return ZMConvOut(
        **out, rice=(dig * dpp / GRAV).sum(1) / 1000.0, dif=dig, dnlf=dnlg,
        dnif=dnig, sprd=sprdg, frz=frzg, qliq=cld.qliq * maskf,
        qice=cld.qice * maskf, qnl=cld.qnl * maskf, qni=cld.qni * maskf,
        wu=cld.wu * maskf, dcape=cld.dcape * maskc,
        mrates={k: v * fac_mb * mbk * maskf for k, v in cld.mrates.items()})


# =============================================================================
# zm_conv_evap  (zm_conv.F90:1712-1972)
# =============================================================================

EVAP_KEYS = ("tend_s", "tend_q", "tend_s_snwprd", "tend_s_snwevmlt",
             "ntprprd", "ntsnprd", "flxprec", "flxsnow", "prec", "snow")


def zm_conv_evap(cfg: ZMConfig, t, pmid, pdel, q, landfrac, prdprec, cldfrc,
                 deltat, prec_in, prdsnow=None):
    """Sundqvist evaporation of convective precipitation with snow
    production and melt (zm_conv_evap, zm_conv.F90:1712-1972), tht
    humidity fix. Two snow formulations, keyed on `prdsnow` as in the
    reference (:1789-1794): None is the old_snow path (snow diagnosed from
    the temperature partition, its production heating +latice applied
    here); with `prdsnow` (microp's sprd profile) snow production comes
    from the in-plume scheme, whose latent-ice heat already entered
    through frz, so only the melt and evaporation cooling applies here
    (:1919-1941, 1957-1961), and the melt is partial, limited so that it
    cannot cool T below tmelt (:1828-1847).

    A descent from k=0 carrying the rain and snow fluxes and the column
    evaporation. prec_in in m/s; returns the dict of EVAP_KEYS: heating
    and moistening tendencies, interface fluxes (kg/m2/s), surface
    prec/snow (m/s) and net production terms. The old_snow path is the
    plain version of the evaporation part of the fused ZM tail kernel."""
    pver = t.shape[1]
    old_snow = prdsnow is None
    omsm = 0.9999
    prec = prec_in * 1000.0   # kg/m2/s
    _, qs = qsat_blend(t, pmid)
    _, fsnow_conv = cldfrc_fice(t)
    kemask = cfg.ke * torch.ones_like(landfrac) if not cfg.org else \
        cfg.ke * (1.0 - landfrac) + cfg.ke_lnd * landfrac

    flxprec_k = flxsnow_k = evpvint = torch.zeros_like(prec)
    names = ("tend_s", "tend_q", "tend_s_snwprd", "tend_s_snwevmlt",
             "ntprprd", "ntsnprd")
    outs = {n: [] for n in names}
    flxprec, flxsnow = [flxprec_k], [flxsnow_k]
    for k in range(pver):
        t_k, q_k, qs_k, pdel_k = t[:, k], q[:, k], qs[:, k], pdel[:, k]
        prdprec_k, cldfrc_k = prdprec[:, k], cldfrc[:, k]
        melt = t_k > TFREEZ
        if old_snow:
            flxsntm = torch.where(melt, 0.0, flxsnow_k)
            snowmlt = torch.where(melt, flxsnow_k * GRAV / pdel_k, 0.0)
        else:
            # partial melt, limited so that the cooling cannot push T
            # below tmelt (zm_conv.F90:1828-1847)
            pot = flxsnow_k * GRAV / pdel_k
            full_cool = -c.LATICE / CP * pot * deltat
            frac = torch.where(
                t_k + full_cool <= TFREEZ,
                torch.clamp((t_k - TFREEZ) * CP / c.LATICE / deltat /
                            torch.clamp(pot, min=1e-30), 0.0, 1.0),
                1.0) * omsm
            frac = torch.where(melt, frac, 0.0)
            flxsntm = flxsnow_k * (1.0 - frac)
            snowmlt = frac * pot

        # tht humidity-basis fix (zm_conv.F90:1853-1860)
        evplimit = torch.clamp(1.0 - q_k / (1.0 + q_k) / qs_k, min=0.0)
        evpprec = kemask * (1.0 - cldfrc_k) * evplimit * torch.sqrt(flxprec_k)
        evplimit2 = flxprec_k * GRAV / pdel_k
        evplimit2 = torch.minimum(evplimit2,
                                  (prec - evpvint) * GRAV / pdel_k)
        evpprec = torch.minimum(evplimit2, evpprec)
        if not old_snow:
            evpprec = torch.clamp(evpprec, min=0.0) * omsm   # (:1904-1907)

        flx_nz = torch.where(flxprec_k == 0, 1e-30, flxprec_k)
        work1 = torch.where(flxprec_k > 0.0,
                            torch.clamp(flxsntm / flx_nz, 0.0, 1.0), 0.0)
        evpsnow = evpprec * work1
        evpvint = evpvint + evpprec * pdel_k / GRAV
        ntprprd = prdprec_k - evpprec
        if old_snow:
            work1b = torch.where(flxprec_k > 0.0,
                                 torch.clamp(flxsnow_k / flx_nz, 0.0, 1.0),
                                 0.0)
            work2 = torch.maximum(fsnow_conv[:, k], work1b)
            work2 = torch.where(snowmlt > 0.0, 0.0, work2)
            ntsnprd = prdprec_k * work2 - evpsnow - snowmlt
            outs["tend_s_snwprd"].append(prdprec_k * work2 * c.LATICE)
            outs["tend_s_snwevmlt"].append(-(evpsnow + snowmlt) * c.LATICE)
            outs["tend_s"].append(-evpprec * c.LATVAP + ntsnprd * c.LATICE)
        else:
            # snow production from the in-plume scheme; its +latice heat
            # already entered through frz (zm_conv.F90:1936-1941)
            snk = torch.minimum(flxsnow_k * GRAV / pdel_k, evpsnow + snowmlt)
            ntsnprd = prdsnow[:, k] - snk
            tend_s_snwevmlt = -snk * c.LATICE
            outs["tend_s_snwprd"].append(prdsnow[:, k] * c.LATICE)
            outs["tend_s_snwevmlt"].append(tend_s_snwevmlt)
            outs["tend_s"].append(-evpprec * c.LATVAP + tend_s_snwevmlt)
        outs["tend_q"].append(evpprec)
        outs["ntprprd"].append(ntprprd)
        outs["ntsnprd"].append(ntsnprd)
        flxprec_k = torch.clamp(flxprec_k + ntprprd * pdel_k / GRAV, min=0.0)
        flxsnow_k = torch.clamp(flxsnow_k + ntsnprd * pdel_k / GRAV, min=0.0)
        flxprec.append(flxprec_k)
        flxsnow.append(flxsnow_k)

    res = {n: torch.stack(v, 1) for n, v in outs.items()}
    res["flxprec"] = torch.stack(flxprec, 1)
    res["flxsnow"] = torch.stack(flxsnow, 1)
    res["prec"] = res["flxprec"][:, -1] / 1000.0
    res["snow"] = res["flxsnow"][:, -1] / 1000.0
    return res
