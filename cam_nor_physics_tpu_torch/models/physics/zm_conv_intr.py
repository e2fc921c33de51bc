"""ZM convection CAM interface — zm_conv_tend / zm_conv_tend_2.

Twin of `cam_nor_physics_tpu.models.physics.zm_conv_intr` (reference
zm_conv_intr.F90:390-1028): runs the ZM core on a PhysicsState, applies
its tendencies through physics_update in the reference's order (deep
convection -> evaporation -> momentum transport -> convtran1), stores the
mass fluxes and precipitation in the physics buffer, and returns the
summed ptend with the diagnostics. With microp the in-plume
microphysics' detrainment and in-plume fields go to the pbuf and its
outfld family to the diagnostics, and the evaporation takes its snow
production (prdsnow).

The tail (evaporation, momentum transport, convtran1) is ONE call of
the fused tail (`ops.zm_tail_kernels.zm_tail`: its CUDA kernel for a
state on a CUDA device, its plain version on the CPU) when the JAX
package's structural conditions hold: some tracer is in convtran1,
neither Q nor ZM_ORG is among them, and microp is off (the conv/evap/org
updates then never touch u, v or the transported tracers; the tail has
no prdsnow path, in the kernel as in the JAX package's Pallas tail).
Otherwise the separate plain zm_conv_evap, momtran and convtran run, as
in the JAX package; that choice is made before any launch, and is the
same on either device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.zm_tail_kernels import zm_tail
from ...utils import constants as c
from ...utils.config import ZMConfig
from ...utils.timing import spanned
from .constituents import ConstituentRegistry
from .physics_buffer import PhysicsBuffer
from .state import (PhysicsPtend, PhysicsState, physics_update, ptend_init,
                    ptend_sum, refresh_dse)
from .zm_conv import zm_conv_evap, zm_convr
from .zm_transport import convtran, momtran

# ZM_ORG organization-tracer parameters (the zmconv_org pathway)
ORG_TAU = 10800.0      # decay timescale (s)
ORG_PROD = 1.0e3       # production per unit evap moistening rate
ORG2TPERT = 50.0       # K per unit near-surface organization

@dataclass
class ZMTendOut:
    ptend_all: PhysicsPtend
    state1: PhysicsState          # provisionally updated state
    pbuf: PhysicsBuffer
    # coupler-facing outputs (zm_conv_tend arg list)
    mcon: torch.Tensor            # kg/m2/s at interfaces
    cme: torch.Tensor
    zdu: torch.Tensor
    pflx: torch.Tensor
    rliq: torch.Tensor
    rice: torch.Tensor
    jctop: torch.Tensor
    jcbot: torch.Tensor
    diagnostics: dict             # outfld payload (CAPE, FREQZM, ZMDT, ...)


TEND_FIELDS = ("mcon", "cme", "zdu", "pflx", "rliq", "rice", "jctop",
               "jcbot")


def _with_q(ptend, m, value):
    """ptend with its tracer m tendency set to `value`."""
    q = ptend.q.clone()
    q[:, :, m] = value
    return ptend.replace(q=q)


def _take_level(arr, idx):
    """arr[i, idx[i]] with jnp.take_along_axis' index rules: a negative
    index counts from the bottom, one outside the column gives NaN. Only a
    column whose state is not finite has such an index (its plume levels
    come out of NaN comparisons); a gather would raise there, on a card as
    a device-side assert."""
    nk = arr.shape[1]
    idx = torch.where(idx < 0, idx + nk, idx)
    got = torch.gather(arr, 1, idx.clamp(0, nk - 1)[:, None])[:, 0]
    return torch.where((idx >= 0) & (idx < nk), got,
                       torch.full_like(got, float("nan")))


@spanned("zm_conv_tend")
def zm_conv_tend(cfg: ZMConfig, registry: ConstituentRegistry,
                 state: PhysicsState, pbuf: PhysicsBuffer,
                 pblh, tpert, landfrac, ztodt: float, msg: int = 0,
                 aero: dict | None = None) -> ZMTendOut:
    """Deep-convection tendency driver (zm_conv_tend, zm_conv_intr.F90:
    390-951). `aero` is the modal aerosol bundle for the in-plume
    activation when microp is on (zm_aero_init role, :1032-1410); None
    takes the land/ocean activation constants."""
    ncol, pver, pcnst = state.ncol, state.pver, state.pcnst
    dtype, dev = state.t.dtype, state.t.device
    diags = {}

    # ---- ZM_ORG organization feedback (zm_conv_intr.F90:101-172) ----
    ix_org = registry.index("ZM_ORG") if cfg.org else -1
    if ix_org > 0:
        org_low = torch.mean(state.q[:, -5:, ix_org], -1)
        tpert = tpert + torch.clamp(ORG2TPERT * org_low, 0.0, 2.0)
        diags["ZM_ORG2D"] = org_low

    # ---- zm_convr on the current state (intr:662-673; delt = ztodt/2) ----
    out = zm_convr(cfg, msg, state.t, state.q[:, :, 0], state.pmid,
                   state.pint, state.pdel, state.zm, state.phis, state.zi,
                   pblh, tpert, landfrac, 0.5 * ztodt, aero=aero)

    maskf = out.ideep.to(dtype)
    diags["CAPE"] = out.cape
    diags["FREQZM"] = maskf
    mcon_kg = out.mcon * 100.0 / c.GRAVIT        # mb/s -> kg/m2/s (intr:701)
    diags["CMFMC_DP"] = mcon_kg
    diags["ZMMU"] = out.mu * 100.0 / c.GRAVIT
    diags["ZMMD"] = out.md * 100.0 / c.GRAVIT
    diags["ZMDT"] = out.heat / c.CPAIR
    diags["ZMDQ"] = out.qtnd
    diags["DLFZM"] = out.dlf
    diags["EURT"] = out.eurt[:, -1]
    diags["PCONVT"] = torch.where(out.ideep, _take_level(state.pmid, out.jt),
                                  state.ps)
    diags["PCONVB"] = torch.where(out.ideep,
                                  _take_level(state.pmid, out.maxg),
                                  state.ps)

    # convective microphysics: the scheme ran in-plume inside cldprp
    # (out.heat holds its latice frz heating, q1q2 :4378); its outputs
    # go to the pbuf and the zm_conv_micro_outfld family
    # (zm_conv_intr.F90:1292-1390)
    if cfg.microp:
        pbuf = pbuf.update(DNLFZM=out.dnlf, DNIFZM=out.dnif,
                           DP_CLDLIQ=out.qliq, DP_CLDICE=out.qice)
        diags.update(
            DNLFZM=out.dnlf, DNIFZM=out.dnif, ZMSPRD=out.sprd,
            ZMFRZ=out.frz * c.LATICE / c.CPAIR,       # conv%frz (K/s)
            ZMNLIQ=out.qnl, ZMNICE=out.qni, ZMDCAPE=out.dcape,
            DIFZM=out.dif, CLDLIQZM=out.qliq, CLDICEZM=out.qice,
            ICIMRDP=out.qice, QNLZM=out.qnl, QNIZM=out.qni, WUZM=out.wu,
            FRZZM=out.frz, CLIQSNUM=(out.qliq > 0.0).to(dtype),
            CICESNUM=(out.qice > 0.0).to(dtype),
            WUZMSNUM=(out.wu > 0.0).to(dtype))
        diags.update(out.mrates)

    lq = (True,) + (False,) * (pcnst - 1)
    ptend_conv = ptend_init("zm_convr", ncol, pver, pcnst, ls=True, lq=lq,
                            dtype=dtype, device=dev)
    ptend_conv = _with_q(ptend_conv.replace(s=out.heat), 0, out.qtnd)
    ptend_all = ptend_init("zm_conv_tend", ncol, pver, pcnst, dtype=dtype,
                           device=dev)
    ptend_all = ptend_sum(ptend_all, ptend_conv, name="zm_conv_tend")
    # intermediate updates defer the zi/zm/s refresh: nothing before the
    # final refresh_dse reads them (evap reads t/q/p, momtran u/v,
    # convtran q)
    state1 = physics_update(state, ptend_conv, ztodt, registry,
                            refresh=False)

    doconv = registry.mask("is_convtran1")
    tr_idx = [m for m in range(pcnst) if doconv[m]]
    # the fused tail is valid where conv/evap/org updates never touch u, v
    # or the convtran-1 species: these conditions
    fused_tail = (len(tr_idx) > 0 and 0 not in tr_idx
                  and ix_org not in tr_idx and not cfg.microp)
    cld = pbuf.get("CLD")
    if fused_tail:
        # the tracers gathered and scattered by stacking slices, not by a
        # list index (which copies the index from the host: no CUDA graph)
        ev, mt, dq_sub = zm_tail(
            cfg, state1.t, state1.q[:, :, 0].contiguous(), state1.pmid,
            state1.pdel, state1.u, state1.v,
            torch.stack([state1.q[:, :, m] for m in tr_idx], -1), cld,
            out.mu, out.md, out.du, out.eu, out.ed, out.dp, out.jt,
            out.maxg, out.rprd, out.prec, landfrac, ztodt)
        zero = torch.zeros((ncol, pver), dtype=dtype, device=dev)
        dq_tran = torch.stack([dq_sub[:, :, tr_idx.index(m)]
                               if m in tr_idx else zero
                               for m in range(pcnst)], -1)
    else:
        ev = zm_conv_evap(cfg, state1.t, state1.pmid, state1.pdel,
                          state1.q[:, :, 0], landfrac, out.rprd, cld, ztodt,
                          out.prec, prdsnow=out.sprd if cfg.microp else None)
    ptend_evap = ptend_init("zm_conv_evap", ncol, pver, pcnst, ls=True,
                            lq=lq, dtype=dtype, device=dev)
    ptend_evap = _with_q(ptend_evap.replace(s=ev["tend_s"]), 0, ev["tend_q"])
    diags["EVAPTZM"] = ev["tend_s"] / c.CPAIR
    diags["EVAPQZM"] = ev["tend_q"]
    diags["FZSNTZM"] = ev["tend_s_snwprd"] / c.CPAIR
    diags["EVSNTZM"] = ev["tend_s_snwevmlt"] / c.CPAIR
    diags["ZMFLXPRC"] = ev["flxprec"]
    diags["ZMFLXSNW"] = ev["flxsnow"]
    diags["ZMNTPRPD"] = ev["ntprprd"]
    diags["ZMNTSNPD"] = ev["ntsnprd"]
    diags["PRECZ"] = ev["prec"]
    ptend_all = ptend_sum(ptend_all, ptend_evap, name="zm_conv_tend")
    state1 = physics_update(state1, ptend_evap, ztodt, registry,
                            refresh=False)

    # ---- ZM_ORG source/decay (intr:773-777) ----
    if ix_org > 0:
        prod = ORG_PROD * torch.clamp(ev["tend_q"], min=0.0)
        dorg = prod - state1.q[:, :, ix_org] / ORG_TAU
        lq_org = tuple(m == ix_org for m in range(pcnst))
        ptend_org = ptend_init("zm_org", ncol, pver, pcnst, lq=lq_org,
                               dtype=dtype, device=dev)
        ptend_org = _with_q(ptend_org, ix_org, dorg)
        ptend_all = ptend_sum(ptend_all, ptend_org, name="zm_conv_tend")
        state1 = physics_update(state1, ptend_org, ztodt, registry,
                                refresh=False)

    # ---- momentum transport (intr:822-858) ----
    if not fused_tail:
        mt = momtran(state1.u, state1.v, out.mu, out.md, out.du, out.eu,
                     out.ed, out.dp, out.jt, out.maxg, ztodt, cfg.momcu,
                     cfg.momcd)
    ptend_mom = ptend_init("momtran", ncol, pver, pcnst, ls=True, lu=True,
                           lv=True, dtype=dtype, device=dev)
    ptend_mom = ptend_mom.replace(u=mt["dudt"], v=mt["dvdt"], s=mt["seten"])
    diags["ZMMTT"] = mt["seten"] / c.CPAIR
    diags["ZMMTU"] = mt["dudt"]
    diags["ZMMTV"] = mt["dvdt"]
    diags["ZMUPGU"] = mt["pguall"][0]
    diags["ZMVPGU"] = mt["pguall"][1]
    diags["ZMICUU"] = mt["icwu"][0]
    diags["ZMICVU"] = mt["icwu"][1]
    ptend_all = ptend_sum(ptend_all, ptend_mom, name="zm_conv_tend")
    state1 = physics_update(state1, ptend_mom, ztodt, registry,
                            refresh=False)

    # ---- convective transport pass 1: cloud liquid/ice (intr:875-886) ----
    if not fused_tail:
        dq_tran = convtran(doconv, state1.q, out.mu, out.md, out.du, out.eu,
                           out.ed, out.dp, out.jt, out.maxg, ztodt)
    ptend_tr = ptend_init("convtran1", ncol, pver, pcnst, lq=doconv,
                          dtype=dtype, device=dev).replace(q=dq_tran)
    ix_liq = registry.index("CLDLIQ")
    ix_ice = registry.index("CLDICE")
    if ix_liq > 0:
        diags["ZMDLIQ"] = dq_tran[:, :, ix_liq]
    if ix_ice > 0:
        diags["ZMDICE"] = dq_tran[:, :, ix_ice]
    ptend_all = ptend_sum(ptend_all, ptend_tr, name="zm_conv_tend")
    state1 = physics_update(state1, ptend_tr, ztodt, registry,
                            refresh=False)
    state1 = refresh_dse(state1)

    # ---- pbuf stores (intr:591-621 / evaporation block) ----
    pbuf = pbuf.update(
        ZM_MU=out.mu, ZM_EU=out.eu, ZM_DU=out.du, ZM_MD=out.md, ZM_ED=out.ed,
        ZM_DP=out.dp, ZM_DSUBCLD=out.dsubcld,
        ZM_JT=out.jt.to(dtype), ZM_MAXG=out.maxg.to(dtype),
        ZM_IDEEP=maskf, RPRDDP=out.rprd, ICWMRDP=out.ql,
        NEVAPR_DPCU=ev["tend_q"], PREC_DP=ev["prec"], SNOW_DP=ev["snow"],
        DP_FLXPRC=ev["flxprec"], DP_FLXSNW=ev["flxsnow"],
        DLFZM=out.dlf, DIFZM=out.dif, CMFMC_DP=mcon_kg)

    return ZMTendOut(ptend_all=ptend_all, state1=state1, pbuf=pbuf,
                     mcon=mcon_kg, cme=out.cme, zdu=out.zdu, pflx=out.pflx,
                     rliq=out.rliq, rice=out.rice, jctop=out.jctop,
                     jcbot=out.jcbot, diagnostics=diags)


def zm_conv_tend_2(registry: ConstituentRegistry, state: PhysicsState,
                   pbuf: PhysicsBuffer, ztodt: float) -> PhysicsPtend:
    """Second convective-transport pass on convtran2 species with dry dp
    (zm_conv_tend_2, zm_conv_intr.F90:955-1028; called from tphysac)."""
    ncol, pver, pcnst = state.ncol, state.pver, state.pcnst
    doconv = registry.mask("is_convtran2")
    ptend = ptend_init("convtran2", ncol, pver, pcnst, lq=doconv,
                       dtype=state.t.dtype, device=state.t.device)
    if not any(doconv):
        return ptend
    dq = convtran(doconv, state.q, pbuf.get("ZM_MU"), pbuf.get("ZM_MD"),
                  pbuf.get("ZM_DU"), pbuf.get("ZM_EU"), pbuf.get("ZM_ED"),
                  pbuf.get("ZM_DP"), pbuf.get("ZM_JT").long(),
                  pbuf.get("ZM_MAXG").long(), ztodt,
                  dpdry=state.pdeldry * 0.01, dry_mask=tuple(
                      cn.mixtype == "dry" for cn in registry.constituents))
    return ptend.replace(q=dq)
