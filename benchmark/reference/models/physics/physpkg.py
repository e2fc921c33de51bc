"""Physics package driver: tphysbc / tphysac (physpkg).

Twin of `cam_nor_physics_tpu.models.physics.physpkg` (reference
physpkg.F90, the CLUBB-ordered CAM physics driver). The whole column batch
runs as one call. Parameterizations the reference calls but does not
carry (CLUBB, MG microphysics, wet deposition, and RRTMG radiation under
the default radiation_scheme="rrtmg") are stubs: each applies a zero
ptend, so the sequence, the energy accounting and the pbuf data flow are
the reference's and a real scheme can take the slot. Under
radiation_scheme="gray" the radheat slot runs the gray two-stream scheme
of radiation.py.

Pre-coupler (tphysbc, physpkg.F90:2508-2942):
  qneg3 -> energy fixer -> dry adjustment -> deep convection (ZM, whose
  tail is the zm_tail CUDA kernel on a card) -> convect_diagnostics ->
  cam_export
Post-coupler (tphysac, physpkg.F90:1342-2506):
  qneg4 -> vertical diffusion with the surface fluxes -> cloud fraction
  -> macro/micro substeps (stubs) -> wet deposition (stub) ->
  convect_deep_tend_2 -> radiation -> dry-mass/energy adjustment ->
  TEOUT for the next step's fixer

raytau0 > 0 adds Rayleigh friction to tphysac after the radiation. The
port's prognostic modal aerosol (calcsize, water uptake and the modal
optics after ZM, for a non-empty PhysConfig.aero_modes) is not carried:
tphysbc refuses a configuration that turns it on.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.fill import qneg3, qneg4
from ...utils import constants as c
from ...utils.config import PhysConfig, ZMConfig
from ..coupling.camsrfexch import CamIn, CamOut, cam_export
from .cam_diagnostics import (diag_clip_tend_writeout, diag_conv,
                              diag_conv_tend_ini, diag_physvar_ic)
from .check_energy import (check_energy_chng, check_energy_fix,
                           check_energy_gmean, column_energy)
from .cloud_fraction import cldfrc
from .constituents import ConstituentRegistry
from .convect_diagnostics import convect_diagnostics_calc
from .dadadj import dadadj_tend
from .physics_buffer import PhysicsBuffer, zm_pbuf_specs
from .radiation import radiation_tend
from .rayleigh_friction import rayleigh_friction_tend
from .state import (PhysicsState, PhysicsTend, physics_dme_adjust,
                    physics_update, ptend_init, qmin_vector, set_dry_to_wet,
                    tend_update)
from .vertical_diffusion import vertical_diffusion_tend
from .zm_conv_intr import zm_conv_tend, zm_conv_tend_2


def physpkg_pbuf_specs(ncol: int, pver: int, nmodes: int = 1,
                       pcnst: int = 1) -> dict:
    """The whole pbuf registration: the ZM set plus the driver's
    persistent fields (phys_register, physpkg.F90:100-352). nmodes sizes
    the per-mode aerosol stacks (len(phys_cfg.aero_modes)); pcnst sizes
    the moist budget snapshot."""
    specs = dict(zm_pbuf_specs(ncol, pver))
    specs.update({
        # pre-moist-processes T/q for the DTCOND/DC* family
        # (diag_conv_tend_ini, physpkg.F90:2745 -> diag_conv, :2006)
        "DTCOND_TINI": ((ncol, pver), "physpkg"),
        "DQCOND_QINI": ((ncol, pver, pcnst), "physpkg"),
        "TEOUT": ((ncol,), "global"),        # physpkg.F90:231
        # 1 once tphysac has stored a TEOUT: the fixer fires only then
        "TEOUT_VALID": ((1,), "global"),
        # end-of-physics T/q/u/v for the dynamics-tendency diagnostics
        # (physpkg.F90:1046-1049, 2470-2477)
        "DTCORE": ((ncol, pver), "global"),
        "DQCORE": ((ncol, pver), "global"),
        "DUCORE": ((ncol, pver), "global"),
        "DVCORE": ((ncol, pver), "global"),
        # gravity-wave frontogenesis sources and the QBO zonal-mean wind,
        # filled in d_p_coupling (dp_coupling.F90:313-320)
        "FRONTGF": ((ncol, pver), "global"),
        "FRONTGA": ((ncol, pver), "global"),
        "UZM": ((ncol, pver), "global"),
        "QINI": ((ncol, pver), "physpkg"),
        "CLDLIQINI": ((ncol, pver), "physpkg"),
        "CLDICEINI": ((ncol, pver), "physpkg"),
        "RLIQBC": ((ncol,), "physpkg"),      # physpkg.F90:2894
        # per-mode aerosol water uptake state for the modal optics, as
        # the reference's (pcols, pver, nmodes) fields (modal_aer_opt.F90:
        # 652-663; filled by calcsize and wateruptake, physpkg.F90:
        # 2899-2930); NAER, the per-mode number (1/kg), feeds ZM's
        # in-plume activation
        "DGNUMDRY": ((ncol, pver, nmodes), "global"),
        "DGNUMWET": ((ncol, pver, nmodes), "global"),
        "QAERWAT": ((ncol, pver, nmodes), "global"),
        "WETDENS_AP": ((ncol, pver, nmodes), "global"),
        "NAER": ((ncol, pver, nmodes), "global"),
    })
    return specs


@dataclass
class PhysRunOut:
    state: PhysicsState
    pbuf: PhysicsBuffer
    tend: PhysicsTend
    cam_out: CamOut
    diagnostics: dict


def _snap(diags: dict, phys_cfg: PhysConfig, tag: str, state,
          ptend=None) -> None:
    """Snapshot hook: with phys_cfg.cam_snapshot, the state's T/u/v/s/ps
    and every constituent, and at 'after' sites the ptend, into the
    diagnostics as SNAP_<tag>_<field>."""
    if not phys_cfg.cam_snapshot:
        return
    diags[f"SNAP_{tag}_T"] = state.t
    diags[f"SNAP_{tag}_U"] = state.u
    diags[f"SNAP_{tag}_V"] = state.v
    diags[f"SNAP_{tag}_S"] = state.s
    diags[f"SNAP_{tag}_PS"] = state.ps
    for k in range(state.pcnst):
        diags[f"SNAP_{tag}_Q{k:02d}"] = state.q[:, :, k]
    if ptend is not None:
        diags[f"SNAP_{tag}_PTEND_S"] = ptend.s
        diags[f"SNAP_{tag}_PTEND_U"] = ptend.u
        diags[f"SNAP_{tag}_PTEND_V"] = ptend.v
        for k in range(state.pcnst):
            diags[f"SNAP_{tag}_PTEND_Q{k:02d}"] = ptend.q[:, :, k]


def _stub_ptend(name: str, state: PhysicsState):
    """Zero ptend with the interface shape of a parameterization that is
    not ported (the CLUBB / MG / RRTMG / wet-deposition slots,
    physpkg.F90:1736, 1813, 2030, 1936)."""
    return ptend_init(name, state.ncol, state.pver, state.pcnst,
                      dtype=state.t.dtype, device=state.t.device)


def _update(state, ptend, dt, registry, tend):
    """physics_update with the step's tendency accumulator."""
    return physics_update(state, ptend, dt, registry), tend_update(tend,
                                                                   ptend)


def _ptend(name, state, **flags):
    return ptend_init(name, state.ncol, state.pver, state.pcnst,
                      dtype=state.t.dtype, device=state.t.device, **flags)


def tphysbc(phys_cfg: PhysConfig, zm_cfg: ZMConfig,
            registry: ConstituentRegistry, state: PhysicsState,
            pbuf: PhysicsBuffer, cam_in: CamIn, ztodt: float,
            nstep: int = 1) -> PhysRunOut:
    """Pre-coupler physics (tphysbc, physpkg.F90:2508-2942). nstep is a
    Python int: 0 (the first step) has no TEOUT, so no energy fixer and
    no dynamics tendencies."""
    if (phys_cfg.prog_modal_aero and not phys_cfg.use_oslo_aero
            and phys_cfg.aero_modes):
        raise NotImplementedError(
            "the reference carries no prognostic modal aerosol "
            "(PhysConfig.aero_modes): a configuration with it needs a "
            "reference of its own")
    ncol, pver, pcnst = state.ncol, state.pver, state.pcnst
    dtype, dev = state.t.dtype, state.t.device
    diags = {}
    tend = PhysicsTend.zeros(ncol, pver, dtype, dev)

    # step-start vapour and condensate for dme_adjust and the budgets
    pbuf = pbuf.update(QINI=state.q[:, :, 0])
    ixliq, ixice = registry.index("CLDLIQ"), registry.index("CLDICE")
    if ixliq > 0:
        pbuf = pbuf.set("CLDLIQINI", state.q[:, :, ixliq])
    if ixice > 0:
        pbuf = pbuf.set("CLDICEINI", state.q[:, :, ixice])

    # qneg3 (physpkg.F90:2702-2707)
    q_fixed, _, _ = qneg3(state.q, qmin_vector(registry, state.q))
    state = state.replace(q=q_fixed)

    _snap(diags, phys_cfg, "chkenergyfix_before", state)
    # ---- energy fixer (physpkg.F90:2726-2781): close the dycore's
    # energy error against the previous step's exported energy, only once
    # tphysac has stored one (TEOUT_VALID, a multiply, not a branch) ----
    if nstep > 0:
        heat = check_energy_fix(state, registry, pbuf.get("TEOUT")) / ztodt
        heat = heat * pbuf.get("TEOUT_VALID")[0]
    else:
        heat = torch.zeros_like(state.t)
    ptend = _ptend("chkenergyfix", state, ls=True).replace(s=heat)
    state, tend = _update(state, ptend, ztodt, registry, tend)
    efix = torch.sum(heat * state.pdel, -1) / c.GRAVIT
    state, _ = check_energy_chng(state, registry, ztodt, flx_sen=efix)
    diags["EFIX"] = efix
    diags["TFIX"] = heat[:, -1] / c.CPAIR

    # ---- T/q/u/v tendencies of the dynamics (physpkg.F90:2770-2781):
    # the post-dynamics state against what tphysac stored last step ----
    if nstep > 0:
        valid = pbuf.get("TEOUT_VALID")[0]
        diags["DTCORE"] = valid * (state.t - pbuf.get("DTCORE")) / ztodt
        diags["DQCORE"] = valid * (state.q[:, :, 0] -
                                   pbuf.get("DQCORE")) / ztodt
        diags["UTEND_CORE"] = valid * (state.u - pbuf.get("DUCORE")) / ztodt
        diags["VTEND_CORE"] = valid * (state.v - pbuf.get("DVCORE")) / ztodt

    _snap(diags, phys_cfg, "chkenergyfix_after", state, ptend=ptend)
    ini = diag_conv_tend_ini(state)
    pbuf = pbuf.update(DTCOND_TINI=ini["T_ini"], DQCOND_QINI=ini["Q_ini"])
    _snap(diags, phys_cfg, "dadadj_before", state)
    # ---- dry adiabatic adjustment (physpkg.F90:2786-2806) ----
    tend_s, tend_q = dadadj_tend(state, ztodt)
    ptend = _ptend("dadadj", state, ls=True,
                   lq=(True,) + (False,) * (pcnst - 1))
    q = ptend.q.clone()
    q[:, :, 0] = tend_q
    ptend = ptend.replace(s=tend_s, q=q)
    state, tend = _update(state, ptend, ztodt, registry, tend)

    _snap(diags, phys_cfg, "dadadj_after", state, ptend=ptend)
    _snap(diags, phys_cfg, "convect_deep_before", state)
    # ---- deep convection (physpkg.F90:2813-2868 -> zm_conv_tend); the
    # ZM tail kernel takes contiguous tensors ----
    zm_out = zm_conv_tend(zm_cfg, registry, state.contiguous(), pbuf,
                          pbuf.get("PBLH"), pbuf.get("TPERT"),
                          cam_in.landfrac, ztodt)
    state, pbuf = zm_out.state1, zm_out.pbuf
    diags.update(zm_out.diagnostics)
    prec_dp = pbuf.get("PREC_DP")
    snow_dp = pbuf.get("SNOW_DP")
    state, ediag = check_energy_chng(
        state, registry, ztodt,
        flx_cnd=prec_dp + zm_out.rliq,         # both m/s (physpkg.F90:2867)
        flx_ice=snow_dp + zm_out.rice)
    diags["ZM_TE_ERR"] = ediag.te_err

    _snap(diags, phys_cfg, "convect_deep_after", state)
    # ---- merged convection diagnostics (physpkg.F90:2885-2887) ----
    diags.update(convect_diagnostics_calc(state, pbuf))
    pbuf = pbuf.set("RLIQBC", zm_out.rliq)               # (:2894-2895)

    # ---- export to the surface models (physpkg.F90:2933-2940) ----
    cam_out = cam_export(state, prec_dp, snow_dp)
    return PhysRunOut(state=state, pbuf=pbuf, tend=tend, cam_out=cam_out,
                      diagnostics=diags)


def tphysac(phys_cfg: PhysConfig, registry: ConstituentRegistry,
            state: PhysicsState, pbuf: PhysicsBuffer, cam_in: CamIn,
            ztodt: float) -> PhysRunOut:
    """Post-coupler physics (tphysac, physpkg.F90:1342-2506). Under
    radiation_scheme="rrtmg" the radiation slot is a zero-ptend stub:
    RRTMG is not ported, as in the JAX package (its physpkg.py:467-469);
    "gray" runs radiation.radiation_tend. raytau0 > 0 adds Rayleigh
    friction after the radiation."""
    ncol, pver, pcnst = state.ncol, state.pver, state.pcnst
    dtype, dev = state.t.dtype, state.t.device
    diags = {}
    tend = PhysicsTend.zeros(ncol, pver, dtype, dev)

    # ---- qneg4 surface-flux limiter (physpkg.F90:1546-1649) ----
    cflx = qneg4(cam_in.cflx, state.q[:, -1, :],
                 state.pdel[:, -1:].expand(ncol, pcnst), ztodt, c.GRAVIT)

    _snap(diags, phys_cfg, "vertical_diffusion_before", state)
    # ---- implicit vertical diffusion with the surface fluxes
    # (vertical_diffusion_tend, physpkg.F90:2144-2171) ----
    vd = vertical_diffusion_tend(state, cam_in.shf, cflx, cam_in.wsx,
                                 cam_in.wsy, pbuf.get("PBLH"), ztodt)
    # frictional heating closes the KE budget of the momentum mixing
    u1 = state.u + vd["dudt"] * ztodt
    v1 = state.v + vd["dvdt"] * ztodt
    dke = 0.5 * ((u1 ** 2 + v1 ** 2) - (state.u ** 2 + state.v ** 2))
    ptend = _ptend("vertical_diffusion", state, ls=True, lu=True, lv=True,
                   lq=(True,) * pcnst).replace(
        s=vd["dsdt"] - dke / ztodt, u=vd["dudt"], v=vd["dvdt"],
        q=vd["dqdt"])
    state, tend = _update(state, ptend, ztodt, registry, tend)
    state, _ = check_energy_chng(state, registry, ztodt,
                                 flx_vap=cflx[:, 0], flx_sen=cam_in.shf)
    diags["KVH"] = vd["kvh"]

    _snap(diags, phys_cfg, "vertical_diffusion_after", state, ptend=ptend)
    # ---- macro/micro substeps (physpkg.F90:1719-1915); the macrophysics
    # slot's cloud fraction into the CLD pbuf field (cldfrc role) ----
    pbuf = pbuf.set("CLD", cldfrc(state, pbuf.get("CMFMC_DP")))

    _snap(diags, phys_cfg, "macmic_before", state)
    n_sub = phys_cfg.cld_macmic_num_steps
    for _ in range(n_sub):
        # clubb_tend_cam slot (physpkg.F90:1736): stub
        ptend = _stub_ptend("clubb", state)
        state, tend = _update(state, ptend, ztodt / n_sub, registry, tend)
        # microp_driver_tend slot (physpkg.F90:1813-1906): stub
        ptend = _stub_ptend("microp", state)
        state, tend = _update(state, ptend, ztodt / n_sub, registry, tend)

    _snap(diags, phys_cfg, "macmic_after", state, ptend=ptend)
    # ---- aerosol wet deposition slot (physpkg.F90:1936-1960): stub ----
    ptend = _stub_ptend("wetdep", state)
    state, tend = _update(state, ptend, ztodt, registry, tend)

    _snap(diags, phys_cfg, "convect_deep_2_before", state)
    # ---- convective tracer transport, pass 2 (physpkg.F90:1988) ----
    ptend = zm_conv_tend_2(registry, state, pbuf, ztodt)
    # the raw q + ptend dt prediction, for the clipping tendencies
    q_preclip = state.q + ptend.q * ztodt
    state, tend = _update(state, ptend, ztodt, registry, tend)
    _snap(diags, phys_cfg, "convect_deep_2_after", state, ptend=ptend)
    diags.update(diag_clip_tend_writeout(
        q_preclip, state.q, ztodt, 0, registry.index("CLDLIQ"),
        registry.index("CLDICE")))

    # ---- moist budget family (diag_conv, physpkg.F90:2006) against the
    # pre-moist snapshot tphysbc stored ----
    diags.update(diag_conv(
        state, {"T_ini": pbuf.get("DTCOND_TINI"),
                "Q_ini": pbuf.get("DQCOND_QINI")}, ztodt,
        cnst_names=registry.names))

    _snap(diags, phys_cfg, "radiation_before", state)
    # ---- radiation slot (physpkg.F90:2030-2051) ----
    if phys_cfg.radiation_scheme == "gray":
        rad = radiation_tend(state, cam_in)
        ptend = _ptend("radheat", state, ls=True).replace(
            s=rad["qrl"] + rad["qrs"])
        state, tend = _update(state, ptend, ztodt, registry, tend)
        # the column's radiative gain: SW absorbed in the air plus the
        # net LW gain
        state, _ = check_energy_chng(
            state, registry, ztodt,
            flx_sen=(rad["FSNT"] - rad["FSNS"]) +
                    (rad["FLNS"] - rad["FLNT"]))
        for k in ("FSNT", "FLNT", "FSNS", "FLNS", "FLWDS"):
            diags[k] = rad[k]
        diags["QRL"] = rad["qrl"] / c.CPAIR
        diags["QRS"] = rad["qrs"] / c.CPAIR
    else:
        # RRTMG slot: stub (zero ptend)
        ptend = _stub_ptend("radheat", state)
        state, tend = _update(state, ptend, ztodt, registry, tend)
    _snap(diags, phys_cfg, "radiation_after", state, ptend=ptend)

    # ---- Rayleigh friction (physpkg.F90:2177-2185) ----
    if phys_cfg.raytau0 > 0.0:
        _snap(diags, phys_cfg, "rayleigh_before", state)
        dudt, dvdt, dsdt = rayleigh_friction_tend(
            state, ztodt, phys_cfg.rayk0, phys_cfg.raykrange,
            phys_cfg.raytau0)
        ptend = _ptend("rayleigh_friction", state, ls=True, lu=True,
                       lv=True).replace(u=dudt, v=dvdt, s=dsdt)
        state, tend = _update(state, ptend, ztodt, registry, tend)
        state, _ = check_energy_chng(state, registry, ztodt)
        _snap(diags, phys_cfg, "rayleigh_after", state, ptend=ptend)

    _snap(diags, phys_cfg, "dme_adjust_before", state)
    # ---- dry-mass / energy adjustment (physpkg.F90:2394-2452): the FV
    # dycore is moist, so dry-type tracers go back to the wet basis and
    # the layer masses follow the vapour change since the step began ----
    state = set_dry_to_wet(state, registry)
    t_pre_dme = state.t
    state = physics_dme_adjust(state, pbuf.get("QINI"), registry)
    diags["PTTEND_DME"] = (state.t - t_pre_dme) / ztodt
    diags["IETEND_DME"] = torch.sum(
        c.CPAIR * (state.t - t_pre_dme) * state.pdel, -1) / (c.GRAVIT * ztodt)

    _snap(diags, phys_cfg, "dme_adjust_after", state)
    diags.update(diag_physvar_ic(pbuf))
    # ---- TEOUT for the next step's energy fixer (physpkg.F90:2394) and
    # the end-of-physics state for its dynamics tendencies (:2470-2477)
    te, _ = column_energy(state, registry)
    pbuf = pbuf.update(
        TEOUT=te, TEOUT_VALID=torch.ones((1,), dtype=dtype, device=dev),
        DTCORE=state.t, DQCORE=state.q[:, :, 0],
        DUCORE=state.u, DVCORE=state.v)

    cam_out = cam_export(state, pbuf.get("PREC_DP"), pbuf.get("SNOW_DP"))
    if "FLWDS" in diags:
        # the radiation's surface fluxes to the coupler (netsw/flwds)
        cam_out = cam_out.replace(netsw=diags["FSNS"], flwds=diags["FLWDS"])
    return PhysRunOut(state=state, pbuf=pbuf, tend=tend, cam_out=cam_out,
                      diagnostics=diags)


def phys_run1(phys_cfg: PhysConfig, zm_cfg: ZMConfig,
              registry: ConstituentRegistry, state: PhysicsState,
              pbuf: PhysicsBuffer, cam_in: CamIn, ztodt: float,
              nstep: int = 1) -> PhysRunOut:
    """Pre-coupler driver (phys_run1, physpkg.F90:1057-1173): tphysbc on
    the whole column batch, and the global-mean energy
    (check_energy_gmean, :1115) as TEGMEAN."""
    out = tphysbc(phys_cfg, zm_cfg, registry, state, pbuf, cam_in, ztodt,
                  nstep)
    out.diagnostics["TEGMEAN"] = check_energy_gmean(out.state, registry)
    return out


def phys_run2(phys_cfg: PhysConfig, registry: ConstituentRegistry,
              state: PhysicsState, pbuf: PhysicsBuffer, cam_in: CamIn,
              ztodt: float) -> PhysRunOut:
    """Post-coupler driver (phys_run2, physpkg.F90:1179-1293)."""
    return tphysac(phys_cfg, registry, state, pbuf, cam_in, ztodt)
