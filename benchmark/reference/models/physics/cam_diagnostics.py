"""General physics diagnostics (cam_diagnostics).

Twin of `cam_nor_physics_tpu.models.physics.cam_diagnostics` (reference
cam_diagnostics.F90): the diagnostics the coupled step computes, each
builder returning {name: tensor}:

  diag_conv_tend_ini      (:1306) pre-moist-processes T/q snapshot
  diag_conv               (:2021) moist budget terms DTCOND, DC*
  diag_clip_tend_writeout (:1975) negative-water clipping tendencies
  diag_physvar_ic         (:2368) pbuf physics variables for IC tapes
  diag_phys_tend_writeout (:2696) before/after-physics state and the
                                  total physics tendencies
  constituent_burdens             column burdens CB_<name>
  tidal_coeffs, diag_conv_tidal   DTCOND times local-solar-time harmonics

The port's history catalog and its tape payload builders (the driver's
history writer's) are not carried: the reference runs the step, not the
driver.
"""

from __future__ import annotations

import math

import torch

from ...utils import constants as c

# pbuf physics variables written to IC tapes (diag_physvar_ic, :2368-2500)
_IC_FIELDS = [
    ("QCWAT", "kg/kg", "q associated with cloud water", "mid"),
    ("TCWAT", "K", "T associated with cloud water", "mid"),
    ("LCWAT", "kg/kg", "Cloud water (liq+ice)", "mid"),
    ("CLOUD", "fraction", "Cloud fraction", "mid"),
    ("CONCLD", "fraction", "Convective cloud fraction", "mid"),
    ("CUSH", "Pa", "Convective scale height", "srf"),
    ("TKE", "m2/s2", "Turbulent kinetic energy", "int"),
    ("KVM", "m2/s", "Vertical diffusivity (momentum)", "int"),
    ("KVH", "m2/s", "Vertical diffusivity (heat/moisture)", "int"),
    ("PBLH", "m", "PBL height", "srf"),
    ("TPERT", "K", "Perturbation temperature (eddies in PBL)", "srf"),
    ("QPERT", "kg/kg", "Perturbation specific humidity (eddies in PBL)",
     "srf"),
]


def constituent_burdens(state, cnst_names) -> dict:
    """Column burdens of every constituent but water vapour (upstream
    constituent_burden_comp, cam_diagnostics.F90:867-868, 1737-1738)."""
    return {"CB_" + name: torch.sum(state.q[:, :, m] * state.pdel, -1)
            / c.GRAVIT
            for m, name in enumerate(cnst_names) if m > 0}


def diag_conv_tend_ini(state) -> dict:
    """Pre-moist-processes snapshot for the budget differences
    (diag_conv_tend_ini, called at physpkg.F90:2745); it crosses to
    tphysac through the pbuf (DTCOND_TINI/DQCOND_QINI)."""
    return {"T_ini": state.t, "Q_ini": state.q}


def diag_conv(state, ini: dict, ztodt: float, cnst_names=()) -> dict:
    """Moist budget terms (diag_conv, called at physpkg.F90:2006): DTCOND,
    DCQ and DC<name> for every other constituent."""
    q_ini = ini["Q_ini"]
    out = {"DTCOND": (state.t - ini["T_ini"]) / ztodt,
           "DCQ": (state.q[:, :, 0] - q_ini[:, :, 0]) / ztodt}
    for m, name in enumerate(cnst_names):
        if m > 0:
            out["DC" + name] = (state.q[:, :, m] - q_ini[:, :, m]) / ztodt
    return out


def tidal_coeffs(lons, time_days):
    """Local-solar-time tide coefficients (tidal_diag role, cam_diagnostics.
    F90:2156-2161): sin and cos of the 24, 12 and 8 hour harmonics of
    theta = 2 pi (time_days mod 1) + lon, lon in radians. `time_days` is
    a tensor of lons' dtype. Returns (6, nlon) ordered [24_SIN, 24_COS,
    12_SIN, 12_COS, 08_SIN, 08_COS]."""
    theta = 2.0 * math.pi * torch.remainder(time_days, 1.0) + lons
    return torch.stack([f(n * theta) for n in (1.0, 2.0, 3.0)
                        for f in (torch.sin, torch.cos)])


def diag_conv_tidal(dtcond, coeffs) -> dict:
    """DTCOND times the tidal coefficients (cam_diagnostics.F90:2156-2161).
    dtcond: (ncol, pver), ncol = jm*im row-major; coeffs: (6, im)."""
    names = ("DTCOND_24_SIN", "DTCOND_24_COS", "DTCOND_12_SIN",
             "DTCOND_12_COS", "DTCOND_08_SIN", "DTCOND_08_COS")
    col = coeffs.repeat(1, dtcond.shape[0] // coeffs.shape[1])
    return {n: dtcond * col[i][:, None] for i, n in enumerate(names)}


def diag_phys_tend_writeout(state_before, state_after, ztodt: float,
                            cnst_names=()) -> dict:
    """Before/after-physics snapshots and the total physics tendencies
    (the TBP/TAP families, cam_diagnostics.F90:246-298, 2696,
    2748-2833)."""
    rdt = 1.0 / ztodt
    out = {}
    for m, name in enumerate(cnst_names):
        if name in ("Q", "CLDLIQ", "CLDICE"):
            out[name + "BP"] = state_before.q[:, :, m]
            out[name + "AP"] = state_after.q[:, :, m]
    dt_ = (state_after.t - state_before.t) * rdt
    du = (state_after.u - state_before.u) * rdt
    dv = (state_after.v - state_before.v) * rdt
    return out | {
        "TBP": state_before.t, "UBP": state_before.u, "VBP": state_before.v,
        "TAP": state_after.t, "UAP": state_after.u, "VAP": state_after.v,
        "PTTEND": dt_, "UTEND_PHYSTOT": du, "VTEND_PHYSTOT": dv,
        "TTEND_TOT": dt_, "UTEND_TOT": du, "VTEND_TOT": dv,
    }


def diag_clip_tend_writeout(q_preclip, q_clipped, ztodt: float, ix_q: int,
                            ix_cldliq: int, ix_cldice: int) -> dict:
    """Clipping tendencies from the pre-clip prediction and the clipped
    result ((state%q - preclip) / dt, cam_diagnostics.F90:2007-2012)."""
    rdt = 1.0 / ztodt
    return {name: (q_clipped[:, :, ix] - q_preclip[:, :, ix]) * rdt
            for name, ix in (("VNEGCLPTEND", ix_q),
                             ("LNEGCLPTEND", ix_cldliq),
                             ("INEGCLPTEND", ix_cldice)) if ix >= 0}


def diag_physvar_ic(pbuf) -> dict:
    """Physics-buffer variables for IC tapes (diag_physvar_ic,
    cam_diagnostics.F90:2368-2500): each present field as NAME&IC."""
    return {name + "&IC": pbuf.get(name) for name, *_ in _IC_FIELDS
            if pbuf.has(name)}
