"""Bulk surface fluxes over a prescribed SST: the surface coupler's stand-in.

Twin of `cam_nor_physics_tpu.models.coupling.surface_fluxes`: the Neale &
Hoskins (2000) aquaplanet SST profiles, bulk aerodynamic fluxes that make
a CamIn from the current physics state, and a slab (mixed-layer) ocean
step that closes the surface energy budget.
"""

from __future__ import annotations

import math

import torch

from ...ops.saturation import qsat
from ...utils import constants as c
from .camsrfexch import CamIn

CD = 1.3e-3          # bulk transfer coefficient (momentum/heat/moisture)
WIND_MIN = 1.0       # gustiness floor (m/s)


def aquaplanet_sst(lat, profile: str = "control"):
    """Neale & Hoskins (2000) zonally symmetric SST (K) at latitudes `lat`
    (radians): "control", "flat" or "qobs"."""
    phi = torch.abs(lat)
    x = torch.sin(1.5 * phi) ** 2
    if profile == "flat":
        t = 27.0 * (1.0 - x ** 4)
    elif profile == "qobs":
        t = 27.0 * (1.0 - 0.5 * (x + x ** 2))
    else:                                  # control
        t = 27.0 * (1.0 - x)
    return torch.where(phi < math.pi / 3.0, t, 0.0) + c.TMELT


def bulk_surface_fluxes(state, sst, pcnst: int) -> CamIn:
    """Bulk aerodynamic fluxes over ocean (the coupler's cam_in): sensible
    and latent heat, the vapour flux and the wind stress."""
    ncol = state.ncol
    dtype, dev = state.t.dtype, state.t.device
    ub, vb = state.u[:, -1], state.v[:, -1]
    tb = state.t[:, -1]
    qb = state.q[:, -1, 0]
    pb = state.pmid[:, -1]
    rho = pb / (c.RAIR * tb)
    vmag = torch.sqrt(ub ** 2 + vb ** 2 + WIND_MIN ** 2)

    shf = rho * c.CPAIR * CD * vmag * (sst - tb)
    _, qs_sst = qsat(sst, state.ps)
    qflx = rho * CD * vmag * torch.maximum(qs_sst - qb, -qb)   # kg/m2/s
    lhf = c.LATVAP * qflx
    wsx = -rho * CD * vmag * ub
    wsy = -rho * CD * vmag * vb

    cflx = torch.zeros((ncol, pcnst), dtype=dtype, device=dev)
    cflx[:, 0] = qflx
    base = CamIn.zeros(ncol, pcnst, dtype, dev)
    return base.replace(shf=shf, lhf=lhf, cflx=cflx, wsx=wsx, wsy=wsy,
                        ts=sst, sst=sst)


# slab ocean: dSST/dt = (net surface energy flux into the ocean) /
# (rho_w c_w h)
RHO_W = 1000.0
CW = 4218.0
SB_ = 5.670374419e-8


def slab_ocean_step(sst, cam_in, cam_out, dt: float, h_mix: float = 30.0,
                    q_flux=None, sst_min: float = 271.35):
    """The mixed-layer SST one step on: net flux in = netsw + flwds -
    sigma SST^4 - shf - lhf - L_f snow, less the optional prescribed
    ocean heat-transport divergence `q_flux` (W/m2); floored at the
    freezing point of sea water."""
    net = (cam_out.netsw + cam_out.flwds - SB_ * sst ** 4
           - cam_in.shf - cam_in.lhf
           - c.LATICE * c.RHOH2O * (cam_out.precsc + cam_out.precsl))
    if q_flux is not None:
        net = net - q_flux
    sst_new = sst + dt * net / (RHO_W * CW * h_mix)
    return torch.clamp(sst_new, min=sst_min)
