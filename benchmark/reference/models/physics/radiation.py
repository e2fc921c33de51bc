"""Gray-atmosphere radiation: a working radiation_tend for the radheat slot.

Twin of `cam_nor_physics_tpu.models.physics.radiation`. The reference's
radiation is upstream RRTMG (physpkg.F90:2030-2051), not ported; this is
the gray two-stream scheme of Frierson et al. (2006), selected by
PhysConfig(radiation_scheme="gray").

LW: a gray gas with the optical depth
  tau(lat, sigma) = [tau_e + (tau_p - tau_e) sin^2 lat]
                    [f sigma + (1-f) sigma^4],
two streams without scattering, the downward and upward fluxes marched
level by level (Python loops of elementwise operations over the columns).
SW: a collimated beam absorbed in proportion to the water-vapour path,
the rest reaching the surface with a fixed albedo.
"""

from __future__ import annotations

import torch

from ...utils import constants as c

SB = 5.670374419e-8       # Stefan-Boltzmann
S0 = 1360.0               # solar constant (W/m2)
TAU_EQ = 4.0              # LW optical depth at the equator
TAU_POLE = 1.5            # at the poles
F_LIN = 0.1               # linear fraction of the tau profile
SW_TAU_REF = 0.12         # SW absorption optical depth scale (moist column)
ALBEDO = 0.27


def lw_gray_fluxes(t, ts, tau_int):
    """Two-stream gray LW. t: (ncol, pver) layer temperatures; ts: (ncol,)
    surface temperature; tau_int: (ncol, pver+1) optical depth at the
    interfaces (0 at the top, growing downward). Returns (up, dn) at the
    interfaces."""
    pver = t.shape[1]
    emis = 1.0 - torch.exp(-(tau_int[:, 1:] - tau_int[:, :-1]))
    b = SB * t ** 4
    # downward march from the top (D = 0)
    d = torch.zeros_like(ts)
    dn = [d]
    for k in range(pver):
        d = d * (1.0 - emis[:, k]) + b[:, k] * emis[:, k]
        dn.append(d)
    # upward march from the surface (U = sigma Ts^4)
    u = SB * ts ** 4
    up = [u]
    for k in range(pver - 1, -1, -1):
        u = u * (1.0 - emis[:, k]) + b[:, k] * emis[:, k]
        up.append(u)
    return torch.stack(up[::-1], 1), torch.stack(dn, 1)


def radiation_tend(state, cam_in):
    """Gray radiation heating and boundary fluxes (the radiation_tend
    contract), under the annual-mean insolation fit S(lat) = (S0/4)(1 -
    0.477 P2(sin lat)). Returns {qrl, qrs (J/kg/s), net_flx, FSNT, FLNT,
    FSNS, FLNS, FLWDS, NETSW_SRF}."""
    ncol = state.t.shape[0]
    lat = state.lat
    p2 = 0.5 * (3.0 * torch.sin(lat) ** 2 - 1.0)
    coszrs = torch.clamp(0.25 * (1.0 - 0.477 * p2), min=0.0)

    # ---- LW ----
    tau_inf = TAU_EQ + (TAU_POLE - TAU_EQ) * torch.sin(lat[:, None]) ** 2
    sig_int = state.pint / state.ps[:, None]
    tau_int = tau_inf * (F_LIN * sig_int + (1.0 - F_LIN) * sig_int ** 4)
    up, dn = lw_gray_fluxes(state.t, cam_in.ts, tau_int)
    net_lw = up - dn                                   # positive upward
    # layer heating: net upward flux in at the lower interface less the
    # flux out at the upper one
    qrl = c.GRAVIT * (net_lw[:, 1:] - net_lw[:, :-1]) * state.rpdel

    # ---- SW ----
    s_toa = S0 * coszrs
    wvp = torch.cumsum(state.q[:, :, 0] * state.pdel, 1) / c.GRAVIT
    trans = torch.exp(-SW_TAU_REF * torch.sqrt(torch.clamp(wvp, min=0.0)
                                               / 25.0))
    trans_int = torch.cat([torch.ones((ncol, 1), dtype=state.t.dtype,
                                      device=state.t.device), trans], 1)
    sw_dn = s_toa[:, None] * trans_int                 # (ncol, pver+1)
    qrs = c.GRAVIT * (sw_dn[:, :-1] - sw_dn[:, 1:]) * state.rpdel
    sw_sfc = sw_dn[:, -1] * (1.0 - ALBEDO)

    fsnt = s_toa - sw_dn[:, -1] * ALBEDO               # net SW at the top
    flnt = net_lw[:, 0]                                # outgoing LW at the top
    return dict(qrl=qrl, qrs=qrs, net_flx=fsnt - flnt, FSNT=fsnt, FLNT=flnt,
                FSNS=sw_sfc, FLNS=net_lw[:, -1], FLWDS=dn[:, -1],
                NETSW_SRF=sw_sfc)
