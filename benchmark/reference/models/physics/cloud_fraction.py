"""Diagnostic cloud fraction (cldfrc).

Twin of `cam_nor_physics_tpu.models.physics.cloud_fraction`: the classic
CAM diagnostic that fills the CLD pbuf field ZM's evaporation reads
(zm_conv.F90:1712-1972): a Sundqvist RH fraction with pressure-dependent
thresholds, plus a convective fraction from the updraft mass flux, as
overlapping areas.
"""

from __future__ import annotations

import torch

from ...ops.saturation import qsat

RHMIN_HIGH = 0.80      # RH threshold, p < premib (high and middle cloud)
RHMIN_LOW = 0.91       # RH threshold, low cloud
PREMIB = 750.0e2       # Pa: boundary between the regimes
SH1 = 0.04             # convective-fraction coefficients (CAM cldfrc)
SH2 = 500.0


def cldfrc_sundqvist(rh, rhmin):
    """Sundqvist (1988): C = 1 - sqrt((1 - RH) / (1 - RHmin))."""
    x = torch.clamp((rh - rhmin) / (1.0 - rhmin), 0.0, 1.0)
    return 1.0 - torch.sqrt(torch.clamp(1.0 - x, 0.0, 1.0))


def cldfrc(state, cmfmc):
    """Total diagnostic cloud fraction (ncol, pver): the stratiform
    Sundqvist fraction with the low or high threshold by pressure, the
    convective fraction sh1 log(1 + sh2 mc) from the interface mass flux
    cmfmc (ncol, pver+1), combined as C = Cc + (1 - Cc) Cs."""
    _, qs = qsat(state.t, state.pmid)
    rh = torch.clamp(state.q[:, :, 0] / torch.clamp(qs, min=1.0e-12),
                     0.0, 1.0)
    rhmin = torch.where(state.pmid > PREMIB, RHMIN_LOW,
                        torch.full_like(state.pmid, RHMIN_HIGH))
    c_strat = cldfrc_sundqvist(rh, rhmin)
    mc = 0.5 * (cmfmc[:, 1:] + cmfmc[:, :-1])          # to midpoints
    c_conv = torch.clamp(SH1 * torch.log1p(SH2 * torch.clamp(mc, min=0.0)),
                         0.0, 0.8)
    return torch.clamp(c_conv + (1.0 - c_conv) * c_strat, 0.0, 1.0)
