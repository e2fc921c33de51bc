"""Constants and aerosol activation of ZM's in-plume convective
microphysics.

Twin of `cam_nor_physics_tpu.models.physics.zm_microphysics`. The
two-moment scheme itself (`zm_mphy`) lives in zm_conv.py and runs inside
cldprp's plume iteration (the reference's zm_mphy call,
zm_conv.F90:3782-3793): freezing heat enters the updraft MSE budget,
condensate loading feeds the detrainment streams, and rain and snow
production interleave with the ascent. This module keeps the scheme
constants (Song & Zhang 2011-style process coefficients) and the
modal-aerosol activated-number reduction (the zm_aero_t role,
zm_conv_intr.F90:1032-1410).
"""

from __future__ import annotations

import math

import torch

# --- scheme constants ---------------------------------------------------
T_HOM = 233.15            # homogeneous freezing threshold (K)
T_FREEZ = 273.15
R_ACT = 7.0e-6            # activation droplet radius (m)
R_ICE0 = 25.0e-6          # fresh ice crystal radius (m)
RHO_LIQ = 1000.0
RHO_ICE = 500.0
M_ACT = (4.0 / 3.0) * 3.14159265358979 * R_ACT ** 3 * RHO_LIQ
M_ICE0 = (4.0 / 3.0) * 3.14159265358979 * R_ICE0 ** 3 * RHO_ICE
BIMM = 100.0              # Bigg immersion-freezing rate coefficient (1/s)
AIMM = 0.66               # Bigg exponent (1/K)
KK_A = 1350.0             # KK2000 autoconversion prefactor
KK_ACC = 67.0             # KK2000 accretion prefactor (qc·qr)^1.15
QI0_SNOW = 1.0e-4         # ice threshold for snow conversion (kg/kg)
TAU_SNOW = 180.0          # ice->snow relaxation time (s)
TAU_BERG = 600.0          # Wegener-Bergeron-Findeisen liquid->ice time (s)
T_BERG_PEAK = 258.15      # WBF efficiency peak (~-15 C, max ei-ew gap)
T_BERG_WIDTH = 12.0       # efficiency half-width (K)
NACT_LND = 4.0e8          # activated number per kg, land
NACT_OCN = 1.5e8          # activated number per kg, ocean
COOPER_A = 0.005e3        # Cooper (1986) crystal number: a·exp(b·dT) (1/m3)
COOPER_B = 0.304
NI_MAX = 1.0e8            # crystal-number cap (1/kg), ~Cooper at -35 C
D_ACT0 = 0.08e-6          # critical dry activation diameter at kappa=0.5 (m)


def activated_number(aero: dict):
    """Activated CCN number per kg from the modal aerosol state: the
    reduced Abdul-Razzak & Ghan role of zm_aero_init/activation
    (zm_conv_intr.F90:1032-1410).

    aero: {"num": (ncol, pver, nmodes) 1/kg, "dgnum": wet median diameter
    (m), "hygro": per-mode hygroscopicity, a tuple of floats}. Per
    lognormal mode the activated fraction is the tail above the
    kappa-scaled critical diameter d_c = D_ACT0 (0.5/kappa)^(1/3);
    sigma_g = 1.8 assumed. The critical diameters are host numbers, so
    the call copies nothing to the device."""
    num = aero["num"]
    dg = torch.clamp(aero["dgnum"], min=1.0e-10)
    denom = math.sqrt(2.0) * math.log(1.8)
    z = torch.stack([
        torch.log(dg.new_full(dg.shape[:-1],
                              D_ACT0 * (0.5 / max(h, 1e-3)) ** (1.0 / 3.0))
                  / dg[..., m]) / denom
        for m, h in enumerate(aero["hygro"])], -1)
    frac = 0.5 * torch.special.erfc(z)
    return torch.sum(num * frac, -1)
