"""Modal aerosol dry-size diagnosis and hygroscopic water uptake.

Twin of `cam_nor_physics_tpu.models.physics.modal_aero_wateruptake`: the
counterparts of the upstream CAM modules `modal_aero_calcsize` and
`modal_aero_wateruptake`, which fill the DGNUMWET / QAERWAT pbuf fields the
modal optics read (modal_aer_opt.F90:697-704) and which physpkg drives
(physpkg.F90:2899-2930).

  calcsize: per mode, the dry number-mode diameter from the mode's dry
    volume and number mixing ratios, v = (pi/6) dgnum^3 exp(4.5 ln^2
    sigma) n, the number first clipped so that dgnum lands in [dgnumlo,
    dgnumhi].

  wateruptake: per mode, the equilibrium wet radius of the volume-mean
    particle from Koehler theory, ln S = A/r_w - B r_d^3/(r_w^3 - r_d^3),
    with Kelvin parameter A and volume-weighted hygroscopicity B, by a
    fixed number of contraction iterations; the water content ramps
    linearly between rhcrystal and rhdeliques (hysteresis).

Every function works on whole (ncol, pver) tensors and reads no device
value on the host.
"""

from __future__ import annotations

import math

import torch

RHOH2O = 1000.0          # density of liquid water (kg/m3)
KELVIN_A = 2.1e-9        # Kelvin-effect parameter A (m), CAM's kohlerc value
RH_CAP = 0.98            # max RH the uptake sees (CAM caps hygroscopic
                         # growth at 98% against the Koehler singularity)
PI43 = 4.0 * math.pi / 3.0


def _cbrt(x):
    """Real cube root (jnp.cbrt); torch has none."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def mode_dry_volume(specmmr, species_density):
    """Total dry volume mixing ratio of a mode (m3 per kg air)."""
    return sum(m / d for m, d in zip(specmmr, species_density))


def modal_aero_calcsize(specmmr, species_density, sigma_logr,
                        dgnum_default, dgnumlo, dgnumhi, num_mmr=None):
    """The dry number-mode diameter (upstream modal_aero_calcsize role,
    called at modal_aer_opt.F90:699-700).

    specmmr: list of (ncol, pver) species mass mixing ratios; num_mmr: an
    optional (ncol, pver) number mixing ratio (# per kg air). Returns
    (dgnumdry, naer, dryvol): diameter (m), number (#/kg), volume
    (m3/kg)."""
    dryvol = mode_dry_volume(specmmr, species_density)
    alnsg2 = math.log(sigma_logr) ** 2
    vfac = (math.pi / 6.0) * math.exp(4.5 * alnsg2)   # vol = vfac dg^3 n
    if num_mmr is None:
        naer = dryvol / (vfac * dgnum_default ** 3)
    else:
        # clip the number so the implied diameter stays in [lo, hi]
        n_min = dryvol / (vfac * dgnumhi ** 3)
        n_max = dryvol / (vfac * dgnumlo ** 3)
        naer = torch.minimum(torch.maximum(num_mmr, n_min), n_max)
    safe_n = torch.clamp(naer, min=1.0e-30)
    dgnum = _cbrt(dryvol / (vfac * safe_n))
    dgnum = torch.clamp(dgnum, dgnumlo, dgnumhi)
    dgnum = torch.where(dryvol > 1.0e-30, dgnum, dgnum_default)
    return dgnum, naer, dryvol


def kohler_wet_radius(rdry, hygro, rh, n_iter: int = 40):
    """Equilibrium wet radius from Koehler theory: the fixed point
    r_w = r_d (1 + B / (A/r_w - ln S))^(1/3), a contraction for S < 1,
    over a fixed n_iter iterations; RH capped at RH_CAP. Returns
    r_w >= r_d."""
    s = torch.clamp(rh, 0.0, RH_CAP)
    lns = torch.log(torch.clamp(s, min=1.0e-10))      # <= log(0.98) < 0
    b = torch.clamp(hygro, min=0.0)
    rw = rdry * _cbrt(1.0 + b / torch.clamp(-lns, min=1.0e-10))
    for _ in range(n_iter):
        denom = torch.clamp(KELVIN_A / torch.clamp(rw, min=1.0e-12) - lns,
                            min=1.0e-12)
        rw = rdry * _cbrt(1.0 + b / denom)
    return torch.maximum(rw, rdry)


def modal_aero_wateruptake(specmmr, species_density, species_hygro,
                           sigma_logr, dgnumdry, naer, rh,
                           rhcrystal: float = 0.35,
                           rhdeliques: float = 0.80):
    """Hygroscopic growth of one mode (upstream modal_aero_wateruptake_dr
    role, modal_aer_opt.F90:701-704; fills DGNUMWET / QAERWAT, which the
    optics read at :713-714).

    Returns dict(dgnumwet, qaerwat, wetdens, hygro): the wet diameter (m),
    the aerosol water (kg/kg air), the wet density (kg/m3) and the
    volume-weighted hygroscopicity. Hysteresis: no water below rhcrystal,
    a linear ramp of the deliquesced water on [rhcrystal, rhdeliques),
    full Koehler equilibrium above (CAM's hystfac)."""
    vols = [m / d for m, d in zip(specmmr, species_density)]
    dryvol = sum(vols)
    drymass = sum(specmmr)
    safe_dv = torch.clamp(dryvol, min=1.0e-30)
    hygro = sum(v * h for v, h in zip(vols, species_hygro)) / safe_dv

    # the volume-mean dry radius for the mode's number (wateruptake_sub's
    # dryrad, not the number-mode radius)
    safe_n = torch.clamp(naer, min=1.0e-30)
    rdry = _cbrt(safe_dv / (PI43 * safe_n))

    rwet_eq = kohler_wet_radius(rdry, hygro, rh)
    rwet_del = kohler_wet_radius(rdry, hygro, torch.full_like(rh, rhdeliques))

    wetvol_eq = PI43 * safe_n * rwet_eq ** 3
    wetvol_del = PI43 * safe_n * rwet_del ** 3
    hystfac = 1.0 / max(rhdeliques - rhcrystal, 1.0e-5)
    ramp = torch.clamp((rh - rhcrystal) * hystfac, 0.0, 1.0)
    wetvol_ramp = dryvol + (wetvol_del - dryvol) * ramp

    wetvol = torch.where(rh >= rhdeliques, wetvol_eq,
                         torch.where(rh >= rhcrystal, wetvol_ramp, dryvol))
    wetvol = torch.maximum(wetvol, dryvol)

    qaerwat = RHOH2O * (wetvol - dryvol)
    rwet = _cbrt(wetvol / (PI43 * safe_n))
    dgnumwet = dgnumdry * rwet / torch.clamp(rdry, min=1.0e-12)
    dgnumwet = torch.where(dryvol > 1.0e-30, dgnumwet, dgnumdry)
    qaerwat = torch.where(dryvol > 1.0e-30, qaerwat, 0.0)

    wetdens = torch.where(wetvol > 1.0e-30,
                          (drymass + qaerwat) / torch.clamp(wetvol,
                                                            min=1.0e-30),
                          RHOH2O)
    return dict(dgnumwet=dgnumwet, qaerwat=qaerwat, wetdens=wetdens,
                hygro=hygro)
