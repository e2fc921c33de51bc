"""General physics diagnostics (cam_diagnostics).

Twin of `cam_nor_physics_tpu.models.physics.cam_diagnostics` (reference
cam_diagnostics.F90). The reference's addfld declarations become the
field catalog here, declared on a utils.history.HistoryRegistry by
`diag_register` (with `amwg_core_fields` and `budget_register` routing
fields to tapes); its per-chunk outfld calls become payload builders,
each returning {name: tensor} for `outfld_many`:

  diag_phys_writeout      (:1953) state fields T/U/V/Q/PS/OMEGA/Z3, the
                                  pressure-surface families, moments,
                                  moisture integrals, stability indices
  diag_cloud                      cloud-cover summaries (cldsav role)
  diag_surf               (:2199) surface fields from cam_in/cam_out
  diag_export             (:2307) precipitation bound for the coupler
  diag_conv_tend_ini      (:1306) pre-moist-processes T/q snapshot
  diag_conv               (:2021) moist budget terms DTCOND, DC*
  diag_clip_tend_writeout (:1975) negative-water clipping tendencies
  diag_physvar_ic         (:2368) pbuf physics variables for IC tapes
  diag_phys_tend_writeout (:2696) before/after-physics state and the
                                  total physics tendencies
  constituent_burdens             column burdens CB_<name>
  tidal_coeffs, diag_conv_tidal   DTCOND times local-solar-time harmonics

The builders read no device value on the host, so the driver runs them
inside a CUDA graph of coupled steps. The Oslo-aerosol optics block
(:378-723, emitted only with use_oslo_aero) is out of scope, as the
reference's stubbed use_oslo_aero = .false. makes it.
"""

from __future__ import annotations

import math

import torch

from ...utils import constants as c
from ...utils.history import HistoryRegistry

# ---------------------------------------------------------------------------
# catalog (diag_init_dry/moist role, cam_diagnostics.F90:195-1304)
# ---------------------------------------------------------------------------

# (name, units, long_name, vdim) with optional 5th avgflag element
_CATALOG = [
    # dycore state + pressures (:240-330)
    ("NSTEP", "timestep", "Model timestep", "srf", "I"),
    ("PHIS", "m2/s2", "Surface geopotential", "srf", "I"),
    ("PS", "Pa", "Surface pressure", "srf"),
    ("PSDRY", "Pa", "Dry surface pressure", "srf"),
    ("PSL", "Pa", "Sea level pressure", "srf"),
    ("PMID", "Pa", "Pressure at layer midpoints", "mid"),
    ("PINT", "Pa", "Pressure at layer interfaces", "int"),
    ("PDEL", "Pa", "Layer pressure thickness", "mid"),
    ("PDELDRY", "Pa", "Dry-air layer pressure thickness", "mid"),
    ("AIRMASSL", "kg/m2", "Layer air mass", "mid"),
    ("GRIDAREA", "m2", "Column grid area", "srf", "I"),
    ("T", "K", "Temperature", "mid"),
    ("U", "m/s", "Zonal wind", "mid"),
    ("V", "m/s", "Meridional wind", "mid"),
    ("Q", "kg/kg", "Specific humidity", "mid"),
    ("OMEGA", "Pa/s", "Vertical velocity (pressure)", "mid"),
    ("Z3", "m", "Geopotential height above sea level", "mid"),
    # before/after-physics snapshots + total tendencies (:246-298, 2696)
    ("TBP", "K", "Temperature (before physics)", "mid"),
    ("UBP", "m/s", "Zonal wind (before physics)", "mid"),
    ("VBP", "m/s", "Meridional wind (before physics)", "mid"),
    ("TAP", "K", "Temperature (after physics)", "mid"),
    ("UAP", "m/s", "Zonal wind (after physics)", "mid"),
    ("VAP", "m/s", "Meridional wind (after physics)", "mid"),
    ("QBP", "kg/kg", "Specific humidity (before physics)", "mid"),
    ("CLDLIQBP", "kg/kg", "Cloud liquid (before physics)", "mid"),
    ("CLDICEBP", "kg/kg", "Cloud ice (before physics)", "mid"),
    ("QAP", "kg/kg", "Specific humidity (after physics)", "mid"),
    ("CLDLIQAP", "kg/kg", "Cloud liquid (after physics)", "mid"),
    ("CLDICEAP", "kg/kg", "Cloud ice (after physics)", "mid"),
    ("TTEND_TOT", "K/s", "Total temperature tendency", "mid"),
    ("UTEND_TOT", "m/s2", "Total zonal-wind tendency", "mid"),
    ("VTEND_TOT", "m/s2", "Total meridional-wind tendency", "mid"),
    ("UTEND_PHYSTOT", "m/s2", "Zonal-wind tendency from physics", "mid"),
    ("VTEND_PHYSTOT", "m/s2", "Meridional-wind tendency from physics",
     "mid"),
    ("PTTEND", "K/s", "T tendency: total physics parameterizations", "mid"),
    # dynamics-tendency family (diag_phys_tend_writeout's DTCORE block,
    # cam_diagnostics.F90:286-300; stored across the bc/ac boundary in
    # pbuf by physpkg)
    ("DTCORE", "K/s", "T tendency due to dynamical core", "mid"),
    ("DQCORE", "kg/kg/s", "Water vapor tendency due to dynamical core",
     "mid"),
    ("UTEND_CORE", "m/s2", "Zonal-wind tendency due to dynamical core",
     "mid"),
    ("VTEND_CORE", "m/s2", "Meridional-wind tendency due to dynamical "
     "core", "mid"),
    # ZM heating/moistening rates (zm_conv_intr.F90 outfld families; the
    # history_budget heating-rate members)
    ("ZMDT", "K/s", "T tendency - Zhang-McFarlane moist convection",
     "mid"),
    ("ZMDQ", "kg/kg/s", "Q tendency - Zhang-McFarlane moist convection",
     "mid"),
    ("EVAPTZM", "K/s", "T tendency - evaporation/snow production from "
     "ZM convection", "mid"),
    ("EVAPQZM", "kg/kg/s", "Q tendency - evaporation from ZM convection",
     "mid"),
    # ZM in-plume microphysics family (zm_conv_micro_outfld,
    # zm_conv_intr.F90:1292-1390)
    ("CLDLIQZM", "kg/kg", "ZM in-plume convective cloud liquid", "mid"),
    ("CLDICEZM", "kg/kg", "ZM in-plume convective cloud ice", "mid"),
    ("ICIMRDP", "kg/kg", "Deep-convection in-cloud ice mixing ratio",
     "mid"),
    ("QNLZM", "1/kg", "ZM in-plume droplet number", "mid"),
    ("QNIZM", "1/kg", "ZM in-plume crystal number", "mid"),
    ("WUZM", "m/s", "ZM updraft vertical velocity", "mid"),
    ("FRZZM", "kg/kg/s", "ZM in-plume freezing rate", "mid"),
    ("CLIQSNUM", "1", "ZM cloud-liquid presence sample number", "mid"),
    ("CICESNUM", "1", "ZM cloud-ice presence sample number", "mid"),
    ("WUZMSNUM", "1", "ZM updraft-velocity presence sample number", "mid"),
    ("ZMDCAPE", "J/kg", "ZM freezing-CAPE increment", "srf"),
    ("ZMFRZ", "K/s", "ZM freezing heating rate", "mid"),
    ("ZMSPRD", "kg/kg/s", "ZM snow production rate", "mid"),
    ("DIFZM", "kg/kg/s", "Detrained ice water from ZM convection", "mid"),
    ("DNLFZM", "1/kg/s", "Detrained liquid-number tendency from ZM",
     "mid"),
    ("DNIFZM", "1/kg/s", "Detrained ice-number tendency from ZM", "mid"),
    ("ZMNLIQ", "1/kg", "ZM in-plume liquid number", "mid"),
    ("ZMNICE", "1/kg", "ZM in-plume ice number", "mid"),
    ("AUTOL_M", "kg/kg/s", "ZM in-plume autoconversion mass rate", "mid"),
    ("ACCRL_M", "kg/kg/s", "ZM in-plume accretion mass rate", "mid"),
    ("FHTIM_M", "kg/kg/s", "ZM immersion-freezing mass rate", "mid"),
    ("FHTCT_M", "kg/kg/s", "ZM contact/deposition-freezing mass rate",
     "mid"),
    ("HMPI_M", "kg/kg/s", "ZM homogeneous-freezing mass rate", "mid"),
    ("BERGN_M", "kg/kg/s", "ZM Wegener-Bergeron-Findeisen mass rate",
     "mid"),
    ("ACTIV_N", "1/kg/s", "ZM droplet-activation number rate", "mid"),
    ("AUTOL_N", "1/kg/s", "ZM autoconversion number-loss rate", "mid"),
    ("ACCRL_N", "1/kg/s", "ZM accretion number-loss rate", "mid"),
    ("FHTIM_N", "1/kg/s", "ZM immersion-freezing number rate", "mid"),
    ("FHTCT_N", "1/kg/s", "ZM contact-freezing number rate", "mid"),
    ("TFIX", "K/s", "T fixer (T tendency from energy fixer)", "srf"),
    ("PTTEND_DME", "K/s", "T tendency: dry-mass adjustment", "mid"),
    ("IETEND_DME", "W/m2", "Column internal-energy tendency: dry-mass "
     "adjustment", "srf"),
    # geopotential-height p-surfaces (:312-330)
    ("Z050", "m", "Geopotential Z at 50 mbar pressure surface", "srf"),
    ("Z100", "m", "Geopotential Z at 100 mbar pressure surface", "srf"),
    ("Z200", "m", "Geopotential Z at 200 mbar pressure surface", "srf"),
    ("Z300", "m", "Geopotential Z at 300 mbar pressure surface", "srf"),
    ("Z500", "m", "Geopotential Z at 500 mbar pressure surface", "srf"),
    ("Z700", "m", "Geopotential Z at 700 mbar pressure surface", "srf"),
    ("Z1000", "m", "Geopotential Z at 1000 mbar pressure surface", "srf"),
    # temperature p-surfaces (:471-520)
    ("T010", "K", "Temperature at 10 mbar pressure surface", "srf"),
    ("T200", "K", "Temperature at 200 mbar pressure surface", "srf"),
    ("T300", "K", "Temperature at 300 mbar pressure surface", "srf"),
    ("T400", "K", "Temperature at 400 mbar pressure surface", "srf"),
    ("T500", "K", "Temperature at 500 mbar pressure surface", "srf"),
    ("T700", "K", "Temperature at 700 mbar pressure surface", "srf"),
    ("T850", "K", "Temperature at 850 mbar pressure surface", "srf"),
    ("T925", "K", "Temperature at 925 mbar pressure surface", "srf"),
    ("T1000", "K", "Temperature at 1000 mbar pressure surface", "srf"),
    # wind p-surfaces (:523-556)
    ("U010", "m/s", "Zonal wind at 10 mbar pressure surface", "srf"),
    ("U200", "m/s", "Zonal wind at 200 mbar pressure surface", "srf"),
    ("U250", "m/s", "Zonal wind at 250 mbar pressure surface", "srf"),
    ("U500", "m/s", "Zonal wind at 500 mbar pressure surface", "srf"),
    ("U850", "m/s", "Zonal wind at 850 mbar pressure surface", "srf"),
    ("V200", "m/s", "Meridional wind at 200 mbar pressure surface", "srf"),
    ("V250", "m/s", "Meridional wind at 250 mbar pressure surface", "srf"),
    ("V500", "m/s", "Meridional wind at 500 mbar pressure surface", "srf"),
    ("V850", "m/s", "Meridional wind at 850 mbar pressure surface", "srf"),
    # humidity p-surfaces
    ("Q200", "kg/kg", "Specific humidity at 200 mbar pressure surface",
     "srf"),
    ("Q850", "kg/kg", "Specific humidity at 850 mbar pressure surface",
     "srf"),
    ("Q925", "kg/kg", "Specific humidity at 925 mbar pressure surface",
     "srf"),
    ("Q1000", "kg/kg", "Specific humidity at 1000 mbar pressure surface",
     "srf"),
    ("OMEGA500", "Pa/s", "Vertical velocity at 500 mbar pressure surface",
     "srf"),
    ("OMEGA850", "Pa/s", "Vertical velocity at 850 mbar pressure surface",
     "srf"),
    # layer-difference stability indices (:486-515)
    ("T7001000", "K", "T difference 700 mb - 1000 mb", "srf"),
    ("T8501000", "K", "T difference 850 mb - 1000 mb", "srf"),
    ("T9251000", "K", "T difference 925 mb - 1000 mb", "srf"),
    ("TH7001000", "K", "Theta difference 700 mb - 1000 mb", "srf"),
    ("TH8501000", "K", "Theta difference 850 mb - 1000 mb", "srf"),
    ("TH9251000", "K", "Theta difference 925 mb - 1000 mb", "srf"),
    ("THE7001000", "K", "Theta_e difference 700 mb - 1000 mb", "srf"),
    ("THE8501000", "K", "Theta_e difference 850 mb - 1000 mb", "srf"),
    ("THE9251000", "K", "Theta_e difference 925 mb - 1000 mb", "srf"),
    # second moments / transport products (:333-468)
    ("VT", "K m/s", "Meridional heat transport", "mid"),
    ("VU", "m2/s2", "Meridional flux of zonal momentum", "mid"),
    ("VV", "m2/s2", "Meridional velocity squared", "mid"),
    ("VQ", "m/s kg/kg", "Meridional water transport", "mid"),
    ("VZ", "m2/s", "Meridional transport of geopotential height", "mid"),
    ("ZZ", "m2", "Geopotential height squared", "mid"),
    ("QQ", "kg2/kg2", "Eddy moisture variance", "mid"),
    ("TT", "K2", "Eddy temperature variance", "mid"),
    ("UU", "m2/s2", "Zonal velocity squared", "mid"),
    ("OMEGAT", "K Pa/s", "Vertical heat flux", "mid"),
    ("OMEGAU", "m Pa/s2", "Vertical flux of zonal momentum", "mid"),
    ("OMEGAV", "m Pa/s2", "Vertical flux of meridional momentum", "mid"),
    ("OMEGAQ", "kg/kg Pa/s", "Vertical water transport", "mid"),
    ("OMGAOMGA", "Pa2/s2", "Vertical flux of vertical momentum", "mid"),
    ("MQ", "kg/m2", "Water vapor mass in layer", "mid"),
    ("WSPEED", "m/s", "Horizontal total wind speed maximum", "mid", "X"),
    ("WSPDSRFMX", "m/s", "Horizontal total wind speed maximum at the "
     "surface", "srf", "X"),
    ("WSPDSRFAV", "m/s", "Horizontal total wind speed average at the "
     "surface", "srf"),
    # humidity / moisture integrals (:560-640)
    ("RELHUM", "percent", "Relative humidity", "mid"),
    ("RHW", "percent", "Relative humidity with respect to liquid", "mid"),
    ("RHI", "percent", "Relative humidity with respect to ice", "mid"),
    ("RHCFMIP", "percent", "Relative humidity with respect to water above "
     "273 K, ice below 273 K", "mid"),
    ("TMQ", "kg/m2", "Total (vertically integrated) precipitable water",
     "srf"),
    ("IVT", "kg/m/s", "Total (vertically integrated) vapor transport",
     "srf"),
    ("uIVT", "kg/m/s", "u component of integrated vapor transport", "srf"),
    ("vIVT", "kg/m/s", "v component of integrated vapor transport", "srf"),
    ("ATMEINT", "J/m2", "Vertically integrated total atmospheric energy",
     "srf"),
    # bottom-level + reference-height fields (:643-700)
    ("TBOT", "K", "Lowest model level temperature", "srf"),
    ("UBOT", "m/s", "Lowest model level zonal wind", "srf"),
    ("VBOT", "m/s", "Lowest model level meridional wind", "srf"),
    ("QBOT", "kg/kg", "Lowest model level water vapor mixing ratio", "srf"),
    ("ZBOT", "m", "Lowest model level height", "srf"),
    ("TREFHT", "K", "Reference height temperature", "srf"),
    ("TREFHTMN", "K", "Minimum reference height temperature over output "
     "period", "srf", "M"),
    ("TREFHTMX", "K", "Maximum reference height temperature over output "
     "period", "srf", "X"),
    ("QREFHT", "kg/kg", "Reference height humidity", "srf"),
    ("RHREFHT", "fraction", "Reference height relative humidity", "srf"),
    # moist-process budget terms (diag_conv, :2021)
    # per-constituent column burdens (upstream constituent_burden_comp,
    # called from diag_phys_writeout at cam_diagnostics.F90:1738: "column
    # burdens of all constituents except water vapor"; vapor is TMQ)
    ("CB_CLDLIQ", "kg/m2", "Column burden CLDLIQ", "srf"),
    ("CB_CLDICE", "kg/m2", "Column burden CLDICE", "srf"),
    ("DTCOND", "K/s", "T tendency - moist processes", "mid"),
    ("DCQ", "kg/kg/s", "Q tendency - moist processes", "mid"),
    ("DCCLDLIQ", "kg/kg/s", "CLDLIQ tendency - moist processes", "mid"),
    ("DCCLDICE", "kg/kg/s", "CLDICE tendency - moist processes", "mid"),
    # migrating-tide extraction products (diag_conv's tidal_diag block,
    # :2156-2161): DTCOND x sin/cos of the 24/12/8-hour local-solar-time
    # harmonics; monthly means of these isolate the migrating tides
    ("DTCOND_24_SIN", "K/s", "DTCOND 24hr. sin coeff.", "mid"),
    ("DTCOND_24_COS", "K/s", "DTCOND 24hr. cos coeff.", "mid"),
    ("DTCOND_12_SIN", "K/s", "DTCOND 12hr. sin coeff.", "mid"),
    ("DTCOND_12_COS", "K/s", "DTCOND 12hr. cos coeff.", "mid"),
    ("DTCOND_08_SIN", "K/s", "DTCOND 8hr. sin coeff.", "mid"),
    ("DTCOND_08_COS", "K/s", "DTCOND 8hr. cos coeff.", "mid"),
    # clipping tendencies (diag_clip_tend_writeout, :1975)
    ("INEGCLPTEND", "kg/kg/s", "Cloud-ice tendency due to clipping "
     "negative values", "mid"),
    ("LNEGCLPTEND", "kg/kg/s", "Cloud-liquid tendency due to clipping "
     "negative values", "mid"),
    ("VNEGCLPTEND", "kg/kg/s", "Water-vapor tendency due to clipping "
     "negative values", "mid"),
    # surface fields (diag_surf, :2199)
    ("SHFLX", "W/m2", "Surface sensible heat flux", "srf"),
    ("LHFLX", "W/m2", "Surface latent heat flux", "srf"),
    ("QFLX", "kg/m2/s", "Surface water flux", "srf"),
    ("TAUX", "N/m2", "Zonal surface stress", "srf"),
    ("TAUY", "N/m2", "Meridional surface stress", "srf"),
    ("TS", "K", "Surface temperature (radiative)", "srf"),
    ("TSMN", "K", "Minimum surface temperature over output period", "srf",
     "M"),
    ("TSMX", "K", "Maximum surface temperature over output period", "srf",
     "X"),
    ("SST", "K", "Sea surface temperature", "srf"),
    ("SNOWHLND", "m", "Water equivalent snow depth (land)", "srf"),
    ("SNOWHICE", "m", "Water equivalent snow depth (ice)", "srf"),
    ("LANDFRAC", "fraction", "Fraction of surface area that is land",
     "srf"),
    ("ICEFRAC", "fraction", "Fraction of surface area that is sea-ice",
     "srf"),
    ("OCNFRAC", "fraction", "Fraction of surface area that is ocean",
     "srf"),
    ("ASDIR", "fraction", "Albedo: shortwave, direct", "srf"),
    ("ASDIF", "fraction", "Albedo: shortwave, diffuse", "srf"),
    ("ALDIR", "fraction", "Albedo: longwave, direct", "srf"),
    ("ALDIF", "fraction", "Albedo: longwave, diffuse", "srf"),
    # precip / export fields (diag_export, :2307)
    ("PRECT", "m/s", "Total (convective and large-scale) precipitation "
     "rate", "srf"),
    ("PRECTMX", "m/s", "Maximum total precipitation rate over output "
     "period", "srf", "X"),
    ("PRECC", "m/s", "Convective precipitation rate", "srf"),
    ("PRECL", "m/s", "Large-scale (stable) precipitation rate", "srf"),
    ("PRECSC", "m/s", "Convective snow rate (water equivalent)", "srf"),
    ("PRECSL", "m/s", "Large-scale snow rate (water equivalent)", "srf"),
    ("PRECST", "m/s", "Total snow rate (water equivalent)", "srf"),
    ("PRECCav", "m/s", "Average large-scale precipitation (convective)",
     "srf"),
    ("PRECLav", "m/s", "Average large-scale precipitation", "srf"),
    # cloud-cover summaries (cldsav role)
    ("CLDTOT", "fraction", "Vertically-integrated total cloud", "srf"),
    ("CLDLOW", "fraction", "Vertically-integrated low cloud", "srf"),
    ("CLDMED", "fraction", "Vertically-integrated mid-level cloud", "srf"),
    ("CLDHGH", "fraction", "Vertically-integrated high cloud", "srf"),
    ("CLDFREE", "fraction", "Fractional occurrence of cloud-free column",
     "srf"),
    # general tail (diag_init, cam_diagnostics.F90:195-850): airmass /
    # gas "constants" / reference-height extrema / surface LW up / 10 m
    # wind / precip partition
    ("AIRMASS", "kg/m2", "Vertically integrated dry air mass", "srf"),
    ("CPAIRV", "J/K/kg", "Specific heat of dry air (variable composition "
     "slot; constant here)", "mid"),
    ("RAIRV", "J/K/kg", "Gas constant of dry air (variable composition "
     "slot; constant here)", "mid"),
    ("TREFMXAV", "K", "Average of TREFHT daily maximum", "srf", "X"),
    ("TREFMNAV", "K", "Average of TREFHT daily minimum", "srf", "M"),
    ("U10", "m/s", "10 m wind speed", "srf"),
    ("FLUS", "W/m2", "Upwelling longwave flux at surface", "srf"),
    ("EFLX", "W/m2", "Net energy flux into the surface", "srf"),
    ("PREC_PCW", "m/s", "Stratiform (macro/microphysics slot) "
     "precipitation rate", "srf"),
    ("PREC_zmc", "m/s", "Deep-convective (ZM) precipitation rate", "srf"),
]

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


def amwg_core_fields() -> list[str]:
    """The AMWG-core default-tape set (the reference's history_amwg
    add_default block, cam_diagnostics.F90 diag_init + phys_control
    history_amwg): every catalog field a standard h0 climate tape carries.
    The driver add_defaults these (plus the dycore/ZM families registered
    elsewhere) when history is on."""
    return [row[0] for row in _CATALOG] + \
        [name + "&IC" for name, *_ in _IC_FIELDS]


def budget_register(reg: HistoryRegistry, tape: int = 1,
                    cnst_names=("Q",)) -> None:
    """history_budget tape defaults (cam_diagnostics.F90:760-850): route
    the state/tendency budget families — PHIS/PS/T/U/V, the total
    tendencies, the before/after-physics snapshots, the dynamics-tendency
    family, and the per-constituent budget fields — to `tape`
    (history_budget_histfile_num role). Call after diag_register."""
    names = ["PHIS", "PS", "T", "U", "V",
             "TTEND_TOT", "UTEND_TOT", "VTEND_TOT",
             "TBP", "UBP", "VBP", "TAP", "UAP", "VAP",
             "QBP", "QAP", "CLDLIQBP", "CLDLIQAP", "CLDICEBP", "CLDICEAP",
             "PTTEND", "TFIX", "PTTEND_DME",
             "DTCORE", "DQCORE", "UTEND_CORE", "VTEND_CORE",
             "DTCOND", "EVAPTZM", "ZMDT", "EVAPQZM", "ZMDQ"]
    for n in cnst_names:
        if f"DC{n}" in reg.fields:
            names.append(f"DC{n}")
    for n in names:
        if n in reg.fields and n not in reg.defaults.get(tape, []):
            reg.add_default(n, tape=tape)


def diag_register(reg: HistoryRegistry) -> None:
    """Declare the diagnostic field set (diag_init_dry/moist role,
    cam_diagnostics.F90:195-1304)."""
    for row in _CATALOG:
        name, units, long_name, vdim = row[:4]
        avgflag = row[4] if len(row) > 4 else "A"
        if name not in reg.fields:
            reg.addfld(name, units, long_name, vdim=vdim, avgflag=avgflag)
    for name, units, long_name, vdim in _IC_FIELDS:
        icname = name + "&IC"
        if icname not in reg.fields:
            reg.addfld(icname, units, long_name, vdim=vdim, avgflag="I")


def plevel_slice(field, pmid, p_target: float):
    """Linear-in-log-p interpolation of a (ncol, pver) field to one pressure
    surface (vertical_interpolate role); clamps outside the column range."""
    lnp = torch.log(pmid)
    lnt = torch.log(torch.full((), p_target, dtype=field.dtype,
                               device=field.device))
    km = field.shape[1]
    cnt = torch.sum(lnp <= lnt, 1)
    k = torch.clamp(cnt - 1, 0, km - 2)
    lev = torch.arange(km, device=field.device)
    oh_lo = (k[:, None] == lev).to(field.dtype)
    oh_hi = (k[:, None] + 1 == lev).to(field.dtype)
    p_lo = torch.sum(oh_lo * lnp, 1)
    p_hi = torch.sum(oh_hi * lnp, 1)
    f_lo = torch.sum(oh_lo * field, 1)
    f_hi = torch.sum(oh_hi * field, 1)
    w = torch.clamp((lnt - p_lo) / torch.where(p_hi == p_lo, 1.0,
                                               p_hi - p_lo), 0.0, 1.0)
    return f_lo + w * (f_hi - f_lo)


def _theta_e(t, q, pmid):
    """Bolton (1980) pseudo-equivalent potential temperature (the
    reference's THE* stability indices)."""
    e = pmid * q / (c.EPSILO + q)
    e = torch.clamp(e, min=1.0e-3)
    tl = 2840.0 / (3.5 * torch.log(t) - torch.log(e * 0.01) - 4.805) + 55.0
    theta = t * (1.0e5 / pmid) ** (0.2854 * (1.0 - 0.28 * q))
    return theta * torch.exp((3.376 / tl - 0.00254) * 1.0e3 * q *
                             (1.0 + 0.81 * q))


def _plevel_name(prefix: str, p: float) -> str:
    """T010, T200, ...: the pressure in hPa, three digits below 100 hPa."""
    return f"{prefix}{int(p / 100):03d}" if p < 100e2 \
        else f"{prefix}{int(p / 100)}"


def diag_phys_writeout(state, nstep=0, area=None) -> dict:
    """State snapshot payload (diag_phys_writeout, cam_diagnostics.F90:1953):
    prognostic fields, pressure-surface slices, second moments, moisture
    integrals, stability indices. `nstep` is an int or the state's 0-d step
    tensor; `area` the (ncol,) cell areas (GRIDAREA)."""
    from ...ops.saturation import qsat, qsat_ice, qsat_water
    t, u, v = state.t, state.u, state.v
    qv = state.q[:, :, 0]
    pmid = state.pmid
    _, qs = qsat(t, pmid)
    _, qsw = qsat_water(t, pmid)
    _, qsi = qsat_ice(t, pmid)
    z3 = state.zm + state.phis[:, None] / c.GRAVIT
    wspd = torch.sqrt(u ** 2 + v ** 2)
    ncol = t.shape[0]
    if isinstance(nstep, torch.Tensor):
        nstep_col = nstep.to(t.dtype).expand(ncol)
    else:
        nstep_col = torch.full((ncol,), float(nstep), dtype=t.dtype,
                               device=t.device)

    def sl(f, p):
        return plevel_slice(f, pmid, p)

    theta = t * (1.0e5 / pmid) ** c.CAPPA
    the = _theta_e(t, qv, pmid)

    # vertically integrated total energy (ATMEINT): cp T + Phi + K + L q
    # over mass, the tot_energy_phys 'phys' accounting
    e_int = torch.sum((c.CPAIR * t + c.GRAVIT * z3 + 0.5 * wspd ** 2 +
                       c.LATVAP * qv) * state.pdel, 1) / c.GRAVIT
    tbot, wbot = t[:, -1], wspd[:, -1]

    out = {
        "NSTEP": nstep_col,
        "T": t, "U": u, "V": v, "Q": qv,
        "PS": state.ps, "PSDRY": state.psdry, "OMEGA": state.omega,
        "PMID": pmid, "PINT": state.pint, "PDEL": state.pdel,
        "PDELDRY": state.pdeldry,
        "AIRMASSL": state.pdel / c.GRAVIT,
        "Z3": z3,
        "RELHUM": 100.0 * qv / torch.clamp(qs, min=1e-12),
        "RHW": 100.0 * qv / torch.clamp(qsw, min=1e-12),
        "RHI": 100.0 * qv / torch.clamp(qsi, min=1e-12),
        "RHCFMIP": 100.0 * qv / torch.clamp(
            torch.where(t >= 273.0, qsw, qsi), min=1e-12),
        "TMQ": torch.sum(qv * state.pdel, -1) / c.GRAVIT,
        "uIVT": torch.sum(u * qv * state.pdel, -1) / c.GRAVIT,
        "vIVT": torch.sum(v * qv * state.pdel, -1) / c.GRAVIT,
        "ATMEINT": e_int,
        "TREFHT": tbot,
        "QREFHT": qv[:, -1],
        "TREFHTMN": tbot, "TREFHTMX": tbot,
        "RHREFHT": qv[:, -1] / torch.clamp(qs[:, -1], min=1e-12),
        "TBOT": tbot, "UBOT": u[:, -1], "VBOT": v[:, -1],
        "QBOT": qv[:, -1], "ZBOT": state.zm[:, -1],
        "PHIS": state.phis,
        # second moments / transports
        "VT": v * t, "VU": v * u, "VQ": v * qv, "VZ": v * z3,
        "ZZ": z3 * z3, "QQ": qv * qv, "TT": t * t, "UU": u * u,
        "VV": v * v,
        "OMEGAT": state.omega * t, "OMEGAU": state.omega * u,
        "OMEGAV": state.omega * v, "OMEGAQ": state.omega * qv,
        "OMGAOMGA": state.omega * state.omega,
        "MQ": qv * state.pdel / c.GRAVIT,
        "WSPEED": wspd, "WSPDSRFMX": wbot, "WSPDSRFAV": wbot,
        "AIRMASS": torch.sum(state.pdeldry, -1) / c.GRAVIT,
        "CPAIRV": torch.full_like(t, c.CPAIR),
        "RAIRV": torch.full_like(t, c.RAIR),
        "TREFMXAV": tbot, "TREFMNAV": tbot,
        "U10": wbot,
        "FLUS": c.STEBOL * tbot ** 4,
    }
    if area is not None:
        out["GRIDAREA"] = area
    # pressure-surface families
    for p in (10e2, 200e2, 300e2, 400e2, 500e2, 700e2, 850e2, 925e2,
              1000e2):
        out[_plevel_name("T", p)] = sl(t, p)
    for p in (50e2, 100e2, 200e2, 300e2, 500e2, 700e2, 1000e2):
        out[_plevel_name("Z", p)] = sl(z3, p)
    for p in (10e2, 200e2, 250e2, 500e2, 850e2):
        out[_plevel_name("U", p)] = sl(u, p)
    for p in (200e2, 250e2, 500e2, 850e2):
        out[f"V{int(p / 100)}"] = sl(v, p)
    for p in (200e2, 850e2, 925e2, 1000e2):
        out[f"Q{int(p / 100)}"] = sl(qv, p)
    out["OMEGA500"] = sl(state.omega, 500e2)
    out["OMEGA850"] = sl(state.omega, 850e2)
    out["IVT"] = torch.sqrt(out["uIVT"] ** 2 + out["vIVT"] ** 2)
    # layer-difference stability indices (T/TH/THE at 700/850/925 - 1000)
    t1000, th1000, the1000 = sl(t, 1000e2), sl(theta, 1000e2), \
        sl(the, 1000e2)
    for p, tag in ((700e2, "7001000"), (850e2, "8501000"),
                   (925e2, "9251000")):
        out[f"T{tag}"] = sl(t, p) - t1000
        out[f"TH{tag}"] = sl(theta, p) - th1000
        out[f"THE{tag}"] = sl(the, p) - the1000
    return out


def diag_cloud(cld, pmid) -> dict:
    """Cloud-cover summaries by maximum-random overlap (cldsav role:
    CLDTOT/CLDLOW/CLDMED/CLDHGH, bands at 700/400 hPa)."""
    eps = 1.0e-6

    def overlap(mask):
        cf = torch.where(mask, cld, 0.0)
        cf_up = torch.cat([cf[:, :1] * 0.0, cf[:, :-1]], 1)
        num = 1.0 - torch.maximum(cf, cf_up)
        den = 1.0 - torch.clamp(cf_up, max=1.0 - eps)
        return 1.0 - torch.prod(num / den, 1)

    tot = overlap(torch.ones_like(cld, dtype=torch.bool))
    return {
        "CLDTOT": tot,
        "CLDFREE": 1.0 - tot,
        "CLDLOW": overlap(pmid > 700e2),
        "CLDMED": overlap((pmid <= 700e2) & (pmid > 400e2)),
        "CLDHGH": overlap(pmid <= 400e2),
    }


def diag_surf(cam_in, cam_out) -> dict:
    """Surface diagnostics (diag_surf, cam_diagnostics.F90:2199)."""
    out = {
        "SHFLX": cam_in.shf, "LHFLX": cam_in.lhf,
        "QFLX": cam_in.cflx[:, 0],
        "TAUX": cam_in.wsx, "TAUY": cam_in.wsy, "TS": cam_in.ts,
        "TSMN": cam_in.ts, "TSMX": cam_in.ts,
        "PSL": cam_out.psl,
        # net energy flux into the surface: absorbed solar and downwelling
        # longwave less the turbulent losses (EFLX role)
        "EFLX": (cam_out.netsw + cam_out.flwds - cam_in.shf - cam_in.lhf),
    }
    for attr, name in (("landfrac", "LANDFRAC"), ("icefrac", "ICEFRAC"),
                       ("ocnfrac", "OCNFRAC"), ("snowhland", "SNOWHLND"),
                       ("snowhice", "SNOWHICE"), ("sst", "SST"),
                       ("asdir", "ASDIR"), ("asdif", "ASDIF"),
                       ("aldir", "ALDIR"), ("aldif", "ALDIF")):
        val = getattr(cam_in, attr, None)
        if val is not None:
            out[name] = val
    return out


def diag_export(cam_out) -> dict:
    """Coupler-bound precipitation payload (diag_export,
    cam_diagnostics.F90:2307)."""
    prect = cam_out.precc + cam_out.precl
    return {
        "PRECT": prect,
        "PRECTMX": prect,
        "PRECST": cam_out.precsc + cam_out.precsl,
        "PRECC": cam_out.precc,
        "PRECL": cam_out.precl,
        "PRECSC": cam_out.precsc,
        "PRECSL": cam_out.precsl,
        "PRECCav": cam_out.precc,
        "PRECLav": cam_out.precl,
        "PREC_zmc": cam_out.precc,
        "PREC_PCW": cam_out.precl,
    }


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
