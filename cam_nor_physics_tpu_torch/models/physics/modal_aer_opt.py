"""Modal aerosol optics (modal_aer_opt).

Twin of `cam_nor_physics_tpu.models.physics.modal_aer_opt` (reference
modal_aer_opt.F90): the Ghan & Zaveri (2007) parameterization of per-mode
aerosol shortwave and longwave optical properties (modal_aero_sw
:485-1212, modal_aero_lw :1216-1469). Per mode, band and level:

  1. the wet surface-mode radius from DGNUMWET, and a Chebyshev basis in
     log(radius) over [log rmmin, log rmmax] (modal_size_parameters,
     :1538-1574);
  2. the bulk complex refractive index, the volume mix of the per-band
     species indices and of aerosol water (:733-850; the water indices of
     read_water_refindex, :1475-1536);
  3. bilinear interpolation in (Re m, Im m) on the per-band 7 x 10 grids
     of Chebyshev coefficient tables (ncoef=5, :54);
  4. the specific extinction exp(Chebyshev sum) in m2/kg, geometric optics
     1.5/(r rho_w) above the tables' radius range (:869-877); absorption
     and asymmetry plain Chebyshev sums (:882-891); per kg of water to per
     kg of air by wetvol rhoh2o (:880-890); the layer optical depth
     tau = pext * dry air mass (:896).

The interpolation is a four-corner weighted sum over one-hot cell
weights, as in the JAX package. `AeroMode` and `ModalOpticsTable` hold
numpy data only; the tables become tensors on the state's device and in
its dtype at their first use, and are kept (`_device_array`), so that a
later step, one inside a CUDA graph capture too, copies nothing from the
host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

NCOEF = 5      # Chebyshev polynomial terms       (modal_aer_opt.F90:54)
PREFR = 7      # real refractive-index grid size   (:54)
PREFI = 10     # imaginary refractive-index grid   (:54)
NSWBANDS = 14  # RRTMG shortwave bands (radconstants)
NLWBANDS = 16  # RRTMG longwave bands
IDX_SW_DIAG = 9   # 0-based visible diagnostic band (16000-22650 cm-1)
IDX_UV_DIAG = 10  # 0-based 0.35 um band
IDX_NIR_DIAG = 7  # 0-based 0.88 um band

RHOH2O = 1000.0   # kg/m3 (rhoh2o; watervol = qaerwat/rhoh2o, :834)


@dataclass(frozen=True)
class ModalOpticsTable:
    """Per-mode optics tables (the modal_optics_file payload, :112-481).

    Coefficient tables are (nband, prefr, prefi, ncoef); the refractive
    index grids are per band, (prefr, nband) / (prefi, nband), as the
    reference's refrtabsw(:,isw) (:856-857). 1-D grids are broadcast
    across the bands by the constructors below.
    """

    extpsw: np.ndarray     # log specific extinction Chebyshev coefs (m2/kg)
    abspsw: np.ndarray     # specific absorption coefs
    asmpsw: np.ndarray     # asymmetry parameter coefs
    absplw: np.ndarray     # LW specific absorption (nlwband, R, I, ncoef)
    refrtabsw: np.ndarray  # (prefr, nswband) real refractive-index grids
    refitabsw: np.ndarray  # (prefi, nswband) imaginary grids (positive)
    refrtablw: np.ndarray  # (prefr, nlwband)
    refitablw: np.ndarray  # (prefi, nlwband)
    rmmin: float           # min surface mode radius treated (m)  (:140)
    rmmax: float           # max surface mode radius treated (m)  (:141)


@dataclass(frozen=True)
class AeroMode:
    """One aerosol mode: species metadata (the rad_constituents role,
    rad_cnst_get_mode_props / rad_cnst_get_aer_props, :717-765).

    species_refindex_sw/lw entries may be a scalar complex (broadcast over
    the bands) or a per-band complex array of length NSWBANDS/NLWBANDS.
    """

    name: str
    species_names: tuple          # constituent names of the species
    species_density: tuple        # kg/m3 per species
    species_refindex_sw: tuple    # complex refractive index per species
    species_refindex_lw: tuple
    species_hygro: tuple = ()     # hygroscopicity per species (wateruptake)
    species_type: tuple = ()      # 'dust'/'sulfate'/... (AOD diagnostics)
    sigma_logr: float = 1.8       # geometric standard deviation
    num_name: str = None          # number-mixing-ratio constituent, if any
    dgnum: float = 0.11e-6        # default dry number-mode diameter (m)
    dgnumlo: float = 0.0535e-6
    dgnumhi: float = 0.44e-6
    rhcrystal: float = 0.35
    rhdeliques: float = 0.80
    table: ModalOpticsTable = None


def _per_band(values, nband):
    """Per-species refractive indices stacked to (nspec, nband) complex,
    scalars broadcast across the bands."""
    rows = []
    for v in values:
        arr = np.asarray(v, dtype=complex)
        rows.append(np.broadcast_to(arr, (nband,)))
    return np.stack(rows)  # (nspec, nband)


# Water complex refractive index per RRTMG band (read_water_refindex role,
# :1475-1536): values representative of the Segelstein (1981) compilation
# at the band centres; `read_water_refindex` reads the reference's
# water_refindex_file instead.
CREFWSW = np.array([complex(r, i) for r, i in [
    (1.396, 9.2e-3), (1.334, 2.0e-4), (1.311, 1.2e-4), (1.297, 1.1e-4),
    (1.286, 6.6e-5), (1.279, 2.2e-5), (1.307, 2.2e-6), (1.321, 1.0e-7),
    (1.328, 2.5e-8), (1.332, 1.5e-9), (1.336, 8.7e-10), (1.340, 3.3e-9),
    (1.346, 2.9e-9), (1.291, 5.5e-2)]])
CREFWLW = np.array([complex(r, i) for r, i in [
    (1.53, 0.39), (1.48, 0.42), (1.42, 0.40), (1.34, 0.37),
    (1.26, 0.34), (1.18, 0.30), (1.16, 0.21), (1.29, 0.10),
    (1.32, 0.050), (1.32, 0.034), (1.34, 0.019), (1.35, 0.013),
    (1.36, 0.011), (1.38, 0.010), (1.40, 0.012), (1.42, 0.014)]])


def make_synthetic_table(nband: int = NSWBANDS, nlwband: int = NLWBANDS,
                         seed: int = 0) -> ModalOpticsTable:
    """Physically shaped synthetic tables (the JAX package's, from the
    same numpy seed): smooth in radius (Chebyshev coefficients decaying
    by order), extinction stored in log space (pext = exp(chebsum),
    :869-874), absorption growing with Im(m), asymmetry in (0, 1). They
    stand in for the modal_optics_file payload where the NetCDF file is
    not at hand."""
    rng = np.random.default_rng(seed)
    refr = np.linspace(1.3, 1.7, PREFR)
    refi = np.geomspace(1e-9, 0.5, PREFI)

    def cheb_decay(shape, lo=0.5, hi=1.5):
        base = rng.uniform(lo, hi, shape[:-1] + (1,))
        orders = np.exp(-1.5 * np.arange(NCOEF))[None, None, None, :]
        return base * orders

    # log specific extinction ~ exp(0.5*c1) in [e^2, e^5] m2/kg-water
    extpsw = cheb_decay((nband, PREFR, PREFI, NCOEF), 4.0, 10.0) * \
        (1.0 + 0.3 * (refr[None, :, None, None] - 1.3))
    abspsw = 50.0 * cheb_decay((nband, PREFR, PREFI, NCOEF)) * \
        (0.05 + 0.9 * (refi / refi[-1])[None, None, :, None])
    asmpsw = 0.6 * cheb_decay((nband, PREFR, PREFI, NCOEF))
    absplw = 30.0 * cheb_decay((nlwband, PREFR, PREFI, NCOEF)) * \
        (0.1 + (refi / refi[-1])[None, None, :, None])

    def tile(g, nb):
        return np.tile(g[:, None], (1, nb))

    return ModalOpticsTable(
        extpsw=extpsw, abspsw=abspsw, asmpsw=asmpsw, absplw=absplw,
        refrtabsw=tile(refr, nband), refitabsw=tile(refi, nband),
        refrtablw=tile(refr, nlwband), refitablw=tile(refi, nlwband),
        rmmin=0.01e-6, rmmax=25.0e-6)


def load_modal_optics_netcdf(path: str, mode_index: int = 0
                             ) -> ModalOpticsTable:
    """One mode's tables from the reference's modal_optics_file
    (modal_aer_opt_init, :112-481; NetCDF-3 classic through scipy). The
    file stores the coefficients as (ncoef, prefr, prefi, nband), the
    Fortran declarations' order (:548-551); they are transposed here to
    (nband, prefr, prefi, ncoef)."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as nc:
        def get(name):
            return np.array(nc.variables[name][:])

        def coefs(name):
            a = get(name)
            if a.ndim == 5:          # a (mode, ...) stacked file
                a = a[mode_index]
            if a.shape[0] == NCOEF:  # (ncoef, prefr, prefi, nband)
                a = np.transpose(a, (3, 1, 2, 0))
            return a

        def grid(name, n):
            a = get(name)
            if a.ndim == 1:
                a = np.tile(a[:, None], (1, n))
            return a

        return ModalOpticsTable(
            extpsw=coefs("extpsw"), abspsw=coefs("abspsw"),
            asmpsw=coefs("asmpsw"), absplw=coefs("absplw"),
            refrtabsw=grid("refrtabsw", NSWBANDS),
            refitabsw=grid("refitabsw", NSWBANDS),
            refrtablw=grid("refrtablw", NLWBANDS),
            refitablw=grid("refitablw", NLWBANDS),
            rmmin=float(get("rmmin")) if "rmmin" in nc.variables else 0.01e-6,
            rmmax=float(get("rmmax")) if "rmmax" in nc.variables else 25e-6)


def read_water_refindex(path: str):
    """Per-band water complex refractive indices from the reference's
    water_refindex_file (read_water_refindex, :1475-1536). Returns
    (crefwsw[NSWBANDS], crefwlw[NLWBANDS]) complex arrays, the imaginary
    parts made positive as the reference does (:1527-1532)."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as nc:
        def g(n):
            return np.array(nc.variables[n][:])

        crefwsw = g("refindex_real_water_sw") + \
            1j * np.abs(g("refindex_im_water_sw"))
        crefwlw = g("refindex_real_water_lw") + \
            1j * np.abs(g("refindex_im_water_lw"))
    return crefwsw, crefwlw


# (id of a host object, which array of it, device, dtype) -> (the object,
# the tensor); the object is kept so that its id is not reused while
# cached
_ON_DEVICE: dict = {}


def _device_array(obj, like: torch.Tensor, what=None,
                  make=np.asarray) -> torch.Tensor:
    """make(obj), a host array, as a tensor on `like`'s device and in its
    dtype, made once and kept: a step after the first copies nothing from
    the host (a CUDA graph capture allows no such copy)."""
    key = (id(obj), what, like.device, like.dtype)
    hit = _ON_DEVICE.get(key)
    if hit is None:
        hit = (obj, torch.as_tensor(np.asarray(make(obj)), dtype=like.dtype,
                                    device=like.device))
        _ON_DEVICE[key] = hit
    return hit[1]


def modal_size_parameters(dgnumwet, rmmin: float, rmmax: float,
                          sigma_logr: float):
    """The surface-mode radius and the Chebyshev basis in normalized log
    radius (modal_size_parameters, modal_aer_opt.F90:1538-1574).

    dgnumwet: (ncol, pver) wet number-mode diameter (m); the surface-mode
    radius is dgnumwet/2 exp(2 ln^2 sigma). Returns (radsurf, logradsurf,
    cheb) with cheb (ncol, pver, NCOEF); logradsurf unclipped (the
    geometric-optics branch tests it against log rmmax, :869)."""
    alnsg = math.log(sigma_logr)
    radsurf = 0.5 * dgnumwet * math.exp(2.0 * alnsg ** 2)
    logradsurf = torch.log(torch.clamp(radsurf, min=1.0e-30))
    xrmin, xrmax = math.log(rmmin), math.log(rmmax)
    xr = torch.clamp(logradsurf, xrmin, xrmax)
    xr = (2.0 * xr - xrmax - xrmin) / (xrmax - xrmin)
    # Chebyshev recurrence T_0..T_{NCOEF-1}
    cheb = [torch.ones_like(xr), xr]
    for _ in range(2, NCOEF):
        cheb.append(2.0 * xr * cheb[-1] - cheb[-2])
    return radsurf, logradsurf, torch.stack(cheb[:NCOEF], -1)


def _bilinear_cell(grids, x):
    """Per-band 1-D table interpolation weights (the table_interp_mod
    role): grids (n_grid, nband) numpy, x (ncol, pver, nband); returns the
    one-hot (ncol, pver, nband, n_grid) interpolation weights."""
    g = _device_array(grids, x).T                         # (b, n)
    n = g.shape[-1]
    cnt = torch.sum(g <= x[..., None], -1)
    k = torch.clamp(cnt - 1, 0, n - 2)
    iota = torch.arange(n, device=x.device)
    onehot_lo = (k[..., None] == iota).to(x.dtype)
    onehot_hi = (k[..., None] + 1 == iota).to(x.dtype)
    x_lo = torch.einsum('cpbn,bn->cpb', onehot_lo, g)
    x_hi = torch.einsum('cpbn,bn->cpb', onehot_hi, g)
    w = torch.clamp((x - x_lo) / torch.where(x_hi == x_lo, 1.0, x_hi - x_lo),
                    0.0, 1.0)
    return onehot_lo * (1.0 - w[..., None]) + onehot_hi * w[..., None]


def _volume_mix_refindex(specmmr, specdens, crefin_spec, qaerwat, crefw,
                         nband):
    """The bulk complex refractive index by per-band volume mixing
    (modal_aero_sw :733-850): sum(vol_l m_l(band)) + watervol m_w(band),
    over the wet volume; a negative water volume becomes zero (:837-843).
    crefin_spec: the species' indices (AeroMode.species_refindex_sw/lw),
    crefw: the water's (CREFWSW/CREFWLW). Returns (refr, refi, wetvol,
    dryvol), refr/refi (ncol, pver, nband)."""
    def on_device(values, cref):
        """(re, |im|) of the complex array cref(values), as tensors."""
        return (_device_array(values, qaerwat, ("re", nband),
                              lambda v: np.real(cref(v))),
                _device_array(values, qaerwat, ("im", nband),
                              lambda v: np.abs(np.imag(cref(v)))))

    cre_s, cim_s = on_device(crefin_spec, lambda v: _per_band(v, nband))
    cre_w, cim_w = on_device(crefw, lambda v: v[:nband])
    vols = [m / d for m, d in zip(specmmr, specdens)]     # (ncol,pver) each
    dryvol = sum(vols)
    watervol = torch.clamp(qaerwat / RHOH2O, min=0.0)     # (:837-843)
    wetvol = watervol + dryvol
    cre = sum(v[..., None] * cre_s[l] for l, v in enumerate(vols)) + \
        watervol[..., None] * cre_w
    cim = sum(v[..., None] * cim_s[l] for l, v in enumerate(vols)) + \
        watervol[..., None] * cim_w
    safe = torch.clamp(wetvol, min=1.0e-60)[..., None]
    return cre / safe, cim / safe, wetvol, dryvol


def _interp(w_r, w_i, table):
    """The table's Chebyshev coefficients at each point's refractive
    index: sum over the (r, i) cell weights, (c,p,b,R), (c,p,b,I) and
    (b,R,I,n) -> (c,p,b,n); the imaginary axis first, which keeps the
    intermediate at (c,p,b,R,n)."""
    return torch.einsum('cpbr,cpbrn->cpbn', w_r,
                        torch.einsum('cpbi,brin->cpbrn', w_i, table))


def modal_aero_sw(mode: AeroMode, specmmr, dgnumwet, qaerwat, mass):
    """Shortwave optics of one mode (modal_aero_sw, :485-1212).

    specmmr: list of (ncol, pver) species mass mixing ratios (kg/kg);
    dgnumwet, qaerwat: (ncol, pver) from DGNUMWET / QAERWAT; mass:
    (ncol, pver) dry layer air mass pdeldry/gravit (kg/m2). Returns
    dict(tau, tau_w, tau_w_g, tau_w_f), each (ncol, pver, nband) (the
    tauxar/wa/ga/fa accumulation of radiation_tend, :940-947), and the
    AOD and burden diagnostics."""
    tbl = mode.table
    nband = tbl.extpsw.shape[0]
    radsurf, logradsurf, cheb = modal_size_parameters(
        dgnumwet, tbl.rmmin, tbl.rmmax, mode.sigma_logr)   # (c,p,5)
    refr, refi, wetvol, _ = _volume_mix_refindex(
        specmmr, mode.species_density, mode.species_refindex_sw, qaerwat,
        CREFWSW, nband)

    w_r = _bilinear_cell(tbl.refrtabsw, refr)       # (c,p,b,prefr)
    w_i = _bilinear_cell(tbl.refitabsw, refi)       # (c,p,b,prefi)

    def interp(table):                               # (b,R,I,5) -> (c,p,b,5)
        return _interp(w_r, w_i, _device_array(table, dgnumwet))

    # Chebyshev sums: 0.5 c1 + sum_{n>=2} cheb_n c_n  (:870-890)
    def chebsum(coef):
        return 0.5 * coef[..., 0] + torch.einsum(
            'cpbn,cpn->cpb', coef[..., 1:], cheb[..., 1:])

    # specific extinction per kg water: exp of the Chebyshev sum inside
    # the tables' radius range, geometric optics 1.5/(r rho_w) above it
    # (:869-877)
    pext_tab = torch.exp(chebsum(interp(tbl.extpsw)))
    pext_geo = 1.5 / (torch.clamp(radsurf, min=1.0e-30) * RHOH2O)
    pext = torch.where((logradsurf <= math.log(tbl.rmmax))[..., None],
                       pext_tab, pext_geo[..., None])

    # per kg water -> per kg air (:880-890); tau = pext * layer mass (:896)
    wfac = (wetvol * RHOH2O)[..., None]
    pext = pext * wfac
    pabs = torch.clamp(chebsum(interp(tbl.abspsw)) * wfac, min=0.0)
    pabs = torch.minimum(pabs, pext)
    pasm = torch.clamp(chebsum(interp(tbl.asmpsw)), -1.0, 1.0)
    palb = 1.0 - pabs / torch.clamp(pext, min=1.0e-40)

    tau = pext * mass[..., None]
    tau_w = tau * palb
    tau_w_g = tau_w * pasm
    tau_w_f = tau_w_g * pasm

    # the AOD family (the savaervis block, :780-828, 900-935)
    drymass = sum(specmmr) * mass
    return dict(tau=tau, tau_w=tau_w, tau_w_g=tau_w_g, tau_w_f=tau_w_f,
                AODVIS=torch.sum(tau[:, :, IDX_SW_DIAG % nband], 1),
                AODABS=torch.sum((pabs * mass[..., None])[
                    :, :, IDX_SW_DIAG % nband], 1),
                AODNIR=torch.sum(tau[:, :, IDX_NIR_DIAG % nband], 1),
                AODUV=torch.sum(tau[:, :, IDX_UV_DIAG % nband], 1),
                burden=torch.sum(drymass, 1))


def modal_aero_lw(mode: AeroMode, specmmr, dgnumwet, qaerwat, mass):
    """Longwave absorption optics of one mode (modal_aero_lw,
    :1216-1469). Returns tau_abs (ncol, pver, nlwband): pabs = Chebyshev
    sum * wetvol * rhoh2o (:1418-1421), dopaer = pabs * mass (:1422)."""
    tbl = mode.table
    nband = tbl.absplw.shape[0]
    _, _, cheb = modal_size_parameters(dgnumwet, tbl.rmmin, tbl.rmmax,
                                       mode.sigma_logr)
    refr, refi, wetvol, _ = _volume_mix_refindex(
        specmmr, mode.species_density, mode.species_refindex_lw, qaerwat,
        CREFWLW, nband)
    w_r = _bilinear_cell(tbl.refrtablw, refr)
    w_i = _bilinear_cell(tbl.refitablw, refi)
    coef = _interp(w_r, w_i, _device_array(tbl.absplw, dgnumwet))
    pabs = 0.5 * coef[..., 0] + \
        torch.einsum('cpbn,cpn->cpb', coef[..., 1:], cheb[..., 1:])
    pabs = torch.clamp(pabs * (wetvol * RHOH2O)[..., None], min=0.0)
    return pabs * mass[..., None]


def modal_aero_optics_all(modes, specmmr_by_mode, dgnumwet_m, qaerwat_m,
                          mass):
    """The sweep over modes (the `do m = 1, nmodes` loops, :707 and
    :1325): tauxar/wa/ga/fa summed over the modes, and the per-mode
    diagnostics. dgnumwet_m/qaerwat_m: (ncol, pver, nmodes). Returns
    (sw_totals, lw_tau, per_mode_diags)."""
    tot = None
    lw = None
    diags = {}
    for m, (mode, specmmr) in enumerate(zip(modes, specmmr_by_mode)):
        sw = modal_aero_sw(mode, specmmr, dgnumwet_m[..., m],
                           qaerwat_m[..., m], mass)
        lw_m = modal_aero_lw(mode, specmmr, dgnumwet_m[..., m],
                             qaerwat_m[..., m], mass)
        if tot is None:
            tot = {k: sw[k] for k in ("tau", "tau_w", "tau_w_g", "tau_w_f")}
            lw = lw_m
        else:
            for k in tot:
                tot[k] = tot[k] + sw[k]
            lw = lw + lw_m
        for k, out in (("AODVIS", "AODVIS"), ("AODABS", "AODABS"),
                       ("AODNIR", "AODNIR"), ("AODUV", "AODUV"),
                       ("burden", "BURDEN")):
            diags[f"{out}_{mode.name}"] = sw[k]
    return tot, lw, diags
