"""Jablonowski-Williamson (2006, QJRMS 132:2943) baroclinic-wave test.

PyTorch twin of `cam_nor_physics_tpu.models.fv.baroclinic_wave`: the
dycore's standard deterministic test case, the analytic initial state of
read_inidat's analytic hook (fv/dyn_comp.F90:2968-2976). A balanced,
zonally symmetric baroclinic jet, an exact steady state of the hydrostatic
primitive equations, plus an optional localized u-perturbation that grows
into an explosive baroclinic wave around day 8. Unperturbed, a good dycore
holds the jet steady; perturbed, the surface low deepens as the published
solutions do. Evaluated on the FV D grid (u at south cell edges, v at west
cell edges), in float64 and then cast.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...utils import constants as c
from ...utils.device import resolve_device
from .cd_core import DynState, pressure_vars
from .grid import FVGrid
from .vertical import HybridCoord

# the JW06 constants
ETA0 = 0.252          # jet-core eta level
ETA_T = 0.2           # tropopause eta
U0 = 35.0             # max jet speed (m/s)
T0 = 288.0            # surface mean temperature (K)
GAMMA = 0.005         # mean lapse rate (K/m)
DELTA_T = 4.8e5       # stratosphere temperature-profile amplitude (K)
P0 = 1.0e5
UP = 1.0              # perturbation amplitude (m/s)
PERT_LON = math.pi / 9.0
PERT_LAT = 2.0 * math.pi / 9.0


def _t_mean(eta):
    tm = T0 * eta ** (c.RAIR * GAMMA / c.GRAVIT)
    return tm + torch.where(
        eta < ETA_T, DELTA_T * torch.clamp(ETA_T - eta, min=0.0) ** 5, 0.0)


def _horiz_factors(lat):
    """A1 and A2 of JW06 eq. (6)/(7)."""
    a1 = (-2.0 * torch.sin(lat) ** 6 * (torch.cos(lat) ** 2 + 1.0 / 3.0)
          + 10.0 / 63.0)
    a2 = (8.0 / 5.0 * torch.cos(lat) ** 3 * (torch.sin(lat) ** 2 + 2.0 / 3.0)
          - math.pi / 4.0)
    return a1, a2


def _u_balanced(eta, lat):
    eta_v = (eta - ETA0) * math.pi / 2.0
    return U0 * torch.cos(eta_v) ** 1.5 * torch.sin(2.0 * lat) ** 2


def _temperature(eta, lat):
    eta_v = (eta - ETA0) * math.pi / 2.0
    a1, a2 = _horiz_factors(lat)
    fac = 0.75 * (eta * math.pi * U0 / c.RAIR) * torch.sin(eta_v) * \
        torch.sqrt(torch.cos(eta_v))
    return _t_mean(eta) + fac * (2.0 * U0 * torch.cos(eta_v) ** 1.5 * a1
                                 + c.REARTH * c.OMEGA * a2)


def _phis(lat):
    cvs = math.cos((1.0 - ETA0) * math.pi / 2.0) ** 1.5
    a1, a2 = _horiz_factors(lat)
    return U0 * cvs * (U0 * cvs * a1 + c.REARTH * c.OMEGA * a2)


def _u_perturbation(lon, lat):
    """The localized Gaussian u bump of JW06 eq. 11, radius a/10."""
    r_great = torch.arccos(torch.clamp(
        math.sin(PERT_LAT) * torch.sin(lat)
        + math.cos(PERT_LAT) * torch.cos(lat) * torch.cos(lon - PERT_LON),
        -1.0, 1.0))
    return UP * torch.exp(-(10.0 * r_great) ** 2)


def jw_baroclinic_wave(grid: FVGrid, coord: HybridCoord,
                       perturb: bool = True, nq: int = 1,
                       moist: bool = False, dtype=torch.float64,
                       device="cuda") -> tuple[DynState, torch.Tensor]:
    """(DynState, phis) of the JW06 case on the D grid, on `device`.

    ps = p0 everywhere (the case's topography carries the balance), so
    eta(k) = (ak + bk p0)/p0 is uniform and the formulas evaluate at the
    mid levels. `moist` adds the moist variant's specific humidity
    (Lauritzen et al. 2010 eq. 16) in tracer slot 0."""
    dev = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    jm, im, km = grid.jm, grid.im, grid.km
    dp = math.pi / (jm - 1)
    dl = 2.0 * math.pi / im

    # the grid's row and column positions (make_grid's), in float64
    lat_c = torch.as_tensor(np.linspace(-0.5 * math.pi, 0.5 * math.pi, jm),
                            **f64)
    lat_u = lat_c - 0.5 * dp                          # south edges
    lat_u[0] = -0.5 * math.pi                         # unused row
    lon_c = torch.as_tensor(-math.pi + dl * np.arange(im), **f64)

    ak, bk = coord.ak.to(**f64), coord.bk.to(**f64)
    eta_if = (ak + bk * P0) / P0
    eta3 = (0.5 * (eta_if[1:] + eta_if[:-1]))[:, None, None]

    # the winds on their staggered points
    u = _u_balanced(eta3, lat_u[None, :, None]).expand(km, jm, im).to(dtype)
    if perturb:
        u = u + _u_perturbation(lon_c[None, None, :],
                                lat_u[None, :, None]).to(dtype)
    u = u.clone()
    u[:, 0, :] = 0.0                                  # the polar edge row
    v = torch.zeros((km, jm, im), dtype=dtype, device=dev)

    # mass and thermodynamics at the centres
    pe = (ak + bk * P0).reshape(km + 1, 1, 1).expand(km + 1, jm, im)
    delp = (pe[1:] - pe[:-1]).to(dtype)
    _, _, pkz, _ = pressure_vars(delp, coord.ptop)
    t = _temperature(eta3, lat_c[None, :, None]).expand(km, jm, im).to(dtype)

    q = torch.zeros((nq, km, jm, im), dtype=dtype, device=dev)
    tv = t
    if moist:
        q0, phi_w, p_w = 0.021, 2.0 * math.pi / 9.0, 3.4e4
        pmid = 0.5 * (pe[1:] + pe[:-1])
        qv = q0 * torch.exp(-(lat_c[None, :, None] / phi_w) ** 4) * \
            torch.exp(-(((pmid / P0) - 1.0) * P0 / p_w) ** 2)
        q[0] = qv.to(dtype)
        tv = t * (1.0 + c.ZVIR * qv)

    phis = _phis(lat_c)[:, None].expand(jm, im).to(dtype).contiguous()
    state = DynState(u=u.contiguous(), v=v, pt=(tv / pkz).to(dtype),
                     delp=delp.contiguous(), q=q)
    return state, phis
