"""Held-Suarez (1994) idealized forcing and initial states.

PyTorch twin of `cam_nor_physics_tpu.models.fv.held_suarez`, with the
published HS94 constants. Operates on the dycore state (pt = virtual
potential temperature Tv/pkz; dry, so Tv = T).
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.tp_core import _rollx, _rolly, wset_row
from ...utils import constants as c
from ...utils.timing import spanned
from .cd_core import DynState, pressure_vars
from .grid import FVGrid
from .vertical import HybridCoord

KF = 1.0 / 86400.0        # surface Rayleigh damping (1/s)
KA = 1.0 / (40.0 * 86400.0)
KS = 1.0 / (4.0 * 86400.0)
DT_Y = 60.0               # equator-pole temperature difference (K)
DTH_Z = 10.0              # vertical theta gradient parameter (K)
SIG_B = 0.7
P0 = 1.0e5
T_MIN = 200.0
T_SRF = 315.0


def equilibrium_temperature(p, lat):
    """Teq(p, φ) (HS94, under their eq. 2)."""
    s2 = torch.sin(lat) ** 2
    c2 = torch.cos(lat) ** 2
    teq = (T_SRF - DT_Y * s2 - DTH_Z * torch.log(p / P0) * c2) * \
        (p / P0) ** c.CAPPA
    return torch.clamp(teq, min=T_MIN)


@spanned("hs_forcing")
def hs_forcing(state: DynState, grid: FVGrid, ptop: float, dt: float
               ) -> DynState:
    """One forward step of HS94 temperature relaxation + Rayleigh friction."""
    pe, pk, pkz, peln = pressure_vars(state.delp, ptop)
    pmid = 0.5 * (pe[1:] + pe[:-1])
    sigma = pmid / pe[-1][None]
    lat_c = grid.lats[:, None]

    tv = state.pt * pkz
    kt_vert = torch.clamp((sigma - SIG_B) / (1.0 - SIG_B), min=0.0)
    kt = KA + (KS - KA) * kt_vert * torch.cos(lat_c) ** 4
    teq = equilibrium_temperature(pmid, lat_c)
    tv_new = tv + dt * (-kt * (tv - teq))
    pt_new = tv_new / pkz

    kv = KF * kt_vert
    kv_u = wset_row(0.5 * (kv + _rolly(kv, 1)), 0, kv[..., 0, :])
    kv_v = 0.5 * (kv + _rollx(kv, 1))
    u_new = state.u * torch.exp(-dt * kv_u)
    v_new = state.v * torch.exp(-dt * kv_v)
    return state.replace(u=u_new, v=v_new, pt=pt_new)


def isothermal_rest_state(grid: FVGrid, coord: HybridCoord, t0: float = 260.0,
                          nq: int = 1) -> DynState:
    """Atmosphere at rest over flat topography, in the grid's dtype and on
    its device."""
    jm, im, km = grid.jm, grid.im, grid.km
    kw = dict(dtype=grid.dtype, device=grid.device)
    ps = torch.full((jm, im), 1.0e5, **kw)
    pe = coord.pint(ps).movedim(-1, 0)
    delp = pe[1:] - pe[:-1]
    _, _, pkz, _ = pressure_vars(delp, coord.ptop)
    pt = torch.full((km, jm, im), t0, **kw) / pkz
    z = torch.zeros((km, jm, im), **kw)
    q = torch.zeros((nq, km, jm, im), **kw)
    return DynState(u=z, v=z.clone(), pt=pt, delp=delp.contiguous(), q=q)


def hs_initial_state(grid: FVGrid, coord: HybridCoord, nq: int = 1,
                     pert: float = 1.0, seed: int = 0,
                     rng: np.random.Generator | None = None) -> DynState:
    """Held-Suarez spin-up state: the Teq profile plus temperature noise
    from `rng` (default np.random.default_rng(seed), the same draw as the
    JAX package) to break zonal symmetry; uniform on each pole cap."""
    st = isothermal_rest_state(grid, coord, nq=nq)
    pe, _, pkz, _ = pressure_vars(st.delp, coord.ptop)
    pmid = 0.5 * (pe[1:] + pe[:-1])
    teq = equilibrium_temperature(pmid, grid.lats[:, None])
    if rng is None:
        rng = np.random.default_rng(seed)
    noise = pert * rng.standard_normal(tuple(teq.shape))
    tv = teq + torch.as_tensor(noise, dtype=teq.dtype, device=teq.device)
    tv[:, 0, :] = tv[:, 0, :].mean(dim=-1, keepdim=True)
    tv[:, -1, :] = tv[:, -1, :].mean(dim=-1, keepdim=True)
    return st.replace(pt=tv / pkz)
