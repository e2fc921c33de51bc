"""Initial-condition files: read_inidat / write_inidat.

PyTorch twin of `cam_nor_physics_tpu.models.fv.inidat`. The reference
reads CAM IC NetCDF files (read_inidat, fv/dyn_comp.F90:2889-3081: PS, US,
VS, T and the constituents at :3004-3027), sets the topography (set_phis,
:3085-3168), averages every scalar's pole rows (process_inidat,
:3172-3402) and optionally seeds a temperature perturbation (pertlim,
:3230-3255). Here the files are NetCDF-3 through scipy, as in the JAX
package, so a file written by either package reads in the other. The
file reading, the pole averaging and pertlim run in numpy float64 on the
host; the state is derived on the target device.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import constants as c
from ...utils.device import resolve_device
from .cd_core import DynState, pressure_vars
from .grid import FVGrid
from .vertical import HybridCoord


def pole_average(a: np.ndarray) -> np.ndarray:
    """A copy of `a` with each pole row replaced by its zonal mean
    (process_inidat's pole consistency, dyn_comp.F90:3257-3273): the cap
    is one control volume and carries one value."""
    a = np.array(a)
    a[..., 0, :] = a[..., 0, :].mean(axis=-1, keepdims=True)
    a[..., -1, :] = a[..., -1, :].mean(axis=-1, keepdims=True)
    return a


def apply_pertlim(t: np.ndarray, pertlim: float, seed: int = 0) -> np.ndarray:
    """The seeded temperature perturbation (dyn_comp.F90:3230-3255):
    uniform in (-pertlim, +pertlim), numpy's default_rng(seed), so both
    packages draw the same perturbation."""
    if pertlim == 0.0:
        return t
    rng = np.random.default_rng(seed)
    return t * (1.0 + pertlim * (2.0 * rng.random(t.shape) - 1.0))


def read_inidat(path: str, grid: FVGrid, coord: HybridCoord,
                constituent_names=("Q",), pertlim: float = 0.0,
                dtype=torch.float64, device="cuda"
                ) -> tuple[DynState, torch.Tensor]:
    """Read a CAM IC file (read_inidat, dyn_comp.F90:2889-3081) into
    (DynState, phis) on `device`.

    Variables: PS (lat, lon); T and the constituents (lev, lat, lon), a
    leading time dimension squeezed; US (lev, slat, lon) onto the edge
    rows 1..jm-1; VS (lev, lat, lon); PHIS optional. A missing
    constituent, US, VS or PHIS reads as zeros. Fields must match the
    grid."""
    from scipy.io import netcdf_file
    dev = resolve_device(device)
    km, jm, im = grid.km, grid.jm, grid.im

    with netcdf_file(path, "r", mmap=False) as nc:
        def get(name, ndim):
            """A variable, its leading unit time dimension squeezed."""
            v = np.array(nc.variables[name][:], np.float64)
            while v.ndim > ndim and v.shape[0] == 1:
                v = v[0]
            return v

        ps = get("PS", 2)
        t = get("T", 3)
        if t.shape != (km, jm, im):
            raise ValueError(f"T shape {t.shape} != grid {(km, jm, im)}")
        qs = [get(name, 3) if name in nc.variables else
              np.zeros((km, jm, im)) for name in constituent_names]
        us = get("US", 3) if "US" in nc.variables else \
            np.zeros((km, jm - 1, im))
        vs = get("VS", 3) if "VS" in nc.variables else np.zeros((km, jm, im))
        phis = get("PHIS", 2) if "PHIS" in nc.variables else \
            np.zeros((jm, im))

    ps = pole_average(ps)
    t = pole_average(apply_pertlim(t, pertlim))
    qs = [pole_average(q) for q in qs]
    phis = pole_average(phis)

    u = np.zeros((km, jm, im))
    u[:, 1:, :] = us
    v = np.array(vs)
    v[:, 0, :] = 0.0
    v[:, -1, :] = 0.0

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    # the hydrostatic state from the hybrid coordinate and PS
    ak = coord.ak.to(device=dev, dtype=torch.float64)
    bk = coord.bk.to(device=dev, dtype=torch.float64)
    pe = (ak + bk * f64(ps)[..., None]).movedim(-1, 0)
    delp = pe[1:] - pe[:-1]
    _, _, pkz, _ = pressure_vars(delp, coord.ptop)
    pt = f64(t) * (1.0 + c.ZVIR * f64(qs[0])) / pkz

    state = DynState(
        u=f64(u).to(dtype), v=f64(v).to(dtype), pt=pt.to(dtype),
        delp=delp.to(dtype).contiguous(), q=f64(np.stack(qs)).to(dtype))
    return state, f64(phis).to(dtype)


def write_inidat(path: str, state: DynState, phis, grid: FVGrid,
                 coord: HybridCoord, constituent_names=("Q",)) -> None:
    """Write the dycore state as a CAM-convention IC file (float64
    variables PS, PHIS, T, US, VS and the named constituents)."""
    from scipy.io import netcdf_file
    km, jm, im = grid.km, grid.jm, grid.im
    pe, _, pkz, _ = pressure_vars(state.delp, coord.ptop)
    t = state.pt * pkz / (1.0 + c.ZVIR * state.q[0])

    def host(a):
        return a.detach().cpu().numpy().astype(np.float64)

    with netcdf_file(path, "w") as nc:
        nc.createDimension("lat", jm)
        nc.createDimension("lon", im)
        nc.createDimension("slat", jm - 1)
        nc.createDimension("lev", km)
        for name, dims, data in (
                ("PS", ("lat", "lon"), pe[-1]),
                ("PHIS", ("lat", "lon"), phis),
                ("T", ("lev", "lat", "lon"), t),
                ("US", ("lev", "slat", "lon"), state.u[:, 1:, :]),
                ("VS", ("lev", "lat", "lon"), state.v)):
            nc.createVariable(name, "d", dims)[:] = host(data)
        for m, name in enumerate(constituent_names):
            nc.createVariable(name, "d", ("lev", "lat", "lon"))[:] = \
                host(state.q[m])
