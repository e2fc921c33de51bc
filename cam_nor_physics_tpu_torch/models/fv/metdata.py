"""Prescribed meteorology (offline dynamics): the metdata equivalent.

PyTorch twin of `cam_nor_physics_tpu.models.fv.metdata`. The reference's
OFFLINE_DYN build (fv/dyn_comp.F90:500-502, 1274-1281) replaces the
computed dynamics with meteorology read from files, so that the physics
and the tracers can be driven by prescribed winds and temperature.
`MetData` holds the time series on the device; `met_state_at`
interpolates it linearly in time with no host read; `offline_dyn_run`
overwrites the dynamical fields with it or relaxes them toward it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...utils import constants as c
from ...utils.device import resolve_device
from .cd_core import DynState

MET_FIELDS = ("times", "u", "v", "pt", "delp", "q")


@dataclass
class MetData:
    """Prescribed meteorology on the model grid: u, v, pt, delp
    (ntime, km, jm, im), q (ntime, nq, km, jm, im), times (ntime,) s."""

    times: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    pt: torch.Tensor
    delp: torch.Tensor
    q: torch.Tensor


def _time_weights(times, t):
    """One-hot selectors of the bracketing records (n,) and the linear
    weight of the later one, for model time t (clamped to the record)."""
    n = times.shape[0]
    t = times.new_full((), t)
    k = torch.clamp(torch.sum(times <= t) - 1, 0, n - 2)
    idx = torch.arange(n, device=times.device)
    lo = (idx == k).to(times.dtype)
    hi = (idx == k + 1).to(times.dtype)
    t_lo = torch.sum(lo * times)
    t_hi = torch.sum(hi * times)
    w = torch.clamp((t - t_lo) / torch.where(t_hi == t_lo, 1.0, t_hi - t_lo),
                    0.0, 1.0)
    return lo, hi, w


def _select(onehot, a):
    """Σ_n onehot[n]·a[n], the JAX package's contraction (a value that is
    not finite in any record makes the result NaN there, as in JAX)."""
    return torch.sum(onehot.reshape((-1,) + (1,) * (a.ndim - 1)) * a, 0)


def met_state_at(met: MetData, t: float) -> DynState:
    """The prescribed fields linearly interpolated in time to model time
    t (metdata's interpolation), clamped outside the record."""
    lo, hi, w = _time_weights(met.times, t)

    def interp(a):
        a_lo = _select(lo.to(a.dtype), a)
        return a_lo + w * (_select(hi.to(a.dtype), a) - a_lo)

    return DynState(u=interp(met.u), v=interp(met.v), pt=interp(met.pt),
                    delp=interp(met.delp), q=interp(met.q))


def load_metdata_netcdf(path: str, coord, zvir: float | None = None,
                        dtype=None, device="cuda") -> MetData:
    """Read a CAM-convention meteorology file (NetCDF-3 through scipy)
    into MetData on `device`: dims (time, lev, lat, lon); variables time
    (s), U, V, T (time, lev, lat, lon), PS (time, lat, lon), Q and
    optionally Q2..Qn. delp comes from PS through the hybrid ak/bk, and
    pt = T(1 + zvir·q)/pkz, in numpy float64 as in the JAX package; the
    tensors are then cast to `dtype` (float64 if None)."""
    from scipy.io import netcdf_file
    zvir = c.ZVIR if zvir is None else zvir
    dev = resolve_device(device)

    with netcdf_file(path, "r", mmap=False) as nc:
        def get(name):
            return np.array(nc.variables[name][:], np.float64)

        times, u, v, t, ps = (get(n) for n in ("time", "U", "V", "T", "PS"))
        qs = [get("Q")]
        i = 2
        while f"Q{i}" in nc.variables:
            qs.append(get(f"Q{i}"))
            i += 1
    q = np.stack(qs, axis=1)                      # (ntime, nq, km, jm, im)

    ak = coord.ak.detach().cpu().numpy().astype(np.float64)
    bk = coord.bk.detach().cpu().numpy().astype(np.float64)
    pe = ak[None, :, None, None] + bk[None, :, None, None] * ps[:, None]
    delp = pe[:, 1:] - pe[:, :-1]
    peln = np.log(pe)
    pk = pe ** c.CAPPA
    pkz = (pk[:, 1:] - pk[:, :-1]) / (c.CAPPA * (peln[:, 1:] - peln[:, :-1]))
    pt = t * (1.0 + zvir * q[:, 0]) / pkz

    def dev_t(x):
        return torch.as_tensor(x, dtype=dtype or torch.float64, device=dev)

    return MetData(times=dev_t(times), u=dev_t(u), v=dev_t(v), pt=dev_t(pt),
                   delp=dev_t(delp), q=dev_t(q))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def save_metdata_netcdf(path: str, times, u, v, t, ps, q_list) -> None:
    """Write a CAM-convention met file, the inverse of
    load_metdata_netcdf. u, v, t: (ntime, km, jm, im); ps (ntime, jm,
    im); q_list: (ntime, km, jm, im) mixing ratios Q, Q2, ... Tensors or
    arrays."""
    from scipy.io import netcdf_file
    ntime, km, jm, im = _host(u).shape
    with netcdf_file(path, "w") as nc:
        nc.createDimension("time", ntime)
        nc.createDimension("lev", km)
        nc.createDimension("lat", jm)
        nc.createDimension("lon", im)

        def var(name, dims, data, units):
            vv = nc.createVariable(name, "d", dims)
            vv[:] = _host(data)
            vv.units = units

        var("time", ("time",), times, "s")
        var("U", ("time", "lev", "lat", "lon"), u, "m/s")
        var("V", ("time", "lev", "lat", "lon"), v, "m/s")
        var("T", ("time", "lev", "lat", "lon"), t, "K")
        var("PS", ("time", "lat", "lon"), ps, "Pa")
        for i, qi in enumerate(q_list):
            name = "Q" if i == 0 else f"Q{i + 1}"
            var(name, ("time", "lev", "lat", "lon"), qi, "kg/kg")


def offline_dyn_run(state: DynState, met: MetData, t: float, ndt: float,
                    met_rlx: float = 0.0) -> DynState:
    """The offline replacement for dyn_run (dyn_comp.F90:1274-1281):
    advance to the prescribed meteorology at t + ndt. met_rlx in [0, 1]:
    0 or 1 overwrite the winds and thermodynamics, otherwise relax toward
    them linearly. The tracers stay prognostic."""
    tgt = met_state_at(met, t + ndt)
    a = 1.0 if met_rlx == 0.0 else met_rlx

    def mix(cur, new):
        return cur + a * (new - cur)

    return state.replace(u=mix(state.u, tgt.u), v=mix(state.v, tgt.v),
                         pt=mix(state.pt, tgt.pt),
                         delp=mix(state.delp, tgt.delp))
