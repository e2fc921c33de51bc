"""History system: the cam_history role (addfld / add_default / outfld).

Twin of `cam_nor_physics_tpu.utils.history`. Fields are declared once
(`addfld` with name, units, vertical dimension, grid and avgflag A/I/X/M:
average, instantaneous, max, min) and routed to tapes (`add_default`);
each step `outfld` feeds a value into a tape's accumulation buffer, and a
host-side writer resolves the buffer and writes a CAM-convention NetCDF-3
tape (dimension names lat/lon/slat/slon/lev/ilev/time, float32 on disk,
through scipy.io.netcdf_file). Staggered fields (US/VS on the FV u/v
staggers, reference dyn_comp.F90:676-712) keep their (lev, rows, lon)
layout.

The buffers are device tensors {name: {"sum", "count"}}, and `outfld`
accumulates into them in place: a CUDA graph of several coupled steps
accumulates history inside itself, and the driver reads and resets the
same tensors at a tape boundary. 'X'/'M' buffers start at -inf/+inf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

_AVGFLAGS = ("A", "I", "X", "M")
_GRIDS = ("fv_centers", "fv_u_stagger", "fv_v_stagger")

# a buffer's value before its first sample, by avgflag
INIT = {"A": 0.0, "I": 0.0, "X": -math.inf, "M": math.inf}


@dataclass(frozen=True)
class FieldDef:
    name: str
    units: str
    long_name: str
    vdim: str = "mid"          # 'mid' | 'int' | 'srf'
    avgflag: str = "A"         # 'A' averaged | 'I' instant | 'X' max | 'M' min
    gridname: str = "fv_centers"   # 'fv_centers' | 'fv_u_stagger' | 'fv_v_stagger'


@dataclass
class HistoryRegistry:
    """addfld/add_default registry (cam_history declaration side)."""

    fields: dict = field(default_factory=dict)      # name -> FieldDef
    defaults: dict = field(default_factory=dict)    # tape -> [names]

    def addfld(self, name: str, units: str, long_name: str,
               vdim: str = "mid", avgflag: str = "A",
               gridname: str = "fv_centers") -> None:
        if name in self.fields:
            raise ValueError(f"duplicate addfld {name!r}")
        if avgflag not in _AVGFLAGS:
            raise ValueError(f"avgflag {avgflag!r} not one of {_AVGFLAGS}")
        if gridname not in _GRIDS:
            raise ValueError(f"gridname {gridname!r} not one of {_GRIDS}")
        self.fields[name] = FieldDef(name, units, long_name, vdim, avgflag,
                                     gridname)

    def add_default(self, name: str, tape: int = 0) -> None:
        if name not in self.fields:
            raise KeyError(f"add_default of undeclared field {name!r}")
        self.defaults.setdefault(tape, []).append(name)

    def buffer(self, ncol: int, pver: int, dtype=torch.float64,
               tape: int = 0, jm: int | None = None, im: int | None = None,
               device="cpu") -> dict:
        """The accumulation buffer {name: {'sum': tensor, 'count': 0-d
        tensor}} of the tape's default fields on `device`. Staggered fields
        are buffered in their (pver, rows, im) layout and need jm/im;
        center fields use flat (ncol, ...) columns."""
        shapes = {"mid": (ncol, pver), "int": (ncol, pver + 1),
                  "srf": (ncol,)}
        buf = {}
        for name in self.defaults.get(tape, []):
            fd = self.fields[name]
            if fd.gridname == "fv_centers":
                shape = shapes[fd.vdim]
            else:
                if jm is None or im is None:
                    raise ValueError(
                        f"buffer() needs jm/im for staggered field {name!r}")
                rows = jm - 1 if fd.gridname == "fv_u_stagger" else jm
                shape = (pver, rows, im)
            buf[name] = {
                "sum": torch.full(shape, INIT[fd.avgflag], dtype=dtype,
                                  device=device),
                "count": torch.zeros((), dtype=dtype, device=device)}
        return buf


def _accumulate(entry: dict, value, avgflag: str) -> dict:
    """One sample into `entry`, in place."""
    s = entry["sum"]
    if avgflag == "A":
        s.add_(value)
    elif avgflag == "I":
        s.copy_(value)
    elif avgflag == "X":
        torch.maximum(s, value, out=s)
    else:                                            # 'M'
        torch.minimum(s, value, out=s)
    entry["count"].add_(1.0)
    return entry


def outfld(buf: dict, name: str, value,
           registry: HistoryRegistry = None) -> dict:
    """Accumulate one field sample into `buf` in place (outfld role) and
    return it. A field not on the tape is dropped, as the reference drops
    unrequested fields. Without a registry the field is averaged ('A')."""
    if name not in buf:
        return buf
    avgflag = registry.fields[name].avgflag if registry is not None else "A"
    _accumulate(buf[name], value, avgflag)
    return buf


def outfld_many(buf: dict, payload: dict,
                registry: HistoryRegistry = None) -> dict:
    """Accumulate a diagnostics dict (the per-step outfld batch)."""
    for name, value in payload.items():
        buf = outfld(buf, name, value, registry)
    return buf


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def history_resolve(registry: HistoryRegistry, buf: dict) -> dict:
    """Resolved numpy values per avgflag: 'A' the mean over samples, 'I'
    the last sample, 'X'/'M' the running extreme; a field never sampled
    resolves to 0. Reads the buffers on the host."""
    out = {}
    for name, entry in buf.items():
        cnt = _host(entry["count"])
        fd = registry.fields[name]
        val = _host(entry["sum"])
        if fd.avgflag == "A":
            out[name] = val / np.maximum(cnt, 1.0)
        elif cnt == 0.0:
            out[name] = np.zeros_like(val)
        else:
            out[name] = val
    return out


def stagger_coords(lats: np.ndarray, lons: np.ndarray):
    """FV staggered coordinates: slat = interior interface latitudes
    (jm-1 midpoints), slon = west-edge longitudes (lon - dl/2)."""
    slat = 0.5 * (np.asarray(lats)[:-1] + np.asarray(lats)[1:])
    lons = np.asarray(lons)
    dl = lons[1] - lons[0] if len(lons) > 1 else 0.0
    slon = lons - 0.5 * dl
    return slat, slon


def _field_shape(fd: FieldDef, jm: int, im: int, pver: int):
    """(dims, shape) of one resolved field in the tape file."""
    if fd.gridname == "fv_u_stagger":
        return ("time", "lev", "slat", "lon"), (pver, jm - 1, im)
    if fd.gridname == "fv_v_stagger":
        return ("time", "lev", "lat", "slon"), (pver, jm, im)
    if fd.vdim == "srf":
        return ("time", "lat", "lon"), (jm, im)
    dim = "lev" if fd.vdim == "mid" else "ilev"
    nk = pver if fd.vdim == "mid" else pver + 1
    return ("time", dim, "lat", "lon"), (nk, jm, im)


def write_history_netcdf(path: str, registry: HistoryRegistry, buf: dict,
                         lats: np.ndarray, lons: np.ndarray, pver: int,
                         time_days: float) -> None:
    """Write one CAM-convention NetCDF-3 history tape (cam_history writer
    role). lats/lons in radians. Center-grid column batches are
    unflattened to (time, [lev,] lat, lon); staggered fields keep their
    layout."""
    from scipy.io import netcdf_file
    lats, lons = _host(lats), _host(lons)
    jm, im = len(lats), len(lons)
    vals = history_resolve(registry, buf)
    slat, slon = stagger_coords(lats, lons)
    with netcdf_file(path, "w") as nc:
        nc.createDimension("time", None)
        nc.createDimension("lat", jm)
        nc.createDimension("lon", im)
        nc.createDimension("slat", jm - 1)
        nc.createDimension("slon", im)
        nc.createDimension("lev", pver)
        nc.createDimension("ilev", pver + 1)
        vtime = nc.createVariable("time", "d", ("time",))
        vtime.units = b"days since 0001-01-01 00:00:00"
        for vname, dim, units, vals_ in (
                ("lat", "lat", b"degrees_north", lats),
                ("lon", "lon", b"degrees_east", lons),
                ("slat", "slat", b"degrees_north", slat),
                ("slon", "slon", b"degrees_east", slon)):
            v = nc.createVariable(vname, "d", (dim,))
            v.units = units
            v[:] = np.degrees(vals_)
        vtime[0] = time_days
        for name, val in vals.items():
            fd = registry.fields[name]
            dims, shape = _field_shape(fd, jm, im, pver)
            v = nc.createVariable(name, "f", dims)
            if fd.gridname == "fv_centers" and fd.vdim != "srf":
                val = val.T           # (ncol, k) -> (k, ncol)
            v[0] = val.reshape(shape).astype(np.float32)
            v.units = fd.units.encode()
            v.long_name = fd.long_name.encode()


def default_registry_atm() -> HistoryRegistry:
    """The baseline field set the driver emits (a subset of the
    reference's addflds: the dycore state, dyn_comp.F90:676-712; the ZM
    set, zm_conv_intr.F90:677-858; the diag_phys_writeout families)."""
    r = HistoryRegistry()
    r.addfld("T", "K", "Temperature")
    r.addfld("U", "m/s", "Zonal wind")
    r.addfld("V", "m/s", "Meridional wind")
    r.addfld("US", "m/s", "Zonal wind, staggered", gridname="fv_u_stagger")
    r.addfld("VS", "m/s", "Meridional wind, staggered",
             gridname="fv_v_stagger")
    r.addfld("Q", "kg/kg", "Specific humidity")
    r.addfld("PS", "Pa", "Surface pressure", vdim="srf")
    r.addfld("OMEGA", "Pa/s", "Vertical pressure velocity")
    r.addfld("Z3", "m", "Geopotential height")
    r.addfld("CAPE", "J/kg", "Convectively available potential energy",
             vdim="srf")
    r.addfld("FREQZM", "fraction", "Fractional occurrence of ZM convection",
             vdim="srf")
    r.addfld("PRECC", "m/s", "Convective precipitation rate", vdim="srf")
    r.addfld("PRECCMX", "m/s", "Max convective precipitation rate",
             vdim="srf", avgflag="X")
    r.addfld("ZMDT", "K/s", "T tendency - Zhang-McFarlane convection")
    r.addfld("ZMDQ", "kg/kg/s", "Q tendency - Zhang-McFarlane convection")
    r.addfld("CMFMC", "kg/m2/s", "Total convective mass flux", vdim="int")
    r.addfld("CLDTOP", "level", "Convective cloud top level", vdim="srf")
    r.addfld("CLDBOT", "level", "Convective cloud bottom level", vdim="srf")
    for name in ["T", "U", "V", "Q", "PS", "CAPE", "PRECC", "ZMDT", "ZMDQ",
                 "CMFMC", "FREQZM"]:
        r.add_default(name)
    return r
