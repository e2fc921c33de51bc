"""Carry dycore state between the JAX package and the port as numpy arrays.

`dynstate_to_numpy`/`dynstate_from_numpy` map the DynState fields
(u, v, pt, delp, q); `grid_to_numpy`/`grid_from_numpy` the FVGrid tables and
scalars; `coord_to_numpy`/`coord_from_numpy` the HybridCoord. The numpy side
is a plain dict keyed by the field names both packages share, so a JAX
object converts with {f: np.asarray(getattr(obj, f)) for f in FIELDS}.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.fv.cd_core import DynState
from .models.fv.grid import FVGrid
from .models.fv.vertical import HybridCoord
from .utils.device import resolve_device

STATE_FIELDS = ("u", "v", "pt", "delp", "q")
GRID_TABLES = ("cosp", "sinp", "cose", "sine", "acosp", "acosu", "coslon",
               "sinlon", "cosl5", "sinl5", "f0", "fc", "pft_center",
               "pft_edge", "lats", "lons")
GRID_SCALARS = ("im", "jm", "km", "dl", "dp", "acap", "rcap", "ycrit_deg",
                "rdy")
COORD_FIELDS = ("ak", "bk", "ps0", "ptop")


def _tensor(a, dtype, device):
    """A copy of `a` as a tensor (its own dtype unless `dtype` is given)."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def dynstate_from_numpy(fields: dict, device="cuda", dtype=None) -> DynState:
    """DynState from numpy arrays keyed u, v, pt, delp, q (dtype kept
    unless `dtype` is given)."""
    dev = resolve_device(device)
    return DynState(**{f: _tensor(fields[f], dtype, dev)
                       for f in STATE_FIELDS})


def dynstate_to_numpy(state: DynState) -> dict:
    return {f: getattr(state, f).detach().cpu().numpy() for f in STATE_FIELDS}


def grid_from_numpy(tables: dict, device="cuda", dtype=None) -> FVGrid:
    """FVGrid from its numpy tables and scalars."""
    dev = resolve_device(device)
    kw = {f: _tensor(tables[f], dtype, dev) for f in GRID_TABLES}
    for f in GRID_SCALARS:
        kw[f] = int(tables[f]) if f in ("im", "jm", "km") \
            else float(tables[f])
    return FVGrid(**kw)


def grid_to_numpy(grid: FVGrid) -> dict:
    out = {f: getattr(grid, f).detach().cpu().numpy() for f in GRID_TABLES}
    out.update({f: getattr(grid, f) for f in GRID_SCALARS})
    return out


def coord_from_numpy(fields: dict, device="cuda", dtype=None) -> HybridCoord:
    dev = resolve_device(device)
    return HybridCoord(ak=_tensor(fields["ak"], dtype, dev),
                       bk=_tensor(fields["bk"], dtype, dev),
                       ps0=float(fields["ps0"]), ptop=float(fields["ptop"]))


def coord_to_numpy(coord: HybridCoord) -> dict:
    return {"ak": coord.ak.detach().cpu().numpy(),
            "bk": coord.bk.detach().cpu().numpy(),
            "ps0": coord.ps0, "ptop": coord.ptop}
