"""Carry dycore state between the JAX package and the port as numpy arrays.

`dynstate_to_numpy`/`dynstate_from_numpy` map the DynState fields
(u, v, pt, delp, q); `grid_to_numpy`/`grid_from_numpy` the FVGrid tables and
scalars; `coord_to_numpy`/`coord_from_numpy` the HybridCoord;
`physstate_*`, `pbuf_*` and `zmtend_to_numpy` the physics state, the physics
buffer and the outputs of zm_conv_tend; `atmstate_*` the coupled state of
atm_step (dycore state, physics export, physics buffer with its lifetimes,
phis, nstep), `camin_*` and `camout_to_numpy` the surface exchange;
`atmstate_named_leaves`/`atmstate_from_leaves` the coupled state's leaves
in the order `jax.tree.flatten` gives the JAX AtmState's (the checkpoint
layout both drivers write); `metdata_*`, `iopdata_*` and `scamforcing_*`
the offline dynamics' MetData and SCAM's IopData and ScamForcing. The
numpy side
is a plain dict keyed by the field names both packages share, so a JAX
object converts with {f: np.asarray(getattr(obj, f)) for f in FIELDS}.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.atm_comp import AtmState
from .models.coupling.camsrfexch import CAMIN_FIELDS, CAMOUT_FIELDS, CamIn
from .models.fv.cd_core import DynState
from .models.fv.grid import FVGrid
from .models.fv.metdata import MET_FIELDS, MetData
from .models.fv.vertical import HybridCoord
from .models.physics.physics_buffer import PhysicsBuffer
from .models.physics.state import PTEND_FIELDS, PhysicsState
from .models.physics.state import STATE_FIELDS as PHYS_STATE_FIELDS
from .models.physics.zm_conv_intr import TEND_FIELDS
from .models.scam import FORCING_FIELDS, IOP_FIELDS, IopData, ScamForcing
from .utils.device import resolve_device

STATE_FIELDS = ("u", "v", "pt", "delp", "q")
GRID_TABLES = ("cosp", "sinp", "cose", "sine", "acosp", "acosu", "coslon",
               "sinlon", "cosl5", "sinl5", "f0", "fc", "pft_center",
               "pft_edge", "lats", "lons", "dft_fc", "dft_fs", "dft_gc",
               "dft_gs")
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


# ---- physics state, physics buffer and zm_conv_tend outputs ----

def _np(x):
    """A tensor or array (either package's) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def physstate_from_numpy(fields: dict, device="cuda",
                         dtype=None) -> PhysicsState:
    """PhysicsState from numpy arrays keyed by its field names."""
    dev = resolve_device(device)
    return PhysicsState(**{f: _tensor(fields[f], dtype, dev)
                           for f in PHYS_STATE_FIELDS})


def physstate_to_numpy(state) -> dict:
    """{field: array} of a PhysicsState of either package."""
    return {f: _np(getattr(state, f)) for f in PHYS_STATE_FIELDS}


def pbuf_from_numpy(fields: dict, lifetimes: dict, device="cuda",
                    dtype=None) -> PhysicsBuffer:
    """PhysicsBuffer from {name: array} and {name: lifetime}."""
    dev = resolve_device(device)
    return PhysicsBuffer(fields={k: _tensor(v, dtype, dev)
                                 for k, v in fields.items()},
                         lifetimes=dict(lifetimes))


def pbuf_to_numpy(pbuf) -> tuple[dict, dict]:
    """({name: array}, {name: lifetime}) of a PhysicsBuffer of either
    package."""
    return ({k: _np(v) for k, v in pbuf.fields.items()},
            dict(pbuf.lifetimes))


def zmtend_to_numpy(out) -> dict:
    """A flat {key: array} of a ZMTendOut of either package: the summed
    ptend ("ptend.s", ...), the updated state ("state1.t", ...), every pbuf
    field ("pbuf.ZM_MU", ...), the coupler outputs ("mcon", ...) and the
    diagnostics ("diag.CAPE", ...)."""
    res = {f"ptend.{f}": _np(getattr(out.ptend_all, f)) for f in PTEND_FIELDS}
    res.update({f"state1.{f}": a
                for f, a in physstate_to_numpy(out.state1).items()})
    res.update({f"pbuf.{k}": a for k, a in pbuf_to_numpy(out.pbuf)[0].items()})
    res.update({f: _np(getattr(out, f)) for f in TEND_FIELDS})
    res.update({f"diag.{k}": _np(v) for k, v in out.diagnostics.items()})
    return res


# ---- the coupled state and the surface exchange ----

def atmstate_from_numpy(fields: dict, device="cuda", dtype=None) -> AtmState:
    """AtmState from {"dyn": {...}, "phys": {...}, "pbuf": ({...},
    {lifetimes}), "phis": array, "nstep": int}; nstep becomes a 0-d int32
    tensor, every other array keeps its dtype unless `dtype` is given."""
    dev = resolve_device(device)
    pb_fields, lifetimes = fields["pbuf"]
    return AtmState(
        dyn=dynstate_from_numpy(fields["dyn"], dev, dtype),
        phys=physstate_from_numpy(fields["phys"], dev, dtype),
        pbuf=pbuf_from_numpy(pb_fields, lifetimes, dev, dtype),
        phis=_tensor(fields["phis"], dtype, dev),
        nstep=torch.as_tensor(int(np.asarray(fields["nstep"])),
                              dtype=torch.int32, device=dev))


def atmstate_to_numpy(state) -> dict:
    """The numpy form of an AtmState of either package (see
    atmstate_from_numpy)."""
    return {"dyn": {f: _np(getattr(state.dyn, f)) for f in STATE_FIELDS},
            "phys": physstate_to_numpy(state.phys),
            "pbuf": pbuf_to_numpy(state.pbuf),
            "phis": _np(state.phis), "nstep": int(_np(state.nstep))}


def camin_from_numpy(fields: dict, device="cuda", dtype=None) -> CamIn:
    """CamIn from numpy arrays keyed by its field names."""
    dev = resolve_device(device)
    return CamIn(**{f: _tensor(fields[f], dtype, dev) for f in CAMIN_FIELDS})


def camin_to_numpy(cam_in) -> dict:
    """{field: array} of a CamIn of either package."""
    return {f: _np(getattr(cam_in, f)) for f in CAMIN_FIELDS}


def camout_to_numpy(cam_out) -> dict:
    """{field: array} of a CamOut of either package."""
    return {f: _np(getattr(cam_out, f)) for f in CAMOUT_FIELDS}


# ---- the coupled state's leaves (the checkpoint layout) ----

def atmstate_named_leaves(state: AtmState) -> list:
    """[(name, tensor)] of an AtmState in the JAX AtmState's
    `jax.tree.flatten` order: dyn's u, v, pt, delp, q; phys's fields in
    PhysicsState order; the pbuf's fields by sorted name (a dict's keys
    flatten sorted); phis; nstep."""
    out = [(f"dyn.{f}", getattr(state.dyn, f)) for f in STATE_FIELDS]
    out += [(f"phys.{f}", getattr(state.phys, f))
            for f in PHYS_STATE_FIELDS]
    out += [(f"pbuf.{k}", state.pbuf.fields[k])
            for k in sorted(state.pbuf.fields)]
    return out + [("phis", state.phis), ("nstep", state.nstep)]


def atmstate_from_leaves(template: AtmState, leaves) -> AtmState:
    """The AtmState of `template`'s structure (its pbuf names, their
    order and lifetimes) holding `leaves`, in atmstate_named_leaves'
    order."""
    leaves = list(leaves)
    nd, nphys = len(STATE_FIELDS), len(PHYS_STATE_FIELDS)
    names = sorted(template.pbuf.fields)
    if len(leaves) != nd + nphys + len(names) + 2:
        raise ValueError(f"{len(leaves)} leaves for an AtmState of "
                         f"{nd + nphys + len(names) + 2}")
    pb = dict(zip(names, leaves[nd + nphys:nd + nphys + len(names)]))
    return AtmState(
        dyn=DynState(**dict(zip(STATE_FIELDS, leaves[:nd]))),
        phys=PhysicsState(**dict(zip(PHYS_STATE_FIELDS,
                                     leaves[nd:nd + nphys]))),
        pbuf=PhysicsBuffer(fields={k: pb[k] for k in template.pbuf.fields},
                           lifetimes=dict(template.pbuf.lifetimes)),
        phis=leaves[-2], nstep=leaves[-1])


# ---- the offline dynamics' and SCAM's forcing ----

def metdata_from_numpy(fields: dict, device="cuda", dtype=None) -> MetData:
    """MetData from numpy arrays keyed times, u, v, pt, delp, q."""
    dev = resolve_device(device)
    return MetData(**{f: _tensor(fields[f], dtype, dev) for f in MET_FIELDS})


def metdata_to_numpy(met) -> dict:
    """{field: array} of a MetData of either package."""
    return {f: _np(getattr(met, f)) for f in MET_FIELDS}


def iopdata_from_numpy(fields: dict, device="cuda", dtype=None) -> IopData:
    """IopData from numpy arrays keyed tsec, divT, divq, omega, shflx,
    lhflx; tsec stays a host array (in `dtype`'s precision if given)."""
    dev = resolve_device(device)
    tsec = np.array(fields["tsec"])
    if dtype is not None:
        tsec = tsec.astype(torch.zeros((), dtype=dtype).numpy().dtype)
    return IopData(tsec=tsec, **{f: _tensor(fields[f], dtype, dev)
                                 for f in IOP_FIELDS[1:]})


def iopdata_to_numpy(iop) -> dict:
    """{field: array} of an IopData of either package."""
    return {f: _np(getattr(iop, f)) for f in IOP_FIELDS}


def scamforcing_from_numpy(fields: dict, device="cuda",
                           dtype=None) -> ScamForcing:
    """ScamForcing from numpy arrays keyed dtdt_ls, dqdt_ls, omega."""
    dev = resolve_device(device)
    return ScamForcing(**{f: _tensor(fields[f], dtype, dev)
                          for f in FORCING_FIELDS})


def scamforcing_to_numpy(forcing) -> dict:
    """{field: array} of a ScamForcing of either package."""
    return {f: _np(getattr(forcing, f)) for f in FORCING_FIELDS}
