"""Single-column model mode (SCAM).

PyTorch twin of `cam_nor_physics_tpu.models.scam`. The reference treats
single-column mode as the physics' test harness: `single_column` bypasses
the dycore (physpkg.F90:28, 1167, 1221-1228) and prescribed large-scale
forcing (IOP soundings) drives the physics. `scam_run` steps tphysbc and
tphysac on 1..N independent columns with fixed forcing applied before the
physics; `scam_run_iop` interpolates an IOP file's forcing and surface
fluxes in time. The IOP's times stay on the host as numpy, so picking a
record reads nothing from the device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..utils.config import PhysConfig, ZMConfig
from ..utils.device import resolve_device
from .coupling.camsrfexch import CamIn
from .physics.constituents import ConstituentRegistry
from .physics.physics_buffer import PhysicsBuffer, pbuf_register
from .physics.physpkg import phys_run1, phys_run2, physpkg_pbuf_specs
from .physics.state import PhysicsState

FORCING_FIELDS = ("dtdt_ls", "dqdt_ls", "omega")
IOP_FIELDS = ("tsec", "divT", "divq", "omega", "shflx", "lhflx")


@dataclass
class ScamForcing:
    """Prescribed large-scale forcing of a step (the IOP role): the
    advective tendencies of T and q and the vertical velocity."""

    dtdt_ls: torch.Tensor       # (ncol, pver) K/s
    dqdt_ls: torch.Tensor       # (ncol, pver) kg/kg/s
    omega: torch.Tensor         # (ncol, pver) Pa/s

    @classmethod
    def zeros(cls, ncol: int, pver: int, dtype=torch.float64,
              device="cuda") -> "ScamForcing":
        z = torch.zeros((ncol, pver), dtype=dtype,
                        device=resolve_device(device))
        return cls(dtdt_ls=z, dqdt_ls=z, omega=z)

    def replace(self, **kw) -> "ScamForcing":
        return replace(self, **kw)


def scam_init_pbuf(ncol: int, pver: int, dtype=torch.float64,
                   pcnst: int = 1, device="cuda") -> PhysicsBuffer:
    """The physics buffer a SCAM run starts from: zeros, CLD 0.1 and
    PBLH 500 m."""
    dev = resolve_device(device)
    pbuf = pbuf_register(physpkg_pbuf_specs(ncol, pver, pcnst=pcnst), dtype,
                         dev)
    return pbuf.update(
        CLD=torch.full((ncol, pver), 0.1, dtype=dtype, device=dev),
        PBLH=torch.full((ncol,), 500.0, dtype=dtype, device=dev))


def scam_step(phys_cfg: PhysConfig, zm_cfg: ZMConfig,
              registry: ConstituentRegistry, state: PhysicsState,
              pbuf: PhysicsBuffer, cam_in: CamIn, forcing: ScamForcing,
              ztodt: float, nstep: int = 0):
    """One SCAM step: the large-scale forcing, then tphysbc and tphysac.
    Returns (state, pbuf, cam_out, diags)."""
    q = state.q.clone()
    q[:, :, 0] = state.q[:, :, 0] + ztodt * forcing.dqdt_ls
    state = state.replace(t=state.t + ztodt * forcing.dtdt_ls, q=q,
                          omega=forcing.omega)
    o1 = phys_run1(phys_cfg, zm_cfg, registry, state, pbuf, cam_in, ztodt,
                   nstep=nstep)
    o2 = phys_run2(phys_cfg, registry, o1.state, o1.pbuf, cam_in, ztodt)
    diags = dict(o1.diagnostics)
    diags.update(o2.diagnostics)
    return o2.state, o2.pbuf, o2.cam_out, diags


@dataclass
class IopData:
    """Time series of IOP large-scale forcing and surface fluxes (the
    BFB_CAM_SCAM_IOP file contract, physpkg.F90:1069, 1137-1141). tsec
    is a host numpy array; the others are tensors."""

    tsec: np.ndarray          # (ntime,) seconds
    divT: torch.Tensor        # (ntime, pver) K/s
    divq: torch.Tensor        # (ntime, pver) kg/kg/s
    omega: torch.Tensor       # (ntime, pver) Pa/s
    shflx: torch.Tensor       # (ntime,) W/m2
    lhflx: torch.Tensor       # (ntime,) W/m2


def load_iop_netcdf(path: str, dtype=torch.float64,
                    device="cuda") -> IopData:
    """Read a SCAM IOP forcing file (NetCDF-3 through scipy): dims (time,
    lev); variables tsec (or time), divT, divq, omega, and optionally
    shflx and lhflx (zeros if absent). Trailing unit lat/lon axes are
    squeezed."""
    from scipy.io import netcdf_file
    dev = resolve_device(device)
    with netcdf_file(path, "r", mmap=False) as nc:
        def get(name, default=None):
            if name not in nc.variables:
                return default
            a = np.array(nc.variables[name][:], np.float64)
            while a.ndim > 2 and a.shape[-1] == 1:
                a = a[..., 0]
            return a

        tsec = get("tsec")
        if tsec is None:
            tsec = get("time")
        divT, divq, omega = get("divT"), get("divq"), get("omega")
        ntime = tsec.shape[0]
        shflx = get("shflx", np.zeros((ntime,)))
        lhflx = get("lhflx", np.zeros((ntime,)))

    def dev_t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    host_dtype = torch.zeros((), dtype=dtype).numpy().dtype
    return IopData(tsec=tsec.astype(host_dtype), divT=dev_t(divT),
                   divq=dev_t(divq), omega=dev_t(omega),
                   shflx=dev_t(shflx.reshape(ntime)),
                   lhflx=dev_t(lhflx.reshape(ntime)))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def save_iop_netcdf(path: str, tsec, divT, divq, omega, shflx=None,
                    lhflx=None) -> None:
    """Write an IOP forcing file, the inverse of load_iop_netcdf. Tensors
    or arrays."""
    from scipy.io import netcdf_file
    ntime, pver = _host(divT).shape
    with netcdf_file(path, "w") as nc:
        nc.createDimension("time", ntime)
        nc.createDimension("lev", pver)

        def var(name, dims, data, units):
            vv = nc.createVariable(name, "d", dims)
            vv[:] = _host(data)
            vv.units = units

        var("tsec", ("time",), tsec, "s")
        var("divT", ("time", "lev"), divT, "K/s")
        var("divq", ("time", "lev"), divq, "kg/kg/s")
        var("omega", ("time", "lev"), omega, "Pa/s")
        if shflx is not None:
            var("shflx", ("time",), shflx, "W/m2")
        if lhflx is not None:
            var("lhflx", ("time",), lhflx, "W/m2")


def _onehot(n: int, k: int, like: torch.Tensor) -> torch.Tensor:
    """(n,) selector of record k in `like`'s dtype, made on its device."""
    return (torch.arange(n, device=like.device) == k).to(like.dtype)


def iop_forcing_at(iop: IopData, t, ncol: int) -> ScamForcing:
    """The IOP series linearly interpolated to model time t (clamped to
    the record) and broadcast to ncol columns. The record and the weight
    come from the host's tsec, in its dtype; the fields are picked on the
    device with JAX's one-hot contraction."""
    times = iop.tsec
    n = times.shape[0]
    t = times.dtype.type(t)
    k = int(np.clip(np.sum(times <= t) - 1, 0, n - 2))
    t_lo, t_hi = times[k], times[k + 1]
    w = np.clip((t - t_lo) / (times.dtype.type(1.0) if t_hi == t_lo
                              else t_hi - t_lo), 0.0, 1.0).astype(times.dtype)
    lo, hi = _onehot(n, k, iop.divT), _onehot(n, k + 1, iop.divT)

    def interp(a):
        sel = lo.reshape((n,) + (1,) * (a.ndim - 1))
        sel_hi = hi.reshape((n,) + (1,) * (a.ndim - 1))
        a_lo = torch.sum(sel * a, 0)
        v = a_lo + float(w) * (torch.sum(sel_hi * a, 0) - a_lo)
        return v[None].expand((ncol,) + v.shape).contiguous()

    return ScamForcing(dtdt_ls=interp(iop.divT), dqdt_ls=interp(iop.divq),
                       omega=interp(iop.omega))


def scam_run_iop(phys_cfg: PhysConfig, zm_cfg: ZMConfig,
                 registry: ConstituentRegistry, state: PhysicsState,
                 cam_in: CamIn, iop: IopData, ztodt: float, nsteps: int):
    """Single-column physics driven by an IOP file: each step
    interpolates the forcing to model time and folds the IOP's surface
    fluxes into cam_in (scam_use_iop_srf). Step i runs with nstep=i.
    Returns (state, pbuf, {"precc", "tbot"} series (nsteps, ncol))."""
    ncol = state.ncol
    pbuf = scam_init_pbuf(ncol, state.pver, state.t.dtype,
                          device=state.t.device)
    ntime = iop.tsec.shape[0]
    precc, tbot = [], []
    for i in range(nsteps):
        t_mod = i * ztodt
        forcing = iop_forcing_at(iop, t_mod, ncol)
        k = int(np.clip(np.sum(iop.tsec <= t_mod) - 1, 0, ntime - 1))
        sel = _onehot(ntime, k, state.t)
        ci = cam_in.replace(
            shf=torch.sum(sel * iop.shflx).expand(ncol).clone(),
            lhf=torch.sum(sel * iop.lhflx).expand(ncol).clone())
        state, pbuf, cam_out, _ = scam_step(phys_cfg, zm_cfg, registry,
                                            state, pbuf, ci, forcing, ztodt,
                                            nstep=i)
        precc.append(cam_out.precc)
        tbot.append(state.t[:, -1])
    return state, pbuf, dict(precc=torch.stack(precc), tbot=torch.stack(tbot))


def scam_run(phys_cfg: PhysConfig, zm_cfg: ZMConfig,
             registry: ConstituentRegistry, state: PhysicsState,
             cam_in: CamIn, forcing: ScamForcing, ztodt: float,
             nsteps: int):
    """nsteps of single-column physics with fixed forcing: the first step
    with nstep=0 (no energy fixer: no TEOUT yet), the others with
    nstep=1. As in the JAX package's scan, the series hold the steps
    after the first (the first's alone when nsteps is 1)."""
    pbuf = scam_init_pbuf(state.ncol, state.pver, state.t.dtype,
                          device=state.t.device)
    state, pbuf, cam_out, _ = scam_step(phys_cfg, zm_cfg, registry, state,
                                        pbuf, cam_in, forcing, ztodt,
                                        nstep=0)
    if nsteps == 1:
        return state, pbuf, dict(precc=cam_out.precc[None],
                                 tbot=state.t[None, :, -1])
    precc, tbot = [], []
    for _ in range(nsteps - 1):
        state, pbuf, cam_out, _ = scam_step(phys_cfg, zm_cfg, registry,
                                            state, pbuf, cam_in, forcing,
                                            ztodt, nstep=1)
        precc.append(cam_out.precc)
        tbot.append(state.t[:, -1])
    return state, pbuf, dict(precc=torch.stack(precc), tbot=torch.stack(tbot))
