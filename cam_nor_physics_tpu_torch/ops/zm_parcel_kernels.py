"""ZM's dilute parcel and its CAPE/CIN: the CUDA kernel and the route to
it.

`zm_parcel` takes buoyan_dilute's arguments and returns its BuoyanOut.
Where `takes` holds (tensors on the card, the batched parcel with the
solver "newton" or "newton_exact", either parcel_pbl, at most MAX_LEVELS
levels, float32 or float64) it launches csrc/zm_parcel_kernels.cu once a
call: a block a tile of neighbouring columns staged through shared
memory, the inversions one thread per (column, level), the recursions
one thread per column. Everything else (CPU tensors, the
reference-shaped scan parcel, the Brent solver, deeper columns) takes
`zm_parcel_ref`, the port's buoyan_dilute. A launch that fails raises.
`zm_parcel.launches` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from ..models.physics.zm_conv import BuoyanOut, buoyan_dilute
from ..utils.config import ZMConfig
from . import cost, cuda_build

# kMaxK in csrc/zm_parcel_kernels.cu: its launch refuses more
MAX_LEVELS = 64
SOLVERS = ("newton", "newton_exact")
DEVICE_TYPE = "cuda"       # the device whose tensors launch the kernel

zm_parcel_ref = buoyan_dilute
"""Plain version of `zm_parcel`: the port's buoyan_dilute."""


def takes(cfg: ZMConfig, t) -> bool:
    """Whether `zm_parcel` launches the kernel: tensors on DEVICE_TYPE of
    at most MAX_LEVELS levels, float32 or float64, under the batched
    parcel with a fixed-count solver."""
    return (t.device.type == DEVICE_TYPE and cfg.parcel_impl == "batched"
            and cfg.inversion_solver in SOLVERS
            and t.shape[1] <= MAX_LEVELS
            and t.dtype in (torch.float32, torch.float64))


def _check(mids, ifaces, cols, dmpdz):
    """Validate what the kernel takes: one device and dtype, contiguous
    (ncol, pver) profiles (q may be a level slice of the tracer array),
    (ncol, pver + 1) interface fields and (ncol,) column values; dmpdz of
    shape (ncol, pver) with any non-negative strides (the second call's
    is a column value expanded)."""
    ref = mids[0][1]
    ncol, pver = ref.shape
    named = [(n, a, (ncol, pver)) for n, a in mids] + \
        [(n, a, (ncol, pver + 1)) for n, a in ifaces] + \
        [(n, a, (ncol,)) for n, a in cols] + [("dmpdz", dmpdz, (ncol, pver))]
    for name, a, shape in named:
        if a.device != ref.device or a.dtype != ref.dtype:
            raise TypeError(f"zm_parcel: {name} is {a.dtype} on {a.device}, "
                            f"expected {ref.dtype} on {ref.device}")
        if tuple(a.shape) != shape:
            raise ValueError(f"zm_parcel: {name} must be {shape}, got "
                             f"{tuple(a.shape)}")
        if name in ("q", "dmpdz"):
            if min(a.stride()) < 0:
                raise ValueError(f"zm_parcel: {name} has a negative stride")
        elif not a.is_contiguous():
            raise ValueError(f"zm_parcel: {name} must be contiguous")


@cost.counted("zm_parcel")
def zm_parcel(cfg: ZMConfig, msg: int, q, t, p, z, pf, zi_, zs, pblt,
              tpert, landfrac, dmpdz) -> BuoyanOut:
    """buoyan_dilute (dilute CAPE/CIN and the parcel's profiles), on the
    card in one kernel launch where `takes`."""
    if not takes(cfg, t):
        return zm_parcel_ref(cfg, msg, q, t, p, z, pf, zi_, zs, pblt, tpert,
                             landfrac, dmpdz)
    out = _launch(cfg, msg, q, t, p, z, pf, zi_, zs, pblt, tpert, dmpdz)
    zm_parcel.launches += 1
    return out


def _launch(cfg, msg, q, t, p, z, pf, zi_, zs, pblt, tpert, dmpdz):
    """The kernel on PyTorch's current stream."""
    lib = cuda_build.library("zm_parcel_kernels")
    suf = "f32" if t.dtype == torch.float32 else "f64"
    return _run(getattr(lib, f"cam_zm_parcel_{suf}"),
                torch.cuda.current_stream(t.device).cuda_stream, cfg, msg, q,
                t, p, z, pf, zi_, zs, pblt, tpert, dmpdz)


def _run(fn, stream, cfg, msg, q, t, p, z, pf, zi_, zs, pblt, tpert, dmpdz):
    """zm_parcel's launch: check the arguments, allocate the outputs, call
    `fn`, the C entry in csrc/zm_parcel_kernels.cu, on `stream` (the CPU
    test of the source calls it with a host build of it), and unpack a
    BuoyanOut."""
    _check([("t", t), ("q", q), ("p", p), ("z", z)],
           [("pf", pf), ("zi_", zi_)],
           [("zs", zs), ("pblt", pblt), ("tpert", tpert)], dmpdz)
    ncol, pver = t.shape
    prof = torch.empty((3, ncol, pver), dtype=t.dtype, device=t.device)
    colv = torch.empty((4, ncol), dtype=t.dtype, device=t.device)
    idx = torch.empty((3, ncol), dtype=torch.int64, device=t.device)
    rc = fn(*[a.data_ptr() for a in (q, t, p, z, pf, zi_, zs, pblt, tpert,
                                     dmpdz)],
            q.stride(0), q.stride(1), dmpdz.stride(0), dmpdz.stride(1), ncol,
            pver, int(msg), int(cfg.num_cin), int(cfg.parcel_pbl),
            int(cfg.inversion_solver == "newton_exact"),
            int(cfg.precip_sweeps), float(cfg.plclmin),
            float(cfg.tiedke_add), float(cfg.parcel_hscale),
            prof.data_ptr(), colv.data_ptr(), idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"zm_parcel: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    tp, qstp, buoy = prof.unbind(0)
    tl, cape, cin, pl = colv.unbind(0)
    lcl, lel, mx = idx.unbind(0)
    return BuoyanOut(tp=tp, qstp=qstp, tl=tl, cape=cape, cin=cin, lcl=lcl,
                     lel=lel, mx=mx, buoy=buoy, pl=pl)


zm_parcel.launches = 0
