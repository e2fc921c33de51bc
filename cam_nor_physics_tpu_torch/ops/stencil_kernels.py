"""Per-level transport stencils of the FV dycore: CUDA kernels and their
plain PyTorch versions.

Twin of `cam_nor_physics_tpu.ops.pallas_kernels`. Each function dispatches
on the device of its tensors: CUDA tensors launch the hand-written Hopper
kernel (csrc/stencil_kernels.cu), CPU tensors take the plain version
(`*_ref`), which is the same tp_core math on whole (..., jm, im) tensors.
There is no fallback between the two: a kernel that does not build or
launch raises. Each wrapper adds its CUDA launches a call,
`LAUNCHES_PER_CALL[name]`, to `<wrapper>.launches`; each launch is a row
kernel over (row, level) blocks: transport3d four (the inner operators,
the mass fluxes, ddp and pt's fluxes, the caps and divergence),
vort_flux3d one (the fluxes), tracer_div3d three (the inner operators,
the fluxes, the caps and divergence).

Kernel orders: iord/jord in KERNEL_ORDERS, the orders FVConfig documents
(1 upwind, 2 van Leer, 3 PPM, 4 PPM with the improved monotonicity
constraint, 5 positive definite, 6 Yeh steepening, 7 Huynh, -2 van Leer
with the unlimited slope), on both devices; any other order raises. The
order is a runtime argument of the row kernels (csrc/tp_core.cuh), one
instantiation for every order.
"""

from __future__ import annotations

import torch

from . import cost, cuda_build
from . import tp_core as tp

KERNEL_ORDERS = (1, 2, 3, 4, 5, 6, 7, -2)

# CUDA launches a call of each wrapper (csrc/stencil_kernels.cu)
LAUNCHES_PER_CALL = {"transport3d": 4, "vort_flux3d": 1, "tracer_div3d": 3}


def transport3d_ref(delp, pt, crx, cry, yfx, va, ffsl, cosp, acosp,
                    rcap: float, iord: int, jord: int,
                    band: int | None = None):
    """Plain version of `transport3d`."""
    ddp, mfx, mfy = tp.tp2c(va, delp, crx, cry, iord, jord, crx, yfx, cosp,
                            acosp, rcap, ffsl, band=band)
    fx_pt, fy_pt = tp.tp2d(va, pt, crx, cry, iord, jord, mfx, mfy, cosp,
                           ffsl, 1, band=band)
    return ddp, tp.flux_divergence(fx_pt, fy_pt, acosp, rcap), mfx, mfy


def vort_flux3d_ref(zeta, crx, cry, udt, vedt, ffsl, cosp, iord: int,
                    jord: int, band: int | None = None):
    """Plain version of `vort_flux3d`."""
    fy = tp.ytp(zeta, cry, vedt, jord, 0)
    fx = tp.xtp(zeta, crx, udt, cosp, ffsl, iord, 1, band=band)
    return fx, fy


def tracer_div3d_ref(q, crx, cry, mfx, mfy, va, ffsl, cosp, acosp,
                     rcap: float, iord: int, jord: int,
                     band: int | None = None):
    """Plain version of `tracer_div3d` (the level fields broadcast over the
    tracer axis)."""
    fx, fy = tp.tp2d(va, q, crx, cry, iord, jord, mfx, mfy, cosp, ffsl, 1,
                     band=band)
    return tp.flux_divergence(fx, fy, acosp, rcap)


def check_orders(name, iord, jord):
    """Raise ValueError unless iord and jord are in KERNEL_ORDERS."""
    if iord not in KERNEL_ORDERS or jord not in KERNEL_ORDERS:
        raise ValueError(f"{name}: iord/jord must be in {KERNEL_ORDERS}, "
                         f"got iord={iord} jord={jord}")


def _check(name, slabs, shape, ffsl, rows, iord, jord, winds=False):
    """Validate what a kernel takes: one device, float32 or float64,
    contiguous, the given shapes (with `winds`, the first slab has `shape`
    and the others its trailing (km, jm, im)); raise on anything else. The
    wrappers check CPU tensors too, so the CPU runs hold the main path to
    the kernels' contract."""
    check_orders(name, iord, jord)
    dev, dtype = slabs[0][1].device, slabs[0][1].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 expected, got {dtype}")
    shapes = [shape] + [shape[-3:] if winds else shape] * (len(slabs) - 1)
    for arg, t, shp in [(a, t, s) for (a, t), s in zip(slabs, shapes)] + \
            [("ffsl", ffsl, shape[-3:-1])] + [(a, t, shape[-2:-1])
                                              for a, t in rows]:
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        want = torch.bool if arg == "ffsl" else dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {want}")
        if tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shp)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@cost.counted("transport3d")
def transport3d(delp, pt, crx, cry, yfx, va, ffsl, cosp, acosp,
                rcap: float, iord: int, jord: int, band: int | None = None):
    """Mass-flux (tp2c) + mass-consistent scalar (tp2d) transport of the
    cd_core C and D steps. Shapes (km, jm, im); cosp/acosp (jm,); ffsl
    (km, jm) bool; `band` the FFSL polar rows (tp_core.ffsl_band). Returns
    (ddp, dpt, mfx, mfy): thickness and pt-mass increments (polar caps
    closed) and the mass fluxes."""
    _check("transport3d", [("delp", delp), ("pt", pt), ("crx", crx),
                           ("cry", cry), ("yfx", yfx), ("va", va)],
           delp.shape, ffsl, [("cosp", cosp), ("acosp", acosp)], iord, jord)
    if not delp.is_cuda:
        return transport3d_ref(delp, pt, crx, cry, yfx, va, ffsl, cosp,
                               acosp, rcap, iord, jord, band)
    lib = cuda_build.library("stencil_kernels")
    fn = getattr(lib, f"cam_transport3d_{_suffix(delp.dtype)}")
    out = _run_transport(fn, _stream(delp), delp, pt, crx, cry, yfx, va,
                         ffsl, cosp, acosp, rcap, iord, jord, band)
    transport3d.launches += LAUNCHES_PER_CALL["transport3d"]
    return out


@cost.counted("vort_flux3d")
def vort_flux3d(zeta, crx, cry, udt, vedt, ffsl, cosp, iord: int, jord: int,
                band: int | None = None):
    """Upwind-PPM fluxes of absolute vorticity for the vector-invariant
    wind update: fy = ytp(ζ)·v̄dt at u points, fx = xtp(ζ)·ūdt at v
    points. Shapes (km, jm, im). Returns (fx, fy)."""
    _check("vort_flux3d", [("zeta", zeta), ("crx", crx), ("cry", cry),
                           ("udt", udt), ("vedt", vedt)],
           zeta.shape, ffsl, [("cosp", cosp)], iord, jord)
    if not zeta.is_cuda:
        return vort_flux3d_ref(zeta, crx, cry, udt, vedt, ffsl, cosp, iord,
                               jord, band)
    lib = cuda_build.library("stencil_kernels")
    out = _run_vort(getattr(lib, f"cam_vort_flux3d_{_suffix(zeta.dtype)}"),
                    _stream(zeta), zeta, crx, cry, udt, vedt, ffsl, cosp,
                    iord, jord, band)
    vort_flux3d.launches += LAUNCHES_PER_CALL["vort_flux3d"]
    return out


@cost.counted("tracer_div3d")
def tracer_div3d(q, crx, cry, mfx, mfy, va, ffsl, cosp, acosp, rcap: float,
                 iord: int, jord: int, band: int | None = None):
    """Flux divergence of tracer mass for trac2d: q (nq, km, jm, im) mixing
    ratios, winds/fluxes (km, jm, im) shared across tracers. Returns dqm
    (nq, km, jm, im) with polar caps closed."""
    _check("tracer_div3d", [("q", q), ("crx", crx), ("cry", cry),
                            ("mfx", mfx), ("mfy", mfy), ("va", va)],
           q.shape, ffsl, [("cosp", cosp), ("acosp", acosp)], iord, jord,
           winds=True)
    if not q.is_cuda:
        return tracer_div3d_ref(q, crx, cry, mfx, mfy, va, ffsl, cosp, acosp,
                                rcap, iord, jord, band)
    lib = cuda_build.library("stencil_kernels")
    dqm = _run_tracer(getattr(lib, f"cam_tracer_div3d_{_suffix(q.dtype)}"),
                      _stream(q), q, crx, cry, mfx, mfy, va, ffsl, cosp,
                      acosp, rcap, iord, jord, band)
    tracer_div3d.launches += LAUNCHES_PER_CALL["tracer_div3d"]
    return dqm


def _run_transport(fn, stream, delp, pt, crx, cry, yfx, va, ffsl, cosp,
                   acosp, rcap, iord, jord, band):
    """transport3d's launch: allocate the outputs and the scratch (4 slabs
    a level) and call `fn`, the C entry in csrc/stencil_kernels.cu, on
    `stream` (the CPU test of the source calls it with a host build of
    it). Returns (ddp, dpt, mfx, mfy)."""
    km, jm, im = delp.shape
    ddp, dpt, mfx, mfy = (torch.empty_like(delp) for _ in range(4))
    scratch = torch.empty((4,) + tuple(delp.shape), dtype=delp.dtype,
                          device=delp.device)
    rc = fn(delp.data_ptr(), pt.data_ptr(), crx.data_ptr(), cry.data_ptr(),
            yfx.data_ptr(), va.data_ptr(), ffsl.data_ptr(), cosp.data_ptr(),
            acosp.data_ptr(), float(rcap), iord, jord,
            -1 if band is None else band, tp.max_cfl_int(im), km, jm, im,
            ddp.data_ptr(), dpt.data_ptr(), mfx.data_ptr(), mfy.data_ptr(),
            scratch.data_ptr(), stream)
    _raise_on(rc, "transport3d")
    return ddp, dpt, mfx, mfy


def _run_vort(fn, stream, zeta, crx, cry, udt, vedt, ffsl, cosp, iord, jord,
              band):
    """vort_flux3d's launch: allocate fx and fy and call `fn`, the C entry
    in csrc/stencil_kernels.cu, on `stream`. Returns (fx, fy)."""
    km, jm, im = zeta.shape
    fx, fy = torch.empty_like(zeta), torch.empty_like(zeta)
    rc = fn(zeta.data_ptr(), crx.data_ptr(), cry.data_ptr(), udt.data_ptr(),
            vedt.data_ptr(), ffsl.data_ptr(), cosp.data_ptr(), iord, jord,
            -1 if band is None else band, tp.max_cfl_int(im), km, jm, im,
            fx.data_ptr(), fy.data_ptr(), stream)
    _raise_on(rc, "vort_flux3d")
    return fx, fy


def _run_tracer(fn, stream, q, crx, cry, mfx, mfy, va, ffsl, cosp, acosp,
                rcap, iord, jord, band):
    """tracer_div3d's launch: allocate dqm and the scratch (4 slabs a
    tracer and level) and call `fn`, the C entry in
    csrc/stencil_kernels.cu, on `stream` (the CPU test of the source calls
    it with a host build of it)."""
    nq, km, jm, im = q.shape
    dqm = torch.empty_like(q)
    scratch = torch.empty((4,) + tuple(q.shape), dtype=q.dtype,
                          device=q.device)
    rc = fn(q.data_ptr(), crx.data_ptr(), cry.data_ptr(), mfx.data_ptr(),
            mfy.data_ptr(), va.data_ptr(), ffsl.data_ptr(), cosp.data_ptr(),
            acosp.data_ptr(), float(rcap), iord, jord,
            -1 if band is None else band, tp.max_cfl_int(im), nq, km, jm, im,
            dqm.data_ptr(), scratch.data_ptr(), stream)
    _raise_on(rc, "tracer_div3d")
    return dqm


transport3d.launches = 0
vort_flux3d.launches = 0
tracer_div3d.launches = 0
