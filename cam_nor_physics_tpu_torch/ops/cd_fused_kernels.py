"""The fused small step's four kernels K1-K4: CUDA launches and dispatch.

Twin of the `pallas_call`s of `cam_nor_physics_tpu.models.fv.cd_pallas`.
`k1`...`k4` dispatch on the device of their tensors: CUDA tensors launch
the hand-written Hopper kernels of csrc/cd_fused_kernels.cu, CPU tensors
take the plain versions `k1_ref`...`k4_ref` of models/fv/cd_fused.py.
There is no fallback between the two: a kernel that does not build or
launch raises. `_check` validates the inputs on either device.

Each call adds its CUDA launches, `launches_per_call(name, dyn_filter)`,
to `<wrapper>.launches`: K1 a row kernel for the C-grid winds and
Courants, K3's four transport row kernels at order 1 and the downward
pressure pass; K2 the upward geopotential pass and a row kernel, with
the polar filter on also its two DFT products and a row kernel for the
Courants; K3 four row kernels and the downward pass; K4 the upward pass,
three row kernels and, with the polar filter on, its two DFT products.
K3's transport and K4's vorticity fluxes take iord/jord in
stencil_kernels.KERNEL_ORDERS; any other order raises.
"""

from __future__ import annotations

import math

import torch

from ..models.fv.cd_fused import (KE_METHODS, METRIC_ROWS, k1_ref, k2_ref,
                                  k3_ref, k4_ref)
from ..utils import constants as c
from . import cost, cuda_build
from . import tp_core as tp
from .stencil_kernels import check_orders

# CUDA launches a call of each K, (polar filter off, on): K2 and K4 add
# the two DFT products of csrc/dft_filter.cuh when they filter, K2 also
# the Courants' row kernel
LAUNCHES_PER_CALL = {"k1": (6, 6), "k2": (2, 5), "k3": (5, 5), "k4": (4, 6)}

# scratch slabs of each K (csrc/cd_fused_kernels.cu)
_SCRATCH = {"k1": 14, "k2": 4, "k3": 9, "k4": 12}


def launches_per_call(name: str, dyn_filter: bool = True) -> int:
    """The CUDA launches one call of K `name` makes."""
    return LAUNCHES_PER_CALL[name][bool(dyn_filter)]


def _check(name, slabs, others=(), iord=1, jord=1, ke_method="centered"):
    """Validate what a kernel takes: one device, float32 or float64,
    contiguous; `slabs` (km, jm, im) with im even, `others` (arg, tensor,
    kind) with kind "plane" (jm, im), "metrics" (len(METRIC_ROWS), jm),
    "levels" (km, jm), "fwd" (im, nf), "inv" (nf, im) or "resp" (jm, nf),
    nf = im//2+1; the transport orders in stencil_kernels.KERNEL_ORDERS;
    a known KE form. Raises on anything else, for CPU tensors too."""
    check_orders(name, iord, jord)
    if ke_method not in KE_METHODS:
        raise ValueError(f"{name}: ke_method must be one of {KE_METHODS}, "
                         f"got {ke_method!r}")
    ref = slabs[0][1]
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 expected, got "
                        f"{ref.dtype}")
    if ref.dim() != 3 or ref.shape[-1] % 2 or ref.shape[-2] < 3:
        raise ValueError(f"{name}: (km, jm, im) slabs with im even and "
                         f"jm >= 3 expected, got {tuple(ref.shape)}")
    km, jm, im = ref.shape
    nf = im // 2 + 1
    shapes = {"slab": (km, jm, im), "plane": (jm, im),
              "metrics": (len(METRIC_ROWS), jm), "levels": (km, jm),
              "fwd": (im, nf), "inv": (nf, im), "resp": (jm, nf)}
    for arg, t, kind in [(a, t, "slab") for a, t in slabs] + list(others):
        if t.device != ref.device:
            raise ValueError(f"{name}: {arg} on {t.device}, expected "
                             f"{ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected "
                            f"{ref.dtype}")
        if tuple(t.shape) != shapes[kind]:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shapes[kind]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _dft_args(dft):
    return [(n, t, k) for n, t, k in zip(
        ("fc", "fs", "gc", "gs", "resp_center", "resp_edge"), dft,
        ("fwd", "fwd", "inv", "inv", "resp", "resp"))]


def _fn(stem, dtype):
    lib = cuda_build.library("cd_fused_kernels")
    return getattr(lib, f"{stem}_{'f32' if dtype == torch.float32 else 'f64'}")


def _launch(name, fn, *args):
    rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args])
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def _scratch(name, ref, spec=False):
    """A K's scratch slabs, per-level row flags and, with `spec`, the DFT
    spectra: sr, si of two fields over all km·jm level rows, each row nf
    rounded up to whole 16-byte copies (dftf::spectrum_stride)."""
    km, jm, im = ref.shape
    out = [torch.empty((_SCRATCH[name], km, jm, im), dtype=ref.dtype,
                       device=ref.device),
           torch.empty((km, jm), dtype=torch.uint8, device=ref.device)]
    if spec:
        lds = (im // 2 + 1 + 3) // 4 * 4
        out.append(torch.empty((4, km * jm, lds), dtype=ref.dtype,
                               device=ref.device))
    return out


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _carry_start(ptop: float):
    """ptop, ptop^κ and ln ptop in float64: the pressure carry's start."""
    return float(ptop), float(ptop) ** c.CAPPA, math.log(ptop)


def _band(band):
    return -1 if band is None else band


@cost.counted("k1")
def k1(u, v, pt, delp, metrics, dt5: float, rcap: float, ptop: float,
       band: int | None):
    """K1, the c_sw half step and the downward pressure pass: (km, jm, im)
    winds, pt and delp, the metric rows; returns (pt_h, uc0, vc0, pkz_h,
    dgz_h)."""
    _check("k1", [("u", u), ("v", v), ("pt", pt), ("delp", delp)],
           [("metrics", metrics, "metrics")])
    if not delp.is_cuda:
        return k1_ref(u, v, pt, delp, metrics, dt5, rcap, ptop, band)
    out = _run_k1(_fn("cam_cd_k1", delp.dtype), _stream(delp), u, v, pt,
                  delp, metrics, dt5, rcap, ptop, band)
    k1.launches += launches_per_call("k1")
    return out


@cost.counted("k2")
def k2(pt_h, pkz_h, dgz_h, uc0, vc0, phis, metrics, dft, dt: float,
       dt5: float, dyn_filter: bool):
    """K2, the upward geopotential pass, the C-grid PGF and Coriolis kick,
    the polar filter and the D-grid Courants; `dft` = (fc, fs, gc, gs,
    resp_center, resp_edge). Returns (uc, crx, cry)."""
    _check("k2", [("pt_h", pt_h), ("pkz_h", pkz_h), ("dgz_h", dgz_h),
                  ("uc0", uc0), ("vc0", vc0)],
           [("phis", phis, "plane"), ("metrics", metrics, "metrics")] +
           _dft_args(dft))
    if not pt_h.is_cuda:
        return k2_ref(pt_h, pkz_h, dgz_h, uc0, vc0, phis, metrics, dft, dt,
                      dt5, dyn_filter)
    out = _run_k2(_fn("cam_cd_k2", pt_h.dtype), _stream(pt_h), pt_h, pkz_h,
                  dgz_h, uc0, vc0, phis, metrics, dft, dt, dt5, dyn_filter)
    k2.launches += launches_per_call("k2", dyn_filter)
    return out


@cost.counted("k3")
def k3(delp, pt, crx, cry, metrics, iord: int, jord: int, rcap: float,
       ptop: float, band: int | None):
    """K3, the D-grid transport, the floors and the downward pressure
    pass. Returns (delp', pt', mfx, mfy, pkz, dgz)."""
    _check("k3", [("delp", delp), ("pt", pt), ("crx", crx), ("cry", cry)],
           [("metrics", metrics, "metrics")], iord, jord)
    if not delp.is_cuda:
        return k3_ref(delp, pt, crx, cry, metrics, iord, jord, rcap, ptop,
                      band)
    out = _run_k3(_fn("cam_cd_k3", delp.dtype), _stream(delp), delp, pt,
                  crx, cry, metrics, iord, jord, rcap, ptop, band)
    k3.launches += launches_per_call("k3")
    return out


@cost.counted("k4")
def k4(u, v, pt_new, pkz, dgz, phis, crx, cry, uc, metrics, nu2_rows, dft,
       dt: float, dl: float, dp: float, iord: int, jord: int,
       ke_method: str, div2_on: bool, nu4: float, del2_velocity: float,
       dyn_filter: bool, rcirc: float, band: int | None):
    """K4, the upward pass to phi_m and the vector-invariant wind update
    with divergence and velocity damping and the polar filter; `nu2_rows`
    (km, jm) the per-level del2 coefficient. Returns (u', v')."""
    _check("k4", [("u", u), ("v", v), ("pt_new", pt_new), ("pkz", pkz),
                  ("dgz", dgz), ("crx", crx), ("cry", cry), ("uc", uc)],
           [("phis", phis, "plane"), ("metrics", metrics, "metrics"),
            ("nu2_rows", nu2_rows, "levels")] + _dft_args(dft),
           iord, jord, ke_method)
    args = (u, v, pt_new, pkz, dgz, phis, crx, cry, uc, metrics, nu2_rows,
            dft, dt, dl, dp, iord, jord, ke_method, div2_on, nu4,
            del2_velocity, dyn_filter, rcirc, band)
    if not u.is_cuda:
        return k4_ref(*args)
    out = _run_k4(_fn("cam_cd_k4", u.dtype), _stream(u), *args)
    k4.launches += launches_per_call("k4", dyn_filter)
    return out


# The launches: allocate a K's outputs and scratch and call `fn`, its C
# entry in csrc/cd_fused_kernels.cu, on `stream` (the CPU test of the
# source calls them with a host build of it).

def _run_k1(fn, stream, u, v, pt, delp, metrics, dt5, rcap, ptop, band):
    km, jm, im = delp.shape
    outs = [torch.empty_like(delp) for _ in range(5)]
    scratch, flags = _scratch("k1", delp)
    _launch("k1", fn, u, v, pt, delp, metrics, float(dt5), float(rcap),
            *_carry_start(ptop), c.CAPPA, c.CPAIR, _band(band),
            tp.max_cfl_int(im), km, jm, im, *outs, scratch, flags, stream)
    return tuple(outs)


def _run_k2(fn, stream, pt_h, pkz_h, dgz_h, uc0, vc0, phis, metrics, dft,
            dt, dt5, dyn_filter):
    km, jm, im = pt_h.shape
    outs = [torch.empty_like(pt_h) for _ in range(3)]
    scratch, _, spec = _scratch("k2", pt_h, spec=True)
    _launch("k2", fn, pt_h, pkz_h, dgz_h, uc0, vc0, phis, metrics, *dft,
            float(dt), float(dt5), c.CPAIR, int(bool(dyn_filter)), km, jm,
            im, *outs, scratch, spec, stream)
    return tuple(outs)


def _run_k3(fn, stream, delp, pt, crx, cry, metrics, iord, jord, rcap, ptop,
            band):
    km, jm, im = delp.shape
    outs = [torch.empty_like(delp) for _ in range(6)]
    scratch, flags = _scratch("k3", delp)
    _launch("k3", fn, delp, pt, crx, cry, metrics, float(rcap),
            *_carry_start(ptop), c.CAPPA, c.CPAIR, iord, jord, _band(band),
            tp.max_cfl_int(im), km, jm, im, *outs, scratch, flags, stream)
    return tuple(outs)


def _run_k4(fn, stream, u, v, pt_new, pkz, dgz, phis, crx, cry, uc, metrics,
            nu2_rows, dft, dt, dl, dp, iord, jord, ke_method, div2_on, nu4,
            del2_velocity, dyn_filter, rcirc, band):
    km, jm, im = u.shape
    outs = [torch.empty_like(u) for _ in range(2)]
    scratch, flags, spec = _scratch("k4", u, spec=True)
    # dt·ν as the plain version's Python product
    dtdel2 = dt * del2_velocity if del2_velocity > 0.0 else 0.0
    _launch("k4", fn, u, v, pt_new, pkz, dgz, phis, crx, cry, uc, metrics,
            nu2_rows, *dft, float(dt), float(dtdel2), float(rcirc), c.CPAIR,
            c.REARTH, float(dl), float(dp), iord, jord,
            KE_METHODS.index(ke_method), int(bool(div2_on)), int(nu4 > 0.0),
            int(bool(dyn_filter)), _band(band), tp.max_cfl_int(im), km, jm,
            im, *outs, scratch, spec, flags, stream)
    return tuple(outs)


k1.launches = 0
k2.launches = 0
k3.launches = 0
k4.launches = 0
