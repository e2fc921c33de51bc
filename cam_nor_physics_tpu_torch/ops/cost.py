"""The work of the port's steps: bytes moved and operations done.

One source for two readers: chip_smoke.py holds each kernel's time
against its bound (`kernel_work`, `bound`), and the bench's roofline
(BENCH_ROOFLINE=1, `bench.roofline_line`) divides a whole step's count by
its time. The count is the work the step needs, whatever implements it,
so a step counts the same on the CPU (the kernels' plain versions) and
on the card (the CUDA kernels).

- A kernel wrapper (`counted`) adds its own work: each tensor argument
  read once, each output written once, and the operations of its
  formulas from the per-point counts below, with this call's
  data-dependent FFSL sums. What runs inside the wrapper (the plain
  version's PyTorch ops on the CPU; the allocations and the ctypes call
  on the card, which no dispatch mode sees) is not counted.
- The PyTorch glue between kernels is counted op by op under `WorkCount`,
  a TorchDispatchMode, with XLA's cost model's meaning: bytes are each
  aten op's tensor inputs once and its outputs once; views, allocations
  and metadata ops count nothing; operations are one per output element
  of an elementwise op, one per input element of a reduction or scan,
  2mnk of a matrix product and 5 n log2 n per FFT transform of length n.
  Other ops (copies, gathers, concatenations, rolls) move bytes and do
  no operations.

`count_work` runs one eager call: a CUDA graph's replay hides its
operations from the dispatch mode.
"""

from __future__ import annotations

import functools
import inspect
import math

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode)
from torch.utils._pytree import tree_flatten

from . import tp_core as tp

# the card the peaks are for (torch.cuda.get_device_name), its HBM rate
# and its float32 rate outside the tensor cores: NVIDIA's data sheet for
# the SXM part at its full limit, "NVIDIA H100 80GB HBM3, 700.00 W" as
# nvidia-smi names it
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}
HBM_BYTES_PER_S, PEAK_F32_OPS = PEAKS["NVIDIA H100 80GB HBM3"]

# estimated operations per grid point of the stencil formulas (tp_core.cuh):
# an x-flux (xtp) and a y-flux (ytp) at each order (van Leer's 4th-order
# slope at 2 and -2; PPM's edges and constraint from 3 up, lmt 0 and 2
# dearer than 1 and 3, Yeh's steepening two more slopes' worth at 6,
# Huynh's bounds at 7), the inner advective operators and a flux
# divergence
OPS_X = {1: 3, 2: 25, -2: 22, 3: 80, 4: 70, 5: 85, 6: 120, 7: 95}
OPS_Y = {1: 2, 2: 30, -2: 25, 3: 90, 4: 80, 5: 95, 6: 85, 7: 85}
OPS_ADX, OPS_ADY, OPS_DIV = 2 * OPS_X[1] + 6, 5, 5
# ... and per grid point of the fused kernels' other formulas
# (csrc/cd_fused_kernels.cu, a power or logarithm counted as one): K1's
# C-grid winds, Courants and floors, K2's PGF and kicks, K3's fluxes and
# floors, K4's vorticity, KE, corners, fluxes of order 4, PGF and damping;
# the downward pass 9 and the upward pass 3 per point
OPS_FUSED = {"k1": 26 + 9, "k2": 3 + 45, "k3": 9 + 9,
             "k4": 3 + 120 + OPS_Y[4] + OPS_X[4]}
OPS_DEL4 = 12             # K4's del4 Laplacian of the divergence
OPS_DEL2 = 20             # K4's del2 Laplacians of u and v
# per column and level of the fused ZM tail (csrc/zm_tail_kernels.cu, each
# power or logarithm counted as one): evaporation with the blended
# Goff-Gratch qsat ~100, momtran of two winds ~120, the KE heating ~25,
# and per tracer ~50
OPS_TAIL_POINT, OPS_TAIL_TRACER = 245, 50


def bound(nbytes, ops, peaks=(HBM_BYTES_PER_S, PEAK_F32_OPS)):
    """(bound ms, "bytes" or "operations") of work that moves nbytes and
    does ops, at `peaks` (bytes/s, operations/s)."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = ops / peaks[1] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------- kernels
def ffsl_rows(crx, band):
    """Rows that take the FFSL branch: a |Courant| above 1 within the
    polar band."""
    ffsl = torch.amax(torch.abs(crx), dim=-1) > 1.0
    return _in_band(ffsl, band)


def _in_band(ffsl, band):
    jm = ffsl.shape[-1]
    if band is not None and 2 * band < jm:
        rows = torch.arange(jm, device=ffsl.device)
        ffsl = ffsl & ((rows < band) | (rows >= jm - band))
    return ffsl


def ffsl_sums(crx, ffsl, band):
    """Integer-Courant cells summed by one FFSL x-flux evaluation over
    the slab (data dependent)."""
    iu = torch.trunc(crx).abs().clamp(max=tp.max_cfl_int(crx.shape[-1]))
    return float((iu * _in_band(ffsl, band)[..., None]).sum())


def fused_courant(u, v, metrics, dt5):
    """K1's C-grid x-Courant from its arguments, through the plain
    version's own helper."""
    from ..models.fv.cd_fused import c_grid_courants
    return c_grid_courants(u, v, metrics, dt5)[2]


def _transport_ops(pts, iord, jord):
    """tp2c + tp2d of one slab: the inner operators, the fluxes of both
    fields and their divergences."""
    return pts * (2 * (OPS_ADX + OPS_ADY) + 2 * (OPS_Y[jord] + OPS_X[iord])
                  + 2 * OPS_DIV)


def filter_ops(name, shape, dft, dyn_filter):
    """Operations of K2's or K4's polar filter on (km, jm, im) slabs (0
    with the filter off), as (what the function needs, what the kernel
    does). The function needs an rfft and an irfft, 5 im log2(im)
    together, and 2 nf products with the response on each level row whose
    response is not 1 everywhere (the rows equatorward of the filter's
    edge need no work). The kernel takes the dense real-DFT sums on every
    row: 16 jm nf im a level (forward and inverse sums of two fields, a
    product and an addition a term)."""
    if not dyn_filter:
        return 0, 0
    km, jm, im = shape
    nf = im // 2 + 1
    # K2 filters its x-kick on center rows and y-kick on edge rows, K4
    # the other way round: each response table serves one field
    rows = sum(int((resp != 1.0).any(dim=-1).sum()) for resp in dft[4:])
    need = km * rows * (5.0 * im * math.log2(im) + 2 * nf)
    return need, km * 16 * jm * nf * im


def _ops_transport3d(p):
    return (_transport_ops(p["crx"].numel(), p["iord"], p["jord"])
            + 6 * ffsl_sums(p["crx"], p["ffsl"], p["band"]))


def _ops_vort_flux3d(p):
    return (p["crx"].numel() * (OPS_Y[p["jord"]] + OPS_X[p["iord"]])
            + ffsl_sums(p["crx"], p["ffsl"], p["band"]))


def _ops_tracer_div3d(p):
    q = p["q"]
    return (q.numel() * (OPS_ADX + OPS_ADY + OPS_Y[p["jord"]]
                         + OPS_X[p["iord"]] + OPS_DIV)
            + 3 * q.shape[0] * ffsl_sums(p["crx"], p["ffsl"], p["band"]))


def _ops_te_map_remap(p):
    # what the remap needs: pe_s and pe_t are monotone, so one merge pass
    # and a prefix sum give each target interface's mass (the kernel's
    # walk). Per column and field: PPM edges and limiter (~40 per source
    # cell), ~11 for the partial cell at each target interface, and the
    # merge's km + km_t + 1 comparisons plus the prefix sum's km additions
    km, ncol = p["u"].shape
    km_t = p["pe_t"].shape[0] - 1
    nf = len(p["center_fields"]) + 2
    return ncol * nf * (km * 40 + (km_t + 1) * 11 + (km + km_t + 1) + km)


def _ops_k1(p):
    pts = p["u"].numel()
    crx = fused_courant(p["u"], p["v"], p["metrics"], p["dt5"])
    return (pts * OPS_FUSED["k1"] + _transport_ops(pts, 1, 1)
            + 6 * ffsl_sums(crx, ffsl_rows(crx, p["band"]), p["band"]))


def _ops_k2(p):
    return (p["pt_h"].numel() * OPS_FUSED["k2"]
            + filter_ops("k2", p["pt_h"].shape, p["dft"],
                         p["dyn_filter"])[0])


def _ops_k3(p):
    pts, crx, band = p["delp"].numel(), p["crx"], p["band"]
    return (pts * OPS_FUSED["k3"] + _transport_ops(pts, p["iord"], p["jord"])
            + 6 * ffsl_sums(crx, ffsl_rows(crx, band), band))


def _ops_k4(p):
    pts, crx, band = p["u"].numel(), p["crx"], p["band"]
    return (pts * OPS_FUSED["k4"]
            + filter_ops("k4", p["u"].shape, p["dft"], p["dyn_filter"])[0]
            + pts * ((OPS_DEL4 if p["nu4"] > 0.0 else 0)
                     + (OPS_DEL2 if p["del2_velocity"] > 0.0 else 0))
            # OPS_FUSED counts the vorticity fluxes at order 4
            + pts * (OPS_Y[p["jord"]] + OPS_X[p["iord"]] - OPS_Y[4]
                     - OPS_X[4])
            + ffsl_sums(crx, ffsl_rows(crx, band), band))


def _ops_zm_tail(p):
    return p["t1"].numel() * (OPS_TAIL_POINT
                              + OPS_TAIL_TRACER * p["q_tr"].shape[2])


def _zm_tail_out_bytes(p):
    """zm_tail's outputs from its shapes (the plain version returns the
    same fields in other containers): 17 (ncol, pver) rows, the two
    (ncol, pver+1) fluxes, the two surface rates and dq_tr."""
    t1 = p["t1"]
    ncol, pver = t1.shape
    return t1.element_size() * (17 * ncol * pver + 2 * ncol * (pver + 1)
                                + 2 * ncol + p["q_tr"].numel())


_OPS = {"transport3d": _ops_transport3d, "vort_flux3d": _ops_vort_flux3d,
        "tracer_div3d": _ops_tracer_div3d,
        "te_map_remap": _ops_te_map_remap, "k1": _ops_k1, "k2": _ops_k2,
        "k3": _ops_k3, "k4": _ops_k4, "zm_tail": _ops_zm_tail,
        "probe": lambda p: p["x"].numel()}
_SIGNATURES = {}            # kernel name -> its wrapper's signature


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_work(name, args, kwargs, out):
    """(bytes, operations) one call of kernel `name` needs, from its
    arguments and what it returned: each tensor argument read once, each
    output written once; operations from the per-point counts and this
    call's FFSL sums (data dependent: count them quietly, outside any
    timed window)."""
    p = _SIGNATURES[name].bind(*args, **kwargs)
    p.apply_defaults()
    p = p.arguments
    ins = _nbytes(_tensors(list(p.values())))
    outs = (_zm_tail_out_bytes(p) if name == "zm_tail"
            else _nbytes(_tensors(out)))
    return ins + outs, _OPS[name](p)


def counted(name):
    """Decorator of the kernel wrapper `name`: under a `WorkCount` the
    call adds its `kernel_work` and nothing of what runs inside it; with
    no dispatch mode active it costs one check."""
    def deco(fn):
        _SIGNATURES[name] = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not torch._C._len_torch_dispatch_stack():
                return fn(*args, **kwargs)
            mode = _get_current_dispatch_mode()
            if not isinstance(mode, WorkCount):
                return fn(*args, **kwargs)
            with _disable_current_modes():
                out = fn(*args, **kwargs)
                nbytes, ops = kernel_work(name, args, kwargs, out)
            mode.add(name, nbytes, ops)
            return out
        return wrapper
    return deco


# ------------------------------------------------------------------ glue
_A = torch.ops.aten
# ops that move nothing: allocations, constants and metadata
_NO_WORK = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
            "ones_like", "new_ones", "full", "full_like", "new_full",
            "scalar_tensor", "arange", "linspace", "lift_fresh",
            "lift_fresh_copy", "_local_scalar_dense", "_unsafe_view",
            "_reshape_alias", "detach", "alias", "resize_", "set_",
            "record_stream", "is_nonzero", "is_same_size", "sym_size",
            "sym_stride", "sym_numel", "sym_storage_offset"}
# ops that overwrite their first argument without reading it
_OVERWRITE = {"copy_", "fill_", "zero_"}
# elementwise in name only: copies do no operations
_COPIES = {"clone", "_to_copy", "copy_", "contiguous"}
_SCANS = {"cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
          "cumsum_", "cumprod_"}
_FFTS = {"_fft_r2c", "_fft_c2r", "_fft_c2c"}


def _matmul_ops(name, args, out):
    """2mnk (out m x n, k the contracted length), plus mn for the added
    term of addmm, baddbmm and addmv."""
    added = name.startswith(("add", "badd"))
    ops = 2.0 * out.numel() * args[1 if added else 0].shape[-1]
    return ops + out.numel() if added else ops


def _fft_ops(name, args, out):
    sig = out if name == "_fft_c2r" else args[0]
    n = math.prod(sig.shape[d] for d in args[1])
    if n <= 1:
        return 0.0
    return sig.numel() / n * 5.0 * n * math.log2(n)


def aten_work(func, args, kwargs, out):
    """(bytes, operations) of one aten op (the module docstring's
    rules)."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _NO_WORK:
        return 0, 0.0
    ins = _tensors([list(args)[1:] if name in _OVERWRITE else list(args),
                    {k: v for k, v in kwargs.items() if k != "out"}])
    outs = _tensors(out)
    nbytes = _nbytes(ins) + _nbytes(outs)
    if name in ("mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"):
        ops = _matmul_ops(name, args, outs[0])
    elif name in _FFTS:
        ops = _fft_ops(name, args, outs[0])
    elif torch.Tag.reduction in func.tags or name in _SCANS:
        ops = float(args[0].numel())
    elif torch.Tag.pointwise in func.tags and name not in _COPIES:
        ops = float(sum(t.numel() for t in outs))
    else:
        ops = 0.0
    return nbytes, ops


class WorkCount(TorchDispatchMode):
    """Counts the bytes and operations of what runs under it: the glue op
    by op (`aten_work`), each kernel wrapper by its `kernel_work`
    (`kernels`: name -> [calls, bytes, operations])."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0.0
        self.kernels = {}

    def add(self, name, nbytes, ops):
        self.bytes += nbytes
        self.ops += ops
        row = self.kernels.setdefault(name, [0, 0, 0.0])
        row[0] += 1
        row[1] += nbytes
        row[2] += ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        nbytes, ops = aten_work(func, args, kwargs, out)
        self.bytes += nbytes
        self.ops += ops
        return out


def count_work(fn, *args):
    """(bytes, operations) of one eager call fn(*args)."""
    with WorkCount() as count:
        fn(*args)
    return count.bytes, count.ops
