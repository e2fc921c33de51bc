"""te_map's vertical remap: the CUDA kernel and its plain PyTorch version.

Twin of `cam_nor_physics_tpu.ops.remap_pallas`. `te_map_remap` remaps the
center fields (pt, tracers) on pe_s -> pe_t and u / v on their own
edge-averaged interface sets, all in the natural (k, ncol) layout. CUDA
tensors launch csrc/remap_kernels.cu: one launch a call, one thread per
column and field, each walking its column once (O(km + km_t) work), bitwise
equal to `te_map_remap_ref`: a column with a non-finite value or crossed
interfaces is summed again as the plain version sums it (NaN where it has
NaN). CPU tensors take
`te_map_remap_ref`. A kernel that does not build or launch raises.
`te_map_remap.launches` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from . import cost, cuda_build
from .remap import _ppm_edges_nonuniform

# The kernel's walk keeps no per-level arrays, so nothing in it bounds the
# levels; the limit stays the wrapper's contract (and its refusal tests')
MAX_LEVELS = 64


def _seq_sum(x, dim: int):
    """Sum along `dim` in index order, as the kernel accumulates."""
    acc = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        acc = acc + x.select(dim, k)
    return acc


def _remap_set_ref(pe_s, pe_t, fields, kord: int):
    """Remap each (km, ncol) field from pe_s to pe_t ((km+1, ncol) each)."""
    dp = pe_s[1:] - pe_s[:-1]
    dp_safe = torch.where(dp == 0, 1e-30, dp)
    # fractional overlap of each source cell below each interior target
    # interface: (km_t - 1, km, ncol)
    s = torch.clamp((pe_t[1:-1, None, :] - pe_s[None, :-1, :]) / dp_safe,
                    0.0, 1.0)
    dpe_t = pe_t[1:] - pe_t[:-1]
    outs = []
    for q in fields:
        al, ar, a6 = (a.T for a in _ppm_edges_nonuniform(q.T, dp.T, kord))
        half = 0.5 * ((ar - al) + a6)
        third = a6 * (1.0 / 3.0)
        part = dp * (s * (al + s * (half - third * s)))
        m = torch.cat([torch.zeros_like(q[:1]), _seq_sum(part, 1),
                       _seq_sum(q * dp, 0)[None]], 0)
        outs.append((m[1:] - m[:-1]) / dpe_t)
    return outs


def te_map_remap_ref(pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv, center_fields,
                     u, v, kord: int = 4):
    """Plain version of `te_map_remap`."""
    cen = _remap_set_ref(pe_s, pe_t, list(center_fields), kord)
    (u_n,) = _remap_set_ref(pe_su, pe_tu, [u], kord)
    (v_n,) = _remap_set_ref(pe_sv, pe_tv, [v], kord)
    return cen, u_n, v_n


def _check(pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv, cen, u, v):
    """Validate what the kernel takes (cen: the stacked center fields):
    one device, float32 or float64, contiguous, consistent shapes. Checked
    for CPU tensors too, so the CPU runs hold te_map to the contract."""
    km, ncol = u.shape
    km_t = pe_t.shape[0] - 1
    if min(km, km_t) < 1 or km > MAX_LEVELS or km_t > MAX_LEVELS:
        raise ValueError(f"te_map_remap: the CUDA kernel takes 1 to "
                         f"{MAX_LEVELS} levels, got {km} -> {km_t}")
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"te_map_remap: float32 or float64 expected, got "
                        f"{u.dtype}")
    named = [("pe_s", pe_s, (km + 1, ncol)), ("pe_t", pe_t, (km_t + 1, ncol)),
             ("pe_su", pe_su, (km + 1, ncol)),
             ("pe_tu", pe_tu, (km_t + 1, ncol)),
             ("pe_sv", pe_sv, (km + 1, ncol)),
             ("pe_tv", pe_tv, (km_t + 1, ncol)),
             ("center_fields", cen, (cen.shape[0], km, ncol)),
             ("u", u, (km, ncol)), ("v", v, (km, ncol))]
    for name, t, shape in named:
        if t.device != u.device or t.dtype != u.dtype:
            raise TypeError(f"te_map_remap: {name} is {t.dtype} on "
                            f"{t.device}, expected {u.dtype} on {u.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"te_map_remap: {name} must be a contiguous "
                             f"{shape}, got {tuple(t.shape)}")


@cost.counted("te_map_remap")
def te_map_remap(pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv, center_fields,
                 u, v, kord: int = 4):
    """Remap center_fields (list of (km, ncol)) on pe_s -> pe_t and u / v on
    their interface sets; all pe_* are (km+1, ncol). Returns
    (center_out list, u_out, v_out)."""
    cen = torch.stack(list(center_fields))
    _check(pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv, cen, u, v)
    if not u.is_cuda:
        return te_map_remap_ref(pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv,
                                center_fields, u, v, kord)
    lib = cuda_build.library("remap_kernels")
    suf = "f32" if u.dtype == torch.float32 else "f64"
    out = _run(getattr(lib, f"cam_te_map_remap_{suf}"),
               torch.cuda.current_stream(u.device).cuda_stream, pe_s, pe_t,
               pe_su, pe_tu, pe_sv, pe_tv, cen, u, v, kord)
    te_map_remap.launches += 1
    return out


def _run(fn, stream, pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv, cen, u, v,
         kord):
    """te_map_remap's launch: allocate the outputs and call `fn`, the C
    entry in csrc/remap_kernels.cu, on `stream` (the CPU test of the source
    calls it with a host build of it)."""
    km, ncol = u.shape
    km_t = pe_t.shape[0] - 1
    nf = cen.shape[0]
    cen_out = torch.empty((nf, km_t, ncol), dtype=u.dtype, device=u.device)
    u_out = torch.empty((km_t, ncol), dtype=u.dtype, device=u.device)
    v_out = torch.empty_like(u_out)
    rc = fn(pe_s.data_ptr(), pe_t.data_ptr(), pe_su.data_ptr(),
            pe_tu.data_ptr(), pe_sv.data_ptr(), pe_tv.data_ptr(),
            cen.data_ptr(), u.data_ptr(), v.data_ptr(), nf, km, km_t, ncol,
            kord, cen_out.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"te_map_remap: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    return list(cen_out.unbind(0)), u_out, v_out


te_map_remap.launches = 0
