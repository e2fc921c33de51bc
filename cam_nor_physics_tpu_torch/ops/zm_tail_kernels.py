"""The fused tail of ZM deep convection: the CUDA kernel and its plain
PyTorch version.

Twin of `cam_nor_physics_tpu.models.physics.zm_tail_pallas`. `zm_tail`
computes, in one launch, zm_conv_evap (old_snow path), momtran of u and v
and convtran pass 1 of the stacked tracers (fracis = 1, wet dp), with the
JAX signature and return value `(ev, mt, dq_tr)`. CUDA tensors launch
csrc/zm_tail_kernels.cu: one launch a call, a block a tile of neighbouring
columns staged through shared memory with coalesced loads and stores, its
recursions one thread per (column, chain); CPU tensors take
`zm_tail_ref`, the port's zm_conv_evap, momtran and convtran_single. A
kernel that does not build or launch raises. `zm_tail.launches` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from ..models.physics.zm_conv import zm_conv_evap
from ..models.physics.zm_transport import convtran_single, momtran
from ..utils.config import ZMConfig
from . import cost, cuda_build

# kMaxK in csrc/zm_tail_kernels.cu: its launch refuses more
MAX_LEVELS = 64

# the kernel's (ncol, pver) output rows, in csrc order
MID_OUT = ("tend_s", "tend_q", "tend_s_snwprd", "tend_s_snwevmlt",
           "ntprprd", "ntsnprd", "dudt", "dvdt", "seten", "pgu_u", "pgu_v",
           "pgd_u", "pgd_v", "icwu_u", "icwu_v", "icwd_u", "icwd_v")


def zm_tail_ref(cfg: ZMConfig, t1, qv1, pmid, pdel, u, v, q_tr, cld,
                mu, md, du, eu, ed, dp, jt, mx, rprd, prec_in, landfrac,
                ztodt: float):
    """Plain version of `zm_tail`: whole-column PyTorch through the port's
    zm_conv_evap, momtran and convtran_single."""
    ev = zm_conv_evap(cfg, t1, pmid, pdel, qv1, landfrac, rprd, cld, ztodt,
                      prec_in)
    mt = momtran(u, v, mu, md, du, eu, ed, dp, jt, mx, ztodt, cfg.momcu,
                 cfg.momcd)
    ones = torch.ones_like(t1)
    dq = torch.stack([convtran_single(q_tr[:, :, m], ones, mu, md, du, eu,
                                      ed, dp, jt, mx, ztodt)
                      for m in range(q_tr.shape[2])], -1)
    return ev, mt, dq


def _check(mids, q_tr, cols, jt, mx):
    """Validate what the kernel takes: one device, float32 or float64,
    contiguous (ncol, pver) fields, (ncol, pver, ntr) tracers, (ncol,)
    column values and integer level indices, at most MAX_LEVELS levels.
    Checked for CPU tensors too, so CPU runs hold the tail to the
    kernel's contract."""
    ref = mids[0][1]
    ncol, pver = ref.shape
    if pver > MAX_LEVELS:
        raise ValueError(f"zm_tail: the CUDA kernel takes at most "
                         f"{MAX_LEVELS} levels, got {pver}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"zm_tail: float32 or float64 expected, got "
                        f"{ref.dtype}")
    named = [(n, a, (ncol, pver)) for n, a in mids] + \
        [("q_tr", q_tr, (ncol, pver, q_tr.shape[-1]))] + \
        [(n, a, (ncol,)) for n, a in cols]
    for name, a, shape in named:
        if a.device != ref.device or a.dtype != ref.dtype:
            raise TypeError(f"zm_tail: {name} is {a.dtype} on {a.device}, "
                            f"expected {ref.dtype} on {ref.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"zm_tail: {name} must be a contiguous {shape}, "
                             f"got {tuple(a.shape)}")
    for name, a in (("jt", jt), ("mx", mx)):
        if a.is_floating_point() or tuple(a.shape) != (ncol,) or \
                a.device != ref.device:
            raise TypeError(f"zm_tail: {name} must be an integer ({ncol},) "
                            f"tensor on {ref.device}")


@cost.counted("zm_tail")
def zm_tail(cfg: ZMConfig, t1, qv1, pmid, pdel, u, v, q_tr, cld,
            mu, md, du, eu, ed, dp, jt, mx, rprd, prec_in, landfrac,
            ztodt: float):
    """Fused evap + momtran + convtran tail. q_tr: (ncol, pver, ntr) the
    convtran-1 tracers in their pre-transport state. Returns (ev, mt,
    dq_tr) as zm_conv_evap, momtran and convtran return them (dq_tr is
    (ncol, pver, ntr))."""
    mids = [("t1", t1), ("qv1", qv1), ("pmid", pmid), ("pdel", pdel),
            ("u", u), ("v", v), ("cld", cld), ("rprd", rprd), ("mu", mu),
            ("md", md), ("du", du), ("eu", eu), ("ed", ed), ("dp", dp)]
    cols = [("landfrac", landfrac), ("prec_in", prec_in)]
    _check(mids, q_tr, cols, jt, mx)
    if not t1.is_cuda:
        return zm_tail_ref(cfg, t1, qv1, pmid, pdel, u, v, q_tr, cld, mu, md,
                           du, eu, ed, dp, jt, mx, rprd, prec_in, landfrac,
                           ztodt)
    lib = cuda_build.library("zm_tail_kernels")
    suf = "f32" if t1.dtype == torch.float32 else "f64"
    out = _run(getattr(lib, f"cam_zm_tail_{suf}"),
               torch.cuda.current_stream(t1.device).cuda_stream, cfg, t1,
               qv1, pmid, pdel, u, v, q_tr, cld, mu, md, du, eu, ed, dp, jt,
               mx, rprd, prec_in, landfrac, ztodt)
    zm_tail.launches += 1
    return out


def _run(fn, stream, cfg, t1, qv1, pmid, pdel, u, v, q_tr, cld, mu, md, du,
         eu, ed, dp, jt, mx, rprd, prec_in, landfrac, ztodt):
    """zm_tail's launch: allocate the outputs, call `fn`, the C entry in
    csrc/zm_tail_kernels.cu, on `stream` (the CPU test of the source calls
    it with a host build of it), and unpack (ev, mt, dq_tr)."""
    ncol, pver = t1.shape
    ntr = q_tr.shape[2]
    mid = torch.empty((len(MID_OUT), ncol, pver), dtype=t1.dtype,
                      device=t1.device)
    flx = torch.empty((2, ncol, pver + 1), dtype=t1.dtype, device=t1.device)
    dq = torch.empty((ncol, pver, ntr), dtype=t1.dtype, device=t1.device)
    jt64 = jt.to(torch.int64).contiguous()
    mx64 = mx.to(torch.int64).contiguous()
    rc = fn(*[a.data_ptr() for a in (t1, qv1, pmid, pdel, u, v, cld, rprd,
                                     mu, md, du, eu, ed, dp, q_tr, landfrac,
                                     prec_in, jt64, mx64)],
            ncol, pver, ntr, int(cfg.org), float(cfg.ke), float(cfg.ke_lnd),
            float(cfg.momcu), float(cfg.momcd), float(ztodt),
            mid.data_ptr(), flx.data_ptr(), dq.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"zm_tail: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    o = dict(zip(MID_OUT, mid.unbind(0)))
    ev = {k: o[k] for k in MID_OUT[:6]}
    ev["flxprec"], ev["flxsnow"] = flx.unbind(0)
    ev["prec"] = ev["flxprec"][:, -1] / 1000.0
    ev["snow"] = ev["flxsnow"][:, -1] / 1000.0
    mt = dict(dudt=o["dudt"], dvdt=o["dvdt"], seten=o["seten"],
              pguall=(o["pgu_u"], o["pgu_v"]), pgdall=(o["pgd_u"], o["pgd_v"]),
              icwu=(o["icwu_u"], o["icwu_v"]), icwd=(o["icwd_u"], o["icwd_v"]))
    return ev, mt, dq


zm_tail.launches = 0
