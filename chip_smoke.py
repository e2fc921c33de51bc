#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives cam_nor_physics_tpu_torch only (never the JAX package):

1. names the card (torch and nvidia-smi: name, power limit);
2. builds the four CUDA kernels from csrc/ (one nvcc per source, together);
3. holds each kernel against its plain PyTorch version on the card, at the
   f19 (144x96x26) shapes and on inputs captured from a real Held-Suarez
   step (the Courants and fluxes of cd_step, the pe sets of te_map), plus a
   stress case that forces the FFSL branch near the poles; float32 within
   1e-5 and float64 within 1e-12 of each output's max magnitude;
4. runs the slice: build_step(144, 96, 26, float32, "cuda",
   filter_impl="matmul") for 4 large steps (2 model hours) with the launch
   counts set to 0 just before and read just after; checks finite fields,
   global dry-mass drift <= 1e-5, and agreement with the same 4 steps run
   through the plain versions on the card: ps, pt, u, v and q each within
   1e-3 of the field's max, or within twice the spread that one float32
   ulp of pt makes in the plain run over those steps where that is larger
   (float64: within 1e-9);
5. times each kernel and its plain version (CUDA events) and the step;
6. holds the fused ZM tail kernel (zm_tail) against its plain version
   (zm_tail_ref) at f19's 13,824 columns x 26 levels, on the inputs the
   port's own zm_convr gives it on entry.varied_zm_inputs (bench.py's
   sounding with per-column noise, winds, cloud tracers and fraction,
   land/ocean, every fourth column stable; seed 0): float32 within 1e-5,
   float64 within 1e-12 of each output's max (a surface rate, prec or
   snow, that is 0 everywhere in the plain version: of its column flux's
   max / 1000);
7. runs the ZM step, build_zm_step(13824, 26, float32, "cuda"), once on
   those inputs with the launch counts set to 0 just before and read just
   after: exactly 1 zm_tail launch, a triggered share strictly inside
   (0, 1), finite fields; then zm_conv_tend through the kernel against the
   same call through the plain tail, float32 and float64, on the ptend's
   s, u, v and q per species and the pbuf stores PREC_DP, SNOW_DP,
   DP_FLXPRC, DP_FLXSNW and NEVAPR_DPCU, with the gates of item 6;
8. times zm_tail and zm_tail_ref (CUDA events), zm_conv_tend per call
   (host clock, synchronised, mean of 3 after 1 warm-up) and zm_convr's
   share of it (timed inside 3 more calls),
   and the main path's grid points per second,
   144*96*26 / (HS large step + ZM step), as bench.py's headline;
9. runs the HS large step and the ZM step once more each under
   torch.profiler and prints the device kernels each launched,
   the device's busy time (the kernels' summed durations: one stream, so
   they do not overlap) and its share of the wall time, and the kernels
   that took the most device time;
10. prints the kernels JSON line, then {"ok": true, "device": {...}} last.

Exits non-zero, printing no result, without a CUDA device, outside a
checkout of the repo, or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
IM, JM, KM = 144, 96, 26
DEVICE = "cuda"
NSTEPS = 4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_F32_OPS = 67e12              # float32 FLOP/s outside the tensor cores
TOL = {"float32": 1e-5, "float64": 1e-12}
DRIFT_TOL = 1e-5
PLAIN_TOL = 1e-3          # float32, ROADMAP.md R2 ...
PLAIN_SPREAD = 2.0        # ... or this many times the one-ulp spread (R2b)
PLAIN_TOL_F64 = 1e-9      # float64: roundoff amplified through 16 small steps

NCOL = IM * JM                     # ZM columns: f19's 13,824
ZM_DT = 1800.0
ZM_CALLS = 3                       # timed zm_conv_tend calls after 1 warm-up
# estimated operations per column and level of the fused ZM tail (formulas
# of csrc/zm_tail_kernels.cu, each power or logarithm counted as one):
# evaporation with the blended Goff-Gratch qsat ~100, momtran of two winds
# ~120, the KE heating ~25, and per tracer ~50
OPS_TAIL_POINT, OPS_TAIL_TRACER = 245, 50

# name, source, the TPU kernel it replaces (file:line of the Pallas kernel)
KERNELS = (
    ("transport3d", "cam_nor_physics_tpu_torch/csrc/stencil_kernels.cu",
     "cam_nor_physics_tpu/ops/pallas_kernels.py:177"),
    ("vort_flux3d", "cam_nor_physics_tpu_torch/csrc/stencil_kernels.cu",
     "cam_nor_physics_tpu/ops/pallas_kernels.py:266"),
    ("tracer_div3d", "cam_nor_physics_tpu_torch/csrc/stencil_kernels.cu",
     "cam_nor_physics_tpu/ops/pallas_kernels.py:326"),
    ("te_map_remap", "cam_nor_physics_tpu_torch/csrc/remap_kernels.cu",
     "cam_nor_physics_tpu/ops/remap_pallas.py:115"),
    ("zm_tail", "cam_nor_physics_tpu_torch/csrc/zm_tail_kernels.cu",
     "cam_nor_physics_tpu/models/physics/zm_tail_pallas.py:206"),
)

# estimated operations per grid point of the stencil formulas (tp_core.cuh):
# an x-flux (xtp) and a y-flux (ytp) at order 1 and 4, the inner advective
# operators and a flux divergence
OPS_X = {1: 3, 4: 70}
OPS_Y = {1: 2, 4: 80}
OPS_ADX, OPS_ADY, OPS_DIV = 2 * OPS_X[1] + 6, 5, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    """`name, power.limit` of the card from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


class Smoke:
    def __init__(self, torch, card: str):
        import cam_nor_physics_tpu_torch.models.fv.cd_core as cd_core
        import cam_nor_physics_tpu_torch.models.fv.dyn_comp as dyn_comp
        from cam_nor_physics_tpu_torch.ops import (remap_kernels,
                                                   stencil_kernels, tp_core)
        self.torch = torch
        self.card = card
        self.tp = tp_core
        # where the main path looks each kernel's wrapper up
        self.sites = {"transport3d": (cd_core, stencil_kernels),
                      "vort_flux3d": (cd_core, stencil_kernels),
                      "tracer_div3d": (dyn_comp, stencil_kernels),
                      "te_map_remap": (dyn_comp, remap_kernels)}

    def kernel(self, name):
        return getattr(self.sites[name][1], name)

    def plain(self, name):
        return getattr(self.sites[name][1], name + "_ref")

    @contextmanager
    def routed(self, wrap):
        """Point the main path's kernel sites at wrap(name) for a while."""
        saved = {n: getattr(m, n) for n, (m, _) in self.sites.items()}
        try:
            for n, (m, _) in self.sites.items():
                setattr(m, n, wrap(n))
            yield
        finally:
            for n, (m, _) in self.sites.items():
                setattr(m, n, saved[n])

    # ------------------------------------------------------------ phase 3
    def capture_inputs(self, step, state, grid, coord, phis):
        """One spin-up large step, then the arguments of every kernel call of
        the next step, both through the plain versions."""
        calls = {n: [] for n in self.sites}

        def rec(name):
            ref = self.plain(name)

            def f(*a, **kw):
                calls[name].append((a, kw))
                return ref(*a, **kw)
            return f

        with self.routed(self.plain):
            state = step(state, grid, coord, phis)
        with self.routed(rec):
            step(state, grid, coord, phis)
        self.torch.cuda.synchronize()
        return calls

    def main_path_inputs(self, calls):
        """(label, name, args, kwargs) of each distinct kernel configuration
        the main path runs: transport3d at iord 1 (C half step) and 4
        (D step), the last call of each."""
        out = []
        for name, lst in calls.items():
            if name == "transport3d":
                for order in (1, 4):
                    a, kw = [c for c in lst if c[0][10] == order][-1]
                    out.append((f"{name}[iord={order}]", name, a, kw))
            else:
                a, kw = lst[-1]
                out.append((name, name, a, kw))
        return out

    def stressed(self, name, a, kw):
        """The same call with |crx| raised by 1.5 in rows 1-3 and
        jm-4..jm-2 so the FFSL branch (integer-Courant sums) runs there."""
        torch = self.torch
        a = list(a)
        crx = a[2] if name == "transport3d" else a[1]
        rows = list(range(1, 4)) + list(range(JM - 4, JM - 1))
        c2 = crx.clone()
        c2[:, rows] = c2[:, rows] + torch.where(c2[:, rows] >= 0, 1.5, -1.5)
        ffsl = torch.amax(torch.abs(c2), dim=-1) > 1.0
        if name == "transport3d":
            a[2], a[6] = c2, ffsl
        elif name == "vort_flux3d":
            a[1], a[5] = c2, ffsl
        else:
            a[1], a[6] = c2, ffsl
        return tuple(a), kw, int(ffsl.sum())

    def cast(self, a, kw, dtype):
        torch = self.torch

        def f(x):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                return x.to(dtype).contiguous()
            if isinstance(x, list):
                return [f(y) for y in x]
            return x
        return tuple(f(x) for x in a), {k: f(v) for k, v in kw.items()}

    @staticmethod
    def flat(out):
        res = []
        for x in (out if isinstance(out, (tuple, list)) else (out,)):
            res.extend(Smoke.flat(x) if isinstance(x, (tuple, list)) else [x])
        return res

    def compare(self, label, name, a, kw, dtype_name):
        torch = self.torch
        dtype = getattr(torch, dtype_name)
        a, kw = self.cast(a, kw, dtype)
        got = self.flat(self.kernel(name)(*a, **kw))
        want = self.flat(self.plain(name)(*a, **kw))
        torch.cuda.synchronize()
        rel, abs_err = 0.0, 0.0
        for g, w in zip(got, want):
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"{label} {dtype_name}: non-finite output")
            d = float((g - w).abs().max())
            scale = max(float(w.abs().max()), 1e-30)
            abs_err = max(abs_err, d)
            rel = max(rel, d / scale)
        ok = rel <= TOL[dtype_name]
        log(f"check {label:<24} {dtype_name}: max_abs_err={abs_err:.3e} "
            f"max_rel_err={rel:.3e} tol={TOL[dtype_name]:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label} {dtype_name}: kernel disagrees with "
                               f"its plain version ({rel:.3e})")
        return abs_err

    # ------------------------------------------------------------ phase 4
    @staticmethod
    def parity(a, b, coord):
        """max|a-b| / max|b| of ps, pt, u, v and q of two states."""
        out = {}
        for f in ("ps", "pt", "u", "v", "q"):
            if f == "ps":
                x = coord.ptop + a.delp.double().sum(0)
                y = coord.ptop + b.delp.double().sum(0)
            else:
                x, y = getattr(a, f).double(), getattr(b, f).double()
            out[f] = float((x - y).abs().max() / y.abs().max())
        return out

    @staticmethod
    def dry_mass(grid, state):
        w = grid.cosp.double().clone()
        w[0] = w[-1] = grid.acap / grid.im
        return float((state.delp.double() * w[:, None]).sum())

    def run_steps(self, step, state, grid, coord, phis):
        torch = self.torch
        times = []
        for _ in range(NSTEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = step(state, grid, coord, phis)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return state, times

    # ------------------------------------------------------------ phase 5
    def time_call(self, fn, a, kw, reps):
        torch = self.torch
        for _ in range(2):
            fn(*a, **kw)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn(*a, **kw)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def ffsl_sums(self, crx, ffsl, band):
        """Integer-Courant cells summed by one FFSL x-flux evaluation over
        the slab (data dependent)."""
        torch = self.torch
        rows = torch.arange(crx.shape[-2], device=crx.device)
        if band is not None and 2 * band < crx.shape[-2]:
            ffsl = ffsl & ((rows < band) | (rows >= crx.shape[-2] - band))
        iu = torch.trunc(crx).abs().clamp(max=self.tp.max_cfl_int(IM))
        return float((iu * ffsl[..., None]).sum())

    def work(self, name, a, kw):
        """(bytes moved, operations) the call needs: each input read once,
        each output written once; operations from the per-point counts."""
        torch = self.torch
        out = self.flat(self.kernel(name)(*a, **kw))
        ins = [x for x in self.flat(list(a)) if isinstance(x, torch.Tensor)]
        nbytes = sum(t.numel() * t.element_size() for t in ins + out)
        if name == "te_map_remap":
            # what the remap needs, not the kernel's all-pairs clip
            # integral: pe_s and pe_t are monotone, so one merge pass and a
            # prefix sum give each target interface's mass. Per column and
            # field: PPM edges and limiter (~40 per source cell), ~11 for
            # the partial cell at each target interface, and the merge's
            # km + km_t + 1 comparisons plus the prefix sum's km additions
            km, ncol = a[7].shape
            km_t = a[1].shape[0] - 1
            nf = len(a[6]) + 2
            ops = ncol * nf * (km * 40 + (km_t + 1) * 11
                               + (km + km_t + 1) + km)
            return nbytes, ops
        band = kw.get("band")
        if name == "transport3d":
            crx, ffsl, iord, jord = a[2], a[6], a[10], a[11]
            pts = crx.numel()
            ops = pts * (2 * (OPS_ADX + OPS_ADY) + 2 * (OPS_Y[jord] +
                         OPS_X[iord]) + 2 * OPS_DIV)
            ops += 6 * self.ffsl_sums(crx, ffsl, band)
        elif name == "vort_flux3d":
            crx, ffsl, iord, jord = a[1], a[5], a[7], a[8]
            ops = crx.numel() * (OPS_Y[jord] + OPS_X[iord])
            ops += self.ffsl_sums(crx, ffsl, band)
        else:
            q, crx, ffsl, iord, jord = a[0], a[1], a[6], a[10], a[11]
            ops = q.numel() * (OPS_ADX + OPS_ADY + OPS_Y[jord] + OPS_X[iord]
                               + OPS_DIV)
            ops += 3 * q.shape[0] * self.ffsl_sums(crx, ffsl, band)
        return nbytes, ops


class ZMSmoke:
    """The ZM step's checks: the fused tail kernel (zm_tail) against its
    plain version, and zm_conv_tend through the kernel against the same
    call through the plain tail."""

    def __init__(self, torch, sm: Smoke):
        from cam_nor_physics_tpu_torch.models.physics import zm_conv_intr
        from cam_nor_physics_tpu_torch.models.physics.constituents import \
            default_registry
        from cam_nor_physics_tpu_torch.ops import zm_tail_kernels
        from cam_nor_physics_tpu_torch.utils.config import ZMConfig
        self.torch, self.sm = torch, sm
        self.intr, self.tk = zm_conv_intr, zm_tail_kernels
        self.cfg, self.reg = ZMConfig(), default_registry()

    @contextmanager
    def routed(self, fn):
        """Point zm_conv_tend's tail site at fn for a while."""
        saved = self.intr.zm_tail
        self.intr.zm_tail = fn
        try:
            yield
        finally:
            self.intr.zm_tail = saved

    def tend(self, pstate, pbuf, forcing):
        return self.intr.zm_conv_tend(self.cfg, self.reg, pstate, pbuf,
                                      forcing["pblh"], forcing["tpert"],
                                      forcing["landfrac"], ZM_DT)

    def capture(self, pstate, pbuf, forcing):
        """The arguments of the tail call of one zm_conv_tend, run through
        the plain tail."""
        calls = []

        def rec(*a, **kw):
            calls.append((a, kw))
            return self.tk.zm_tail_ref(*a, **kw)

        with self.routed(rec):
            self.tend(pstate, pbuf, forcing)
        return calls[-1]

    @staticmethod
    def tail_outputs(res):
        """{name: tensor} of zm_tail's (ev, mt, dq_tr)."""
        ev, mt, dq = res
        out = dict(ev)
        out.update({k: mt[k] for k in ("dudt", "dvdt", "seten")})
        for k in ("pguall", "pgdall", "icwu", "icwd"):
            out.update({f"{k}[{i}]": mt[k][i] for i in range(2)})
        out["dq_tr"] = dq
        return out

    @staticmethod
    def tend_outputs(out):
        """The fields of zm_conv_tend the tail moves: the summed ptend's
        s, u, v and q per species, and the tail's pbuf stores."""
        res = {"ptend.s": out.ptend_all.s, "ptend.u": out.ptend_all.u,
               "ptend.v": out.ptend_all.v}
        for m in range(out.ptend_all.q.shape[2]):
            res[f"ptend.q[{m}]"] = out.ptend_all.q[:, :, m]
        for k in ("PREC_DP", "SNOW_DP", "DP_FLXPRC", "DP_FLXSNW",
                  "NEVAPR_DPCU"):
            res[f"pbuf.{k}"] = out.pbuf.get(k)
        return res

    def rel_errors(self, got, want, flux_of):
        """max|g-w| / scale per field and the largest |g-w|; the scale is
        the field's max in `want`. A surface rate (`flux_of` names its
        column flux; the rate is the flux's bottom row / 1000) that is 0
        everywhere in `want` is held to its flux's max / 1000 instead."""
        rel, abs_err = {}, 0.0
        for k, w in want.items():
            g = got[k]
            if not bool(self.torch.isfinite(g).all()):
                raise RuntimeError(f"ZM {k}: non-finite output")
            d = float((g.double() - w.double()).abs().max())
            scale = float(w.double().abs().max())
            if scale == 0.0 and k in flux_of:
                scale = float(want[flux_of[k]].double().abs().max()) / 1000.0
            rel[k] = d / max(scale, 1e-30)
            abs_err = max(abs_err, d)
        return rel, abs_err

    def gate(self, label, rel, dtype_name):
        worst = max(rel, key=rel.get)
        ok = rel[worst] <= TOL[dtype_name]
        log(f"check {label:<24} {dtype_name}: max_rel_err={rel[worst]:.3e} "
            f"({worst}) tol={TOL[dtype_name]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label} {dtype_name}: kernel disagrees with "
                               f"its plain version: {rel}")

    def compare_tail(self, a, kw, dtype_name):
        a, kw = self.sm.cast(a, kw, getattr(self.torch, dtype_name))
        got = self.tail_outputs(self.tk.zm_tail(*a, **kw))
        want = self.tail_outputs(self.tk.zm_tail_ref(*a, **kw))
        self.torch.cuda.synchronize()
        rel, abs_err = self.rel_errors(
            got, want, {"prec": "flxprec", "snow": "flxsnow"})
        self.gate("zm_tail", rel, dtype_name)
        return abs_err

    def compare_tend(self, inputs, dtype_name):
        got = self.tend_outputs(self.tend(*inputs))
        with self.routed(self.tk.zm_tail_ref):
            want = self.tend_outputs(self.tend(*inputs))
        self.torch.cuda.synchronize()
        rel, _ = self.rel_errors(got, want,
                                 {"pbuf.PREC_DP": "pbuf.DP_FLXPRC",
                                  "pbuf.SNOW_DP": "pbuf.DP_FLXSNW"})
        self.gate("zm_conv_tend", rel, dtype_name)

    def work(self, a, kw):
        """(bytes, operations) of one tail call: inputs read once, outputs
        written once; operations from the per-point estimate."""
        torch = self.torch
        out = list(self.tail_outputs(self.tk.zm_tail(*a, **kw)).values())
        ins = [x for x in a if isinstance(x, torch.Tensor)]
        nbytes = sum(t.numel() * t.element_size() for t in ins + out)
        t1, q_tr = a[1], a[7]          # zm_tail(cfg, t1, qv1, ..., q_tr, ...)
        ops = t1.numel() * (OPS_TAIL_POINT + OPS_TAIL_TRACER * q_tr.shape[2])
        return nbytes, ops

    def time_host(self, fn, calls):
        """Mean seconds of `calls` synchronised calls after one warm-up."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sum(times) / len(times), times

    def convr_share(self, fn, calls):
        """(zm_convr's seconds, the call's seconds), summed over `calls`
        calls of fn after one warm-up, with zm_convr timed inside the same
        calls (synchronised on entry and exit)."""
        torch, orig, spent = self.torch, self.intr.zm_convr, []

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)
            return out

        self.intr.zm_convr = timed
        try:
            _, times = self.time_host(fn, calls)
        finally:
            self.intr.zm_convr = orig
        return sum(spent[-calls:]), sum(times)


def run_zm(torch, sm: Smoke, card: str) -> dict:
    """Phases 6-8: the ZM step at f19's columns."""
    from cam_nor_physics_tpu_torch.entry import (build_zm_step,
                                                 varied_zm_inputs)
    zm = ZMSmoke(torch, sm)

    # ---- phase 6: the tail kernel against its plain version, on the
    # inputs the port's own zm_convr gives it on the ZM state
    zstep, _, _, _ = build_zm_step(NCOL, KM, torch.float32, DEVICE)
    inputs = varied_zm_inputs(NCOL, KM, torch.float32, DEVICE)
    a, kw = zm.capture(*inputs)
    err = zm.compare_tail(a, kw, "float32")
    zm.compare_tail(a, kw, "float64")

    # ---- phase 7: the ZM step through the kernel, counted
    zm.tk.zm_tail.launches = 0
    state1, pbuf1 = zstep(*inputs)
    torch.cuda.synchronize()
    launches = zm.tk.zm_tail.launches
    share = float(pbuf1.get("ZM_IDEEP").double().mean())
    log(f"main path: 1 zm_conv_tend on {NCOL}x{KM} float32, launches "
        f"{{'zm_tail': {launches}}}, triggered share {share:.4f} [{card}]")
    if launches != 1:
        raise RuntimeError(f"zm_tail launched {launches} times in one "
                           f"zm_conv_tend (expected 1)")
    if not 0.0 < share < 1.0:
        raise RuntimeError(f"triggered share {share} not inside (0, 1)")
    for f in ("t", "u", "v", "q"):
        if not bool(torch.isfinite(getattr(state1, f)).all()):
            raise RuntimeError(f"non-finite {f} after the ZM step")
    zm.compare_tend(inputs, "float32")
    zm.compare_tend(varied_zm_inputs(NCOL, KM, torch.float64, DEVICE),
                    "float64")

    # ---- phase 8: times
    ms = sm.time_call(zm.tk.zm_tail, a, kw, 50)
    plain_ms = sm.time_call(zm.tk.zm_tail_ref, a, kw, 5)
    nbytes, ops = zm.work(a, kw)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS * 1e3
    bound = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"time zm_tail            kernel {ms:.4f} ms  plain {plain_ms:.4f} "
        f"ms  bound {bound:.5f} ms by {bound_by} ({nbytes} B, {ops:.3e} "
        f"ops)  [{card}]")
    tend_s, tend_all = zm.time_host(lambda: zstep(*inputs), ZM_CALLS)
    convr_s, call_s = zm.convr_share(lambda: zstep(*inputs), ZM_CALLS)
    log(f"zm_conv_tend per call [{card}]: {1e3 * tend_s:.2f} ms (mean of "
        f"{ZM_CALLS} after 1 warm-up: "
        + ", ".join(f"{1e3 * t:.2f}" for t in tend_all)
        + f" ms); zm_convr {1e3 * convr_s / ZM_CALLS:.2f} of "
        f"{1e3 * call_s / ZM_CALLS:.2f} ms per call "
        f"({100.0 * convr_s / call_s:.1f}%) in {ZM_CALLS} more calls with "
        f"zm_convr timed inside them")
    return {"row": {"launches": launches, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by},
            "zm_s": tend_s, "step": lambda: zstep(*inputs)}


def profile_call(torch, label, fn, card, top=6):
    """Phase 9: one warm-up call of fn, then one under torch.profiler;
    prints the wall time, the device kernels, the device's busy time and
    share, and the `top` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError(f"{label}: the profiler recorded no device time")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    share = 100.0 * busy_us / 1e6 / wall
    log(f"profile {label} [{card}]: wall {1e3 * wall:.2f} ms under the "
        f"profiler, {len(kernels)} device kernels, device busy "
        f"{busy_us / 1e3:.3f} ms ({share:.1f}% of the wall time, idle "
        f"{100.0 - share:.1f}%)")
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda x: -x[1][1])[:top]:
        log(f"    {us / 1e3:9.3f} ms  {n:6d} x  {name[:90]}")


def run(torch) -> dict:
    from cam_nor_physics_tpu_torch.entry import build_step
    from cam_nor_physics_tpu_torch.ops import cuda_build

    # ---- phase 1: the card
    card = card_label()
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    log(card)
    sm = Smoke(torch, card)

    # ---- phase 2: build
    t0 = time.perf_counter()
    times = cuda_build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    for name in cuda_build.SOURCES:
        logf = cuda_build.BUILD / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # ---- phase 3: each kernel against its plain version
    step, state0, grid, coord, phis = build_step(
        IM, JM, KM, torch.float32, DEVICE, filter_impl="matmul")
    # a positive tracer, so trac2d and te_map move real tracer mass
    rng = np.random.default_rng(1)
    tracer = torch.as_tensor(
        1e-3 * (1.0 + 0.5 * rng.uniform(size=tuple(state0.q.shape))),
        dtype=torch.float32, device=DEVICE)
    state0 = state0.replace(q=tracer)
    calls = sm.capture_inputs(step, state0, grid, coord, phis)
    cases = sm.main_path_inputs(calls)
    max_err = {}
    for label, name, a, kw in cases:
        for dt in ("float32", "float64"):
            err = sm.compare(label, name, a, kw, dt)
            if dt == "float32":
                max_err[name] = max(max_err.get(name, 0.0), err)
        if name != "te_map_remap":
            sa, skw, nrows = sm.stressed(name, a, kw)
            for dt in ("float32", "float64"):
                sm.compare(f"{label}+ffsl({nrows} rows)", name, sa, skw, dt)

    # ---- phase 4: the slice through the kernels, counted
    for name in sm.sites:
        sm.kernel(name).launches = 0
    state, step_s = sm.run_steps(step, state0, grid, coord, phis)
    torch.cuda.synchronize()
    launches = {n: sm.kernel(n).launches for n in sm.sites}
    log(f"main path: {NSTEPS} HS large steps at {IM}x{JM}x{KM} float32, "
        f"launches {launches} [{card}]")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    for f in ("u", "v", "pt", "delp", "q"):
        if not bool(torch.isfinite(getattr(state, f)).all()):
            raise RuntimeError(f"non-finite {f} after {NSTEPS} steps")
    m0, m1 = sm.dry_mass(grid, state0), sm.dry_mass(grid, state)
    drift = abs(m1 - m0) / m0
    log(f"dry-mass drift over {NSTEPS} steps: {drift:.3e} "
        f"(tol {DRIFT_TOL:.0e})")
    if drift > DRIFT_TOL:
        raise RuntimeError(f"dry-mass drift {drift:.3e} > {DRIFT_TOL}")
    with sm.routed(sm.plain):
        ref, ref_s = sm.run_steps(step, state0, grid, coord, phis)
        # how far float32 roundoff alone carries in 4 steps: the plain run
        # again from pt changed by one ulp
        nudged = state0.replace(pt=state0.pt * (1.0 + 2.0 ** -23))
        ref_n, _ = sm.run_steps(step, nudged, grid, coord, phis)
    ulp = sm.parity(ref_n, ref, coord)
    log("plain run vs plain run from pt nudged by one float32 ulp: "
        + ", ".join(f"{k} {v:.3e}" for k, v in ulp.items()))
    parity = sm.parity(state, ref, coord)
    ptol = {f: max(PLAIN_TOL, PLAIN_SPREAD * ulp[f]) for f in parity}
    log("kernels vs plain versions after the same steps (rel. to max): "
        + ", ".join(f"{k} {v:.3e} (tol {ptol[k]:.2e})"
                    for k, v in parity.items()))
    bad = {f: e for f, e in parity.items() if e > ptol[f]}
    if bad:
        raise RuntimeError(f"slice disagrees with its plain run: {bad}")
    # the same comparison in float64
    step64, s64, grid64, coord64, phis64 = build_step(
        IM, JM, KM, torch.float64, DEVICE, filter_impl="matmul")
    s64 = s64.replace(q=tracer.double())
    k64, _ = sm.run_steps(step64, s64, grid64, coord64, phis64)
    with sm.routed(sm.plain):
        r64, _ = sm.run_steps(step64, s64, grid64, coord64, phis64)
    parity64 = sm.parity(k64, r64, coord64)
    log("float64: kernels vs plain versions after the same steps: "
        + ", ".join(f"{k} {v:.3e}" for k, v in parity64.items())
        + f" (tol {PLAIN_TOL_F64:.0e})")
    if max(parity64.values()) > PLAIN_TOL_F64:
        raise RuntimeError(f"float64 slice disagrees with its plain run: "
                           f"{parity64}")
    steady = sum(step_s[1:]) / (len(step_s) - 1)
    log(f"step time [{card}]: kernels " + ", ".join(f"{1e3 * t:.2f}"
                                                   for t in step_s)
        + f" ms (mean of steps 2-{NSTEPS}: {1e3 * steady:.2f} ms); plain "
        + ", ".join(f"{1e3 * t:.2f}" for t in ref_s) + " ms")

    # ---- phase 5: per-kernel times at the main path's shapes
    rows = []
    for label, name, a, kw in cases:
        ms = sm.time_call(sm.kernel(name), a, kw, 50)
        plain_ms = sm.time_call(sm.plain(name), a, kw, 5)
        nbytes, ops = sm.work(name, a, kw)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS * 1e3
        bound = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"time {label:<18} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {bound:.5f} ms by {bound_by} ({nbytes} B, {ops:.3e} "
            f"ops)  [{card}]")
        rows.append((label, name, ms, plain_ms, bound, bound_by))
    # ---- phases 6-8: the ZM step and its tail kernel
    zm = run_zm(torch, sm, card)
    log(f"main path [{card}]: HS large step {1e3 * steady:.2f} ms + ZM step "
        f"{1e3 * zm['zm_s']:.2f} ms -> "
        f"{IM * JM * KM / (steady + zm['zm_s']):.6e} grid points/s "
        f"({IM}x{JM}x{KM})")

    # ---- phase 9: where the main path's time goes
    profile_call(torch, f"HS large step {IM}x{JM}x{KM}",
                 lambda: step(state0, grid, coord, phis), card)
    profile_call(torch, f"ZM step {NCOL}x{KM}", zm["step"], card)

    kernels = []
    for name, source, replaces in KERNELS:
        if name == "zm_tail":
            kernels.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces, **zm["row"],
                            "library_ms": None})
            continue
        # transport3d runs at two orders, launched equally often per
        # step: its numbers are the mean of the two per-launch values
        mine = [r for r in rows if r[1] == name]
        mean = lambda i: sum(r[i] for r in mine) / len(mine)  # noqa: E731
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": mean(2), "plain_ms": mean(3), "bound_ms": mean(4),
            "bound_by": max(mine, key=lambda r: r[4])[5],
            "library_ms": None})
    return {"card": card, "kernels": kernels}


def main() -> int:
    if not (REPO / "cam_nor_physics_tpu_torch" / "entry.py").is_file():
        print("chip_smoke.py must run from a checkout of the repo "
              "(cam_nor_physics_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    record = run(torch)
    print(json.dumps({"kernels": record["kernels"]}))
    print(record["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
