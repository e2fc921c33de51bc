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
6. prints the kernels JSON line, then {"ok": true, "device": {...}} last.

Exits non-zero, printing no result, without a CUDA device, outside a
checkout of the repo, or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
    kernels = []
    for name, source, replaces in KERNELS:
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
