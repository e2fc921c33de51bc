"""The port's bench: bench.py's main path, timed, one JSON line.

    python -m cam_nor_physics_tpu_torch.bench

Twin of the root bench.py's `main`. Metric: grid points per second of one
FV Held-Suarez large step (dyn_run with FVConfig()'s auto splits and the
fused fft small step, then hs_forcing; dt = 1800 s) plus one ZM
deep-convection step (zm_conv_tend) on the same number of columns, in
float32. On the card the step runs the port's CUDA kernels: K1-K4 in
every small step, tracer_div3d in trac2d, te_map_remap in te_map and the
fused ZM tail. Before any timing the probe kernel (ops/probe_kernels.py)
runs once and must return exactly 2 x its input.

Two loop shapes are timed, as in bench.py:
- per dispatch: the chained loop x(n+1) = step(x(n)), best of 3 passes
  after 2 warm-up steps, with torch.cuda.synchronize() as the fence;
- chunked: K chained steps captured as one CUDA graph (`ChainGraph`),
  whose last step writes back into the graph's input buffers, replayed
  once per dispatch. The graph is used only after its first replay has
  been found bitwise equal to K eager steps from the same state; it
  raises otherwise. The CPU has no graph: there the chunked keys are left
  out, as bench.py leaves them out for chunk 1.
The headline is the faster shape (`headline_shape`, `chunk`).

Environment, as bench.py's:
  BENCH_SMALL=1          72x46x10, 3 iterations
  BENCH_GRID=f19|f09|f05 144x96x26 (40, the default), 288x192x26 (5),
                         576x384x32 (3)
  BENCH_CHUNK=K          steps per graph replay (default 8; 1: per
                         dispatch only)
  BENCH_PHASES=1         cd_step x ns, trac2d and te_map times on stderr
  BENCH_CPU=1            run on the CPU (the kernels' plain versions)
  BENCH_COUPLED=1        the coupled step instead (below)
  BENCH_MICROP=1         with BENCH_COUPLED=1: ZMConfig(microp=True), the
                         in-plume microphysics (bench.py's production
                         configuration; ZM's fused tail is off under it)
  BENCH_ROOFLINE=1       after the timings, each step's bytes and
                         operations counted over one eager call
                         (ops/cost.py: the kernels' own work and the
                         PyTorch glue op by op) and one stderr line per
                         step and loop shape timed: the achieved rates and
                         their shares of the card's peaks (`roofline_line`);
                         with BENCH_COUPLED=1 it raises ValueError (bench.py
                         ignores it there)
The JSON line carries bench.py's keys plus `impl` (what the headline
measures) and `card` (nvidia-smi's name and power limit; null on the
CPU).

BENCH_COUPLED=1 is the twin of bench.py's `coupled_main`: the coupled
atm_step in bench.py's configuration ("config-4b", entry.build_coupled:
gray radiation, implicit vertical diffusion, ZM, the FV dycore with
FVConfig()'s auto splits, aquaplanet bulk surface fluxes), float32, at
BENCH_GRID (20 steps at f19, 5 at f09, 3 at f05, 3 with BENCH_SMALL).
After the first step (first_step=True) and one more, the loop shapes
are timed from the same state: per dispatch, and *chunked* (BENCH_CHUNK
steps, only the state kept, as one CUDA graph, `ChainGraph`, held bitwise
to as many eager steps first). bench.py's *full* (diagnostics returned)
and *prog_only* (diagnostics dropped) are one computation in eager
PyTorch, which builds the diagnostics whichever the caller keeps: one
per-dispatch loop is timed and reported under both keys. Then the
per-phase table: phys_run1 (bc_physics), phys_run2 (ac_physics),
p_d_coupling, dyn_run (dyn) and d_p_coupling, each timed as its own
dispatch on the same state. The metric is grid points per second of the
fastest shape.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import torch

from .entry import DT, build_coupled, build_step, build_zm_step
from .ops import cost, cuda_build
from .ops.probe_kernels import SHAPE as PROBE_SHAPE
from .ops.probe_kernels import probe
from .utils.config import FVConfig
from .utils.device import resolve_device

# name: (im, jm, km, chained iterations), bench.py:472-485
GRIDS = {"small": (72, 46, 10, 3), "f19": (144, 96, 26, 40),
         "f09": (288, 192, 26, 5), "f05": (576, 384, 32, 3)}
SPINUP = 3
PROFILE_TRIES = 3          # profiler windows run before giving up
# spin kernels (torch.cuda._sleep, ~1 ms each) at each end of a profiled
# window: the profiler drops device records now and then, up to a few
# dozen of a window's first ones or every one of a short window
PROFILE_PAD = 48
PROFILE_PAD_CYCLES = 10 ** 6
METRIC = "grid-points/s per chip (FV dyn step + ZM physics step)"
# chained steps of the coupled bench, bench.py:289-297
COUPLED_ITERS = {"small": 3, "f19": 20, "f09": 5, "f05": 3}
COUPLED_METRIC = ("grid-points/s per chip (full coupled atm_step, "
                  "config-4b aquaplanet)")
# bench.py's metric under BENCH_MICROP=1 (bench.py:443)
COUPLED_METRIC_MICROP = ("grid-points/s per chip (full coupled atm_step, "
                         "config-4b aquaplanet, in-plume microphysics ON)")
COUPLED_IMPL = {
    "cuda": "torch+cuda f32 coupled atm_step: fused fft small step (K1-K4 "
            "CUDA), CUDA tracer_div3d, te_map_remap and ZM tail; physics, "
            "coupling and diagnostics in PyTorch; full and prog_only: one "
            "per-dispatch loop (eager builds the diagnostics either way)",
    "cpu": "torch cpu f32 coupled atm_step: the kernels' plain PyTorch "
           "versions"}
COUPLED_IMPL_MICROP = {
    "cuda": "torch+cuda f32 coupled atm_step with ZM's in-plume "
            "microphysics: fused fft small step (K1-K4 CUDA), CUDA "
            "tracer_div3d and te_map_remap; ZM (its tail the plain "
            "evaporation, momtran and convtran under microp, as in the "
            "JAX package), physics, coupling and diagnostics in PyTorch; "
            "full and prog_only: one per-dispatch loop",
    "cpu": "torch cpu f32 coupled atm_step with ZM's in-plume "
           "microphysics: the kernels' plain PyTorch versions"}
IMPL = {"cuda": "torch+cuda f32: fused fft HS step (K1-K4 CUDA), CUDA "
                "tracer_div3d and te_map_remap, CUDA ZM tail",
        "cpu": "torch cpu f32: the kernels' plain PyTorch versions (fused "
               "fft HS step, ZM tail)"}


def grid_from_env(env) -> str:
    """bench.py's grid choice: BENCH_SMALL=1 first, then BENCH_GRID."""
    if env.get("BENCH_SMALL") == "1":
        return "small"
    name = env.get("BENCH_GRID", "f19")
    if name not in ("f19", "f09", "f05"):
        raise ValueError(f"BENCH_GRID must be f19, f09 or f05, got {name!r}")
    return name


def card_label() -> str:
    """`name, power.limit` of the card from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def kernel_times(fn, reps: int = 1):
    """One warm-up call of fn, then `reps` calls under torch.profiler:
    ({device kernel name: [launches recorded, µs]}, wall seconds). The
    profiler drops launches in short windows, at times all of them, so
    the calls sit between PROFILE_PAD spin kernels at each end of the
    window (left out of the table), and a window that recorded no device
    kernel of fn is run again, up to PROFILE_TRIES windows in all."""
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(PROFILE_PAD_CYCLES)
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pad()
        by_name, pads = {}, 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "spin_kernel" in e.name:
                pads += 1
                continue
            n_us = by_name.setdefault(e.name, [0, 0.0])
            n_us[0] += 1
            n_us[1] += e.time_range.elapsed_us()
        if by_name:
            return by_name, wall
        print(f"profiler: no device kernel recorded in window {attempt} "
              f"of {PROFILE_TRIES} ({pads} of {2 * PROFILE_PAD} spin "
              f"kernels)", file=sys.stderr, flush=True)
    raise RuntimeError("the profiler recorded no device time")


def kernel_ident(name: str) -> str:
    """The function name in a device kernel's demangled signature
    ("void (anonymous namespace)::k1_winds_kernel<float>(...)" ->
    "k1_winds_kernel")."""
    m = re.match(r"\s*(?:void\s+)?([\w:]+)",
                 name.replace("(anonymous namespace)::", ""))
    return m.group(1).rsplit("::", 1)[-1] if m else name


def by_origin(times: dict) -> dict:
    """{"port": [launches, µs], "PyTorch": [launches, µs]} of a
    kernel_times table: a kernel is the port's where its name is one that
    csrc/ defines (cuda_build.kernel_names)."""
    ours = cuda_build.kernel_names()
    out = {"port": [0, 0.0], "PyTorch": [0, 0.0]}
    for name, (n, us) in times.items():
        row = out["port" if kernel_ident(name) in ours else "PyTorch"]
        row[0] += n
        row[1] += us
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_fn(fn, args, iters: int, dev: torch.device, passes: int = 3):
    """Seconds per iteration of the chained loop x(n+1) = fn(*x(n)) (fn
    returns a tuple matching its arguments): 2 warm-up calls, then the
    best of `passes` timed passes of `iters` calls (bench.py:32-54)."""
    cur = fn(*args)
    _sync(dev)
    cur = fn(*cur)
    _sync(dev)
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(iters):
            cur = fn(*cur)
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def tensors(tree) -> list:
    """The tensors of a state: dataclasses, dicts, tuples and lists walked
    in order; other values skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in tensors(x)]


def clone_tree(tree):
    """A copy of a state with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: clone_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(x) for x in tree)
    return tree


def bitwise_equal(a, b) -> bool:
    """Every tensor of state a equal to b's, bit for bit."""
    ta, tb = tensors(a), tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype and
        torch.equal(_bits(x), _bits(y)) for x, y in zip(ta, tb))


def _bits(t):
    """t's bit patterns as integers (so -0.0 differs from 0.0 and a NaN
    equals itself)."""
    return t.contiguous().view({8: torch.int64, 4: torch.int32,
                                2: torch.int16, 1: torch.uint8}
                               [t.element_size()])


class ChainGraph:
    """`k` chained steps, carry(n+1) = step(*carry(n)), captured as one CUDA
    graph: bench.py's `lax.fori_loop` per dispatch.

    `static` is a copy of `carry` that holds the graph's input buffers (or
    the caller's `static` carry itself, which several graphs may then
    share). The graph runs the k steps and copies the last step's result
    into those buffers, so each `replay()` advances `static` by k steps in
    place and replays chain as bench.py's donated carries do; the
    copy-back is inside the graph and inside the timed time. A result that
    is its own input buffer (a tensor the step updated in place) needs no
    copy. The step must have run eagerly on the card before (libraries
    loaded, lazy tables built) and may not synchronise with the host or
    copy host memory to the card. Kernel wrappers count their launches
    once at capture, never at replay."""

    def __init__(self, step, carry, k: int, static=None):
        self.k = k
        self.static = clone_tree(carry) if static is None else static
        ins = tensors(self.static)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            cur = self.static
            for _ in range(k):
                cur = step(*cur)
            outs = tensors(cur)
            if [(t.shape, t.dtype) for t in outs] != \
                    [(t.shape, t.dtype) for t in ins]:
                raise ValueError("ChainGraph: the step's result does not "
                                 "match its arguments")
            # a result that is (a view of) another input buffer is copied
            # out first, so the write-back reads no overwritten buffer
            bufs = {t.untyped_storage().data_ptr() for t in ins}
            srcs = [o if o is i or
                    o.untyped_storage().data_ptr() not in bufs
                    else o.clone() for i, o in zip(ins, outs)]
            for i, o in zip(ins, srcs):
                if o is not i:
                    i.copy_(o)

    def replay(self) -> None:
        self.graph.replay()


def chain_graph(step, carry, k: int) -> ChainGraph:
    """A ChainGraph of `k` steps from `carry` whose first replay has been
    held bitwise to k eager steps from the same carry; a difference
    raises (the graph is then not used)."""
    g = ChainGraph(step, carry, k)
    g.replay()
    cur = carry
    for _ in range(k):
        cur = step(*cur)
    torch.cuda.synchronize()
    if not bitwise_equal(g.static, cur):
        raise RuntimeError(f"CUDA graph of {k} steps differs from {k} eager "
                           f"steps")
    return g


def time_chunked(g: ChainGraph, dispatches: int, passes: int = 3):
    """Seconds per step of the chunked loop: one replay (k steps) per
    dispatch, 2 warm-up replays, best of `passes` passes of `dispatches`
    replays (bench.py:64-89)."""
    for _ in range(2):
        g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(dispatches):
            g.replay()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / (dispatches * g.k))
    return best


def check_probe(dev: torch.device) -> None:
    """The probe kernel once on `dev`: raises unless it returns exactly
    2 x its input."""
    x = torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1],
                     dtype=torch.float32).reshape(PROBE_SHAPE) * 0.5 - 7.0
    out = probe(x.to(dev)).cpu()
    if not torch.equal(out, x * 2.0):
        raise RuntimeError("probe kernel: output is not exactly 2 x input")


def phase_times(state, grid, coord, phis, cfg: FVConfig, iters: int,
                dev: torch.device):
    """bench.py's BENCH_PHASES timings (bench.py:550-574), seconds per call:
    cd_step at dt/ns with bench.py's arguments, trac2d with that step's
    Courants and fluxes, te_map of the step's result."""
    from .models.fv.cd_core import cd_step
    from .models.fv.dyn_comp import te_map, trac2d
    im, jm = grid.im, grid.jm
    ns, _, _ = cfg.resolved_splits(DT, im, jm)
    dts = DT / max(ns, 1)

    def f_cd(st):
        return cd_step(st, grid, coord.ptop, phis, dts, iord=cfg.iord,
                       jord=cfg.jord, dyn_filter=True, c_sw_pgf=cfg.c_sw_pgf,
                       ke_method=cfg.ke_method,
                       del2_velocity=cfg.del2coef
                       if cfg.div24del2flag == 42 else 0.0)

    st1, d = f_cd(state)
    t_cd = time_fn(lambda st: (f_cd(st)[0],), (state,), iters, dev)
    t_tr = time_fn(lambda q: (trac2d(q, state.delp, d["cx"], d["cy"],
                                     d["mfx"], d["mfy"], grid, cfg.iord,
                                     cfg.jord)[0],),
                   (state.q,), iters, dev)
    t_te = time_fn(lambda st: (te_map(st, coord, grid, coord.ptop,
                                      kord=cfg.kord, consv=cfg.conserve),),
                   (st1,), iters, dev)
    return ns, t_cd, t_tr, t_te


def roofline_line(name: str, t: float, nbytes: float, ops: float,
                  device_name: str) -> str:
    """bench.py's roofline line (bench.py:100-130) for a step of `t`
    seconds that moves `nbytes` and does `ops` (cost.count_work): the
    achieved rates and, on a card of cost.PEAKS, their shares of its HBM
    and float32 peaks and the resource nearer its peak. A share above 100%
    raises: the count is then wrong. On any other device the line says
    that the device has no peak in the table."""
    line = (f"roofline[{name}]: t={t * 1e3:.2f}ms flops={ops:.3g} "
            f"bytes={nbytes:.3g} -> {ops / t / 1e9:.3g} GF/s")
    gb = nbytes / t / 1e9
    if device_name not in cost.PEAKS:
        return (line + f" / {gb:.3g} GB/s ({device_name} has no peak in "
                f"the table)")
    hbm, fp32 = cost.PEAKS[device_name]
    pct_f, pct_b = 100.0 * ops / t / fp32, 100.0 * nbytes / t / hbm
    if max(pct_f, pct_b) > 100.0:
        raise RuntimeError(f"roofline[{name}]: {pct_f:.1f}% of FP32, "
                           f"{pct_b:.1f}% of HBM: a share above 100% means "
                           f"the count is wrong")
    return (line + f" ({pct_f:.1f}% of FP32) / {gb:.3g} GB/s ({pct_b:.1f}% "
            f"of HBM) bound={'FP32' if pct_f >= pct_b else 'HBM'}")


def run(grid: str = "f19", device="cuda", chunk: int = 8,
        phases: bool = False, roofline: bool = False,
        iters: int | None = None, passes: int = 3) -> dict:
    """The bench at `grid` (a key of GRIDS) on `device`; returns the JSON
    record. `iters` overrides the grid's chained iterations; `roofline`
    prints each step's roofline line (BENCH_ROOFLINE=1)."""
    dev = resolve_device(device)
    im, jm, km, n_iter = GRIDS[grid]
    iters = n_iter if iters is None else iters
    on_card = dev.type == "cuda"
    card = card_label() if on_card else None
    check_probe(dev)

    cfg = FVConfig()
    hs, state, grd, coord, phis = build_step(
        im, jm, km, torch.float32, dev, filter_impl="fft", cfg=cfg)

    def dyn_step(s):
        return (hs(s, grd, coord, phis),)

    # spin a few steps so the timed state has realistic winds
    for _ in range(SPINUP):
        (state,) = dyn_step(state)
    _sync(dev)
    t_dyn = time_fn(dyn_step, (state,), iters, dev, passes)
    graphs = on_card and chunk > 1
    dispatches = max(1, iters // chunk)
    t_dyn_c = (time_chunked(chain_graph(dyn_step, (state,), chunk),
                            dispatches, passes) if graphs else None)

    if phases:
        ns, t_cd, t_tr, t_te = phase_times(state, grd, coord, phis, cfg,
                                           iters, dev)
        print(f"phases: cd_core={t_cd*1e3:.1f}ms x{ns} "
              f"trac2d={t_tr*1e3:.1f}ms te_map={t_te*1e3:.1f}ms",
              file=sys.stderr)

    # ZM physics on the same number of columns (bench.py:576-629)
    zm, pstate, pbuf, _ = build_zm_step(jm * im, km, torch.float32, dev)
    t_zm = time_fn(zm, (pstate, pbuf), iters, dev, passes)
    t_zm_c = (time_chunked(chain_graph(zm, (pstate, pbuf), chunk),
                           dispatches, passes) if graphs else None)

    if roofline:
        # one eager call of each step, outside every timed window, on
        # copies of the timed states
        name = torch.cuda.get_device_name(dev) if on_card else dev.type
        counts = {"dyn_step": cost.count_work(dyn_step, clone_tree(state)),
                  "zm_tend": cost.count_work(zm, clone_tree(pstate),
                                             clone_tree(pbuf))}
        shapes = [("", {"dyn_step": t_dyn, "zm_tend": t_zm})]
        if graphs:
            shapes.append((f" chunked K={chunk}",
                           {"dyn_step": t_dyn_c, "zm_tend": t_zm_c}))
        for label, times in shapes:
            for step, t in times.items():
                print(roofline_line(step + label, t, *counts[step], name),
                      file=sys.stderr)

    npts = im * jm * km
    print(f"phase timings: dyn_step={t_dyn*1e3:.1f}ms "
          f"zm_tend={t_zm*1e3:.1f}ms grid={im}x{jm}x{km} "
          f"device={dev.type} [{card}]", file=sys.stderr)
    total = t_dyn + t_zm
    headline_shape = "per_dispatch"
    total_c = None
    if graphs:
        total_c = t_dyn_c + t_zm_c
        print(f"chunked (K={chunk}): dyn_step={t_dyn_c*1e3:.1f}ms "
              f"zm_tend={t_zm_c*1e3:.1f}ms -> "
              f"{npts / total_c / 1e6:.1f}M gp/s", file=sys.stderr)
        if total_c < total:
            total, headline_shape = total_c, "chunked"
    record = {
        "metric": METRIC,
        "value": npts / total,
        "unit": "gridpoints/s",
        "vs_baseline": 1.0,
        "headline_shape": headline_shape,
        "chunk": chunk if headline_shape == "chunked" else 1,
        "grid": f"{im}x{jm}x{km}",
        "device": "gpu" if on_card else "cpu",
        "t_ms": {"dyn_step": t_dyn * 1e3, "zm_tend": t_zm * 1e3},
        "impl": IMPL[dev.type],
        "card": card,
    }
    if total_c is not None:
        record["t_ms_chunked"] = {"dyn_step": t_dyn_c * 1e3,
                                  "zm_tend": t_zm_c * 1e3}
        record["chunked_k"] = chunk
        record["per_dispatch_gps"] = npts / (t_dyn + t_zm)
        record["chunked_gps"] = npts / total_c
    return record


def time_calls(fn, iters: int, dev: torch.device, passes: int = 3):
    """Seconds per call of fn() on the same arguments: 1 warm-up call,
    then the best of `passes` passes of `iters` calls, synchronised at
    the end of each (bench.py:420-430)."""
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def coupled_phases(model, start, sst, iters: int, dev: torch.device,
                   passes: int = 3) -> dict:
    """bench.py's per-phase table of the coupled step, seconds per call,
    each phase its own dispatch on `start` (bench.py:399-441)."""
    from .models.coupling.dp_coupling import d_p_coupling, p_d_coupling
    from .models.coupling.surface_fluxes import bulk_surface_fluxes
    from .models.fv.dyn_comp import dyn_run
    from .models.physics.physpkg import phys_run1, phys_run2
    m, reg = model, model.registry
    cam_in = bulk_surface_fluxes(start.phys, sst, reg.pcnst)

    def p1():
        return phys_run1(m.phys_cfg, m.zm_cfg, reg, start.phys, start.pbuf,
                         cam_in, m.dt, nstep=1)
    o1 = p1()

    def p2():
        return phys_run2(m.phys_cfg, reg, o1.state, o1.pbuf, cam_in, m.dt)
    o2 = p2()

    def pd():
        return p_d_coupling(start.dyn, o2.state, m.grid, m.coord.ptop, m.dt,
                            reg)
    dyn1 = pd()

    def dyn():
        return dyn_run(dyn1, m.grid, m.coord, start.phis, m.fv_cfg, m.dt,
                       filter_impl=m.filter_impl, return_diags=True)
    dyn2, ddiags = dyn()

    def dp():
        return d_p_coupling(dyn2, m.grid, start.phis, m.coord.ptop, reg,
                            omega=ddiags["omega"])
    return {name: time_calls(fn, iters, dev, passes)
            for name, fn in (("bc_physics", p1), ("ac_physics", p2),
                             ("p_d_coupling", pd), ("dyn", dyn),
                             ("d_p_coupling", dp))}


def run_coupled(grid: str = "f19", device="cuda", chunk: int = 8,
                iters: int | None = None, passes: int = 3,
                microp: bool = False) -> dict:
    """The coupled bench (BENCH_COUPLED=1) at `grid` on `device`; returns
    the JSON record. `iters` overrides the grid's chained steps;
    `microp` is BENCH_MICROP=1 (ZMConfig(microp=True))."""
    dev = resolve_device(device)
    im, jm, km, _ = GRIDS[grid]
    iters = COUPLED_ITERS[grid] if iters is None else iters
    on_card = dev.type == "cuda"
    card = card_label() if on_card else None
    check_probe(dev)

    model, step, state, sst = build_coupled(im, jm, km, torch.float32, dev,
                                            microp=microp)

    def prog_only(s):
        return (step(s)[0],)

    state, _, _ = step(state, first_step=True)
    (start,) = prog_only(state)
    _sync(dev)
    del state
    # full and prog_only: one loop, reported under both keys
    t_step = time_fn(prog_only, (start,), iters, dev, passes)
    t_chunked = None
    if on_card and chunk > 1:
        t_chunked = time_chunked(chain_graph(prog_only, (start,), chunk),
                                 max(1, iters // chunk), passes)
        torch.cuda.empty_cache()
    phases = coupled_phases(model, start, sst, iters, dev, passes)

    npts = im * jm * km
    shapes = {"full": t_step, "prog_only": t_step}
    if t_chunked is not None:
        shapes["chunked"] = t_chunked
    shape = min(shapes, key=shapes.get)
    print(f"coupled: per dispatch (full = prog_only)={t_step*1e3:.1f}ms "
          + (f"chunked(K={chunk})={t_chunked*1e3:.1f}ms "
             if t_chunked is not None else "")
          + f"grid={im}x{jm}x{km} device={dev.type} [{card}]",
          file=sys.stderr)
    print("phase table (independent dispatches, incl. per-dispatch "
          "latency): " + " ".join(f"{k}={v*1e3:.1f}ms"
                                  for k, v in phases.items()),
          file=sys.stderr)
    record = {
        "metric": COUPLED_METRIC_MICROP if microp else COUPLED_METRIC,
        "value": npts / shapes[shape],
        "unit": "gridpoints/s",
        "vs_baseline": 1.0,
        "headline_shape": shape,
        "chunk": chunk if shape == "chunked" else 1,
        "grid": f"{im}x{jm}x{km}",
        "device": "gpu" if on_card else "cpu",
        "t_ms": {"full": t_step * 1e3, "prog_only": t_step * 1e3},
        "t_ms_phases_independent_dispatch":
            {k: v * 1e3 for k, v in phases.items()},
        "impl": (COUPLED_IMPL_MICROP if microp else COUPLED_IMPL)[dev.type],
        "card": card,
    }
    if t_chunked is not None:
        record["t_ms"]["chunked_per_step"] = t_chunked * 1e3
        record["chunked_k"] = chunk
    return record


def main(env=None) -> dict:
    """Reads bench.py's environment variables, runs the bench, prints the
    JSON line and returns the record."""
    env = os.environ if env is None else env
    roofline = env.get("BENCH_ROOFLINE") == "1"
    device = "cpu" if env.get("BENCH_CPU") == "1" else "cuda"
    chunk = int(env.get("BENCH_CHUNK", "8"))
    if env.get("BENCH_COUPLED") == "1":
        if roofline:
            raise ValueError(
                "BENCH_COUPLED=1 with BENCH_ROOFLINE=1: the coupled step has "
                "no roofline count yet (bench.py ignores BENCH_ROOFLINE "
                "there); unset one of the two")
        record = run_coupled(grid=grid_from_env(env), device=device,
                             chunk=chunk,
                             microp=env.get("BENCH_MICROP") == "1")
    else:
        record = run(grid=grid_from_env(env), device=device, chunk=chunk,
                     phases=env.get("BENCH_PHASES") == "1",
                     roofline=roofline)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
