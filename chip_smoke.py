#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives cam_nor_physics_tpu_torch only (never the JAX package):

1. names the card (torch and nvidia-smi: name, power limit);
2. builds the six CUDA libraries from csrc/ (one nvcc per source,
   together) and the driver's two native writers from native/ (g++, at
   the same time), and holds the probe kernel (the bench's health check) on
   one seeded (8, 128) block to exactly 2 x its input (float32, float64);
   times it, its plain version and torch.mul in turns (3 rounds of
   library, kernel, plain, plain, kernel, library; 200 calls a turn; the
   median of each one's turns), with each one's device time a call from
   torch.profiler beside it;
3. holds each kernel against its plain PyTorch version on the card, at the
   f19 (144x96x26) shapes and on inputs captured from real Held-Suarez
   steps: the unfused step's Courants and fluxes (filter_impl="matmul"),
   the fused step's K1-K4 inputs (filter_impl="fft"), the pe sets of
   te_map; plus stress cases that force the FFSL branch near the poles
   (transport3d, vort_flux3d, tracer_div3d, K1, K3, K4) and K2/K4 with the
   polar filter off, K4 with the avg_sq KE and del4 damping, K3 at
   order 1 and tracer_div3d with FFSL rows and a polar band; float32
   within 1e-5 and float64 within 1e-12 of each output's max magnitude,
   and K1, K2, K3, te_map_remap, vort_flux3d and (in float32)
   transport3d and tracer_div3d bitwise (max abs error 0);
4. runs both HS paths, build_step(144, 96, 26, float32, "cuda",
   filter_impl=...) for 4 large steps (2 model hours) each, with the
   launch counts set to 0 just before and read just after: the unfused
   "matmul" step launches transport3d (8 calls a step of 4 row kernels)
   and vort_flux3d (4 calls of 1; stencil_kernels.LAUNCHES_PER_CALL),
   the fused "fft" step (the default, the JAX package's) K1-K4, 4 calls
   per step of
   cd_fused_kernels.launches_per_call launches each (K1 6, K2 5, K3 5,
   K4 6 with the polar filter), and no transport3d or vort_flux3d; both
   call tracer_div3d (3 launches, stencil_kernels.LAUNCHES_PER_CALL) and
   te_map_remap once a step. Each path: finite
   fields, global dry-mass drift <= 1e-5, and agreement with the same 4
   steps run through the plain versions on the card: ps, pt, u, v and q
   each within 1e-3 of the field's max, or within twice the spread that
   one float32 ulp of pt makes in the plain run over those steps where
   that is larger (float64: within 1e-9). Then one float64 small step of
   the fused path against the unfused formulation (cd_step fused=False)
   from the same state, within 1e-7 of each field's max
   (tests/test_cd_pallas.py);
5. times each kernel and its plain version (CUDA events) and both steps,
   te_map_remap's device time too (torch.profiler);
   K1's, K2's, K3's, K4's, transport3d's and tracer_div3d's device
   time split by the
   kernels they launch (torch.profiler): the column passes and row
   kernels against K2's and K4's two DFT products, and the products' rate
   on their own work;
6. holds the fused ZM tail kernel (zm_tail) against its plain version
   (zm_tail_ref) at f19's 13,824 columns x 26 levels, on the inputs the
   port's own zm_convr gives it on entry.varied_zm_inputs (bench.py's
   sounding with per-column noise, winds, cloud tracers and fraction,
   land/ocean, every fourth column stable; seed 0): float32 within 1e-5,
   float64 within 1e-12 of each output's max (a surface rate, prec or
   snow, that is 0 everywhere in the plain version: of its column flux's
   max / 1000); the largest absolute error is printed beside each gate,
   and whether it is 0;
7. runs the ZM step, build_zm_step(13824, 26, float32, "cuda"), once on
   those inputs with the launch counts set to 0 just before and read just
   after: exactly 1 zm_tail launch and 2 zm_parcel launches (zm_convr's
   two parcel calls), a triggered share strictly inside
   (0, 1), finite fields; then zm_conv_tend through the kernel against the
   same call through the plain tail, float32 and float64, on the ptend's
   s, u, v and q per species and the pbuf stores PREC_DP, SNOW_DP,
   DP_FLXPRC, DP_FLXSNW and NEVAPR_DPCU, with the gates of item 6;
8. times zm_tail and zm_tail_ref (CUDA events; zm_tail's device time by
   torch.profiler), zm_conv_tend per call
   (host clock, synchronised, mean of 3 after 1 warm-up) and zm_convr's
   share of it (timed inside 3 more calls),
   and the main path's grid points per second,
   144*96*26 / (fused HS large step + ZM step), as bench.py's headline
   (the unfused step's time printed beside it);
9. runs each HS large step and the ZM step once more under
   torch.profiler and prints the device kernels each launched,
   the device's busy time (the kernels' summed durations: one stream, so
   they do not overlap) and its share of the wall time, and the kernels
   that took the most device time;
10. captures the bench's CUDA graphs at f19, K = 8 chained steps a
    replay, of the HS large step (FVConfig(), after the bench's 3 spin-up
    steps) and of the ZM step (build_zm_step, bench.py's sounding): the
    launches counted at capture must be 8 times one eager step's and a
    replay must count none; replays 1 and 2 must be bitwise equal to eager
    steps 1-8 and 9-16 from the same state (the ZM state and its pbuf);
11. runs the bench's HS step at f09 (288x192x26) and f05 (576x384x32)
    with FVConfig()'s auto splits, (8, 2, 1) and (16, 4, 1): 3 steps
    through the kernels with exact launch counts, finite fields and
    dry-mass drift <= 1e-5; then one call each of K1-K4, tracer_div3d and
    te_map_remap, on the inputs of the next step, against its plain
    version (float32 gate of item 3; te_map_remap in float64 too) and
    timed beside its bound, with
    K1-K4's share of the step by kernel, and the splits of item 5; K1 and
    tracer_div3d also with FFSL rows forced and tracer_div3d with a polar
    band, and at f05 K3 with FFSL rows forced and K2 with the filter off
    (float32, bitwise); then the unfused "matmul" HS step with the same
    splits: one step through the kernels with exact launch counts, finite
    fields and dry-mass drift <= 1e-5, and on the inputs of the next step
    transport3d (iord 1 and 4) and vort_flux3d against their plain
    versions (float32 gate of item 3), plain and with FFSL rows forced,
    timed beside their bounds, transport3d's device time split by its row
    kernels; then zm_tail against zm_tail_ref on the inputs the
    port's zm_convr gives it on entry.varied_zm_inputs at the grid's
    columns and levels (f09 55,296 x 26, f05 221,184 x 32, the bench's ZM
    step there), float32 gate of item 6, timed beside its bound;
12. runs the port's bench (cam_nor_physics_tpu_torch.bench.run) at f19
    once, with the launch counts set to 0 just before and read just
    after: the probe exactly once, every kernel of the fused path at
    least once; prints its JSON line;
13. drives the coupled atm_step at f19 in the bench's coupled
    configuration (entry.build_coupled: gray radiation, ZM, vertical
    diffusion, the FV dycore with FVConfig()'s splits, aquaplanet bulk
    fluxes), float32: the first step and 3 more, eager, with the launch
    counts set to 0 before each step and read after it: K1-K4,
    tracer_div3d, te_map_remap, zm_tail and zm_parcel each exactly as one
    HS step and one ZM step launch them, transport3d and vort_flux3d
    never;
    every tensor of the state finite and the dry-air mass (cos-lat
    weighted delp (1 - q), tests/test_atm_comp.py:48-65) within 1e-5 of
    the step before; the energy fixer's EFIX range printed per step, and
    for the same 4 steps in float64 through the kernels; the first step
    and one more in float64 through the
    kernels and through their plain versions (all eight sites routed),
    each dycore and physics field within 1e-9 of its max, with the count
    of columns whose ZM trigger or level indices differ printed; a CUDA
    graph of 8 prog_only steps (bench.chain_graph: its first replay
    bitwise equal to 8 eager steps, launches counted at capture only);
    times a step per dispatch (full and prog_only are one computation in
    eager PyTorch), as a graph, the bench's phase table, the device
    kernels a step (the port's and PyTorch's) and the device's busy share
    under torch.profiler; then one step at f09 (nspltrac 2: two trac2d
    calls) with exact launch counts, finite fields and the drift gate;
14. drives the port's run driver (driver.run, run_coupled) at f19 in
    float32 in entry.build_coupled's configuration, with the fixed CamIn
    of bulk_surface_fluxes(state0.phys, sst) for run, the launch counts
    set to 0 before each run and read after it: (a) 16 steps at chunk 1
    with history, checkpoints and sentinels every 8 steps: both tapes
    open with scipy, every field finite, ckpt_000008 and ckpt_000016
    written, launches 16 coupled steps' exactly, both writers native;
    (b) the same at chunk 8 (the first step eager, then CUDA graphs of 7
    and 8 steps, each first replay held bitwise to the same steps run
    eagerly; launches 1 + 2 x 15 steps'): the state and every tape array
    bitwise equal to (a)'s; (c) a resume from (a)'s ckpt_000008 on a
    zeroed template, 8 steps as one graph, bitwise equal to (a) after
    step 16; then the same resume for 40 steps to time the replays and
    the boundaries; (d) a NaN put into dyn.u of the step-8 state, chunk
    8: BlowupError, and ABORT.json with exact true, failed_step 1 and
    the last good checkpoint; (e) run_coupled for 4 steps with history
    every 2: finite, dry-mass drift within 4 x 1e-5; prints the phase
    tables, ms a step of both loop shapes beside phase 13's coupled step,
    the tape and checkpoint sizes;
15. drives the coupled step with ZM's in-plume microphysics
    (entry.build_coupled(microp=True), bench.py's BENCH_MICROP=1) at f19,
    float32: the first step and 3 more with exact launch counts (those of
    item 13 but zm_tail 0: the plain tail runs under microp, as in the
    JAX package), finite tensors, the drift gate, ZMFRZ and ZMDCAPE
    finite and not all zero; the first step and one more in float64
    through the kernels and the plain versions, within 1e-9, with ZM
    trigger and index flips counted; one profiled step (device kernels by
    origin, busy share); two steps of the aerosol configuration
    (aerosol=True: one modal mode): NAER, DGNUMWET and the AOD family
    finite and positive, the first step's droplet number 0 (the
    registration's zero NAER), the second's different from the run
    without aerosol; the driver with microp, 16 steps at chunk 1 and at
    chunk 8 (two captures, each first replay held bitwise to eager
    steps): launches exact, state and both tapes bitwise equal, the
    microp fields on the tape and finite; ms a step per dispatch and as
    the 8-step graph's first replay;
16. drives the model's other modes at f19 (ModesSmoke): (A) the JW06
    baroclinic wave (jw_baroclinic_wave, perturbed) for 8 dyn_run steps
    in float32 with FVConfig(am_fixer, am_fix_taper, am_diag), launches
    exact each step, AM_DU3S/AM_DUFIX/AM_TOTAL finite, the relative AM
    drift with the fixer smaller than without, an 8-step CUDA graph held
    bitwise to eager steps, 2 float64 steps kernels vs plain within 1e-9;
    (B) one float64 small step with am_correction over a mountain after 2
    spin-up steps: |AM_after - AM_before - dt torque| under a quarter of
    the uncorrected (tests/test_am_flags.py); (C) high_altitude with the
    species O, O2, H on four tracers, float64, 2 steps kernels vs plain
    within 1e-9, tracer_div3d fed nq + 1 = 5 tracers; (D) the coupled
    step with Rayleigh friction and the TEM diagnostics
    (build_coupled(raytau0=5, do_circulation_diags=True)): item 13's
    checks for 3 steps, the TEM fields finite, its 8-step graph bitwise,
    2 float64 steps kernels vs plain with flips counted; (E)
    cd_step(return_debug=True): the unfused step (transport3d and
    vort_flux3d launch), its state bitwise that of return_debug=False,
    the debug terms finite; (F) (A)'s float64 state through an IC file
    (write_inidat, read_inidat onto the card: u, v, q and phis bitwise,
    delp and pt within 1e-13) and a dyn_run from it against one from the
    state in memory within 1e-9; three of (A)'s states as a met file,
    offline_dyn_run through it for 8 steps on the card and on the CPU in
    float64 within 1e-12; (G) zm_tail against its plain version at 1 and
    16 columns (float32, float64), then scam_run_iop on 16 columns for 48
    steps (a simulated day; an IOP file of 9 records) in float32, exactly
    one zm_tail and two zm_parcel launches a step, and in float64 on the
    card against the
    CPU within 1e-9 with ZM trigger flips counted; ms a step of each;
17. the transport orders beside 1 and 4, latitude strips and a world of
    one (OrdersSmoke): (a) transport3d, vort_flux3d, tracer_div3d, K3
    and K4 on their captured main-path inputs and with FFSL rows forced,
    at iord/jord 2, 3, 5, 6, 7, -2 and (3, 5), (6, 2): float32 bitwise
    to the plain version, float64 within 1e-12; each timed at orders 1,
    4 and the others (events and device time); 4 float64 HS steps at (3, 3) and (6, 2) on both
    paths, launches as item 4's, kernels vs plain within 1e-9; (b) the
    three stencils on the strips of 2, 4 and 8 ranks (halos cut from the
    whole slab, parallel/shard_stencil.strip_call) reassembled, bitwise
    to the whole slab in float32 and float64; (c) ensure_initialized
    over NCCL with one rank, an all_reduce, then dyn_run and the coupled
    atm_step on make_mesh(1), bitwise to no mesh with equal launches;
18. the repo's long runs and the roofline at f19, float32, one step a
    dispatch (cam_nor_physics_tpu_torch/tools/): (a) hs_climate for 60
    days with 20 of spin-up at FVConfig() (flag 22): u finite at every
    96-step check, max|u| below driver.UMAX_GUARD (300 m/s) and all six
    HS94 checks ok; (b) the damping-flag ladder, hs_climate for 20 days
    with 10 of spin-up at flags 2, 4, 24 and 42: flag 42 finite through
    day 20 (22 is (a)), the blow-up day of 2, 4 and 24 (or none) printed
    beside VALIDATION.md's 14, 8 and 14, not gated (float32 on another
    chip is chaotic); (c) jw06_envelope, the nine-day JW06 wave at flag
    2, within tests/test_baroclinic_wave.py's envelope, its day-9 ps_min
    beside VALIDATION.md's 967.1 hPa, and the 12-day jw_baroclinic
    series at FVConfig() beside VALIDATION.md's 992.5 hPa on day 9, not
    gated; (d) the port's bench at f19 with the roofline on
    (bench.run(roofline=True)): a roofline line for dyn_step and zm_tend
    per loop shape, every share at most 100%; (e) ops/cost.py's count of
    the bench's HS step and of the ZM step on 1,728 columns on the card
    and on the CPU from the same state: the same bytes, operations within
    1e-6 (FFSL sums are data dependent), the HS step's bytes at least
    its kernels' work;
19. holds ZM's parcel kernel (zm_parcel) against its plain version
    (zm_parcel_ref, the port's buoyan_dilute) on the arguments of
    zm_convr's two calls on entry.varied_zm_inputs at f19's, f09's and
    f05's columns, float32 and float64: each field's largest error and
    the columns whose trigger (cape > capelmt, cin < cin_threshd cape),
    lcl, lel or mx differ, with their CAPE and CIN margins; each timed
    (CUDA events, the device time by torch.profiler) beside its plain
    version and its bound; then zm_convr in the coupled step at f19
    (entry.build_coupled, the aqua cell's configuration) at its first
    step and after 48 steps, through the kernel and through the plain
    version: ideep, maxg, lcl and lel flips. Each field within 1e-12
    (float64) or 1e-5 (float32) of its max in the columns whose lcl, lel
    and mx agree; float64: no flip; float32: a flip only where the CAPE
    or CIN margin is within 1e-5 of its threshold;
20. prints the kernels JSON line (eleven kernels), the card's name and
    power limit, then {"ok": true, "device": {...}} last. Every phase
    prints its wall time.

`python3 chip_smoke.py --phase 16` (or 17, 18, 19) builds the kernels
and runs that phase alone (no result line).

Exits non-zero, printing no result, without a CUDA device, outside a
checkout of the repo, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
TOL = {"float32": 1e-5, "float64": 1e-12}
# kernels held bitwise to their plain versions, and in which dtypes
# (tracer_div3d and transport3d within TOL in float64: their caps sum a
# float64 row in index order, torch.sum in another, and the two differ by
# an ulp at times; K1 and K3 add that increment to delp and pt, which has
# hidden it on the card's inputs)
BOTH = ("float32", "float64")
EXACT = {"k1": BOTH, "k2": BOTH, "k3": BOTH, "tracer_div3d": ("float32",),
         "te_map_remap": BOTH, "transport3d": ("float32",),
         "vort_flux3d": BOTH}
# kernels whose device time is split by kernel
SPLIT = ("k1", "k2", "k3", "k4", "transport3d", "tracer_div3d")
DRIFT_TOL = 1e-5
PLAIN_TOL = 1e-3          # float32, ROADMAP.md R2 ...
PLAIN_SPREAD = 2.0        # ... or this many times the one-ulp spread (R2b)
PLAIN_TOL_F64 = 1e-9      # float64: roundoff amplified through 16 small steps
FUSED_TOL = 1e-7          # float64 fused vs unfused cd_step (R2)

NCOL = IM * JM                     # ZM columns: f19's 13,824
ZM_DT = 1800.0
ZM_CALLS = 3                       # timed zm_conv_tend calls after 1 warm-up

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
    ("zm_parcel", "cam_nor_physics_tpu_torch/csrc/zm_parcel_kernels.cu",
     "none: the JAX package's buoyan_dilute is jnp "
     "(cam_nor_physics_tpu/models/physics/zm_conv.py)"),
    ("k1", "cam_nor_physics_tpu_torch/csrc/cd_fused_kernels.cu",
     "cam_nor_physics_tpu/models/fv/cd_pallas.py:224"),
    ("k2", "cam_nor_physics_tpu_torch/csrc/cd_fused_kernels.cu",
     "cam_nor_physics_tpu/models/fv/cd_pallas.py:265"),
    ("k3", "cam_nor_physics_tpu_torch/csrc/cd_fused_kernels.cu",
     "cam_nor_physics_tpu/models/fv/cd_pallas.py:312"),
    ("k4", "cam_nor_physics_tpu_torch/csrc/cd_fused_kernels.cu",
     "cam_nor_physics_tpu/models/fv/cd_pallas.py:345"),
    ("probe", "cam_nor_physics_tpu_torch/csrc/probe_kernels.cu",
     "bench.py:133"),
)
FUSED = ("k1", "k2", "k3", "k4")
PROBE_CALLS = 200          # back-to-back probe calls a timing turn
PROBE_ROUNDS = 3           # rounds of its six interleaved turns
GRAPH_K = 8                # steps per CUDA-graph replay, as the bench's chunk
COUPLED_STEPS = 3          # coupled steps after the first, counted
COUPLED_F64_STEPS = 2      # float64 coupled steps, kernels vs plain
COUPLED_TOL_F64 = 1e-9     # float64 coupled step, kernels vs plain
COUPLED_TIMED = 3          # coupled steps timed per dispatch
DRIVER_STEPS = 16          # phase 14: steps of the driver's runs
DRIVER_CHUNK = 8           # steps a CUDA graph in the driver's chunked loop
DRIVER_LONG = 40           # steps of the resumed run that times replays
BEYOND = ("f09", "f05")    # the bench's grids beyond f19
# repetitions of each kernel (and of its plain version) timed there
BEYOND_REPS = {"f09": (20, 3), "f05": (10, 2)}
PARCEL_STEPS = 48         # coupled steps before the second flip count
PARCEL_MARGIN = 1e-5      # a float32 flip's CAPE or CIN margin, relative
# repetitions of zm_parcel and of zm_parcel_ref timed at each grid
PARCEL_REPS = {"f19": (50, 3), "f09": (20, 2), "f05": (10, 1)}
# calls in a profiled window of zm_parcel (its device mean at every grid)
PARCEL_PROFILE_REPS = 100



def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    """Logs the wall time of the block."""
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s wall")


def parcel_launches(torch, cfg, km: int) -> int:
    """zm_parcel's launches in one zm_convr call on the card at km levels:
    one for each parcel call (two with second_call) where the kernel
    takes it."""
    from cam_nor_physics_tpu_torch.ops import zm_parcel_kernels
    t = torch.empty((1, km), device=DEVICE)
    return (2 if cfg.second_call else 1) \
        if zm_parcel_kernels.takes(cfg, t) else 0


class Smoke:
    def __init__(self, torch, card: str):
        import cam_nor_physics_tpu_torch.models.fv.cd_core as cd_core
        import cam_nor_physics_tpu_torch.models.fv.cd_fused as cd_fused
        import cam_nor_physics_tpu_torch.models.fv.dyn_comp as dyn_comp
        from cam_nor_physics_tpu_torch.ops import (cd_fused_kernels, cost,
                                                   remap_kernels,
                                                   stencil_kernels)
        self.torch = torch
        self.card = card
        self.cost = cost
        self.cd_fused = cd_fused
        self.sk = stencil_kernels
        self.dyn_comp, self.ck = dyn_comp, cd_fused_kernels
        # where the main path looks each kernel's wrapper up (cd_step_fused
        # calls K1-K4 as attributes of their module)
        self.sites = {"transport3d": (cd_core, stencil_kernels),
                      "vort_flux3d": (cd_core, stencil_kernels),
                      "tracer_div3d": (dyn_comp, stencil_kernels),
                      "te_map_remap": (dyn_comp, remap_kernels)}
        self.sites.update({k: (cd_fused_kernels, cd_fused_kernels)
                           for k in FUSED})
        self.kernels = {n: getattr(m, n) for n, (_, m) in self.sites.items()}
        from cam_nor_physics_tpu_torch.ops import (probe_kernels,
                                                   zm_parcel_kernels,
                                                   zm_tail_kernels)
        # every kernel wrapper with a launch count
        self.counted = dict(self.kernels, zm_tail=zm_tail_kernels.zm_tail,
                            zm_parcel=zm_parcel_kernels.zm_parcel,
                            probe=probe_kernels.probe)

    def zero_counts(self):
        for fn in self.counted.values():
            fn.launches = 0

    def counts(self) -> dict:
        return {n: fn.launches for n, fn in self.counted.items()}

    def kernel(self, name):
        return self.kernels[name]

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
        the HS paths run: transport3d at iord 1 (C half step) and 4
        (D step), the last call of each."""
        out = []
        for name, lst in calls.items():
            if not lst:
                raise RuntimeError(f"{name}: no call captured")
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
        jm-4..jm-2 so the FFSL branch (integer-Courant sums) runs there
        (K1, whose Courants come from the winds: u raised by 150 m/s
        there). Returns (args, kwargs, FFSL rows)."""
        torch = self.torch
        a = list(a)
        jm = a[0].shape[-2]
        rows = list(range(1, 4)) + list(range(jm - 4, jm - 1))

        def raised(x, by):
            x = x.clone()
            x[:, rows] = x[:, rows] + torch.where(x[:, rows] >= 0, by, -by)
            return x

        if name == "k1":
            a[0] = raised(a[0], 150.0)
            c0 = self.cost.fused_courant(a[0], a[1], a[4], a[5])
            return tuple(a), kw, int(self.cost.ffsl_rows(c0, a[-1]).sum())
        at = {"transport3d": (2, 6), "vort_flux3d": (1, 5),
              "tracer_div3d": (1, 6), "k3": (2, None), "k4": (6, None)}
        ic, iflag = at[name]
        a[ic] = raised(a[ic], 1.5)
        ffsl = torch.amax(torch.abs(a[ic]), dim=-1) > 1.0
        if iflag is not None:
            a[iflag] = ffsl
        return tuple(a), kw, int(ffsl.sum())

    def variants(self, name, a, kw, grid):
        """(label, args, kwargs) of K2 and K4 with the polar filter off; K4
        with the avg_sq KE and del4 divergence damping (div4_coef_nd =
        0.02) as well; K3 at iord = jord = 1 and tracer_div3d with FFSL
        rows forced and a polar band of 3 rows (rows 3 and jm-4 keep their
        flag but not the branch)."""
        a = list(a)
        if name == "k2":
            a[10] = False
            return [("k2[filter off]", tuple(a), kw)]
        if name == "k3":
            sa = list(self.stressed(name, a, kw)[0])
            sa[5], sa[6], sa[9] = 1, 1, 3
            return [("k3[order 1,ffsl,band 3]", tuple(sa), kw)]
        if name == "tracer_div3d":
            sa, skw, _ = self.stressed(name, a, kw)
            return [("tracer_div3d[ffsl,band 3]", sa, dict(skw, band=3))]
        if name != "k4":
            return []
        dt = a[12]
        nu4 = 0.02 / dt
        a[9] = self.cd_fused._metric_rows(grid.cosp, grid.acosp, grid.cose,
                                          grid.f0, grid.fc, grid.dl, grid.dp,
                                          nu4)
        a[17], a[19], a[21] = "avg_sq", nu4, False
        return [("k4[avg_sq,del4,filter off]", tuple(a), kw)]

    def cast(self, a, kw, dtype):
        torch = self.torch

        def f(x):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                return x.to(dtype).contiguous()
            if isinstance(x, (list, tuple)):
                return type(x)(f(y) for y in x)
            return x
        return tuple(f(x) for x in a), {k: f(v) for k, v in kw.items()}

    @staticmethod
    def flat(out):
        res = []
        for x in (out if isinstance(out, (tuple, list)) else (out,)):
            res.extend(Smoke.flat(x) if isinstance(x, (tuple, list)) else [x])
        return res

    def compare(self, label, name, a, kw, dtype_name, exact=None):
        """The kernel against its plain version: bitwise where `exact`
        (by default where EXACT says), else within TOL."""
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
        if exact is None:
            exact = dtype_name in EXACT.get(name, ())
        ok = abs_err == 0.0 if exact else rel <= TOL[dtype_name]
        log(f"check {label:<24} {dtype_name}: max_abs_err={abs_err:.3e} "
            f"max_rel_err={rel:.3e} tol="
            + ("bitwise" if exact else f"{TOL[dtype_name]:.0e}")
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label} {dtype_name}: kernel disagrees with "
                               f"its plain version ({abs_err:.3e} abs, "
                               f"{rel:.3e} rel)")
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

    def hs_path(self, impl, step, state0, grid, coord, phis, expect):
        """Phase 4 for one HS path: NSTEPS large steps through the kernels
        with the launch counts set to 0 just before and read just after
        (each must equal `expect`), finite fields, the dry-mass drift, and
        the per-field gate against the same steps through the plain
        versions, in float32 and float64."""
        torch = self.torch
        for name in self.sites:
            self.kernel(name).launches = 0
        state, step_s = self.run_steps(step, state0, grid, coord, phis)
        torch.cuda.synchronize()
        launches = {n: self.kernel(n).launches for n in self.sites}
        log(f"main path ({impl}): {NSTEPS} HS large steps at {IM}x{JM}x{KM} "
            f"float32, launches {launches} [{self.card}]")
        if launches != expect:
            raise RuntimeError(f"{impl} path launched {launches}, expected "
                               f"{expect}")
        for f in ("u", "v", "pt", "delp", "q"):
            if not bool(torch.isfinite(getattr(state, f)).all()):
                raise RuntimeError(f"{impl}: non-finite {f} after {NSTEPS} "
                                   f"steps")
        m0, m1 = self.dry_mass(grid, state0), self.dry_mass(grid, state)
        drift = abs(m1 - m0) / m0
        log(f"{impl}: dry-mass drift over {NSTEPS} steps: {drift:.3e} "
            f"(tol {DRIFT_TOL:.0e})")
        if drift > DRIFT_TOL:
            raise RuntimeError(f"{impl}: dry-mass drift {drift:.3e} > "
                               f"{DRIFT_TOL}")
        with self.routed(self.plain):
            ref, ref_s = self.run_steps(step, state0, grid, coord, phis)
            # how far float32 roundoff alone carries in 4 steps: the plain
            # run again from pt changed by one ulp
            nudged = state0.replace(pt=state0.pt * (1.0 + 2.0 ** -23))
            ref_n, _ = self.run_steps(step, nudged, grid, coord, phis)
        ulp = self.parity(ref_n, ref, coord)
        log(f"{impl}: plain run vs plain run from pt nudged by one float32 "
            "ulp: " + ", ".join(f"{k} {v:.3e}" for k, v in ulp.items()))
        parity = self.parity(state, ref, coord)
        ptol = {f: max(PLAIN_TOL, PLAIN_SPREAD * ulp[f]) for f in parity}
        log(f"{impl}: kernels vs plain versions after the same steps (rel. "
            "to max): " + ", ".join(f"{k} {v:.3e} (tol {ptol[k]:.2e})"
                                    for k, v in parity.items()))
        bad = {f: e for f, e in parity.items() if e > ptol[f]}
        if bad:
            raise RuntimeError(f"{impl}: slice disagrees with its plain run: "
                               f"{bad}")
        # the same comparison in float64
        from cam_nor_physics_tpu_torch.entry import build_step
        step64, s64, grid64, coord64, phis64 = build_step(
            IM, JM, KM, torch.float64, DEVICE, filter_impl=impl)
        s64 = s64.replace(q=state0.q.double())
        k64, _ = self.run_steps(step64, s64, grid64, coord64, phis64)
        with self.routed(self.plain):
            r64, _ = self.run_steps(step64, s64, grid64, coord64, phis64)
        parity64 = self.parity(k64, r64, coord64)
        log(f"{impl}: float64: kernels vs plain versions after the same "
            "steps: " + ", ".join(f"{k} {v:.3e}" for k, v in parity64.items())
            + f" (tol {PLAIN_TOL_F64:.0e})")
        if max(parity64.values()) > PLAIN_TOL_F64:
            raise RuntimeError(f"{impl}: float64 slice disagrees with its "
                               f"plain run: {parity64}")
        steady = sum(step_s[1:]) / (len(step_s) - 1)
        log(f"{impl}: step time [{self.card}]: kernels "
            + ", ".join(f"{1e3 * t:.2f}" for t in step_s)
            + f" ms (mean of steps 2-{NSTEPS}: {1e3 * steady:.2f} ms); plain "
            + ", ".join(f"{1e3 * t:.2f}" for t in ref_s) + " ms")
        return {"launches": launches, "steady": steady,
                "f64_state": (k64, grid64, coord64, phis64)}

    def fused_vs_unfused(self, f64):
        """One float64 small step from the fused path's state after its
        steps, as dyn_run calls cd_step, through the fused K1-K4 and
        through the unfused formulation (fused=False): each field within
        FUSED_TOL of its max."""
        torch = self.torch
        state, grid, coord, phis = f64
        from cam_nor_physics_tpu_torch.utils.config import FVConfig
        seen = []
        orig = self.dyn_comp.cd_step

        def rec(*a, **kw):
            seen.append((a, kw))
            return orig(*a, **kw)

        self.dyn_comp.cd_step = rec
        try:
            self.dyn_comp.dyn_run(state, grid, coord, phis,
                                  FVConfig(nsplit=4, nspltrac=1), 1800.0,
                                  filter_impl="fft")
        finally:
            self.dyn_comp.cd_step = orig
        a, kw = seen[0]
        new, d = orig(*a, **kw)
        ref, rd = orig(*a, **kw, fused=False)
        torch.cuda.synchronize()
        err = {f: float((getattr(new, f) - getattr(ref, f)).abs().max()
                        / getattr(ref, f).abs().max())
               for f in ("u", "v", "pt", "delp")}
        err.update({f: float((d[f] - rd[f]).abs().max() / rd[f].abs().max())
                    for f in ("cx", "cy", "mfx", "mfy", "pe", "pkz", "wz")})
        worst = max(err, key=err.get)
        log("float64 small step, fused vs unfused cd_step: "
            + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
            + f" (tol {FUSED_TOL:.0e})")
        if err[worst] > FUSED_TOL:
            raise RuntimeError(f"fused and unfused cd_step disagree: {err}")

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

    def work(self, name, a, kw):
        """(bytes moved, operations) the call needs (cost.kernel_work: each
        input read once, each output written once; operations from the
        per-point counts)."""
        out = self.kernel(name)(*a, **kw)
        return self.cost.kernel_work(name, a, kw, out)

    def filter_ops(self, name, a):
        """K2's or K4's polar filter: (what the function needs, what the
        kernel's dense DFT sums do), cost.filter_ops."""
        dft, on = {"k2": (7, 10), "k4": (11, 21)}[name]
        return self.cost.filter_ops(name, a[0].shape, a[dft], a[on])

    def split(self, name, label, a, kw, reps):
        """A kernel's device time a call split by the kernels it launches
        (torch.profiler, each kernel's mean over the launches it
        recorded): the column passes and row kernels against K2's and K4's
        two DFT products, and the products' rate on their own work (16 km
        jm nf im operations, a multiply and an add a term)."""
        from cam_nor_physics_tpu_torch.bench import kernel_times
        times, _ = kernel_times(lambda: self.kernel(name)(*a, **kw), reps)
        mean_ms = {n: us / c / 1e3 for n, (c, us) in times.items()}
        dft_ms = sum(t for n, t in mean_ms.items() if "dft_" in n)
        level_ms = sum(t for n, t in mean_ms.items() if "dft_" not in n)
        log(f"split {label:<18} device ms a call: row and column kernels "
            f"{level_ms:.4f}"
            + (f", DFT products {dft_ms:.4f}" if dft_ms else "")
            + f"  [{self.card}]")
        for n, t in sorted(mean_ms.items(), key=lambda x: -x[1]):
            log(f"    {t:9.4f} ms  ({times[n][0]} launches recorded in "
                f"{reps} calls)  {n[:70]}")
        if name in ("k2", "k4") and a[{"k2": 10, "k4": 21}[name]]:
            km, jm, im = a[0].shape
            ops = 16 * km * jm * (im // 2 + 1) * im
            log(f"    DFT products: {ops:.3e} ops in {dft_ms:.4f} ms = "
                f"{ops / dft_ms / 1e9:.3f} TFLOP/s (a multiply and an add a "
                f"term; FP32 lanes' ceiling without fused multiply-add "
                f"{self.cost.PEAK_F32_OPS / 2e12:.1f})")

    def device_ms(self, label, fn, a, kw, key, reps=20):
        """Device ms a launch of the kernel whose name holds `key` (one a
        call of fn; torch.profiler, the mean over the launches it
        recorded), beside the CUDA-event time that carries the wrapper's
        host path; logs it and returns it."""
        from cam_nor_physics_tpu_torch.bench import kernel_times
        times, _ = kernel_times(lambda: fn(*a, **kw), reps)
        mine = [(c, us) for n, (c, us) in times.items() if key in n]
        if not mine:
            raise RuntimeError(f"{label}: the profiler recorded no {key}")
        n = sum(c for c, _ in mine)
        ms = sum(us for _, us in mine) / 1e3 / n
        log(f"device {label:<16} {ms:.4f} ms a call ({n} launches of {key} "
            f"recorded in {reps} calls)  [{self.card}]")
        return ms

    def time_row(self, label, name, a, kw, reps, plain_reps):
        """Times one kernel call and its plain version (CUDA events) and
        logs them beside the call's bound; returns (ms, plain ms, bound
        ms, bound_by)."""
        ms = self.time_call(self.kernel(name), a, kw, reps)
        plain_ms = self.time_call(self.plain(name), a, kw, plain_reps)
        nbytes, ops = self.work(name, a, kw)
        bound, bound_by = self.cost.bound(nbytes, ops)
        own = ""
        if name in ("k2", "k4"):
            # the kernel's dense DFT sums: its own work, not the bound
            need, dense = self.filter_ops(name, a)
            own = f"; the kernel's own work {ops - need + dense:.3e} ops"
        log(f"time {label:<18} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {bound:.5f} ms by {bound_by} ({nbytes} B, {ops:.3e} "
            f"ops{own})  [{self.card}]")
        return ms, plain_ms, bound, bound_by

    # ------------------------------------------------------ the probe
    def run_probe(self) -> dict:
        """The probe kernel on one seeded (8, 128) float32 block (the
        bench's) and the same block in float64: exactly 2 x its input and
        bitwise its plain version; its float32 time (CUDA events over
        back-to-back calls, so mostly the host's launch path) beside its
        plain version's and the library call's (one torch.mul), timed in
        turns, and its bound (the block read once and written once; one
        multiply an element); each one's device time a call from
        torch.profiler splits host from device."""
        torch = self.torch
        from cam_nor_physics_tpu_torch.bench import bitwise_equal
        from cam_nor_physics_tpu_torch.ops import probe_kernels as pk
        x = torch.as_tensor(np.random.default_rng(2).standard_normal(
            pk.SHAPE), dtype=torch.float32, device=DEVICE)
        for xd in (x, x.double()):
            got = pk.probe(xd)
            want = pk.probe_ref(xd)
            twice = (x.double() * 2.0).to(xd.dtype)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            ok = bitwise_equal(got, want) and bitwise_equal(got, twice)
            log(f"check probe (8, 128) {xd.dtype}: max_abs_err={e:.3e} "
                f"exact 2x: {ok}")
            if not ok:
                raise RuntimeError(f"probe kernel ({xd.dtype}): output is "
                                   f"not exactly 2 x its input")
            if xd.dtype == torch.float32:
                err = e
        calls = {"library": (torch.mul, (x, 2.0)), "kernel": (pk.probe, (x,)),
                 "plain": (pk.probe_ref, (x,))}
        # in turns: PROBE_ROUNDS rounds of library, kernel, plain, plain,
        # kernel, library (PROBE_CALLS back-to-back calls a turn, CUDA
        # events); each one's time is the median of its turns
        turns = defaultdict(list)
        for _ in range(PROBE_ROUNDS):
            for name in ("library", "kernel", "plain", "plain", "kernel",
                         "library"):
                fn, args = calls[name]
                turns[name].append(self.time_call(fn, args, {},
                                                  PROBE_CALLS))
        ms, plain_ms, library_ms = (float(np.median(turns[n])) for n in
                                    ("kernel", "plain", "library"))
        # the device's share: each call's kernel duration by the profiler
        dev = {n: device_us(lambda f=f, a=a: f(*a), PROBE_CALLS)
               for n, (f, a) in calls.items()}
        nbytes = 2 * x.numel() * x.element_size()
        bound, bound_by = self.cost.bound(nbytes, x.numel())
        log(f"time probe              kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  library (torch.mul) {library_ms:.4f} ms  "
            f"bound {bound:.3e} ms by {bound_by} ({nbytes} B, "
            f"{x.numel()} ops)  [{self.card}]")
        for n in ("kernel", "plain", "library"):
            t = float(np.median(turns[n]))
            log(f"    probe {n:<8} turns "
                + ", ".join(f"{v:.4f}" for v in turns[n])
                + f" ms a call; device {dev[n] / 1e3:.4f} ms a call, host "
                f"and launch {t - dev[n] / 1e3:.4f} ms")
        log(f"probe: kernel {'at or below' if ms <= library_ms else 'above'}"
            f" torch.mul in the same run ({ms:.4f} vs {library_ms:.4f} ms)")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": library_ms}

    # ------------------------------------------------- the CUDA graphs
    def graph_check(self, label, step, carry, k: int = GRAPH_K):
        """One step's CUDA graph through the bench's `chain_graph`, which
        captures k chained steps and holds the first replay bitwise to k
        eager steps from the same carry. On top of that: the launches it
        counts (the capture and the k eager steps) equal 2k times one
        eager step's, so the capture counted k steps and the replay none;
        replays 2 and 3 are bitwise equal to eager steps k+1..2k and
        2k+1..3k. Prints the per step time of each shape (host clock,
        synchronised)."""
        torch = self.torch
        from cam_nor_physics_tpu_torch.bench import (bitwise_equal,
                                                     chain_graph, clone_tree)
        self.zero_counts()
        step(*carry)                   # one eager step, also the warm-up
        torch.cuda.synchronize()
        eager = self.counts()
        self.zero_counts()
        t0 = time.perf_counter()
        g = chain_graph(step, carry, k)
        check_s = time.perf_counter() - t0
        counted = self.counts()
        captured = {n: c - k * eager[n] for n, c in counted.items()}
        want = {n: k * c for n, c in eager.items()}
        log(f"graph {label}: {k} steps captured, replayed once and held "
            f"bitwise to {k} eager steps in {check_s:.2f} s; launches "
            f"counted at capture {captured}, one eager step {eager}")
        if captured != want or not any(eager.values()):
            raise RuntimeError(f"graph {label}: capture counted {captured}, "
                               f"expected {k} x one eager step = {want}")
        cur, same, replay_s, eager_s = clone_tree(g.static), [], [], []
        for _ in range(2):
            self.zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.replay()
            torch.cuda.synchronize()
            replay_s.append(time.perf_counter() - t0)
            if any(self.counts().values()):
                raise RuntimeError(f"graph {label}: a replay counted "
                                   f"launches {self.counts()}")
            t0 = time.perf_counter()
            for _ in range(k):
                cur = step(*cur)
            torch.cuda.synchronize()
            eager_s.append(time.perf_counter() - t0)
            same.append(bitwise_equal(g.static, cur))
        log(f"graph {label}: replay 1 == eager steps 1-{k} bitwise: True "
            f"(chain_graph); replay 2 == eager steps {k + 1}-{2 * k}: "
            f"{same[0]}; replay 3 == eager steps {2 * k + 1}-{3 * k}: "
            f"{same[1]}")
        log(f"graph {label} per step [{self.card}]: replay "
            + ", ".join(f"{1e3 * t / k:.3f}" for t in replay_s)
            + " ms; eager " + ", ".join(f"{1e3 * t / k:.3f}" for t in eager_s)
            + " ms (replays 2-3; eager steps in blocks of "
            f"{k}, synchronised at each block's end)")
        if not all(same):
            raise RuntimeError(f"graph {label}: replays differ from eager "
                               f"steps")
        return min(replay_s) / k

    # ---------------------------------------------- f09 and f05
    def run_grid(self, gname: str, impl: str = "fft") -> dict:
        """The bench's HS step at grid `gname` with FVConfig()'s splits,
        fused ("fft") or unfused ("matmul"): SPINUP large steps (the
        unfused step 1) through the kernels from the bench's initial state,
        with exact launch counts, finite fields and the dry-mass drift over
        them; then one more step with each kernel's last call recorded (of
        transport3d, the last at each order), and on those inputs the
        path's kernels against their plain versions (float32 gate) and
        timed beside their bounds: K1-K4, tracer_div3d and te_map_remap
        (fused), transport3d and vort_flux3d (unfused)."""
        torch = self.torch
        from cam_nor_physics_tpu_torch.bench import GRIDS, SPINUP
        from cam_nor_physics_tpu_torch.entry import DT, build_step
        from cam_nor_physics_tpu_torch.utils.config import FVConfig
        im, jm, km, _ = GRIDS[gname]
        cfg = FVConfig()
        ns, nstrac, nv = cfg.resolved_splits(DT, im, jm)
        n2 = (nstrac + nv - 1) // nv
        calls = (ns + n2 * nv - 1) // (n2 * nv) * n2 * nv
        nsteps = SPINUP if impl == "fft" else 1
        step, state0, grid, coord, phis = build_step(
            im, jm, km, torch.float32, DEVICE, filter_impl=impl, cfg=cfg)
        lpc = self.sk.LAUNCHES_PER_CALL
        # launches a small step: K1-K4's, or 2 transport3d and 1
        # vort_flux3d calls
        small = ({k: self.ck.launches_per_call(k) for k in FUSED}
                 if impl == "fft" else
                 {"transport3d": 2 * lpc["transport3d"],
                  "vort_flux3d": lpc["vort_flux3d"]})
        expect = {n: small.get(n, 0) * calls * nsteps for n in self.sites}
        expect["tracer_div3d"] = n2 * nv * nsteps * lpc["tracer_div3d"]
        expect["te_map_remap"] = nv * nsteps
        for name in self.sites:
            self.kernel(name).launches = 0
        state, step_s = state0, []
        for _ in range(nsteps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = step(state, grid, coord, phis)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = {n: self.kernel(n).launches for n in self.sites}
        log(f"{gname} ({impl}): {nsteps} HS large steps at {im}x{jm}x{km} "
            f"float32, splits (nsplit, nspltrac, nspltvrm) = "
            f"{(ns, nstrac, nv)}: {calls} small steps and {n2 * nv} trac2d "
            f"a step; launches {launches}; step times "
            + ", ".join(f"{1e3 * t:.2f}" for t in step_s) + f" ms "
            f"[{self.card}]")
        if launches != expect:
            raise RuntimeError(f"{gname} ({impl}): launched {launches}, "
                               f"expected {expect}")
        for f in ("u", "v", "pt", "delp", "q"):
            if not bool(torch.isfinite(getattr(state, f)).all()):
                raise RuntimeError(f"{gname} ({impl}): non-finite {f}")
        m0, m1 = self.dry_mass(grid, state0), self.dry_mass(grid, state)
        drift = abs(m1 - m0) / m0
        log(f"{gname} ({impl}): dry-mass drift over {nsteps} steps: "
            f"{drift:.3e} (tol {DRIFT_TOL:.0e})")
        if drift > DRIFT_TOL:
            raise RuntimeError(f"{gname} ({impl}): dry-mass drift "
                               f"{drift:.3e} > {DRIFT_TOL}")

        last = {}

        def rec(name):
            kern = self.kernel(name)

            def f(*a, **kw):
                key = (f"{name}[iord={a[10]}]" if name == "transport3d"
                       else name)
                last[key] = (a, kw)
                return kern(*a, **kw)
            # K1-K4 add their launches to their module's name for them,
            # which points here while routed
            f.launches = 0
            return f

        with self.routed(rec):
            step(state, grid, coord, phis)
        torch.cuda.synchronize()
        steady = sum(step_s[1:]) / max(len(step_s) - 1, 1)
        if impl == "matmul":
            self.unfused_grid_kernels(gname, last, calls)
            return {"drift": drift}
        reps, plain_reps = BEYOND_REPS[gname]
        times = {}
        for name in FUSED + ("tracer_div3d", "te_map_remap"):
            a, kw = last[name]
            self.compare(f"{name}@{gname}", name, a, kw, "float32")
            if name == "te_map_remap":
                self.compare(f"{name}@{gname}", name, a, kw, "float64")
            times[name] = self.time_row(f"{name}@{gname}", name, a, kw,
                                        reps, plain_reps)[0]
            if name == "te_map_remap":
                self.device_ms(f"{name}@{gname}", self.kernel(name), a, kw,
                               "te_map_kernel", 5)
            if name in SPLIT:
                self.split(name, f"{name}@{gname}", a, kw, 3)
        # K1's and tracer_div3d's flags and caps with FFSL rows forced,
        # and tracer_div3d with a polar band
        for name in ("k1", "tracer_div3d"):
            a, kw = last[name]
            sa, skw, nrows = self.stressed(name, a, kw)
            self.compare(f"{name}@{gname}+ffsl({nrows} rows)", name, sa,
                         skw, "float32")
        for vlabel, va, vkw in self.variants("tracer_div3d",
                                             *last["tracer_div3d"], grid):
            self.compare(f"{vlabel}@{gname}", "tracer_div3d", va, vkw,
                         "float32")
        if gname == "f05":
            # where the row kernels' blocks are most numerous: K3's flags
            # and caps with FFSL rows forced, K2's finishing row kernel
            a, kw = last["k3"]
            sa, skw, nrows = self.stressed("k3", a, kw)
            self.compare(f"k3@{gname}+ffsl({nrows} rows)", "k3", sa, skw,
                         "float32")
            a, kw = last["k2"]
            for vlabel, va, vkw in self.variants("k2", a, kw, grid):
                self.compare(f"{vlabel}@{gname}", "k2", va, vkw, "float32")
        per_step = {n: times[n] * (calls if n in FUSED else
                                   n2 * nv if n == "tracer_div3d" else nv)
                    for n in times}
        share = {n.upper(): 100.0 * per_step[n] / (1e3 * steady)
                 for n in FUSED}
        share["K1-K4"] = sum(share.values())
        log(f"{gname}: kernel time a step (calls x kernel ms): "
            + ", ".join(f"{n} {t:.2f}" for n, t in per_step.items())
            + f" ms; share of the HS step ({1e3 * steady:.2f} ms, mean of "
            f"spin-up steps 2-{SPINUP}): "
            + ", ".join(f"{n} {v:.1f}%" for n, v in share.items())
            + f" [{self.card}]")
        return {"drift": drift, "steady": steady}

    def unfused_grid_kernels(self, gname, last, calls):
        """The unfused step's kernels at grid `gname` on the inputs `last`
        recorded: transport3d at iord 1 and 4 and vort_flux3d against
        their plain versions (float32), plain and with FFSL rows forced,
        timed beside their bounds, transport3d's device time split by its
        row kernels; their time a step (calls small steps)."""
        reps, plain_reps = BEYOND_REPS[gname]
        times = {}
        for key in ("transport3d[iord=1]", "transport3d[iord=4]",
                    "vort_flux3d"):
            name = key.split("[")[0]
            a, kw = last[key]
            self.compare(f"{key}@{gname}", name, a, kw, "float32")
            sa, skw, nrows = self.stressed(name, a, kw)
            self.compare(f"{key}@{gname}+ffsl({nrows} rows)", name, sa, skw,
                         "float32")
            times[key] = self.time_row(f"{key}@{gname}", name, a, kw, reps,
                                       plain_reps)[0]
            if name in SPLIT:
                self.split(name, f"{key}@{gname}", a, kw, 3)
        log(f"{gname} (matmul): transport3d and vort_flux3d a step "
            f"({calls} small steps x (transport3d at iord 1 and 4 + "
            f"vort_flux3d)): "
            f"{calls * sum(times.values()):.3f} ms [{self.card}]")


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

    def gate(self, label, rel, dtype_name, abs_err):
        worst = max(rel, key=rel.get)
        ok = rel[worst] <= TOL[dtype_name]
        log(f"check {label:<24} {dtype_name}: max_abs_err={abs_err:.3e} "
            f"({'exact' if abs_err == 0.0 else 'not exact'}) "
            f"max_rel_err={rel[worst]:.3e} ({worst}) "
            f"tol={TOL[dtype_name]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label} {dtype_name}: kernel disagrees with "
                               f"its plain version: {rel}")

    def compare_tail(self, a, kw, dtype_name, label="zm_tail"):
        a, kw = self.sm.cast(a, kw, getattr(self.torch, dtype_name))
        got = self.tail_outputs(self.tk.zm_tail(*a, **kw))
        want = self.tail_outputs(self.tk.zm_tail_ref(*a, **kw))
        self.torch.cuda.synchronize()
        rel, abs_err = self.rel_errors(
            got, want, {"prec": "flxprec", "snow": "flxsnow"})
        self.gate(label, rel, dtype_name, abs_err)
        return abs_err

    def compare_tend(self, inputs, dtype_name):
        got = self.tend_outputs(self.tend(*inputs))
        with self.routed(self.tk.zm_tail_ref):
            want = self.tend_outputs(self.tend(*inputs))
        self.torch.cuda.synchronize()
        rel, abs_err = self.rel_errors(got, want,
                                       {"pbuf.PREC_DP": "pbuf.DP_FLXPRC",
                                        "pbuf.SNOW_DP": "pbuf.DP_FLXSNW"})
        self.gate("zm_conv_tend", rel, dtype_name, abs_err)

    def work(self, a, kw):
        """(bytes, operations) of one tail call (cost.kernel_work)."""
        return self.sm.cost.kernel_work("zm_tail", a, kw,
                                        self.tk.zm_tail(*a, **kw))

    def time_tail(self, label, a, kw, reps, plain_reps):
        """zm_tail's and zm_tail_ref's time a call (CUDA events) beside the
        call's bound; returns (ms, plain ms, bound ms, bound_by)."""
        sm = self.sm
        ms = sm.time_call(self.tk.zm_tail, a, kw, reps)
        plain_ms = sm.time_call(self.tk.zm_tail_ref, a, kw, plain_reps)
        nbytes, ops = self.work(a, kw)
        bound, bound_by = sm.cost.bound(nbytes, ops)
        log(f"time {label:<18} kernel {ms:.4f} ms  plain {plain_ms:.4f} "
            f"ms  bound {bound:.5f} ms by {bound_by} ({nbytes} B, {ops:.3e} "
            f"ops)  [{sm.card}]")
        return ms, plain_ms, bound, bound_by

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

    # ---- phase 7: the ZM step through the kernels, counted
    from cam_nor_physics_tpu_torch.utils.config import ZMConfig
    sm.zero_counts()
    state1, pbuf1 = zstep(*inputs)
    torch.cuda.synchronize()
    got = {k: v for k, v in sm.counts().items() if v}
    want = {"zm_tail": 1,
            "zm_parcel": parcel_launches(torch, ZMConfig(), KM)}
    share = float(pbuf1.get("ZM_IDEEP").double().mean())
    log(f"main path: 1 zm_conv_tend on {NCOL}x{KM} float32, launches "
        f"{got}, triggered share {share:.4f} [{card}]")
    if got != want:
        raise RuntimeError(f"one zm_conv_tend launched {got} (expected "
                           f"{want})")
    if not 0.0 < share < 1.0:
        raise RuntimeError(f"triggered share {share} not inside (0, 1)")
    for f in ("t", "u", "v", "q"):
        if not bool(torch.isfinite(getattr(state1, f)).all()):
            raise RuntimeError(f"non-finite {f} after the ZM step")
    zm.compare_tend(inputs, "float32")
    zm.compare_tend(varied_zm_inputs(NCOL, KM, torch.float64, DEVICE),
                    "float64")

    # ---- phase 8: times
    ms, plain_ms, bound, bound_by = zm.time_tail("zm_tail", a, kw, 50, 5)
    sm.device_ms("zm_tail", zm.tk.zm_tail, a, kw, "zm_tail_kernel")
    tend_s, tend_all = zm.time_host(lambda: zstep(*inputs), ZM_CALLS)
    convr_s, call_s = zm.convr_share(lambda: zstep(*inputs), ZM_CALLS)
    log(f"zm_conv_tend per call [{card}]: {1e3 * tend_s:.2f} ms (mean of "
        f"{ZM_CALLS} after 1 warm-up: "
        + ", ".join(f"{1e3 * t:.2f}" for t in tend_all)
        + f" ms); zm_convr {1e3 * convr_s / ZM_CALLS:.2f} of "
        f"{1e3 * call_s / ZM_CALLS:.2f} ms per call "
        f"({100.0 * convr_s / call_s:.1f}%) in {ZM_CALLS} more calls with "
        f"zm_convr timed inside them")
    return {"row": {"launches": got["zm_tail"], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by},
            "parcel_launches": got["zm_parcel"],
            "zm_s": tend_s, "step": lambda: zstep(*inputs)}


def run_zm_grid(torch, sm: Smoke, gname: str) -> None:
    """Phase 11's ZM part: zm_tail against zm_tail_ref (float32 gate) on
    the inputs the port's zm_convr gives it on entry.varied_zm_inputs at
    grid `gname`'s columns and levels, timed beside its bound."""
    from cam_nor_physics_tpu_torch.bench import GRIDS
    from cam_nor_physics_tpu_torch.entry import varied_zm_inputs
    im, jm, km, _ = GRIDS[gname]
    zm = ZMSmoke(torch, sm)
    a, kw = zm.capture(*varied_zm_inputs(im * jm, km, torch.float32,
                                         DEVICE))
    zm.compare_tail(a, kw, "float32", f"zm_tail@{gname}")
    zm.time_tail(f"zm_tail@{gname}", a, kw, *BEYOND_REPS[gname])
    sm.device_ms(f"zm_tail@{gname}", zm.tk.zm_tail, a, kw, "zm_tail_kernel",
                 5)


class ParcelSmoke:
    """Phase 19: ZM's parcel kernel (zm_parcel) against its plain version
    (zm_parcel_ref, the port's buoyan_dilute) on the arguments of
    zm_convr's two calls, and the trigger and level indices the two give
    zm_convr in the coupled step."""

    def __init__(self, torch, sm: Smoke):
        from cam_nor_physics_tpu_torch.models.physics import zm_conv, \
            zm_conv_intr
        from cam_nor_physics_tpu_torch.ops import zm_parcel_kernels
        from cam_nor_physics_tpu_torch.utils.config import ZMConfig
        self.torch, self.sm = torch, sm
        self.zc, self.intr, self.pk = zm_conv, zm_conv_intr, zm_parcel_kernels
        self.kernel = zm_parcel_kernels.zm_parcel
        self.cfg = ZMConfig()

    @contextmanager
    def recorded(self, out, plain=False):
        """zm_convr's parcel calls through the kernel or, with plain,
        through the plain version, each call's (arguments, output) of
        `_launch` or of zm_parcel_ref appended to out (zm_convr looks
        zm_parcel up in its module at each call)."""
        pk = self.pk
        name = "zm_parcel" if plain else "_launch"
        fn = pk.zm_parcel_ref if plain else pk._launch

        def rec(*a):
            res = fn(*a)
            out.append((a, res))
            return res

        setattr(pk, name, rec)
        try:
            yield
        finally:
            setattr(pk, name, self.kernel if plain else fn)

    def calls(self, convr_args):
        """The arguments of zm_convr's zm_parcel calls (through the plain
        version)."""
        rec = []
        with self.recorded(rec, plain=True):
            self.zc.zm_convr(*convr_args)
        return [a for a, _ in rec]

    def varied_args(self, ncol, km, dtype):
        """zm_convr's arguments on entry.varied_zm_inputs (as zm_conv_tend
        forms them, msg 0, half of ZM_DT)."""
        from cam_nor_physics_tpu_torch.entry import varied_zm_inputs
        ps, _, fo = varied_zm_inputs(ncol, km, dtype, DEVICE)
        return (self.cfg, 0, ps.t, ps.q[:, :, 0], ps.pmid, ps.pint, ps.pdel,
                ps.zm, ps.phis, ps.zi, fo["pblh"], fo["tpert"],
                fo["landfrac"], 0.5 * ZM_DT)

    def trigger(self, cape, cin):
        return (cape > self.cfg.capelmt) & \
            (cin < cape * self.cfg.cin_threshd)

    def flips(self, label, got, want):
        """Columns whose trigger (from the call's CAPE and CIN), lcl, lel
        or mx differ, each with the plain version's CAPE margin to capelmt
        and CIN margin to cin_threshd * cape (relative); logs them and
        returns (count, the largest of each flip's smaller margin)."""
        torch, cfg = self.torch, self.cfg
        diff = self.trigger(got.cape, got.cin) != \
            self.trigger(want.cape, want.cin)
        for f in ("lcl", "lel", "mx"):
            diff |= getattr(got, f) != getattr(want, f)
        cols = torch.nonzero(diff).flatten().tolist()
        worst = 0.0
        for i in cols[:20]:
            cape, cin = float(want.cape[i]), float(want.cin[i])
            m_cape = abs(cape - cfg.capelmt) / cfg.capelmt
            thr = cfg.cin_threshd * cape
            m_cin = abs(cin - thr) / max(abs(thr), 1e-30)
            worst = max(worst, min(m_cape, m_cin))
            log(f"    {label} column {i}: cape {cape:.6g} / "
                f"{float(got.cape[i]):.6g}, cin {cin:.6g} / "
                f"{float(got.cin[i]):.6g}, lcl {int(want.lcl[i])}/"
                f"{int(got.lcl[i])}, lel {int(want.lel[i])}/"
                f"{int(got.lel[i])}, mx {int(want.mx[i])}/{int(got.mx[i])};"
                f" margins cape {m_cape:.3e} cin {m_cin:.3e}")
        if len(cols) > 20:
            worst = float("inf")
        return len(cols), worst

    def compare(self, label, args, dtype_name):
        """zm_parcel against zm_parcel_ref on one call's arguments cast to
        dtype_name: each field's largest error relative to its max in the
        columns whose lcl, lel and mx agree, held to TOL; the largest
        absolute error over all columns; the flips, none in float64 (a
        float32 flip's margins are held by run_parcel). Returns (max abs
        error, max rel error, flips, worst margin)."""
        torch, pk = self.torch, self.pk
        a, _ = self.sm.cast(list(args), {}, getattr(torch, dtype_name))
        n0 = self.kernel.launches
        got = self.kernel(*a)
        want = pk.zm_parcel_ref(*a)
        torch.cuda.synchronize()
        if self.kernel.launches != n0 + 1:
            raise RuntimeError(f"{label}: zm_parcel did not launch once")
        same = (got.lcl == want.lcl) & (got.lel == want.lel) & \
            (got.mx == want.mx)
        rel, abs_err = {}, 0.0
        for f in ("tp", "qstp", "buoy", "tl", "cape", "cin", "pl"):
            g, w = getattr(got, f).double(), getattr(want, f).double()
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"{label} {f}: non-finite output")
            d = (g - w).abs()
            abs_err = max(abs_err, float(d.max()))
            d = d.reshape(d.shape[0], -1).amax(1)[same]
            rel[f] = float(d.max()) / max(float(w.abs().max()), 1e-30)
        n, worst = self.flips(f"{label} {dtype_name}", got, want)
        top = max(rel, key=rel.get)
        tol = TOL[dtype_name]
        log(f"check {label:<24} {dtype_name}: max_abs_err={abs_err:.3e} "
            f"({'exact' if abs_err == 0.0 else 'not exact'}) "
            f"max_rel_err={rel[top]:.3e} ({top}) tol={tol:.0e}; columns "
            f"with trigger or index flips: {n}")
        if rel[top] > tol or (dtype_name == "float64" and n):
            raise RuntimeError(f"{label} {dtype_name}: zm_parcel disagrees "
                               f"with its plain version: {rel}, {n} flips")
        return abs_err, rel[top], n, worst

    def time_pair(self, label, args, reps, plain_reps):
        """zm_parcel's and zm_parcel_ref's ms a call (CUDA events), the
        kernel's device ms (torch.profiler, PARCEL_PROFILE_REPS calls)
        and the call's bound."""
        sm, pk = self.sm, self.pk
        ms = sm.time_call(self.kernel, args, {}, reps)
        plain_ms = sm.time_call(pk.zm_parcel_ref, args, {}, plain_reps)
        dev = sm.device_ms(label, self.kernel, args, {}, "zm_parcel_kernel",
                           PARCEL_PROFILE_REPS)
        nbytes, ops = sm.cost.kernel_work("zm_parcel", args, {},
                                          self.kernel(*args))
        bound, bound_by = sm.cost.bound(nbytes, ops)
        log(f"time {label:<18} kernel {ms:.4f} ms (device {dev:.4f})  "
            f"plain {plain_ms:.4f} ms  bound {bound:.5f} ms by {bound_by} "
            f"({nbytes} B, {ops:.3e} ops)  [{sm.card}]")
        return ms, plain_ms, dev, bound, bound_by

    def coupled_states(self, dtype, steps):
        """zm_convr's arguments in the coupled step (entry.build_coupled,
        the aqua cell's configuration) at its first step and after
        `steps` more, the parcel through the kernel."""
        from cam_nor_physics_tpu_torch.entry import build_coupled
        seen, real = [], self.intr.zm_convr

        def rec(*a, **kw):
            seen[:] = seen[:1] + [(tuple(
                x.clone() if isinstance(x, self.torch.Tensor) else x
                for x in a), kw)]
            return real(*a, **kw)

        _, step, state, _ = build_coupled(IM, JM, KM, dtype, DEVICE)
        self.intr.zm_convr = rec
        try:
            state, _, _ = step(state, first_step=True)
            first = seen[0]
            for _ in range(steps):
                state, _, _ = step(state)
        finally:
            self.intr.zm_convr = real
        return {"start": first, f"after {steps} steps": seen[-1]}

    def coupled_flips(self, dtype_name, steps):
        """zm_convr on the coupled step's arguments with the parcel through
        the kernel and through its plain version: ideep, maxg (mx) and
        each call's lcl and lel flips with their margins. Returns (count,
        worst margin)."""
        torch = self.torch
        total, worst = 0, 0.0
        for tag, (a, kw) in self.coupled_states(
                getattr(torch, dtype_name), steps).items():
            got_calls, want_calls = [], []
            with self.recorded(got_calls):
                got = self.zc.zm_convr(*a, **kw)
            with self.recorded(want_calls, plain=True):
                want = self.zc.zm_convr(*a, **kw)
            torch.cuda.synchronize()
            n_ideep = int((got.ideep != want.ideep).sum())
            n_mx = int((got.maxg != want.maxg).sum())
            log(f"coupled {tag} {dtype_name}: zm_convr ideep flips {n_ideep},"
                f" maxg flips {n_mx}, triggered share "
                f"{float(want.ideep.double().mean()):.4f}")
            n_calls = 0
            for i, ((_, g), (_, w)) in enumerate(zip(got_calls, want_calls)):
                n, m = self.flips(f"coupled {tag} call {i + 1} {dtype_name}",
                                  g, w)
                n_calls += n
                worst = max(worst, m)
            if (n_ideep or n_mx) and not n_calls:
                worst = float("inf")      # a flip with no parcel flip
            total += n_calls + n_ideep + n_mx
        return total, worst


def run_parcel(torch, sm: Smoke, card: str) -> dict:
    """Phase 19: zm_parcel against zm_parcel_ref at f19's, f09's and f05's
    columns (float32, float64) on entry.varied_zm_inputs, timed; then
    the flips in the coupled step at f19, at its start and after
    PARCEL_STEPS steps. Each field within TOL in the columns whose level
    indices agree; float64: no flip; float32: every flip's CAPE or CIN
    margin within PARCEL_MARGIN of its threshold. Returns the f19 float32
    row of the kernels JSON line (its launches are phase 7's count)."""
    from cam_nor_physics_tpu_torch.bench import GRIDS
    ps = ParcelSmoke(torch, sm)
    row, bad = None, []
    for gname in ("f19",) + BEYOND:
        im, jm, km, _ = GRIDS[gname]
        calls = ps.calls(ps.varied_args(im * jm, km, torch.float32))
        for dtype_name in ("float32", "float64"):
            errs = [ps.compare(f"zm_parcel@{gname} call {i + 1}", a,
                               dtype_name) for i, a in enumerate(calls)]
            if dtype_name == "float32":
                bad += [e for e in errs if e[2] and e[3] > PARCEL_MARGIN]
            a, _ = sm.cast(list(calls[1]), {}, getattr(torch, dtype_name))
            ms, plain_ms, dev, bound, bound_by = ps.time_pair(
                f"zm_parcel@{gname} {dtype_name[5:]}", a,
                *PARCEL_REPS[gname])
            if gname == "f19" and dtype_name == "float32":
                row = {"max_abs_err": max(e[0] for e in errs), "ms": ms,
                       "plain_ms": plain_ms, "device_ms": dev,
                       "bound_ms": bound, "bound_by": bound_by}
        torch.cuda.empty_cache()
    for dtype_name in ("float64", "float32"):
        n, worst = ps.coupled_flips(dtype_name, PARCEL_STEPS)
        log(f"coupled f19 {dtype_name}: {n} flips, worst margin "
            f"{worst:.3e} [{card}]")
        if dtype_name == "float64" and n:
            raise RuntimeError(f"coupled float64: {n} trigger or index flips")
        if n and worst > PARCEL_MARGIN:
            bad.append((dtype_name, n, worst))
    if bad:
        raise RuntimeError(f"zm_parcel float32 flips beyond a margin of "
                           f"{PARCEL_MARGIN}: {bad}")
    return row


def dyn_launches(sm: Smoke, fv_cfg, dt, grid) -> dict:
    """The launches of one FV large step with the fused small step: K1-K4
    ns times, tracer_div3d n2 times, te_map_remap nv times."""
    ns, nspltrac, nv = fv_cfg.resolved_splits(dt, grid.im, grid.jm)
    n2 = (nspltrac + nv - 1) // nv
    nsplit = (ns + n2 * nv - 1) // (n2 * nv)
    lpc = sm.sk.LAUNCHES_PER_CALL
    out = {k: nsplit * n2 * nv * sm.ck.launches_per_call(k) for k in FUSED}
    out.update(tracer_div3d=n2 * nv * lpc["tracer_div3d"], te_map_remap=nv,
               zm_tail=0, zm_parcel=0, transport3d=0, vort_flux3d=0,
               probe=0)
    return out


class CoupledSmoke:
    """Phase 13: the coupled atm_step (entry.build_coupled) on the card."""

    def __init__(self, torch, sm: Smoke, card: str):
        from cam_nor_physics_tpu_torch.models.physics import zm_conv_intr
        from cam_nor_physics_tpu_torch.ops import zm_tail_kernels
        self.torch, self.sm, self.card = torch, sm, card
        self.intr, self.tk = zm_conv_intr, zm_tail_kernels

    @contextmanager
    def plain(self):
        """All eight kernel sites of the coupled step at their plain
        versions (zm_convr looks zm_parcel up in its module at each
        call)."""
        from cam_nor_physics_tpu_torch.ops import zm_parcel_kernels as pk
        saved = self.intr.zm_tail, pk.zm_parcel
        self.intr.zm_tail = self.tk.zm_tail_ref
        pk.zm_parcel = pk.zm_parcel_ref
        try:
            with self.sm.routed(self.sm.plain):
                yield
        finally:
            self.intr.zm_tail, pk.zm_parcel = saved

    def expected(self, model) -> dict:
        """The launches of one coupled step: one HS large step's (K1-K4
        ns times, tracer_div3d n2 times, te_map_remap nv times) and one ZM
        step's (its tail kernel once, never under microp, where the plain
        tail runs, as in the JAX package; the parcel kernel once for each
        of zm_convr's parcel calls)."""
        out = dyn_launches(self.sm, model.fv_cfg, model.dt, model.grid)
        out["zm_tail"] = 0 if model.zm_cfg.microp else 1
        out["zm_parcel"] = parcel_launches(self.torch, model.zm_cfg,
                                           model.grid.km)
        return out

    @staticmethod
    def dry_mass(model, state):
        """Cos-lat weighted dry-air mass (tests/test_atm_comp.py:48-65)."""
        g = model.grid
        w = g.cosp.double().clone()
        w[0] = w[-1] = g.acap / g.im
        d = state.dyn
        return float((w[:, None] * d.delp.double() *
                      (1.0 - d.q[0].double())).sum())

    def counted_steps(self, label, model, step, state, nsteps, keep=()):
        """The first step and `nsteps` more, eager, each with the counts
        set to 0 before it and read after it; finite state and the
        dry-mass drift of each step. Returns the state, the steps' host
        times and, per step, copies of the diagnostics named in `keep`."""
        torch, sm = self.torch, self.sm
        from cam_nor_physics_tpu_torch.bench import tensors
        want = self.expected(model)
        times, kept = [], []
        for i in range(nsteps + 1):
            m0 = self.dry_mass(model, state)
            sm.zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, cam_out, diags = step(state, first_step=i == 0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = sm.counts()
            drift = abs(self.dry_mass(model, state) - m0) / m0
            log(f"coupled {label} step {i + 1}"
                f"{' (first_step)' if i == 0 else ''}: launches {got}, "
                f"dry-mass drift {drift:.3e} (tol {DRIFT_TOL:.0e}), "
                f"EFIX {self.efix_range(diags)} W/m2, "
                f"{1e3 * times[-1]:.1f} ms [{self.card}]")
            if got != want:
                raise RuntimeError(f"coupled {label} step {i + 1} launched "
                                   f"{got}, expected {want}")
            if drift > DRIFT_TOL:
                raise RuntimeError(f"coupled {label}: dry-mass drift "
                                   f"{drift:.3e} > {DRIFT_TOL}")
            bad = [j for j, t in enumerate(tensors((state, cam_out, diags)))
                   if t.is_floating_point()
                   and not bool(torch.isfinite(t).all())]
            if bad:
                raise RuntimeError(f"coupled {label}: {len(bad)} non-finite "
                                   f"tensors after step {i + 1}")
            kept.append({k: diags[k].clone() for k in keep})
        return state, times, kept

    @staticmethod
    def efix_range(diags) -> str:
        """[min, max] of the energy fixer's column heating (EFIX)."""
        e = diags["EFIX"].double()
        return f"[{float(e.min()):.6e}, {float(e.max()):.6e}]"

    def parity64(self, microp=False, tag=None, **phys):
        """The first step and one more in float64 through the kernels and
        through the plain versions, from the same state: each dycore and
        physics field within COUPLED_TOL_F64 of its max; the columns whose
        ZM trigger or level indices differ, counted. Without microp the
        kernels' run goes on to the float32 run's COUPLED_STEPS + 1 steps
        for EFIX. `phys`: PhysConfig fields for build_coupled."""
        torch = self.torch
        from cam_nor_physics_tpu_torch.entry import build_coupled
        model, step, s0, _ = build_coupled(IM, JM, KM, torch.float64,
                                           DEVICE, microp=microp, **phys)
        tag = tag or ("coupled microp" if microp else "coupled")

        def run(nsteps):
            s, kept, flips, efix = s0, None, [], []
            for i in range(nsteps):
                s, _, diags = step(s, first_step=i == 0)
                efix.append(self.efix_range(diags))
                if i < COUPLED_F64_STEPS:
                    flips.append({k: s.pbuf.get(k).clone()
                                  for k in ("ZM_IDEEP", "ZM_JT", "ZM_MAXG")})
                    kept = s
            return kept, flips, efix

        got, kflips, efix = run(COUPLED_F64_STEPS if microp
                                else COUPLED_STEPS + 1)
        log(f"{tag} float64 through the kernels: EFIX by step {efix} "
            f"W/m2")
        with self.plain():
            want, pflips, _ = run(COUPLED_F64_STEPS)
        torch.cuda.synchronize()
        flipped = [int(sum((a[k] != b[k]) for k in a).gt(0).sum())
                   for a, b in zip(kflips, pflips)]
        rel = {}
        for grp in ("dyn", "phys"):
            g, w = getattr(got, grp), getattr(want, grp)
            for f in dataclasses.fields(w):
                x, y = getattr(g, f.name), getattr(w, f.name)
                scale = float(y.abs().max())
                rel[f"{grp}.{f.name}"] = float((x - y).abs().max()) / \
                    max(scale, 1e-300)
        worst = max(rel, key=rel.get)
        log(f"{tag} float64, {COUPLED_F64_STEPS} steps, kernels vs plain "
            f"versions: worst {worst} {rel[worst]:.3e} (tol "
            f"{COUPLED_TOL_F64:.0e}); dyn "
            + ", ".join(f"{k[4:]} {v:.2e}" for k, v in rel.items()
                        if k.startswith("dyn."))
            + f"; columns whose ZM trigger or level indices differ, by step: "
            f"{flipped} of {IM * JM}")
        if rel[worst] > COUPLED_TOL_F64:
            raise RuntimeError(f"{tag} float64: kernels disagree with the "
                               f"plain versions: {worst} {rel[worst]:.3e}")

    def graph(self, step, state):
        """A CUDA graph of GRAPH_K prog_only steps (bench.chain_graph, its
        first replay held bitwise to GRAPH_K eager steps), the launches it
        counted at capture (GRAPH_K steps') and at a replay (none), and
        the replay time a step."""
        torch, sm = self.torch, self.sm
        from cam_nor_physics_tpu_torch.bench import chain_graph

        def prog_only(s):
            return (step(s)[0],)

        sm.zero_counts()
        prog_only(state)
        torch.cuda.synchronize()
        one = sm.counts()
        sm.zero_counts()
        t0 = time.perf_counter()
        g = chain_graph(prog_only, (state,), GRAPH_K)
        check_s = time.perf_counter() - t0
        captured = {n: c - GRAPH_K * one[n] for n, c in sm.counts().items()}
        if captured != {n: GRAPH_K * c for n, c in one.items()}:
            raise RuntimeError(f"coupled graph: capture counted {captured}, "
                               f"one eager step {one}")
        sm.zero_counts()
        reps = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.replay()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) / GRAPH_K)
        if any(sm.counts().values()):
            raise RuntimeError(f"coupled graph: a replay counted "
                               f"{sm.counts()}")
        log(f"coupled graph: {GRAPH_K} prog_only steps captured, first "
            f"replay bitwise equal to {GRAPH_K} eager steps (chain_graph, "
            f"{check_s:.1f} s); launches at capture {captured}; replay "
            f"per step " + ", ".join(f"{1e3 * t:.2f}" for t in reps)
            + f" ms [{self.card}]")
        del g
        return min(reps)


def run_coupled(torch, sm: Smoke, card: str) -> None:
    """Phase 13: the coupled step at f19 on the card, and one at f09."""
    from cam_nor_physics_tpu_torch import bench
    from cam_nor_physics_tpu_torch.entry import build_coupled
    cs = CoupledSmoke(torch, sm, card)
    model, step, state, sst = build_coupled(IM, JM, KM, torch.float32,
                                            DEVICE)
    state, _, _ = cs.counted_steps("f19", model, step, state, COUPLED_STEPS)
    cs.parity64()
    torch.cuda.empty_cache()
    t_graph = cs.graph(step, state)
    torch.cuda.empty_cache()

    def timed(fn):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COUPLED_TIMED):
            state = fn(state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / COUPLED_TIMED

    # full and prog_only are one computation in eager PyTorch
    t_step = timed(lambda s: step(s)[0])
    phases = bench.coupled_phases(model, state, sst, 2, torch.device(DEVICE),
                                  passes=1)
    npts = IM * JM * KM
    log(f"coupled step at {IM}x{JM}x{KM} float32 [{card}]: per dispatch "
        f"{1e3 * t_step:.2f} ms (full = prog_only, the mean of "
        f"{COUPLED_TIMED}); graph {1e3 * t_graph:.2f} ms -> "
        f"{npts / t_graph:.6e} grid points/s; phase table (independent "
        f"dispatches): " + ", ".join(f"{k} {1e3 * v:.2f} ms"
                                     for k, v in phases.items()))
    profile_call(f"coupled step (prog_only) {IM}x{JM}x{KM}",
                 lambda: step(state), card)
    del state
    torch.cuda.empty_cache()
    # f09: FVConfig()'s (8, 2, 1) splits run trac2d twice a step, the
    # second time on the first's output
    im, jm, km, _ = bench.GRIDS["f09"]
    model, step, state, _ = build_coupled(im, jm, km, torch.float32, DEVICE)
    cs.counted_steps("f09", model, step, state, 1)
    del state
    torch.cuda.empty_cache()
    return t_step, t_graph


class DriverSmoke:
    """Phase 14: the port's run driver (driver.run, its chunked loop as
    CUDA graphs, run_coupled) at f19 on the card, with its tapes and
    checkpoints under build/driver_smoke (removed after the phase)."""

    def __init__(self, torch, sm: Smoke, card: str):
        from cam_nor_physics_tpu_torch import driver
        self.torch, self.sm, self.card, self.drv = torch, sm, card, driver
        self.cs = CoupledSmoke(torch, sm, card)
        self.root = REPO / "cam_nor_physics_tpu_torch" / "build" / \
            "driver_smoke"
        self.writers = []      # (kind, native) of each writer a run made

    @contextmanager
    def recorded_writers(self):
        """The driver's writer classes, each instance recorded with the
        route it takes (native or not)."""
        from cam_nor_physics_tpu_torch.utils import histio_native
        drv, seen = self.drv, self.writers
        saved = histio_native.AsyncHistoryWriter, drv.AsyncCheckpointWriter

        class Hist(saved[0]):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                seen.append(("history", self.native))

        class Ckpt(saved[1]):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                seen.append(("checkpoint", self.native))

        histio_native.AsyncHistoryWriter, drv.AsyncCheckpointWriter = \
            Hist, Ckpt
        try:
            yield
        finally:
            histio_native.AsyncHistoryWriter, drv.AsyncCheckpointWriter = \
                saved

    def counted(self, label, steps, fn):
        """fn() with the launch counts set to 0 before and read after; they
        must be `steps` coupled steps' (an eager step and a captured step
        count one each, a replay none). Returns fn's result and the wall
        time."""
        torch, sm = self.torch, self.sm
        sm.zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = sm.counts()
        want = {n: steps * c for n, c in self.one.items()}
        log(f"driver {label}: {wall:.2f} s wall, launches {got} "
            f"({steps} coupled steps' worth) [{self.card}]")
        if got != want:
            raise RuntimeError(f"driver {label}: launched {got}, expected "
                               f"{want}")
        return out, wall

    @staticmethod
    def read_tape(path):
        from scipy.io import netcdf_file
        with netcdf_file(path, mmap=False) as nc:
            return {k: np.array(v.data) for k, v in nc.variables.items()}

    @staticmethod
    def dir_bytes(path: Path) -> int:
        return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())

    def zeros_like(self, state):
        from cam_nor_physics_tpu_torch import convert
        return convert.atmstate_from_leaves(
            state, [self.torch.zeros_like(t)
                    for _, t in convert.atmstate_named_leaves(state)])

    def run_microp(self) -> float:
        """Phase 15's driver runs with microp at f19: 16 steps at chunk 1
        and at chunk 8 (the first step eager, then CUDA graphs of 7 and 8
        steps, each first replay held bitwise to the same steps run
        eagerly), history and sentinels every 8; launches exact; state
        and every tape array bitwise equal; the microp family on the tape,
        finite. Returns the 8-step graph's first replay, seconds a step
        (the replays timed by a ChainGraph subclass)."""
        import shutil
        torch, drv = self.torch, self.drv
        from cam_nor_physics_tpu_torch.bench import bitwise_equal
        from cam_nor_physics_tpu_torch.entry import build_coupled
        from cam_nor_physics_tpu_torch.models.coupling.surface_fluxes import \
            bulk_surface_fluxes
        root = self.root / "microp"
        shutil.rmtree(root, ignore_errors=True)
        model, _, state0, sst = build_coupled(IM, JM, KM, torch.float32,
                                              DEVICE, microp=True)
        cam_in = bulk_surface_fluxes(state0.phys, sst, model.registry.pcnst)
        self.one = self.cs.expected(model)
        n, k = DRIVER_STEPS, DRIVER_CHUNK
        io = dict(hist_every=n // 2, check_every=n // 2)
        timed = []
        saved = drv.ChainGraph

        class Timed(saved):
            def __init__(self_g, *a, **kw):
                t0 = time.perf_counter()
                super().__init__(*a, **kw)
                torch.cuda.synchronize()
                timed.append(("capture", self_g.k,
                              time.perf_counter() - t0))

            def replay(self_g):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                super().replay()
                torch.cuda.synchronize()
                timed.append(("replay", self_g.k, time.perf_counter() - t0))

        try:
            (st_a, tm_a), wall_a = self.counted(
                "microp chunk 1", n, lambda: drv.run(
                    model, state0, cam_in, n, out_dir=str(root / "a"),
                    chunk=1, **io))
            drv.ChainGraph = Timed
            (st_b, tm_b), wall_b = self.counted(
                f"microp chunk {k}", 1 + 2 * (n - 1), lambda: drv.run(
                    model, state0, cam_in, n, out_dir=str(root / "b"),
                    chunk=k, **io))
        finally:
            drv.ChainGraph = saved
        try:
            if not bitwise_equal(st_b, st_a):
                raise RuntimeError("driver microp: the chunked run's state "
                                   "differs from the eager run's")
            diff, missing = [], []
            for t in ("h0.0000.nc", "h0.0001.nc"):
                ta = self.read_tape(root / "a" / t)
                tb = self.read_tape(root / "b" / t)
                diff += [f"{t} {v}" for v, x in ta.items()
                         if x.tobytes() != tb[v].tobytes()]
                missing += [f"{t} {v}" for v in MICROP_TAPE
                            if v not in ta or not np.isfinite(ta[v]).all()]
            if diff or missing:
                raise RuntimeError(f"driver microp: tape arrays differ "
                                   f"{diff[:10]}; microp fields missing or "
                                   f"not finite {missing}")
        finally:
            shutil.rmtree(root, ignore_errors=True)
        rep = [t / m for kind, m, t in timed if kind == "replay" and m == k]
        cap = [(m, t) for kind, m, t in timed if kind == "capture"]
        log(f"driver microp at {IM}x{JM}x{KM} float32 [{self.card}]: chunk 1 "
            f"{1e3 * wall_a / n:.2f} ms a step with the IO (atm_step "
            f"{1e3 * tm_a.totals['atm_step'] / n:.2f}); chunk {k} "
            f"{1e3 * wall_b / n:.2f} ms a step with the captures and IO; "
            f"captures " + ", ".join(f"{m} steps {t:.1f} s" for m, t in cap)
            + f"; the {k}-step graph's first replay {1e3 * rep[0]:.2f} ms a "
            f"step; state and both tapes bitwise equal to chunk 1, the "
            f"microp fields {list(MICROP_TAPE)} on the tape, finite")
        return rep[0]

    def run(self, coupled_ms) -> None:
        import shutil
        try:
            with self.recorded_writers():
                self._run(coupled_ms)
        finally:
            shutil.rmtree(self.root, ignore_errors=True)

    def _run(self, coupled_ms) -> None:
        import shutil
        torch, drv = self.torch, self.drv
        from cam_nor_physics_tpu_torch.bench import bitwise_equal, tensors
        from cam_nor_physics_tpu_torch.entry import build_coupled
        from cam_nor_physics_tpu_torch.models.coupling.surface_fluxes import \
            bulk_surface_fluxes
        from cam_nor_physics_tpu_torch.utils.checkpoint import \
            restore_checkpoint
        shutil.rmtree(self.root, ignore_errors=True)
        model, _, state0, sst = build_coupled(IM, JM, KM, torch.float32,
                                              DEVICE)
        cam_in = bulk_surface_fluxes(state0.phys, sst, model.registry.pcnst)
        self.one = self.cs.expected(model)
        n, k = DRIVER_STEPS, DRIVER_CHUNK
        half = n // 2
        dirs = {x: self.root / x for x in ("a", "b", "c", "long", "e")}
        io = dict(hist_every=half, ckpt_every=half, check_every=half)

        # (a) chunk 1: every step eager
        (st_a, tm_a), wall_a = self.counted(
            "(a) chunk 1", n, lambda: drv.run(
                model, state0, cam_in, n, out_dir=str(dirs["a"]), chunk=1,
                **io))
        tapes = {t: self.read_tape(dirs["a"] / t)
                 for t in ("h0.0000.nc", "h0.0001.nc")}
        bad = [f"{t} {v}" for t, d in tapes.items() for v, a in d.items()
               if not np.isfinite(a).all()]
        cks = [dirs["a"] / f"ckpt_{i:06d}" for i in (half, n)]
        missing = [str(c) for c in cks if not (c / "state.npz").is_file()
                   or not (c / "meta.json").is_file()]
        if bad or missing or len(tapes["h0.0000.nc"]) < 150:
            raise RuntimeError(f"driver (a): non-finite tape fields {bad}, "
                               f"checkpoints missing {missing}")
        tape_bytes = [(dirs["a"] / t).stat().st_size for t in tapes]
        ckpt_bytes = [self.dir_bytes(c) for c in cks]
        log(f"driver (a): tapes {list(tapes)} open with scipy, "
            f"{len(tapes['h0.0000.nc'])} variables each, all finite, "
            f"{tape_bytes} bytes; checkpoints {[c.name for c in cks]}, "
            f"{ckpt_bytes} bytes")
        log("driver (a) phase table:\n" + tm_a.table())

        # (b) chunk 8: the first step eager, then CUDA graphs of 7 and 8
        # steps, each captured once (its check runs the same steps eagerly)
        lengths = {min(k - i % k, n - i) for i in range(1, n)
                   if i == 1 or i % k == 0}
        (st_b, tm_b), wall_b = self.counted(
            f"(b) chunk {k}", 1 + 2 * sum(lengths), lambda: drv.run(
                model, state0, cam_in, n, out_dir=str(dirs["b"]), chunk=k,
                **io))
        if not bitwise_equal(st_b, st_a):
            raise RuntimeError("driver (b): the chunked run's state differs "
                               "from the eager run's")
        diff = [f"{t} {v}" for t, d in tapes.items()
                for v, a in self.read_tape(dirs["b"] / t).items()
                if a.tobytes() != d[v].tobytes()]
        if diff:
            raise RuntimeError(f"driver (b): tape arrays differ from (a)'s: "
                               f"{diff[:10]}")
        shutil.rmtree(dirs["b"], ignore_errors=True)
        log(f"driver (b): CUDA graphs of {sorted(lengths)} steps, each "
            f"first replay held bitwise to the same steps run eagerly; "
            f"state after {n} steps and every array of both tapes bitwise "
            f"equal to (a)'s")
        log("driver (b) phase table:\n" + tm_b.table())

        # (c) resume from (a)'s checkpoint at step 8, 8 steps in one graph
        (st_c, _), _ = self.counted(
            "(c) resume", 2 * k, lambda: drv.run(
                model, self.zeros_like(state0), cam_in, n - half,
                out_dir=str(dirs["c"]), chunk=k,
                resume_from=str(cks[0])))
        if int(st_c.nstep) != n or not bitwise_equal(st_c, st_a):
            raise RuntimeError("driver (c): the run resumed from step "
                               f"{half} differs from (a) after step {n}")
        log(f"driver (c): resumed from {cks[0].name}, {n - half} steps as "
            f"one graph, bitwise equal to (a) after step {n}")

        # the chunked loop's replays and boundaries, timed: resumed from
        # step 8 for DRIVER_LONG steps (one capture, then replays)
        (_, tm_l), wall_l = self.counted(
            f"resumed {DRIVER_LONG} steps", 2 * k, lambda: drv.run(
                model, self.zeros_like(state0), cam_in, DRIVER_LONG,
                out_dir=str(dirs["long"]), chunk=k, hist_every=k,
                ckpt_every=2 * k, check_every=k, resume_from=str(cks[0])))
        log(f"driver resumed {DRIVER_LONG} steps, chunk {k}, phase table:\n"
            + tm_l.table())
        shutil.rmtree(dirs["long"], ignore_errors=True)

        # (d) a NaN in dyn.u of the step-8 state: the chunked run aborts
        # at its check boundary and names step 1 exactly
        bad_state = restore_checkpoint(str(cks[0]), self.zeros_like(state0))
        bad_state.dyn.u[0, 4, 4] = float("nan")

        def abort_run():
            try:
                drv.run(model, bad_state, cam_in, k, out_dir=str(dirs["a"]),
                        chunk=k, check_every=k)
            except drv.BlowupError as err:
                return str(err)
            raise RuntimeError("driver (d): no BlowupError on a NaN state")

        reason, _ = self.counted("(d) abort", 2 * k, abort_run)
        with open(dirs["a"] / "ABORT.json") as f:
            rec = json.load(f)
        want = {"failed_step": 1, "detected_step": k, "exact": True,
                "failed_within": [0, 1]}
        if any(rec.get(key) != v for key, v in want.items()) or not str(
                rec.get("last_good_checkpoint")).endswith(cks[1].name):
            raise RuntimeError(f"driver (d): ABORT.json {rec}, expected "
                               f"{want} and last_good_checkpoint "
                               f"{cks[1].name}")
        log(f"driver (d): BlowupError ({reason}); ABORT.json {rec}")

        # (e) run_coupled: the surface fluxes from the evolving state
        m0 = self.cs.dry_mass(model, state0)
        out_e, _ = self.counted(
            "(e) run_coupled", 4, lambda: drv.run_coupled(
                model, state0, sst, 4, out_dir=str(dirs["e"]), hist_every=2))
        st_e, sst_e, _ = out_e
        drift = abs(self.cs.dry_mass(model, st_e) - m0) / m0
        nonfinite = [i for i, t in enumerate(tensors((st_e, sst_e)))
                     if t.is_floating_point()
                     and not bool(torch.isfinite(t).all())]
        tape_e = self.read_tape(dirs["e"] / "h0.0001.nc")
        if nonfinite or drift > 4 * DRIFT_TOL or not all(
                np.isfinite(a).all() for a in tape_e.values()):
            raise RuntimeError(f"driver (e): non-finite tensors {nonfinite} "
                               f"or drift {drift:.3e} > {4 * DRIFT_TOL}")
        log(f"driver (e): run_coupled 4 steps, finite, dry-mass drift "
            f"{drift:.3e} (tol {4 * DRIFT_TOL:.0e}, 4 steps), tapes finite")

        # the per-step payload and its accumulation into h0's buffers (the
        # work the chunked loop's graph adds to each step), profiled
        from cam_nor_physics_tpu_torch.bench import kernel_times
        from cam_nor_physics_tpu_torch.models.atm_comp import atm_step
        from cam_nor_physics_tpu_torch.models.physics.cam_diagnostics import \
            amwg_core_fields
        reg = drv._history_registry(amwg_core_fields() +
                                    ["US", "VS", "PRECCMX"])
        tapes = drv._HistoryTapes(reg, model, torch.float32, k, dirs["e"])
        area = drv._grid_area(model.grid, torch.float32)
        s1, cam_out, diags = atm_step(model, st_a, cam_in)
        by_name, wall = kernel_times(lambda: tapes.accumulate(
            lambda: drv._step_payload(s1, cam_in, cam_out, diags, area)))
        tapes.close()
        log(f"driver payload + outfld a step [{self.card}]: "
            f"{sum(c for c, _ in by_name.values())} device kernels, "
            f"{sum(us for _, us in by_name.values()) / 1e3:.3f} ms device, "
            f"{1e3 * wall:.2f} ms wall under the profiler; "
            f"{len(tapes.bufs[0])} fields on h0")
        del s1, cam_out, diags, tapes

        routes = sorted(set(self.writers))
        if not self.writers or any(not native for _, native in routes):
            raise RuntimeError(f"driver: writers {routes}, expected native")
        steady = tm_l.totals["atm_step"] / (tm_l.counts["atm_step"] * k)
        t_step, t_graph = coupled_ms
        log(f"driver at {IM}x{JM}x{KM} float32 [{self.card}]: (a) chunk 1 "
            f"{1e3 * wall_a / n:.2f} ms a step with IO "
            f"(atm_step {1e3 * tm_a.totals['atm_step'] / n:.2f}); (b) "
            f"chunk {k} {1e3 * wall_b / n:.2f} ms a step with the captures "
            f"and IO; the chunked loop's replays {1e3 * steady:.2f} ms a "
            f"step (history_write "
            f"{1e3 * tm_l.totals['history_write'] / tm_l.counts['history_write']:.2f}"
            f" ms, checkpoint "
            f"{1e3 * tm_l.totals['checkpoint'] / tm_l.counts['checkpoint']:.2f}"
            f" ms a boundary); the bench's coupled step "
            f"{1e3 * t_step:.2f} ms per dispatch, {1e3 * t_graph:.2f} ms "
            f"as a graph; writers {routes}")


# phase 15: the diagnostics each microp step keeps, and those its tape holds
MICROP_KEEP = ("QNLZM", "ACTIV_N", "ZMFRZ", "ZMDCAPE")
AOD_KEYS = ("AODVIS_accum", "AODABS_accum", "AODNIR_accum", "AODUV_accum",
            "BURDEN_accum")
MICROP_TAPE = ("ZMFRZ", "ZMDCAPE", "WUZM", "DNLFZM", "DNIFZM", "CLDICEZM",
               "ZMSPRD", "ACTIV_N", "BERGN_M")


def run_microp(torch, sm: Smoke, card: str, coupled_ms) -> None:
    """Phase 15: the coupled step with ZM's in-plume microphysics
    (entry.build_coupled(microp=True), bench.py's BENCH_MICROP=1) at f19,
    float32; the aerosol configuration; the driver with microp."""
    from cam_nor_physics_tpu_torch.entry import build_coupled
    cs = CoupledSmoke(torch, sm, card)
    model, step, state, _ = build_coupled(IM, JM, KM, torch.float32,
                                          DEVICE, microp=True)
    state, times, kept = cs.counted_steps("f19 microp", model, step, state,
                                          COUPLED_STEPS, keep=MICROP_KEEP)
    for i, d in enumerate(kept):
        dead = [k for k in ("ZMFRZ", "ZMDCAPE")
                if not bool(torch.isfinite(d[k]).all())
                or not bool((d[k] != 0).any())]
        if dead:
            raise RuntimeError(f"coupled microp step {i + 1}: {dead} not "
                               f"finite or all zero")
    log("coupled microp f19 by step: ZMFRZ max "
        + ", ".join(f"{float(d['ZMFRZ'].max()):.4e}" for d in kept)
        + " K/s; ZMDCAPE max "
        + ", ".join(f"{float(d['ZMDCAPE'].max()):.4e}" for d in kept)
        + " J/kg; triggered columns "
        + ", ".join(str(int((d["ZMDCAPE"] != 0).sum())) for d in kept))
    cs.parity64(microp=True)
    torch.cuda.empty_cache()
    profile_call(f"coupled microp step (prog_only) {IM}x{JM}x{KM}",
                 lambda: step(state), card)
    del state
    torch.cuda.empty_cache()

    # the aerosol configuration: the first step's activation reads the
    # registration's zero NAER, the second the first step's
    model_a, step_a, state_a, _ = build_coupled(
        IM, JM, KM, torch.float32, DEVICE, microp=True, aerosol=True)
    state_a, _, akept = cs.counted_steps("f19 microp+aerosol", model_a,
                                         step_a, state_a, 1,
                                         keep=MICROP_KEEP + AOD_KEYS)
    pb = state_a.pbuf
    bad = [k for k in ("NAER", "DGNUMWET")
           if not bool(torch.isfinite(pb.get(k)).all())
           or not bool((pb.get(k) > 0).all())]
    bad += [k for k in AOD_KEYS for d in akept
            if not bool(torch.isfinite(d[k]).all())
            or not bool((d[k] > 0).all())]
    lag = float(akept[0]["QNLZM"].abs().max())
    differs = not torch.equal(akept[1]["QNLZM"], kept[1]["QNLZM"])
    log(f"coupled microp+aerosol f19: NAER [{float(pb.get('NAER').min()):.4e}"
        f", {float(pb.get('NAER').max()):.4e}] 1/kg, DGNUMWET "
        f"[{float(pb.get('DGNUMWET').min()):.4e}, "
        f"{float(pb.get('DGNUMWET').max()):.4e}] m; AODVIS by step "
        + ", ".join(f"[{float(d['AODVIS_accum'].min()):.4e}, "
                    f"{float(d['AODVIS_accum'].max()):.4e}]" for d in akept)
        + f"; QNLZM max step 1 {lag:.4e} (the registration's zero NAER), "
        f"step 2 {float(akept[1]['QNLZM'].max()):.4e} against "
        f"{float(kept[1]['QNLZM'].max()):.4e} without aerosol "
        f"({'differs' if differs else 'EQUAL'})")
    if bad or lag != 0.0 or not differs or \
            float(akept[1]["QNLZM"].max()) <= 0.0:
        raise RuntimeError(f"coupled microp+aerosol: bad {bad}, step-1 "
                           f"QNLZM {lag}, step 2 differs {differs}")
    del state_a, pb, akept
    torch.cuda.empty_cache()
    t_graph = DriverSmoke(torch, sm, card).run_microp()
    t_dispatch = min(times[1:])
    npts = IM * JM * KM
    log(f"coupled microp step at {IM}x{JM}x{KM} float32 [{card}]: per "
        f"dispatch {1e3 * t_dispatch:.2f} ms (the fastest of steps 2-"
        f"{COUPLED_STEPS + 1}), as a graph {1e3 * t_graph:.2f} ms -> "
        f"{npts / t_graph:.6e} grid points/s; without microp (phase 13) "
        f"{1e3 * coupled_ms[0]:.2f} / {1e3 * coupled_ms[1]:.2f} ms")


# phase 16: the other modes at f19
MODES_STEPS = 8            # (A): JW06 steps with the fixer, eager and a graph
MODES_F64_STEPS = 2        # float64 steps, kernels vs plain
MODES_TOL_F64 = 1e-9
MODES_DT = 1800.0
CORR_DT = 450.0            # (B): one small step, nsplit = nspltrac = 1
JW_SPECIES = (("O", 1), ("O2", 2), ("H", 3))
AM_KEYS = ("AM_DU3S", "AM_DUFIX", "AM_TOTAL")
TEM_KEYS = ("U2d", "V2d", "W2d", "TH2d", "VTH2d", "WTH2d", "UV2d", "UW2d")
IC_TOL_F64 = 1e-13         # (F): delp and pt through T and PS and back
OFFLINE_TOL = 1e-12
SCAM_NCOL, SCAM_STEPS = 16, 48     # (G): a simulated day on 16 columns
SCAM_TOL_F64 = 1e-9


def rel_diffs(got: dict, want: dict) -> dict:
    """max|g - w| / max|w| per key (NaN where a value is not finite)."""
    out = {}
    for k, w in want.items():
        g, w = got[k].double().cpu(), w.double().cpu()
        if not (bool(g.isfinite().all()) and bool(w.isfinite().all())):
            out[k] = float("nan")
            continue
        out[k] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                  1e-300)
    return out


def dyn_fields(state) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


class ModesSmoke:
    """Phase 16: the dycore's options (the AM fixer and correction,
    high-altitude κ, the debug terms), the coupled step with Rayleigh
    friction and the TEM diagnostics, IC and met files with the offline
    dynamics, and SCAM, at f19 on the card."""

    def __init__(self, torch, sm: Smoke, card: str):
        from cam_nor_physics_tpu_torch.models.fv import (baroclinic_wave,
                                                         cd_core, dyn_comp,
                                                         grid, inidat,
                                                         metdata, vertical)
        from cam_nor_physics_tpu_torch.utils import constants
        from cam_nor_physics_tpu_torch.utils.config import FVConfig
        self.zvir = constants.ZVIR
        self.torch, self.sm, self.card = torch, sm, card
        self.bw, self.cd, self.dc = baroclinic_wave, cd_core, dyn_comp
        self.grid_mod, self.vert = grid, vertical
        self.ini, self.met = inidat, metdata
        self.FVConfig = FVConfig
        self.out = REPO / "cam_nor_physics_tpu_torch" / "build" / \
            "modes_smoke"
        self.out.mkdir(parents=True, exist_ok=True)

    def fv(self, dtype, device=None):
        device = device or DEVICE
        return (self.grid_mod.make_grid(IM, JM, KM, dtype, device),
                self.vert.hybrid_coefficients(KM, dtype=dtype,
                                              device=device))

    def jw(self, dtype, nq=1, device=None):
        device = device or DEVICE
        grid, coord = self.fv(dtype, device)
        state, phis = self.bw.jw_baroclinic_wave(grid, coord, perturb=True,
                                                 nq=nq, dtype=dtype,
                                                 device=device)
        return grid, coord, state, phis

    def am(self, state, grid64):
        """Global axial AM in float64."""
        s = state.replace(**{k: v.double()
                             for k, v in dyn_fields(state).items()})
        return float(self.dc.axial_angular_momentum(s, grid64))

    def gate_rel(self, label, rel, tol):
        worst = max(rel, key=lambda k: (math.isnan(rel[k]), rel[k]))
        log(f"{label}: worst {worst} {rel[worst]:.3e} (tol {tol:.0e}); "
            + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        if math.isnan(rel[worst]) or rel[worst] > tol:
            raise RuntimeError(f"{label}: {worst} {rel[worst]:.3e} > {tol}")

    def kernels_vs_plain(self, label, run, tol=MODES_TOL_F64):
        """run() through the kernels and through their plain versions;
        each tensor of the two results' dicts within tol of its max."""
        got = run()
        with self.sm.routed(self.sm.plain):
            want = run()
        self.torch.cuda.synchronize()
        self.gate_rel(f"{label}, kernels vs plain", rel_diffs(got, want),
                      tol)

    # ---- (A) JW06 with the AM fixer
    def jw_fixer(self, hs_ms):
        torch, sm = self.torch, self.sm
        grid, coord, s0, phis = self.jw(torch.float32)
        grid64, _ = self.fv(torch.float64)
        cfg = self.FVConfig(am_fixer=True, am_fix_taper=True, am_diag=True)
        want = dyn_launches(sm, cfg, MODES_DT, grid)

        def step(s):
            return self.dc.dyn_run(s, grid, coord, phis, cfg, MODES_DT,
                                   return_diags=True)

        am0, s, times, kept = self.am(s0, grid64), s0, [], [s0]
        for i in range(MODES_STEPS):
            sm.zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, d = step(s)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            got = sm.counts()
            if got != want:
                raise RuntimeError(f"JW06 fixer step {i + 1} launched {got}, "
                                   f"expected {want}")
            bad = [k for k in AM_KEYS + ("du_fix_s",)
                   if not bool(d[k].isfinite().all())]
            if bad or not all(bool(t.isfinite().all())
                              for t in dyn_fields(s).values()):
                raise RuntimeError(f"JW06 fixer step {i + 1}: not finite "
                                   f"{bad}")
            if i in (3, 7):
                kept.append(s)
        log(f"JW06 fixer f19 float32: launches a step {want} (exact, "
            f"{MODES_STEPS} steps); AM_DU3S {float(d['AM_DU3S']):.6e}, "
            f"AM_DUFIX {float(d['AM_DUFIX']):.6e}, AM_TOTAL "
            f"{float(d['AM_TOTAL']):.6e} (step {MODES_STEPS})")
        drift = abs(self.am(s, grid64) - am0) / abs(am0)
        s_nof = s0
        for _ in range(MODES_STEPS):
            s_nof = self.dc.dyn_run(s_nof, grid, coord, phis,
                                    self.FVConfig(), MODES_DT)
        drift_nof = abs(self.am(s_nof, grid64) - am0) / abs(am0)
        log(f"JW06 f19 float32, relative AM drift over {MODES_STEPS} steps: "
            f"with the fixer {drift:.3e}, without {drift_nof:.3e}")
        if not drift < drift_nof:
            raise RuntimeError("JW06: the fixer's AM drift is not smaller "
                               "than without it")
        graph_ms = sm.graph_check("JW06 fixer", lambda x: (step(x)[0],),
                                  (s,))
        dispatch = min(times[1:])
        log(f"JW06 fixer step at {IM}x{JM}x{KM} float32 [{self.card}]: per "
            f"dispatch {1e3 * dispatch:.2f} ms (the fastest of steps 2-"
            f"{MODES_STEPS}), as a graph {1e3 * graph_ms:.3f} ms; the HS "
            f"step as a graph (phase 10) "
            + (f"{1e3 * hs_ms:.3f} ms" if hs_ms else "not measured here"))
        g64, c64, s64, p64 = self.jw(torch.float64)

        ends = []

        def run64():
            x = s64
            for _ in range(MODES_F64_STEPS):
                x, dd = self.dc.dyn_run(x, g64, c64, p64, cfg, MODES_DT,
                                        return_diags=True)
            ends.append(x)
            return {**dyn_fields(x), **{k: dd[k] for k in AM_KEYS}}

        self.kernels_vs_plain(f"JW06 fixer float64, {MODES_F64_STEPS} steps",
                              run64)
        return kept, ends[0]

    # ---- (B) the AM correction over topography
    def am_correction(self):
        torch = self.torch
        grid, coord, s, phis = self.jw(torch.float64)
        lat = np.linspace(-np.pi / 2, np.pi / 2, JM)
        lon = np.linspace(0, 2 * np.pi, IM, endpoint=False)
        phis = phis + torch.as_tensor(
            1500.0 * 9.80616 * np.exp(-((lat[:, None] - 0.7) / 0.3) ** 2)
            * (1.0 + np.cos(lon)[None, :]), dtype=torch.float64,
            device=DEVICE)
        for _ in range(2):          # spin up: the JW ps is uniform
            s = self.dc.dyn_run(s, grid, coord, phis, self.FVConfig(),
                                MODES_DT)
        am0 = float(self.dc.axial_angular_momentum(s, grid))
        tq = float(self.dc.mountain_torque(s, phis, grid, coord.ptop))
        mism = {}
        for flag in (False, True):
            s1 = self.dc.dyn_run(s, grid, coord, phis,
                                 self.FVConfig(am_correction=flag, nsplit=1,
                                               nspltrac=1), CORR_DT)
            mism[flag] = abs(float(self.dc.axial_angular_momentum(
                s1, grid)) - am0 - CORR_DT * tq) / abs(am0)
        log(f"AM correction f19 float64, one small step of {CORR_DT:.0f} s "
            f"over the mountain: torque {tq:.6e}; |AM_after - AM_before - "
            f"dt torque| / |AM| with the correction {mism[True]:.3e}, "
            f"without {mism[False]:.3e} (tests/test_am_flags.py's bound: "
            f"< 0.25 x without)")
        if tq == 0.0 or not mism[True] < 0.25 * mism[False]:
            raise RuntimeError(f"AM correction: torque {tq}, mismatch "
                               f"{mism}")

    # ---- (C) high-altitude κ
    def high_altitude(self):
        torch, sm = self.torch, self.sm
        grid, coord, s, phis = self.jw(torch.float64, nq=4)
        lat = torch.linspace(-1.0, 1.0, JM, dtype=torch.float64,
                             device=DEVICE)
        lon = torch.linspace(0, 2 * math.pi, IM + 1, dtype=torch.float64,
                             device=DEVICE)[:-1]
        o = torch.linspace(0.4, 0.0, KM, dtype=torch.float64,
                           device=DEVICE)[:, None, None] * \
            (0.6 + 0.4 * torch.cos(lat)[None, :, None]) * \
            (1.0 + 0.3 * torch.cos(lon)[None, None, :])
        q = s.q.clone()
        q[1], q[2], q[3] = o, 0.2, 0.01 * o
        s = s.replace(q=q)
        cfg = self.FVConfig(high_altitude=True, major_species=JW_SPECIES)
        seen, args, orig = [], [], self.dc.tracer_div3d

        def rec(qq, *a, **kw):
            seen.append(qq.shape[0])
            args.append(((qq,) + a, kw))
            return orig(qq, *a, **kw)

        def run():
            x = s
            for _ in range(MODES_F64_STEPS):
                x = self.dc.dyn_run(x, grid, coord, phis, cfg, MODES_DT)
            return dyn_fields(x)

        sm.zero_counts()
        self.dc.tracer_div3d = rec
        try:
            run()
        finally:
            self.dc.tracer_div3d = orig
        torch.cuda.synchronize()
        log(f"high_altitude f19 float64: tracer_div3d took {sorted(set(seen))}"
            f" tracers (nq + 1), {sm.counts()['tracer_div3d']} launches in "
            f"{MODES_F64_STEPS} steps")
        if set(seen) != {5} or sm.counts()["tracer_div3d"] == 0:
            raise RuntimeError(f"high_altitude: tracer_div3d saw {seen}")
        self.kernels_vs_plain(f"high_altitude float64, {MODES_F64_STEPS} "
                              f"steps", run)
        # tracer_div3d on the five-tracer stack this path gives it: against
        # its plain version, and timed against the same call on one tracer
        a, kw = args[0]
        for dt in ("float32", "float64"):
            sm.compare("tracer_div3d[nq+1=5]", "tracer_div3d", a, kw, dt)
        a, kw = sm.cast(a, kw, torch.float32)
        ms5 = sm.time_call(sm.kernel("tracer_div3d"), a, kw, 50)
        plain5 = sm.time_call(sm.plain("tracer_div3d"), a, kw, 5)
        ms1 = sm.time_call(sm.kernel("tracer_div3d"),
                           (a[0][:1].contiguous(),) + a[1:], kw, 50)
        log(f"time tracer_div3d float32 [{self.card}]: 5 tracers "
            f"{ms5:.4f} ms (plain {plain5:.4f} ms), 1 tracer {ms1:.4f} ms "
            f"a call (x{ms5 / ms1:.2f})")

    # ---- (E) the debug terms
    def debug_terms(self):
        torch, sm = self.torch, self.sm
        grid, coord, s, phis = self.jw(torch.float32)
        kw = dict(c_sw_pgf=True, filter_impl="fft")
        sm.zero_counts()
        s1, d1 = self.cd.cd_step(s, grid, coord.ptop, phis, 450.0,
                                 return_debug=True, **kw)
        torch.cuda.synchronize()
        counts = {k: v for k, v in sm.counts().items() if v}
        s0, d0 = self.cd.cd_step(s, grid, coord.ptop, phis, 450.0,
                                 fused=False, **kw)
        dbg = d1.pop("debug")
        same = all(torch.equal(a, b) for a, b in zip(
            dyn_fields(s1).values(), dyn_fields(s0).values())) and \
            all(torch.equal(d1[k], d0[k]) for k in d0)
        bad = [k for k, v in dbg.items() if not bool(v.isfinite().all())]
        log(f"cd_step(return_debug=True) f19 float32: the unfused step "
            f"(launches {counts}); state and diagnostics bitwise equal to "
            f"return_debug=False: {same}; {len(dbg)} debug terms, not "
            f"finite: {bad}")
        if not same or bad or not counts.get("transport3d") \
                or not counts.get("vort_flux3d"):
            raise RuntimeError("cd_step(return_debug=True) failed")

    # ---- (F) IC files, met files and the offline dynamics
    def files(self, kept, s):
        """(A)'s float64 state `s` (after its float64 steps through the
        kernels: on the hybrid coordinate) through an IC file, and (A)'s
        float32 states `kept` (steps 0, 4, 8) as a met file."""
        torch = self.torch
        grid, coord = self.fv(torch.float64)
        _, phis = self.bw.jw_baroclinic_wave(grid, coord, device=DEVICE)
        path = str(self.out / "ic.nc")
        self.ini.write_inidat(path, s, phis, grid, coord)
        back, bphis = self.ini.read_inidat(path, grid, coord, device=DEVICE)
        exact = {"u": torch.equal(back.u[:, 1:], s.u[:, 1:]),
                 "v": torch.equal(back.v[:, 1:-1], s.v[:, 1:-1]),
                 "q": torch.equal(back.q, s.q),
                 "phis": torch.equal(bphis.cpu(), torch.as_tensor(
                     self.ini.pole_average(phis.cpu().numpy())))}
        rel = rel_diffs({"delp": back.delp, "pt": back.pt},
                        {"delp": s.delp, "pt": s.pt})
        log(f"IC file f19 float64 ({(self.out / 'ic.nc').stat().st_size} B):"
            f" read back on the card, bitwise {exact}; delp {rel['delp']:.3e}"
            f", pt {rel['pt']:.3e} (through PS and T; tol {IC_TOL_F64:.0e})")
        if not all(exact.values()) or max(rel.values()) > IC_TOL_F64:
            raise RuntimeError(f"IC round trip: {exact} {rel}")
        # the file holds u on edge rows 1..jm-1 (US); row 0, the south
        # pole's edge, reads as 0 (the fixer's increment reaches it)
        u0 = s.u.clone()
        u0[:, 0] = 0.0
        cfg = self.FVConfig()
        a = self.dc.dyn_run(back, grid, coord, phis, cfg, MODES_DT)
        b = self.dc.dyn_run(s.replace(u=u0), grid, coord, phis, cfg,
                            MODES_DT)
        self.gate_rel("dyn_run from the read-back IC vs the in-memory "
                      "state, float64", rel_diffs(dyn_fields(a),
                                                  dyn_fields(b)),
                      MODES_TOL_F64)
        # three of (A)'s states as a met file, and the offline steps
        path = str(self.out / "met.nc")
        g32, c32 = self.fv(torch.float32)
        recs = []
        for x in kept:
            pe, _, pkz, _ = self.cd.pressure_vars(x.delp, c32.ptop)
            recs.append((x.u, x.v, x.pt * pkz / (1.0 + self.zvir * x.q[0]),
                         pe[-1], x.q[0]))
        times = [0.0, 4 * MODES_DT, MODES_STEPS * MODES_DT]
        self.met.save_metdata_netcdf(
            path, times, *(torch.stack([r[i] for r in recs])
                           for i in range(4)),
            [torch.stack([r[4] for r in recs])])
        runs = {}
        for dev in (DEVICE, "cpu"):
            _, c64 = self.fv(torch.float64, dev)
            met = self.met.load_metdata_netcdf(path, c64, device=dev)
            x = s.replace(**{k: v.to(dev) for k, v in dyn_fields(s).items()})
            for i in range(MODES_STEPS):
                x = self.met.offline_dyn_run(x, met, i * MODES_DT, MODES_DT,
                                             met_rlx=0.5)
            runs[dev] = dyn_fields(x)
        self.gate_rel(f"offline_dyn_run, {MODES_STEPS} steps through the met"
                      f" file, card vs CPU float64", rel_diffs(
                          runs[DEVICE], runs["cpu"]), OFFLINE_TOL)

    # ---- (G) SCAM
    def scam(self):
        torch, sm = self.torch, self.sm
        from cam_nor_physics_tpu_torch import entry
        from cam_nor_physics_tpu_torch.models import scam
        from cam_nor_physics_tpu_torch.models.coupling.camsrfexch import \
            CamIn
        from cam_nor_physics_tpu_torch.models.physics.constituents import \
            default_registry
        from cam_nor_physics_tpu_torch.utils.config import (PhysConfig,
                                                             ZMConfig)
        zs = ZMSmoke(torch, sm)
        for n in (1, SCAM_NCOL):
            args = zs.capture(*entry.varied_zm_inputs(n, KM, torch.float32,
                                                      DEVICE))
            for dt in ("float32", "float64"):
                zs.compare_tail(*args, dt, label=f"zm_tail ncol {n}")
        # a day of IOP forcing, a record every 3 h
        rng = np.random.default_rng(16)
        tsec = np.arange(9) * 10800.0
        diurnal = np.sin(2 * np.pi * tsec / 86400.0)[:, None]
        path = str(self.out / "iop.nc")
        scam.save_iop_netcdf(
            path, tsec, -1e-5 * (1.0 + 0.5 * diurnal) *
            rng.uniform(0.5, 1.0, (9, KM)),
            1e-8 * rng.uniform(0.0, 1.0, (9, KM)),
            -0.05 * rng.uniform(0.0, 1.0, (9, KM)),
            20.0 + 15.0 * diurnal[:, 0], 80.0 + 40.0 * diurnal[:, 0])
        reg = default_registry()

        def run(dtype, dev):
            st, _, fo = entry.varied_zm_inputs(SCAM_NCOL, KM, dtype, dev)
            ci = CamIn.zeros(SCAM_NCOL, reg.pcnst, dtype, dev).replace(
                landfrac=fo["landfrac"], ocnfrac=1.0 - fo["landfrac"])
            iop = scam.load_iop_netcdf(path, dtype, dev)
            return scam.scam_run_iop(PhysConfig(), ZMConfig(), reg, st, ci,
                                     iop, MODES_DT, SCAM_STEPS)

        sm.zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, pbuf, series = run(torch.float32, DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in sm.counts().items() if v}
        fin = all(bool(t.isfinite().all()) for t in
                  list(dyn_fields(st).values()) + list(series.values()))
        log(f"SCAM f32 {SCAM_NCOL} columns x {KM} levels, {SCAM_STEPS} steps"
            f" (a day) through scam_run_iop: launches {got}; finite {fin}; "
            f"precc max {float(series['precc'].max()):.4e} m/s, columns "
            f"precipitating {int((series['precc'].amax(0) > 0).sum())}; "
            f"{1e3 * wall / SCAM_STEPS:.1f} ms a step per dispatch "
            f"[{self.card}]")
        launched = got
        runs = {dev: run(torch.float64, dev) for dev in (DEVICE, "cpu")}
        idx = ("ZM_IDEEP", "ZM_JT", "ZM_MAXG")
        flips = int(sum((runs[DEVICE][1].get(k).cpu() !=
                         runs["cpu"][1].get(k)) for k in idx).gt(0).sum())
        got, want = ({**{f"state.{k}": v for k, v in
                         dyn_fields(r[0]).items()},
                      **{f"series.{k}": v for k, v in r[2].items()}}
                     for r in (runs[DEVICE], runs["cpu"]))
        log(f"SCAM float64, {SCAM_STEPS} steps: columns whose ZM trigger or "
            f"level indices differ at the end, card vs CPU: {flips} of "
            f"{SCAM_NCOL}")
        self.gate_rel(f"SCAM float64, {SCAM_STEPS} steps, card vs CPU",
                      rel_diffs(got, want), SCAM_TOL_F64)
        want = {"zm_tail": SCAM_STEPS, "zm_parcel": SCAM_STEPS *
                parcel_launches(torch, ZMConfig(), KM)}
        if launched != want or not fin:
            raise RuntimeError(f"SCAM: launches {launched}, finite {fin}")
        return wall / SCAM_STEPS


def run_modes(torch, sm: Smoke, card: str, hs_ms) -> None:
    """Phase 16: the other modes at f19 (ModesSmoke)."""
    from cam_nor_physics_tpu_torch.entry import build_coupled
    ms = ModesSmoke(torch, sm, card)
    t = {}

    def part(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        t[name] = time.perf_counter() - t0
        return out

    kept, s64 = part("A", ms.jw_fixer, hs_ms)
    part("B", ms.am_correction)
    part("C", ms.high_altitude)
    torch.cuda.empty_cache()
    # (D) the coupled step with Rayleigh friction and the TEM diagnostics
    t0 = time.perf_counter()
    cs = CoupledSmoke(torch, sm, card)
    phys = dict(raytau0=5.0, do_circulation_diags=True)
    model, step, state, _ = build_coupled(IM, JM, KM, torch.float32, DEVICE,
                                          **phys)
    state, _, kept_d = cs.counted_steps("f19 rayleigh+TEM", model, step,
                                        state, 2, keep=TEM_KEYS)
    bad = [k for d in kept_d for k in TEM_KEYS
           if tuple(d[k].shape) != (KM, JM) or not bool(d[k].isfinite().all())]
    log("coupled rayleigh+TEM f19: U2d max by step "
        + ", ".join(f"{float(d['U2d'].max()):.4e}" for d in kept_d)
        + " m/s; VTH2d absmax "
        + ", ".join(f"{float(d['VTH2d'].abs().max()):.4e}" for d in kept_d)
        + f" K m/s; bad {bad}")
    if bad:
        raise RuntimeError(f"coupled rayleigh+TEM: TEM fields {bad}")
    coupled_graph = cs.graph(step, state)
    del state
    torch.cuda.empty_cache()
    cs.parity64(tag="coupled rayleigh+TEM", **phys)
    torch.cuda.empty_cache()
    t["D"] = time.perf_counter() - t0
    part("E", ms.debug_terms)
    part("F", ms.files, kept, s64)
    scam_s = part("G", ms.scam)
    import shutil
    shutil.rmtree(ms.out, ignore_errors=True)
    log(f"phase 16 [{card}]: coupled rayleigh+TEM graph step "
        f"{1e3 * coupled_graph:.2f} ms; SCAM {1e3 * scam_s:.1f} ms a step; "
        f"wall by part " + ", ".join(f"({k}) {v:.1f} s" for k, v in t.items()))


def hs_expect(sm: Smoke) -> dict:
    """The launches of NSTEPS HS steps (build_step's FVConfig(nsplit=4,
    nspltrac=1)) on each path: one tracer_div3d call a step, 8 transport3d
    and 4 vort_flux3d calls on the unfused path, 4 calls of each K on the
    fused one, their kernels' launches each."""
    lpc = sm.sk.LAUNCHES_PER_CALL
    tracer_calls = NSTEPS * lpc["tracer_div3d"]
    return {
        "matmul": {"transport3d": 8 * NSTEPS * lpc["transport3d"],
                   "vort_flux3d": 4 * NSTEPS * lpc["vort_flux3d"],
                   "tracer_div3d": tracer_calls, "te_map_remap": NSTEPS,
                   **{k: 0 for k in FUSED}},
        "fft": {"transport3d": 0, "vort_flux3d": 0,
                "tracer_div3d": tracer_calls, "te_map_remap": NSTEPS,
                **{k: 4 * sm.ck.launches_per_call(k) * NSTEPS
                   for k in FUSED}},
    }


# phase 17: the transport orders beside 1 and 4, latitude strips, and a
# world of one
OTHER_ORDERS = ((2, 2), (3, 3), (5, 5), (6, 6), (7, 7), (-2, -2), (3, 5),
                (6, 2))
ORDER_KERNELS = ("transport3d", "vort_flux3d", "tracer_div3d", "k3", "k4")
# where each kernel takes iord and jord among its arguments
ORDER_ARGS = {"transport3d": (10, 11), "vort_flux3d": (7, 8),
              "tracer_div3d": (10, 11), "k3": (5, 6), "k4": (15, 16)}
ORDER_HS = ((3, 3), (6, 2))    # float64 HS steps at these orders
ORDER_REPS = (20, 2)           # timed calls of each kernel and plain version
STRIP_NY = (2, 4, 8)           # strips of f19's 96 rows: 48, 24, 12
DT_HS = 1800.0                 # (c): the HS large step
WORLD_BACKEND = "nccl"         # (c): the one rank's process group


class OrdersSmoke:
    """Phase 17 at f19: (a) the five kernels that take iord and jord at
    every other order of stencil_kernels.KERNEL_ORDERS, against their
    plain versions and timed, and 4 float64 HS steps at two of them on
    both paths; (b) the strip computation of parallel/shard_stencil at
    ny = 2, 4, 8 against the whole slab; (c) a world of one over NCCL:
    dyn_run and atm_step on a mesh of one rank against no mesh."""

    def __init__(self, torch, sm: Smoke, card: str):
        from cam_nor_physics_tpu_torch.entry import build_step
        self.torch, self.sm, self.card = torch, sm, card
        self.cases = []
        calls = {}
        for impl, names in (("matmul", ("transport3d", "vort_flux3d")),
                            ("fft", ("tracer_div3d", "k3", "k4"))):
            step, state, grid, coord, phis = build_step(
                IM, JM, KM, torch.float32, DEVICE, filter_impl=impl)
            got = sm.capture_inputs(step, state, grid, coord, phis)
            calls.update({n: got[n] for n in names})
        for name in ORDER_KERNELS:
            lst = calls[name]
            if name == "transport3d":
                lst = [c for c in lst if c[0][10] == 4]
            if not lst:
                raise RuntimeError(f"phase 17: no {name} call captured")
            a, kw = lst[-1]
            self.cases.append((name, name, a, kw))
        self.max_err = {}

    @staticmethod
    def with_orders(name, a, iord, jord):
        a = list(a)
        i, j = ORDER_ARGS[name]
        a[i], a[j] = iord, jord
        return tuple(a)

    # ---- (a) the orders
    def check_orders(self):
        """Each kernel on its captured inputs and with FFSL rows forced, at
        every other order: float32 bitwise to the plain version, float64
        within TOL."""
        sm = self.sm
        for label, name, a, kw in self.cases:
            sa, skw, nrows = sm.stressed(name, a, kw)
            for vlabel, va, vkw in ((label, a, kw),
                                    (f"{label}+ffsl({nrows})", sa, skw)):
                for iord, jord in OTHER_ORDERS:
                    oa = self.with_orders(name, va, iord, jord)
                    tag = f"{vlabel}({iord},{jord})"
                    err = sm.compare(tag, name, oa, vkw, "float32",
                                     exact=True)
                    self.max_err[name] = max(self.max_err.get(name, 0.0),
                                             err)
                    sm.compare(tag, name, oa, vkw, "float64", exact=False)

    def time_orders(self):
        """Each kernel at orders 1, 4 and the others (CUDA events; float32,
        the captured inputs), beside its plain version and bound, and its
        device time a call (torch.profiler: the mean duration of each
        kernel it launches, once a call each, summed)."""
        from cam_nor_physics_tpu_torch.bench import kernel_times
        for label, name, a, kw in self.cases:
            fn = self.sm.kernel(name)
            for iord, jord in ((1, 1), (4, 4)) + OTHER_ORDERS:
                oa = self.with_orders(name, a, iord, jord)
                tag = f"{label}({iord},{jord})"
                self.sm.time_row(tag, name, oa, kw, *ORDER_REPS)
                times, _ = kernel_times(lambda: fn(*oa, **kw), ORDER_REPS[0])
                ms = sum(us / n for n, us in times.values()) / 1e3
                log(f"device {tag:<18} {ms:.4f} ms a call ({len(times)} "
                    f"kernels)  [{self.card}]")

    def hs_orders(self):
        """4 float64 HS steps at each of ORDER_HS on both paths, through
        the kernels (launches exactly phase 4's) and the plain versions:
        every field within PLAIN_TOL_F64 of its max."""
        torch, sm = self.torch, self.sm
        from cam_nor_physics_tpu_torch.entry import build_step
        from cam_nor_physics_tpu_torch.utils.config import FVConfig
        expect = hs_expect(sm)
        rng = np.random.default_rng(1)
        for iord, jord in ORDER_HS:
            cfg = FVConfig(nsplit=4, nspltrac=1, iord=iord, jord=jord)
            for impl in ("fft", "matmul"):
                step, s0, grid, coord, phis = build_step(
                    IM, JM, KM, torch.float64, DEVICE, filter_impl=impl,
                    cfg=cfg)
                # a positive tracer, so trac2d moves real tracer mass
                s0 = s0.replace(q=torch.as_tensor(
                    1e-3 * (1.0 + 0.5 * rng.uniform(size=tuple(s0.q.shape))),
                    dtype=torch.float64, device=DEVICE))
                sm.zero_counts()
                state, times = sm.run_steps(step, s0, grid, coord, phis)
                torch.cuda.synchronize()
                launches = {n: sm.kernel(n).launches for n in sm.sites}
                with sm.routed(sm.plain):
                    ref, ref_s = sm.run_steps(step, s0, grid, coord, phis)
                par = sm.parity(state, ref, coord)
                bad = [f for f in ("u", "v", "pt", "delp", "q")
                       if not bool(torch.isfinite(getattr(state, f)).all())]
                log(f"orders ({iord},{jord}) {impl}: {NSTEPS} float64 HS "
                    f"steps, launches {launches}; kernels vs plain "
                    + ", ".join(f"{k} {v:.3e}" for k, v in par.items())
                    + f" (tol {PLAIN_TOL_F64:.0e}); ms a step kernels "
                    + ", ".join(f"{1e3 * t:.1f}" for t in times)
                    + ", plain " + ", ".join(f"{1e3 * t:.1f}" for t in ref_s)
                    + f"  [{self.card}]")
                if launches != expect[impl] or bad or \
                        not max(par.values()) <= PLAIN_TOL_F64 or \
                        any(math.isnan(v) for v in par.values()):
                    raise RuntimeError(
                        f"orders ({iord},{jord}) {impl}: launches "
                        f"{launches} (expected {expect[impl]}), non-finite "
                        f"{bad}, kernels vs plain {par}")
                del state, ref
                torch.cuda.empty_cache()

    # ---- (b) the strips
    def strips(self):
        """transport3d, vort_flux3d and tracer_div3d on the strips of ny
        ranks, each strip's halo cut from the whole slab as the exchange
        delivers it (shard_stencil.cut_strip, strip_call), reassembled,
        against the whole-slab kernel (no FFSL band, as the strips):
        bitwise in float32 and float64."""
        torch, sm = self.torch, self.sm
        from cam_nor_physics_tpu_torch.parallel import shard_stencil as ss
        for label, name, a, kw in self.cases[:3]:
            for dtype in (torch.float32, torch.float64):
                ca, _ = sm.cast(a, {}, dtype)
                tensors = [x for x in ca if isinstance(x, torch.Tensor)]
                scalars = ca[len(tensors):]
                want = sm.flat(sm.kernel(name)(*ca))
                for ny in STRIP_NY:
                    rows = JM // ny
                    parts = [sm.flat(ss.strip_call(
                        name, ss.cut_strip(tensors, y, ny), scalars, y,
                        rows)) for y in range(ny)]
                    got = [torch.cat([p[i] for p in parts], -2)
                           for i in range(len(want))]
                    torch.cuda.synchronize()
                    bad = sorted({int(r) for g, w in zip(got, want)
                                  for r in torch.nonzero(
                                      (g != w).flatten(0, -3).any(0)
                                      .any(-1)).flatten()})
                    err = max(float((g - w).abs().max())
                              for g, w in zip(got, want))
                    log(f"strips {label} ny={ny} ({rows} rows) "
                        f"{str(dtype)[6:]}: max_abs_err {err:.3e}, rows "
                        f"differing {bad}")
                    if bad:
                        raise RuntimeError(f"strips {label} ny={ny}: rows "
                                           f"{bad} differ from the whole "
                                           f"slab")

    # ---- (c) a world of one
    def world_of_one(self):
        """ensure_initialized over NCCL with one rank (a tcp:// rendezvous
        on localhost), one all_reduce, then dyn_run (HS, float32, 4 small
        steps) and the coupled atm_step (first step) on make_mesh(1)
        against the same calls without a mesh: bitwise, launches equal."""
        import os
        import socket
        from dataclasses import fields

        import torch.distributed as dist

        from cam_nor_physics_tpu_torch.entry import (build_coupled,
                                                     build_step)
        from cam_nor_physics_tpu_torch.models.atm_comp import atm_step
        from cam_nor_physics_tpu_torch.models.coupling.surface_fluxes \
            import bulk_surface_fluxes
        from cam_nor_physics_tpu_torch.models.fv.dyn_comp import dyn_run
        from cam_nor_physics_tpu_torch.parallel import distributed as pdist
        from cam_nor_physics_tpu_torch.parallel import mesh as pmesh
        from cam_nor_physics_tpu_torch.utils.config import FVConfig
        torch, sm = self.torch, self.sm
        with socket.socket() as sck:
            sck.bind(("localhost", 0))
            port = sck.getsockname()[1]
        # the one rank's group rendezvous on the loopback device
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        multi = pdist.ensure_initialized(f"tcp://localhost:{port}", 1, 0)
        try:
            t = torch.ones(4, device=DEVICE)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            if multi or dist.get_backend() != WORLD_BACKEND or \
                    not bool((t == 1).all()):
                raise RuntimeError(f"world of one: multi {multi}, backend "
                                   f"{dist.get_backend()}, all_reduce {t}")
            mesh = pmesh.make_mesh(1)
            _, s0, grid, coord, phis = build_step(IM, JM, KM, torch.float32,
                                                  DEVICE)
            cfg = FVConfig(nsplit=4, nspltrac=1)

            def counted(fn):
                sm.zero_counts()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                return out, sm.counts(), time.perf_counter() - t0

            a, ca, ta = counted(lambda: dyn_run(s0, grid, coord, phis, cfg,
                                                DT_HS))
            b, cb, tb = counted(lambda: dyn_run(
                pmesh.shard_state(s0, mesh), grid, coord,
                mesh.take_rows(phis), cfg, DT_HS, mesh=mesh))
            diff = [f for f in ("u", "v", "pt", "delp", "q")
                    if not torch.equal(getattr(a, f), getattr(b, f))]
            log(f"world of one: dyn_run on make_mesh(1) vs no mesh: fields "
                f"differing {diff}, launches {cb} (no mesh {ca}); "
                f"{1e3 * tb:.1f} vs {1e3 * ta:.1f} ms  [{self.card}]")
            if diff or ca != cb:
                raise RuntimeError(f"world of one dyn_run: {diff}, {ca} vs "
                                   f"{cb}")
            model, _, st, sst = build_coupled(IM, JM, KM, torch.float32,
                                              DEVICE)
            cam_in = bulk_surface_fluxes(st.phys, sst, model.registry.pcnst)
            (x, xo, _), cx, tx = counted(lambda: atm_step(
                model, st, cam_in, first_step=True))
            (y, yo, _), cy, ty = counted(lambda: atm_step(
                model, pmesh.shard_state(st, mesh),
                pmesh.shard_state(cam_in, mesh, JM, IM), first_step=True,
                mesh=mesh))
            pairs = [(f"dyn.{f.name}", getattr(x.dyn, f.name),
                      getattr(y.dyn, f.name)) for f in fields(x.dyn)]
            pairs += [(f"phys.{f.name}", getattr(x.phys, f.name),
                       getattr(y.phys, f.name)) for f in fields(x.phys)]
            pairs += [(f"cam_out.{f.name}", getattr(xo, f.name),
                       getattr(yo, f.name)) for f in fields(xo)]
            pairs += [(f"pbuf.{k}", v, y.pbuf.fields[k])
                      for k, v in x.pbuf.fields.items()]
            diff = [n for n, u, v in pairs
                    if isinstance(u, torch.Tensor) and not torch.equal(u, v)]
            log(f"world of one: atm_step on make_mesh(1) vs no mesh: "
                f"{len(pairs)} tensors, differing {diff}, launches {cy} (no "
                f"mesh {cx}); {1e3 * ty:.1f} vs {1e3 * tx:.1f} ms  "
                f"[{self.card}]")
            if diff or cx != cy:
                raise RuntimeError(f"world of one atm_step: {diff}, {cx} vs "
                                   f"{cy}")
        finally:
            dist.destroy_process_group()


def run_orders(torch, sm: Smoke, card: str) -> None:
    """Phase 17: OrdersSmoke's parts, each timed."""
    osm = OrdersSmoke(torch, sm, card)
    t = {}
    for part, fn in (("a check", osm.check_orders),
                     ("a time", osm.time_orders),
                     ("a HS steps", osm.hs_orders), ("b strips", osm.strips),
                     ("c world of one", osm.world_of_one)):
        t0 = time.perf_counter()
        fn()
        t[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    log(f"phase 17 [{card}]: float32 max_abs_err at the other orders "
        + ", ".join(f"{k} {v:.3e}" for k, v in osm.max_err.items())
        + "; wall by part " + ", ".join(f"({k}) {v:.1f} s"
                                        for k, v in t.items()))


# phase 18: the long runs (days of spin-up are not averaged)
HS_DAYS, HS_SPINUP = 60, 20           # the HS climate at flag 22
LADDER_DAYS, LADDER_SPINUP = 20, 10   # the damping-flag ladder
# VALIDATION.md's blow-up day of each flag in the JAX package's 20-day HS
# runs on the TPU (None: stable through day 20); flag 22 is phase 18 (a)
LADDER = {2: 14, 4: 8, 24: 14, 42: None}
# VALIDATION.md's JW06 day-9 ps_min (hPa), JAX on the TPU, float32
JW06_DAY9 = {2: 967.1, 22: 992.5}
JW_DAYS = 12                          # jw_baroclinic's days (the JAX tool's)
ROOFLINE_ITERS, ROOFLINE_PASSES = 8, 2   # the bench's chained steps in (d)
COUNT_NCOL = NCOL // 8                # ZM columns of the count in (e)
COUNT_TOL = 1e-6                      # operations, card against CPU


class LongSmoke:
    """Phase 18: the repo's long runs and the roofline at f19."""

    def __init__(self, torch, sm: Smoke, card: str):
        from cam_nor_physics_tpu_torch import driver
        from cam_nor_physics_tpu_torch.tools import hs_climate, jw_baroclinic
        self.torch, self.sm, self.card = torch, sm, card
        self.hs, self.jw, self.guard = (hs_climate.hs_climate, jw_baroclinic,
                                        driver.UMAX_GUARD)

    def climate(self):
        """(a) 60 days of HS at flag 22."""
        r = self.hs(HS_DAYS, HS_SPINUP, IM, JM, KM, device=DEVICE,
                    log=sys.stdout)
        steps = int(HS_DAYS * 48)
        log(f"HS climate {HS_DAYS} days ({HS_SPINUP} spin-up) at flag 22 "
            f"[{self.card}]: status {r['status']}, {r['wall_s']:.1f} s "
            f"wall, {1e3 * r['wall_s'] / steps:.3f} ms a step ({steps} "
            f"steps with the samples and checks), nsamples "
            f"{r.get('nsamples')}, max|u| at the checks "
            f"{max(r['umax_ms'], default=float('nan')):.2f} m/s")
        if r["status"] == "blowup":
            raise RuntimeError(f"HS climate: u not finite at day {r['day']}")
        for k, v in r["checks"].items():
            log(f"    {k:<24} {v['value']:10.3f}  "
                f"{'ok' if v['ok'] else 'FAIL'}")
        if max(r["umax_ms"]) >= self.guard:
            raise RuntimeError(f"HS climate: max|u| {max(r['umax_ms'])} "
                               f"m/s at or above {self.guard}")
        bad = [k for k, v in r["checks"].items() if not v["ok"]]
        if bad:
            raise RuntimeError(f"HS climate: HS94 checks failed {bad}")

    def ladder(self):
        """(b) 20 days of HS at flags 2, 4, 24 and 42."""
        for flag, jax_day in LADDER.items():
            r = self.hs(LADDER_DAYS, LADDER_SPINUP, IM, JM, KM, flag=flag,
                        device=DEVICE, log=sys.stdout)
            day = r["day"] if r["status"] == "blowup" else None
            log(f"ladder flag {flag:2d} [{self.card}]: blow-up day "
                f"{day if day is not None else 'none'} (VALIDATION.md, "
                f"JAX on the TPU: {jax_day if jax_day else 'none'}), "
                f"{r['wall_s']:.1f} s wall, max|u| at the checks "
                f"{max(r['umax_ms'], default=float('nan')):.2f} m/s")
            if flag == 42 and day is not None:
                raise RuntimeError(f"ladder: flag 42 blew up at day {day}")

    def waves(self):
        """(c) the JW06 envelope at flag 2 and the 12-day series."""
        r = self.jw.jw06_envelope(IM, JM, KM, device=DEVICE, log=sys.stdout)
        log(f"JW06 envelope, flag 2 [{self.card}]: ps_min day 9 "
            f"{r['ps_min'].get(9, float('nan')):.2f} hPa (VALIDATION.md, "
            f"JAX on the TPU: {JW06_DAY9[2]}), d78 {r.get('d78', 0.0):.2f} "
            f"d89 {r.get('d89', 0.0):.2f} hPa, eke day 5 "
            f"{r['eke'].get(5, float('nan')):.4g} day 9 "
            f"{r['eke'].get(9, float('nan')):.4g}, {r['wall_s']:.1f} s wall")
        for k, ok in r["checks"].items():
            log(f"    {k:<32} {'ok' if ok else 'FAIL'}")
        if not r["ok"]:
            raise RuntimeError(f"JW06 envelope failed: {r}")
        r = self.jw.jw_baroclinic(JW_DAYS, IM, JM, KM, device=DEVICE,
                                  log=sys.stdout)
        day9 = next((s["ps_min_hpa"] for s in r["series"]
                     if s["day"] == 9.0), float("nan"))
        log(f"JW06 {JW_DAYS} days at FVConfig() (flag 22) [{self.card}]: "
            f"status {r['status']}, ps_min day 9 {day9:.2f} hPa "
            f"(VALIDATION.md, JAX on the TPU: {JW06_DAY9[22]}), quiet "
            f"through day 4 {r['quiet_through_day4']}, first day below "
            f"960 hPa {r['first_day_below_960']}, {r['wall_s']:.1f} s wall, "
            f"{1e3 * r['wall_s'] / (JW_DAYS * 48):.3f} ms a step")

    def roofline(self):
        """(d) the bench at f19 with the roofline on."""
        import contextlib
        import io
        from cam_nor_physics_tpu_torch import bench
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            record = bench.run("f19", DEVICE, roofline=True,
                               iters=ROOFLINE_ITERS, passes=ROOFLINE_PASSES)
        lines = [ln for ln in err.getvalue().splitlines()
                 if ln.startswith("roofline[")]
        for ln in err.getvalue().splitlines():
            log(f"bench: {ln}")
        log(json.dumps(record))
        names = sorted(ln.split("]")[0][len("roofline["):] for ln in lines)
        want = sorted(f"{s}{x}" for s in ("dyn_step", "zm_tend")
                      for x in ("", f" chunked K={record['chunked_k']}"))
        if names != want:
            raise RuntimeError(f"roofline lines {names}, expected {want}")

    def count(self):
        """(e) the count of the HS and ZM steps on the card and the CPU."""
        torch = self.torch
        from cam_nor_physics_tpu_torch import convert
        from cam_nor_physics_tpu_torch.entry import build_step, build_zm_step
        from cam_nor_physics_tpu_torch.utils.config import FVConfig
        cost = self.sm.cost
        hs, state, grid, coord, phis = build_step(
            IM, JM, KM, torch.float32, DEVICE, cfg=FVConfig())
        for _ in range(3):
            state = hs(state, grid, coord, phis)
        cpu = build_step(IM, JM, KM, torch.float32, "cpu", cfg=FVConfig())
        zm, pstate, pbuf, _ = build_zm_step(COUNT_NCOL, KM, torch.float32,
                                            DEVICE)
        zcpu, pcpu, bcpu, _ = build_zm_step(COUNT_NCOL, KM, torch.float32,
                                            "cpu")
        cases = {
            "HS step": ((hs, state, grid, coord, phis),
                        (cpu[0], convert.dynstate_from_numpy(
                            convert.dynstate_to_numpy(state), "cpu"),
                         *cpu[2:])),
            f"ZM step {COUNT_NCOL} columns": ((zm, pstate, pbuf),
                                              (zcpu, pcpu, bcpu))}
        for label, (card_call, cpu_call) in cases.items():
            counts = {}
            for dev, (fn, *args) in (("card", card_call), ("cpu", cpu_call)):
                t0 = time.perf_counter()
                with cost.WorkCount() as c:
                    fn(*args)
                counts[dev] = (c, time.perf_counter() - t0)
            (cc, t_card), (cp, t_cpu) = counts["card"], counts["cpu"]
            kb = sum(b for _, b, _ in cc.kernels.values())
            ko = sum(o for _, _, o in cc.kernels.values())
            log(f"count {label} [{self.card}]: card {cc.bytes} B "
                f"{cc.ops:.6e} ops ({t_card:.1f} s), CPU {cp.bytes} B "
                f"{cp.ops:.6e} ops ({t_cpu:.1f} s); the kernels' work "
                f"{kb} B {ko:.6e} ops ({100 * kb / cc.bytes:.1f}% of the "
                f"bytes), the glue {cc.bytes - kb} B {cc.ops - ko:.6e} ops")
            for n, (calls, b, o) in cc.kernels.items():
                log(f"    {n:<14} {calls:3d} calls {b:12d} B {o:.4e} ops")
            rel = abs(cc.ops - cp.ops) / max(cp.ops, 1.0)
            if cc.bytes != cp.bytes or rel > COUNT_TOL or \
                    cc.kernels.keys() != cp.kernels.keys():
                raise RuntimeError(f"count {label}: card and CPU differ "
                                   f"({cc.bytes} / {cp.bytes} B, ops rel "
                                   f"{rel:.2e}, {cc.kernels} / "
                                   f"{cp.kernels})")
            if cc.bytes < kb or not cc.kernels:
                raise RuntimeError(f"count {label}: {cc.bytes} B below its "
                                   f"kernels' {kb} B")


def run_long(torch, sm: Smoke, card: str) -> None:
    """Phase 18: (a)-(e) of the module docstring's item 18."""
    lg = LongSmoke(torch, sm, card)
    for name, fn in (("(a) HS climate", lg.climate),
                     ("(b) damping-flag ladder", lg.ladder),
                     ("(c) JW06", lg.waves), ("(d) roofline", lg.roofline),
                     ("(e) count", lg.count)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        log(f"  18 {name}: {time.perf_counter() - t0:.1f} s wall")


def device_us(fn, reps):
    """Device µs a call of fn, which launches one kernel: the mean
    duration of the launches torch.profiler recorded in `reps` calls."""
    from cam_nor_physics_tpu_torch.bench import kernel_times
    times, _ = kernel_times(fn, reps)
    return sum(us for _, us in times.values()) / sum(
        c for c, _ in times.values())


def profile_call(label, fn, card, top=6):
    """Phase 9: one call of fn under torch.profiler (after a warm-up);
    prints the wall time, the device kernels (the port's and PyTorch's),
    the device's busy time and share, and the `top` kernels by device
    time."""
    from cam_nor_physics_tpu_torch.bench import by_origin, kernel_times
    by_name, wall = kernel_times(fn)
    busy_us = sum(us for _, us in by_name.values())
    share = 100.0 * busy_us / 1e6 / wall
    log(f"profile {label} [{card}]: wall {1e3 * wall:.2f} ms under the "
        f"profiler, {sum(n for n, _ in by_name.values())} device kernels ("
        + ", ".join(f"{k} {n} launches {us / 1e3:.3f} ms"
                    for k, (n, us) in by_origin(by_name).items())
        + f"), device busy {busy_us / 1e3:.3f} ms ({share:.1f}% of the "
        f"wall time, idle {100.0 - share:.1f}%)")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda x: -x[1][1])[:top]:
        log(f"    {us / 1e3:9.3f} ms  {n:6d} x  {name[:90]}")


def run(torch) -> dict:
    from cam_nor_physics_tpu_torch import bench
    from cam_nor_physics_tpu_torch.bench import card_label
    from cam_nor_physics_tpu_torch.entry import build_step, build_zm_step
    from cam_nor_physics_tpu_torch.ops import cuda_build
    from cam_nor_physics_tpu_torch.utils.config import FVConfig

    # ---- phase 1: the card
    card = card_label()
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    log(card)
    sm = Smoke(torch, card)

    # ---- phase 2: build, and the probe
    with phase("2 build"):
        from concurrent.futures import ThreadPoolExecutor

        from cam_nor_physics_tpu_torch.utils.histio_native import \
            native_library

        def timed_native(stem):
            t = time.perf_counter()
            native_library(stem)
            return time.perf_counter() - t

        t0 = time.perf_counter()
        # the driver's native writers (g++) build beside the kernels (nvcc)
        with ThreadPoolExecutor(2) as pool:
            native = {f"{stem} (g++)": pool.submit(timed_native, stem)
                      for stem in ("histio", "ckptio")}
            times = cuda_build.build()
            times.update({k: f.result() for k, f in native.items()})
        log(f"build: {time.perf_counter() - t0:.1f} s wall "
            + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
        for name in cuda_build.SOURCES:
            logf = cuda_build.BUILD / f"{name}.log"
            if logf.exists():
                for line in logf.read_text().splitlines():
                    if "registers" in line or "spill" in line:
                        log(f"  ptxas {name}: {line.strip()}")
        probe_row = sm.run_probe()

    # ---- phase 3: each kernel against its plain version, on the inputs
    # of the unfused (matmul) and the fused (fft) HS step
    with phase("3 kernels vs plain versions at f19"):
        rng = np.random.default_rng(1)
        paths = {}
        for impl in ("matmul", "fft"):
            step, state0, grid, coord, phis = build_step(
                IM, JM, KM, torch.float32, DEVICE, filter_impl=impl)
            # a positive tracer, so trac2d and te_map move real tracer mass
            if impl == "matmul":
                tracer = torch.as_tensor(
                    1e-3 * (1.0 + 0.5 * rng.uniform(
                        size=tuple(state0.q.shape))),
                    dtype=torch.float32, device=DEVICE)
            paths[impl] = (step, state0.replace(q=tracer), grid, coord, phis)
        calls = sm.capture_inputs(*paths["matmul"])
        calls_fft = sm.capture_inputs(*paths["fft"])
        for name in FUSED:
            calls[name] = calls_fft[name]
        cases = sm.main_path_inputs(calls)
        max_err = {}
        for label, name, a, kw in cases:
            for dt in ("float32", "float64"):
                err = sm.compare(label, name, a, kw, dt)
                if dt == "float32":
                    max_err[name] = max(max_err.get(name, 0.0), err)
            if name not in ("te_map_remap", "k2"):
                sa, skw, nrows = sm.stressed(name, a, kw)
                for dt in ("float32", "float64"):
                    sm.compare(f"{label}+ffsl({nrows} rows)", name, sa, skw,
                               dt)
            for vlabel, va, vkw in sm.variants(name, a, kw,
                                               paths["fft"][2]):
                for dt in ("float32", "float64"):
                    sm.compare(vlabel, name, va, vkw, dt)

    # ---- phase 4: both HS paths through the kernels, counted
    with phase("4 HS paths at f19"):
        expect = hs_expect(sm)
        runs = {impl: sm.hs_path(impl, *paths[impl], expect[impl])
                for impl in ("matmul", "fft")}
        sm.fused_vs_unfused(runs["fft"]["f64_state"])
        launches = {**{n: runs["matmul"]["launches"][n]
                       for n in ("transport3d", "vort_flux3d")},
                    **{n: runs["fft"]["launches"][n]
                       for n in ("tracer_div3d", "te_map_remap") + FUSED}}

    # ---- phase 5: per-kernel times at the main path's shapes
    with phase("5 kernel times at f19"):
        rows = []
        for label, name, a, kw in cases:
            rows.append((label, name,
                         *sm.time_row(label, name, a, kw, 50, 5)))
            if name == "te_map_remap":
                sm.device_ms(label, sm.kernel(name), a, kw, "te_map_kernel")
            if name in SPLIT:
                sm.split(name, label, a, kw, 10)
        steady = runs["fft"]["steady"]
    # ---- phases 6-8: the ZM step and its tail kernel
    with phase("6-8 ZM step at f19"):
        zm = run_zm(torch, sm, card)
        log(f"main path [{card}]: HS large step (fused, fft) "
            f"{1e3 * steady:.2f} ms + ZM step {1e3 * zm['zm_s']:.2f} ms -> "
            f"{IM * JM * KM / (steady + zm['zm_s']):.6e} grid points/s "
            f"({IM}x{JM}x{KM}); the unfused (matmul) HS step "
            f"{1e3 * runs['matmul']['steady']:.2f} ms")

    # ---- phase 9: where the main path's time goes
    with phase("9 profiles at f19"):
        for impl, what in (("fft", "fused"), ("matmul", "unfused")):
            step, state0, grid, coord, phis = paths[impl]
            profile_call(
                         f"HS large step ({what}, {impl}) {IM}x{JM}x{KM}",
                         lambda: step(state0, grid, coord, phis), card)
        profile_call(f"ZM step {NCOL}x{KM}", zm["step"], card)
    del paths, calls, calls_fft, cases, runs, zm["step"]

    # ---- phase 10: the bench's CUDA graphs at f19, replays against eager
    # steps
    with phase("10 CUDA graphs at f19"):
        hs, state, grid, coord, phis = build_step(
            IM, JM, KM, torch.float32, DEVICE, cfg=FVConfig())
        hs_carry = (state,)
        for _ in range(bench.SPINUP):
            hs_carry = (hs(hs_carry[0], grid, coord, phis),)
        hs_ms = sm.graph_check("HS", lambda s: (hs(s, grid, coord, phis),),
                               hs_carry)
        zstep, pstate, pbuf, _ = build_zm_step(NCOL, KM, torch.float32,
                                               DEVICE)
        sm.graph_check("ZM", zstep, (pstate, pbuf))
        del hs_carry, pstate, pbuf
        torch.cuda.empty_cache()

    # ---- phase 11: the bench's HS step at f09 and f05, FVConfig()'s splits
    for gname in BEYOND:
        with phase(f"11 HS steps and zm_tail at {gname}"):
            sm.run_grid(gname)
            torch.cuda.empty_cache()
            sm.run_grid(gname, "matmul")
            torch.cuda.empty_cache()
            run_zm_grid(torch, sm, gname)
        torch.cuda.empty_cache()

    # ---- phase 12: the port's bench at f19, its main path counted
    with phase("12 the port's bench at f19"):
        sm.zero_counts()
        record = bench.run("f19", DEVICE)
        torch.cuda.synchronize()
        bench_launches = sm.counts()
        print(json.dumps(record), flush=True)
        log(f"bench at f19: launches {bench_launches}")
        idle = [n for n in FUSED + ("tracer_div3d", "te_map_remap",
                                    "zm_tail", "zm_parcel", "probe")
                if bench_launches[n] == 0]
        if idle or bench_launches["probe"] != 1:
            raise RuntimeError(f"bench at f19: kernels not launched {idle}, "
                               f"probe launched {bench_launches['probe']} "
                               f"times (expected 1)")

    # ---- phase 13: the coupled atm_step at f19 (and one step at f09)
    with phase("13 coupled atm_step at f19"):
        coupled_ms = run_coupled(torch, sm, card)

    # ---- phase 14: the run driver at f19
    with phase("14 the run driver at f19"):
        DriverSmoke(torch, sm, card).run(coupled_ms)
        torch.cuda.empty_cache()

    # ---- phase 15: the coupled step and the driver with microp at f19
    with phase("15 microp coupled step and driver at f19"):
        run_microp(torch, sm, card, coupled_ms)
        torch.cuda.empty_cache()

    # ---- phase 16: the other modes at f19
    with phase("16 other modes at f19"):
        run_modes(torch, sm, card, hs_ms)
        torch.cuda.empty_cache()

    # ---- phase 17: the transport orders beside 1 and 4, latitude strips,
    # a world of one
    with phase("17 orders and strips at f19"):
        run_orders(torch, sm, card)
        torch.cuda.empty_cache()

    # ---- phase 18: the long runs and the roofline
    with phase("18 long runs and roofline at f19"):
        run_long(torch, sm, card)

    # ---- phase 19: ZM's parcel kernel
    with phase("19 ZM parcel at f19, f09, f05"):
        parcel_row = run_parcel(torch, sm, card)
        torch.cuda.empty_cache()

    kernels = []
    for name, source, replaces in KERNELS:
        if name in ("zm_tail", "zm_parcel", "probe"):
            row = {"zm_tail": lambda: dict(zm["row"], library_ms=None),
                   "zm_parcel": lambda: dict(
                       parcel_row, launches=zm["parcel_launches"],
                       library_ms=None),
                   "probe": lambda: dict(probe_row,
                                         launches=bench_launches["probe"])
                   }[name]()
            kernels.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces, **row})
            continue
        # transport3d runs at two orders, launched equally often per
        # step: its numbers are the mean of the two per-launch values; a K
        # is timed per call (launches_per_call launches)
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


def run_phase(torch, n: int) -> int:
    """`python3 chip_smoke.py --phase 16` (17, 18, 19): the build and that
    phase alone (phase 16 without the HS graph step; phase 19 prints its
    kernels row, without the launches phase 7 counts); prints no result
    line."""
    from cam_nor_physics_tpu_torch.bench import card_label
    from cam_nor_physics_tpu_torch.ops import cuda_build
    card = card_label()
    log(card)
    times = cuda_build.build()
    log("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    sm = Smoke(torch, card)
    if n == 16:
        with phase("16 other modes at f19"):
            run_modes(torch, sm, card, None)
    elif n == 17:
        with phase("17 orders and strips at f19"):
            run_orders(torch, sm, card)
    elif n == 18:
        with phase("18 long runs and roofline at f19"):
            run_long(torch, sm, card)
    else:
        with phase("19 ZM parcel at f19, f09, f05"):
            log(json.dumps({"zm_parcel": run_parcel(torch, sm, card)}))
    return 0


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
    if sys.argv[1:] in (["--phase", "16"], ["--phase", "17"],
                        ["--phase", "18"], ["--phase", "19"]):
        return run_phase(torch, int(sys.argv[2]))
    t0 = time.perf_counter()
    record = run(torch)
    log(f"chip_smoke.py: {time.perf_counter() - t0:.1f} s wall in all")
    print(json.dumps({"kernels": record["kernels"]}))
    print(record["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
