"""Run driver: the `cam` main program's role.

Twin of `cam_nor_physics_tpu.driver`. It wires the coupled step
(models/atm_comp.atm_step) to the run's subsystems: history tapes
(utils/history.py and the native writer), checkpoints
(utils/checkpoint.py and the native writer), phase timing
(utils/timing.py) and blow-up sentinels (finite and |u| guards in place of
the reference's endrun aborts), with a structured ABORT.json on failure.

`run(...)` integrates nsteps, writes history every `hist_every` steps and
a checkpoint every `ckpt_every`, checks the state every `check_every`, and
returns the final state and the timing table. Two loop shapes:

- chunk = 1 steps eagerly, one atm_step after another; the device is read
  on the host only at history, checkpoint and sentinel boundaries.
- chunk > 1 runs `chunk` coupled steps at a time. On CUDA tensors the
  chunk is one CUDA graph (bench.ChainGraph over a static carry: the
  state, every tape's history buffers, which outfld_many updates in place,
  and a (chunk,) bool of per-step sentinel flags); one graph is captured
  for each distinct chunk length (the partial first and last chunks have
  their own), and each graph's first replay is held bitwise to the same
  steps run eagerly before it is used (the timer's "graph_capture"
  region; "atm_step" times the replays). A capture or replay that fails
  raises: there is no eager fallback on the card. On CPU tensors the
  same chunks run as eager steps. The graph's carry is a copy, so the
  caller's state is never written. Every call captures its graphs anew,
  so the spans' device markers (utils/timing.span) are in the graphs of
  a call made under torch.profiler and in no other.

The first step of a run from nstep 0 runs alone and eagerly with
first_step=True (no energy fixer yet), as in JAX. At a boundary the tapes
due are read to the host and their buffers re-initialised in place, the
chunk's flags are kept (as copies) until a clean check, and the sentinels
read the state. A sentinel failure writes ABORT.json with the exact first
failing step from the per-step flags.
"""

from __future__ import annotations

import glob
import json
import os

import torch

from .bench import ChainGraph, bitwise_equal, clone_tree
from .models.atm_comp import AtmModel, AtmState, atm_init, atm_step
from .models.coupling.camsrfexch import CamIn
from .models.physics.cam_diagnostics import (amwg_core_fields, diag_cloud,
                                             diag_export, diag_phys_writeout,
                                             diag_register, diag_surf)
from .utils import constants as c
from .utils.checkpoint import restore_checkpoint
from .utils.ckptio_native import AsyncCheckpointWriter
from .utils.history import INIT, default_registry_atm, outfld_many
from .utils.timing import PhaseTimer, span

UMAX_GUARD = 300.0        # m/s wind sanity bound (dyn_comp.F90:996-997)


def _grid_area(grid, dtype):
    """Per-column cell area (m2) on the grid's device, flattened (jm*im,):
    the GRIDAREA payload, computed once a run."""
    cosp = torch.clamp(grid.cosp.to(torch.float64), min=0.0)
    area = (c.REARTH ** 2 * grid.dl * grid.dp) * cosp
    return area[:, None].expand(grid.jm, grid.im).reshape(-1).to(dtype)


class BlowupError(RuntimeError):
    """The model state failed the finite/range sentinels (the structured
    replacement of the reference's collective endrun abort)."""


class _HistoryTapes:
    """Per-tape accumulation buffers and their writer (cam_history's tape
    set).

    `every` is the per-tape write frequency: an int applies to tape 0
    (h0); a dict {tape: every} drives several tapes, each over the fields
    add_default-ed to it. The buffers live on the model's device and are
    updated in place; a write reads them on the host and re-initialises
    them in place."""

    def __init__(self, reg, model, dtype, every, out_dir):
        from .utils.histio_native import AsyncHistoryWriter
        g = model.grid
        self.reg = reg
        self.out_dir = out_dir
        self.every = ({0: every} if isinstance(every, int) else dict(every))
        self.every = {t: e for t, e in self.every.items() if e}
        self.writer = AsyncHistoryWriter(reg, g.lats, g.lons, g.km)
        self.bufs = {t: reg.buffer(g.jm * g.im, g.km, dtype, tape=t,
                                   jm=g.jm, im=g.im, device=g.cosp.device)
                     for t in self.every}
        self.counts = {t: 0 for t in self.every}

    def accumulate(self, payload) -> dict:
        """_accumulate into every tape's buffers."""
        return _accumulate(self.bufs, self.reg, payload)

    def maybe_write(self, istep, time_days):
        for t, every in self.every.items():
            if istep % every == 0:
                path = os.path.join(
                    self.out_dir, f"h{t}.{self.counts[t]:04d}.nc")
                self.writer.write(path, self.bufs[t], time_days)
                self.counts[t] += 1
                for name, entry in self.bufs[t].items():
                    entry["sum"].fill_(INIT[self.reg.fields[name].avgflag])
                    entry["count"].zero_()

    def close(self):
        self.writer.flush()
        self.writer.close()


def _accumulate(bufs: dict, reg, payload) -> dict:
    """One step's history into `bufs` ({tape: buffer}) in place, inside
    the span "history_accumulate": the payload, `payload()` (built inside
    the span), through outfld_many into each tape's buffer."""
    with span("history_accumulate"):
        fields = payload()
        for b in bufs.values():
            outfld_many(b, fields, reg)
    return bufs


def _dyn_payload(state: AtmState) -> dict:
    """Staggered-grid prognostic winds (the reference's US/VS addflds on
    the FV u/v staggers, dyn_comp.F90:676-684). u rows 1..jm-1 are the
    interior interfaces (row 0 is the unused south-pole edge)."""
    return {"US": state.dyn.u[:, 1:, :], "VS": state.dyn.v}


def _step_payload(state: AtmState, cam_in: CamIn, cam_out, diags: dict,
                  area) -> dict:
    """The per-step outfld batch; reads no device value on the host, so it
    runs inside a CUDA graph."""
    payload = dict(diags)
    payload.update(diag_phys_writeout(state.phys, nstep=state.nstep,
                                      area=area))
    payload.update(diag_surf(cam_in, cam_out))
    payload.update(diag_export(cam_out))
    payload.update(_dyn_payload(state))
    payload.update(diag_cloud(state.pbuf.get("CLD"), state.phys.pmid))
    if "PRECC" in payload:
        payload["PRECCMX"] = payload["PRECC"]
    return payload


def _check_state(state: AtmState, nstep: int) -> None:
    """The sentinels, read on the host."""
    u = state.dyn.u
    if not bool(torch.isfinite(u).all() & torch.isfinite(state.dyn.pt).all()):
        raise BlowupError(f"non-finite dycore state at step {nstep}")
    umax = float(u.abs().max())
    if umax > UMAX_GUARD:
        raise BlowupError(f"|u|max={umax:.1f} m/s exceeds {UMAX_GUARD} "
                          f"at step {nstep}")


def _state_ok(state: AtmState) -> torch.Tensor:
    """_check_state's predicate as a 0-d bool tensor on the device, kept
    per step inside a chunk so that ABORT.json can name the exact
    diverging step."""
    u = state.dyn.u
    return (torch.isfinite(u).all() & torch.isfinite(state.dyn.pt).all()
            & (u.abs().max() <= UMAX_GUARD))


def latest_checkpoint(out_dir: str) -> str | None:
    """The most recent `ckpt_*` directory under out_dir (restart
    discovery)."""
    paths = sorted(glob.glob(os.path.join(out_dir, "ckpt_*")))
    return paths[-1] if paths else None


def _structured_abort(out_dir: str, err: BlowupError, nstep: int,
                      hist, ckpt_writer, last_ok: int = 0,
                      exact_step: int | None = None) -> None:
    """The structured abort record (the endrun replacement): flush the IO
    workers so no tape or checkpoint is cut short, then write ABORT.json
    with the reason and the last good checkpoint; recovery is a restart
    from it.

    `detected_step` is the check boundary at which the sentinels fired
    (in the chunked loop a chunk boundary, so detection can slip to
    ceil(check_every/chunk)*chunk). `failed_step` is the exact first
    failing step where per-step flags exist (the chunked loop keeps them),
    else `detected_step`. `failed_within` bounds the divergence: (last
    step that passed, first failing step]."""
    if hist:
        hist.close()
    if ckpt_writer:
        ckpt_writer.flush()
        ckpt_writer.close()
    record = {"reason": str(err),
              "failed_step": nstep if exact_step is None else exact_step,
              "detected_step": nstep,
              "exact": exact_step is not None,
              "failed_within": ([last_ok, nstep] if exact_step is None
                                else [exact_step - 1, exact_step]),
              "last_good_checkpoint": latest_checkpoint(out_dir)}
    with open(os.path.join(out_dir, "ABORT.json"), "w") as f:
        json.dump(record, f, indent=1)


def _close(hist, ckpt_writer, timer: PhaseTimer) -> None:
    """Wait for the IO workers (their last writes are timed in their
    regions) and stop them."""
    if hist:
        with timer.region("history_write"):
            hist.close()
    if ckpt_writer:
        with timer.region("checkpoint"):
            ckpt_writer.flush()
            ckpt_writer.close()


def _history_registry(names):
    reg = default_registry_atm()
    diag_register(reg)
    for name in names:
        if name in reg.fields:
            reg.add_default(name)
    return reg


def run(model: AtmModel, state: AtmState, cam_in: CamIn, nsteps: int,
        out_dir: str = "output", hist_every: int = 0, ckpt_every: int = 0,
        check_every: int = 10, resume_from: str | None = None,
        chunk: int = 1):
    """Integrate nsteps with a fixed surface input; returns (state, timer).

    `resume_from`: a checkpoint directory of an earlier run (either
    package's); `state` is then the template of shapes, dtypes and device
    (the reference's restart contract: same grid, same constituents), and
    the run goes on from the stored step counter, bitwise as the run that
    was not interrupted.

    `chunk`: steps per dispatch (see the module docstring). History and
    checkpoint cadences must be multiples of it; the sentinels run at
    chunk boundaries, and ABORT.json names the exact failing step."""
    os.makedirs(out_dir, exist_ok=True)
    timer = PhaseTimer()
    if resume_from is not None:
        state = restore_checkpoint(resume_from, state)

    reg = _history_registry(amwg_core_fields() + ["US", "VS", "PRECCMX"])
    dtype = state.phys.t.dtype
    hist = _HistoryTapes(reg, model, dtype, hist_every,
                         out_dir) if hist_every else None
    ckpt_writer = AsyncCheckpointWriter() if ckpt_every else None
    area = _grid_area(model.grid, dtype) if hist else None
    nstep0 = int(state.nstep)

    if chunk > 1:
        return _run_chunked(model, state, cam_in, nsteps, chunk, hist,
                            ckpt_writer, out_dir, ckpt_every, check_every,
                            timer, area, nstep0)

    last_ok = 0
    for i in range(nsteps):
        # the caller's (or the restored) state is an input only: atm_step
        # writes none of its arguments
        first = i == 0 and nstep0 == 0
        state, cam_out, diags = timer.timed("atm_step", atm_step, model,
                                            state, cam_in, first_step=first)
        nstep = nstep0 + i + 1

        if hist:
            timer.timed("outfld", hist.accumulate, lambda: _step_payload(
                state, cam_in, cam_out, diags, area))
            with timer.region("history_write"):
                hist.maybe_write(i + 1, nstep * model.dt / 86400.0)

        if ckpt_every and (i + 1) % ckpt_every == 0:
            with timer.region("checkpoint"):
                ckpt_writer.write(
                    os.path.join(out_dir, f"ckpt_{i + 1:06d}"),
                    state, {"nstep": nstep})

        if check_every and (i + 1) % check_every == 0:
            with timer.region("sentinels"):
                try:
                    _check_state(state, i + 1)
                    last_ok = i + 1
                except BlowupError as err:
                    _structured_abort(out_dir, err, i + 1, hist, ckpt_writer,
                                      last_ok=last_ok)
                    raise

    _close(hist, ckpt_writer, timer)
    return state, timer


def _checked_graph(step, carry, n: int) -> ChainGraph:
    """A ChainGraph of n steps on the static `carry` itself. The n steps
    first run eagerly from a copy of the carry (which also warms up every
    library and table the capture needs); the graph's first replay must
    then leave the carry bitwise equal to them, or this raises."""
    ref = clone_tree(carry)
    for _ in range(n):
        ref = step(*ref)
    g = ChainGraph(step, carry, n, static=carry)
    g.replay()
    torch.cuda.synchronize()
    if not bitwise_equal(carry, ref):
        raise RuntimeError(f"driver: the CUDA graph of {n} coupled steps "
                           f"differs from {n} eager steps")
    return g


def _run_chunked(model: AtmModel, state: AtmState, cam_in: CamIn,
                 nsteps: int, chunk: int, hist, ckpt_writer, out_dir: str,
                 ckpt_every: int, check_every: int, timer: PhaseTimer,
                 area, nstep0: int):
    """run()'s body for chunk > 1: `chunk` coupled steps a dispatch, with
    history accumulated on the device inside the chunk (a CUDA graph on
    the card, eager steps on the CPU)."""
    if hist:
        for t, every in hist.every.items():
            if every % chunk:
                raise ValueError(
                    f"hist_every[{t}]={every} must be a multiple of "
                    f"chunk={chunk}")
    if ckpt_every and ckpt_every % chunk:
        raise ValueError(f"ckpt_every={ckpt_every} must be a multiple of "
                         f"chunk={chunk}")

    reg = hist.reg if hist else None
    bufs = hist.bufs if hist else {}

    def chunk_step(st, bufs, flags):
        """One coupled step of a chunk: history into `bufs` in place, and
        the step's sentinel flag shifted into the end of `flags`."""
        st2, cam_out, diags = atm_step(model, st, cam_in)
        if bufs:
            _accumulate(bufs, reg, lambda: _step_payload(
                st2, cam_in, cam_out, diags, area))
        return st2, bufs, torch.cat([flags[1:], _state_ok(st2)[None]])

    i = 0
    check_eff = (-(-check_every // chunk) * chunk) if check_every else 0
    last_ok = 0
    # per-step sentinel flags since the last clean check: [(first step of
    # the batch, (n,) bool copy)], read only when a check fails
    pending_flags = []

    def _exact_failed_step():
        for start, oks in pending_flags:
            bad = torch.nonzero(~oks.cpu()).flatten()
            if bad.numel():
                return start + int(bad[0])
        return None

    def boundary(i, state):
        nonlocal last_ok, pending_flags
        if hist:
            with timer.region("history_write"):
                hist.maybe_write(i, (nstep0 + i) * model.dt / 86400.0)
        if ckpt_every and i % ckpt_every == 0:
            with timer.region("checkpoint"):
                ckpt_writer.write(os.path.join(out_dir, f"ckpt_{i:06d}"),
                                  state, {"nstep": nstep0 + i})
        if check_eff and i % check_eff == 0:
            with timer.region("sentinels"):
                try:
                    _check_state(state, i)
                    last_ok = i
                    pending_flags = []
                except BlowupError as err:
                    _structured_abort(out_dir, err, i, hist, ckpt_writer,
                                      last_ok=last_ok,
                                      exact_step=_exact_failed_step())
                    raise

    if nstep0 == 0 and nsteps > 0:
        # nstep == 0 leaves the energy fixer out (physpkg.F90:2899): a
        # different step, run alone
        state, cam_out, diags = timer.timed(
            "atm_step", atm_step, model, state, cam_in, first_step=True)
        if hist:
            timer.timed("outfld", hist.accumulate, lambda: _step_payload(
                state, cam_in, cam_out, diags, area))
        if check_eff:
            pending_flags.append((1, _state_ok(state)[None]))
        i = 1
        boundary(i, state)

    flags = torch.ones((chunk,), dtype=torch.bool, device=state.dyn.u.device)
    graphs = {}                        # chunk length -> ChainGraph
    if state.dyn.u.is_cuda:
        # the graphs' static carry: a copy of the state (the caller's
        # stays unwritten), the tapes' buffers and the flags
        carry = (clone_tree(state), bufs, flags)

        def advance(n):
            if n in graphs:
                graphs[n].replay()
            else:
                graphs[n] = _checked_graph(chunk_step, carry, n)
            return carry

        def region(n):
            # a graph's first chunk (its eager check, capture and first
            # replay) is timed apart from the replays
            return "atm_step" if n in graphs else "graph_capture"
    else:
        carry = (state, bufs, flags)

        def advance(n):
            nonlocal carry
            for _ in range(n):
                carry = chunk_step(*carry)
            return carry

        def region(n):
            return "atm_step"

    while i < nsteps:
        n = min(chunk - (i % chunk), nsteps - i)
        state, _, flags = timer.timed(region(n), advance, n)
        if check_eff:
            pending_flags.append((i + 1, flags[chunk - n:].clone()))
        i += n
        boundary(i, state)

    _close(hist, ckpt_writer, timer)
    return state, timer


def run_coupled(model: AtmModel, state: AtmState, sst, nsteps: int,
                slab_ocean: bool = False, h_mix: float = 30.0, q_flux=None,
                out_dir: str = "output", hist_every: int = 0,
                ckpt_every: int = 0, check_every: int = 10):
    """Integrate nsteps with an interactive surface: bulk aerodynamic
    fluxes from the evolving state each step (the data-ocean coupler's
    role) and, with `slab_ocean=True`, a prognostic mixed-layer SST that
    closes the surface energy budget. Returns (state, sst, timer). Steps
    eagerly, one after another; the checkpoint holds (state, sst)."""
    from .models.coupling.surface_fluxes import (bulk_surface_fluxes,
                                                 slab_ocean_step)

    os.makedirs(out_dir, exist_ok=True)
    timer = PhaseTimer()
    reg = _history_registry(
        ["OMEGA", "RELHUM", "TMQ", "PRECT", "TS", "SST", "US", "VS",
         "PRECCMX", "T850", "U250", "Z500", "VT", "VU", "CLDTOT", "CLDLOW",
         "CLDHGH"])
    dtype = state.phys.t.dtype
    hist = _HistoryTapes(reg, model, dtype, hist_every,
                         out_dir) if hist_every else None
    ckpt_writer = AsyncCheckpointWriter() if ckpt_every else None
    area = _grid_area(model.grid, dtype) if hist else None
    nstep0 = int(state.nstep)

    def _step(s, sst, first):
        cam_in = bulk_surface_fluxes(s.phys, sst, model.registry.pcnst)
        s2, cam_out, diags = atm_step(model, s, cam_in, first_step=first)
        if slab_ocean:
            sst = slab_ocean_step(sst, cam_in, cam_out, model.dt,
                                  h_mix=h_mix, q_flux=q_flux)
        return s2, sst, cam_in, cam_out, diags

    last_ok = 0
    for i in range(nsteps):
        state, sst, cam_in, cam_out, diags = timer.timed(
            "atm_step", _step, state, sst, i == 0 and nstep0 == 0)
        nstep = nstep0 + i + 1

        if hist:
            def payload():
                fields = _step_payload(state, cam_in, cam_out, diags, area)
                fields["SST"] = sst
                return fields
            timer.timed("outfld", hist.accumulate, payload)
            with timer.region("history_write"):
                hist.maybe_write(i + 1, nstep * model.dt / 86400.0)

        if ckpt_every and (i + 1) % ckpt_every == 0:
            with timer.region("checkpoint"):
                ckpt_writer.write(
                    os.path.join(out_dir, f"ckpt_{i + 1:06d}"),
                    (state, sst), {"nstep": nstep})

        if check_every and (i + 1) % check_every == 0:
            with timer.region("sentinels"):
                try:
                    _check_state(state, i + 1)
                    last_ok = i + 1
                except BlowupError as err:
                    _structured_abort(out_dir, err, i + 1, hist, ckpt_writer,
                                      last_ok=last_ok)
                    raise

    _close(hist, ckpt_writer, timer)
    return state, sst, timer


def quick_run(im=48, jm=24, km=10, nsteps=4, device="cuda", dtype=None,
              **kwargs):
    """A small end-to-end Held-Suarez run of the coupled driver (the
    developer smoke), on `device` in `dtype` (float64 on the CPU, float32
    on a card, unless given)."""
    from .models.fv.held_suarez import hs_initial_state
    from .utils.device import resolve_device
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float32 if dev.type == "cuda" else torch.float64
    model = AtmModel.create(im, jm, km, dtype=dtype, device=dev)
    dyn0 = hs_initial_state(model.grid, model.coord, pert=1.0,
                            nq=model.registry.pcnst)
    q = torch.full_like(dyn0.q, 1e-4)
    q[0] = 3e-3 * (dyn0.delp / dyn0.delp.max())
    state = atm_init(model, dyn0.replace(q=q),
                     torch.zeros((jm, im), dtype=dtype, device=dev))
    ncol = jm * im
    cam_in = CamIn.zeros(ncol, model.registry.pcnst, dtype=dtype, device=dev)
    cam_in = cam_in.replace(landfrac=torch.full((ncol,), 0.3, dtype=dtype,
                                                device=dev))
    return run(model, state, cam_in, nsteps, **kwargs)


if __name__ == "__main__":
    _, timer = quick_run(hist_every=2, ckpt_every=4)
    print(timer.table())
