"""Entry points: the Held-Suarez FV dycore large step and the ZM step.

`build_step` is the twin of `__graft_entry__._build`/`entry` in the JAX
package: one FV large step `dyn_run` (nsplit=4 small steps, one tracer
cycle, one remap, dt=1800 s) followed by `hs_forcing`. On a CUDA device
the step runs the port's CUDA kernels: with the default
filter_impl="fft" every small step is the fused K1-K4 (ops.cd_fused_kernels,
two launches each); with filter_impl="matmul" it is the unfused step with
transport3d and vort_flux3d. tracer_div3d runs in trac2d and te_map_remap
in te_map on both paths.

    step, state, grid, coord, phis = build_step(144, 96, 26)
    for _ in range(4):
        state = step(state, grid, coord, phis)

`build_zm_step` is the twin of bench.py's ZM set-up: one `zm_conv_tend`
on ncol columns of a conditionally unstable sounding. On a CUDA device
its tail runs the fused ZM tail kernel once a call.

    zm_step, pstate, pbuf, forcing = build_zm_step(144 * 96, 26)
    pstate, pbuf = zm_step(pstate, pbuf)

Together the two are the main path that bench.py times.

`build_coupled` is the twin of bench.py's coupled set-up (BENCH_COUPLED=1,
"config-4b"): the coupled atm_step with gray radiation, ZM, vertical
diffusion and the FV dycore over an aquaplanet with bulk surface fluxes.

    model, step, state, sst = build_coupled(144, 96, 26)
    state, cam_out, diags = step(state, first_step=True)
    state, cam_out, diags = step(state)

`build_coupled(..., microp=True)` is BENCH_MICROP=1's production
configuration, ZMConfig(microp=True); `aerosol=True` adds one prognostic
modal-aerosol mode (`accum_mode`: so4_a1 and pom_a1, the synthetic
optics tables), whose NAER/DGNUMWET feed ZM's in-plume activation from
the second step on.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.atm_comp import AtmModel, atm_init, atm_step
from .models.coupling.surface_fluxes import (aquaplanet_sst,
                                             bulk_surface_fluxes)
from .models.fv.dyn_comp import dyn_run
from .models.fv.grid import make_grid
from .models.fv.held_suarez import hs_forcing, hs_initial_state
from .models.fv.vertical import hybrid_coefficients
from .models.physics.constituents import Constituent, default_registry
from .models.physics.modal_aer_opt import AeroMode, make_synthetic_table
from .models.physics.physics_buffer import pbuf_register, zm_pbuf_specs
from .models.physics.state import make_state_from_profiles
from .models.physics.zm_conv_intr import zm_conv_tend
from .utils.config import FVConfig, PhysConfig, ZMConfig
from .utils.device import resolve_device

DT = 1800.0


def build_step(im: int = 144, jm: int = 96, km: int = 26,
               dtype=torch.float32, device="cuda",
               filter_impl: str = "fft", cfg: FVConfig | None = None):
    """Returns (step, state0, grid, coord, phis) for the HS large step at
    im x jm x km, dt = 1800 s, with `cfg` (default FVConfig(nsplit=4,
    nspltrac=1), the JAX package's `_build`; bench.py and the port's bench
    pass FVConfig(), whose auto splits differ beyond f19). The initial
    state is hs_initial_state with np.random.default_rng(0) noise, as in
    `_build`; filter_impl defaults to its "fft", the fused small step.

    Raises where `device` is CUDA and no card is present. For float32 on a
    card, TF32 matmuls must be off (the "matmul" polar filter's circulant
    matmul feeds the wind update; PyTorch's default keeps them off)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("build_step: torch.backends.cuda.matmul."
                           "allow_tf32 must be False (the polar filter "
                           "needs full float32 matmuls)")
    grid = make_grid(im, jm, km, dtype=dtype, device=dev)
    coord = hybrid_coefficients(km, dtype=dtype, device=dev)
    phis = torch.zeros((jm, im), dtype=dtype, device=dev)
    if cfg is None:
        cfg = FVConfig(nsplit=4, nspltrac=1)

    def step(state, grid, coord, phis):
        state = dyn_run(state, grid, coord, phis, cfg, DT,
                        filter_impl=filter_impl)
        return hs_forcing(state, grid, coord.ptop, DT)

    state0 = hs_initial_state(grid, coord, pert=1.0)
    return step, state0, grid, coord, phis


def zm_profiles(ncol: int, pver: int):
    """bench.py's ZM sounding as float64 numpy arrays: interface pressures
    pint (ncol, pver+1) on eta = linspace(0.003, 1, pver+1)**1.2 times
    1e5 Pa, t = max(300 (p/1e5)**0.19, 195) K plus 2 K in the lowest
    level, q = 0.017 (p/p_sfc)**2.5 + 1e-6 with the lowest 3 levels
    times 1.15."""
    eta = np.linspace(0.003, 1.0, pver + 1) ** 1.2
    pint = np.broadcast_to(eta[None, :] * 1.0e5, (ncol, pver + 1)).copy()
    pmid = 0.5 * (pint[:, 1:] + pint[:, :-1])
    t = np.maximum(300.0 * (pmid / 1.0e5) ** 0.19, 195.0)
    t[:, -1] += 2.0
    q = 0.017 * (pmid / pmid[:, -1:]) ** 2.5 + 1e-6
    q[:, -3:] *= 1.15
    return pint, t, q


def varied_zm_inputs(ncol: int, pver: int, dtype=torch.float32,
                     device="cuda"):
    """(pstate, pbuf, forcing) on `zm_profiles` with per-column variety
    from np.random.default_rng(0): t + 2 N(0, 1) K; u, v from
    N(0, 10) m/s; CLDLIQ and CLDICE uniform in [0, 1e-5] and [0, 1e-6]
    kg/kg; CLD uniform in [0, 0.5]; landfrac 0 or 1; and every fourth
    column the stable, dry profile t = 260 + 20 p/p_sfc K,
    q = 1e-5 p/p_sfc (tests/test_zm_conv.py::make_sounding). pblh and
    tpert as build_zm_step. Raises where `device` is CUDA and no card is
    present."""
    dev = resolve_device(device)
    reg = default_registry()
    rng = np.random.default_rng(0)
    pint, t, q0 = zm_profiles(ncol, pver)
    pmid = 0.5 * (pint[:, 1:] + pint[:, :-1])
    t = t + 2.0 * rng.standard_normal((ncol, pver))
    u = rng.normal(0.0, 10.0, (ncol, pver))
    v = rng.normal(0.0, 10.0, (ncol, pver))
    q = np.zeros((ncol, pver, reg.pcnst))
    q[:, :, 0] = q0
    q[:, :, 1] = rng.uniform(0.0, 1e-5, (ncol, pver))
    q[:, :, 2] = rng.uniform(0.0, 1e-6, (ncol, pver))
    cld = rng.uniform(0.0, 0.5, (ncol, pver))
    landfrac = (rng.uniform(size=ncol) < 0.5).astype(np.float64)
    stable = np.arange(ncol) % 4 == 3
    ratio = pmid[stable] / pmid[stable][:, -1:]
    t[stable] = 260.0 + 20.0 * ratio
    q[stable, :, 0] = 1e-5 * ratio

    def ten(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    pstate = make_state_from_profiles(ten(pint), ten(t), ten(u), ten(v),
                                      ten(q), ten(np.zeros(ncol)))
    pbuf = pbuf_register(zm_pbuf_specs(ncol, pver), dtype, dev).set(
        "CLD", ten(cld))
    forcing = dict(pblh=ten(np.full(ncol, 800.0)),
                   tpert=ten(np.full(ncol, 0.3)), landfrac=ten(landfrac))
    return pstate, pbuf, forcing


def build_zm_step(ncol: int, pver: int, dtype=torch.float32, device="cuda"):
    """Returns (step, pstate0, pbuf0, forcing) for one ZM deep-convection
    step, the twin of bench.py's ZM set-up: `zm_profiles` with zero winds,
    CLD = 0.1 in the physics buffer, pblh = 800 m, tpert = 0.3 K,
    landfrac = 1, dt = 1800 s, ZMConfig() and default_registry() (Q plus
    the convtran-1 tracers CLDLIQ and CLDICE, both zero).

    step(pstate, pbuf, forcing=forcing) -> (state1, pbuf) runs
    zm_conv_tend; `forcing` holds the (ncol,) pblh, tpert and landfrac.
    Raises where `device` is CUDA and no card is present."""
    dev = resolve_device(device)
    cfg = ZMConfig()
    reg = default_registry()
    pint, t, q0 = zm_profiles(ncol, pver)

    def ten(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    q = np.zeros((ncol, pver, reg.pcnst))
    q[:, :, 0] = q0
    zeros = ten(np.zeros((ncol, pver)))
    pstate = make_state_from_profiles(ten(pint), ten(t), zeros, zeros,
                                      ten(q), ten(np.zeros(ncol)))
    pbuf = pbuf_register(zm_pbuf_specs(ncol, pver), dtype, dev).set(
        "CLD", ten(np.full((ncol, pver), 0.1)))
    forcing0 = dict(pblh=ten(np.full(ncol, 800.0)),
                    tpert=ten(np.full(ncol, 0.3)),
                    landfrac=ten(np.ones(ncol)))

    def step(pstate, pbuf, forcing=forcing0):
        o = zm_conv_tend(cfg, reg, pstate, pbuf, forcing["pblh"],
                         forcing["tpert"], forcing["landfrac"], DT)
        return o.state1, o.pbuf

    return step, pstate, pbuf, forcing0


# the accumulation mode's species and their initial mixing ratios (kg/kg)
AEROSOL_SPECIES = (("so4_a1", 2e-9), ("pom_a1", 1e-9))


def accum_mode() -> AeroMode:
    """One accumulation mode of sulfate and organic matter, with the
    synthetic optics tables (tests/test_aero_integration.py's mode)."""
    return AeroMode(name="accum", species_names=("so4_a1", "pom_a1"),
                    species_density=(1770.0, 1000.0),
                    species_refindex_sw=(complex(1.43, 1e-8),
                                         complex(1.55, 5e-3)),
                    species_refindex_lw=(complex(1.35, 0.2),
                                         complex(1.5, 0.1)),
                    table=make_synthetic_table())


def build_coupled(im: int = 144, jm: int = 96, km: int = 26,
                  dtype=torch.float32, device="cuda",
                  fv_cfg: FVConfig | None = None, microp: bool = False,
                  aerosol: bool = False, **phys):
    """Returns (model, step, state0, sst) for bench.py's coupled
    configuration (bench.py:306-319): AtmModel.create(im, jm, km,
    dt=1800, phys_cfg=PhysConfig(radiation_scheme="gray"),
    zm_cfg=ZMConfig(microp=microp)) with FVConfig()'s auto splits unless
    `fv_cfg` is given; the initial state is hs_initial_state(pert=1) with
    q = 1e-6 everywhere but vapour, q[0] = 1e-2 (delp / max delp)^2, zero
    phis, through atm_init; sst is aquaplanet_sst of the columns'
    latitudes. `aerosol=True` registers AEROSOL_SPECIES (uniform at their
    mixing ratios) and PhysConfig.aero_modes=(accum_mode(),) with
    prog_modal_aero. Further keywords are PhysConfig fields (raytau0=5.0,
    do_circulation_diags=True, ...).

    step(state, first_step=False) -> (state, cam_out, diags) makes the
    CamIn with bulk_surface_fluxes from the state's physics export and
    runs atm_step. Raises where `device` is CUDA and no card is present."""
    dev = resolve_device(device)
    registry = default_registry()
    if aerosol:
        for name, _ in AEROSOL_SPECIES:
            registry = registry.add(Constituent(name=name, longname=name,
                                                qmin=0.0, mixtype="wet"))
        phys.update(aero_modes=(accum_mode(),), prog_modal_aero=True)
    phys_cfg = PhysConfig(radiation_scheme="gray", **phys)
    model = AtmModel.create(
        im, jm, km, dt=DT, registry=registry, fv_cfg=fv_cfg or FVConfig(),
        phys_cfg=phys_cfg, zm_cfg=ZMConfig(microp=microp), dtype=dtype,
        device=dev)
    pcnst = model.registry.pcnst
    dyn0 = hs_initial_state(model.grid, model.coord, pert=1.0, nq=pcnst)
    q = torch.full_like(dyn0.q, 1e-6)
    q[0] = 1e-2 * (dyn0.delp / dyn0.delp.max()) ** 2
    for name, mmr in AEROSOL_SPECIES if aerosol else ():
        q[registry.index(name)] = mmr
    state0 = atm_init(model, dyn0.replace(q=q),
                      torch.zeros((jm, im), dtype=dtype, device=dev))
    sst = aquaplanet_sst(state0.phys.lat)

    def step(state, first_step: bool = False):
        cam_in = bulk_surface_fluxes(state.phys, sst, pcnst)
        return atm_step(model, state, cam_in, first_step=first_step)

    return model, step, state0, sst
