"""Entry point: the Held-Suarez FV dycore large step.

Twin of `__graft_entry__._build`/`entry` in the JAX package: one FV large
step `dyn_run` (nsplit=4 small steps, one tracer cycle, one remap, dt=1800 s)
followed by `hs_forcing`. On a CUDA device the step runs the port's four
CUDA kernels (transport3d and vort_flux3d in every small step, tracer_div3d
in trac2d, te_map_remap in te_map).

    step, state, grid, coord, phis = build_step(144, 96, 26)
    for _ in range(4):
        state = step(state, grid, coord, phis)
"""

from __future__ import annotations

import torch

from .models.fv.dyn_comp import dyn_run
from .models.fv.grid import make_grid
from .models.fv.held_suarez import hs_forcing, hs_initial_state
from .models.fv.vertical import hybrid_coefficients
from .utils.config import FVConfig
from .utils.device import resolve_device

DT = 1800.0


def build_step(im: int = 144, jm: int = 96, km: int = 26,
               dtype=torch.float32, device="cuda",
               filter_impl: str = "matmul"):
    """Returns (step, state0, grid, coord, phis) for the HS large step at
    im x jm x km, FVConfig(nsplit=4, nspltrac=1), dt = 1800 s. The initial
    state is hs_initial_state with np.random.default_rng(0) noise, as in
    the JAX package's `_build`.

    Raises where `device` is CUDA and no card is present. For float32 on a
    card, TF32 matmuls must be off (the polar filter's circulant matmul
    feeds the wind update; PyTorch's default keeps them off)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("build_step: torch.backends.cuda.matmul."
                           "allow_tf32 must be False (the polar filter "
                           "needs full float32 matmuls)")
    grid = make_grid(im, jm, km, dtype=dtype, device=dev)
    coord = hybrid_coefficients(km, dtype=dtype, device=dev)
    phis = torch.zeros((jm, im), dtype=dtype, device=dev)
    cfg = FVConfig(nsplit=4, nspltrac=1)

    def step(state, grid, coord, phis):
        state = dyn_run(state, grid, coord, phis, cfg, DT,
                        filter_impl=filter_impl)
        return hs_forcing(state, grid, coord.ptop, DT)

    state0 = hs_initial_state(grid, coord, pert=1.0)
    return step, state0, grid, coord, phis
