"""Tracer-mass conservation bookkeeping (check_tracers).

Twin of `cam_nor_physics_tpu.models.physics.check_tracers`. The reference
brackets physics with check_tracers_init / check_tracers_chng
(physpkg.F90:2719, 1993): the column mass of each tracer is recorded at
step start, and a later check holds its change to the accumulated surface
fluxes, aborting on a violation. Here the check returns the residual, for
a sentinel to read, and aborts nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...utils import constants as c


@dataclass
class TracerState:
    """Column mass of each tracer at the last init/chng (kg/m2)."""

    mass: torch.Tensor         # (ncol, pcnst)


def _column_mass(state) -> torch.Tensor:
    return torch.sum(state.q * state.pdel[:, :, None], 1) / c.GRAVIT


def check_tracers_init(state) -> TracerState:
    """Record each tracer's column mass (check_tracers_init)."""
    return TracerState(mass=_column_mass(state))


def check_tracers_chng(state, tracers: TracerState, cflx=None,
                       dt: float = 0.0):
    """The change of each tracer's column mass against the surface input
    (check_tracers_chng). cflx: (ncol, pcnst) kg/m2/s, the surface fluxes
    accumulated since init. Returns (new TracerState, residual (ncol,
    pcnst))."""
    mass = _column_mass(state)
    expected = tracers.mass
    if cflx is not None and dt > 0.0:
        expected = expected + cflx * dt
    return TracerState(mass=mass), mass - expected
