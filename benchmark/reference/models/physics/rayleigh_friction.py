"""Rayleigh friction (rayleigh_friction_tend equivalent).

PyTorch twin of `cam_nor_physics_tpu.models.physics.rayleigh_friction`:
linear drag on the winds of the top model layers (physpkg.F90:2177-2185),
a sponge for resolved waves near the model top, with the kinetic energy it
removes returned as heating. The drag coefficient follows CAM's profile,
a hyperbolic-tangent ramp centred on level rayk0 with e-folding time
raytau0 (days) at the top.
"""

from __future__ import annotations

import torch


def rayleigh_friction_tend(state, ztodt: float, rayk0: int = 2,
                           raykrange: float = 0.0, raytau0: float = 5.0):
    """(dudt, dvdt, dsdt) from the top-of-model drag. rayk0: the ramp's
    centre level (0 at the top); raykrange: its width in levels (0 gives
    max(rayk0/2, 1), as CAM); raytau0 <= 0 disables."""
    pver = state.u.shape[1]
    if raytau0 <= 0.0:
        z = torch.zeros_like(state.u)
        return z, z, z
    krange = raykrange if raykrange > 0 else max(rayk0 / 2.0, 1.0)
    k = torch.arange(pver, dtype=state.u.dtype, device=state.u.device)
    # f = 1/(2 tau0) (1 + tanh((rayk0 - k)/krange)), 1/s
    tau0_s = raytau0 * 86400.0
    kf = (1.0 / (2.0 * tau0_s)) * (1.0 + torch.tanh((rayk0 - k) / krange))
    # implicit in time: u_new = u/(1 + kf dt)
    fac = (1.0 / (1.0 + kf * ztodt) - 1.0) / ztodt
    dudt = state.u * fac[None, :]
    dvdt = state.v * fac[None, :]
    # the frictional heating closes the kinetic-energy budget
    u_new = state.u + dudt * ztodt
    v_new = state.v + dvdt * ztodt
    dsdt = -0.5 * ((u_new ** 2 + v_new ** 2) -
                   (state.u ** 2 + state.v ** 2)) / ztodt
    return dudt, dvdt, dsdt
