"""Implicit vertical diffusion (vertical_diffusion_tend).

Twin of `cam_nor_physics_tpu.models.physics.vertical_diffusion`. The
reference calls upstream `vertical_diffusion_tend` from tphysac
(physpkg.F90:2144-2171): backward-Euler vertical diffusion of momentum,
dry static energy and constituents with the surface fluxes as the lower
boundary condition. Eddy diffusivities come from a local
Richardson-number scheme with a PBL enhancement. The tridiagonal solve is
the Thomas algorithm as two Python loops over the levels, each step an
elementwise operation over every column; the six fields share one
elimination of the matrix.
"""

from __future__ import annotations

import torch

from ...utils import constants as c

KARMAN = 0.4
RI_CRIT = 0.25
LAMBDA_FREE = 30.0      # asymptotic mixing length (m)
KV_MIN = 0.01           # background diffusivity (m2/s)
KV_MAX = 500.0


def tridiag_solve(a, b, cc, d):
    """Batched Thomas algorithm: a_i x_{i-1} + b_i x_i + c_i x_{i+1} = d_i
    along the last axis. a, b, cc: (ncol, n); d: (..., ncol, n), any
    leading axes sharing the matrix."""
    n = a.shape[-1]
    zero = torch.zeros_like(d[..., 0])
    cp_prev, dp_prev = torch.zeros_like(a[:, 0]), zero
    cps, dps = [], []
    for i in range(n):
        denom = b[:, i] - a[:, i] * cp_prev
        denom = torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
        cp_prev = cc[:, i] / denom
        dp_prev = (d[..., i] - a[:, i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x = [None] * n
    x_next = zero
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        x[i] = x_next
    return torch.stack(x, -1)


def eddy_diffusivity(state, pblh):
    """Interface eddy diffusivities (ncol, pver+1): a local
    Richardson-number scheme with stable-regime suppression and a PBL
    enhancement below pblh (eddy_diff role); zero at the top and the
    surface."""
    ncol = state.t.shape[0]
    zi = state.zi
    # shear and buoyancy gradients at the interior interfaces
    dz = torch.clamp(state.zm[:, :-1] - state.zm[:, 1:], min=1.0)
    du = state.u[:, :-1] - state.u[:, 1:]
    dv = state.v[:, :-1] - state.v[:, 1:]
    shear2 = (du ** 2 + dv ** 2) / dz ** 2 + 1.0e-8
    # virtual potential temperature
    thv = state.t * (1.0 + c.ZVIR * state.q[:, :, 0]) * \
        (1.0e5 / state.pmid) ** c.CAPPA
    dthv = thv[:, :-1] - thv[:, 1:]
    thv_m = 0.5 * (thv[:, :-1] + thv[:, 1:])
    ri = (c.GRAVIT / thv_m) * dthv / dz / shear2

    z_int = zi[:, 1:-1]                               # interior interfaces
    lmix = 1.0 / (1.0 / (KARMAN * torch.clamp(z_int, min=1.0))
                  + 1.0 / LAMBDA_FREE)
    fri = torch.where(ri < 0.0, torch.sqrt(1.0 - 18.0 * ri),
                      torch.clamp(1.0 - ri / RI_CRIT, min=0.0) ** 2)
    kv = lmix ** 2 * torch.sqrt(shear2) * fri
    # PBL enhancement: a cubic profile below pblh
    zfrac = torch.clamp(z_int / torch.clamp(pblh[:, None], min=1.0),
                        0.0, 1.0)
    k_pbl = KARMAN * 0.5 * z_int * (1.0 - zfrac) ** 2
    kv = torch.clamp(torch.maximum(kv, torch.where(zfrac < 1.0, k_pbl, 0.0)),
                     KV_MIN, KV_MAX)
    zerocol = torch.zeros((ncol, 1), dtype=kv.dtype, device=kv.device)
    return torch.cat([zerocol, kv, zerocol], 1)


def vertical_diffusion_tend(state, cam_in_shf, cam_in_cflx, cam_in_wsx,
                            cam_in_wsy, pblh, ztodt: float):
    """Implicit diffusion of u, v, s and q with surface fluxes (the
    vertical_diffusion_tend contract). Returns {dudt, dvdt, dsdt, dqdt
    (ncol, pver, pcnst), kvh}."""
    ncol = state.t.shape[0]
    pcnst = state.q.shape[-1]
    kv = eddy_diffusivity(state, pblh)                # (ncol, pver+1)

    # d(x)/dt = g d/dp [rho^2 g Kv d(x)/dp] on the layers
    rho_int = state.pint[:, 1:-1] / (c.RAIR * 0.5 *
                                     (state.t[:, :-1] + state.t[:, 1:]))
    gk = (c.GRAVIT * rho_int) ** 2 * kv[:, 1:-1]      # interior interfaces
    dp_mid = state.pmid[:, 1:] - state.pmid[:, :-1]
    w_int = gk / torch.clamp(dp_mid, min=1.0)         # (ncol, pver-1)
    rpdel = state.rpdel

    # tridiagonal coefficients (backward Euler)
    zero = torch.zeros((ncol, 1), dtype=state.t.dtype, device=state.t.device)
    w_up = torch.cat([zero, w_int], 1)                # coupling to k-1
    w_dn = torch.cat([w_int, zero], 1)                # coupling to k+1
    a = -ztodt * w_up * rpdel
    cc = -ztodt * w_dn * rpdel
    b = 1.0 - a - cc

    # u, v, s and each tracer, with its surface flux into the lowest
    # layer (kg, J or N per m2 per s)
    xs = [state.u, state.v, state.s] + [state.q[:, :, m]
                                        for m in range(pcnst)]
    flux = [cam_in_wsx, cam_in_wsy, cam_in_shf] + [cam_in_cflx[:, m]
                                                   for m in range(pcnst)]
    d = torch.stack([torch.cat([x[:, :-1], (x[:, -1] + ztodt * f * c.GRAVIT
                                            * rpdel[:, -1])[:, None]], 1)
                     for x, f in zip(xs, flux)])
    new = tridiag_solve(a, b, cc, d)
    return dict(
        dudt=(new[0] - state.u) / ztodt,
        dvdt=(new[1] - state.v) / ztodt,
        dsdt=(new[2] - state.s) / ztodt,
        dqdt=(new[3:].movedim(0, -1) - state.q) / ztodt,
        kvh=kv)
