"""Dry adiabatic adjustment (dadadj_tend).

Twin of `cam_nor_physics_tpu.models.physics.dadadj`. The reference calls
upstream `dadadj_tend` from tphysbc (physpkg.F90:2786-2806) right after
the energy fixer: unstable pairs of layers (potential temperature falling
with height) among the top NLVDRY interfaces are mixed to a common
potential temperature conserving cp * sum(T dp), vapour mass-weighted.
As in the JAX package, a fixed count of whole-column sweeps (masked where
already stable) replaces the reference's iterate-until-stable loop; here
the sweeps and the pairs are Python loops of elementwise operations.
"""

from __future__ import annotations

import torch

from ...utils import constants as c

NLVDRY = 3          # interfaces from the top that the adjustment covers
NITER = 15          # whole-column sweeps

def dadadj(t, q, pmid, pdel):
    """T and qv adjusted over the top NLVDRY pairs of layers, NITER
    sweeps. t, q, pmid, pdel: (ncol, pver), layer k above layer k+1.
    Returns (t_adj, q_adj)."""
    pver = t.shape[-1]
    nlvdry = min(NLVDRY, pver - 1)
    exn = (pmid / 1.0e5) ** c.CAPPA          # theta = T / exn
    # the levels the sweeps touch, as columns; the rest pass through
    tc = [t[:, k] for k in range(nlvdry + 1)]
    qc = [q[:, k] for k in range(nlvdry + 1)]
    for _ in range(NITER):
        for k in range(nlvdry):
            w_up, w_dn = pdel[:, k], pdel[:, k + 1]
            unstable = tc[k] / exn[:, k] < tc[k + 1] / exn[:, k + 1]
            # enthalpy-conserving common theta
            th_star = (w_up * tc[k] + w_dn * tc[k + 1]) / \
                (w_up * exn[:, k] + w_dn * exn[:, k + 1])
            q_star = (w_up * qc[k] + w_dn * qc[k + 1]) / (w_up + w_dn)
            tc[k], tc[k + 1] = (torch.where(unstable, th_star * exn[:, k],
                                            tc[k]),
                                torch.where(unstable,
                                            th_star * exn[:, k + 1],
                                            tc[k + 1]))
            qc[k], qc[k + 1] = (torch.where(unstable, q_star, qc[k]),
                                torch.where(unstable, q_star, qc[k + 1]))
    t_adj = torch.cat([torch.stack(tc, -1), t[:, nlvdry + 1:]], -1)
    q_adj = torch.cat([torch.stack(qc, -1), q[:, nlvdry + 1:]], -1)
    return t_adj, q_adj


def dadadj_tend(state, dt: float):
    """(ds/dt heating, dq/dt) of the adjustment (the dadadj_tend contract
    at physpkg.F90:2786)."""
    t_adj, q_adj = dadadj(state.t, state.q[:, :, 0], state.pmid, state.pdel)
    tend_s = c.CPAIR * (t_adj - state.t) / dt
    tend_q = (q_adj - state.q[:, :, 0]) / dt
    return tend_s, tend_q
