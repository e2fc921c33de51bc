"""Negative-tracer repair: qneg3, qneg4 and the vertical borrowing filler.

PyTorch twin of `cam_nor_physics_tpu.ops.fill` (qneg3, qneg4, fillz).
"""

from __future__ import annotations

import torch


def qneg3(q, qmin=0.0):
    """Clamp below-minimum mixing ratios to qmin (qneg3 semantics).
    Returns (q_fixed, worst, nfix): the repaired field, the most negative
    offense (inf when there is none) and the offense count."""
    bad = q < qmin
    worst = torch.min(torch.where(bad, q, torch.inf))
    return torch.where(bad, qmin, q), worst, torch.sum(bad)


def qneg4(cflx, qbot, pdel_bot, dt, gravit):
    """Surface-flux limiter (qneg4 semantics, physpkg.F90:1647): a
    negative surface flux may remove at most the lowest layer's tracer
    mass over dt. Returns the limited flux."""
    max_removal = qbot * pdel_bot / (gravit * dt)
    return torch.maximum(cflx, -max_removal)


def fillz(q, dp):
    """Vertical borrowing filler (fill_module's fillz): repair negative
    cells by borrowing mass from the cell below, sweeping top-down; the mass
    a net-negative column still owes at the bottom is returned as
    `residual`. q, dp: (..., km). Returns (q_new, residual)."""
    debt = torch.zeros(torch.broadcast_shapes(q.shape, dp.shape)[:-1],
                       dtype=q.dtype, device=q.device)
    out = []
    for k in range(q.shape[-1]):
        dp_k = dp[..., k]
        avail = q[..., k] * dp_k - debt
        out.append(torch.clamp(avail, min=0.0) / dp_k)
        debt = torch.clamp(-avail, min=0.0)
    return torch.stack(out, -1), debt
