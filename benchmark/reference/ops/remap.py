"""Conservative vertical PPM remapping (the kernel of te_map).

PyTorch twin of `cam_nor_physics_tpu.ops.remap`: cell means are remapped
through the cumulative mass function M(p) = ∫_{ptop}^{p} q dp of the
piecewise-parabolic reconstruction, evaluated at every target interface by
summing each source cell's clipped partial integral (no containing-cell
search). Target means (M(pe_t[k+1]) - M(pe_t[k])) / Δpe_t[k] conserve the
column integral by construction.

Shapes: pe_* are (ncol, km+1) monotone interface pressures sharing their
first and last values per column; q is (ncol, km) cell means.
"""

from __future__ import annotations

import torch


def _ppm_edges_nonuniform(q, dp, kord: int):
    """PPM edge values (al, ar, a6) along the last axis on a non-uniform
    grid, with the tp_core limiter family (kord-3 -> lmppm lmt)."""
    dq_lo = q[..., 1:] - q[..., :-1]
    z1 = torch.zeros_like(q[..., :1])
    dqc = torch.cat([z1, 0.5 * (dq_lo[..., 1:] + dq_lo[..., :-1]), z1], -1)
    qm, qc, qp = q[..., :-2], q[..., 1:-1], q[..., 2:]
    qmax = torch.cat([z1, torch.maximum(torch.maximum(qm, qc), qp) - qc, z1],
                     -1)
    qmin = torch.cat([z1, qc - torch.minimum(torch.minimum(qm, qc), qp), z1],
                     -1)
    dm = torch.sign(dqc) * torch.minimum(torch.minimum(torch.abs(dqc), qmax),
                                         qmin)
    if kord <= 2:
        return q - dm, q + dm, torch.zeros_like(q)

    w_hi = dp[..., :-1] / (dp[..., :-1] + dp[..., 1:])
    # (1/3)· rather than /3: PyTorch's CUDA division by a Python scalar
    # multiplies by the reciprocal, so the product is what both devices and
    # the te_map kernel compute alike
    edge = q[..., :-1] + w_hi * (q[..., 1:] - q[..., :-1]) + \
        (dm[..., :-1] - dm[..., 1:]) * (1.0 / 3.0)
    al = torch.cat([q[..., :1], edge], -1)
    ar = torch.cat([edge, q[..., -1:]], -1)
    a6 = 3.0 * (q + q - (al + ar))
    if kord == 3:                       # lmppm lmt = 0
        da1 = ar - al
        da2 = da1 ** 2
        a6da = a6 * da1
        lo = a6da < -da2
        hi = a6da > da2
        zero = dm == 0.0
        a6_lo = 3.0 * (al - q)
        ar_lo = al - a6_lo
        a6_hi = 3.0 * (ar - q)
        al_hi = ar - a6_hi
        a6n = torch.where(zero, 0.0, torch.where(lo, a6_lo,
                                                 torch.where(hi, a6_hi, a6)))
        arn = torch.where(zero, q, torch.where(lo, ar_lo, ar))
        aln = torch.where(zero, q, torch.where(hi, al_hi, al))
        return aln, arn, a6n
    # lmt >= 1: improved full constraint
    da1 = dm + dm
    dl = torch.sign(da1) * torch.minimum(torch.abs(da1), torch.abs(al - q))
    dr = torch.sign(da1) * torch.minimum(torch.abs(da1), torch.abs(ar - q))
    return q - dl, q + dr, 3.0 * (dl - dr)


def _mass_at_dense(pe_src, dp, al, delta, a6, pe_tgt):
    """Cumulative PPM mass at target interfaces, densely over cells.
    al/delta/a6 may carry a leading field axis (..., ncol, km); pe_tgt is
    (ncol, n). Returns (..., ncol, n)."""
    s = (pe_tgt[:, :, None] - pe_src[:, None, :-1]) / \
        torch.where(dp == 0, 1e-300, dp)[:, None, :]
    s = torch.clamp(s, 0.0, 1.0)
    al, delta, a6 = al[..., None, :], delta[..., None, :], a6[..., None, :]
    part = s * (al + s * (0.5 * (delta + a6) - a6 * s * (1.0 / 3.0)))
    return torch.sum(dp[:, None, :] * part, dim=-1)


def ppm_remap_multi(pe_src, qs, pe_tgt, kord: int = 4):
    """Remap fields sharing one interface set: qs (nf, ncol, km) ->
    (nf, ncol, km_t)."""
    dp = pe_src[:, 1:] - pe_src[:, :-1]
    al, ar, a6 = _ppm_edges_nonuniform(qs, dp, kord)
    m = _mass_at_dense(pe_src, dp, al, ar - al, a6, pe_tgt)
    # pin the endpoints: shared top/bottom interfaces carry 0 and the full
    # column mass exactly
    m[..., 0] = 0.0
    m[..., -1] = torch.sum(qs * dp, dim=-1)
    return (m[..., 1:] - m[..., :-1]) / (pe_tgt[:, 1:] - pe_tgt[:, :-1])


def ppm_remap(pe_src, q, pe_tgt, kord: int = 4):
    """Remap cell means q (ncol, km) from pe_src to pe_tgt; conservative
    when the end interfaces coincide."""
    return ppm_remap_multi(pe_src, q[None], pe_tgt, kord)[0]


def remap_state(pe_src, pe_tgt, fields: dict, kord: int = 4) -> dict:
    """Remap a dict of (ncol, km) fields from pe_src to pe_tgt."""
    names = list(fields)
    out = ppm_remap_multi(pe_src, torch.stack([fields[n] for n in names]),
                          pe_tgt, kord)
    return {n: out[i] for i, n in enumerate(names)}
