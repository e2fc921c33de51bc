"""te_map's vertical remap, plain version under the kernel wrapper's
name: the reference never launches a kernel."""

from __future__ import annotations

import torch

from .remap import _ppm_edges_nonuniform


def _seq_sum(x, dim: int):
    """Sum along `dim` in index order, as the kernel accumulates."""
    acc = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        acc = acc + x.select(dim, k)
    return acc


def _remap_set_ref(pe_s, pe_t, fields, kord: int):
    """Remap each (km, ncol) field from pe_s to pe_t ((km+1, ncol) each)."""
    dp = pe_s[1:] - pe_s[:-1]
    dp_safe = torch.where(dp == 0, 1e-30, dp)
    # fractional overlap of each source cell below each interior target
    # interface: (km_t - 1, km, ncol)
    s = torch.clamp((pe_t[1:-1, None, :] - pe_s[None, :-1, :]) / dp_safe,
                    0.0, 1.0)
    dpe_t = pe_t[1:] - pe_t[:-1]
    outs = []
    for q in fields:
        al, ar, a6 = (a.T for a in _ppm_edges_nonuniform(q.T, dp.T, kord))
        half = 0.5 * ((ar - al) + a6)
        third = a6 * (1.0 / 3.0)
        part = dp * (s * (al + s * (half - third * s)))
        m = torch.cat([torch.zeros_like(q[:1]), _seq_sum(part, 1),
                       _seq_sum(q * dp, 0)[None]], 0)
        outs.append((m[1:] - m[:-1]) / dpe_t)
    return outs


def te_map_remap_ref(pe_s, pe_t, pe_su, pe_tu, pe_sv, pe_tv, center_fields,
                     u, v, kord: int = 4):
    """Plain version of `te_map_remap`."""
    cen = _remap_set_ref(pe_s, pe_t, list(center_fields), kord)
    (u_n,) = _remap_set_ref(pe_su, pe_tu, [u], kord)
    (v_n,) = _remap_set_ref(pe_sv, pe_tv, [v], kord)
    return cen, u_n, v_n


te_map_remap = te_map_remap_ref
