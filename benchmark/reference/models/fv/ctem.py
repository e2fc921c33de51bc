"""TEM circulation diagnostics (ctem equivalent).

PyTorch twin of `cam_nor_physics_tpu.models.fv.ctem` (reference
fv/ctem.F90:32-493): u, v, ω and θ interpolated to pressure surfaces,
their zonal means and the eddy covariances v'θ', ω'θ', u'v', u'ω'. The
zonal mean is a mean over the minor (longitude) axis.

The pressure interpolation is linear in log p between the two layers
around each target. The JAX package picks them with a one-hot contraction
over the levels; here they are gathered at the same index, and a column
holding a value that is not finite outside the picked layer gives NaN, as
0·NaN and 0·inf make the contraction give NaN there.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import constants as c

_LEVELS: dict = {}


def default_ctem_levels(km: int = 26) -> np.ndarray:
    """The TEM output's pressure surfaces (Pa)."""
    return np.geomspace(30.0e2, 1000.0e2, km)


def pressure_levels(km: int, plev, like: torch.Tensor) -> torch.Tensor:
    """plev (default: default_ctem_levels(km)) as a tensor like `like`.
    The default levels are made once per device and dtype and kept, so a
    later call, one inside a CUDA graph capture too, copies nothing from
    the host."""
    if plev is not None:
        return torch.as_tensor(plev, dtype=like.dtype, device=like.device)
    key = (km, like.device, like.dtype)
    if key not in _LEVELS:
        _LEVELS[key] = torch.as_tensor(default_ctem_levels(km),
                                       dtype=like.dtype, device=like.device)
    return _LEVELS[key]


def _at_level(a, k):
    """a (km, jm, im) at level k (npl, jm, im), with the NaN a one-hot
    contraction over the levels gives where another level is not
    finite."""
    out = torch.gather(a, 0, k)
    n_bad = torch.sum(~torch.isfinite(a), 0)
    tainted = n_bad - (~torch.isfinite(out)).to(n_bad.dtype) > 0
    return torch.where(tainted, torch.nan, out)


def interp_to_pressure(field, pmid, plev):
    """Linear-in-log-p interpolation of a (km, jm, im) field to the
    (npl,) surfaces `plev`; targets outside the column take the end
    values (interpolate_data role)."""
    km = field.shape[0]
    lnp = torch.log(pmid)
    lnt = torch.log(plev)
    # the layer below each target: lnp[k] <= t < lnp[k+1]
    cnt = torch.sum(lnp[None] <= lnt[:, None, None, None], 1)
    k = torch.clamp(cnt - 1, 0, km - 2)
    p_lo, p_hi = _at_level(lnp, k), _at_level(lnp, k + 1)
    f_lo, f_hi = _at_level(field, k), _at_level(field, k + 1)
    w = torch.clamp((lnt[:, None, None] - p_lo) /
                    torch.where(p_hi == p_lo, 1.0, p_hi - p_lo), 0.0, 1.0)
    return f_lo + w * (f_hi - f_lo)


def ctem_diags(u3, v3, omega, t3, pmid, plev=None) -> dict:
    """TEM diagnostics (ctem_diags, ctem.F90:32-493) from (km, jm, im)
    cell-centre fields (A-grid winds): the zonal means U2d, V2d, W2d,
    TH2d and the eddy fluxes VTH2d, WTH2d, UV2d, UW2d, each (npl, jm)."""
    plev = pressure_levels(u3.shape[0], plev, u3)
    theta = t3 * (1.0e5 / pmid) ** c.CAPPA
    up = interp_to_pressure(u3, pmid, plev)
    vp = interp_to_pressure(v3, pmid, plev)
    wp = interp_to_pressure(omega, pmid, plev)
    thp = interp_to_pressure(theta, pmid, plev)

    def zm(a):
        return torch.mean(a, -1)

    ub, vb, wb, thb = zm(up), zm(vp), zm(wp), zm(thp)
    upr = up - ub[..., None]
    vpr = vp - vb[..., None]
    wpr = wp - wb[..., None]
    thpr = thp - thb[..., None]
    return {
        "U2d": ub, "V2d": vb, "W2d": wb, "TH2d": thb,
        "VTH2d": zm(vpr * thpr),      # meridional eddy heat flux
        "WTH2d": zm(wpr * thpr),      # vertical eddy heat flux
        "UV2d": zm(upr * vpr),        # meridional eddy momentum flux
        "UW2d": zm(upr * wpr),        # vertical eddy momentum flux
    }
