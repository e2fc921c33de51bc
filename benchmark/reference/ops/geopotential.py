"""Hydrostatic geopotential heights (geopotential_t equivalent).

Twin of `cam_nor_physics_tpu.ops.geopotential` (geopotential_t,
geopotential_dse and their hydrostatic matrix elements). Level
k=0 is the model top; interfaces have pver+1 entries, zi[:, pver] = 0.
The recursion for zi is a suffix sum over levels (reference
geopotential.F90:153-311, LR branch):
    hkl = ln pint(k+1) - ln pint(k),  hkk = 1 - pint(k) * hkl * rpdel(k)
"""

from __future__ import annotations

import torch

from ..utils import constants as c


def _hydrostatic_elements(piln, pint, pmid, pdel, rpdel, dycore: str):
    if dycore in ("LR", "FV3"):
        hkl = piln[:, 1:] - piln[:, :-1]
        hkk = 1.0 - pint[:, :-1] * hkl * rpdel
    else:  # EUL / SE / MPAS midpoint rule
        hkl = pdel / pmid
        hkk = 0.5 * hkl
    return hkl, hkk


def geopotential_t(piln, pmln, pint, pmid, pdel, rpdel, t, q1,
                   zvir=c.ZVIR, rair=c.RAIR, gravit=c.GRAVIT,
                   dycore: str = "LR"):
    """Heights zi (ncol, pver+1) and zm (ncol, pver) from T and pressures;
    q1 is the water vapor mixing ratio."""
    hkl, hkk = _hydrostatic_elements(piln, pint, pmid, pdel, rpdel, dycore)
    rog = rair / gravit
    tv = t * (1.0 + zvir * q1)
    dz = rog * tv * hkl
    zi_top = torch.flip(torch.cumsum(torch.flip(dz, (-1,)), -1), (-1,))
    zi = torch.cat([zi_top, torch.zeros_like(zi_top[:, :1])], -1)
    zm = zi[:, 1:] + rog * tv * hkk
    return zi, zm


def geopotential_dse(piln, pmln, pint, pmid, pdel, rpdel, dse, q1, phis,
                     zvir=c.ZVIR, rair=c.RAIR, gravit=c.GRAVIT,
                     cpair=c.CPAIR, dycore: str = "LR"):
    """(t, zi, zm) from the dry static energy (geopotential_dse,
    reference geopotential.F90:29-150, LR branch). tv(k) depends on
    zi(k+1), which depends on tv below: a recursion from the surface up,
    one level at a time."""
    hkl, hkk = _hydrostatic_elements(piln, pint, pmid, pdel, rpdel, dycore)
    rog = rair / gravit
    tvfac = 1.0 + zvir * q1
    pver = dse.shape[1]
    zi_below = torch.zeros_like(dse[:, 0])
    t, zm, zi = [None] * pver, [None] * pver, [None] * pver
    for k in range(pver - 1, -1, -1):
        tv = (dse[:, k] - phis - gravit * zi_below) / (
            cpair / tvfac[:, k] + rair * hkk[:, k])
        t[k] = tv / tvfac[:, k]
        zm[k] = zi_below + rog * tv * hkk[:, k]
        zi[k] = zi_below = zi_below + rog * tv * hkl[:, k]
    zi.append(torch.zeros_like(dse[:, 0]))
    return torch.stack(t, 1), torch.stack(zi, 1), torch.stack(zm, 1)
