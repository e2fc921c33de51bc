"""Hydrostatic geopotential heights (geopotential_t equivalent).

Twin of `cam_nor_physics_tpu.ops.geopotential` (geopotential_t and its
hydrostatic matrix elements; geopotential_dse is not ported yet). Level
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
