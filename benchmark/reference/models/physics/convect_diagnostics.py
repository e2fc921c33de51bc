"""Merged convection diagnostics (convect_diagnostics).

Twin of `cam_nor_physics_tpu.models.physics.convect_diagnostics`
(reference convect_diagnostics.F90): deep plus shallow convection
outputs. With CLUBB as the shallow scheme (the only one the reference
accepts, :78-80) the shallow terms are zero (:185-196) and the merged
fields are the deep scheme's.
"""

from __future__ import annotations

import torch

from .physics_buffer import PhysicsBuffer


def convect_diagnostics_calc(state, pbuf: PhysicsBuffer) -> dict:
    """Merged CMFMC, cloud top and bottom levels and their pressures, and
    the total rain production (convect_diagnostics_calc, :115-237):
    {name: (ncol, ...) tensor}."""
    cmfmc_dp = pbuf.get("CMFMC_DP")          # (ncol, pver+1) kg/m2/s
    rprd_dp = pbuf.get("RPRDDP")             # (ncol, pver)
    cmfmc = cmfmc_dp                         # no shallow convection
    pver = state.pver
    active = cmfmc[:, 1:] > 1.0e-12          # interfaces below the top
    lev = torch.arange(pver, device=cmfmc.device)[None, :]
    # highest active interface -> cloud top; lowest -> cloud bottom
    cldtop = torch.amin(torch.where(active, lev, pver - 1), -1)
    cldbot = torch.amax(torch.where(active, lev, 0), -1)
    pcldtop = torch.gather(state.pmid, 1, cldtop[:, None])[:, 0]
    pcldbot = torch.gather(state.pmid, 1, cldbot[:, None])[:, 0]
    return {
        "CMFMC": cmfmc,
        "CLDTOP": cldtop.to(state.t.dtype),
        "CLDBOT": cldbot.to(state.t.dtype),
        "PCLDTOP": pcldtop,
        "PCLDBOT": pcldbot,
        "RPRDTOT": rprd_dp,
    }
