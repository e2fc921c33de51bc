"""Surface-exchange containers: cam_in_t and cam_out_t.

Twin of `cam_nor_physics_tpu.models.coupling.camsrfexch` (the reference's
camsrfexch, used at physpkg.F90:22): fluxes and surface properties into
the atmosphere (`CamIn`), lowest-level state and precipitation out of it
(`CamOut`, filled by `cam_export`). Dataclasses of tensors with
`replace`, as the port's PhysicsState.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import torch

from ...utils import constants as c


@dataclass
class CamIn:
    """Surface -> atmosphere (cam_in_t role): fluxes and surface state."""

    shf: torch.Tensor        # sensible heat flux (W/m2)
    lhf: torch.Tensor        # latent heat flux (W/m2)
    cflx: torch.Tensor       # constituent surface fluxes (ncol, pcnst)
    wsx: torch.Tensor        # zonal surface stress (N/m2)
    wsy: torch.Tensor        # meridional surface stress (N/m2)
    ts: torch.Tensor         # surface temperature (K)
    sst: torch.Tensor        # sea-surface temperature (K)
    landfrac: torch.Tensor
    icefrac: torch.Tensor
    ocnfrac: torch.Tensor
    snowhland: torch.Tensor  # snow depth over land (m)
    asdir: torch.Tensor      # shortwave albedos (direct/diffuse, vis/nir)
    asdif: torch.Tensor
    aldir: torch.Tensor
    aldif: torch.Tensor

    @classmethod
    def zeros(cls, ncol: int, pcnst: int, dtype=torch.float64,
              device="cpu") -> "CamIn":
        kw = dict(dtype=dtype, device=device)
        z = torch.zeros((ncol,), **kw)
        return cls(shf=z, lhf=z, cflx=torch.zeros((ncol, pcnst), **kw),
                   wsx=z, wsy=z, ts=torch.full((ncol,), 288.0, **kw),
                   sst=torch.full((ncol,), 288.0, **kw),
                   landfrac=z, icefrac=z, ocnfrac=torch.ones((ncol,), **kw),
                   snowhland=z, asdir=z, asdif=z, aldir=z, aldif=z)

    def replace(self, **kw) -> "CamIn":
        return replace(self, **kw)


@dataclass
class CamOut:
    """Atmosphere -> surface (cam_out_t role): bottom-level state and
    precipitation (cam_export, physpkg.F90:2933-2940)."""

    tbot: torch.Tensor       # bottom-level temperature (K)
    zbot: torch.Tensor       # bottom-level height (m)
    ubot: torch.Tensor
    vbot: torch.Tensor
    qbot: torch.Tensor       # (ncol, pcnst)
    pbot: torch.Tensor       # bottom mid-level pressure (Pa)
    rho: torch.Tensor        # bottom air density (kg/m3)
    psl: torch.Tensor        # sea-level pressure (Pa)
    precc: torch.Tensor      # convective precipitation (m/s)
    precl: torch.Tensor      # large-scale precipitation (m/s)
    precsc: torch.Tensor     # convective snow (m/s)
    precsl: torch.Tensor     # large-scale snow (m/s)
    netsw: torch.Tensor      # net shortwave at the surface (W/m2)
    flwds: torch.Tensor      # downwelling longwave at the surface (W/m2)

    def replace(self, **kw) -> "CamOut":
        return replace(self, **kw)


CAMIN_FIELDS = tuple(f.name for f in fields(CamIn))
CAMOUT_FIELDS = tuple(f.name for f in fields(CamOut))


def cam_export(state, prec_dp, snow_dp) -> CamOut:
    """cam_out from the physics state (cam_export role, physpkg.F90:2933;
    the upstream precipitation partition). Deep convection is the only
    source of precipitation: the large-scale rates are 0."""
    z = torch.zeros_like(state.ps)
    tbot = state.t[:, -1]
    pbot = state.pmid[:, -1]
    rho = pbot / (c.RAIR * tbot)
    # sea-level pressure: an isothermal-layer reduction
    psl = state.ps * torch.exp(state.phis / (c.RAIR * tbot))
    return CamOut(
        tbot=tbot, zbot=state.zm[:, -1], ubot=state.u[:, -1],
        vbot=state.v[:, -1], qbot=state.q[:, -1, :], pbot=pbot, rho=rho,
        psl=psl, precc=prec_dp, precl=z, precsc=snow_dp, precsl=z, netsw=z,
        flwds=z)
