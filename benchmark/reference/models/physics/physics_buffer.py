"""Physics buffer — named, lifetime-tagged field store (pbuf equivalent).

Twin of `cam_nor_physics_tpu.models.physics.physics_buffer`: fields with
'global' (persists across steps, the restart payload) or 'physpkg'
(scratch within one physics step) lifetime (reference
zm_conv_intr.F90:101-172). The buffer is treated as immutable: `set` and
`update` return a new buffer. `global_fields` is the persistent subset
(what a restart must carry); the driver's checkpoint holds the whole
AtmState, as the JAX driver's does.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Mapping

import torch


@dataclass
class PhysicsBuffer:
    fields: dict                                   # name -> tensor
    lifetimes: dict = field(default_factory=dict)  # name -> lifetime

    def get(self, name: str):
        return self.fields[name]

    def has(self, name: str) -> bool:
        return name in self.fields

    def set(self, name: str, value) -> "PhysicsBuffer":
        if name not in self.fields:
            raise KeyError(f"pbuf field {name!r} not registered")
        new = dict(self.fields)
        new[name] = value
        return replace(self, fields=new)

    def update(self, **kv) -> "PhysicsBuffer":
        out = self
        for k, v in kv.items():
            out = out.set(k, v)
        return out

    def global_fields(self) -> dict:
        """The persistent ('global') subset: the restart payload."""
        return {k: v for k, v in self.fields.items()
                if self.lifetimes.get(k) == "global"}

    def reset_physpkg(self) -> "PhysicsBuffer":
        """The buffer with its per-step ('physpkg') fields zeroed (step
        start)."""
        return replace(self, fields={
            k: (torch.zeros_like(v) if self.lifetimes.get(k) == "physpkg"
                else v) for k, v in self.fields.items()})


def pbuf_register(specs: Mapping[str, tuple], dtype=torch.float64,
                  device="cpu") -> PhysicsBuffer:
    """A buffer of zeros from {name: (shape, lifetime)} specs
    (pbuf_add_field equivalent)."""
    fields_ = {name: torch.zeros(shape, dtype=dtype, device=device)
               for name, (shape, _) in specs.items()}
    lifetimes = {name: lifetime for name, (_, lifetime) in specs.items()}
    return PhysicsBuffer(fields=fields_, lifetimes=lifetimes)


def zm_pbuf_specs(ncol: int, pver: int) -> dict:
    """The ZM pbuf registration set (zm_conv_register,
    zm_conv_intr.F90:101-172)."""
    mid = ((ncol, pver), "physpkg")
    edge = ((ncol, pver + 1), "physpkg")
    srf = ((ncol,), "physpkg")
    return {
        "ZM_MU": mid, "ZM_EU": mid, "ZM_DU": mid, "ZM_MD": mid, "ZM_ED": mid,
        "ZM_DP": mid, "ZM_DSUBCLD": srf, "ZM_JT": srf, "ZM_MAXG": srf,
        "ZM_IDEEP": srf,
        "DP_FLXPRC": edge, "DP_FLXSNW": edge,
        "DP_CLDLIQ": mid, "DP_CLDICE": mid,
        "ICWMRDP": mid, "RPRDDP": mid, "NEVAPR_DPCU": mid,
        "PREC_DP": srf, "SNOW_DP": srf,
        "DLFZM": mid, "DIFZM": mid, "DNLFZM": mid, "DNIFZM": mid,
        "CMFMC_DP": edge,
        "CLD": ((ncol, pver), "global"),
        "FRACIS": ((ncol, pver), "physpkg"),
        "TPERT": srf, "PBLH": ((ncol,), "global"),
    }
