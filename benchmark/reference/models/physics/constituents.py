"""Constituent (tracer) registry — upstream `constituents` equivalent.

The port's own copy of `cam_nor_physics_tpu.models.physics.constituents`
(numpy only). The reference registers tracers via `cnst_add` with
per-tracer minimum mixing ratios, wet/dry mixing-ratio type, and
convective-transport membership flags `cnst_is_convtran1/2` (physpkg.F90
and zm_conv_intr.F90:875-886,955-1028). Water vapor must be constituent
index 0 ("Q must be constituent 1", physpkg.F90:113-118).

This is static Python configuration (hashable).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


@dataclass(frozen=True)
class Constituent:
    name: str
    qmin: float = 1.0e-12        # minimum permitted mixing ratio (kg/kg)
    mixtype: str = "wet"         # 'wet' or 'dry' mixing ratio basis
    molec_weight: float = 0.0
    is_convtran1: bool = False   # transported by convtran pass 1 (tphysbc)
    is_convtran2: bool = False   # transported by convtran pass 2 (tphysac)
    longname: str = ""


@dataclass(frozen=True)
class ConstituentRegistry:
    constituents: tuple[Constituent, ...] = ()

    def __post_init__(self):
        if self.constituents and self.constituents[0].name != "Q":
            raise ValueError("water vapor 'Q' must be constituent 0 "
                             "(reference physpkg.F90:113-118)")

    @property
    def pcnst(self) -> int:
        return len(self.constituents)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(cn.name for cn in self.constituents)

    def index(self, name: str) -> int:
        """cnst_get_ind equivalent; returns -1 if absent (abort=.false. path)."""
        try:
            return self.names.index(name)
        except ValueError:
            return -1

    def qmin_array(self, dtype=np.float64) -> np.ndarray:
        return np.array([cn.qmin for cn in self.constituents], dtype=dtype)

    def mask(self, attr: str) -> tuple[bool, ...]:
        return tuple(getattr(cn, attr) for cn in self.constituents)

    def add(self, cn: Constituent) -> "ConstituentRegistry":
        if cn.name in self.names:
            raise ValueError(f"constituent {cn.name} already registered")
        return replace(self, constituents=self.constituents + (cn,))


def default_registry(extra: int = 0) -> ConstituentRegistry:
    """Q + cloud liquid/ice (the convtran1 set, zm_conv_intr.F90:875-886)
    + `extra` passive test tracers (convtran2 set)."""
    base = [
        Constituent("Q", qmin=1.0e-12, molec_weight=18.016,
                    longname="Specific humidity"),
        Constituent("CLDLIQ", qmin=1.0e-12, is_convtran1=True,
                    longname="Grid box averaged cloud liquid amount"),
        Constituent("CLDICE", qmin=1.0e-12, is_convtran1=True,
                    longname="Grid box averaged cloud ice amount"),
    ]
    for n in range(extra):
        base.append(Constituent(f"TT{n:02d}", qmin=0.0, is_convtran2=True,
                                longname=f"passive test tracer {n}"))
    return ConstituentRegistry(tuple(base))
