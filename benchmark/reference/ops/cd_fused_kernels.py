"""The fused small step's K1-K4, plain versions under the kernel
wrappers' names: the reference never launches a kernel."""

from __future__ import annotations

from ..models.fv.cd_fused import k1_ref as k1
from ..models.fv.cd_fused import k2_ref as k2
from ..models.fv.cd_fused import k3_ref as k3
from ..models.fv.cd_fused import k4_ref as k4

__all__ = ["k1", "k2", "k3", "k4"]
