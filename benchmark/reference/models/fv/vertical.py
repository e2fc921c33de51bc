"""Hybrid vertical coordinate (hycoef equivalent).

PyTorch twin of `cam_nor_physics_tpu.models.fv.vertical`: the same analytic
hybrid set, p(k) = ak + bk·ps, with ak/bk held as tensors in the model's
dtype and device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...utils.device import resolve_device


@dataclass
class HybridCoord:
    """Hybrid ak/bk set: (km+1,) tensors, plus the scalars ps0 and ptop
    (ak[0], taken in float64 before any cast)."""

    ak: torch.Tensor     # (km+1,) Pa
    bk: torch.Tensor     # (km+1,) dimensionless
    ps0: float
    ptop: float

    @property
    def km(self) -> int:
        return self.ak.shape[0] - 1

    def pint(self, ps):
        """Interface pressures (..., km+1) from surface pressure (...,)."""
        return self.ak + self.bk * ps[..., None]


def hybrid_coefficients(km: int, ptop: float = 219.4, ps0: float = 1.0e5,
                        p_sigma_switch: float = 0.18, dtype=torch.float64,
                        device="cuda") -> HybridCoord:
    """Smooth CAM-like hybrid set: eta(k) = ptop/ps0 + (1-ptop/ps0)(k/km)^1.6,
    pure pressure above `p_sigma_switch`, bk(surface) = 1."""
    k = np.arange(km + 1, dtype=np.float64) / km
    etat = ptop / ps0
    eta = etat + (1.0 - etat) * k ** 1.6
    bk = np.where(eta > p_sigma_switch,
                  ((eta - p_sigma_switch) / (1.0 - p_sigma_switch)) ** 2,
                  0.0)
    bk[-1] = 1.0
    ak = (eta - bk) * ps0
    ak[0] = etat * ps0
    ak[-1] = 0.0
    device = resolve_device(device)
    return HybridCoord(ak=torch.as_tensor(ak, dtype=dtype, device=device),
                       bk=torch.as_tensor(bk, dtype=dtype, device=device),
                       ps0=float(ps0), ptop=float(ak[0]))


def sigma_coefficients(km: int, ptop: float = 100.0, ps0: float = 1.0e5,
                       dtype=torch.float64, device="cuda") -> HybridCoord:
    """Pure sigma-like hybrid set (Held-Suarez style), evenly spaced in
    sigma: bk = k/km, ak = ptop·(1 - k/km)."""
    k = np.arange(km + 1, dtype=np.float64) / km
    ak = ptop * (1.0 - k)
    device = resolve_device(device)
    return HybridCoord(ak=torch.as_tensor(ak, dtype=dtype, device=device),
                       bk=torch.as_tensor(k, dtype=dtype, device=device),
                       ps0=float(ps0), ptop=float(ak[0]))
