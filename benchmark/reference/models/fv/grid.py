"""FV dycore grid geometry (grid_vars_init equivalent).

PyTorch twin of `cam_nor_physics_tpu.models.fv.grid`. The tables are
computed once in numpy float64 with the same formulas, then held as tensors
in the model's dtype on the model's device (PyTorch promotes a float32
tensor to float64 when it meets a float64 tensor, so every table a step
reads must share the state's dtype).

Grid staggering (Arakawa D grid, lat-lon): jm latitude rows, j=0 the south
pole row, j=jm-1 the north pole row; cosp/sinp at cell centers, cose/sine at
cell edges (edge j = south edge of row j); im periodic longitudes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ...utils import constants as c
from ...utils.device import resolve_device


@dataclass
class FVGrid:
    """FV grid tables: (jm,) and (im,) tensors plus scalar spacings."""

    im: int
    jm: int
    km: int
    dl: float            # longitude spacing (rad)
    dp: float            # latitude spacing (rad)
    cosp: torch.Tensor
    sinp: torch.Tensor
    cose: torch.Tensor
    sine: torch.Tensor
    acosp: torch.Tensor
    acosu: torch.Tensor
    coslon: torch.Tensor
    sinlon: torch.Tensor
    cosl5: torch.Tensor
    sinl5: torch.Tensor
    acap: float
    rcap: float
    f0: torch.Tensor     # Coriolis at cell centers
    fc: torch.Tensor     # Coriolis at cell edges
    ycrit_deg: float
    pft_center: torch.Tensor   # (jm, im//2+1) rfft damping factors, centers
    pft_edge: torch.Tensor     # (jm, im//2+1) damping factors, edges
    lats: torch.Tensor         # (jm,) cell-center latitudes (rad)
    lons: torch.Tensor         # (im,) cell-center longitudes (rad)
    # real-DFT factors of the fused cd_step's in-kernel polar filter
    # (cd_fused.py): forward (im, nf) and inverse (nf, im), nf = im//2+1
    dft_fc: torch.Tensor
    dft_fs: torch.Tensor
    dft_gc: torch.Tensor
    dft_gs: torch.Tensor
    rdy: float = 0.0
    _circ: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.cosp.dtype

    @property
    def device(self) -> torch.device:
        return self.cosp.device

    def circ_center(self) -> torch.Tensor:
        """(jm, im, im) circulant form of the center-row polar filter."""
        return self._circ_memo("center")

    def circ_edge(self) -> torch.Tensor:
        """(jm, im, im) circulant form of the edge-row polar filter."""
        return self._circ_memo("edge")

    def _circ_memo(self, which: str) -> torch.Tensor:
        # built once per grid: an (jm, im, im) table is 8 MB in f32 at f19
        if which not in self._circ:
            resp = self.pft_center if which == "center" else self.pft_edge
            circ = circulant_filter_matrices(resp.cpu().numpy())
            self._circ[which] = torch.as_tensor(
                circ, dtype=self.dtype, device=self.device)
        return self._circ[which]


def make_grid(im: int, jm: int, km: int, dtype=torch.float64,
              device="cuda", am_geom_crrct: bool = False,
              ae: float = c.REARTH, om: float = c.OMEGA,
              ycrit_deg: float | None = None) -> FVGrid:
    """Build the FV grid tables (grid_vars_init, dynamics_vars.F90:729-983)."""
    if im % 2 != 0:
        raise ValueError("im must be even (dynamics_vars.F90:858)")
    dl = 2.0 * math.pi / im
    dp = math.pi / (jm - 1)

    j = np.arange(jm, dtype=np.float64)
    sine = np.zeros(jm + 1)
    ph5 = -0.5 * math.pi + (j - 0.5) * dp
    sine[:jm] = np.sin(ph5)
    sine[jm] = np.sin(-0.5 * math.pi + (jm - 0.5) * dp)

    cosp = np.zeros(jm)
    cosp[1:jm - 1] = (sine[2:jm] - sine[1:jm - 1]) / dp

    cose = np.zeros(jm)
    if am_geom_crrct:
        cose[1:] = np.cos(ph5[1:])
    else:
        cose[2:] = 0.5 * (cosp[1:jm - 1] + cosp[2:jm])
        cose[1] = 0.5 * (cosp[0] + cosp[1])
    cose[0] = cose[1]

    acosu = np.zeros(jm)
    acosu[1:jm - 1] = 2.0 / (cose[1:jm - 1] + cose[2:jm])

    sinp = np.zeros(jm)
    sinp[0], sinp[-1] = -1.0, 1.0
    if am_geom_crrct:
        sinp[1:jm - 1] = (cose[1:jm - 1] - cose[2:jm]) / dp
    else:
        sinp[1:jm - 1] = 0.5 * (sine[1:jm - 1] + sine[2:jm])

    acap = im * (1.0 + sine[1]) / dp
    rcap = 1.0 / acap

    acosp = np.empty(jm)
    acosp[0] = acosp[-1] = rcap * im
    acosp[1:jm - 1] = 1.0 / cosp[1:jm - 1]

    i = np.arange(im // 2, dtype=np.float64)
    zam5 = (i - 0.5) * dl
    zamda = i * dl
    cosl5 = np.concatenate([np.cos(zam5), -np.cos(zam5)])
    sinl5 = np.concatenate([np.sin(zam5), -np.sin(zam5)])
    coslon = np.concatenate([np.cos(zamda), -np.cos(zamda)])
    sinlon = np.concatenate([np.sin(zamda), -np.sin(zamda)])

    f0 = 2.0 * om * sinp
    fc = np.zeros(jm)
    if am_geom_crrct:
        fc[1:] = 2.0 * om * sine[1:jm]
    else:
        fc[1:] = 0.5 * (f0[1:] + f0[:-1])
    fc[0] = fc[1]

    # polar filter: ycrit from grid aspect ratio (dynamics_vars.F90:924-927)
    rat = im / (2.0 * (jm - 1.0))
    ycrit = math.acos(min(0.81, rat)) * 180.0 / math.pi
    if ycrit_deg is not None:
        ycrit = ycrit_deg
    pftc = _pft_coefficients(im, cosp, ycrit, pole_rows_exempt=True)
    pfte = _pft_coefficients(im, cose, ycrit, pole_rows_exempt=False)

    # real-DFT factor matrices for the fused-cd in-kernel polar filter
    mm = np.arange(im // 2 + 1, dtype=np.float64)
    ang = 2.0 * math.pi * np.outer(np.arange(im, dtype=np.float64), mm) / im
    wgt = np.where((mm == 0) | (mm == im // 2), 1.0, 2.0)
    dft_fc = np.cos(ang)
    dft_fs = np.sin(ang)
    dft_gc = (wgt[:, None] * np.cos(ang).T) / im
    dft_gs = (wgt[:, None] * np.sin(ang).T) / im

    device = resolve_device(device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return FVGrid(im=im, jm=jm, km=km, dl=dl, dp=dp, cosp=dev(cosp),
                  sinp=dev(sinp), cose=dev(cose), sine=dev(sine[:jm]),
                  acosp=dev(acosp), acosu=dev(acosu), coslon=dev(coslon),
                  sinlon=dev(sinlon), cosl5=dev(cosl5), sinl5=dev(sinl5),
                  acap=acap, rcap=rcap, f0=dev(f0), fc=dev(fc),
                  ycrit_deg=ycrit, pft_center=dev(pftc), pft_edge=dev(pfte),
                  lats=dev(np.linspace(-0.5 * math.pi, 0.5 * math.pi, jm)),
                  lons=dev(-math.pi + dl * np.arange(im)),
                  dft_fc=dev(dft_fc), dft_fs=dev(dft_fs),
                  dft_gc=dev(dft_gc), dft_gs=dev(dft_gs),
                  rdy=1.0 / (ae * dp))


def _pft_coefficients(im: int, coslat: np.ndarray, ycrit_deg: float,
                      pole_rows_exempt: bool = True) -> np.ndarray:
    """FFT polar-filter response per (row, zonal wavenumber):
    R(m, φ) = min[1, (cos φ / (cos φc · sin(π m / im)))²] poleward of ycrit,
    1 elsewhere and for the zonal mean."""
    coszc = math.cos(ycrit_deg * math.pi / 180.0)
    m = np.arange(im // 2 + 1, dtype=np.float64)
    s = np.sin(math.pi * m / im)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = coslat[:, None] / (coszc * np.where(s > 0, s, np.inf)[None, :])
    resp = np.minimum(1.0, ratio ** 2)
    resp[:, 0] = 1.0                        # never damp the zonal mean
    need = coslat < coszc
    resp = np.where(need[:, None], resp, 1.0)
    if pole_rows_exempt:
        # center pole rows are cap means; edge rows must stay filtered
        resp[0, :] = 1.0
        resp[-1, :] = 1.0
    return resp


def polar_filter(field, resp):
    """FFT polar filter along x: field (..., jm, im), resp (jm, im//2+1)."""
    spec = torch.fft.rfft(field, dim=-1)
    return torch.fft.irfft(spec * resp, n=field.shape[-1], dim=-1)


def circulant_filter_matrices(resp: np.ndarray) -> np.ndarray:
    """The polar filter as per-row circulant matrices (jm, im, im):
    M[j, i, m] = h[j, (i-m) mod im] with h = irfft(resp)."""
    im = 2 * (resp.shape[1] - 1)
    h = np.fft.irfft(resp, im, axis=1)
    i = np.arange(im)
    idx = (i[:, None] - i[None, :]) % im
    return h[:, idx]


def polar_filter_matmul(field, circ):
    """Circulant-matmul polar filter: field (..., jm, im), circ
    (jm, im, im). Equal to `polar_filter` with the generating response to
    roundoff. A batched matrix product in the field's dtype (TF32 must be
    off for float32, see entry.build_step)."""
    return torch.einsum('jim,...jm->...ji', circ, field)


def ffsl_flags(grid: FVGrid, crx, cosa=None):
    """Rows that need flux-form semi-Lagrangian (integer-CFL) x-transport:
    |c| > 1 anywhere in the row. crx: (..., jm, im); returns (..., jm)
    booleans."""
    return torch.amax(torch.abs(crx), dim=-1) > 1.0
