"""Zonal-time-mean climatology on pressure surfaces, the analysis the
Held-Suarez 1994 benchmark is judged by.

PyTorch twin of `cam_nor_physics_tpu.utils.climatology`. HS94 (BAMS 75,
1825-1830) defines the test by its long-time zonal-mean climate:
subtropical westerly jets of ~30 m/s near 250 hPa at ±40-50°, tropical
surface easterlies, and midlatitude temperature-variance maxima. The
accumulator is a dict of tensors on the model's device, updated with no
host read (so it can sit inside a captured step); `climo_resolve` and
`hs94_checks` run on the host at the end of a run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.fv.ctem import (default_ctem_levels, interp_to_pressure,
                             pressure_levels)
from .device import resolve_device


def climo_init(km: int, jm: int, nplev: int | None = None,
               dtype=torch.float32, device="cuda") -> dict:
    """Zeroed accumulator: running sums of the zonal-mean u, v, T, T², u²
    on (nplev, jm) pressure-latitude sections, and the sample count."""
    npl = nplev or len(default_ctem_levels(km))
    dev = resolve_device(device)
    z = torch.zeros((npl, jm), dtype=dtype, device=dev)
    return {"u": z, "v": z, "t": z, "t2": z, "u2": z,
            "count": torch.zeros((), dtype=dtype, device=dev)}


def climo_update(acc: dict, u3, v3, t3, pmid, plev=None) -> dict:
    """Add one sample of the zonal-mean state: (km, jm, im) A-grid winds,
    temperature and layer mid-pressures."""
    plev = pressure_levels(u3.shape[0], plev, u3)
    up = torch.mean(interp_to_pressure(u3, pmid, plev), -1)
    vp = torch.mean(interp_to_pressure(v3, pmid, plev), -1)
    tp = torch.mean(interp_to_pressure(t3, pmid, plev), -1)
    return {"u": acc["u"] + up, "v": acc["v"] + vp, "t": acc["t"] + tp,
            "t2": acc["t2"] + tp * tp, "u2": acc["u2"] + up * up,
            "count": acc["count"] + 1.0}


def climo_resolve(acc: dict) -> dict:
    """Time means and the temporal variances of the zonal means, as numpy
    arrays on the host."""
    h = {k: v.detach().cpu().numpy() for k, v in acc.items()}
    n = float(np.maximum(h["count"], 1.0))
    u = h["u"] / n
    v = h["v"] / n
    t = h["t"] / n
    return {"u": u, "v": v, "t": t,
            "u_var": h["u2"] / n - u * u,
            "t_var": h["t2"] / n - t * t,
            "nsamples": n}


def hs94_checks(climo: dict, lats_deg: np.ndarray,
                plev: np.ndarray) -> dict:
    """The HS94 climatology's structure checks, {name: (value, ok)}, with
    the published figures' generous tolerances (their Fig. 1-2):
      jet_speed      : max time-zonal-mean u in 20 - 45 m/s
      jet_latitude   : |lat of max| in 30 - 60°
      jet_pressure   : p of max u in 150 - 400 hPa
      tropical_east  : equatorial-band zonal wind easterly (min u < 0)
      sfc_polar_t    : lowest-level T falls equator -> pole by > 20 K
      temp_monotone  : T at 300 hPa colder than at 850 hPa by > 20 K
    """
    u, t = climo["u"], climo["t"]
    imax = np.unravel_index(np.argmax(u), u.shape)
    jet_speed = float(u[imax])
    jet_lat = float(abs(lats_deg[imax[1]]))
    jet_p = float(plev[imax[0]] / 100.0)

    trop = np.abs(lats_deg) < 15.0
    tropical_min_u = float(u[:, trop].min())

    low = -1                     # largest pressure = lowest level
    eq = np.argmin(np.abs(lats_deg))
    sfc_dt = float(t[low, eq] - min(t[low, 0], t[low, -1]))

    k300 = int(np.argmin(np.abs(plev - 300e2)))
    k850 = int(np.argmin(np.abs(plev - 850e2)))
    lapse_dt = float(np.mean(t[k850] - t[k300]))

    return {
        "jet_speed_ms": (jet_speed, 20.0 <= jet_speed <= 45.0),
        "jet_latitude_deg": (jet_lat, 30.0 <= jet_lat <= 60.0),
        "jet_pressure_hpa": (jet_p, 150.0 <= jet_p <= 400.0),
        "tropical_easterlies_ms": (tropical_min_u, tropical_min_u < 0.0),
        "sfc_eq_pole_dT_K": (sfc_dt, sfc_dt > 20.0),
        "lapse_850_300_dT_K": (lapse_dt, lapse_dt > 20.0),
    }
