"""Saturation vapor pressure / mixing ratio (wv_saturation equivalent).

Twin of `cam_nor_physics_tpu.ops.saturation`: the Goff-Gratch formulas
evaluated directly, with the upstream water/ice blending (a linear
transition over the 20 K band below freezing). Shape-polymorphic; the
operand order follows the JAX package.
"""

from __future__ import annotations

import math

import torch

from ..utils import constants as c

TMELT = c.TMELT
EPSILO = c.EPSILO
OMEPS = 1.0 - EPSILO
TRICE = 20.0  # width (K) of the water->ice transition band below freezing


def svp_water(t):
    """Goff-Gratch (1946) saturation vapor pressure over liquid water, Pa."""
    ts = 373.16
    e = (-7.90298 * (ts / t - 1.0)
         + 5.02808 * torch.log10(ts / t)
         - 1.3816e-7 * (10.0 ** (11.344 * (1.0 - t / ts)) - 1.0)
         + 8.1328e-3 * (10.0 ** (-3.49149 * (ts / t - 1.0)) - 1.0)
         + math.log10(1013.246))
    return 10.0 ** e * 100.0


def svp_ice(t):
    """Goff-Gratch saturation vapor pressure over ice, Pa."""
    h2otrip = 273.16
    e = (-9.09718 * (h2otrip / t - 1.0)
         - 3.56654 * torch.log10(h2otrip / t)
         + 0.876793 * (1.0 - t / h2otrip)
         + math.log10(6.1071))
    return 10.0 ** e * 100.0


def svp_trans(t):
    """Blended svp: water above freezing, ice 20 K below, linear between."""
    weight = torch.clamp((TMELT - t) / TRICE, 0.0, 1.0)
    return (1.0 - weight) * svp_water(t) + weight * svp_ice(t)


def svp_to_qsat(es, p):
    """Saturation mixing ratio epsilo*es / (p - omeps*es), capped at 1
    where p <= es (upstream wv_sat_svp_to_qsat)."""
    qs = EPSILO * es / (p - OMEPS * es)
    return torch.where(p - es <= 0.0, 1.0, qs)


def qsat(t, p):
    """(es, qs) with water/ice transition blending (upstream `qsat`)."""
    es = torch.minimum(svp_trans(t), p)
    return es, svp_to_qsat(es, p)


def qsat_water(t, p):
    """(es, qs) over liquid water only (upstream `qsat_water`)."""
    es = torch.minimum(svp_water(t), p)
    return es, svp_to_qsat(es, p)


def qsat_ice(t, p):
    """(es, qs) over ice only (upstream `qsat_ice`)."""
    es = torch.minimum(svp_ice(t), p)
    return es, svp_to_qsat(es, p)


def qsat_hpa(t, p_hpa):
    """The ZM plume code's interface (zm_conv.F90:5421-5437): pressure in
    hPa, es out in hPa, qs over water."""
    es, qs = qsat_water(t, p_hpa * 100.0)
    return es * 0.01, qs


def dqsdt_water(t, p):
    """d(qsat_water)/dT from Clausius-Clapeyron:
    qs * p * L es / (Rv T^2) / (es (p - omeps es))."""
    es, qs = qsat_water(t, p)
    desdt = c.LATVAP * es / (c.RH2O * t * t)
    return qs * p * desdt / (es * (p - OMEPS * es))
