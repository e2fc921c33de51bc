"""Moist thermodynamics: entropy, enthalpy, and their batched inversions.

Twin of `cam_nor_physics_tpu.ops.thermo` (the ZM plume thermodynamic core):
  - `entropy` (Raymond & Blyth 1992), zm_conv.F90:5280-5300;
  - `enthalpy` (tht moist enthalpy), zm_conv.F90:5440-5457;
  - `calc_kappav`, the composition-dependent κ of the dycore's
    high-altitude option (fv/dyn_comp.F90:2474), with `MAJOR_SPECIES`;
  - `ientropy`/`ienthalpy`, zm_conv.F90:5304-5414, with three solvers:
    "newton" (fixed-count secant, the default: a straight run of tensor
    operations with no host synchronisation), "newton_exact" (analytic
    derivative) and "brent" (the reference's method).

The Brent loop runs over whole arrays like the JAX `lax.while_loop`: every
lane advances together, converged lanes freeze, and the loop stops after
`max_iter` passes or as soon as every lane has converged (checked on the
host each pass). That exit is part of the result: the freeze keeps the
swapped a2/b2, which still swap on later passes, so a converged lane's
root can move while others iterate. An unbracketable target returns NaN
and converged=False; nothing aborts.
"""

from __future__ import annotations

from functools import partial

import torch

from ..utils import constants as c
from .saturation import dqsdt_water, qsat_hpa

# ZM-internal constant aliases (zm_convi, zm_conv.F90:155-168)
CPRES = c.CPAIR
RL = c.LATVAP
TFREEZ = c.TMELT
EPS1 = c.EPSILO
RGAS = c.RAIR

# WACCM-X major species (fv/dyn_comp.F90:2371-2489): molecular weight
# (kg/kmole) and the kinetic-theory cp factor (cp = factor · R_universal /
# MW; monatomic 5/2, diatomic 7/2). Pure N2 gives κ = 2/7.
MAJOR_SPECIES = {
    "O": (15.9994, 2.5),
    "O2": (31.9988, 3.5),
    "H": (1.0074, 2.5),
    "N2": (28.0134, 3.5),
}


def calc_kappav(q, species):
    """κ = R/cp from major-species mass mixing ratios (cam_thermo's
    calc_kappav role). q: (nq, ...) tracer stack; `species`: (name, index)
    pairs locating 'O', 'O2', 'H' in q. N2 is the remainder 1 - Σ q_i, so
    no species gives the constant N2 κ. Returns κ with one tracer's shape:
    the dycore advects it as a tracer slot."""
    rair = 0.0
    cpair = 0.0
    qsum = torch.zeros_like(q[0])
    for name, ix in species:
        mw, cpfac = MAJOR_SPECIES[name]
        qi = torch.clamp(q[ix], 0.0, 1.0)
        qsum = qsum + qi
        rair = rair + qi * (c.RGAS / mw)
        cpair = cpair + qi * cpfac * (c.RGAS / mw)
    mw_n2, cp_n2 = MAJOR_SPECIES["N2"]
    qn2 = torch.clamp(1.0 - qsum, 0.0, 1.0)
    rair = rair + qn2 * (c.RGAS / mw_n2)
    cpair = cpair + qn2 * cp_n2 * (c.RGAS / mw_n2)
    return rair / cpair


def entropy(tk, p_hpa, qtot):
    """Moist entropy (J/kg/K), Raymond & Blyth 1992; p in hPa.

    s = (cp + qt*cl) ln(T/Tf) - Rd ln((p-e)/pref) + L qv/T - qv Rv ln(qv/qst)
    with qv = min(qt, qst) and L = Lv - (cl - cpv)(T - Tf).
    """
    pref = 1000.0
    L = RL - (c.CPLIQ - c.CPWV) * (tk - TFREEZ)
    _, qst = qsat_hpa(tk, p_hpa)
    qv = torch.minimum(qtot, qst)
    e = qv * p_hpa / (EPS1 + qv)
    return ((CPRES + qtot * c.CPLIQ) * torch.log(tk / TFREEZ)
            - RGAS * torch.log((p_hpa - e) / pref)
            + L * qv / tk
            - qv * c.RH2O * torch.log(qv / qst))


def enthalpy(tk, p_hpa, qtot, z):
    """Moist static enthalpy (J/kg), tht variant; p in hPa, z in m.

    h = (cp + qt*cl) T + L qv + (1+qt) g z, qv = min(qt, qst).
    """
    L = RL - (c.CPLIQ - c.CPWV) * (tk - TFREEZ)
    _, qst = qsat_hpa(tk, p_hpa)
    qv = torch.minimum(qtot, qst)
    return (CPRES + qtot * c.CPLIQ) * tk + L * qv + (1.0 + qtot) * c.GRAVIT * z


def _nz(x):
    """x with exact zeros replaced by 1e-30 (the Brent loop's guard)."""
    return torch.where(x == 0, 1e-30, x)


def _brent_invert(f, target, t_guess, max_iter=100, tol=0.001):
    """Batched Brent root of f(T) = target, bracketed at t_guess +- 10 K
    (widened by doubling to 160 K on lanes whose ends share a sign), the
    elementwise translation of zm_conv.F90:5335-5391. Returns
    (T, converged); T is NaN where the root was not bracketed."""
    eps_ = 3.0e-8
    half = torch.full_like(t_guess, 10.0)
    for _ in range(4):
        same = (f(t_guess - half) - target) * (f(t_guess + half) - target) > 0.0
        half = torch.where(same, half * 2.0, half)
    a = t_guess - half
    b = t_guess + half
    fa = f(a) - target
    fb = f(b) - target
    bracketed = fa * fb <= 0.0

    cc, fc = b, fb
    d = b - a
    e = b - a
    done = torch.zeros_like(t_guess, dtype=torch.bool)
    it = 0
    while it <= max_iter and not bool(done.all()):
        # re-bracket if fb, fc on the same side
        same = (fb > 0) & (fc > 0) | (fb < 0) & (fc < 0)
        cc = torch.where(same, a, cc)
        fc = torch.where(same, fa, fc)
        d = torch.where(same, b - a, d)
        e = torch.where(same, b - a, e)

        # swap so that b is the best guess
        swap = torch.abs(fc) < torch.abs(fb)
        a2 = torch.where(swap, b, a)
        b2 = torch.where(swap, cc, b)
        cc2 = torch.where(swap, a2, cc)
        fa2 = torch.where(swap, fb, fa)
        fb2 = torch.where(swap, fc, fb)
        fc2 = torch.where(swap, fa2, fc)

        tol1 = 2.0 * eps_ * torch.abs(b2) + 0.5 * tol
        xm = 0.5 * (cc2 - b2)
        done = done | (torch.abs(xm) <= tol1) | (fb2 == 0.0)

        # interpolation step: secant (a == c) or inverse quadratic
        use_interp = (torch.abs(e) >= tol1) & (torch.abs(fa2) > torch.abs(fb2))
        sbr = fb2 / _nz(fa2)
        a_eq_c = a2 == cc2
        p_sec = 2.0 * xm * sbr
        q_sec = 1.0 - sbr
        qbr = fa2 / _nz(fc2)
        rbr = fb2 / _nz(fc2)
        p_iq = sbr * (2.0 * xm * qbr * (qbr - rbr) - (b2 - a2) * (rbr - 1.0))
        q_iq = (qbr - 1.0) * (rbr - 1.0) * (sbr - 1.0)
        pbr = torch.where(a_eq_c, p_sec, p_iq)
        qbr2 = torch.where(a_eq_c, q_sec, q_iq)
        qbr2 = torch.where(pbr > 0, -qbr2, qbr2)
        pbr = torch.abs(pbr)
        ok = 2.0 * pbr < torch.minimum(3.0 * xm * qbr2 - torch.abs(tol1 * qbr2),
                                       torch.abs(e * qbr2))
        d_new = torch.where(use_interp & ok, pbr / _nz(qbr2), xm)
        e_new = torch.where(use_interp & ok, d, d_new)

        step = torch.where(torch.abs(d_new) > tol1, d_new,
                           torch.where(xm >= 0, tol1, -tol1))
        b3 = b2 + step
        fb3 = f(b3) - target

        # freeze converged lanes
        a = torch.where(done, a2, b2)
        b = torch.where(done, b2, b3)
        cc = cc2
        fa = torch.where(done, fa2, fb2)
        fb = torch.where(done, fb2, fb3)
        fc = fc2
        d = torch.where(done, d, d_new)
        e = torch.where(done, e, e_new)
        it += 1
    ok = done & bracketed
    return torch.where(ok, b, torch.nan), ok


def _newton_invert(f, target, t_guess, iters=7, dt_fd=0.5, clamp=10.0,
                   tol=0.001):
    """Fixed-count damped secant inversion of f(T) = target: one f-eval a
    step, the update clamped to +-clamp K (robust across the saturation
    kink). Returns (T, converged)."""
    tp = t_guess
    fp = f(tp) - target
    tc = tp + torch.where(fp > 0, -dt_fd, dt_fd).to(tp.dtype)
    for _ in range(iters):
        fc = f(tc) - target
        denom = fc - fp
        tiny = torch.full_like(denom, 1e-12)
        denom = torch.where(torch.abs(denom) < 1e-12,
                            torch.where(denom >= 0, tiny, -tiny), denom)
        step = fc * (tc - tp) / denom
        tn = tc - torch.clamp(step, -clamp, clamp)
        tp, fp, tc = tc, fc, tn
    fc = f(tc) - target
    conv = torch.abs(fc) <= torch.abs(f(tc + tol) - (fc + target)) + \
        1e-6 * torch.abs(target)
    return tc, conv


def _enthalpy_and_deriv(tk, p_hpa, qtot, z):
    """(h, dh/dT) with the exact saturated-branch derivative
    dh/dT = (cp + qt cl) - (cl - cpv) qv + L dqv/dT."""
    L = RL - (c.CPLIQ - c.CPWV) * (tk - TFREEZ)
    _, qst = qsat_hpa(tk, p_hpa)
    sat = qtot >= qst
    qv = torch.where(sat, qst, qtot)
    h = (CPRES + qtot * c.CPLIQ) * tk + L * qv + (1.0 + qtot) * c.GRAVIT * z
    dqvdt = torch.where(sat, dqsdt_water(tk, p_hpa * 100.0), 0.0)
    dh = (CPRES + qtot * c.CPLIQ) - (c.CPLIQ - c.CPWV) * qv + L * dqvdt
    return h, dh


def _entropy_and_deriv(tk, p_hpa, qtot):
    """(s, ds/dT) with the exact saturated-branch derivative (the JAX
    package's `_entropy_and_deriv`)."""
    L = RL - (c.CPLIQ - c.CPWV) * (tk - TFREEZ)
    Lp = -(c.CPLIQ - c.CPWV)
    _, qst = qsat_hpa(tk, p_hpa)
    sat = qtot >= qst
    qv = torch.where(sat, qst, qtot)
    e = qv * p_hpa / (EPS1 + qv)
    pref = 1000.0
    s = ((CPRES + qtot * c.CPLIQ) * torch.log(tk / TFREEZ)
         - RGAS * torch.log((p_hpa - e) / pref)
         + L * qv / tk
         - qv * c.RH2O * torch.log(qv / qst))
    qstp = dqsdt_water(tk, p_hpa * 100.0)
    dqvdt = torch.where(sat, qstp, 0.0)
    dedqv = p_hpa * EPS1 / (EPS1 + qv) ** 2
    dlog = torch.where(sat, 0.0, qv * c.RH2O * qstp / qst)
    ds = ((CPRES + qtot * c.CPLIQ) / tk
          + RGAS * dedqv * dqvdt / (p_hpa - e)
          + (Lp * qv + L * dqvdt) / tk - L * qv / (tk * tk)
          + dlog)
    return s, ds


def _newton_exact_invert(fdf, target, t_guess, iters=4, clamp=10.0,
                         tol=0.001):
    """Newton with the analytic derivative, a fixed count of steps each
    clamped to +-clamp K. Returns (T, converged)."""
    tc = t_guess
    for _ in range(iters):
        fc, dfc = fdf(tc)
        step = (fc - target) / torch.clamp(dfc, min=1e-6)
        tc = tc - torch.clamp(step, -clamp, clamp)
    fc, dfc = fdf(tc)
    conv = torch.abs(fc - target) <= dfc * tol + 1e-6 * torch.abs(target)
    return tc, conv


def _invert(fn, fdf, target, t_guess, max_iter, solver):
    if solver == "newton":
        return _newton_invert(fn, target, t_guess)
    if solver == "newton_exact":
        return _newton_exact_invert(fdf, target, t_guess)
    return _brent_invert(fn, target, t_guess, max_iter=max_iter)


def ientropy(s_target, p_hpa, qt, t_guess, max_iter=100, solver="brent"):
    """Invert entropy(T, p, qt) = s for T; returns (T, qst, converged)."""
    t, conv = _invert(partial(entropy, p_hpa=p_hpa, qtot=qt),
                      partial(_entropy_and_deriv, p_hpa=p_hpa, qtot=qt),
                      s_target, t_guess, max_iter, solver)
    _, qst = qsat_hpa(torch.where(conv, t, t_guess), p_hpa)
    return t, qst, conv


def ienthalpy(h_target, p_hpa, qt, z, t_guess, max_iter=100, solver="brent"):
    """Invert enthalpy(T, p, qt, z) = h for T; returns (T, qst, converged)."""
    t, conv = _invert(partial(enthalpy, p_hpa=p_hpa, qtot=qt, z=z),
                      partial(_enthalpy_and_deriv, p_hpa=p_hpa, qtot=qt, z=z),
                      h_target, t_guess, max_iter, solver)
    _, qst = qsat_hpa(torch.where(conv, t, t_guess), p_hpa)
    return t, qst, conv
