"""Convective tracer and momentum transport (convtran / momtran).

Twin of `cam_nor_physics_tpu.models.physics.zm_transport` (reference
zm_conv.F90:1976-2715). The updraft and downdraft in-cloud profiles are
Python loops over levels on (ncol,) rows, the JAX package's `lax.scan`s;
columns without deep convection have zero mass fluxes, so their tendencies
vanish. All mass fluxes and dp are in mb; `dt` is the full model step.

These are also the plain version of the fused ZM tail kernel
(ops/zm_tail_kernels.py), which repeats their arithmetic in this order.
"""

from __future__ import annotations

import torch

MBSTH = 1.0e-15   # mass-flux threshold (mb/s), zm_conv.F90:2077
SMALL = 1.0e-36


def _safe_div(a, b, eps=1.0e-300):
    """a / b with |b| < eps replaced by +-eps. eps is taken in b's dtype,
    as the JAX package takes it: in float32 1e-300 underflows to 0 and
    this is a plain division."""
    eps = float(torch.tensor(eps, dtype=b.dtype))
    if eps == 0.0:
        return a / b
    e = torch.full_like(b, eps)
    return a / torch.where(torch.abs(b) < eps, torch.where(b >= 0, e, -e), b)


def _above(a):
    """a(k-1) with the top level repeated (km1 = max(1, k-1))."""
    return torch.cat([a[:, :1], a[:, :-1]], 1)


def _below(a, fill=None):
    """a(k+1) with the bottom level repeated (or set to `fill`)."""
    last = a[:, -1:] if fill is None else torch.full_like(a[:, -1:], fill)
    return torch.cat([a[:, 1:], last], 1)


def _interface_chat(const, geometric: bool):
    """Environment interface values chat(k) from (const(k-1), const(k)):
    convtran's log mean where the layers differ (zm_conv.F90:2120-2143),
    momtran's arithmetic mean (:2424); chat(0) = const(0)."""
    c0 = _above(const)
    if not geometric:
        return 0.5 * (const + c0)
    minc = torch.minimum(c0, const)
    maxc = torch.maximum(c0, const)
    cdifr = torch.where(minc < 0, 0.0,
                        _safe_div(torch.abs(const - c0),
                                  torch.clamp(maxc, min=SMALL)))
    cabv = torch.maximum(c0, maxc * 1.0e-12)
    cbel = torch.maximum(const, maxc * 1.0e-12)
    use_log = cdifr > 1.0e-6
    safe = torch.where(use_log & (cabv != cbel), cabv - cbel, 1.0)
    logmean = torch.log(torch.where(use_log, _safe_div(cabv, cbel), 1.0)) / \
        safe * cabv * cbel
    return torch.where(use_log, logmean, 0.5 * (const + c0))


def _updraft_profile(const_src, chat, mu, du, eu, dp, extra=None):
    """conu, bottom-up (zm_conv.F90:2151-2186 / 2520-2560):
    conu(k) = (mu(k+1) conu(k+1) + eu(k) src(k) dp(k) [+ extra(k) dp(k)])
              / (mu(k) + du(k) dp(k))  where the denominator > MBSTH,
    else chat(k)."""
    pver = chat.shape[1]
    if extra is None:
        extra = torch.zeros_like(chat)
    conu_b = mu_b = torch.zeros_like(chat[:, 0])
    rows = [None] * pver
    for k in range(pver - 1, -1, -1):
        mupdudp = mu[:, k] + du[:, k] * dp[:, k]
        val = _safe_div(mu_b * conu_b + eu[:, k] * const_src[:, k] * dp[:, k]
                        + extra[:, k] * dp[:, k], mupdudp)
        conu_b = torch.where(mupdudp > MBSTH, val, chat[:, k])
        mu_b = mu[:, k]
        rows[k] = conu_b
    return torch.stack(rows, 1)


def _downdraft_profile(const_src, chat, md, dp, extra=None):
    """cond, top-down (zm_conv.F90:2189-2199 / 2563-2574):
    cond(k) = (md(k-1) cond(k-1) - (src(k-1) dp(k-1) + extra(k-1) dp(k-1)))
              / md(k)  where md(k) < -MBSTH, else chat(k);
    `const_src` carries the ed-folded source (ed*const)."""
    pver = chat.shape[1]
    if extra is None:
        extra = torch.zeros_like(chat)
    z = torch.zeros_like(chat[:, 0])
    cond_p, md_p, src_p, dp_p, ex_p = z, z, z, z, z
    rows = []
    for k in range(pver):
        val = _safe_div(md_p * cond_p - (src_p * dp_p + ex_p * dp_p),
                        md[:, k])
        cond_p = torch.where(md[:, k] < -MBSTH, val, chat[:, k])
        md_p, src_p, dp_p, ex_p = md[:, k], const_src[:, k], dp[:, k], \
            extra[:, k]
        rows.append(cond_p)
    return torch.stack(rows, 1)


def convtran_single(qcnst, fracis, mu, md, du, eu, ed, dp, jt, mx, dt,
                    dpdry=None, is_dry: bool = False):
    """Convective transport of one tracer (convtran inner loop,
    zm_conv.F90:1976-2311). Returns dqdt (/s)."""
    pver = qcnst.shape[1]
    karr = torch.arange(pver, device=qcnst.device)[None, :]

    if is_dry:
        fac = dp / dpdry
        dptmp, dutmp, eutmp, edtmp = dpdry, du * fac, eu * fac, ed * fac
    else:
        dptmp, dutmp, eutmp, edtmp = dp, du, eu, ed

    const = qcnst
    chat = _interface_chat(const, geometric=True)
    conu = _updraft_profile(fracis * const, chat, mu, dutmp, eutmp, dptmp)
    cond = _downdraft_profile(edtmp * fracis * const, chat, md, dptmp)

    mu_b = _below(mu, 0.0)
    md_b = _below(md, 0.0)
    conu_b = _below(conu)
    cond_b = _below(cond)
    chat_b = _below(chat)
    const_b = _below(const)
    const_a = _above(const)

    # version-3 flux-limited tendency (zm_conv.F90:2232-2248)
    fluxin = mu_b * conu_b + mu * torch.minimum(chat, const_a) - \
        (md * cond + md_b * torch.minimum(chat_b, const_b))
    fluxout = mu * conu + mu_b * torch.minimum(chat_b, const) - \
        (md_b * cond_b + md * torch.minimum(chat, const))
    netflux = fluxin - fluxout
    netflux = torch.where(torch.abs(netflux) <
                          torch.maximum(fluxin, fluxout) * 1.0e-12,
                          0.0, netflux)
    dcondt = torch.where(karr >= jt[:, None], netflux / dptmp, 0.0)

    # subcloud (zm_conv.F90:2253-2288): version-3 at k == mx, zero below
    fluxin_s = mu * torch.minimum(chat, const_a) - md * cond
    fluxout_s = mu * conu - md * torch.minimum(chat, const)
    netflux_s = fluxin_s - fluxout_s
    netflux_s = torch.where(torch.abs(netflux_s) <
                            torch.maximum(fluxin_s, fluxout_s) * 1.0e-12,
                            0.0, netflux_s)
    at_mx = karr == mx[:, None]
    below_mx = karr > mx[:, None]
    return torch.where(at_mx, netflux_s / dptmp,
                       torch.where(below_mx, 0.0, dcondt))


def convtran(doconvtran, q, mu, md, du, eu, ed, dp, jt, mx, dt, fracis=None,
             dpdry=None, dry_mask=None):
    """Convective transport of tracers m >= 1 (water vapor excluded, as the
    reference's `do m = 2, ncnst`). `doconvtran`/`dry_mask` are per-tracer
    tuples; q is (ncol, pver, pcnst). Returns dqdt."""
    pcnst = q.shape[2]
    if fracis is None:
        fracis = torch.ones_like(q)
    out = [torch.zeros_like(q[:, :, 0])]
    for m in range(1, pcnst):
        if doconvtran[m]:
            is_dry = bool(dry_mask[m]) if dry_mask is not None else False
            out.append(convtran_single(q[:, :, m], fracis[:, :, m], mu, md,
                                       du, eu, ed, dp, jt, mx, dt,
                                       dpdry=dpdry, is_dry=is_dry))
        else:
            out.append(torch.zeros_like(q[:, :, 0]))
    return torch.stack(out, -1)


def momtran(u, v, mu, md, du, eu, ed, dp, jt, mx, dt,
            momcu: float, momcd: float):
    """Convective momentum transport with pressure-gradient terms and the
    KE-dissipation heating (momtran, zm_conv.F90:2315-2715).

    Returns dict(dudt, dvdt, seten, pguall, pgdall, icwu, icwd); seten is
    the dry-static-energy tendency (J/kg/s)."""
    pver = u.shape[1]
    karr = torch.arange(pver, device=u.device)[None, :]
    kge_jt = karr >= jt[:, None]
    at_mx = karr == mx[:, None]
    below_mx = karr > mx[:, None]
    mu_b = _below(mu, 0.0)
    md_b = _below(md, 0.0)
    dp_a = _above(dp)

    res = []
    for const in (u, v):
        chat = _interface_chat(const, geometric=False)
        const_a = _above(const)
        const_b = _below(const)

        # pressure-perturbation terms (zm_conv.F90:2466-2515)
        mududp = mu * _safe_div(const - const_a, dp_a) + \
            mu_b * _safe_div(const_b - const, dp)
        mddudp = md * _safe_div(const - const_a, dp_a) + \
            md_b * _safe_div(const_b - const, dp)
        pgu = -momcu * 0.5 * mududp
        pgd = -momcd * 0.5 * mddudp
        # bottom boundary: single-sided (zm_conv.F90:2503-2515)
        at_bot = karr == pver - 1
        pgu = torch.where(at_bot, -momcu * (mu * _safe_div(const - const_a,
                                                           dp_a)), pgu)
        pgd = torch.where(at_bot, -momcd * (md * _safe_div(const - const_a,
                                                           dp_a)), pgd)
        pgu = torch.where(karr == 0, 0.0, pgu)
        pgd = torch.where(karr == 0, 0.0, pgd)

        conu = _updraft_profile(const, chat, mu, du, eu, dp, extra=pgu)
        cond = _downdraft_profile(ed * const, chat, md, dp, extra=pgd)

        conu_b = _below(conu)
        cond_b = _below(cond)
        chat_b = _below(chat)

        dcondt = (mu_b * (conu_b - chat_b) - mu * (conu - chat) +
                  md_b * (cond_b - chat_b) - md * (cond - chat)) / dp
        dcondt = torch.where(kge_jt, dcondt, 0.0)
        dcondt_mx = (1.0 / dp) * (-mu * (conu - chat) - md * (cond - chat))
        dcondt = torch.where(at_mx, dcondt_mx,
                             torch.where(below_mx, 0.0, dcondt))

        mfx = -mu * (conu - chat) - md * (cond - chat)
        mfx = torch.where(kge_jt, mfx, 0.0)
        mfx_b = _below(mfx, 0.0)
        windf = const - (mfx_b - mfx) * dt / dp
        res.append(dict(dcondt=dcondt, mfx=mfx, mfx_b=mfx_b, windf=windf,
                        pgu=-pgu, pgd=-pgd, conu=conu, cond=cond))

    # KE dissipation -> heating (zm_conv.F90:2648-2695)
    ru, rv = res
    utop, vtop = 0.5 * (u + _above(u)), 0.5 * (v + _above(v))
    ubot, vbot = 0.5 * (u + _below(u)), 0.5 * (v + _below(v))
    fket = utop * ru["mfx"] + vtop * rv["mfx"]
    fkeb = ubot * ru["mfx_b"] + vbot * rv["mfx_b"]
    ketend_cons = (fket - fkeb) / dp
    uf, vf = ru["windf"], rv["windf"]
    ketend = ((uf ** 2 + vf ** 2) - (u ** 2 + v ** 2)) * 0.5 / dt
    seten = torch.where(kge_jt, ketend_cons - ketend, 0.0)

    return dict(dudt=ru["dcondt"], dvdt=rv["dcondt"], seten=seten,
                pguall=(ru["pgu"], rv["pgu"]), pgdall=(ru["pgd"], rv["pgd"]),
                icwu=(ru["conu"], rv["conu"]), icwd=(ru["cond"], rv["cond"]))
