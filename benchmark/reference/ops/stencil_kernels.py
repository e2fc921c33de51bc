"""The transport stencils' plain versions, under the kernel wrappers'
names: the reference never launches a kernel."""

from __future__ import annotations

from . import tp_core as tp


def transport3d_ref(delp, pt, crx, cry, yfx, va, ffsl, cosp, acosp,
                    rcap: float, iord: int, jord: int,
                    band: int | None = None):
    ddp, mfx, mfy = tp.tp2c(va, delp, crx, cry, iord, jord, crx, yfx, cosp,
                            acosp, rcap, ffsl, band=band)
    fx_pt, fy_pt = tp.tp2d(va, pt, crx, cry, iord, jord, mfx, mfy, cosp,
                           ffsl, 1, band=band)
    return ddp, tp.flux_divergence(fx_pt, fy_pt, acosp, rcap), mfx, mfy


def vort_flux3d_ref(zeta, crx, cry, udt, vedt, ffsl, cosp, iord: int,
                    jord: int, band: int | None = None):
    fy = tp.ytp(zeta, cry, vedt, jord, 0)
    fx = tp.xtp(zeta, crx, udt, cosp, ffsl, iord, 1, band=band)
    return fx, fy


def tracer_div3d_ref(q, crx, cry, mfx, mfy, va, ffsl, cosp, acosp,
                     rcap: float, iord: int, jord: int,
                     band: int | None = None):
    fx, fy = tp.tp2d(va, q, crx, cry, iord, jord, mfx, mfy, cosp, ffsl, 1,
                     band=band)
    return tp.flux_divergence(fx, fy, acosp, rcap)


transport3d = transport3d_ref
vort_flux3d = vort_flux3d_ref
tracer_div3d = tracer_div3d_ref
