"""Lin-Rood flux-form semi-Lagrangian PPM transport operators (tp_core).

PyTorch twin of `cam_nor_physics_tpu.ops.tp_core`: the same whole-slab
formulas, written on tensors of shape (..., jm, im) so a leading level (or
tracer) axis is carried by broadcasting instead of vmap. These functions are
the plain versions behind the stencil kernels (ops/stencil_kernels.py) and
the CPU path of the port.

Array/axis conventions: slabs are (jm, im); j=0 is the SOUTH pole row,
j=jm-1 the north pole row; i wraps periodically. Edge-indexed x-arrays:
fx[..., i] = flux across the WEST edge of cell i. Edge-indexed y-arrays:
fy[..., e, :] = flux across the SOUTH edge of row e (valid e in [1, jm-1]).
Row vectors (cosp, acosp, ...) are (jm,); per-row flags are (..., jm).
"""

from __future__ import annotations

import math

import numpy as np
import torch

COS_UPW = 0.05   # critical cosine for upwind       (tp_core.F90:336)
COS_VAN = 0.10   # critical cosine for van Leer     (:337)
COS_PPM = 0.10   # critical cosine for PPM          (:338)
R3 = 1.0 / 3.0
R23 = 2.0 / 3.0


def _rollx(a, shift: int):
    """Periodic shift along x (last axis): out[..., i] = a[..., i - shift]."""
    return torch.roll(a, shift, -1)


def _rolly(a, shift: int, axis: int = -2):
    """Shift along y (callers overwrite the rows that wrapped)."""
    return torch.roll(a, shift, axis)


def wset_row(a, row: int, value, axis: int = -2):
    """Copy of `a` with index `row` along `axis` set to `value`, which must
    broadcast against the selected row (a scalar, an (im,) vector, or a
    tensor of the row's shape).

    A scalar is written with `fill_`, which takes it as a kernel argument:
    no host-to-device copy, so the step can be captured in a CUDA graph."""
    out = a.clone()
    dst = out.select(axis, row % a.shape[axis])
    if isinstance(value, torch.Tensor):
        dst.copy_(value.expand_as(dst))
    else:
        dst.fill_(value)
    return out


def wset_interior(a, value, axis: int = -2):
    """`a` with indices 1..n-2 along `axis` taken from `value` (same shape)."""
    n = a.shape[axis]
    shape = [1] * a.ndim
    shape[axis] = n
    idx = torch.arange(n, device=a.device).reshape(shape)
    return torch.where((idx >= 1) & (idx <= n - 2), value, a)


def _limit(d, qmax, qmin):
    """sign(d)·min(|d|, qmax, qmin): the monotonic slope limiter."""
    return torch.sign(d) * torch.minimum(torch.minimum(torch.abs(d), qmax),
                                         qmin)


def xmist(q, id_: int):
    """4th-order x-slopes with optional Lin-et-al-1994 monotonic limiter
    (xmist, tp_core.F90:505-556). q is (..., im) periodic."""
    qp1, qm1 = _rollx(q, -1), _rollx(q, 1)
    if id_ <= 2:
        qp2, qm2 = _rollx(q, -2), _rollx(q, 2)
        dm = (1.0 / 24.0) * (8.0 * (qp1 - qm1) + qm2 - qp2)
    else:
        dm = 0.25 * (qp1 - qm1)
    if id_ < 0:
        return dm
    qmax = torch.maximum(torch.maximum(qm1, q), qp1) - q
    qmin = q - torch.minimum(torch.minimum(qm1, q), qp1)
    return _limit(dm, qmax, qmin)


def steepx(p, al, dm):
    """Yeh steepening of the left-edge value (steepx, tp_core.F90:693-759)."""
    dh = _rollx(p, -1) - p
    dhm = _rollx(dh, 1)
    d2 = dh - dhm
    d2p, d2m = _rollx(d2, -1), _rollx(d2, 1)
    pp1, pm1 = _rollx(p, -1), _rollx(p, 1)
    pp2, pm2 = _rollx(p, -2), _rollx(p, 2)
    denom = torch.where(pp1 == pm1, 1.0, pp1 - pm1)
    xxx = 1.0 - 0.5 * (pp2 - pm2) / denom
    eta = torch.where((d2p * d2m < 0.0) & (pp1 != pm1),
                      torch.clamp(xxx, 0.0, 0.5), 0.0)
    etam = _rollx(eta, 1)
    dmm = _rollx(dm, 1)
    bbb = (2.0 * eta - etam) * dmm
    ccc = (2.0 * etam - eta) * dm
    return al + 0.5 * (etam - eta) * dhm + (bbb - ccc) * R3


def lmppm(dm, a6, ar, al, p, lmt: int):
    """PPM monotonicity constraints (lmppm, tp_core.F90:767-877).

    lmt = 0 full, 1 improved full, 2 positive-definite, 3 quasi-monotone.
    Returns (a6, ar, al).
    """
    if lmt == 0:
        da1 = ar - al
        da2 = da1 ** 2
        a6da = a6 * da1
        a6_lo = 3.0 * (al - p)
        ar_lo = al - a6_lo
        a6_hi = 3.0 * (ar - p)
        al_hi = ar - a6_hi
        lo = a6da < -da2
        hi = a6da > da2
        zero = dm == 0.0
        a6n = torch.where(zero, 0.0, torch.where(lo, a6_lo,
                                                 torch.where(hi, a6_hi, a6)))
        arn = torch.where(zero, p, torch.where(lo, ar_lo, ar))
        aln = torch.where(zero, p, torch.where(hi, al_hi, al))
        return a6n, arn, aln
    if lmt in (1, 3):
        da1 = dm + dm if lmt == 1 else 4.0 * dm
        dl = torch.sign(da1) * torch.minimum(torch.abs(da1), torch.abs(al - p))
        dr = torch.sign(da1) * torch.minimum(torch.abs(da1), torch.abs(ar - p))
        return 3.0 * (dl - dr), p + dr, p - dl
    if lmt == 2:
        skip = torch.abs(ar - al) >= -a6
        fmin = p + 0.25 * (ar - al) ** 2 / torch.where(a6 == 0, 1e-30, a6) + \
            a6 * (1.0 / 12.0)
        skip = skip | (fmin >= 0.0)
        both = (p < ar) & (p < al)
        rgt = ar > al
        a6_r = 3.0 * (al - p)
        ar_r = al - a6_r
        a6_l = 3.0 * (ar - p)
        al_l = ar - a6_l
        a6n = torch.where(both, 0.0, torch.where(rgt, a6_r, a6_l))
        arn = torch.where(both, p, torch.where(rgt, ar_r, ar))
        aln = torch.where(both, p, torch.where(rgt, al, al_l))
        return (torch.where(skip, a6, a6n), torch.where(skip, ar, arn),
                torch.where(skip, al, aln))
    return a6, ar, al  # lmt > 3: no constraint (iord=7 is handled by huynh)


def huynh(ar, al, p):
    """Huynh's 2nd monotonicity constraint on a periodic row
    (huynh, tp_core.F90:885-971). Returns (a6, ar, al)."""
    d1 = p - _rollx(p, 1)
    d2 = _rollx(d1, -1) - d1
    d2m = _rollx(d2, 1)
    pmp_r = p + 2.0 * d1
    lac_r = p + 0.5 * (d1 + d2m) + d2m
    pmin = torch.minimum(torch.minimum(p, pmp_r), lac_r)
    pmax = torch.maximum(torch.maximum(p, pmp_r), lac_r)
    ar = torch.minimum(pmax, torch.maximum(ar, pmin))
    d1p = _rollx(d1, -1)
    d2p = _rollx(d2, -1)
    pmp_l = p - 2.0 * d1p
    lac_l = p + 0.5 * (d2p - d1p) + d2p
    pmin = torch.minimum(torch.minimum(p, pmp_l), lac_l)
    pmax = torch.maximum(torch.maximum(p, pmp_l), lac_l)
    al = torch.minimum(pmax, torch.maximum(al, pmin))
    return 3.0 * (p + p - (al + ar)), ar, al


def _ppm_edges(p, dm, iord: int):
    """PPM edge reconstruction al/ar/a6 on a periodic row
    (fxppm head, tp_core.F90:615-636)."""
    al = 0.5 * (_rollx(p, 1) + p) + (_rollx(dm, 1) - dm) * R3
    if iord == 6:
        al = steepx(p, al, dm)
    ar = _rollx(al, -1)
    if iord == 7:
        a6, ar, al = huynh(ar, al, p)
    else:
        a6 = 3.0 * (p + p - (al + ar)) if iord in (3, 5) \
            else torch.zeros_like(p)
        a6, ar, al = lmppm(dm, a6, ar, al, p, iord - 3)
    return al, ar, a6


def ffsl_band(jm: int, dl: float, dt: float, umax: float = 320.0):
    """Rows per pole where |c| = u·dt/(a·cosφ·dl) can reach 1 under the
    umax wind guard; equatorward rows never take the FFSL branch. Returns
    None when the band covers the whole slab."""
    rearth = 6.37122e6
    dp = math.pi / (jm - 1)
    lat = -0.5 * math.pi + dp * np.arange(jm)
    thresh = umax * dt / (rearth * dl)
    need = np.cos(lat) < thresh
    nb = max(int(need[: jm // 2].sum()) + 1, 2)     # +1 safety row
    if 2 * nb >= jm:
        return None
    return nb


def max_cfl_int(im: int) -> int:
    """Largest integer Courant the FFSL branch sums exactly (donor distances
    are clamped into it)."""
    return min(im // 3, 15)


def xtp(q, c, mfx, cosa, ffsl, iord: int, id_: int, band: int | None = None):
    """E-W flux (xtpv, tp_core.F90:285-497), whole-slab.

    q, c, mfx: (..., jm, im); cosa: (jm,); ffsl: (..., jm) bool. Returns fx
    = flux across the west edge of cell i. id_=0: density (mfx = Courant);
    id_=1: mixing ratio (fx multiplied by mass flux mfx). `band` restricts
    the FFSL branch to that many rows at each pole (see ffsl_band).
    """
    jm, im = q.shape[-2:]
    cosa = cosa[:, None]
    ffsl = ffsl[..., None]
    K = max_cfl_int(im)

    # regular (Eulerian) branch, |c| < 1: donor i-1 (c>0) or i (c<=0)
    up = c > 0.0

    def sel_reg(a):
        return torch.where(up, _rollx(a, 1), a)

    fx_upw = mfx * sel_reg(q)
    if iord == 1:
        fx_reg = fx_upw
    else:
        if iord > 0:
            dm4 = xmist(q, 2)                       # tp_core.F90:464-468
        else:
            dm4 = torch.where(cosa < COS_VAN, xmist(q, 2), xmist(q, iord))
        fx_van = mfx * (sel_reg(q) + sel_reg(dm4) * (torch.sign(c) - c))

        al, ar, a6 = _ppm_edges(q, dm4, iord)
        alm, arm, a6m = _rollx(al, 1), _rollx(ar, 1), _rollx(a6, 1)
        fx_ppm_pos = arm + 0.5 * c * (alm - arm + a6m * (1.0 - R23 * c))
        fx_ppm_neg = al - 0.5 * c * (ar - al + a6 * (1.0 + R23 * c))
        fx_ppm = mfx * torch.where(c > 0.0, fx_ppm_pos, fx_ppm_neg)

        upwind_row = cosa < COS_UPW
        vanleer_row = (cosa < COS_VAN) | (abs(iord) == 2)
        fx_reg = torch.where(upwind_row, fx_upw,
                             torch.where(vanleer_row, fx_van, fx_ppm))

    # FFSL branch (|c| may exceed 1; periodic wrap), on the polar band only
    if band is not None and 2 * band < jm:
        if band == 0:
            return fx_reg
        rows = torch.arange(jm, device=q.device)[:, None]
        ffsl = ffsl & ((rows < band) | (rows >= jm - band))

        def bandsel(a):
            return torch.cat([a[..., :band, :], a[..., jm - band:, :]], -2)

        fxb = _xtp_ffsl(bandsel(q), bandsel(c), bandsel(mfx), bandsel(cosa),
                        iord, id_, K)
        mid = fxb.new_zeros(fxb.shape[:-2] + (jm - 2 * band, im))
        fx_ffsl = torch.cat([fxb[..., :band, :], mid, fxb[..., band:, :]], -2)
    else:
        fx_ffsl = _xtp_ffsl(q, c, mfx, cosa, iord, id_, K)
    return torch.where(ffsl, fx_ffsl, fx_reg)


def _gatherx(arrs, d):
    """out[t][..., i] = arrs[t][..., (i + d[..., i]) mod im]."""
    im = d.shape[-1]
    idx = torch.remainder(torch.arange(im, device=d.device) + d, im).long()
    shape = torch.broadcast_shapes(idx.shape, *(a.shape for a in arrs))
    idx = idx.expand(shape)
    return [torch.gather(a.expand(shape), -1, idx) for a in arrs]


def _int_courant_sums(q, iu, K: int):
    """Whole-cell FFSL sums (tp_core.F90:430-440) as running-sum chains:
    pos[i] = sum_{n=1}^{iu} q[i-n] (c >= 1); neg[i] = sum_{n=0}^{-iu-1}
    q[i+n] (c <= -1), selected at the integer Courant iu in [-K, K]."""
    run_p = torch.zeros_like(q)
    acc_p = torch.zeros_like(q)
    run_n = torch.zeros_like(q)
    acc_n = torch.zeros_like(q)
    for s in range(1, K + 1):
        run_p = run_p + _rollx(q, s)
        acc_p = torch.where(iu == s, run_p, acc_p)
        run_n = run_n + _rollx(q, -(s - 1))
        acc_n = torch.where(iu == -s, run_n, acc_n)
    return acc_p, acc_n


def _xtp_ffsl(q, c, mfx, cosa, iord: int, id_: int, K: int):
    """FFSL E-W flux (the |c| >= 1 machinery of xtp) on a row sub-slab."""
    iu = torch.clamp(torch.trunc(c).to(torch.int32), -K, K)
    rut = c - iu.to(c.dtype)
    # fractional-donor offset relative to i: cell i-iu-1 (c>0) or i-iu
    d = torch.where(c > 0.0, -iu - 1, -iu)

    if iord == 1:
        (qg,) = _gatherx([q], d)
        f_frac = rut * qg
    else:
        # 2nd-order slope for the FFSL branch (tp_core.F90:392-398)
        qp1, qm1 = _rollx(q, -1), _rollx(q, 1)
        tmp = 0.25 * (qp1 - qm1)
        qmax = torch.maximum(torch.maximum(qm1, q), qp1) - q
        qmin = q - torch.minimum(torch.minimum(qm1, q), qp1)
        dm2 = _limit(tmp, qmax, qmin)
        alf, arf, a6f = _ppm_edges(q, dm2, iord)
        qg, dmg, alg, arg, a6g = _gatherx([q, dm2, alf, arf, a6f], d)
        f_upw = rut * qg
        f_van = torch.where(c > 0.0,
                            rut * (qg + dmg * (1.0 - rut)),
                            rut * (qg - dmg * (1.0 + rut)))
        f_ppm = torch.where(
            c > 0.0,
            rut * (arg + 0.5 * rut * (alg - arg + a6g * (1.0 - R23 * rut))),
            rut * (alg - 0.5 * rut * (arg - alg + a6g * (1.0 + R23 * rut))))
        ffsl_upw = cosa < COS_UPW
        ffsl_ppm = (cosa > COS_PPM) & (iord >= 3)
        f_frac = torch.where(ffsl_upw, f_upw,
                             torch.where(ffsl_ppm, f_ppm, f_van))

    sum_pos, sum_neg = _int_courant_sums(q, iu, K)
    f_int = torch.where(c >= 1.0, sum_pos,
                        torch.where(c <= -1.0, -sum_neg, 0.0))
    fx_ffsl = f_frac + f_int
    if id_ != 0:
        # the FFSL sum is in Courant units; the mass flux is divided by
        # the Courant number for these rows (upstream xfx = mfx/cx)
        c_safe = torch.sign(c) * torch.clamp(torch.abs(c), min=1e-30)
        fx_ffsl = fx_ffsl * (mfx / c_safe)
    return fx_ffsl


def ymist(q, jord: int, iv: int):
    """N-S slopes with pole mirroring (ymist, tp_core.F90:1084-1214).
    q: (..., jm, im). iv=0 scalar, iv=1 vector (sign flip across the pole)."""
    jm, im = q.shape[-2:]
    im2 = im // 2
    dm_int = wset_interior(torch.zeros_like(q),
                           0.25 * (_rolly(q, -1) - _rolly(q, 1)))

    q0, q1 = q[..., 0, :], q[..., 1, :]
    q_n1, q_n2 = q[..., jm - 1, :], q[..., jm - 2, :]
    qs_mir = _rollx(q1, -im2)                  # q(i+im2, row 1)
    qn_mir = _rollx(q_n2, -im2)                # q(i+im2, row jm-2)
    if iv == 0:
        tmp_s = 0.25 * (q1 - qs_mir)
        qmax_s = torch.maximum(torch.maximum(q1, q0), qs_mir) - q0
        qmin_s = q0 - torch.minimum(torch.minimum(q1, q0), qs_mir)
        tmp_n = 0.25 * (qn_mir - q_n2)
        qmax_n = torch.maximum(torch.maximum(qn_mir, q_n1), q_n2) - q_n1
        qmin_n = q_n1 - torch.minimum(torch.minimum(qn_mir, q_n1), q_n2)
        mirror_sign = -1.0
    else:
        tmp_s = 0.25 * (q1 + qs_mir)
        qmax_s = torch.maximum(torch.maximum(q1, q0), -qs_mir) - q0
        qmin_s = q0 - torch.minimum(torch.minimum(q1, q0), -qs_mir)
        tmp_n = -0.25 * (qn_mir + q_n2)
        qmax_n = torch.maximum(torch.maximum(-qn_mir, q_n1), q_n2) - q_n1
        qmin_n = q_n1 - torch.minimum(torch.minimum(-qn_mir, q_n1), q_n2)
        mirror_sign = 1.0
    dm_s = _limit(tmp_s, qmax_s, qmin_s)
    dm_n = _limit(tmp_n, qmax_n, qmin_n)
    # second half of each pole row mirrors the first (tp_core.F90:1149-1151)
    half = torch.arange(im, device=q.device) >= im2
    dm_s = torch.where(half, mirror_sign * _rollx(dm_s, im2), dm_s)
    dm_n = torch.where(half, mirror_sign * _rollx(dm_n, im2), dm_n)
    dm = wset_row(wset_row(dm_int, 0, dm_s), -1, dm_n)

    if jord > 0:
        # monotonic constraint on interior rows (tp_core.F90:1200-1211)
        qm, qp = _rolly(q, 1), _rolly(q, -1)
        qmax = torch.maximum(torch.maximum(qm, q), qp) - q
        qmin = q - torch.minimum(torch.minimum(qm, q), qp)
        dm = wset_interior(dm, _limit(dm, qmin, qmax))
    return dm


def fyppm(c, q, dm, jord: int, iv: int):
    """N-S PPM flux (fyppm, tp_core.F90:1222-1388); south-edge convention,
    row 0 zeroed."""
    jm, im = q.shape[-2:]
    im2 = im // 2
    al_full = 0.5 * (_rolly(q, 1) + q) + R3 * (_rolly(dm, 1) - dm)
    sgn = 1.0 if iv == 0 else -1.0
    al = wset_row(al_full, 0, sgn * _rollx(al_full[..., 1, :], -im2))
    ar = _rolly(al, -1)
    ar = wset_row(ar, -1, sgn * _rollx(al[..., jm - 1, :], -im2))
    if jord in (3, 5):
        a6 = 3.0 * (q + q - (al + ar))
    else:
        a6 = torch.zeros_like(q)
    a6, ar, al = lmppm(dm, a6, ar, al, q, jord - 3)
    flux_pos = _rolly(ar, 1) + 0.5 * c * (_rolly(al, 1) - _rolly(ar, 1) +
                                          _rolly(a6, 1) * (1.0 - R23 * c))
    flux_neg = al - 0.5 * c * (ar - al + a6 * (1.0 + R23 * c))
    fe = torch.where(c > 0.0, flux_pos, flux_neg)
    return wset_row(fe, 0, 0.0)


def ytp(q, c, ymass, jord: int, iv: int):
    """N-S flux (ytp, tp_core.F90:980-1076); south-edge convention, row 0
    zeroed."""
    up = c > 0.0
    q_dn = _rolly(q, 1)
    if jord == 1:
        fe = torch.where(up, q_dn, q)
    else:
        dm = ymist(q, jord, iv)
        if abs(jord) >= 3:
            return fyppm(c, q, dm, jord, iv) * ymass
        fe = torch.where(up, q_dn, q) + \
            (torch.sign(c) - c) * torch.where(up, _rolly(dm, 1), dm)
    return wset_row(fe * ymass, 0, 0.0)


def edge_north(fy):
    """South-edge array -> north-edge array: out[j] = fy[j+1], with the
    polar north edge (no flux) zeroed."""
    return wset_row(_rolly(fy, -1), -1, 0.0)


def ycc(q, vc, ymass, jord: int, iv: int):
    """C-grid N-S flux (ycc, tp_core.F90:1544-1704) in the NORTH-edge
    convention: fy[j] is the flux between rows j and j+1, donor row j
    (vc > 0) or j+1; vc and ymass share the convention. Every jord != 1
    takes the van Leer mismatch (ycc has no PPM branch), the pole rows'
    from cross-pole mirrors (iv=0 scalar, iv=1 vector), zeroed again for
    jord > 0. Rows 1..jm-2 are set, the others 0."""
    jm, im = q.shape[-2:]
    im2 = im // 2
    rows = torch.arange(jm, device=q.device)[:, None]
    interior = (rows >= 1) & (rows <= jm - 2)
    up = vc > 0.0
    q_up = wset_row(_rolly(q, -1), -1, q[..., -1, :])      # row j+1
    if jord == 1:
        return torch.where(interior, torch.where(up, q, q_up) * ymass, 0.0)

    inner = (rows >= 2) & (rows <= jm - 2)
    dc = torch.where(inner, 0.25 * (_rolly(q, -1) - _rolly(q, 1)), 0.0)
    mir1 = _rollx(q[..., 1, :], -im2)
    mir_n = _rollx(q[..., jm - 1, :], -im2)
    if iv == 0:                                            # (:1624)
        dc_s = 0.25 * (q[..., 2, :] - mir1)
        dc_n = 0.25 * (mir_n - q[..., jm - 2, :])
    else:                                                  # (:1649)
        dc_s = 0.25 * (q[..., 2, :] + mir1)
        dc_n = -0.25 * (q[..., jm - 2, :] + mir_n)
    dc = wset_row(wset_row(dc, 1, dc_s), jm - 1, dc_n)
    if jord > 0:                                           # (:1671-1692)
        qm, qp = _rolly(q, 1), _rolly(q, -1)
        qmax = torch.maximum(torch.maximum(qm, q), qp) - q
        qmin = q - torch.minimum(torch.minimum(qm, q), qp)
        lim = torch.sign(dc) * torch.minimum(
            torch.minimum(torch.abs(dc), qmin), qmax)
        dc = torch.where(inner, lim, dc)
        dc = wset_row(wset_row(dc, 1, 0.0), jm - 1, 0.0)
    dc_up = wset_row(_rolly(dc, -1), -1, dc[..., -1, :])   # dc[j+1]
    slope = torch.sign(vc) - vc
    fe = torch.where(up, q + slope * dc, q_up + slope * dc_up)
    return torch.where(interior, fe * ymass, 0.0)


def tpcc(va, q, crx, cry, ymass, iord: int, jord: int, cose, ffsl,
         band: int | None = None):
    """C-grid 2-D transport fluxes (tpcc, tp_core.F90:1396-1536), tp2d's
    C-grid counterpart: the first-order advective x-op, ycc for fy, then
    the advective y-op with the scalar cross-pole mirror in the south row
    and the va-upwinded north-pole row, and xtp at `iord` for fx. cry and
    ymass in ycc's north-edge convention; cose (jm,) the critical cosine
    at the xtp rows. Returns (fx, fy): fx rows 1..jm-1 and fy rows
    1..jm-2 are meaningful, row 0 is 0."""
    jm, im = q.shape[-2:]
    im2 = im // 2
    rows = torch.arange(jm, device=q.device)[:, None]

    # first-order advective x-op (:1469-1485)
    wk1 = xtp(q, crx, crx, cose, ffsl, 1, 0, band=band)
    adx = q + 0.5 * (wk1 - _rollx(wk1, -1) + q * (_rollx(crx, -1) - crx))
    adx = wset_row(adx, 0, q[..., 0, :])
    fy = ycc(adx, cry, ymass, jord, 0)

    # the scalar south-pole mirror (:1490-1498)
    q2 = wset_row(q, 0, _rollx(q[..., 1, :], -im2))
    # the north-pole advective row from va (:1500-1515)
    qn, qn1 = q2[..., jm - 1, :], q2[..., jm - 2, :]
    va_n = va[..., jm - 1, :]
    fx1 = _rollx(qn, -im2)
    ad_n = torch.where(va_n > 0.0, qn + 0.5 * va_n * (qn1 - qn),
                       qn + 0.5 * va_n * (qn - fx1))
    # interior advective y-op (:1517-1525): donor j-1 (va > 0) else j+1
    q_m = wset_row(_rolly(q2, 1), 0, q2[..., 0, :])
    q_p = wset_row(_rolly(q2, -1), -1, qn)
    ady = q2 + 0.5 * va * torch.where(va > 0.0, q_m - q2, q2 - q_p)
    ady = wset_row(wset_row(ady, jm - 1, ad_n), 0, q2[..., 0, :])

    fx = xtp(ady, crx, crx, cose, ffsl, iord, 0, band=band)
    return torch.where(rows >= 1, fx, 0.0), fy


def tp2d(va, q, crx, cry, iord: int, jord: int, xfx, yfx, cosp, ffsl,
         id_: int, band: int | None = None):
    """2-D transport on the D grid (tp2d, tp_core.F90:163-276). Returns
    (fx, fy), fy in the south-edge convention."""
    # inner advective x-operator (first-order) -> adx (tp_core.F90:228-243)
    wk1 = xtp(q, crx, crx, cosp, ffsl, 1, 0, band=band)
    adx = q + 0.5 * (wk1 - _rollx(wk1, -1) + q * (_rollx(crx, -1) - crx))
    adx = wset_row(wset_row(adx, 0, q[..., 0, :]), -1, q[..., -1, :])
    fy = ytp(adx, cry, yfx, jord, 0)
    # inner advective y-operator (tp_core.F90:260-265): donor row j-1
    # (va>0) else j+1, given the y CFL limit |va| <= 1
    q_m = wset_row(_rolly(q, 1), 0, q[..., 0, :])
    q_p = wset_row(_rolly(q, -1), -1, q[..., -1, :])
    ady = q + 0.5 * va * torch.where(va > 0.0, q_m - q, q - q_p)
    ady = wset_row(wset_row(ady, 0, q[..., 0, :]), -1, q[..., -1, :])
    fx = xtp(ady, crx, xfx, cosp, ffsl, iord, id_, band=band)
    return fx, fy


def flux_divergence(fx, fy, acosp, rcap: float):
    """fx[i]-fx[i+1] + (fy[j]-fy[j+1])·acosp with the pole rows replaced by
    the cap mean of the meridional flux (tp_core.F90:130-152). The cap sums
    accumulate in float64 and round once, so for float32 fields they do not
    depend on the summation order (the CUDA kernels sum the same way)."""
    jm = fy.shape[-2]
    dh = fx - _rollx(fx, -1) + (fy - edge_north(fy)) * acosp[:, None]
    s_sum = -torch.sum(fy[..., 1, :].double(), dim=-1, keepdim=True) * rcap
    n_sum = torch.sum(fy[..., jm - 1, :].double(), dim=-1,
                      keepdim=True) * rcap
    return wset_row(wset_row(dh, 0, s_sum), -1, n_sum)


def tp2c(va, h, crx, cry, iord: int, jord: int, xfx, yfx, cosp, acosp,
         rcap: float, ffsl, band: int | None = None):
    """C-grid transport + flux divergence with polar-cap closure
    (tp2c, tp_core.F90:72-155). Returns (dh, fx, fy)."""
    fx, fy = tp2d(va, h, crx, cry, iord, jord, xfx, yfx, cosp, ffsl, 0,
                  band=band)
    return flux_divergence(fx, fy, acosp, rcap), fx, fy
