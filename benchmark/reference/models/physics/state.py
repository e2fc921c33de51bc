"""Physics data model: state, tendencies, per-parameterization tendencies.

Twin of `cam_nor_physics_tpu.models.physics.state` (reference
physics_types.F90):
  - `PhysicsState` (physics_state, :62-121), `PhysicsTend` (physics_tend,
    :124-133) and `PhysicsPtend` (physics_ptend, :137-173) as dataclasses
    of tensors; the ptend's activation flags (ls/lu/lv/lq) and level range
    are plain Python values;
  - `ptend_init`, `ptend_sum`, `ptend_scale`, `qmin_vector`,
    `physics_update` (with `refresh=False`), `tend_update`
    (physics_update's tendency accumulator), `refresh_dse`,
    `set_state_pdry`, `set_wet_to_dry`, `set_dry_to_wet`,
    `physics_dme_adjust`, `physics_state_check` and
    `make_state_from_profiles`.

States are treated as immutable: every update returns a new state. Level
k=0 is the model top.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

import torch

from ...ops.geopotential import geopotential_t
from ...utils import constants as c
from .constituents import ConstituentRegistry


@dataclass
class PhysicsState:
    """Column-batched physics state. Shapes: (ncol,) surface fields,
    (ncol, pver) midpoints, (ncol, pver+1) interfaces, (ncol, pver, pcnst)
    tracers."""

    ps: torch.Tensor           # surface pressure (Pa)
    phis: torch.Tensor         # surface geopotential (m2/s2)
    t: torch.Tensor            # temperature (K)
    u: torch.Tensor            # zonal wind (m/s)
    v: torch.Tensor            # meridional wind (m/s)
    s: torch.Tensor            # dry static energy (J/kg)
    omega: torch.Tensor        # vertical pressure velocity (Pa/s)
    pmid: torch.Tensor         # midpoint pressure (Pa)
    pdel: torch.Tensor         # layer thickness (Pa)
    rpdel: torch.Tensor        # 1/pdel
    lnpmid: torch.Tensor       # ln(pmid)
    pint: torch.Tensor         # interface pressure (Pa)
    lnpint: torch.Tensor       # ln(pint)
    q: torch.Tensor            # constituent mixing ratios (kg/kg)
    zi: torch.Tensor           # interface height above surface (m)
    zm: torch.Tensor           # midpoint height above surface (m)
    # dry-pressure companion set (set_state_pdry)
    psdry: torch.Tensor
    pmiddry: torch.Tensor
    pdeldry: torch.Tensor
    rpdeldry: torch.Tensor
    lnpmiddry: torch.Tensor
    pintdry: torch.Tensor
    lnpintdry: torch.Tensor
    # energy/water bookkeeping
    te_ini: torch.Tensor
    te_cur: torch.Tensor
    tw_ini: torch.Tensor
    tw_cur: torch.Tensor
    # grid metadata
    lat: torch.Tensor          # column latitude (radians)
    lon: torch.Tensor          # column longitude (radians)

    @property
    def ncol(self) -> int:
        return self.t.shape[0]

    @property
    def pver(self) -> int:
        return self.t.shape[1]

    @property
    def pcnst(self) -> int:
        return self.q.shape[2]

    @property
    def exner(self):
        """(surface interface pressure / pmid) ** kappa."""
        return (self.pint[:, -1:] / self.pmid) ** c.CAPPA

    def replace(self, **kw) -> "PhysicsState":
        return replace(self, **kw)

    def contiguous(self) -> "PhysicsState":
        """The state with every tensor contiguous (the ZM tail kernel and
        the dycore's kernels take contiguous tensors only)."""
        return replace(self, **{f.name: getattr(self, f.name).contiguous()
                                for f in fields(self)})


STATE_FIELDS = tuple(f.name for f in fields(PhysicsState))


@dataclass
class PhysicsTend:
    """Tendencies accumulated over a physics step (physics_tend)."""

    dtdt: torch.Tensor
    dudt: torch.Tensor
    dvdt: torch.Tensor
    flx_net: torch.Tensor
    te_tnd: torch.Tensor
    tw_tnd: torch.Tensor

    @classmethod
    def zeros(cls, ncol: int, pver: int, dtype=torch.float64,
              device="cpu") -> "PhysicsTend":
        z2 = torch.zeros((ncol, pver), dtype=dtype, device=device)
        z1 = torch.zeros((ncol,), dtype=dtype, device=device)
        return cls(dtdt=z2, dudt=z2, dvdt=z2, flx_net=z1, te_tnd=z1,
                   tw_tnd=z1)

    def replace(self, **kw) -> "PhysicsTend":
        return replace(self, **kw)


TEND_FIELDS = tuple(f.name for f in fields(PhysicsTend))


@dataclass
class PhysicsPtend:
    """Single-parameterization tendencies. ls/lu/lv and per-tracer lq say
    which fields are active; top_level/bot_level bound the update."""

    s: torch.Tensor            # heating rate (J/kg/s)
    u: torch.Tensor
    v: torch.Tensor
    q: torch.Tensor            # (ncol, pver, pcnst)
    hflux_srf: torch.Tensor
    hflux_top: torch.Tensor
    taux_srf: torch.Tensor
    taux_top: torch.Tensor
    tauy_srf: torch.Tensor
    tauy_top: torch.Tensor
    cflx_srf: torch.Tensor     # (ncol, pcnst)
    cflx_top: torch.Tensor
    name: str = "none"
    ls: bool = False
    lu: bool = False
    lv: bool = False
    lq: tuple = field(default=())
    top_level: int = 0
    bot_level: int = -1

    @property
    def any_active(self) -> bool:
        return self.ls or self.lu or self.lv or any(self.lq)

    def replace(self, **kw) -> "PhysicsPtend":
        return replace(self, **kw)


PTEND_FIELDS = ("s", "u", "v", "q", "hflux_srf", "hflux_top", "taux_srf",
                "taux_top", "tauy_srf", "tauy_top", "cflx_srf", "cflx_top")


def ptend_init(name: str, ncol: int, pver: int, pcnst: int,
               ls=False, lu=False, lv=False, lq=None,
               dtype=torch.float64, device="cpu") -> PhysicsPtend:
    """physics_ptend_init (physics_types.F90:1000-1063): zero tendencies."""
    if lq is None:
        lq = (False,) * pcnst
    z2 = torch.zeros((ncol, pver), dtype=dtype, device=device)
    z1 = torch.zeros((ncol,), dtype=dtype, device=device)
    zq = torch.zeros((ncol, pver, pcnst), dtype=dtype, device=device)
    zc = torch.zeros((ncol, pcnst), dtype=dtype, device=device)
    return PhysicsPtend(s=z2, u=z2, v=z2, q=zq,
                        hflux_srf=z1, hflux_top=z1, taux_srf=z1, taux_top=z1,
                        tauy_srf=z1, tauy_top=z1, cflx_srf=zc, cflx_top=zc,
                        name=name, ls=ls, lu=lu, lv=lv, lq=tuple(lq),
                        top_level=0, bot_level=pver - 1)


def ptend_sum(a: PhysicsPtend, b: PhysicsPtend,
              name: str | None = None) -> PhysicsPtend:
    """physics_ptend_sum (physics_types.F90:698-860): a + b."""
    lq = tuple(x or y for x, y in zip(a.lq, b.lq))

    def pick(fa, fb, la, lb):
        return fa + fb if (la and lb) else (fb if lb else fa)

    return PhysicsPtend(
        s=pick(a.s, b.s, a.ls, b.ls), u=pick(a.u, b.u, a.lu, b.lu),
        v=pick(a.v, b.v, a.lv, b.lv), q=a.q + b.q,
        hflux_srf=a.hflux_srf + b.hflux_srf,
        hflux_top=a.hflux_top + b.hflux_top,
        taux_srf=a.taux_srf + b.taux_srf, taux_top=a.taux_top + b.taux_top,
        tauy_srf=a.tauy_srf + b.tauy_srf, tauy_top=a.tauy_top + b.tauy_top,
        cflx_srf=a.cflx_srf + b.cflx_srf, cflx_top=a.cflx_top + b.cflx_top,
        name=name or f"{a.name}+{b.name}",
        ls=a.ls or b.ls, lu=a.lu or b.lu, lv=a.lv or b.lv, lq=lq,
        top_level=min(a.top_level, b.top_level),
        bot_level=max(a.bot_level, b.bot_level))


def ptend_scale(p: PhysicsPtend, fac) -> PhysicsPtend:
    """physics_ptend_scale (physics_types.F90:900-963): every tendency and
    boundary flux times fac."""
    return p.replace(**{f: getattr(p, f) * fac for f in PTEND_FIELDS})


def qmin_vector(registry: ConstituentRegistry, like):
    """The registry's qmin values as a (pcnst,) tensor of `like`'s dtype
    and device, made by fills (no host-to-device copy, so a CUDA graph
    can capture it)."""
    return torch.stack([torch.full((), cn.qmin, dtype=like.dtype,
                                   device=like.device)
                        for cn in registry.constituents])


def _level_mask(pver: int, top: int, bot: int, dtype, device="cpu"):
    """1.0 on levels [top, bot] inclusive."""
    k = torch.arange(pver, device=device)
    return ((k >= top) & (k <= (bot % pver))).to(dtype)


def refresh_dse(state: PhysicsState) -> PhysicsState:
    """Recompute zi/zm and dry static energy from the current t/q
    (the tail of physics_update, physics_types.F90:452-467)."""
    zi, zm = geopotential_t(state.lnpint, state.lnpmid, state.pint,
                            state.pmid, state.pdel, state.rpdel,
                            state.t, state.q[:, :, 0])
    s = state.t * c.CPAIR + c.GRAVIT * zm + state.phis[:, None]
    return state.replace(zi=zi, zm=zm, s=s)


def physics_update(state: PhysicsState, ptend: PhysicsPtend, dt: float,
                   registry: ConstituentRegistry, refresh: bool = True
                   ) -> PhysicsState:
    """Apply a ptend to the state (physics_update, physics_types.F90:
    210-497), in the reference's order: u, v -> q (qneg3 floors, number
    clamps, cldliq/ice min-nz for deep convection) -> t from s -> the
    geopotential and dry-static-energy refresh when heat or vapor changed
    (deferred with refresh=False). Returns the state; the JAX twin's
    PhysicsTend accumulator is `tend_update`."""
    if not ptend.any_active:
        return state

    pver, pcnst = state.pver, state.pcnst
    mask = _level_mask(pver, ptend.top_level, ptend.bot_level,
                       state.t.dtype, state.t.device)[None, :]

    u, v, t, q = state.u, state.v, state.t, state.q
    if ptend.lu:
        u = u + ptend.u * dt * mask
    if ptend.lv:
        v = v + ptend.v * dt * mask

    ixnum = {registry.index(n)
             for n in ("NUMICE", "NUMLIQ", "NUMRAI", "NUMSNO")}
    cols = []      # stacked into a new tensor: the edits below are local
    for m in range(pcnst):
        qm = q[:, :, m]
        if ptend.lq[m]:
            qm = qm + ptend.q[:, :, m] * dt * mask
            if m in ixnum:
                qm = torch.clamp(qm, 1.0e-12, 1.0e10)
            else:
                qm = torch.clamp(qm, min=float(registry.constituents[m].qmin))
                if m == 0:
                    qm = torch.clamp(qm, max=0.1)
        cols.append(qm)
    q = torch.stack(cols, -1)

    # cldliq/cldice minimum-nonzero enforcement for deep-convection updates
    # (state_cnst_min_nz, physics_types.F90:359-381,469-494)
    if ptend.name in ("convect_deep", "zm_conv_tend"):
        for cname, nname in (("CLDLIQ", "NUMLIQ"), ("CLDICE", "NUMICE")):
            ix = registry.index(cname)
            if ix > 0 and ptend.lq[ix]:
                small = q[:, :, ix] < 1.0e-36
                q[:, :, ix] = torch.where(small, 0.0, q[:, :, ix])
                nix = registry.index(nname)
                if nix > 0:
                    q[:, :, nix] = torch.where(small, 0.0, q[:, :, nix])

    if ptend.ls:
        t = t + ptend.s * dt / c.CPAIR * mask

    state = state.replace(u=u, v=v, t=t, q=q)
    if refresh and (ptend.ls or (len(ptend.lq) > 0 and ptend.lq[0])):
        state = refresh_dse(state)
    return state


def tend_update(tend: PhysicsTend, ptend: PhysicsPtend) -> PhysicsTend:
    """The tendency accumulator of the JAX package's physics_update
    (physics_types.F90:210-497): adds the ptend's active u, v and s/cp
    tendencies over its level range to `tend`. The port keeps it apart
    from physics_update, which returns the state alone."""
    if not (ptend.ls or ptend.lu or ptend.lv):
        return tend
    s = ptend.s
    mask = _level_mask(s.shape[1], ptend.top_level, ptend.bot_level,
                       s.dtype, s.device)[None, :]
    if ptend.lu:
        tend = tend.replace(dudt=tend.dudt + ptend.u * mask)
    if ptend.lv:
        tend = tend.replace(dvdt=tend.dvdt + ptend.v * mask)
    if ptend.ls:
        tend = tend.replace(dtdt=tend.dtdt + ptend.s / c.CPAIR * mask)
    return tend


def set_state_pdry(state: PhysicsState) -> PhysicsState:
    """Dry-pressure companion fields (set_state_pdry, physics_types.F90:
    1925-1961): pdeldry = pdel*(1 - qv)."""
    pdeldry = state.pdel * (1.0 - state.q[:, :, 0])
    pintdry_top = state.pint[:, :1]
    pintdry = torch.cat(
        [pintdry_top, pintdry_top + torch.cumsum(pdeldry, -1)], -1)
    psdry = pintdry[:, -1]
    pmiddry = 0.5 * (pintdry[:, 1:] + pintdry[:, :-1])
    return state.replace(
        pdeldry=pdeldry, rpdeldry=1.0 / pdeldry, pintdry=pintdry,
        psdry=psdry, pmiddry=pmiddry, lnpmiddry=torch.log(pmiddry),
        lnpintdry=torch.log(pintdry))


def _scale_by_type(q, fac, registry: ConstituentRegistry, mixtype: str):
    """q with the tracers of `mixtype` times fac (ncol, pver), the others
    as they are."""
    return torch.stack([q[:, :, m] * fac if cn.mixtype == mixtype
                        else q[:, :, m]
                        for m, cn in enumerate(registry.constituents)], -1)


def set_wet_to_dry(state: PhysicsState,
                   registry: ConstituentRegistry) -> PhysicsState:
    """DRY-type constituents from the moist dycore's wet basis to their
    dry basis (set_wet_to_dry, physics_types.F90:1968-1985); wet-type ones,
    water vapour among them, stay wet."""
    return state.replace(q=_scale_by_type(
        state.q, state.pdel / state.pdeldry, registry, "dry"))


def set_dry_to_wet(state: PhysicsState,
                   registry: ConstituentRegistry) -> PhysicsState:
    """Inverse of set_wet_to_dry (physics_types.F90:1988-2005)."""
    return state.replace(q=_scale_by_type(
        state.q, state.pdeldry / state.pdel, registry, "dry"))


def physics_dme_adjust(state: PhysicsState, qini,
                       registry: ConstituentRegistry) -> PhysicsState:
    """Dry-mass/energy adjustment after physics (physics_dme_adjust,
    physics_types.F90:1213-1794). The FV dycore is moist: layer masses
    scale by fdq = 1 + qv - qini, wet constituents are rescaled to keep
    their mass, and the pressure fields are rebuilt. The "tht" form adds
    the uniform column temperature correction that restores
    sum(pdel (cp T + (Lv + Li) qv)). qini: the vapour mixing ratio (wet)
    at the start of physics."""
    qv = state.q[:, :, 0]
    fdq = 1.0 + qv - qini
    pdel_new = state.pdel * fdq
    q_new = torch.stack([state.q[:, :, m] / fdq if cn.mixtype == "wet"
                         else state.q[:, :, m]
                         for m, cn in enumerate(registry.constituents)], -1)

    pint_top = state.pint[:, :1]
    pint_new = torch.cat([pint_top, pint_top + torch.cumsum(pdel_new, -1)],
                         -1)
    ps_new = pint_new[:, -1]
    lnpint_new = torch.log(pint_new)
    pmid_new = pdel_new / (lnpint_new[:, 1:] - lnpint_new[:, :-1])

    e0 = torch.sum(state.pdel * (c.CPAIR * state.t +
                                 (c.LATVAP + c.LATICE) * qv), -1)
    e1 = torch.sum(pdel_new * (c.CPAIR * state.t +
                               (c.LATVAP + c.LATICE) * q_new[:, :, 0]), -1)
    corr = (e0 - e1) / (c.CPAIR * torch.sum(pdel_new, -1))
    t_new = state.t + corr[:, None]

    state = state.replace(
        t=t_new, q=q_new, ps=ps_new, pint=pint_new, lnpint=lnpint_new,
        pdel=pdel_new, rpdel=1.0 / pdel_new, pmid=pmid_new,
        lnpmid=torch.log(pmid_new))
    return refresh_dse(state)


def physics_state_check(state: PhysicsState, name: str = "") -> dict:
    """Finite and range checks (physics_state_check, physics_types.F90:
    501-694) as 0-d bool tensors, with their conjunction under "ok"; a
    caller reads them on the host or feeds a sentinel, nothing aborts."""
    checks = {
        "t_finite": torch.isfinite(state.t).all(),
        "t_range": ((state.t > 0.0) & (state.t < 1000.0)).all(),
        "u_finite": torch.isfinite(state.u).all(),
        "v_finite": torch.isfinite(state.v).all(),
        "q_finite": torch.isfinite(state.q).all(),
        "ps_range": ((state.ps > 1.0) & (state.ps < 2.0e5)).all(),
        "pdel_pos": (state.pdel > 0.0).all(),
    }
    ok = torch.ones((), dtype=torch.bool, device=state.t.device)
    for v in checks.values():
        ok = ok & v
    checks["ok"] = ok
    return checks


def make_state_from_profiles(pint, t, u, v, q, phis, lat=None, lon=None,
                             omega=None) -> PhysicsState:
    """A hydrostatically consistent PhysicsState from interface pressures
    and midpoint profiles (the reference's single-column set-up)."""
    ncol = t.shape[0]
    pdel = pint[:, 1:] - pint[:, :-1]
    pmid = 0.5 * (pint[:, 1:] + pint[:, :-1])
    lnpmid = torch.log(pmid)
    lnpint = torch.log(pint)
    rpdel = 1.0 / pdel
    ps = pint[:, -1]
    if omega is None:
        omega = torch.zeros_like(t)
    zi, zm = geopotential_t(lnpint, lnpmid, pint, pmid, pdel, rpdel,
                            t, q[:, :, 0])
    s = t * c.CPAIR + c.GRAVIT * zm + phis[:, None]
    z1 = torch.zeros((ncol,), dtype=t.dtype, device=t.device)
    state = PhysicsState(
        ps=ps, phis=phis, t=t, u=u, v=v, s=s, omega=omega,
        pmid=pmid, pdel=pdel, rpdel=rpdel, lnpmid=lnpmid,
        pint=pint, lnpint=lnpint, q=q, zi=zi, zm=zm,
        psdry=ps, pmiddry=pmid, pdeldry=pdel, rpdeldry=rpdel,
        lnpmiddry=lnpmid, pintdry=pint, lnpintdry=lnpint,
        te_ini=z1, te_cur=z1, tw_ini=z1, tw_cur=z1,
        lat=lat if lat is not None else z1,
        lon=lon if lon is not None else z1)
    return set_state_pdry(state)
