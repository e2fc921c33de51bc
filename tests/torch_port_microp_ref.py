"""The JAX package's ZM microphysics, modal aerosol and single-column
model as the reference of tests/test_torch_zm_microp.py,
tests/test_torch_aerosol.py and tests/test_torch_modes.py.

    python tests/torch_port_microp_ref.py DIR [DIR ...]

Runs in a fresh interpreter (ROADMAP R1: JAX's microp programs stay out
of the xdist workers), with the test suite's JAX settings
(tests/conftest.py: CPU, float64). Each DIR/in.pkl holds {"mode": "zm",
"zm_tend", "aero", "scam", "scam_run" or "scam_iop", "cases": {...}} of
numpy inputs made by a test; the
script writes DIR/out.pkl, {case: {key: numpy array}}. The first of the
three tests to run starts all three references at once, each in an
interpreter of its own (torch_port_util.shared_jax_reference).

Every JAX function runs under jax.disable_jit(): op by op, each lax.scan
a Python loop over its levels. The JAX package's own tests run zm_convr
eagerly too (tests/test_zm_microphysics.py); jitted, the microp zm_convr
compiles for minutes on the CPU, op by op its primitives compile in
seconds, and the arithmetic is the package's own.
"""

import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402,F401  (CPU, float64)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cam_nor_physics_tpu.models.physics import zm_conv as jzm  # noqa: E402
from cam_nor_physics_tpu.utils.config import PhysConfig, ZMConfig  # noqa: E402
from cam_nor_physics_tpu_torch import convert  # noqa: E402

SOUNDING = ("t", "q", "pmid", "pint", "pdel", "zm", "geos", "zi", "pblh",
            "tpert", "landfrac")


def _j(d):
    """numpy leaves of a dict (nested one level) as jnp arrays; tuples
    and scalars as they are."""
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in d.items()}


def flat_convr(out):
    res = {f: np.asarray(getattr(out, f)) for f in out.__dataclass_fields__
           if f != "mrates"}
    res.update({f"mr.{k}": np.asarray(v) for k, v in out.mrates.items()})
    return res


def flat_fields(out, names):
    return {f: np.asarray(getattr(out, f)) for f in names}


def flat_physrun(out):
    res = {f"state.{f}": a
           for f, a in convert.physstate_to_numpy(out.state).items()}
    res.update({f"pbuf.{k}": a
                for k, a in convert.pbuf_to_numpy(out.pbuf)[0].items()})
    res.update({f"tend.{f}": np.asarray(getattr(out.tend, f))
                for f in out.tend.__dataclass_fields__})
    res.update({f"cam_out.{f}": a
                for f, a in convert.camout_to_numpy(out.cam_out).items()})
    res.update({f"diag.{k}": np.asarray(v)
                for k, v in out.diagnostics.items()})
    return res


def _aero(a):
    return None if a is None else dict(num=jnp.asarray(a["num"]),
                                       dgnum=jnp.asarray(a["dgnum"]),
                                       hygro=tuple(a["hygro"]))


def _registry(names):
    from cam_nor_physics_tpu.models.physics.constituents import (
        Constituent, default_registry)
    reg = default_registry()
    for n in names[reg.pcnst:]:
        reg = reg.add(Constituent(name=n, longname=n, qmin=0.0,
                                  mixtype="wet"))
    assert reg.names == tuple(names)
    return reg


def _pbuf(pb):
    from cam_nor_physics_tpu.models.physics.physics_buffer import \
        PhysicsBuffer
    fields, lifetimes = pb
    return PhysicsBuffer(fields=_j(fields), lifetimes=lifetimes)


def _state(fields):
    from cam_nor_physics_tpu.models.physics.state import PhysicsState
    return PhysicsState(**_j(fields))


def _tick(label, t0=[time.perf_counter()]):
    now = time.perf_counter()
    print(f"{label}: {now - t0[0]:.1f} s", file=sys.stderr, flush=True)
    t0[0] = now


def run_zm(cases):
    """zm_convr, buoyan_dilute, zm_mphy, zm_conv_evap and
    activated_number; run_zm_tend gives the "tend" cases."""
    out = {}
    c = cases["convr"]
    out["convr"] = flat_convr(jzm.zm_convr(
        ZMConfig(microp=True), c["msg"], *[jnp.asarray(c[k])
                                           for k in SOUNDING], 900.0))
    _tick("zm_convr")
    b = cases["pbl"]
    for tag, kw in b["cfgs"].items():
        res = jzm.buoyan_dilute(
            ZMConfig(**kw), b["msg"],
            *[jnp.asarray(b[k]) for k in ("q", "t", "p", "z", "pf", "zi",
                                          "zs", "pblt", "tpert",
                                          "landfrac", "dmpdz")])
        out[f"pbl.{tag}"] = flat_fields(res, res.__dataclass_fields__)
        _tick(f"pbl {tag}")
    m = cases["mphy"]
    for tag, aero in (("clean", None), ("aero", m["aero"])):
        res = jzm.zm_mphy(ZMConfig(microp=True),
                          *[jnp.asarray(m[k]) for k in m["order"]],
                          aero=_aero(aero))
        flat = flat_fields(res, [f for f in res.__dataclass_fields__
                                 if f != "rates"])
        flat.update({f"mr.{k}": np.asarray(v) for k, v in res.rates.items()})
        out[f"mphy.{tag}"] = flat
    _tick("mphy")
    e = cases["evap"]
    out["evap"] = {k: np.asarray(v) for k, v in jzm.zm_conv_evap(
        ZMConfig(), *[jnp.asarray(e[k]) for k in e["order"]],
        e["deltat"], jnp.asarray(e["prec_in"]),
        prdsnow=jnp.asarray(e["prdsnow"])).items()}
    from cam_nor_physics_tpu.models.physics.zm_microphysics import \
        activated_number
    out["act"] = {"nact": np.asarray(activated_number(
        _aero(cases["act"])))}
    return out


def run_zm_tend(cases):
    from cam_nor_physics_tpu.models.physics.constituents import \
        default_registry
    from cam_nor_physics_tpu.models.physics.zm_conv_intr import zm_conv_tend
    out = {}
    t = cases["tend"]
    for tag, aero in (("clean", None), ("aero", t["aero"])):
        res = zm_conv_tend(ZMConfig(microp=True), default_registry(),
                           _state(t["state"]), _pbuf(t["pbuf"]),
                           *[jnp.asarray(t[k]) for k in ("pblh", "tpert",
                                                         "landfrac")],
                           t["dt"], aero=_aero(aero))
        out[f"tend.{tag}"] = convert.zmtend_to_numpy(res)
        _tick(f"tend {tag}")
    return out


def run_aero(cases):
    from cam_nor_physics_tpu.models.coupling.camsrfexch import CamIn
    from cam_nor_physics_tpu.models.physics import modal_aer_opt as mao
    from cam_nor_physics_tpu.models.physics import \
        modal_aero_wateruptake as mwu
    from cam_nor_physics_tpu.models.physics.physpkg import phys_run1
    out = {}
    m = cases["mode"]
    mode = mao.AeroMode(table=mao.make_synthetic_table(), **m)
    s = cases["size"]
    spec = [jnp.asarray(a) for a in s["specmmr"]]
    for tag, num in (("default", None), ("num", s["num"])):
        dg, naer, dryvol = mwu.modal_aero_calcsize(
            spec, mode.species_density, mode.sigma_logr, mode.dgnum,
            mode.dgnumlo, mode.dgnumhi,
            None if num is None else jnp.asarray(num))
        wu = mwu.modal_aero_wateruptake(
            spec, mode.species_density, s["hygro"], mode.sigma_logr, dg,
            naer, jnp.asarray(s["rh"]), mode.rhcrystal, mode.rhdeliques)
        out[f"size.{tag}"] = dict(
            dgnum=np.asarray(dg), naer=np.asarray(naer),
            dryvol=np.asarray(dryvol),
            **{k: np.asarray(v) for k, v in wu.items()})
    o = cases["optics"]
    spec = [jnp.asarray(a) for a in o["specmmr"]]
    sw_tot, lw, diags = mao.modal_aero_optics_all(
        (mode,), (spec,), jnp.asarray(o["dgnumwet"]),
        jnp.asarray(o["qaerwat"]), jnp.asarray(o["mass"]))
    out["optics"] = {**{f"sw.{k}": np.asarray(v) for k, v in sw_tot.items()},
                     "lw": np.asarray(lw),
                     **{k: np.asarray(v) for k, v in diags.items()}}
    p = cases["phys"]
    reg = _registry(p["names"])
    pcfg = PhysConfig(aero_modes=(mode,), radiation_scheme="gray")
    st, pb = _state(p["state"]), _pbuf(p["pbuf"])
    cam_in = CamIn(**_j(p["cam_in"]))
    for step, nstep in ((1, 0), (2, 1)):
        res = phys_run1(pcfg, ZMConfig(microp=True), reg, st, pb, cam_in,
                        p["dt"], nstep=nstep)
        out[f"phys.{step}"] = flat_physrun(res)
        st, pb = res.state, res.pbuf
    return out


def main(*roots):
    from torch_port_modes_ref import run_scam
    # op by op every primitive compiles in milliseconds; the persistent
    # cache's lookup for each serialises reference processes that run at
    # once (measured: three of them took 129 s with it, 72 s without)
    jax.config.update("jax_enable_compilation_cache", False)
    for root in roots:
        with open(os.path.join(root, "in.pkl"), "rb") as f:
            inp = pickle.load(f)
        with jax.disable_jit():
            out = {"zm": run_zm, "zm_tend": run_zm_tend, "aero": run_aero,
                   "scam": run_scam,
                   "scam_run": lambda c: run_scam(c, ("run",)),
                   "scam_iop": lambda c: run_scam(c, ("iop", "step"))
                   }[inp["mode"]](inp["cases"])
        with open(os.path.join(root, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
        _tick(f"{inp['mode']} done")


if __name__ == "__main__":
    main(*sys.argv[1:])
