"""The ZM core of the PyTorch port (zm_convr at microp=False and its
parts), float64 on the CPU.

- Against the JAX package: zm_convr for both parcel/solver pairs is held
  to JAX in tests/test_torch_zm_slice.py, in the same fresh-interpreter
  JAX run as zm_conv_tend (the default pair as zm_conv_tend calls it; the
  reference-shaped pair, parcel_impl="scan" with inversion_solver="brent"
  and second_call off, on this file's `_soundings`).
- Between the port's two parcel forms: batched and scan agree to the
  thermodynamic solvers' convergence tolerance, at the tolerances of
  tests/test_zm_conv.py::TestParcelImplEquivalence.
- Against the NumPy oracles of tests/oracles/zm_conv_oracle.py, at the
  tolerances tests/test_zm_oracle_parity.py uses, on the port's own
  buoyan_dilute/cldprp pipeline: CAPE/CIN/lel, cldprp, closure, q1q2 and
  the scan/brent parcel ascent (which agrees to the Brent solver's 1e-3 K
  tolerance only, as in test_zm_oracle_parity.py).
"""

import numpy as np
import pytest
import torch

from cam_nor_physics_tpu_torch.models.physics import zm_conv as tzm
from cam_nor_physics_tpu_torch.utils import constants as c
from cam_nor_physics_tpu_torch.utils.config import ZMConfig
from oracles import zm_conv_oracle as orc
from test_zm_conv import MSG, make_sounding
from torch_port_util import npy

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

RTOL, ATOL = 1e-12, 1e-14
SOUNDING = ("t", "q", "pmid", "pint", "pdel", "zm", "geos", "zi", "pblh",
            "tpert", "landfrac")


def _soundings():
    """Six unstable columns (two of them over ocean) and two stable ones,
    as float64 numpy."""
    su = make_sounding(ncol=6, unstable=True, seed=7)
    ss = make_sounding(ncol=2, unstable=False, seed=8)
    s = {k: np.concatenate([np.array(su[k]), np.array(ss[k])])
         for k in SOUNDING}
    s["landfrac"][4:6] = 0.0
    return s


# the reference-shaped pair, held to JAX on `_soundings` in
# tests/test_torch_zm_slice.py
SCAN_CFG = dict(parcel_impl="scan", inversion_solver="brent",
                second_call=False)


def test_parcel_impls_agree():
    """The port's batched and scan parcel ascents (newton solver) give the
    same trigger and CAPE within 2e-3 and heating, moistening and
    precipitation within 2e-2, as the JAX package's own test
    (tests/test_zm_conv.py::TestParcelImplEquivalence) holds its two."""
    s = {k: torch.from_numpy(np.array(v))
         for k, v in make_sounding(ncol=8, seed=3, unstable=True).items()}
    a, b = (tzm.zm_convr(ZMConfig(parcel_impl=impl), MSG,
                         *[s[k] for k in SOUNDING], 900.0)
            for impl in ("batched", "scan"))
    assert torch.equal(a.ideep, b.ideep) and bool(a.ideep.any())
    np.testing.assert_allclose(npy(a.cape), npy(b.cape), rtol=2e-3, atol=2.0)
    for f in ("heat", "qtnd"):
        scale = float(getattr(b, f).abs().max()) + 1e-30
        np.testing.assert_allclose(npy(getattr(a, f)) / scale,
                                   npy(getattr(b, f)) / scale, atol=2e-2,
                                   err_msg=f)
    np.testing.assert_allclose(npy(a.prec), npy(b.prec), rtol=2e-2,
                               atol=1e-12)


@pytest.mark.parametrize("option", ["microp", "parcel_pbl"])
def test_unported_options_raise(option):
    """The two options that raised NotImplementedError until they were
    ported now run: finite outputs, the same trigger on these soundings,
    and a different heating than the default configuration's. Their JAX
    parity is held in tests/test_torch_zm_microp.py."""
    s = _soundings()
    args = [torch.from_numpy(s[k]) for k in SOUNDING]
    out = tzm.zm_convr(ZMConfig(**{option: True}), MSG, *args, 900.0)
    ref = tzm.zm_convr(ZMConfig(), MSG, *args, 900.0)
    for f in ("heat", "qtnd", "prec", "cape", "frz", "dcape"):
        assert bool(torch.isfinite(getattr(out, f)).all()), f
    assert torch.equal(out.ideep, ref.ideep) and bool(out.ideep.any())
    assert not torch.equal(out.heat, ref.heat)
    assert (float(out.frz.max()) > 0.0) == (option == "microp")


def test_no_deep_pbl_option():
    """no_deep_pbl with a PBL above every plume top shuts convection off
    (as tests/test_zm_conv.py::TestZMTrigger::test_no_deep_pbl_option)."""
    s = _soundings()
    s["pblh"] = np.full_like(s["pblh"], 20000.0)
    out = tzm.zm_convr(ZMConfig(no_deep_pbl=True), MSG,
                       *[torch.from_numpy(s[k]) for k in SOUNDING], 900.0)
    assert out.ideep[:6].any()
    np.testing.assert_allclose(npy(out.prec), 0.0, atol=1e-20)
    assert float(out.heat.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# NumPy oracles, on the port's own pipeline (test_zm_oracle_parity._pipeline)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipe():
    cfg = ZMConfig()
    s = {k: torch.from_numpy(np.array(v))
         for k, v in make_sounding(ncol=6, pver=26, unstable=True,
                                   seed=7).items()}
    t, q = s["t"], s["q"]
    ncol, pver = t.shape
    karr = torch.arange(pver)
    zs = s["geos"] / c.GRAVIT
    p, pf = s["pmid"] * 0.01, s["pint"] * 0.01
    z, zf = s["zm"] + zs[:, None], s["zi"] + zs[:, None]
    dp = 0.01 * s["pdel"]
    near = (torch.abs(z - zs[:, None] - s["pblh"][:, None]) <
            (zf[:, :-1] - zf[:, 1:]) * 0.5) & (karr >= MSG) & \
        (karr <= pver - 2)
    pblt = torch.where(near.any(1), near.long().argmax(1),
                       pver - 1).double()
    sdse = t + (c.GRAVIT / ((1.0 + c.ZVIR * q) * c.CPAIR)) * z
    b = tzm.buoyan_dilute(cfg, MSG, q, t, p, z, pf, s["zi"], zs, pblt,
                          s["tpert"], s["landfrac"],
                          torch.full_like(t, -cfg.tentrm))
    shat, qhat = tzm._log_mean_interface(sdse), tzm._log_mean_interface(q)
    cld = tzm.cldprp(cfg, MSG, q, t, p, z, sdse, zf, shat, qhat, b.mx,
                     b.lel, s["landfrac"])
    ideep = (b.cape > cfg.capelmt) & (b.cin < b.cape * cfg.cin_threshd)
    dsubcld = torch.where((karr >= b.mx[:, None]) & (karr >= MSG), dp,
                          0.0).sum(1)
    d = dict(b=b, cld=cld, ideep=npy(ideep), p=p, pf=pf, z=z, zf=zf, dp=dp,
             q=q, t=t, s=sdse, shat=shat, qhat=qhat, dsubcld=dsubcld,
             fac_mb=(zf[:, :-1] - zf[:, 1:]) / dp)
    assert d["ideep"].any(), "the sounding must trigger"
    return d, cfg


def test_cape_cin_lel_match_oracle(pipe):
    d, cfg = pipe
    b = d["b"]
    cape, cin, lel = orc.cape_cin_oracle(
        npy(b.buoy), npy(d["pf"]), npy(b.pl) >= cfg.plclmin, npy(b.lcl),
        npy(b.mx), MSG, cfg.num_cin)
    np.testing.assert_allclose(npy(b.cape), cape, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(npy(b.cin), cin, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(npy(b.lel), lel)


def test_cldprp_matches_oracle(pipe):
    d, cfg = pipe
    b, cld = d["b"], d["cld"]
    want = orc.cldprp_oracle(
        *[npy(d[k]) for k in ("q", "t", "p", "z", "s", "zf", "shat",
                              "qhat")], npy(b.mx), npy(b.lel),
        np.ones(b.mx.shape[0]), MSG, cfg.c0_lnd, cfg.c0_ocn, cfg.tiedke_add,
        cfg.tiedke_lnd, cfg.entrmn, cfg.alfadet)
    m = d["ideep"]
    for name in ("jt", "jlcl", "j0", "jd"):
        np.testing.assert_array_equal(npy(getattr(cld, name))[m],
                                      want[name][m], err_msg=name)
    for name in ("mu", "eu", "du", "md", "ed", "mc", "qu", "su", "sd", "qd",
                 "qst", "hmn", "hsat", "ql", "qcde", "cu", "evp", "cmeg",
                 "rprd", "pflx"):
        np.testing.assert_allclose(npy(getattr(cld, name))[m], want[name][m],
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def test_closure_and_q1q2_match_oracles(pipe):
    d, cfg = pipe
    b, cld = d["b"], d["cld"]
    fac = d["fac_mb"]
    du_mb = cld.du * fac
    mb = tzm.closure(cfg, MSG, d["q"], d["t"], d["p"], d["z"], d["s"], b.tp,
                     cld.qst, cld.qu, cld.su, cld.mc, du_mb, cld.mu, cld.md,
                     cld.qd, cld.sd, d["qhat"], d["shat"], d["dp"], b.qstp,
                     d["zf"], cld.ql, d["dsubcld"], b.cape, b.tl, b.lcl,
                     b.lel, cld.jt, b.mx)
    arrs = [npy(x) for x in (d["q"], d["t"], d["p"], d["z"], d["s"], b.tp,
                             cld.qst, cld.qu, cld.su, cld.mc, du_mb, cld.mu,
                             cld.md, cld.qd, cld.sd, d["qhat"], d["shat"],
                             d["dp"], b.qstp, d["zf"], cld.ql, d["dsubcld"],
                             b.cape, b.tl, b.lcl, b.lel, cld.jt, b.mx)]
    mb_o, _, _ = orc.closure_oracle(*arrs, MSG, cfg.capelmt, cfg.tau)
    m = d["ideep"]
    np.testing.assert_allclose(npy(mb)[m], mb_o[m], rtol=RTOL, atol=ATOL)

    evp_mb, cu_mb = cld.evp * fac, cld.cu * fac
    dqdt, dsdt, dl, _ = tzm.q1q2_pjr(
        MSG, d["q"], cld.qst, cld.qu, cld.su, du_mb, d["qhat"], d["shat"],
        d["dp"], cld.mu, cld.md, cld.sd, cld.qd, cld.qcde, d["dsubcld"],
        cld.jt, b.mx, (evp_mb, cu_mb))
    want = orc.q1q2_oracle(*[npy(x) for x in (
        d["q"], cld.qst, cld.qu, cld.su, du_mb, d["qhat"], d["shat"],
        d["dp"], cld.mu, cld.md, cld.sd, cld.qd, cld.qcde, d["dsubcld"],
        cld.jt, b.mx)], MSG, npy(evp_mb), npy(cu_mb))
    for got, w, name in zip((dqdt, dsdt, dl), want, ("dqdt", "dsdt", "dl")):
        np.testing.assert_allclose(npy(got)[m], w[m], rtol=RTOL, atol=1e-16,
                                   err_msg=name)


def test_scan_brent_parcel_matches_oracle(pipe):
    """_parcel_dilute (scan, Brent) vs the oracle, on the region
    buoyan_dilute consumes, at the solver tolerance (atol 3e-3 K on tp,
    as tests/test_zm_oracle_parity.py::TestParcelDiluteParity)."""
    d, _ = pipe
    b = d["b"]
    cfg = ZMConfig(parcel_impl="scan", inversion_solver="brent")
    ncol, pver = d["t"].shape
    kl = b.mx
    dmpdz = torch.full_like(d["t"], -cfg.tentrm)
    tp, qstp, tpv, tl, pl, lcl = tzm._parcel_dilute(
        cfg, kl, d["p"], d["z"], d["t"], d["q"],
        torch.zeros(ncol, dtype=torch.float64), dmpdz)
    want = orc.parcel_dilute_oracle(npy(kl), npy(d["p"]), npy(d["z"]),
                                    npy(d["t"]), npy(d["q"]), np.zeros(ncol),
                                    npy(dmpdz), MSG)
    karr = np.arange(pver)
    in_asc = (karr[None, :] <= npy(kl)[:, None]) & \
        (karr[None, :] >= npy(b.lel)[:, None] - 1)
    np.testing.assert_allclose(npy(tp)[in_asc], want["tp"][in_asc],
                               atol=3e-3, rtol=0)
    np.testing.assert_allclose(npy(tpv)[in_asc], want["tpv"][in_asc],
                               atol=4e-3, rtol=0)
    np.testing.assert_allclose(npy(qstp)[in_asc], want["qstp"][in_asc],
                               atol=2e-6, rtol=0)
    np.testing.assert_array_equal(npy(lcl), want["lcl"])
    np.testing.assert_allclose(npy(tl), want["tl"], atol=3e-3, rtol=0)
    np.testing.assert_allclose(npy(pl), want["pl"], atol=0.5, rtol=0)


def test_eu_only_matches_full(pipe):
    """cldprp(eu_only=True), the slim first call under second_call, is
    bitwise the full call's eu."""
    d, cfg = pipe
    b = d["b"]
    args = (cfg, MSG, d["q"], d["t"], d["p"], d["z"], d["s"], d["zf"],
            d["shat"], d["qhat"], b.mx, b.lel,
            torch.full((b.mx.shape[0],), 0.4, dtype=torch.float64))
    assert torch.equal(tzm.cldprp(*args, eu_only=True), tzm.cldprp(*args).eu)
