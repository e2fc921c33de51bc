"""PyTorch port of ops/tp_core.py against the JAX package and the Fortran
oracle, float64 on the CPU.

Inputs are made with np.random.default_rng; the same arrays go through
cam_nor_physics_tpu.ops.tp_core (eager JAX), cam_nor_physics_tpu_torch's
twin, and for xtp/ytp/tp2d/tp2c the scalar-loop transliteration of the
Fortran in tests/oracles/tp_core_oracle.py. Tolerance 1e-13 relative to
each output's largest magnitude: the formulas are the same operation for
operation, so only the order of the cap sums differs.
"""

import numpy as np
import pytest
import torch

import cam_nor_physics_tpu.ops.tp_core as jtp
import cam_nor_physics_tpu_torch.ops.tp_core as ttp
from oracles import tp_core_oracle as orc
from torch_port_util import assert_close, t64

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

TOL = 1e-13


def _row_grid(jm, im, seed, ffsl_rows=4, cmax_ffsl=2.5, cmax=0.9):
    """(q, c, mfx, cosp, ffsl) slab with FV-like latitude structure: pole
    rows below the upwind/van Leer cosines, FFSL rows with |c| up to
    cmax_ffsl next to each pole."""
    rng = np.random.default_rng(seed)
    dp = np.pi / (jm - 1)
    lat = -0.5 * np.pi + dp * np.arange(jm)
    cosp = np.maximum(np.cos(lat), 1e-10)
    x = 2.0 * np.pi * np.arange(im) / im
    q = (2.0 + np.sin(x)[None, :] * np.cos(lat)[:, None]
         + 0.3 * rng.standard_normal((jm, im)))
    ffsl = np.zeros(jm, bool)
    ffsl[:ffsl_rows] = True
    ffsl[-ffsl_rows:] = True
    c = rng.uniform(-cmax, cmax, (jm, im))
    c[ffsl] = rng.uniform(-cmax_ffsl, cmax_ffsl, (ffsl_rows * 2, im))
    mfx = c * (1.0 + 0.2 * rng.standard_normal((jm, im)))
    return q, c, mfx, cosp, ffsl


@pytest.mark.parametrize("iord,id_", [(1, 0), (4, 0)] + [
    (iord, 1) for iord in (1, 2, 3, 4, 5, 6, 7, -2)])
def test_xtp_matches_jax_and_oracle(iord, id_):
    """Every order and limiter xtp has; density form (id 0) at the two
    orders the dycore transports delp with."""
    q, c, mfx, cosp, ffsl = _row_grid(19, 24, seed=abs(iord) * 10 + id_)
    got = ttp.xtp(t64(q), t64(c), t64(mfx), t64(cosp), t64(ffsl), iord, id_)
    assert_close(got, jtp.xtp(q, c, mfx, cosp, ffsl, iord, id_), TOL, "jax")
    assert_close(got, orc._xtp_slab(q, c, mfx, cosp, ffsl, iord, id_), TOL,
                 "oracle")


def test_xtp_band_and_deep_courant():
    """|c| up to 5.5 (deep integer-Courant sums) with the FFSL branch
    restricted to a polar band, batched over a leading level axis."""
    q, c, mfx, cosp, ffsl = _row_grid(17, 24, seed=5, ffsl_rows=4,
                                      cmax_ffsl=5.5)
    qs, cs, ms = (np.stack([a, a[::-1]]) for a in (q, c, mfx))
    fl = np.stack([ffsl, ffsl])
    got = ttp.xtp(t64(qs), t64(cs), t64(ms), t64(cosp), t64(fl), 4, 1,
                  band=3)
    assert_close(got[0], jtp.xtp(q, c, mfx, cosp, ffsl, 4, 1, band=3), TOL)
    # the batched level is the flipped slab: its FFSL rows are the other
    # pole's, so it must equal the unbatched port on that slab
    assert_close(got[1], ttp.xtp(t64(qs[1]), t64(cs[1]), t64(ms[1]),
                                 t64(cosp), t64(fl[1]), 4, 1, band=3), 0.0)


@pytest.mark.parametrize("jord", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("iv", [0, 1])
def test_ytp_matches_jax_and_oracle(jord, iv):
    rng = np.random.default_rng(jord * 3 + iv)
    jm, im = 17, 24
    q = 2.0 + rng.standard_normal((jm, im))
    c = rng.uniform(-0.9, 0.9, (jm, im))
    yfx = c * (1.0 + 0.2 * rng.standard_normal((jm, im)))
    got = ttp.ytp(t64(q), t64(c), t64(yfx), jord, iv)
    assert_close(got, jtp.ytp(q, c, yfx, jord, iv), TOL, "jax")
    assert_close(got[1:], orc.ytp_oracle(q, c, yfx, jord, iv)[1:], TOL,
                 "oracle")


@pytest.mark.parametrize("iord,jord", [(1, 1), (4, 4), (3, 5), (6, 2)])
def test_tp2d_matches_jax_and_oracle(iord, jord):
    q, crx, xfx, cosp, ffsl = _row_grid(19, 24, seed=iord * 7 + jord)
    rng = np.random.default_rng(99)
    va = rng.uniform(-0.9, 0.9, q.shape)
    cry = rng.uniform(-0.9, 0.9, q.shape)
    yfx = cry * (1.0 + 0.2 * rng.standard_normal(q.shape))
    gfx, gfy = ttp.tp2d(t64(va), t64(q), t64(crx), t64(cry), iord, jord,
                        t64(xfx), t64(yfx), t64(cosp), t64(ffsl), 1)
    jfx, jfy = jtp.tp2d(va, q, crx, cry, iord, jord, xfx, yfx, cosp, ffsl, 1)
    assert_close(gfx, jfx, TOL, "fx jax")
    assert_close(gfy, jfy, TOL, "fy jax")
    wfx, wfy = orc.tp2d_oracle(va, q, crx, cry, iord, jord, xfx, yfx, cosp,
                               ffsl, 1)
    assert_close(gfx[1:-1], wfx[1:-1], TOL, "fx oracle")
    assert_close(gfy[1:], wfy[1:], TOL, "fy oracle")


def test_tp2c_matches_jax_and_oracle():
    q, crx, xfx, cosp, ffsl = _row_grid(19, 24, seed=11)
    rng = np.random.default_rng(5)
    va = rng.uniform(-0.9, 0.9, q.shape)
    cry = rng.uniform(-0.9, 0.9, q.shape)
    yfx = cry * (1.0 + 0.2 * rng.standard_normal(q.shape))
    acosp = 1.0 / cosp
    got = ttp.tp2c(t64(va), t64(q), t64(crx), t64(cry), 4, 4, t64(xfx),
                   t64(yfx), t64(cosp), t64(acosp), 0.01, t64(ffsl))
    want = jtp.tp2c(va, q, crx, cry, 4, 4, xfx, yfx, cosp, acosp, 0.01, ffsl)
    for n, g, w in zip(("dh", "fx", "fy"), got, want):
        assert_close(g, w, TOL, n)
    wdh, _, _ = orc.tp2c_oracle(va, q, crx, cry, 4, 4, xfx, yfx, cosp,
                                acosp, 0.01, ffsl)
    assert_close(got[0], wdh, TOL, "dh oracle")


@pytest.mark.parametrize("id_", [-1, 2, 3])
def test_xmist_and_lmppm_match_jax(id_):
    rng = np.random.default_rng(id_ + 7)
    p = rng.standard_normal((5, 24))
    dm = ttp.xmist(t64(p), id_)
    assert_close(dm, jtp.xmist(p, id_), TOL, "xmist")
    al = 0.5 * (np.roll(p, 1, -1) + p)
    ar = np.roll(al, -1, -1)
    a6 = 3.0 * (2 * p - (al + ar))
    for lmt in (0, 1, 2, 3):
        got = ttp.lmppm(dm, t64(a6), t64(ar), t64(al), t64(p), lmt)
        want = jtp.lmppm(np.asarray(jtp.xmist(p, id_)), a6, ar, al, p, lmt)
        for g, w in zip(got, want):
            assert_close(g, w, TOL, f"lmppm {lmt}")


def test_ffsl_band_and_edge_helpers_match_jax():
    for jm, dl, dt in ((96, 2 * np.pi / 144, 450.0), (46, 2 * np.pi / 72,
                                                      225.0),
                       (24, 2 * np.pi / 36, 1800.0)):
        assert ttp.ffsl_band(jm, dl, dt) == jtp.ffsl_band(jm, dl, dt)
    fy = np.random.default_rng(3).standard_normal((2, 9, 12))
    assert_close(ttp.edge_north(t64(fy)), jtp.edge_north(fy), 0.0)
    assert_close(ttp.wset_row(t64(fy), -1, 7.0),
                 jtp.wset_row(fy, -1, 7.0), 0.0)
