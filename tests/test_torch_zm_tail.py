"""The tail of ZM deep convection in the PyTorch port: zm_conv_evap,
momtran, convtran and zm_tail_ref (the plain version of the fused ZM tail
CUDA kernel), float64 on the CPU.

They are held to the JAX package's XLA path (the plain reference of its
Pallas tail) at 1e-12 relative to each output's largest magnitude, on the
inputs of tests/test_zm_tail_pallas.py::_inputs and on quiescent columns,
and to the NumPy oracles of tests/oracles/zm_conv_oracle.py at the
tolerances tests/test_zm_oracle_parity.py uses. The kernel's CUDA source,
built as host C++ (torch_port_util.host_build: a block's threads as
std::threads meeting at a barrier), is held to zm_tail_ref on the CPU,
also with one, three and five tracers and with quiescent columns; the
kernel itself is held to zm_tail_ref on the card (marked `cuda`, skipped
without one; chip_smoke.py does the same at f19, and in float32 at f09's
and f05's columns).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cam_nor_physics_tpu.models.physics import zm_conv as jzm
from cam_nor_physics_tpu.models.physics import zm_transport as jzt
from cam_nor_physics_tpu.utils.config import ZMConfig as JZMConfig
from cam_nor_physics_tpu_torch.models.physics import zm_conv as tzm
from cam_nor_physics_tpu_torch.models.physics import zm_transport as tzt
from cam_nor_physics_tpu_torch.ops import zm_tail_kernels as ztk
from cam_nor_physics_tpu_torch.utils.config import ZMConfig
from oracles import zm_conv_oracle as orc
from test_zm_tail_pallas import _inputs
from torch_port_util import assert_close, host_build, npy

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

TOL = 1e-12
DT = 1800.0
EVAP_KEYS = tzm.EVAP_KEYS


def _assert_evap_close(got, want, tol):
    """Each evaporation output within tol of its max; the surface rates
    prec and snow (the flux's bottom row / 1000) within tol of their
    column flux's max / 1000: a surface snow rate of zero can come out as
    a 1e-135 residual in one package and 0 in the other."""
    for k in EVAP_KEYS:
        scale = None
        if k in ("prec", "snow"):
            flx = npy(want["flxprec" if k == "prec" else "flxsnow"])
            scale = max(float(np.abs(flx).max()) / 1000.0, 1e-300)
        assert_close(got[k], want[k], tol, k, scale=scale)
MT_PAIRS = ("pguall", "pgdall", "icwu", "icwd")


def _case(quiet=False, ncol=48, seed=0):
    """test_zm_tail_pallas's inputs as float64 numpy (2 tracers); `quiet`
    zeroes every mass flux and the precipitation."""
    d = {k: np.asarray(v, np.float64 if v.dtype != jnp.int32 else np.int64)
         for k, v in _inputs(ncol=ncol, seed=seed).items()}
    d["qtr"] = np.stack([d["q"] * 0.1, d["q"] * 0.05], -1)
    if quiet:
        for k in ("mu", "md", "du", "eu", "ed", "rprd"):
            d[k] = np.zeros_like(d[k])
        d["prec"] = np.zeros_like(d["prec"])
    return d


def _tail_args(d, lib):
    """zm_tail's positional arguments for one package."""
    f = (lambda a: torch.from_numpy(np.ascontiguousarray(a))) \
        if lib == "torch" else jnp.asarray
    return [f(d[k]) for k in ("t", "q", "pmid", "pdel", "u", "v", "qtr",
                              "cld", "mu", "md", "du", "eu", "ed", "dp",
                              "jt", "mx", "rprd", "prec", "landfrac")]


# The JAX side runs jitted (each function compiled once per process and
# kept in the persistent compile cache), as the JAX package runs it.
@functools.cache
def _jax_evap(org=False):
    cfg = JZMConfig(org=org)
    return jax.jit(lambda t, pmid, pdel, q, landfrac, rprd, cld, prec:
                   jzm.zm_conv_evap(cfg, t, pmid, pdel, q, landfrac, rprd,
                                    cld, DT, prec))


_jax_momtran = jax.jit(lambda *a: jzt.momtran(*a, DT, 0.4, 0.4))


@functools.cache
def _jax_convtran(dry_mask):
    return jax.jit(lambda q, *a, **kw: jzt.convtran(
        (False, True, True), q, *a, DT, dry_mask=dry_mask, **kw))


def _evap(d, cfg_kw, lib):
    args = [d[k] for k in ("t", "pmid", "pdel", "q", "landfrac", "rprd",
                           "cld", "prec")]
    if lib == "torch":
        t, pmid, pdel, q, landfrac, rprd, cld, prec = map(torch.from_numpy,
                                                          args)
        return tzm.zm_conv_evap(ZMConfig(**cfg_kw), t, pmid, pdel, q,
                                landfrac, rprd, cld, DT, prec)
    return _jax_evap(**cfg_kw)(*map(jnp.asarray, args))


def _momtran(d, lib):
    args = [d[k] for k in ("u", "v", "mu", "md", "du", "eu", "ed", "dp",
                           "jt", "mx")]
    if lib == "torch":
        return tzt.momtran(*map(torch.from_numpy, args), DT, 0.4, 0.4)
    return _jax_momtran(*map(jnp.asarray, args))


def _convtran(d, lib, dry=False, fracis=True):
    f = torch.from_numpy if lib == "torch" else jnp.asarray
    rng = np.random.default_rng(3)
    q = np.concatenate([d["q"][:, :, None], d["qtr"]], -1)
    kw = {}
    if fracis:
        kw["fracis"] = f(rng.uniform(0.3, 1.0, q.shape))
    if dry:
        kw["dpdry"] = f(d["dp"] * 0.98)
    args = [f(q)] + [f(d[k]) for k in ("mu", "md", "du", "eu", "ed", "dp",
                                       "jt", "mx")]
    dry_mask = (False, True, False) if dry else None
    if lib == "torch":
        return tzt.convtran((False, True, True), *args, DT,
                            dry_mask=dry_mask, **kw)
    return _jax_convtran(dry_mask)(*args, **kw)


@pytest.mark.parametrize("quiet", [False, True])
@pytest.mark.parametrize("org", [False, True])
def test_zm_conv_evap_matches_jax(quiet, org):
    d = _case(quiet)
    got, want = _evap(d, dict(org=org), "torch"), _evap(d, dict(org=org),
                                                        "jax")
    assert set(got) == set(want)
    _assert_evap_close(got, want, TOL)
    if quiet:
        assert float(got["tend_q"].abs().max()) == 0.0


@pytest.mark.parametrize("quiet", [False, True])
def test_momtran_matches_jax(quiet):
    d = _case(quiet)
    got, want = _momtran(d, "torch"), _momtran(d, "jax")
    for k in ("dudt", "dvdt", "seten"):
        assert_close(got[k], want[k], TOL, k)
    for k in MT_PAIRS:
        for i in range(2):
            assert_close(got[k][i], want[k][i], TOL, f"{k}[{i}]")
    if quiet:
        assert float(got["dudt"].abs().max()) == 0.0


@pytest.mark.parametrize("dry", [False, True])
def test_convtran_matches_jax(dry):
    d = _case()
    assert_close(_convtran(d, "torch", dry), _convtran(d, "jax", dry), TOL)


@pytest.mark.parametrize("quiet", [False, True])
def test_zm_tail_ref_matches_jax_pieces(quiet):
    """zm_tail_ref (and zm_tail on CPU tensors) against the JAX XLA pieces
    zm_tail_pallas fuses, as tests/test_zm_tail_pallas.py holds the
    Pallas kernel."""
    d = _case(quiet)
    cfg = ZMConfig()
    ev, mt, dq = ztk.zm_tail_ref(cfg, *_tail_args(d, "torch"), DT)
    ev2, mt2, dq2 = ztk.zm_tail(cfg, *_tail_args(d, "torch"), DT)
    ev_j = _evap(d, {}, "jax")
    mt_j = _momtran(d, "jax")
    dq_j = _convtran(d, "jax", fracis=False)
    _assert_evap_close(ev, ev_j, TOL)
    for k in EVAP_KEYS:
        assert torch.equal(ev2[k], ev[k]), k
    for k in ("dudt", "dvdt", "seten"):
        assert_close(mt[k], mt_j[k], TOL, k)
        assert torch.equal(mt2[k], mt[k]), k
    for k in MT_PAIRS:
        for i in range(2):
            assert_close(mt[k][i], mt_j[k][i], TOL, f"{k}[{i}]")
    assert_close(dq, np.asarray(dq_j)[:, :, 1:], TOL, "dq_tr")
    assert torch.equal(dq2, dq)
    if quiet:
        assert float(dq.abs().max()) == 0.0


def test_tail_pieces_match_oracles():
    """zm_conv_evap, momtran and convtran against the statement-order
    oracles, at test_zm_oracle_parity's tolerances (evap rtol 1e-12 with an
    atol floor 1e-15; transport rtol 1e-11, atol 1e-16 / 1e-20)."""
    d = _case(ncol=24)
    cfg = ZMConfig()
    ev = _evap(d, {}, "torch")
    _, qs = tzm.qsat_blend(torch.from_numpy(d["t"]),
                           torch.from_numpy(d["pmid"]))
    _, fsnow = tzm.cldfrc_fice(torch.from_numpy(d["t"]))
    want = orc.zm_conv_evap_oracle(d["t"], d["pmid"], d["pdel"], d["q"],
                                   npy(qs), npy(fsnow), d["rprd"], d["cld"],
                                   DT, d["prec"], cfg.ke, cfg.ke_lnd,
                                   d["landfrac"], cfg.org)
    for k in EVAP_KEYS:
        np.testing.assert_allclose(npy(ev[k]), want[k], rtol=1e-12,
                                   atol=1e-15, err_msg=k)
    mt = _momtran(d, "torch")
    want = orc.momtran_oracle(*[d[k] for k in ("u", "v", "mu", "md", "du",
                                               "eu", "ed", "dp", "jt", "mx")],
                              DT, 0.4, 0.4)
    for k in ("dudt", "dvdt", "seten"):
        np.testing.assert_allclose(npy(mt[k]), want[k], rtol=1e-11,
                                   atol=1e-16, err_msg=k)
    for k in MT_PAIRS:
        for i in range(2):
            np.testing.assert_allclose(npy(mt[k][i]), want[k][i], rtol=1e-11,
                                       atol=1e-16, err_msg=f"{k}[{i}]")
    rng = np.random.default_rng(3)
    q = np.concatenate([d["q"][:, :, None], d["qtr"]], -1)
    fracis = rng.uniform(0.3, 1.0, q.shape)
    dsubcld = np.zeros(d["t"].shape[0])
    want = orc.convtran_oracle((False, True, True), q, d["mu"], d["md"],
                               d["du"], d["eu"], d["ed"], d["dp"], dsubcld,
                               d["jt"], d["mx"], fracis, d["dp"] * 0.98,
                               (False, True, False), DT)
    np.testing.assert_allclose(npy(_convtran(d, "torch", dry=True)), want,
                               rtol=1e-11, atol=1e-20)


def test_zm_tail_refuses_what_the_kernel_cannot_take():
    d = _case(ncol=8)
    args = _tail_args(d, "torch")
    cfg = ZMConfig()
    bad = list(args)
    bad[1] = bad[1].float()
    with pytest.raises(TypeError, match="qv1"):
        ztk.zm_tail(cfg, *bad, DT)
    bad = list(args)
    bad[8] = bad[8].T.contiguous().T              # non-contiguous mu
    with pytest.raises(ValueError, match="mu"):
        ztk.zm_tail(cfg, *bad, DT)
    bad = list(args)
    bad[14] = bad[14].double()
    with pytest.raises(TypeError, match="jt"):
        ztk.zm_tail(cfg, *bad, DT)
    deep = [torch.zeros((4, ztk.MAX_LEVELS + 1), dtype=torch.float64)] * 6
    deep = deep + [torch.zeros((4, ztk.MAX_LEVELS + 1, 1),
                               dtype=torch.float64)] + \
        [torch.zeros((4, ztk.MAX_LEVELS + 1), dtype=torch.float64)] * 7 + \
        [torch.zeros(4, dtype=torch.long)] * 2 + \
        [torch.zeros((4, ztk.MAX_LEVELS + 1), dtype=torch.float64)] + \
        [torch.zeros(4, dtype=torch.float64)] * 2
    with pytest.raises(ValueError, match="levels"):
        ztk.zm_tail(cfg, *deep, DT)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_kernel_matches_plain_version(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    d = _case(ncol=300, seed=2)
    args = [a.to("cuda", dtype) if a.is_floating_point() else a.cuda()
            for a in _tail_args(d, "torch")]
    cfg = ZMConfig()
    n0 = ztk.zm_tail.launches
    got = ztk.zm_tail(cfg, *args, DT)
    want = ztk.zm_tail_ref(cfg, *args, DT)
    torch.cuda.synchronize()
    assert ztk.zm_tail.launches == n0 + 1
    _assert_evap_close({k: v.cpu() for k, v in got[0].items()},
                       {k: v.cpu() for k, v in want[0].items()}, tol)
    for k in ("dudt", "dvdt", "seten"):
        assert_close(got[1][k].cpu(), want[1][k].cpu(), tol, k)
    assert_close(got[2].cpu(), want[2].cpu(), tol, "dq_tr")


@pytest.fixture(scope="module")
def tail_host_lib(tmp_path_factory):
    """csrc/zm_tail_kernels.cu built as host C++ (torch_port_util.
    host_build: a block's threads as std::threads, its shared memory
    static, __syncthreads() a barrier), with the host libm in place of
    CUDA's."""
    return host_build("zm_tail_kernels", tmp_path_factory.mktemp("tail_host"),
                      1)


def _host_tail(dll, cfg, args, dtype):
    """One zm_tail of the host build through the wrapper's launch function,
    and zm_tail_ref, on `args` cast to dtype; asserts one launch. Returns
    ({output: (got, want)}, the wrapper's (ev, mt, dq))."""
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    suf = "f32" if dtype == torch.float32 else "f64"
    n0 = dll.cam_host_launches()
    got = ztk._run(getattr(dll, f"cam_zm_tail_{suf}"), None, cfg, *args, DT)
    assert dll.cam_host_launches() - n0 == 1
    return got, ztk.zm_tail_ref(cfg, *args, DT)


def _assert_tail_close(got, want, tol, label):
    """Every output of zm_tail within tol of its max (the surface rates of
    their column flux's, as _assert_evap_close)."""
    _assert_evap_close(got[0], want[0], tol)
    for k in ("dudt", "dvdt", "seten"):
        assert_close(got[1][k], want[1][k], tol, f"{label} {k}")
    for k in MT_PAIRS:
        for i in range(2):
            assert_close(got[1][k][i], want[1][k][i], tol,
                         f"{label} {k}[{i}]")
    assert_close(got[2], want[2], tol, f"{label} dq_tr")


def test_cuda_source_arithmetic_on_the_host(tail_host_lib):
    """csrc/zm_tail_kernels.cu built as host C++ against zm_tail_ref:
    float64 within 1e-12 of each output's max, float32 within 1e-5 (the
    card's gates; glibc's powf/log10f differ from PyTorch's CPU ones by
    ulps, so float32 is not bitwise here), with and without org. 64
    columns: tiles of 12 (float32) and 6 (float64) columns, the last one
    ragged."""
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for org in (False, True):
            d = _case(ncol=64, seed=1)
            got, want = _host_tail(tail_host_lib, ZMConfig(org=org),
                                   _tail_args(d, "torch"), dtype)
            _assert_tail_close(got, want, tol, f"{dtype} org={org}")


@pytest.mark.parametrize("ntr", [1, 3, 5])
@pytest.mark.parametrize("quiet", [False, True])
def test_cuda_source_tracer_passes_on_the_host(quiet, ntr, tail_host_lib):
    """The host build with 1, 3 and 5 tracers (the block takes its tracers
    two at a time: one pass, two with a single tracer in the second, three)
    and with every mass flux zero, against zm_tail_ref at the gates of
    test_cuda_source_arithmetic_on_the_host, on 23 columns (ragged tiles)."""
    d = _case(quiet=quiet, ncol=23, seed=4)
    rng = np.random.default_rng(ntr)
    d["qtr"] = d["q"][:, :, None] * rng.uniform(0.01, 0.2, (1, 1, ntr))
    if ntr > 1:
        d["qtr"][:, :, -1] = 0.0          # a tracer that is 0 everywhere
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        got, want = _host_tail(tail_host_lib, ZMConfig(),
                               _tail_args(d, "torch"), dtype)
        assert got[2].shape == (23, d["t"].shape[1], ntr)
        _assert_tail_close(got, want, tol, f"{dtype} ntr={ntr}")
        if quiet:
            assert float(got[2].abs().max()) == 0.0
