"""ZM's dilute parcel kernel (csrc/zm_parcel_kernels.cu, routed by
ops/zm_parcel_kernels.zm_parcel) against its plain version, the port's
buoyan_dilute.

The CUDA source, built as host C++ (torch_port_util.host_build: a block's
threads as std::threads meeting at a barrier, with the host libm in place
of CUDA's), runs through the wrapper's own launch function on the
arguments zm_convr gives buoyan_dilute (both calls of second_call, the
second with its expanded dmpdz) and is held to buoyan_dilute: float64
within 1e-12 of each field's max, float32 within 1e-5, lcl, lel and mx
equal, for the solvers newton and newton_exact with parcel_pbl off and
on. Float32 under newton is held so only in the columns where neither
side jumped: the plain secant divides by a 1e-12 guard that float32
cannot resolve and clamps the step to 10 K, so an ulp of difference (the
host libm's against PyTorch's) can move a point by up to 10 K. The
cases: test_torch_zm_core's soundings (unstable and stable, land
and ocean), and 37 varied columns (a ragged last tile) with launches at
the bottom level, columns without an LCL and columns with at least
num_cin neutral-buoyancy crossings. zm_convr takes the kernel twice a
call with second_call, once without, and never on CPU tensors or under
the scan parcel or the Brent solver; through the kernel it gives the
plain version's outputs. On a card (marked `cuda`) the kernel is held to
the plain version at f19's 13,824 columns.
"""

import functools

import numpy as np
import pytest
import torch

from cam_nor_physics_tpu_torch.models.physics import zm_conv as tzm
from cam_nor_physics_tpu_torch.ops import zm_parcel_kernels as zpk
from cam_nor_physics_tpu_torch.utils.config import ZMConfig
from torch_port_util import assert_close, host_build

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
FLOATS = ("tp", "qstp", "buoy", "tl", "cape", "cin", "pl")
INDICES = ("lcl", "lel", "mx")
CFGS = {"newton": {}, "newton_exact": {"inversion_solver": "newton_exact"},
        "newton.pbl": {"parcel_pbl": True},
        "newton_exact.pbl": {"inversion_solver": "newton_exact",
                             "parcel_pbl": True}}


def _core():
    """test_torch_zm_core (its soundings, SOUNDING, and test_zm_conv's
    MSG and make_sounding), imported when a CPU test asks: it imports the
    JAX package, which the card test does not need."""
    import test_torch_zm_core
    return test_torch_zm_core


def _varied():
    """37 columns of the unstable sounding (tiles of 16: the last one
    ragged): 0-4 with a PBL below the lowest midpoint (the launch at the
    bottom level), 5-9 the stable dry sounding (no LCL), 10-14 with
    +-8 K alternating between levels 2 and 20 (many neutral-buoyancy
    crossings), 18-36 over ocean."""
    core = _core()
    s = {k: np.array(v, np.float64) for k, v in core.make_sounding(
        ncol=37, unstable=True, seed=5).items()}
    st = core.make_sounding(ncol=5, unstable=False, seed=6)
    for k in core.SOUNDING:
        s[k][5:10] = np.array(st[k], np.float64)
    s["pblh"][0:5] = 1.0
    s["t"][10:15, 2:21] += 8.0 * (-1.0) ** np.arange(2, 21)
    s["landfrac"][18:] = 0.0
    return s


CASES = {"soundings": lambda: _core()._soundings(), "varied": _varied}


@functools.cache
def _calls(case, cfg_name):
    """The arguments of zm_convr's zm_parcel calls (float64, CPU) on
    CASES[case] under CFGS[cfg_name]."""
    s = CASES[case]()
    core = _core()
    calls = []

    def rec(*a):
        calls.append(a)
        return tzm.buoyan_dilute(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(zpk, "zm_parcel_ref", rec)
        tzm.zm_convr(ZMConfig(**CFGS[cfg_name]), core.MSG,
                     *[torch.from_numpy(np.asarray(s[k], np.float64))
                       for k in core.SOUNDING], 900.0)
    assert len(calls) == 2 and calls[1][12].stride(1) == 0
    return calls


def _cast(args, dtype):
    return [a.to(dtype) if isinstance(a, torch.Tensor) and
            a.is_floating_point() else a for a in args]


@pytest.fixture(scope="module")
def parcel_host_lib(tmp_path_factory):
    """csrc/zm_parcel_kernels.cu built as host C++ (one launch site)."""
    return host_build("zm_parcel_kernels",
                      tmp_path_factory.mktemp("parcel_host"), 1)


def _host_parcel(dll, args):
    """zm_parcel's arguments through the host build, one launch."""
    cfg, msg, q, t, p, z, pf, zi_, zs, pblt, tpert, _, dmpdz = args
    suf = "f32" if t.dtype == torch.float32 else "f64"
    n0 = dll.cam_host_launches()
    out = zpk._run(getattr(dll, f"cam_zm_parcel_{suf}"), None, cfg, msg, q,
                   t, p, z, pf, zi_, zs, pblt, tpert, dmpdz)
    assert dll.cam_host_launches() - n0 == 1
    return out


def _assert_parcel_close(got, want, tol, label):
    for f in FLOATS:
        assert_close(getattr(got, f), getattr(want, f), tol, f"{label} {f}")
    for f in INDICES:
        assert torch.equal(getattr(got, f), getattr(want, f)), f"{label} {f}"


def _jumped(out, truth, tol=1e-3):
    """Columns where a float32 parcel is more than tol of a field's max off
    the float64 plain version (a secant step divided by the 1e-12 guard
    and clamped to 10 K)."""
    bad = torch.zeros(truth.tp.shape[0], dtype=torch.bool)
    for f in ("tp", "qstp", "buoy"):
        w = getattr(truth, f)
        scale = float(w.abs().max())
        bad |= ((getattr(out, f).double() - w).abs() > tol * scale).any(1)
    return bad


def _assert_close_but_jumps(got, want, truth, tol, label):
    """float32 under the secant solver: each column within tol of each
    field's max, with its level indices equal, unless the kernel or the
    plain version jumped there (`_jumped` against the float64 plain
    version `truth`): the plain version moves as much under a one-ulp
    change of its inputs. At least half the columns are compared."""
    jumped = _jumped(got, truth) | _jumped(want, truth)
    assert 2 * int(jumped.sum()) <= truth.tp.shape[0], label
    keep = ~jumped
    for f in FLOATS:
        g, w = getattr(got, f).double(), getattr(want, f).double()
        scale = max(float(w.abs().max()), 1e-300)
        err = (g - w).abs().reshape(w.shape[0], -1).amax(1)
        assert bool((err[keep] <= tol * scale).all()), (label, f)
    for f in INDICES:
        assert torch.equal(getattr(got, f)[keep], getattr(want, f)[keep]), \
            (label, f)


def _crossings(out, msg, cfg):
    """Neutral-buoyancy crossings below each column's LCL (buoyan_dilute's
    CAPE search)."""
    buoy = out.buoy
    k = torch.arange(buoy.shape[1])[None, :]
    kmask = (k >= msg + 1) & (k < out.lcl[:, None]) & \
        (out.pl >= cfg.plclmin)[:, None]
    below = torch.cat([buoy[:, 1:], buoy[:, -1:]], 1)
    return (kmask & (below > 0.0) & (buoy <= 0.0)).sum(1)


def test_varied_case_covers_the_kernels_branches():
    """The varied case holds what its docstring promises, in both calls:
    launches at the bottom level, columns with no LCL (lcl = mx), columns
    with num_cin crossings or more, and a ragged last tile in float32 and
    float64."""
    cfg = ZMConfig()
    pver = 26
    for args in _calls("varied", "newton"):
        out = tzm.buoyan_dilute(*args)
        assert bool((out.mx == pver - 1).any())
        assert bool((out.lcl == out.mx).any())
        assert bool((out.lcl < out.mx).any())
        assert int(_crossings(out, args[1], cfg).max()) >= cfg.num_cin
        assert bool((out.cape > cfg.capelmt).any())
    assert 37 % 16 != 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("cfg_name", list(CFGS))
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_source_matches_buoyan_dilute_on_the_host(case, cfg_name, dtype,
                                                       parcel_host_lib):
    """The host build against buoyan_dilute on both of zm_convr's calls:
    float64 within 1e-12 of each field's max, float32 within 1e-5, the
    level indices equal; float32 under the secant solver (newton) in the
    columns where neither jumped (_assert_close_but_jumps)."""
    for i, args64 in enumerate(_calls(case, cfg_name)):
        args = _cast(args64, dtype)
        got = _host_parcel(parcel_host_lib, args)
        want = tzm.buoyan_dilute(*args)
        label = f"{case} {cfg_name} call {i + 1}"
        if dtype == torch.float32 and not cfg_name.startswith(
                "newton_exact"):
            _assert_close_but_jumps(got, want, tzm.buoyan_dilute(*args64),
                                    TOL[dtype], label)
        else:
            _assert_parcel_close(got, want, TOL[dtype], label)


def test_zm_parcel_refuses_what_the_kernel_cannot_take(monkeypatch,
                                                       parcel_host_lib):
    args = list(_calls("soundings", "newton")[0])
    dll = parcel_host_lib
    bad = list(args)
    bad[3] = bad[3].float()                      # t float32, the rest not
    with pytest.raises(TypeError, match="q"):
        _host_parcel(dll, bad)
    bad = list(args)
    bad[4] = bad[4].T.contiguous().T             # non-contiguous p
    with pytest.raises(ValueError, match="p"):
        _host_parcel(dll, bad)
    bad = list(args)
    bad[6] = bad[6][:, :-1]                      # pf on levels
    with pytest.raises(ValueError, match="pf"):
        _host_parcel(dll, bad)
    deep = torch.zeros((4, zpk.MAX_LEVELS + 1), dtype=torch.float64)
    assert not zpk.takes(ZMConfig(), deep[:, :-1])      # a CPU tensor
    monkeypatch.setattr(zpk, "DEVICE_TYPE", "cpu")
    assert not zpk.takes(ZMConfig(), deep)
    assert zpk.takes(ZMConfig(), deep[:, :-1])
    assert not zpk.takes(ZMConfig(), deep[:, :-1].half())


def _route_counts(monkeypatch, dll, dtype):
    """zm_convr on test_torch_zm_core's soundings with zm_parcel's launch
    through the host build, CPU tensors routed as the card's are: the
    launches of each configuration, and the outputs through the kernel
    and through the plain version for the default one."""
    core = _core()
    s = core._soundings()
    args = [torch.from_numpy(s[k]).to(dtype) for k in core.SOUNDING]
    monkeypatch.setattr(zpk, "DEVICE_TYPE", "cpu")
    monkeypatch.setattr(zpk, "_launch",
                        lambda *a: _host_parcel(dll, a[:11] + (None, a[11])))
    counts = {}
    for name, kw in (("default", {}),
                     ("first_call_only", dict(second_call=False,
                                              retrigger=False)),
                     ("scan", dict(parcel_impl="scan")),
                     ("brent", dict(inversion_solver="brent"))):
        n0 = zpk.zm_parcel.launches
        out = tzm.zm_convr(ZMConfig(**kw), core.MSG, *args, 900.0)
        counts[name] = zpk.zm_parcel.launches - n0
        if name == "default":
            kernel_out = out
    monkeypatch.setattr(zpk, "DEVICE_TYPE", "cuda")
    plain_out = tzm.zm_convr(ZMConfig(), core.MSG, *args, 900.0)
    return counts, kernel_out, plain_out


def test_zm_convr_routes_the_parcel(monkeypatch, parcel_host_lib):
    """zm_convr's two buoyan_dilute calls go through zm_parcel: never to
    the kernel on CPU tensors; with CPU tensors routed as the card's, twice a
    call with second_call, once without, never under the scan parcel or
    the Brent solver, and the outputs through the kernel within 1e-12 of
    the plain version's (float64), the trigger and indices equal."""
    core = _core()
    s = core._soundings()
    n0 = zpk.zm_parcel.launches
    tzm.zm_convr(ZMConfig(), core.MSG, *[torch.from_numpy(s[k])
                                         for k in core.SOUNDING], 900.0)
    assert zpk.zm_parcel.launches == n0
    counts, got, want = _route_counts(monkeypatch, parcel_host_lib,
                                      torch.float64)
    assert counts == {"default": 2, "first_call_only": 1, "scan": 0,
                      "brent": 0}
    assert torch.equal(got.ideep, want.ideep) and bool(want.ideep.any())
    for f in ("jt", "maxg", "jctop", "jcbot"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("qtnd", "heat", "prec", "cape", "cin", "mu", "md", "dlf",
              "rprd", "mcon"):
        assert_close(getattr(got, f), getattr(want, f), 1e-12, f)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cuda_kernel_matches_plain_version_at_f19(dtype):
    """The kernel against buoyan_dilute on the card, on the arguments of
    zm_convr's two calls at f19's 13,824 columns (entry.varied_zm_inputs),
    at the host test's gates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    from cam_nor_physics_tpu_torch.entry import varied_zm_inputs
    pstate, _, forcing = varied_zm_inputs(144 * 96, 26, dtype, "cuda")
    calls = []

    def rec(*a):
        calls.append(a)
        return tzm.buoyan_dilute(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(zpk, "zm_parcel", rec)
        tzm.zm_convr(ZMConfig(), 0, pstate.t, pstate.q[:, :, 0], pstate.pmid,
                     pstate.pint, pstate.pdel, pstate.zm, pstate.phis,
                     pstate.zi, forcing["pblh"], forcing["tpert"],
                     forcing["landfrac"], 900.0)
    assert len(calls) == 2
    for i, args in enumerate(calls):
        n0 = zpk.zm_parcel.launches
        got = zpk.zm_parcel(*args)
        want = zpk.zm_parcel_ref(*args)
        torch.cuda.synchronize()
        assert zpk.zm_parcel.launches == n0 + 1
        _assert_parcel_close(got, want, TOL[dtype], f"f19 call {i + 1}")
