"""The port's fused small step (models/fv/cd_fused.py, ops/cd_fused_kernels.py)
against the JAX package's cd_pallas, float64 on the CPU at 36x24x6.

- The DFT factor tables equal JAX make_grid's (1e-14), and the plain DFT
  polar filter equals JAX's rfft polar_filter (1e-12).
- cd_step through the fused path (on CPU tensors: k1_ref ... k4_ref)
  against JAX cd_step_fused(interpret=True) for four flag sets, every
  state field and diagnostic within 1e-10 of its max. The two evaluate the
  same formulas; log and pow come from other math libraries (about an
  ulp), which the pressure-gradient cancellation amplifies (measured
  margin in ROADMAP.md Queue 3). JAX's interpreted kernels run in fresh
  interpreters, one a flag set, all at once while the port runs
  (tests/torch_port_modes_ref.py "cd_fused").
- The same step against JAX's unfused cd_step(use_pallas=False) within
  rtol 1e-7, the tolerance of tests/test_cd_pallas.py: the carry and the
  cumsum associate the pressure sum differently.
- Dry mass is conserved; the wrappers' checks refuse what the kernels
  cannot take; the default HS step runs the fused path.
- csrc/cd_fused_kernels.cu built as host C++ (torch_port_util.host_build:
  stub CUDA qualifiers, each launch its blocks in turn, a block's threads
  as std::threads sharing its shared memory and meeting at
  __syncthreads()) against the plain versions: float64 within 1e-12 and
  float32 within 1e-5 of each output's max; also K1 with FFSL rows
  without and with a polar band, K2 with the filter off and K3 with FFSL
  rows and a polar band at orders 1 and 4; and K3 (FFSL rows and a polar
  band) and K4 at every other order of stencil_kernels.KERNEL_ORDERS and
  the pairs (3, 5) and (6, 2), float32 bitwise but for K3's pkz and dgz
  (glibc's powf and logf), float64 within 1e-12.
- On a card (marked `cuda`), each kernel against its plain version.
"""

import functools

import numpy as np
import pytest
import torch

from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import build_step
from cam_nor_physics_tpu_torch.models.fv import cd_core as tcd
from cam_nor_physics_tpu_torch.models.fv import cd_fused as tcf
from cam_nor_physics_tpu_torch.models.fv import grid as tgrid
from cam_nor_physics_tpu_torch.ops import cd_fused_kernels as ck
from torch_port_util import (assert_close, host_build, npy,
                             reference_processes, t64)

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

IM, JM, KM = 36, 24, 6
DT = 450.0
TOL_JAX = 1e-10
TOL_UNFUSED = 1e-7
STATE = ("u", "v", "pt", "delp")
DIAGS = ("cx", "cy", "mfx", "mfy", "pe", "pkz", "wz")
TAPER = np.linspace(0.06, 0.01, KM)

# cd_step flags of the four cases: the default HS step (polar filter on,
# centered KE, del2 velocity damping, the sponge taper), the filter off,
# the avg_sq KE with del4 divergence damping, the upwind KE
BASE = dict(c_sw_pgf=True, dyn_filter=True, ke_method="centered",
            del2_velocity=6e5, div4_coef_nd=0.0, taper=True)
FLAG_SETS = {
    "filter_centered": BASE,
    "filter_off": dict(BASE, dyn_filter=False),
    "avg_sq_div4": dict(BASE, ke_method="avg_sq", div4_coef_nd=0.02),
    "upwind": dict(BASE, ke_method="upwind"),
}


def _spun_up():
    """A Held-Suarez state three unfused small steps from rest, made by the
    port (as tests/test_cd_pallas.py spins up JAX's)."""
    _, st, grid, coord, phis = build_step(IM, JM, KM, torch.float64, "cpu")
    for _ in range(3):
        st, _ = tcd.cd_step(st, grid, coord.ptop, phis, DT, c_sw_pgf=True,
                            del2_velocity=6e5, fused=False)
    return st, grid, coord, phis


def _port_kw(flags):
    kw = {k: v for k, v in flags.items() if k != "taper"}
    return dict(kw, div_taper=TAPER if flags["taper"] else None)


def _port_step(st, grid, coord, phis, flags, **extra):
    return tcd.cd_step(st, grid, coord.ptop, phis, DT, **_port_kw(flags),
                       **extra)


def test_dft_tables_match_jax():
    from cam_nor_physics_tpu.models.fv import grid as jgrid
    for im, jm in ((IM, JM), (144, 96)):
        jg = jgrid.make_grid(im, jm, KM)
        tg = tgrid.make_grid(im, jm, KM, device="cpu")
        for f in ("dft_fc", "dft_fs", "dft_gc", "dft_gs"):
            assert getattr(tg, f).shape == getattr(jg, f).shape, f
            assert_close(getattr(tg, f), np.asarray(getattr(jg, f)), 1e-14, f)


@pytest.mark.parametrize("rows", ["center", "edge"])
def test_dft_filter_matches_jax_polar_filter(rows):
    from cam_nor_physics_tpu.models.fv import grid as jgrid
    jg = jgrid.make_grid(IM, JM, KM)
    tg = tgrid.make_grid(IM, JM, KM, device="cpu")
    resp = "pft_center" if rows == "center" else "pft_edge"
    x = np.random.default_rng(3).standard_normal((KM, JM, IM))
    got = tcf._dft_filter(t64(x), tg.dft_fc, tg.dft_fs, tg.dft_gc,
                          tg.dft_gs, getattr(tg, resp))
    assert_close(got, jgrid.polar_filter(x, getattr(jg, resp)), 1e-12)


def _jax_fused(fields, flags):
    """JAX cd_step_fused(interpret=True) on the state `fields`."""
    import jax
    import jax.numpy as jnp

    from cam_nor_physics_tpu.models.fv import cd_core as jcd
    from cam_nor_physics_tpu.models.fv.cd_pallas import cd_step_fused
    from cam_nor_physics_tpu.models.fv.grid import make_grid
    from cam_nor_physics_tpu.models.fv.vertical import hybrid_coefficients

    grid = make_grid(IM, JM, KM)
    ptop = hybrid_coefficients(KM).ptop
    phis = jnp.zeros((JM, IM))
    taper = jnp.asarray(TAPER) if flags["taper"] else None

    @jax.jit
    def step(st):
        return cd_step_fused(st, grid, ptop, phis, DT, 4, 4, 0.08,
                             flags["dyn_filter"], flags["ke_method"],
                             flags["del2_velocity"], interpret=True,
                             div2_on=True,
                             div4_coef_nd=flags["div4_coef_nd"],
                             div_taper=taper)

    new, diag = step(jcd.DynState(**{f: jnp.asarray(a)
                                     for f, a in fields.items()}))
    return ({f: np.asarray(getattr(new, f)) for f in STATE},
            {f: np.asarray(diag[f]) for f in DIAGS})


def test_fused_cd_step_matches_jax_fused(tmp_path):
    """The port's cd_step (fused, plain versions on the CPU) against JAX
    cd_step_fused in interpret mode, four flag sets, 1e-10 of each
    field's max. The errors relative to each field's max are printed
    (seen with pytest -s on this test)."""
    st, grid, coord, phis = _spun_up()
    fields = convert.dynstate_to_numpy(st)

    def port(_):
        out = {}
        for name, flags in FLAG_SETS.items():
            new, diag = _port_step(st, grid, coord, phis, flags)
            out[name] = {f: npy(getattr(new, f)) for f in STATE}
            out[name].update({f: npy(diag[f]) for f in DIAGS})
        return out

    ported, outs = reference_processes(
        tmp_path, "torch_port_modes_ref.py",
        [("cd_fused", dict(fields=fields, flags=name))
         for name in FLAG_SETS], port, None)
    for (name, flags), want in zip(FLAG_SETS.items(), outs):
        got = ported[name]
        for f in STATE + DIAGS:
            assert_close(got[f], want[f], TOL_JAX, f"{name} {f}")
        rel = {f: np.abs(got[f] - want[f]).max() / np.abs(want[f]).max()
               for f in STATE + DIAGS}
        print(name, {f: f"{e:.1e}" for f, e in rel.items()})


@pytest.mark.parametrize("case", ["filter_centered", "filter_off"])
def test_fused_cd_step_matches_jax_unfused(case):
    """The fused step against JAX's unfused cd_step (use_pallas=False):
    rtol 1e-7 (tests/test_cd_pallas.py:48-58)."""
    import jax.numpy as jnp

    from cam_nor_physics_tpu.models.fv import cd_core as jcd
    from cam_nor_physics_tpu.models.fv import grid as jgrid

    flags = FLAG_SETS[case]
    st, grid, coord, phis = _spun_up()
    fields = convert.dynstate_to_numpy(st)
    new, diag = _port_step(st, grid, coord, phis, flags)
    ref, rdiag = jcd.cd_step(
        jcd.DynState(**{f: jnp.asarray(a) for f, a in fields.items()}),
        jgrid.make_grid(IM, JM, KM), coord.ptop, jnp.zeros((JM, IM)), DT,
        use_pallas=False, **_port_kw(flags))
    for f in STATE:
        assert_close(getattr(new, f), getattr(ref, f), TOL_UNFUSED, f)
    for f in DIAGS:
        assert_close(diag[f], rdiag[f], TOL_UNFUSED, f)


def test_fused_step_agrees_with_unfused_step_and_keeps_mass():
    """The port's fused and unfused steps from one state: within rtol 1e-7
    of each other, and neither changes the global dry mass beyond 1e-13
    (the cap closure of tp2c keeps it; no floor fires)."""
    st, grid, coord, phis = _spun_up()
    w = grid.cosp.clone()
    w[0] = w[-1] = grid.acap / grid.im
    m0 = float((st.delp * w[:, None]).sum())
    for flags in FLAG_SETS.values():
        new, _ = _port_step(st, grid, coord, phis, flags)
        ref, _ = _port_step(st, grid, coord, phis, flags, fused=False)
        for f in STATE:
            assert_close(getattr(new, f), getattr(ref, f), TOL_UNFUSED, f)
        assert abs(float((new.delp * w[:, None]).sum()) - m0) / m0 < 1e-13
        assert bool((new.delp > 0.05 * st.delp).all())


def test_cd_step_dispatch(monkeypatch):
    """cd_step takes the fused path for the fft/dft filter with the c_sw
    half step; matmul, filter_dm/filter_csw_dm, fused=False and the
    Coriolis-only half step stay unfused; build_step's default HS step
    runs it nsplit = 4 times per large step."""
    calls = []
    real = tcf.cd_step_fused

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tcf, "cd_step_fused", spy)
    st, grid, coord, phis = _spun_up()
    for kw, fused in ((dict(filter_impl="fft"), True),
                      (dict(filter_impl="dft"), True),
                      (dict(filter_impl="matmul"), False),
                      (dict(filter_impl="fft", filter_dm=True), False),
                      (dict(filter_impl="fft", filter_csw_dm=True), False),
                      (dict(filter_impl="fft", fused=False), False),
                      (dict(filter_impl="fft", c_sw_pgf=False), False)):
        calls.clear()
        tcd.cd_step(st, grid, coord.ptop, phis, DT,
                    **dict(dict(c_sw_pgf=True), **kw))
        assert bool(calls) == fused, kw
    step, st, grid, coord, phis = build_step(12, 8, 2, torch.float64, "cpu")
    calls.clear()
    step(st, grid, coord, phis)
    assert len(calls) == 4


def _k_calls(flags):
    """The inputs of K1-K4 in one fused step from the spun-up state, as
    cd_step_fused passes them, with their plain outputs."""
    st, grid, coord, phis = _spun_up()
    rec = {}
    real = {n: getattr(ck, n) for n in ("k1", "k2", "k3", "k4")}

    def recorder(name):
        def call(*a):
            rec[name] = a
            return real[name](*a)
        return call

    mp = pytest.MonkeyPatch()
    for n in real:
        mp.setattr(ck, n, recorder(n))
    try:
        _port_step(st, grid, coord, phis, flags)
    finally:
        mp.undo()
    return rec


def test_wrappers_refuse_what_the_kernels_cannot_take():
    rec = _k_calls(BASE)
    a = list(rec["k1"])
    with pytest.raises(TypeError, match="float32 or float64"):
        ck.k1(*[x.half() if isinstance(x, torch.Tensor) else x for x in a])
    with pytest.raises(TypeError, match="expected torch.float64"):
        ck.k1(a[0], a[1].float(), *a[2:])
    with pytest.raises(ValueError, match="shape"):
        ck.k1(*a[:4], a[4][:, :-1], *a[5:])
    with pytest.raises(ValueError, match="contiguous"):
        ck.k1(a[0].transpose(1, 2).contiguous().transpose(1, 2), *a[1:])
    with pytest.raises(ValueError, match="im even"):
        ck.k1(*[x[..., :-1] for x in a[:4]], *a[4:])
    b = list(rec["k3"])
    ck._check("k3", [("delp", b[0])], iord=2, jord=4)
    ck._check("k4", [("u", b[0])], iord=-2, jord=7)
    for iord, jord in ((0, 4), (4, 8)):
        with pytest.raises(ValueError, match="iord/jord"):
            ck.k3(*b[:5], iord, jord, *b[7:])
    c = list(rec["k4"])
    with pytest.raises(ValueError, match="ke_method"):
        ck.k4(*c[:17], "vector", *c[18:])
    with pytest.raises(ValueError, match="shape"):
        ck.k4(*c[:10], c[10][:-1], *c[11:])
    d = list(rec["k2"])
    with pytest.raises(ValueError, match="shape"):
        ck.k2(*d[:7], (d[7][0][:-1],) + tuple(d[7][1:]), *d[8:])


# launch sites of csrc/cd_fused_kernels.cu and its headers: K1 one, K1's
# and K3's transport rows five, K2 three, K4 four, the DFT filter two
_N_LAUNCHES = 15


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_build("cd_fused_kernels",
                      tmp_path_factory.mktemp("cd_fused_host"), _N_LAUNCHES)


def _host_run(dll, name, args, dtype):
    """The host build of kernel `name` (k1...k4) on the recorded wrapper
    arguments `args` cast to `dtype`, marshalled by the wrapper's own
    launch function; returns its outputs and the launches it made."""
    suf = "f32" if dtype == torch.float32 else "f64"
    run = getattr(ck, f"_run_{name}")
    n0 = dll.cam_host_launches()
    out = run(getattr(dll, f"cam_cd_{name}_{suf}"), None,
              *[_cast(x, dtype) for x in args])
    return out, dll.cam_host_launches() - n0


def _cast(x, dtype, device="cpu"):
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    if isinstance(x, tuple):
        return tuple(_cast(y, dtype, device) for y in x)
    return x


def _host_matches_plain(dll, name, args, dyn_filter):
    """The host build of K `name` on `args` against its plain version:
    float64 within 1e-12, float32 within 1e-5 of each output's max
    (glibc's powf/logf are not PyTorch's, so float32 is not bitwise
    here); the call makes launches_per_call(name, dyn_filter) launches."""
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        want = getattr(tcf, f"{name}_ref")(*[_cast(x, dtype) for x in args])
        got, launches = _host_run(dll, name, args, dtype)
        assert launches == ck.launches_per_call(name, dyn_filter), (
            name, launches)
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.isfinite(g).all(), (name, i)
            assert_close(g, w, tol, f"{name} {dtype} output {i}")


@pytest.mark.parametrize("name", ["k1", "k2", "k3", "k4"])
def test_cuda_source_arithmetic_on_the_host(name, host_lib):
    """Each K of csrc/cd_fused_kernels.cu, built for the host, against its
    plain version on the inputs of a fused step (K4 also with the filter
    off, avg_sq KE and del4 damping): float64 within 1e-12, float32
    within 1e-5 of each output's max; each call makes the launches the
    wrapper counts for it (launches_per_call)."""
    for flags in (BASE, FLAG_SETS["avg_sq_div4"] | dict(dyn_filter=False)):
        rec = _k_calls(flags)
        _host_matches_plain(host_lib, name, rec[name], flags["dyn_filter"])
        if name != "k4":
            break


# rows whose |crx| K3's FFSL cases raise by 1.5, and the polar band they
# set: rows 1, 2 and JM-3, JM-2 take the FFSL branch, rows 3 and JM-4 are
# flagged but lie outside the band
FFSL_ROWS = [1, 2, 3, JM - 4, JM - 3, JM - 2]
FFSL_BAND = 3
# u added on FFSL_ROWS in K1's cases (m/s), on the western half of the
# longitudes: its C-grid Courants, whose ua averages rows j and j+1,
# exceed 1 on rows 1, 2 and JM-4..JM-2 (with the band, row JM-4 is flagged
# but outside it), and where the raised winds end the mass flux diverges
# enough that both of K1's floors, of delp and of pt, set points
K1_RAISE = 2500.0
K1_FFSL_ROWS = [1, 2, JM - 4, JM - 3, JM - 2]
ROW_CASES = ("k1_ffsl", "k1_ffsl_band", "k2_filter_off",
             "k3_ffsl_band_order1", "k3_ffsl_band_order4")


def _row_case(case):
    """(name, args, dyn_filter) of a K1, K2 or K3 case beyond the fused
    step's own calls: K1 with u raised so that FFSL rows are flagged,
    without and with a polar band; K2 with the polar filter off; K3 at
    iord = jord = 1 or 4 with FFSL rows forced and a polar band set."""
    rec = _k_calls(BASE)
    if case.startswith("k1"):
        a = list(rec["k1"])
        a[0] = a[0].clone()
        a[0][:, FFSL_ROWS, :IM // 2] += K1_RAISE
        a[8] = FFSL_BAND if case == "k1_ffsl_band" else None
        crx = tcf.c_grid_courants(a[0], a[1], a[4], a[5])[2]
        flagged = tcf._ffsl_rows(crx).any(0)
        assert flagged.nonzero().flatten().tolist() == K1_FFSL_ROWS
        return "k1", a, True
    if case == "k2_filter_off":
        a = list(rec["k2"])
        a[10] = False
        return "k2", a, False
    a = list(rec["k3"])
    crx = a[2].clone()
    crx[:, FFSL_ROWS] += torch.where(crx[:, FFSL_ROWS] >= 0, 1.5, -1.5)
    order = int(case[-1])
    a[2], a[5], a[6], a[9] = crx, order, order, FFSL_BAND
    flagged = tcf._ffsl_rows(crx).any(0)
    assert flagged[FFSL_ROWS].all() and flagged.sum() == len(FFSL_ROWS)
    return "k3", a, True


@pytest.mark.parametrize("case", ROW_CASES)
def test_cuda_source_row_kernel_cases_on_the_host(case, host_lib):
    """The host build of K1 with FFSL rows flagged (its transport at
    order 1 takes the FFSL branch there), without and with a polar band,
    of K2 with the filter off (its row
    kernel finishes the point) and of K3 with FFSL rows and a polar band,
    at orders 1 and 4, against the plain versions, as the test above holds
    them."""
    name, args, dyn_filter = _row_case(case)
    _host_matches_plain(host_lib, name, args, dyn_filter)


# the transport orders beside 1 and 4 and the two mixed pairs; where K3
# and K4 take them in their argument lists
OTHER_ORDERS = [(2, 2), (3, 3), (5, 5), (6, 6), (7, 7), (-2, -2), (3, 5),
                (6, 2)]
ORDER_ARGS = {"k3": (5, 6), "k4": (15, 16)}


# levels of the fused step's inputs the order cases keep (the host runs
# each block's threads as std::threads: a level less is a third less time)
ORDER_LEVELS = 2


@functools.lru_cache(maxsize=None)
def _order_sources():
    """K3's arguments with FFSL rows forced and the polar band set (as
    _row_case), and K4's, on the top ORDER_LEVELS levels of the fused
    step's inputs: made once for the order cases."""
    def top(args):
        return tuple(x[:ORDER_LEVELS].contiguous()
                     if isinstance(x, torch.Tensor) and x.shape[0] == KM
                     else x for x in args)
    return {"k3": top(_row_case("k3_ffsl_band_order4")[1]),
            "k4": top(_k_calls(BASE)["k4"])}


def _order_case(name, iord, jord):
    """K3's or K4's order-case arguments at (iord, jord)."""
    a = list(_order_sources()[name])
    i, j = ORDER_ARGS[name]
    a[i], a[j] = iord, jord
    return a


@pytest.mark.parametrize("iord,jord", OTHER_ORDERS)
def test_k3_k4_every_order_on_the_host(iord, jord, host_lib):
    """K3 and K4 of the host build at (iord, jord), on two levels,
    against their plain versions: float32 bitwise (K3's pkz and dgz, which pass through
    glibc's powf and logf, within 1e-5), float64 within 1e-12 of each
    output's max."""
    for name in ("k3", "k4"):
        a = _order_case(name, iord, jord)
        for dtype in (torch.float32, torch.float64):
            want = getattr(tcf, f"{name}_ref")(*[_cast(x, dtype) for x in a])
            got, launches = _host_run(host_lib, name, a, dtype)
            assert launches == ck.launches_per_call(name)
            for i, (g, w) in enumerate(zip(got, want)):
                msg = f"{name} ({iord}, {jord}) {dtype} output {i}"
                assert torch.isfinite(g).all(), msg
                if dtype == torch.float32 and not (name == "k3" and i >= 4):
                    assert torch.equal(g, w), msg
                else:
                    assert_close(g, w, 1e-12 if dtype == torch.float64
                                 else 1e-5, msg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["k1", "k2", "k3", "k4"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_kernel_matches_plain_version(name, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    rec = _k_calls(BASE)
    args = [_cast(x, dtype, "cuda") for x in rec[name]]
    fn = getattr(ck, name)
    n0 = fn.launches
    got = fn(*args)
    want = getattr(tcf, f"{name}_ref")(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + ck.launches_per_call(name)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g.cpu(), w.cpu(), tol, f"{name} output {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROW_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_row_kernel_cases_match_plain_version(case, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    name, a, dyn_filter = _row_case(case)
    args = [_cast(x, dtype, "cuda") for x in a]
    fn = getattr(ck, name)
    n0 = fn.launches
    got = fn(*args)
    want = getattr(tcf, f"{name}_ref")(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + ck.launches_per_call(name, dyn_filter)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g.cpu(), w.cpu(), tol, f"{case} output {i}")
