"""The port's transport stencils (ops/stencil_kernels.py) against the JAX
package, float64 on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version; these tests hold
that version to the JAX transport3d / vort_flux3d / tracer_div3d at 1e-12
relative to each output's largest magnitude: through the jnp path
(prefer_pallas=False) for the orders and FFSL polar bands the dycore calls
them with, and once per kernel through the Pallas kernel itself in
interpret mode (as tests/test_pallas_kernels.py runs it). The CUDA kernels are held to the
plain versions on the card (marked `cuda`, skipped without one; chip_smoke.py
does the same at f19 shapes). On the CPU, csrc/stencil_kernels.cu built as
host C++ (torch_port_util.host_build) runs the row kernels of
transport3d, vort_flux3d and tracer_div3d against their plain versions:
orders 1 and 4, FFSL rows on and off, a polar band on and off (two tracers);
float64 within 1e-12 and float32 within 1e-5 of each output's max,
LAUNCHES_PER_CALL[name] launches a call; and at every other order of
KERNEL_ORDERS and the mixed pairs (3, 5) and (6, 2), float32 bitwise and
float64 within 1e-12 (the polar caps' float64 row sums are the only
values whose order of summation differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cam_nor_physics_tpu.models.fv.grid import make_grid
from cam_nor_physics_tpu.ops import pallas_kernels as pk
from cam_nor_physics_tpu.ops import tp_core as jtp
from cam_nor_physics_tpu_torch.ops import stencil_kernels as sk
from torch_port_util import assert_close, host_build, slab_fields, t64

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

TOL = 1e-12
KM, JM, IM = 3, 24, 36


def _inputs(seed=0):
    """numpy inputs of the three stencil functions on one small grid."""
    f = slab_fields(KM, JM, IM, seed)
    grid = make_grid(IM, JM, KM)
    f["cosp"] = np.asarray(grid.cosp)
    f["acosp"] = np.asarray(grid.acosp)
    f["rcap"] = float(grid.rcap)
    f["yfx"] = f["cry"] * f["cosp"][:, None]
    f["va"] = 0.5 * (f["cry"] + np.asarray(jtp.edge_north(f["cry"])))
    f["ffsl"] = np.abs(f["crx"]).max(-1) > 1.0
    f["udt"] = 450.0 * f["crx"]
    f["vdt"] = 450.0 * f["cry"]
    return f


def _transport_args(f, iord):
    return [f[k] for k in ("delp", "pt", "crx", "cry", "yfx", "va", "ffsl",
                           "cosp", "acosp", "rcap")] + [iord, iord]


def _vort_args(f, iord):
    return [f[k] for k in ("zeta", "crx", "cry", "udt", "vdt", "ffsl",
                           "cosp")] + [iord, iord]


def _tracer_args(f, iord):
    return [f[k] for k in ("q", "crx", "cry", "udt", "yfx", "va", "ffsl",
                           "cosp", "acosp", "rcap")] + [iord, iord]


CASES = {"transport3d": _transport_args, "vort_flux3d": _vort_args,
         "tracer_div3d": _tracer_args}


def _torch(args):
    return [t64(a) if isinstance(a, np.ndarray) else a for a in args]


def _outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name,iord,band", [
    ("transport3d", 1, 5), ("transport3d", 4, 5), ("vort_flux3d", 4, 5),
    ("tracer_div3d", 4, None)])
def test_plain_version_matches_jax(name, iord, band):
    """The calls of the dycore: cd_step runs transport3d at order 1 (C half
    step) and 4 with a polar band, vort_flux3d at 4 with a band; trac2d runs
    tracer_div3d at 4 without one. The interpret-mode test below covers
    order 4 without a band for the other two."""
    f = _inputs(seed=iord + (band or 0))
    args = CASES[name](f, iord)
    got = getattr(sk, name)(*_torch(args), band=band)
    arrays = [a for a in args if isinstance(a, np.ndarray)]
    scalars = args[len(arrays):]
    want = jax.jit(lambda *a: getattr(pk, name)(
        *a, *scalars, prefer_pallas=False, band=band))(*arrays)
    for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
        assert_close(g, w, TOL, f"{name} output {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas_interpret(name, monkeypatch):
    """Through the Pallas kernel body, run by the interpreter on the CPU."""
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(pk, "use_pallas", lambda *a: True)
    f = slab_fields(2, 16, 24, seed=9, ffsl_rows=2)
    grid = make_grid(24, 16, 2)
    f.update(cosp=np.asarray(grid.cosp), acosp=np.asarray(grid.acosp),
             rcap=float(grid.rcap))
    f["yfx"] = f["cry"] * f["cosp"][:, None]
    f["va"] = 0.5 * (f["cry"] + np.asarray(jtp.edge_north(f["cry"])))
    f["ffsl"] = np.abs(f["crx"]).max(-1) > 1.0
    f["udt"], f["vdt"] = 450.0 * f["crx"], 450.0 * f["cry"]
    f["q"] = f["q"][:1]
    args = CASES[name](f, 4)
    got = getattr(sk, name)(*_torch(args))
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    want = getattr(pk, name)(*jargs, prefer_pallas=True)
    for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
        assert_close(g, w, TOL, f"{name} output {i}")


def test_cpu_tensors_take_the_plain_version():
    """CPU tensors never reach the kernel: the launch counts stay put."""
    f = _inputs(seed=3)
    before = {n: getattr(sk, n).launches for n in CASES}
    for name, make in CASES.items():
        args = _torch(make(f, 4))
        got = getattr(sk, name)(*args)
        want = getattr(sk, name + "_ref")(*args)
        for g, w in zip(_outputs(got), _outputs(want)):
            assert torch.equal(g, w)
    assert {n: getattr(sk, n).launches for n in CASES} == before


def test_kernel_checks_refuse_unsupported_orders():
    """Every order of KERNEL_ORDERS passes the check (order 2, which
    raised until the kernels took it, too); 0 and 8 raise, on either
    axis, naming the set."""
    f = _inputs(seed=4)
    args = _torch(_transport_args(f, 4))
    slabs = [("delp", args[0]), ("pt", args[1])]
    for o in sk.KERNEL_ORDERS:
        sk._check("transport3d", slabs, args[0].shape, args[6],
                  [("cosp", args[7])], o, 2)
    for iord, jord in ((0, 4), (4, 8), (8, 8)):
        with pytest.raises(ValueError, match="iord/jord must be in"):
            sk._check("transport3d", slabs, args[0].shape, args[6],
                      [("cosp", args[7])], iord, jord)
        with pytest.raises(ValueError, match="iord/jord"):
            sk.transport3d(*args[:10], iord, jord)
    with pytest.raises(ValueError, match="shape"):
        sk._check("transport3d", slabs, args[0].shape, args[6][:, :-1],
                  [("cosp", args[7])], 4, 4)
    with pytest.raises(TypeError, match="float32 or float64"):
        sk._check("transport3d", [("delp", args[0].half())], args[0].shape,
                  args[6], [], 4, 4)


# launch sites of csrc/stencil_kernels.cu: transport3d four, vort_flux3d
# one, tracer_div3d three
_N_LAUNCHES = 8
# the polar band of the band cases: of the flagged rows 1-3 and JM-4..JM-2
# (slab_fields), rows 1 and JM-2 take the FFSL branch
TRACER_BAND = 2
# each wrapper's launch function, which the host test calls with the host
# library's C entry
RUNS = {"transport3d": sk._run_transport, "vort_flux3d": sk._run_vort,
        "tracer_div3d": sk._run_tracer}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_build("stencil_kernels",
                      tmp_path_factory.mktemp("stencil_host"), _N_LAUNCHES)


@pytest.mark.parametrize("band", [None, TRACER_BAND],
                         ids=["no_band", "band"])
@pytest.mark.parametrize("ffsl", [True, False], ids=["ffsl", "no_ffsl"])
@pytest.mark.parametrize("order", [1, 4])
@pytest.mark.parametrize("name", list(RUNS))
def test_tracer_row_kernels_on_the_host(name, order, ffsl, band, host_lib):
    """The row kernels of csrc/stencil_kernels.cu, built for the host,
    against the plain version of `name` (tracer_div3d on two tracers),
    marshalled by the wrapper's own launch function: float64 within
    1e-12, float32 within 1e-5 of each output's max; a call makes
    LAUNCHES_PER_CALL[name] launches."""
    f = slab_fields(KM, JM, IM, seed=11 + order,
                    ffsl_rows=3 if ffsl else 0)
    grid = make_grid(IM, JM, KM)
    f.update(cosp=np.asarray(grid.cosp), acosp=np.asarray(grid.acosp),
             rcap=float(grid.rcap))
    f["udt"] = 450.0 * f["crx"]
    f["vdt"] = 450.0 * f["cry"]
    f["yfx"] = f["cry"] * f["cosp"][:, None]
    f["va"] = 0.5 * (f["cry"] + np.asarray(jtp.edge_north(f["cry"])))
    f["ffsl"] = np.abs(f["crx"]).max(-1) > 1.0
    assert f["q"].shape[0] == 2 and f["ffsl"].any() == ffsl
    args = _torch(CASES[name](f, order))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        a = [x.to(dtype) if isinstance(x, torch.Tensor) and
             x.is_floating_point() else x for x in args]
        want = _outputs(getattr(sk, name + "_ref")(*a, band=band))
        suf = "f32" if dtype == torch.float32 else "f64"
        n0 = host_lib.cam_host_launches()
        got = _outputs(RUNS[name](getattr(host_lib, f"cam_{name}_{suf}"),
                                  None, *a, band))
        assert (host_lib.cam_host_launches() - n0 ==
                sk.LAUNCHES_PER_CALL[name])
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.isfinite(g).all()
            assert_close(g, w, tol, f"{name} output {i} {dtype}")


# the orders beside 1 and 4 and the two mixed pairs
OTHER_ORDERS = [(2, 2), (3, 3), (5, 5), (6, 6), (7, 7), (-2, -2), (3, 5),
                (6, 2)]


@pytest.mark.parametrize("iord,jord", OTHER_ORDERS)
@pytest.mark.parametrize("name", list(RUNS))
def test_row_kernels_at_every_order_on_the_host(name, iord, jord, host_lib):
    """The row kernels (csrc/tp_core.cuh), built for the host, against the
    plain version of `name` at (iord, jord), 24x16x2: FFSL rows with a
    polar band (rows 1 and JM-2 take the FFSL branch, the
    other flagged rows the band's Eulerian one), and none; float32
    bitwise, float64 within 1e-12 of each output's max."""
    for ffsl, band in ((True, TRACER_BAND), (False, None)):
        f = slab_fields(2, 16, 24, seed=21 + iord,
                        ffsl_rows=3 if ffsl else 0)
        grid = make_grid(24, 16, 2)
        f.update(cosp=np.asarray(grid.cosp), acosp=np.asarray(grid.acosp),
                 rcap=float(grid.rcap))
        f["udt"] = 450.0 * f["crx"]
        f["vdt"] = 450.0 * f["cry"]
        f["yfx"] = f["cry"] * f["cosp"][:, None]
        f["va"] = 0.5 * (f["cry"] + np.asarray(jtp.edge_north(f["cry"])))
        f["ffsl"] = np.abs(f["crx"]).max(-1) > 1.0
        args = _torch(CASES[name](f, iord))
        args[-1] = jord
        for dtype in (torch.float64, torch.float32):
            a = [x.to(dtype) if isinstance(x, torch.Tensor) and
                 x.is_floating_point() else x for x in args]
            want = _outputs(getattr(sk, name + "_ref")(*a, band=band))
            suf = "f32" if dtype == torch.float32 else "f64"
            got = _outputs(RUNS[name](getattr(host_lib, f"cam_{name}_{suf}"),
                                      None, *a, band))
            for i, (g, w) in enumerate(zip(got, want)):
                msg = f"{name} ({iord}, {jord}) {ffsl} {band} output {i}"
                assert torch.isfinite(g).all(), msg
                if dtype == torch.float32:
                    assert torch.equal(g, w), msg
                else:
                    assert_close(g, w, 1e-12, msg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_kernel_matches_plain_version(name, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    f = _inputs(seed=5)
    args = [torch.as_tensor(a, device="cuda",
                            dtype=torch.bool if a.dtype == bool else dtype)
            if isinstance(a, np.ndarray) else a for a in CASES[name](f, 4)]
    n0 = getattr(sk, name).launches
    got = getattr(sk, name)(*args, band=5)
    want = getattr(sk, name + "_ref")(*args, band=5)
    torch.cuda.synchronize()
    assert getattr(sk, name).launches == n0 + sk.LAUNCHES_PER_CALL[name]
    for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
        assert_close(g.cpu(), w.cpu(), tol, f"{name} output {i}")
