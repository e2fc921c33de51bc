"""The port's bench (cam_nor_physics_tpu_torch/bench.py), its probe kernel
and what the bench configuration adds to the HS step, on the CPU.

- The probe: its plain version against the JAX package's Pallas kernel
  `_k` (bench.py's `_PALLAS_PROBE`, run with interpret=True as the JAX
  suite runs Pallas on the CPU), exactly: o = 2 x is exact in float32.
  csrc/probe_kernels.cu built as host C++ against the plain version,
  exactly; the kernel on the card (marked `cuda`, skipped without one).
- FVConfig()'s auto splits, the bench's configuration, against the JAX
  package's at the bench's four grids, exactly (integers).
- One HS large step with FVConfig(nsplit=8, nspltrac=2): dyn_run's
  tracer subcycle (n2 = 2: 8 small steps, 2 trac2d calls) against JAX's
  dyn_run plus hs_forcing, float64 at 36x24x6 with filter_impl="matmul"
  on both sides, within 1e-9 of each field's max (two math libraries'
  log/pow ulps amplified by the pressure-gradient cancellation; the
  2-step unfused test of test_torch_slice.py measures ~1e-12).
- The bench on the CPU at BENCH_SMALL's 72x46x10, one iteration and one
  pass: bench.py's per-dispatch keys plus `impl` and `card`; the
  environment it reads; BENCH_ROOFLINE raises; BENCH_COUPLED with
  BENCH_MICROP runs the microp coupled bench.
- The coupled bench (BENCH_COUPLED=1 BENCH_SMALL=1 BENCH_CPU=1,
  BENCH_CHUNK=1) on the CPU, one step a shape and one pass: bench.py's
  coupled keys plus `impl` and `card`, and the environment it reads.
- The profile's split of device kernels into the port's (the __global__
  functions of csrc/) and PyTorch's, on demangled profiler names.
- The bench's state helpers (walk, clone, bitwise comparison) and
  wset_row's capture-safe scalar path, bitwise against the former
  host-tensor form.
"""

import json

import numpy as np
import pytest
import torch

from cam_nor_physics_tpu_torch import bench as tbench
from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import build_step
from cam_nor_physics_tpu_torch.models.fv import dyn_comp as tdc
from cam_nor_physics_tpu_torch.ops import cuda_build
from cam_nor_physics_tpu_torch.ops import probe_kernels as pk
from cam_nor_physics_tpu_torch.ops.tp_core import wset_row
from cam_nor_physics_tpu_torch.utils.config import FVConfig
from conftest import run_test_in_subprocess
from torch_port_util import assert_close

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

SUBCYCLE_SHAPE = (36, 24, 6)
TOL_SUBCYCLE = 1e-9
# bench.py's per-dispatch record keys (bench.py:666-676)
PER_DISPATCH_KEYS = {"metric", "value", "unit", "vs_baseline",
                     "headline_shape", "chunk", "grid", "device", "t_ms"}


def _probe_input(seed=5):
    return np.random.default_rng(seed).standard_normal(pk.SHAPE).astype(
        np.float32)


# ---------------------------------------------------------------- probe
def test_probe_ref_matches_the_pallas_probe():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    import bench as jbench

    src = jbench._PALLAS_PROBE
    lines = src[src.index("def _k("):].splitlines()
    body = [lines[0]] + [ln for ln in lines[1:] if ln.startswith("    ")]
    ns = {}
    exec("\n".join(body), ns)
    x = _probe_input()
    want = np.asarray(pl.pallas_call(
        ns["_k"], out_shape=jax.ShapeDtypeStruct(pk.SHAPE, jnp.float32),
        interpret=True)(jnp.asarray(x)))
    got = pk.probe(torch.from_numpy(x))          # CPU: the plain version
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pk.probe_ref(torch.from_numpy(x)).numpy(),
                                  want)


def test_probe_refuses_other_blocks():
    with pytest.raises(TypeError, match="float32 or float64"):
        pk.probe(torch.zeros(pk.SHAPE, dtype=torch.float16))
    with pytest.raises(ValueError, match="block"):
        pk.probe(torch.zeros((8, 64), dtype=torch.float32))
    with pytest.raises(ValueError, match="block"):
        pk.probe(torch.zeros((128, 8), dtype=torch.float32).t())


_HOST_STUBS = """
#pragma once
#define __global__
#define __launch_bounds__(x)
#define __restrict__
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct HostDim { int x = 0, y = 0, z = 0; };
static HostDim blockIdx, blockDim, threadIdx;
"""


def test_probe_source_on_the_host(tmp_path):
    """csrc/probe_kernels.cu built as host C++ (stub CUDA qualifiers, the
    one-block launch as a call with one thread) against probe_ref,
    exactly, in float32 and float64; n < 1 is refused."""
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = (cuda_build.CSRC / "probe_kernels.cu").read_text()
    launch = ("probe_kernel<T><<<1, kThreads, 0, (cudaStream_t)stream>>>"
              "(x, o, n);")
    assert launch in src
    src = src.replace(launch, "(void)stream; blockDim.x = 1; "
                              "probe_kernel<T>(x, o, n);")
    (tmp_path / "cuda_runtime.h").write_text(_HOST_STUBS)
    (tmp_path / "probe.cpp").write_text(src)
    lib = tmp_path / "libprobe.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-I",
                    str(tmp_path), "-o", str(lib), str(tmp_path / "probe.cpp")],
                   check=True, timeout=120)
    dll = ctypes.CDLL(str(lib))
    (stem, argtypes), = cuda_build.SIGNATURES["probe_kernels"]
    for suf, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        fn = getattr(dll, f"{stem}_{suf}")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        x = torch.from_numpy(_probe_input(seed=6)).to(dtype)
        out = torch.full_like(x, float("nan"))
        assert fn(x.data_ptr(), out.data_ptr(), x.numel(), None) == 0
        assert torch.equal(out, pk.probe_ref(x))
        assert fn(x.data_ptr(), out.data_ptr(), 0, None) != 0


@pytest.mark.cuda
def test_probe_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m cuda tests/test_torch_*.py)")
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(_probe_input(seed=7)).to(dtype)
        n0 = pk.probe.launches
        got = pk.probe(x.cuda())
        torch.cuda.synchronize()
        assert pk.probe.launches == n0 + 1
        assert torch.equal(got.cpu(), x * 2.0)


# ------------------------------------------------------- configuration
@pytest.mark.parametrize("grid", sorted(tbench.GRIDS))
def test_auto_splits_match_jax(grid):
    from cam_nor_physics_tpu.utils.config import FVConfig as JFVConfig
    im, jm, _, _ = tbench.GRIDS[grid]
    got = FVConfig().resolved_splits(1800.0, im, jm)
    assert got == JFVConfig().resolved_splits(1800.0, im, jm)
    expect = {"small": (2, 1, 1), "f19": (4, 1, 1), "f09": (8, 2, 1),
              "f05": (16, 4, 1)}
    assert got == expect[grid]


def _jax_subcycled_step(fields, cfg_kw):
    import jax
    import jax.numpy as jnp

    from cam_nor_physics_tpu.models.fv.cd_core import DynState
    from cam_nor_physics_tpu.models.fv.dyn_comp import dyn_run
    from cam_nor_physics_tpu.models.fv.grid import make_grid
    from cam_nor_physics_tpu.models.fv.held_suarez import hs_forcing
    from cam_nor_physics_tpu.models.fv.vertical import hybrid_coefficients
    from cam_nor_physics_tpu.utils.config import FVConfig as JFVConfig

    im, jm, km = SUBCYCLE_SHAPE
    grid = make_grid(im, jm, km)
    coord = hybrid_coefficients(km)
    phis = jnp.zeros((jm, im))
    cfg = JFVConfig(**cfg_kw, use_pallas=False)

    @jax.jit
    def step(state):
        state = dyn_run(state, grid, coord, phis, cfg, 1800.0,
                        filter_impl="matmul")
        return hs_forcing(state, grid, coord.ptop, 1800.0)

    state = step(DynState(**{f: jnp.asarray(a) for f, a in fields.items()}))
    return {f: np.asarray(getattr(state, f)) for f in fields}


def test_tracer_subcycled_hs_step_matches_jax(request, monkeypatch):
    """nsplit=8, nspltrac=2 (f09's auto splits): n2 = 2 tracer cycles of 4
    small steps, each closed by trac2d, then one remap."""
    if run_test_in_subprocess(request, timeout=300):
        return
    cfg_kw = dict(nsplit=8, nspltrac=2)
    calls = {"cd_step": 0, "trac2d": 0}
    for name in calls:
        real = getattr(tdc, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tdc, name, counted)
    step, state, grid, coord, phis = build_step(
        *SUBCYCLE_SHAPE, torch.float64, "cpu", filter_impl="matmul",
        cfg=FVConfig(**cfg_kw))
    fields = convert.dynstate_to_numpy(state)
    rng = np.random.default_rng(11)
    fields["q"] = 1e-3 * (1.0 + 0.5 * rng.uniform(size=fields["q"].shape))
    got = convert.dynstate_to_numpy(step(
        convert.dynstate_from_numpy(fields, "cpu"), grid, coord, phis))
    assert calls == {"cd_step": 8, "trac2d": 2}
    want = _jax_subcycled_step(fields, cfg_kw)
    got["ps"], want["ps"] = (coord.ptop + f["delp"].sum(0)
                             for f in (got, want))
    for f in ("ps",) + convert.STATE_FIELDS:
        assert np.isfinite(got[f]).all(), f
        assert_close(got[f], want[f], TOL_SUBCYCLE, f)


# --------------------------------------------------------------- bench
def test_bench_record_on_cpu():
    """The bench at 72x46x10 on the CPU, one iteration, one pass: exactly
    bench.py's per-dispatch keys plus impl and card, and a headline that
    is the grid points over the two step times."""
    rec = tbench.run("small", "cpu", iters=1, passes=1)
    assert set(rec) == PER_DISPATCH_KEYS | {"impl", "card"}
    assert rec["headline_shape"] == "per_dispatch" and rec["chunk"] == 1
    assert rec["grid"] == "72x46x10" and rec["device"] == "cpu"
    assert rec["card"] is None and "plain" in rec["impl"]
    t = rec["t_ms"]
    assert set(t) == {"dyn_step", "zm_tend"} and min(t.values()) > 0.0
    assert rec["value"] == pytest.approx(
        72 * 46 * 10 / ((t["dyn_step"] + t["zm_tend"]) * 1e-3), rel=1e-12)
    json.dumps(rec)


@pytest.mark.parametrize("env,want", [
    ({}, ("f19", "cuda", 8, False)),
    ({"BENCH_SMALL": "1", "BENCH_GRID": "f05"}, ("small", "cuda", 8, False)),
    ({"BENCH_GRID": "f09", "BENCH_CPU": "1"}, ("f09", "cpu", 8, False)),
    ({"BENCH_GRID": "f05", "BENCH_CHUNK": "4", "BENCH_PHASES": "1"},
     ("f05", "cuda", 4, True)),
])
def test_bench_reads_benchpy_environment(env, want, monkeypatch, capsys):
    seen = []

    def fake_run(grid, device, chunk, phases):
        seen.append((grid, device, chunk, phases))
        return {"value": 1.0}
    monkeypatch.setattr(tbench, "run", fake_run)
    assert tbench.main(env) == {"value": 1.0}
    assert seen == [want]
    assert json.loads(capsys.readouterr().out.strip()) == {"value": 1.0}


def test_bench_refuses_unknown_grid():
    with pytest.raises(ValueError, match="BENCH_GRID"):
        tbench.grid_from_env({"BENCH_GRID": "f10"})


@pytest.mark.parametrize("var,names", [("BENCH_COUPLED", "microp"),
                                       ("BENCH_ROOFLINE", "roofline")])
def test_bench_unported_modes_raise(var, names, monkeypatch, capsys):
    """BENCH_ROOFLINE raises. BENCH_COUPLED with BENCH_MICROP, which
    raised until ZM's microphysics was ported, runs the coupled bench
    with ZMConfig(microp=True) (here on the CPU at BENCH_SMALL, one step
    a shape and one pass), under bench.py's microp metric."""
    monkeypatch.setattr(tbench, "run", lambda **kw: pytest.fail("ran"))
    env = {var: "1", "BENCH_CPU": "1", "BENCH_SMALL": "1",
           "BENCH_MICROP": "1", "BENCH_CHUNK": "1"}
    if var == "BENCH_ROOFLINE":
        with pytest.raises(NotImplementedError, match=names):
            tbench.main(env)
        return
    real = tbench.run_coupled
    monkeypatch.setattr(tbench, "run_coupled",
                        lambda **kw: real(**kw, iters=1, passes=1))
    rec = tbench.main(env)
    assert rec["metric"] == tbench.COUPLED_METRIC_MICROP
    assert rec["metric"].endswith("in-plume microphysics ON)")
    assert rec["impl"] == tbench.COUPLED_IMPL_MICROP["cpu"]
    assert rec["grid"] == "72x46x10" and rec["value"] > 0.0
    assert json.loads(capsys.readouterr().out.strip()) == rec


# bench.py's coupled record keys (bench.py:443-457)
COUPLED_KEYS = {"metric", "value", "unit", "vs_baseline", "headline_shape",
                "chunk", "grid", "device", "t_ms",
                "t_ms_phases_independent_dispatch"}


def test_coupled_bench_record_on_cpu():
    """BENCH_COUPLED=1 BENCH_SMALL=1 BENCH_CPU=1 BENCH_CHUNK=1, one step
    a loop shape and one pass: bench.py's coupled keys plus impl and card,
    the five phases, and a headline that is the grid points over the
    faster shape's step time."""
    rec = tbench.run_coupled("small", "cpu", chunk=1, iters=1, passes=1)
    assert set(rec) == COUPLED_KEYS | {"impl", "card"}
    assert rec["grid"] == "72x46x10" and rec["device"] == "cpu"
    assert rec["card"] is None and "plain" in rec["impl"]
    assert rec["chunk"] == 1 and rec["headline_shape"] in ("full",
                                                           "prog_only")
    t = rec["t_ms"]
    assert set(t) == {"full", "prog_only"} and min(t.values()) > 0.0
    assert rec["value"] == pytest.approx(
        72 * 46 * 10 / (min(t.values()) * 1e-3), rel=1e-12)
    assert list(rec["t_ms_phases_independent_dispatch"]) == [
        "bc_physics", "ac_physics", "p_d_coupling", "dyn", "d_p_coupling"]
    json.dumps(rec)


def test_coupled_bench_reads_benchpy_environment(monkeypatch, capsys):
    seen = []

    def fake(grid, device, chunk, microp):
        seen.append((grid, device, chunk, microp))
        return {"value": 2.0}
    monkeypatch.setattr(tbench, "run_coupled", fake)
    monkeypatch.setattr(tbench, "run", lambda **kw: pytest.fail("ran"))
    assert tbench.main({"BENCH_COUPLED": "1", "BENCH_GRID": "f09",
                        "BENCH_CHUNK": "4"}) == {"value": 2.0}
    assert tbench.main({"BENCH_COUPLED": "1", "BENCH_SMALL": "1",
                        "BENCH_CPU": "1", "BENCH_CHUNK": "1"}) == \
        {"value": 2.0}
    assert seen == [("f09", "cuda", 4, False), ("small", "cpu", 1, False)]
    assert capsys.readouterr().out.count('{"value": 2.0}') == 2


def test_profile_splits_port_and_pytorch_kernels():
    names = cuda_build.kernel_names()
    assert {"k1_winds_kernel", "k2_kick_kernel", "dft_forward_kernel",
            "row_inner_kernel", "tp_q_flux_kernel", "te_map_kernel",
            "zm_tail_kernel", "probe_kernel"} <= names
    assert len(names) == 19
    times = {
        "void (anonymous namespace)::k1_winds_kernel<float>(float const*, "
        "float const*, float const*, double, int, int)": [24, 100.0],
        "void tpc::tp_flux_kernel<float>(float const*, float const*)":
            [3, 10.0],
        "zm_tail_kernel(TailArgs<double>, int, int, int, int)": [1, 5.0],
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float>>(int, float*)": [500, 250.0],
        "void at::native::reduce_kernel<512, 1>(float*)": [20, 40.0]}
    assert tbench.by_origin(times) == {"port": [28, 115.0],
                                       "PyTorch": [520, 290.0]}
    assert tbench.kernel_ident("probe_kernel(float const*, float*, int)") \
        == "probe_kernel"


def test_state_helpers():
    step, state, grid, coord, phis = build_step(8, 6, 2, torch.float32,
                                                "cpu")
    carry = (state, {"a": torch.zeros(3), "n": "label"}, 2.0)
    leaves = tbench.tensors(carry)
    assert len(leaves) == 6 and leaves[0] is state.u and \
        leaves[-1] is carry[1]["a"]
    copy = tbench.clone_tree(carry)
    assert copy[1]["n"] == "label" and copy[2] == 2.0
    assert all(a is not b and torch.equal(a, b)
               for a, b in zip(tbench.tensors(copy), leaves))
    assert tbench.bitwise_equal(copy, carry)
    copy[1]["a"][0] = -0.0            # equal as a number, not as bits
    assert not tbench.bitwise_equal(copy, carry)
    nan = torch.tensor([float("nan")])
    assert tbench.bitwise_equal((nan,), (nan.clone(),))


# ------------------------------------------------------------- wset_row
def _wset_row_host_tensor(a, row, value, axis=-2):
    """wset_row as it was: the value made a tensor on a's device (a host
    copy for a scalar), then copied into the row."""
    out = a.clone()
    out.select(axis, row % a.shape[axis]).copy_(
        torch.as_tensor(value, dtype=a.dtype, device=a.device)
        .expand_as(out.select(axis, 0)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wset_row_capture_safe_form_is_bitwise(dtype):
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.standard_normal((3, 5, 8)), dtype=dtype)
    row_vec = torch.as_tensor(rng.standard_normal(8), dtype=torch.float64)
    plane = torch.as_tensor(rng.standard_normal((3, 8)), dtype=dtype)
    for row, value, axis in [(0, 0.0, -2), (-1, -0.0, -2), (2, 1e-300, -2),
                             (0, 1.0 / 3.0, -1), (-1, row_vec, -2),
                             (0, plane, -2), (1, plane[:, :5], -1),
                             (0, torch.tensor(2.5, dtype=dtype), -2)]:
        got = wset_row(a, row, value, axis)
        want = _wset_row_host_tensor(a, row, value, axis)
        assert tbench.bitwise_equal(got, want), (row, value, axis)
