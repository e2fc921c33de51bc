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
  environment it reads; BENCH_ROOFLINE prints a roofline line for
  dyn_step and for zm_tend and leaves the record's keys as they were,
  and raises ValueError beside BENCH_COUPLED; BENCH_COUPLED with
  BENCH_MICROP runs the microp coupled bench.
- The roofline's count (ops/cost.py): a glue function counted by hand
  (elementwise, in-place, reduction, matrix product, FFT, views,
  allocations); each kernel wrapper under the count adds exactly its
  `kernel_work` and nothing of its plain version, on inputs captured
  from the HS steps and the ZM step (and vort_flux3d's FFSL sums by
  hand); a step counts the same when each kernel's implementation does
  other work (the count is the step's, not its implementation's); the
  roofline line's shares, and a share above 100% raising.
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
from cam_nor_physics_tpu_torch.entry import build_step, build_zm_step
from cam_nor_physics_tpu_torch.models.fv import dyn_comp as tdc
from cam_nor_physics_tpu_torch.ops import cd_fused_kernels as ck
from cam_nor_physics_tpu_torch.ops import cost, cuda_build
from cam_nor_physics_tpu_torch.ops import remap_kernels as rk
from cam_nor_physics_tpu_torch.ops import stencil_kernels as sk
from cam_nor_physics_tpu_torch.ops import zm_tail_kernels as zk
from cam_nor_physics_tpu_torch.ops import probe_kernels as pk
from cam_nor_physics_tpu_torch.ops.tp_core import wset_row
from cam_nor_physics_tpu_torch.utils.config import FVConfig
from conftest import run_test_in_subprocess
from torch_port_util import assert_close, slab_fields, t64

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
    ({}, ("f19", "cuda", 8, False, False)),
    ({"BENCH_SMALL": "1", "BENCH_GRID": "f05"},
     ("small", "cuda", 8, False, False)),
    ({"BENCH_GRID": "f09", "BENCH_CPU": "1"}, ("f09", "cpu", 8, False, False)),
    ({"BENCH_GRID": "f05", "BENCH_CHUNK": "4", "BENCH_PHASES": "1"},
     ("f05", "cuda", 4, True, False)),
    ({"BENCH_ROOFLINE": "1"}, ("f19", "cuda", 8, False, True)),
])
def test_bench_reads_benchpy_environment(env, want, monkeypatch, capsys):
    seen = []

    def fake_run(grid, device, chunk, phases, roofline):
        seen.append((grid, device, chunk, phases, roofline))
        return {"value": 1.0}
    monkeypatch.setattr(tbench, "run", fake_run)
    assert tbench.main(env) == {"value": 1.0}
    assert seen == [want]
    assert json.loads(capsys.readouterr().out.strip()) == {"value": 1.0}


def test_bench_refuses_unknown_grid():
    with pytest.raises(ValueError, match="BENCH_GRID"):
        tbench.grid_from_env({"BENCH_GRID": "f10"})


@pytest.mark.parametrize("var", ["BENCH_COUPLED", "BENCH_ROOFLINE"])
def test_bench_roofline_and_microp_modes_run(var, monkeypatch, capsys):
    """BENCH_ROOFLINE, which raised until the count was written, and
    BENCH_COUPLED with BENCH_MICROP, which raised until ZM's microphysics
    was ported, run, here on the CPU at BENCH_SMALL with one iteration
    and one pass. The roofline prints one stderr line for dyn_step and
    one for zm_tend (the CPU has no peaks: counts and rates only) and
    leaves the record's keys as they were; the microp coupled bench runs
    with ZMConfig(microp=True) under bench.py's microp metric."""
    env = {var: "1", "BENCH_CPU": "1", "BENCH_SMALL": "1",
           "BENCH_MICROP": "1", "BENCH_CHUNK": "1"}
    if var == "BENCH_ROOFLINE":
        monkeypatch.setattr(tbench, "run_coupled",
                            lambda **kw: pytest.fail("ran"))
        real_run = tbench.run
        monkeypatch.setattr(tbench, "run",
                            lambda **kw: real_run(**kw, iters=1, passes=1))
        rec = tbench.main(env)
        assert set(rec) == PER_DISPATCH_KEYS | {"impl", "card"}
        out, err = capsys.readouterr()
        assert json.loads(out.strip()) == rec
        lines = [ln for ln in err.splitlines() if ln.startswith("roofline[")]
        assert [ln.split("]")[0] for ln in lines] == ["roofline[dyn_step",
                                                      "roofline[zm_tend"]
        for ln in lines:
            assert "GF/s" in ln and "GB/s" in ln and \
                "cpu has no peak in the table" in ln, ln
            assert float(ln.split("flops=")[1].split()[0]) > 0.0
            assert float(ln.split("bytes=")[1].split()[0]) > 0.0
        return
    monkeypatch.setattr(tbench, "run", lambda **kw: pytest.fail("ran"))
    real = tbench.run_coupled
    monkeypatch.setattr(tbench, "run_coupled",
                        lambda **kw: real(**kw, iters=1, passes=1))
    rec = tbench.main(env)
    assert rec["metric"] == tbench.COUPLED_METRIC_MICROP
    assert rec["metric"].endswith("in-plume microphysics ON)")
    assert rec["impl"] == tbench.COUPLED_IMPL_MICROP["cpu"]
    assert rec["grid"] == "72x46x10" and rec["value"] > 0.0
    assert json.loads(capsys.readouterr().out.strip()) == rec


def test_bench_coupled_roofline_raises(monkeypatch):
    """bench.py ignores BENCH_ROOFLINE under BENCH_COUPLED; the port
    refuses the pair."""
    monkeypatch.setattr(tbench, "run", lambda **kw: pytest.fail("ran"))
    monkeypatch.setattr(tbench, "run_coupled",
                        lambda **kw: pytest.fail("ran"))
    with pytest.raises(ValueError, match="BENCH_COUPLED.*BENCH_ROOFLINE"):
        tbench.main({"BENCH_COUPLED": "1", "BENCH_ROOFLINE": "1",
                     "BENCH_CPU": "1", "BENCH_SMALL": "1"})


def test_roofline_line_shares_and_refusal():
    h100 = "NVIDIA H100 80GB HBM3"
    line = tbench.roofline_line("dyn_step", 1e-3, 1.675e9, 6.7e9, h100)
    assert line.startswith("roofline[dyn_step]: t=1.00ms flops=6.7e+09 "
                           "bytes=1.68e+09 -> 6.7e+03 GF/s (10.0% of FP32)")
    assert line.endswith("/ 1.68e+03 GB/s (50.0% of HBM) bound=HBM")
    assert tbench.roofline_line("k", 1e-3, 1e6, 6.03e10, h100).endswith(
        "(90.0% of FP32) / 1 GB/s (0.0% of HBM) bound=FP32")
    with pytest.raises(RuntimeError, match="count is wrong"):
        tbench.roofline_line("k", 1e-3, 3.36e9, 1.0, h100)
    assert tbench.roofline_line("k", 1.0, 2e9, 1e9, "cpu").endswith(
        "-> 1 GF/s / 2 GB/s (cpu has no peak in the table)")


# ------------------------------------------------------------ the count
def _glue(x, y, w):
    z = x * y + 1.0
    s = z.sum(-1)
    m = x @ w
    f = torch.fft.rfft(x)
    torch.empty(5)
    torch.zeros(3)
    y.add_(x.reshape(4, 8))
    y[0].copy_(x[0])
    return s, m, f


def test_glue_counted_by_hand():
    """x, y (4, 8) and w (8, 3) float32: mul 384 B and 32 operations; the
    scalar add 256 and 32; the sum over the last axis 144 and 32 (one a
    summed element); the matrix product 272 and 2*4*3*8; the rfft of
    length 8, 4 transforms, 288 (128 in, 4*5 complex64 out) and
    4*5*8*log2(8); add_ 384 and 32 (y read and written); a row's copy_
    64 and none; the reshape, the row views, empty and zeros nothing."""
    x = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    y = torch.ones(4, 8)
    w = torch.ones(8, 3)
    nbytes, ops = cost.count_work(_glue, x, y, w)
    assert nbytes == 384 + 256 + 144 + 272 + 288 + 384 + 64
    assert ops == 32 + 32 + 32 + 192 + 480 + 32


def _owner(name):
    """The module of kernel `name`'s wrapper and plain version."""
    return {"k1": ck, "k2": ck, "k3": ck, "k4": ck, "te_map_remap": rk,
            "zm_tail": zk, "probe": pk}.get(name, sk)


@pytest.fixture(scope="module")
def kernel_calls():
    """The arguments of each kernel wrapper's first call in the fused
    (fft) and unfused (matmul) HS steps at 24x16x4 and a ZM step on 16
    columns, float64 on the CPU, and the probe's block."""
    calls = {"probe": ((torch.ones(pk.SHAPE, dtype=torch.float64),), {})}
    real = cost.kernel_work

    def record(name, args, kwargs, out):
        calls.setdefault(name, (args, kwargs))
        return real(name, args, kwargs, out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cost, "kernel_work", record)
        with cost.WorkCount():
            for impl in ("fft", "matmul"):
                step, st, grid, coord, phis = build_step(
                    24, 16, 4, torch.float64, "cpu", filter_impl=impl)
                step(st, grid, coord, phis)
            zm, pstate, pbuf, _ = build_zm_step(16, 26, torch.float64, "cpu")
            zm(pstate, pbuf)
    return calls


KERNELS = ("transport3d", "vort_flux3d", "tracer_div3d", "te_map_remap",
           "zm_tail", "k1", "k2", "k3", "k4", "probe")


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_wrapper_counts_its_work_only(kernel_calls, name):
    """Under the count a wrapper adds exactly kernel_work (its tensor
    arguments read once, its outputs written once, its formulas'
    operations) and none of its plain version's ops, which the count
    sees when the plain version is called bare."""
    args, kwargs = kernel_calls[name]
    wrapper = getattr(_owner(name), name)
    plain = getattr(_owner(name), name + "_ref")
    with cost.WorkCount() as count:
        out = wrapper(*args, **kwargs)
    want = cost.kernel_work(name, args, kwargs, out)
    assert (count.bytes, count.ops) == want
    assert count.kernels == {name: [1, *want]}
    tensors = tbench.tensors([list(args), kwargs]) + tbench.tensors(out)
    assert want[0] == sum(t.numel() * t.element_size() for t in tensors)
    assert want[1] > 0
    with cost.WorkCount() as bare:
        plain(*args, **kwargs)
    assert bare.kernels == {} and bare.bytes > 0


def test_vort_flux3d_ffsl_sums_by_hand():
    """vort_flux3d with FFSL rows: per point OPS_Y[jord] + OPS_X[iord],
    plus each FFSL row's integer Courants capped at max_cfl_int (numpy)."""
    km, jm, im = 3, 12, 16
    f = slab_fields(km, jm, im, seed=4, ffsl_rows=2, cmax_ffsl=3.7)
    crx = f["crx"]
    ffsl = np.abs(crx).max(-1) > 1.0
    cosp = np.cos(np.linspace(-np.pi / 2, np.pi / 2, jm))
    args = (t64(f["zeta"]), t64(crx), t64(f["cry"]), t64(f["cry"]),
            t64(f["cry"]), t64(ffsl), t64(cosp), 4, 4)
    with cost.WorkCount() as count:
        sk.vort_flux3d(*args)
    cap = sk.tp.max_cfl_int(im)
    sums = (np.minimum(np.abs(np.trunc(crx)), cap) * ffsl[..., None]).sum()
    assert ffsl.any() and sums > 0
    assert count.ops == km * jm * im * (cost.OPS_Y[4] + cost.OPS_X[4]) + sums
    assert count.bytes == 8 * (7 * km * jm * im + jm) + km * jm


def _busier(real):
    """real with other work around it: its inputs copied first, its
    outputs copied after."""
    def f(*a, **kw):
        a = [x.clone() if isinstance(x, torch.Tensor) else x for x in a]
        return tbench.clone_tree(real(*a, **kw))
    return f


@pytest.mark.parametrize("step_name", ["fft", "matmul", "zm"])
def test_step_count_does_not_depend_on_the_kernels_implementation(
        step_name, monkeypatch):
    """A step's count is the work it needs: it stays the same when every
    kernel's implementation does more (here the plain versions with
    copies around them, as a CUDA kernel does other work than its plain
    version)."""
    if step_name == "zm":
        zm, pstate, pbuf, _ = build_zm_step(16, 26, torch.float64, "cpu")
        fn, args = zm, (pstate, pbuf)
    else:
        step, st, grid, coord, phis = build_step(
            24, 16, 4, torch.float64, "cpu", filter_impl=step_name)
        fn, args = step, (st, grid, coord, phis)
    with cost.WorkCount() as want:
        fn(*args)
    assert want.kernels and want.bytes > sum(
        b for _, b, _ in want.kernels.values())
    for name in KERNELS:
        owner, ref = _owner(name), name + "_ref"
        monkeypatch.setattr(owner, ref, _busier(getattr(owner, ref)))
    with cost.WorkCount() as got:
        fn(*args)
    assert (got.bytes, got.ops) == (want.bytes, want.ops)
    assert got.kernels == want.kernels


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
            "zm_tail_kernel", "probe_kernel", "span_mark_kernel"} <= names
    assert len(names) == 20
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
