"""Static and CPU-only checks of the PyTorch port.

- No module of cam_nor_physics_tpu_torch, nor chip_smoke.py, imports
  jax, flax or the JAX package
  cam_nor_physics_tpu (the exact top-level name, so the port's own package
  does not match).
- The scan covers every module of the coupled step and of the driver,
  each by name.
- No port module runs `make` or writes under native/: the native writers
  are built from native/'s sources into the package's build/ directory.
- Entry points default to the CUDA device and raise where it is absent:
  the coupled step's (build_coupled, AtmModel.create, the coupled bench)
  and the driver's (quick_run, cli.run_main) too.
- convert.py carries state, grid and coordinate, the physics state and
  buffer, and the coupled state, across and back unchanged.
- ZMConfig.microp and the dycore's AM and high-altitude options, which
  raised until they were ported, run; so does mesh= in dyn_run (a mesh
  of one rank gives the step without a mesh bitwise; an object that is
  not a mesh raises TypeError).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from cam_nor_physics_tpu.models.fv import grid as jgrid
from cam_nor_physics_tpu.models.fv import vertical as jvert
from cam_nor_physics_tpu_torch import convert
from cam_nor_physics_tpu_torch.entry import (build_coupled, build_step,
                                             build_zm_step, varied_zm_inputs)
from cam_nor_physics_tpu_torch.models.fv import dyn_comp as tdc
from cam_nor_physics_tpu_torch.models.physics.constituents import \
    default_registry
from cam_nor_physics_tpu_torch.models.physics.zm_conv_intr import \
    zm_conv_tend
from cam_nor_physics_tpu_torch.parallel.mesh import make_mesh
from cam_nor_physics_tpu_torch.utils.config import FVConfig, ZMConfig

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "flax", "cam_nor_physics_tpu"}


def _port_sources():
    files = sorted((REPO / "cam_nor_physics_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_nothing_of_jax():
    files = _port_sources()
    assert len(files) > 15
    bad = {str(p.relative_to(REPO)): sorted(_imported_roots(p) & FORBIDDEN)
           for p in files if _imported_roots(p) & FORBIDDEN}
    assert bad == {}


# the coupled step's modules (each must exist and be scanned)
COUPLED_MODULES = (
    "utils/config.py", "ops/fill.py", "models/physics/state.py",
    "models/physics/physics_buffer.py", "models/physics/check_energy.py",
    "models/coupling/camsrfexch.py", "models/coupling/surface_fluxes.py",
    "models/coupling/dp_coupling.py", "models/physics/dadadj.py",
    "models/physics/convect_diagnostics.py",
    "models/physics/cloud_fraction.py",
    "models/physics/vertical_diffusion.py", "models/physics/radiation.py",
    "models/physics/cam_diagnostics.py", "models/physics/physpkg.py",
    "models/atm_comp.py", "bench.py", "convert.py", "entry.py")


# modules that need no torch themselves
TORCH_FREE = ("utils/config.py", "cli.py", "utils/histio_native.py",
              "utils/ckptio_native.py", "models/physics/oslo_aero.py",
              "parallel/__init__.py")

# the driver's modules (each must exist and be scanned)
DRIVER_MODULES = (
    "driver.py", "cli.py", "utils/timing.py", "utils/history.py",
    "utils/histio_native.py", "utils/ckptio_native.py",
    "utils/checkpoint.py", "models/physics/check_tracers.py",
    "ops/geopotential.py")


# ZM's in-plume microphysics and the modal aerosol (each must exist and be
# scanned)
MICROP_MODULES = (
    "models/physics/zm_microphysics.py", "models/physics/zm_conv.py",
    "models/physics/zm_conv_intr.py",
    "models/physics/modal_aero_wateruptake.py",
    "models/physics/modal_aer_opt.py", "models/physics/oslo_aero.py")


# the dycore's options and the model's other modes (each must exist and be
# scanned)
MODES_MODULES = (
    "models/fv/dyn_comp.py", "ops/thermo.py",
    "models/physics/rayleigh_friction.py", "models/fv/ctem.py",
    "utils/climatology.py", "models/fv/baroclinic_wave.py",
    "models/fv/inidat.py", "models/fv/metdata.py", "models/scam.py")


# the multi-device modules (each must exist and be scanned)
PARALLEL_MODULES = (
    "parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py",
    "parallel/shard_stencil.py")


@pytest.mark.parametrize("module",
                         COUPLED_MODULES + DRIVER_MODULES + MICROP_MODULES +
                         MODES_MODULES + PARALLEL_MODULES)
def test_coupled_modules_are_scanned(module):
    path = REPO / "cam_nor_physics_tpu_torch" / module
    assert path in _port_sources()
    assert not _imported_roots(path) & FORBIDDEN
    assert "torch" in _imported_roots(path) or module in TORCH_FREE


def _runs_make_or_writes_native(path):
    """The string constants of a module (docstrings aside) that name
    `make` or a path under native/."""
    tree = ast.parse(path.read_text(), str(path))
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            v = node.value.strip()
            if v == "make" or v.startswith("make ") or "native/" in v \
                    or v.endswith(".so") and "native" in v:
                bad.append(v)
    return bad


def test_port_runs_no_make_and_writes_nothing_under_native(tmp_path):
    bad = {str(p.relative_to(REPO)): _runs_make_or_writes_native(p)
           for p in _port_sources() if _runs_make_or_writes_native(p)}
    assert bad == {}
    from cam_nor_physics_tpu_torch.utils import histio_native
    assert histio_native.BUILD == REPO / "cam_nor_physics_tpu_torch" / \
        "build"
    assert histio_native.NATIVE == REPO / "native"
    probe = tmp_path / "probe.py"
    probe.write_text("import subprocess\nsubprocess.run(['make', '-C', "
                     "'native'])\n")
    assert _runs_make_or_writes_native(probe) == ["make"]


def test_import_scan_catches_the_jax_package(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import cam_nor_physics_tpu_torch\n"
                     "from cam_nor_physics_tpu.ops import tp_core\n")
    assert _imported_roots(probe) & FORBIDDEN == {"cam_nor_physics_tpu"}


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        build_step(8, 8, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.dynstate_from_numpy({f: np.zeros(1)
                                     for f in convert.STATE_FIELDS})


def test_zm_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        build_zm_step(8, 26)
    with pytest.raises(RuntimeError, match="cuda"):
        varied_zm_inputs(8, 26)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.physstate_from_numpy({f: np.zeros(1)
                                      for f in convert.PHYS_STATE_FIELDS})


def test_coupled_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cam_nor_physics_tpu_torch import bench
    from cam_nor_physics_tpu_torch.models.atm_comp import AtmModel
    with pytest.raises(RuntimeError, match="cuda"):
        build_coupled(8, 6, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        AtmModel.create(8, 6, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run_coupled("small")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main({"BENCH_COUPLED": "1", "BENCH_SMALL": "1"})


def test_driver_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cam_nor_physics_tpu_torch.cli import run_main
    from cam_nor_physics_tpu_torch.driver import quick_run
    with pytest.raises(RuntimeError, match="cuda"):
        quick_run(8, 6, 4, nsteps=1, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        run_main(["--nsteps", "1", "--out", str(tmp_path)])


def test_mode_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cam_nor_physics_tpu_torch.models import scam
    from cam_nor_physics_tpu_torch.models.fv import (baroclinic_wave,
                                                     inidat, metdata)
    from cam_nor_physics_tpu_torch.models.fv.grid import make_grid
    from cam_nor_physics_tpu_torch.models.fv.vertical import \
        hybrid_coefficients
    from cam_nor_physics_tpu_torch.utils.climatology import climo_init
    grid = make_grid(8, 6, 2, device="cpu")
    coord = hybrid_coefficients(2, device="cpu")
    st, phis = baroclinic_wave.jw_baroclinic_wave(grid, coord, device="cpu")
    ic, met = str(tmp_path / "ic.nc"), str(tmp_path / "met.nc")
    inidat.write_inidat(ic, st, phis, grid, coord)
    z = np.zeros((2, 2, 6, 8))
    metdata.save_metdata_netcdf(met, [0.0, 1.0], z, z, z + 250.0,
                                np.full((2, 6, 8), 1e5), [z])
    iop = str(tmp_path / "iop.nc")
    scam.save_iop_netcdf(iop, [0.0, 1.0], np.zeros((2, 2)),
                         np.zeros((2, 2)), np.zeros((2, 2)))
    for call in (lambda: baroclinic_wave.jw_baroclinic_wave(grid, coord),
                 lambda: inidat.read_inidat(ic, grid, coord),
                 lambda: metdata.load_metdata_netcdf(met, coord),
                 lambda: scam.load_iop_netcdf(iop),
                 lambda: scam.scam_init_pbuf(4, 26),
                 lambda: scam.ScamForcing.zeros(4, 26),
                 lambda: climo_init(26, 6)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_coupled_state_convert_round_trip():
    _, step, state, _ = build_coupled(12, 8, 4, torch.float64, "cpu",
                                      fv_cfg=FVConfig(nsplit=2, nspltrac=1))
    state, _, _ = step(state, first_step=True)
    fields = convert.atmstate_to_numpy(state)
    assert fields["nstep"] == 1
    back = convert.atmstate_from_numpy(fields, "cpu")
    assert back.nstep.dtype == torch.int32 and back.pbuf.lifetimes == \
        state.pbuf.lifetimes
    again = convert.atmstate_to_numpy(back)
    for grp in ("dyn", "phys"):
        for f, a in fields[grp].items():
            np.testing.assert_array_equal(again[grp][f], a, f)
    for f, a in fields["pbuf"][0].items():
        np.testing.assert_array_equal(again["pbuf"][0][f], a, f)
    np.testing.assert_array_equal(again["phis"], fields["phis"])


def test_zm_conv_tend_microp_raises():
    """zm_conv_tend with microp, which raised until it was ported, runs
    and routes the microphysics: DNLFZM, DNIFZM, DP_CLDLIQ and DP_CLDICE
    into the pbuf, the zm_conv_micro_outfld family and the rates into the
    diagnostics (JAX parity: tests/test_torch_zm_microp.py)."""
    pstate, pbuf, forcing = varied_zm_inputs(4, 26, torch.float64, "cpu")
    out = zm_conv_tend(ZMConfig(microp=True), default_registry(), pstate,
                       pbuf, forcing["pblh"], forcing["tpert"],
                       forcing["landfrac"], 1800.0)
    d = out.diagnostics
    assert {"ZMFRZ", "ZMDCAPE", "WUZMSNUM", "CLDLIQZM", "ACTIV_N",
            "BERGN_M"} <= set(d)
    assert torch.equal(out.pbuf.get("DNIFZM"), d["DNIFZM"])
    assert torch.equal(out.pbuf.get("DP_CLDICE"), d["CLDICEZM"])
    assert float(d["ZMFRZ"].max()) > 0.0


def test_physics_convert_round_trip():
    step, _, _, _ = build_zm_step(8, 26, torch.float64, "cpu")
    pstate, pbuf, forcing = varied_zm_inputs(8, 26, torch.float64, "cpu")
    fields = convert.physstate_to_numpy(pstate)
    assert set(fields) == set(convert.PHYS_STATE_FIELDS)
    back = convert.physstate_to_numpy(convert.physstate_from_numpy(fields,
                                                                   "cpu"))
    for f in fields:
        np.testing.assert_array_equal(back[f], fields[f], f)
    pb_np, lifetimes = convert.pbuf_to_numpy(pbuf)
    pb_back = convert.pbuf_from_numpy(pb_np, lifetimes, "cpu",
                                      dtype=torch.float32)
    assert pb_back.lifetimes == pbuf.lifetimes
    assert pb_back.get("CLD").dtype == torch.float32
    np.testing.assert_array_equal(pb_back.get("CLD").double().numpy(),
                                  pb_np["CLD"].astype(np.float32))
    out = zm_conv_tend(ZMConfig(), default_registry(), pstate, pbuf,
                       forcing["pblh"], forcing["tpert"], forcing["landfrac"],
                       1800.0)
    flat = convert.zmtend_to_numpy(out)
    assert {"ptend.s", "ptend.q", "state1.t", "pbuf.ZM_MU", "pbuf.PREC_DP",
            "mcon", "jctop", "diag.CAPE", "diag.ZMDLIQ"} <= set(flat)
    np.testing.assert_array_equal(flat["pbuf.ZM_MU"],
                                  out.pbuf.get("ZM_MU").numpy())
    s1, _ = step(pstate, pbuf, forcing)
    np.testing.assert_array_equal(flat["state1.t"], s1.t.numpy())


def test_convert_round_trip():
    im, jm, km = 24, 16, 4
    jg = jgrid.make_grid(im, jm, km)
    jc = jvert.hybrid_coefficients(km)
    rng = np.random.default_rng(0)
    fields = {f: rng.standard_normal((km, jm, im))
              for f in ("u", "v", "pt", "delp")}
    fields["q"] = rng.uniform(size=(2, km, jm, im))
    back = convert.dynstate_to_numpy(convert.dynstate_from_numpy(fields,
                                                                 "cpu"))
    for f in convert.STATE_FIELDS:
        np.testing.assert_array_equal(back[f], fields[f], f)
    tables = {f: np.asarray(getattr(jg, f))
              for f in convert.GRID_TABLES + convert.GRID_SCALARS}
    grid = convert.grid_from_numpy(tables, "cpu")
    for f, a in convert.grid_to_numpy(grid).items():
        np.testing.assert_array_equal(a, tables[f], f)
    coord = convert.coord_from_numpy({f: getattr(jc, f)
                                      for f in convert.COORD_FIELDS}, "cpu")
    for f, a in convert.coord_to_numpy(coord).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jc, f)), f)
    f32 = convert.dynstate_from_numpy(fields, "cpu", dtype=torch.float32)
    assert f32.u.dtype == torch.float32


@pytest.mark.parametrize("option", ["am_correction", "am_fixer", "am_diag",
                                    "high_altitude"])
def test_unported_dyn_run_options_raise(option):
    """The AM and high-altitude options, which raised until they were
    ported, run: the fixer and the correction move u (the correction
    leaves delp as it was), am_diag returns its payload and
    high_altitude with no species (constant κ) leaves pt as without it
    (tests/test_torch_dyn_options.py holds each to JAX). mesh, which
    raised until it was ported, runs: a mesh of one rank gives the step
    without it bitwise, with the option on too; an object that is not a
    mesh raises TypeError (tests/test_torch_parallel.py holds meshes of
    several ranks)."""
    step, st, grid, coord, phis = build_step(12, 8, 2, torch.float64, "cpu")
    base = tdc.dyn_run(st, grid, coord, phis, FVConfig(), 1800.0)
    new, diags = tdc.dyn_run(st, grid, coord, phis,
                             FVConfig(**{option: True}), 1800.0,
                             return_diags=True)
    for f in ("u", "v", "pt", "delp", "q"):
        assert torch.isfinite(getattr(new, f)).all()
    if option == "am_fixer":
        assert not torch.equal(new.u, base.u)
    elif option == "am_correction":
        assert torch.equal(new.delp, base.delp)
        assert not torch.equal(new.u, base.u)
    elif option == "am_diag":
        assert {"AM_DU3S", "AM_DUFIX", "AM_TOTAL", "du3s",
                "du_fix_s"} <= set(diags)
        assert torch.equal(diags["du3s"], new.u - st.u)
    else:
        np.testing.assert_allclose(new.pt.numpy(), base.pt.numpy(),
                                   rtol=1e-9)
    one = make_mesh(device="cpu")
    on_mesh, mdiags = tdc.dyn_run(st, grid, coord, phis,
                                  FVConfig(**{option: True}), 1800.0,
                                  mesh=one, return_diags=True)
    for f in ("u", "v", "pt", "delp", "q"):
        assert torch.equal(getattr(on_mesh, f), getattr(new, f)), f
    assert set(mdiags) == set(diags)
    for k in diags:
        assert torch.equal(mdiags[k], diags[k]), k
    with pytest.raises(TypeError, match="Mesh"):
        tdc.dyn_run(st, grid, coord, phis, FVConfig(), 1800.0,
                    mesh=object())


def test_dyn_run_conserves_mass_without_floor_activations():
    """Four HS large steps of the port at 24x16x4: no thickness floor
    fires and global dry mass holds to 1e-12 (float64)."""
    step, st, grid, coord, phis = build_step(24, 16, 4, torch.float64, "cpu")
    w = grid.cosp.clone()
    w[0] = w[-1] = grid.acap / grid.im
    m0 = float((st.delp * w[:, None]).sum())
    cfg = FVConfig(nsplit=4, nspltrac=1)
    for _ in range(4):
        st, diags = tdc.dyn_run(st, grid, coord, phis, cfg, 1800.0,
                                filter_impl="matmul", return_diags=True)
        assert int(diags["floor_activations"]) == 0
        assert torch.isfinite(diags["omega"]).all()
    m1 = float((st.delp * w[:, None]).sum())
    assert abs(m1 - m0) / m0 < 1e-12
