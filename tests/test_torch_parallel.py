"""The port's multi-device meshes (parallel/, cd_step/dyn_run/atm_step
with mesh=) against the JAX package's single-device runs and the port's
own single-rank runs, float64 on the CPU.

One spawn of four ranks for the module (tests/torch_port_parallel_worker.py
"mesh4", gloo over a file:// store in a temporary directory; no JAX),
whose results the tests below share, each case a test of its own. While
the ranks run, JAX's single-device runs of the same inputs are computed
in three fresh interpreters (tests/torch_port_parallel_ref.py through
torch_port_util.reference_processes: the stencils, dyn_run and the HS
steps in one, each coupled shape in one), and the port's single-rank
runs here. The reassembled strips are held to JAX's at JAX's own
decomposition tolerances (tests/test_parallel.py, test_distributed.py),
and to the port's single-rank runs at the same tolerances:

- the three sharded stencils at 48x64x4 (16 rows a rank: halo exchange,
  the kernel on the extended strip, interior rows kept; the edge ranks'
  pole rows from their own strips) within rtol/atol 1e-12, and every
  stencil call of the ranks on a strip (16 + 2·5 rows, 16 + 5 at an
  edge), none on the whole slab;
- dyn_run(mesh=) at 48x64x4 within rtol 1e-10, atol 1e-10 of each
  field's max, with the "matmul" filter and with "fft" (under a mesh the
  unfused step with the FFT filter; without one the port's "fft" takes
  the fused step, JAX's use_pallas=False the unfused one); the stencils
  on strips;
- dyn_run + hs_forcing on a 2x2 mesh with x_shards=2 at 32x24x4, two
  steps, within rtol/atol 1e-12 (x replicated: the whole-slab
  stencils, the same on every x);
- the coupled atm_step, two steps, within 1e-11 of each field's scale
  (at least 1), phys.t within atol 1e-10, TEGMEAN within rtol 1e-12: at
  32x24x4 (6 rows a rank: the dycore's whole-slab path) and at 32x32x4
  (8 rows a rank: the stencils on strips); the physics on each rank's
  columns, the energy fixer's and TEGMEAN's sums all-reduced;
- host_local_state: each rank's rows, assembled exactly.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_parallel_cases as cases
from cam_nor_physics_tpu_torch.parallel import shard_stencil as ss
from torch_port_util import reference_processes

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)

WORLD = 4


def ranks_and(mode, world, root, here, timeout=600):
    """Start `world` ranks of tests/torch_port_parallel_worker.py in
    `mode` (a file:// store under `root`), run `here()` meanwhile, and
    return (here's result, the ranks' results in rank order)."""
    root = Path(root)
    worker = Path(__file__).with_name("torch_port_parallel_worker.py")
    init = f"file://{root / 'store'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), mode, str(r), str(world), init,
         str(root)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        got = here()
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = []
    for r in range(world):
        with open(root / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return got, outs


def _jax_jobs():
    """tests/torch_port_parallel_ref.py's jobs: {case: (mode, inputs)}."""
    return [("parallel", {
        "stencils": ("stencils", cases.stencil_jax_cases()),
        "dyn": ("dyn", cases.dyn_jax_cases(cases.DYN_SHAPE,
                                           ("matmul", "fft"))),
        "xshards": ("hs", cases.hs_jax_cases())}),
            ("parallel", {"coupled": ("coupled", cases.coupled_jax_cases(
                cases.COUPLED_SHAPE))}),
            ("parallel", {"coupled_strip": ("coupled",
                                            cases.coupled_jax_cases(
                                                cases.COUPLED_STRIP_SHAPE))})]


def _whole(_):
    return dict(
        stencils={f"{k}{i}": v for k, vs in cases.stencil_whole().items()
                  for i, v in enumerate(vs)},
        dyn=cases.dyn_whole(cases.DYN_SHAPE),
        dyn_fft=cases.dyn_whole(cases.DYN_SHAPE, "fft"),
        xshards=cases.hs_steps_whole(),
        coupled=cases.coupled_whole(),
        coupled_strip=cases.coupled_whole(cases.COUPLED_STRIP_SHAPE))


def jax_dyn(out):
    """run_dyn's result for one option set, keyed as dyn_whole's."""
    return dict({f: out[f] for f in cases.FIELDS}, omega=out["diag.omega"])


def _np(tree):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": JAX's runs, "port": the single-rank runs} by case, and the
    ranks' results in rank order."""
    root = tmp_path_factory.mktemp("mesh4")

    def here():
        return reference_processes(root / "jax", "torch_port_parallel_ref.py",
                                   _jax_jobs(), _whole, None)

    (port, outs), ranks = ranks_and("mesh4", WORLD, root, here)
    jax = {k: v for out in outs for k, v in out.items()}
    jax["dyn_fft"] = jax_dyn(jax["dyn"]["fft"])
    jax["dyn"] = jax_dyn(jax["dyn"]["matmul"])
    return {"jax": jax, "port": {k: _np(v) for k, v in port.items()}}, ranks


def _assemble(outs, case, key, ranks=range(WORLD), axis=-2):
    return np.concatenate([outs[r][case][key] for r in ranks], axis)


def _references(want, case):
    """[(name, {key: array})]: JAX's run of `case`, then the port's."""
    return [(ref, want[ref][case]) for ref in ("jax", "port")]


def _assert_strips(outs, case, jm):
    """Every stencil call of every rank in `case` was on its strip: the
    strip's jm/WORLD rows and 5 halo rows a side (one at an edge)."""
    for r in range(WORLD):
        rows = outs[r][f"{case}_rows"]
        assert {"transport3d", "vort_flux3d", "tracer_div3d"} <= set(rows)
        edge = r in (0, WORLD - 1)
        for name, n in rows.items():
            assert (n == jm // WORLD + (5 if edge else 10)).all(), (r, name)


def test_sharded_stencils_match_whole_slab(runs):
    want, outs = runs
    for ref, w in _references(want, "stencils"):
        assert len(w) == 7
        for key, v in w.items():
            got = _assemble(outs, "stencils", key)
            np.testing.assert_allclose(got, v, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{ref} {key}")
    _assert_strips(outs, "stencil", cases.STENCIL_SHAPE[1])


def _check_dyn(runs, case):
    want, outs = runs
    for ref, w in _references(want, case):
        assert set(w) == set(cases.FIELDS) | {"omega"}
        for f, v in w.items():
            got = _assemble(outs, case, f)
            np.testing.assert_allclose(
                got, v, rtol=1e-10, atol=1e-10 * max(np.abs(v).max(), 1e-12),
                err_msg=f"{ref} {f}")
    _assert_strips(outs, case, cases.DYN_SHAPE[1])


def test_sharded_dyn_run_matches_single_rank(runs):
    _check_dyn(runs, "dyn")


def test_sharded_dyn_run_fft_filter_matches_single_rank(runs):
    _check_dyn(runs, "dyn_fft")


def test_x_shards_2_matches_single_rank(runs):
    """2x2 mesh: ranks 0, 1 hold rows [0, 12), ranks 2, 3 rows [12, 24);
    x unsharded in the strips' sense, so the whole-slab stencils run."""
    want, outs = runs
    for ref, w in _references(want, "xshards"):
        assert set(w) == set(cases.FIELDS)
        for f, v in w.items():
            for x in (0, 1):
                got = _assemble(outs, "xshards", f, ranks=(x, 2 + x))
                np.testing.assert_allclose(got, v, rtol=1e-12, atol=1e-12,
                                           err_msg=f"{ref} {f} x={x}")
    for r in range(WORLD):
        for name, n in outs[r]["xshards_rows"].items():
            assert (n == cases.HS_SHAPE[1]).all(), (r, name)


def _check_coupled(runs, case, jm):
    want, outs = runs
    for ref, w in _references(want, case):
        assert len(w) == cases.NSTEPS * (len(cases.FIELDS) + 2)
        for key, v in w.items():
            name = key.rsplit(".", 1)[0]
            msg = f"{ref} {key}"
            if name == "TEGMEAN":
                for r in range(WORLD):
                    np.testing.assert_allclose(outs[r][case][key], v,
                                               rtol=1e-12, err_msg=msg)
                continue
            got = _assemble(outs, case, key,
                            axis=0 if name == "phys.t" else -2)
            if name == "phys.t":
                np.testing.assert_allclose(got, v, atol=1e-10, err_msg=msg)
            else:
                scale = max(np.abs(v).max(), 1.0)
                assert np.abs(got - v).max() < 1e-11 * scale, msg
    if jm // WORLD >= ss.MIN_ROWS:
        _assert_strips(outs, case, jm)
        return
    # too few rows a rank for strips: the dycore's whole-slab path
    for r in range(WORLD):
        for name, n in outs[r][f"{case}_rows"].items():
            assert (n == jm).all(), (r, name)


def test_coupled_step_on_a_mesh_matches_single_rank(runs):
    _check_coupled(runs, "coupled", cases.COUPLED_SHAPE[1])


def test_coupled_step_on_strips_matches_single_rank(runs):
    _check_coupled(runs, "coupled_strip", cases.COUPLED_STRIP_SHAPE[1])


def test_host_local_state_assembles_exactly(runs):
    _, outs = runs
    full = cases.host_local_full()
    for r in range(WORLD):
        np.testing.assert_array_equal(outs[r]["host_local"]["whole"], full)
        np.testing.assert_array_equal(outs[r]["host_local"]["strip"],
                                      cases.strip_of(full, r, WORLD))
