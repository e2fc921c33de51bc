"""The port's multi-process glue (parallel/distributed.py,
parallel/mesh.py, parallel/shard_stencil.py's rules) on the CPU.

- In one process: ensure_initialized() with nothing configured is a no-op
  returning False, and a rendezvous that fails raises; make_mesh and global_mesh are a (1, 1) mesh there,
  make_mesh refuses n_devices other than the world and an x_shards that
  does not divide it; use_sharded_pallas and use_strips follow JAX's
  rules (y sharded, x not; jm % ny == 0 and jm / ny >= 8) and raise
  TypeError for an object that is not a mesh; strip_extent gives the
  extended strips' rows; a state cut into strips and gathered back is
  the state; the three stencils on the strips of 2, 4 and 8 ranks
  (halos cut from the whole slab, shard_stencil.cut_strip and
  strip_call, the computation every rank makes after its exchange) and
  reassembled equal the whole-slab stencils bitwise, pole rows too.
- Two ranks (tests/torch_port_parallel_worker.py "mesh2", gloo over a
  file:// store, a mesh from global_mesh()): one dyn_run step at 24x16x4
  (8 rows a rank: every stencil call on a strip), reassembled, within
  rtol 1e-10, atol 1e-11 (tests/test_distributed.py:24-87) of the JAX
  package's single-device step (tests/torch_port_parallel_ref.py in a
  fresh interpreter while the ranks run) and of the port's single-rank
  step.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_port_parallel_cases as cases
from cam_nor_physics_tpu_torch.entry import build_step
from cam_nor_physics_tpu_torch.parallel import mesh as pmesh
from cam_nor_physics_tpu_torch.parallel import shard_stencil as ss
from cam_nor_physics_tpu_torch.parallel.distributed import (
    ensure_initialized, global_mesh)
from test_torch_parallel import jax_dyn, ranks_and
from torch_port_util import reference_processes

pytest_plugins = ("torch_port_plugin",)

torch.set_num_threads(1)


def _mesh(ny, nx=1):
    """A mesh of the given shape as seen by rank 0 (no process group)."""
    return pmesh.Mesh(devices=np.arange(ny * nx).reshape(ny, nx), rank=0,
                      device=torch.device("cpu"))


def test_single_process_init_is_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert ensure_initialized() is False
    assert not dist.is_initialized()


def test_failed_rendezvous_raises(tmp_path, monkeypatch):
    """A half-configured rendezvous and one gloo refuses raise, and leave
    no process group."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        ensure_initialized(None, 2, 1)
    with pytest.raises(ValueError, match="coordinator"):
        ensure_initialized(f"file://{tmp_path / 'a'}", None, 0)
    with pytest.raises(RuntimeError, match="rank"):
        ensure_initialized(f"file://{tmp_path / 'b'}", 2, 5)
    assert not dist.is_initialized()


def test_meshes_of_one_process():
    mesh = pmesh.make_mesh(device="cpu")
    assert mesh.shape == {"y": 1, "x": 1}
    assert mesh.axis_names == ("y", "x")
    assert mesh.devices.size == 1 and mesh.device.type == "cpu"
    assert global_mesh(device="cpu").shape == {"y": 1, "x": 1}
    with pytest.raises(ValueError, match="n_devices"):
        pmesh.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="x_shards"):
        pmesh.make_mesh(1, x_shards=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pmesh.make_mesh()


def test_strip_rules():
    assert not ss.use_sharded_pallas(None)
    assert not ss.use_sharded_pallas(_mesh(1))
    assert ss.use_sharded_pallas(_mesh(2))
    assert not ss.use_sharded_pallas(_mesh(2, 2))
    with pytest.raises(TypeError, match="Mesh"):
        ss.use_sharded_pallas(object())
    assert ss.use_strips(_mesh(4), 64) and ss.use_strips(_mesh(2), 16)
    assert not ss.use_strips(_mesh(4), 24)       # 6 rows a strip
    assert not ss.use_strips(_mesh(3), 32)       # rows do not split
    assert not ss.use_strips(_mesh(1), 64)
    assert ss.strip_extent(64, 0, 4) == (0, 21, 0)
    assert ss.strip_extent(64, 1, 4) == (11, 37, 5)
    assert ss.strip_extent(64, 3, 4) == (43, 64, 5)
    with pytest.raises(ValueError, match="split"):
        _mesh(3).rows(32)


def test_shard_and_gather_state_in_one_process():
    """A mesh of one: shard_state and gather_state keep every leaf; a
    field's strip on rank 1 of a (4, 1) mesh is its rows 4..7 of 16, a
    column batch's its columns 4·im..8·im; state_shardings names them."""
    _, st, _, _, _ = build_step(12, 16, 2, torch.float64, "cpu")
    one = pmesh.make_mesh(device="cpu")
    for f in cases.FIELDS:
        assert torch.equal(getattr(pmesh.shard_state(st, one), f),
                           getattr(st, f))
        assert torch.equal(getattr(pmesh.gather_state(st, one), f),
                           getattr(st, f))
    r1 = dataclasses.replace(_mesh(4), rank=1)
    strip = pmesh.shard_state(st, r1)
    assert torch.equal(strip.q, st.q[..., 4:8, :])
    cols = torch.arange(16 * 12 * 3.0).reshape(16 * 12, 3)
    assert torch.equal(pmesh.take_cols(cols, r1, 16, 12), cols[48:96])
    specs = pmesh.state_shardings(r1, st)
    assert specs.delp == (None, "y", None)
    assert specs.q == (None, None, "y", None)
    assert pmesh.constrain(strip, one) is not None


@pytest.mark.parametrize("ny", [2, 4, 8])
def test_strips_reassemble_the_whole_slab_bitwise(ny):
    whole = cases.stencil_whole()
    for name, args in cases.stencil_inputs().items():
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        scalars = args[len(tensors):]
        rows = cases.STENCIL_SHAPE[1] // ny
        parts = [ss.strip_call(name, ss.cut_strip(tensors, y, ny), scalars,
                               y, rows) for y in range(ny)]
        parts = [cases.outputs(p) for p in parts]
        for i, w in enumerate(whole[name]):
            got = torch.cat([p[i] for p in parts], -2)
            assert torch.equal(got, w), (name, i, ny)


def test_two_process_dyn_run_matches_single_rank(tmp_path):
    def here():
        got, outs = reference_processes(
            tmp_path / "jax", "torch_port_parallel_ref.py",
            [("parallel", {"dyn": ("dyn", cases.dyn_jax_cases(
                cases.TWO_RANK_SHAPE))})],
            lambda _: cases.dyn_whole(cases.TWO_RANK_SHAPE), None)
        return {"jax": jax_dyn(outs[0]["dyn"]["matmul"]),
                "port": {k: v.numpy() for k, v in got.items()}}

    want, outs = ranks_and("mesh2", 2, tmp_path, here)
    jm = cases.TWO_RANK_SHAPE[1]
    for ref, w in want.items():
        assert set(w) == set(cases.FIELDS) | {"omega"}
        for f, v in w.items():
            got = np.concatenate([o["dyn"][f] for o in outs], -2)
            assert np.isfinite(got).all(), f
            np.testing.assert_allclose(got, v, rtol=1e-10, atol=1e-11,
                                       err_msg=f"{ref} {f}")
    for o in outs:
        # 8 rows a rank and 5 halo rows on the side away from its pole
        assert {"transport3d", "vort_flux3d", "tracer_div3d"} <= \
            set(o["dyn_rows"])
        for name, n in o["dyn_rows"].items():
            assert (n == jm // 2 + 5).all(), name
