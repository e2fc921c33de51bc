"""One rank of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py), over gloo on the CPU.

    python tests/torch_port_parallel_worker.py MODE RANK WORLD INIT OUT

Joins the process group through parallel.distributed.ensure_initialized
(INIT a file:// store), runs MODE's cases on its strips and writes
OUT/rank<RANK>.pkl, {case: {key: numpy array}}. Imports no JAX: the tests
hold these runs against the JAX package's single-device runs and the
port's own single-rank runs. Each case also records the latitude rows of
every stencil kernel call the rank made (`<case>_rows`).

"mesh4" (4 ranks): the three sharded stencils at 48x64x4; dyn_run(mesh=)
at 48x64x4 with the "matmul" and the "fft" filter; dyn_run + hs_forcing
on a 2x2 mesh with x_shards=2 at 32x24x4; the coupled atm_step at
32x24x4 (6 rows a rank: the whole-slab dycore) and 32x32x4 (8 rows a
rank: strips), two steps each; host_local_state. "mesh2" (2 ranks): one
dyn_run step at 24x16x4.
"""

import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cam_nor_physics_tpu_torch.ops import stencil_kernels as sk  # noqa: E402
from cam_nor_physics_tpu_torch.parallel import distributed as pdist  # noqa
from cam_nor_physics_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from cam_nor_physics_tpu_torch.parallel import shard_stencil as ss  # noqa

import torch_port_parallel_cases as cases  # noqa: E402


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree


def _spy_rows(seen):
    """Record the latitude rows of every stencil kernel call, through the
    strips (shard_stencil) or whole (cd_core, dyn_comp)."""
    from cam_nor_physics_tpu_torch.models.fv import cd_core, dyn_comp
    for name in ("transport3d", "vort_flux3d", "tracer_div3d"):
        real = getattr(sk, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.setdefault(_name, []).append(int(a[0].shape[-2]))
            return _real(*a, **kw)
        for mod in (sk, cd_core, dyn_comp):
            if hasattr(mod, name):
                setattr(mod, name, spy)


def mesh4(rank):
    out = {}
    mesh = pmesh.make_mesh(4)
    assert ss.use_sharded_pallas(mesh)
    seen = {}
    _spy_rows(seen)

    def rows():
        got = {k: np.array(v) for k, v in seen.items()}
        seen.clear()
        return got
    out["stencils"] = {f"{k}{i}": v for k, vs in
                       cases.stencil_strips(mesh).items()
                       for i, v in enumerate(vs)}
    out["stencil_rows"] = rows()
    out["dyn"] = cases.dyn_strip(mesh, cases.DYN_SHAPE)
    out["dyn_rows"] = rows()
    out["dyn_fft"] = cases.dyn_strip(mesh, cases.DYN_SHAPE, "fft")
    out["dyn_fft_rows"] = rows()
    mesh22 = pmesh.make_mesh(4, x_shards=2)
    out["xshards"] = cases.hs_steps_strip(mesh22)
    out["xshards_rows"] = rows()
    out["coupled"] = cases.coupled_strip(mesh)
    out["coupled_rows"] = rows()
    out["coupled_strip"] = cases.coupled_strip(mesh,
                                               cases.COUPLED_STRIP_SHAPE)
    out["coupled_strip_rows"] = rows()
    out["host_local"] = cases.host_local(mesh)
    return out


def mesh2(rank):
    mesh = pdist.global_mesh()
    assert mesh.shape == {"y": 2, "x": 1}
    seen = {}
    _spy_rows(seen)
    return {"dyn": cases.dyn_strip(mesh, cases.TWO_RANK_SHAPE),
            "dyn_rows": {k: np.array(v) for k, v in seen.items()}}


def main(mode, rank, world, init, root):
    torch.set_num_threads(1)
    multi = pdist.ensure_initialized(init, int(world), int(rank))
    assert multi and torch.distributed.get_backend() == "gloo"
    out = {"mesh4": mesh4, "mesh2": mesh2}[mode](int(rank))
    torch.distributed.barrier()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(_np(out), f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
