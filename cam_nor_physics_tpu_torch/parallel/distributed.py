"""Multi-process runtime glue: the process group, the global mesh and
strip states built rank by rank.

Twin of `cam_nor_physics_tpu.parallel.distributed`. JAX initialises
jax.distributed once a host and builds a global mesh over every host's
devices; here each rank is one process with one device, the group comes
from `torch.distributed.init_process_group` (NCCL on the card, gloo on
the CPU), and a multi-GPU host starts one process a card with
`torchrun --nproc-per-node N`, whose MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK and LOCAL_RANK `ensure_initialized` reads.

A single process stays as it was: `ensure_initialized()` with nothing
configured is a no-op returning False, and `global_mesh()` is then a mesh
of one.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import Mesh, _tree_map, make_mesh

RENDEZVOUS_TIMEOUT_S = 300.0   # a rendezvous that takes longer raises


def ensure_initialized(coordinator: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None) -> bool:
    """Initialise the default process group once a process.

    `coordinator` is an init method ("tcp://host:port", "file:///path")
    or "host:port"; by default torchrun's MASTER_ADDR and MASTER_PORT.
    `num_processes` and `process_id` default to WORLD_SIZE and RANK. On a
    card the group uses NCCL, after `torch.cuda.set_device(LOCAL_RANK)`
    (LOCAL_RANK defaults to the rank); on the CPU gloo. Returns True when
    more than one process takes part; with nothing configured it is a
    no-op returning False. A rendezvous that fails, or takes longer than
    RENDEZVOUS_TIMEOUT_S, raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR"):
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '')}"
    num = num_processes if num_processes is not None else \
        env.get("WORLD_SIZE")
    if coordinator is None and num is None:
        return False
    if coordinator is None or num is None:
        raise ValueError("ensure_initialized: a coordinator and a number "
                         "of processes are both needed (or torchrun's "
                         "MASTER_ADDR, MASTER_PORT and WORLD_SIZE)")
    rank = process_id if process_id is not None else env.get("RANK")
    if rank is None:
        raise ValueError("ensure_initialized: no process_id (or RANK)")
    rank, num = int(rank), int(num)
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    if torch.cuda.is_available():
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=coordinator, world_size=num, rank=rank,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    return num > 1


def global_mesh(x_shards: int = 1, device=None) -> Mesh:
    """The ('y', 'x') mesh over every rank of the job: latitude strips on
    contiguous ranks, so each halo goes to a neighbouring rank (on one
    host, the neighbouring card). `device` as make_mesh's."""
    return make_mesh(None, x_shards=x_shards, device=device)


def host_local_state(mesh: Mesh, make_local, global_shape_of):
    """A strip state built by each rank from its own rows only, so that no
    rank materialises the global state (read_inidat's scatter role).

    `make_local(pidx, pcount)` returns the tree of numpy arrays or
    tensors of latitude block `pidx` of `pcount` (the rank's y and the
    mesh's ny; rows [pidx·jm/pcount, (pidx+1)·jm/pcount));
    `global_shape_of(leaf, pidx, pcount)` the global shape of a leaf.
    Each leaf's rows must be its global rows over ny. Returns the tree
    on the mesh's device: the rank's strip of the global state."""
    pidx, pcount = mesh.y_index, mesh.ny
    local = make_local(pidx, pcount)
    dev = resolve_device(mesh.device)

    def check(leaf):
        t = torch.as_tensor(leaf)
        gshape = tuple(global_shape_of(leaf, pidx, pcount))
        want = gshape[:-2] + (gshape[-2] // pcount, gshape[-1])
        if len(gshape) < 2 or gshape[-2] % pcount or \
                tuple(t.shape) != want:
            raise ValueError(f"host_local_state: a leaf of shape "
                             f"{tuple(t.shape)} is not a strip of "
                             f"{gshape} over {pcount} ranks")
        return t.to(dev).contiguous()

    return _tree_map(check, _as_tensors(local))


def _as_tensors(tree):
    """numpy leaves of a dict/list/tuple tree as tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    return tree
