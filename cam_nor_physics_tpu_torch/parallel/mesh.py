"""Device mesh and the resident layout of the port's latitude strips.

Twin of `cam_nor_physics_tpu.parallel.mesh`. JAX places a state on a
('y', 'x') mesh of devices and lets XLA's SPMD partitioner split the step
from the shardings. PyTorch has no partitioner, so here a `Mesh` is the
ranks of a torch.distributed process group (one rank a device) laid out
as (ny, nx), rank = y·nx + x, and a state on it is each rank's own part,
a *strip state*, in JAX's resident layout:

  - a (..., jm, im) field: rows [lo, hi) of the rank's y (JAX's
    P(..., 'y', None)), `field_spec`;
  - a column batch (its first axis ncol = jm·im, row-major over y, as
    d_p_coupling flattens): columns [lo·im, hi·im) (JAX's P('y'));
  - anything else (scalars, level tables, the step counter) whole.

Ranks along x hold the same rows: x is replicated in the port's layout
(JAX can shard longitude on x; the port's x ranks compute the same
strip), so `make_mesh(x_shards=2)` runs and gives the answers of
x_shards=1. In a world of one process a mesh is (1, 1), and its
collectives are no-ops.

`shard_state` cuts a whole state into the rank's strip, `gather_state`
assembles the whole state from every rank's strip (an all-gather over the
ranks of one x), `constrain` checks a strip state's layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

_Y_GROUPS = {}          # (ny, nx) -> this rank's y process group


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ('y', 'x') mesh of ranks: `devices` the (ny, nx) array of ranks,
    `rank` this process's, `device` where its tensors live, `y_group` the
    process group of the ranks that share its x (None: the default
    group)."""

    devices: np.ndarray
    rank: int
    device: torch.device
    y_group: object = None
    axis_names = ("y", "x")

    @property
    def shape(self) -> dict:
        ny, nx = self.devices.shape
        return {"y": ny, "x": nx}

    @property
    def ny(self) -> int:
        return self.devices.shape[0]

    @property
    def y_index(self) -> int:
        return self.rank // self.devices.shape[1]

    def rank_at(self, y: int) -> int:
        """The rank at row y of this rank's x."""
        return int(self.devices[y, self.rank % self.devices.shape[1]])

    def rows(self, jm: int) -> tuple[int, int]:
        """[lo, hi): the latitude rows of this rank's strip."""
        if jm % self.ny:
            raise ValueError(f"jm={jm} rows do not split over ny={self.ny} "
                             f"ranks")
        n = jm // self.ny
        return self.y_index * n, (self.y_index + 1) * n

    def take_rows(self, a, axis: int = -2):
        """This rank's rows of the whole tensor `a` along `axis`."""
        lo, hi = self.rows(a.shape[axis])
        return a.narrow(axis, lo, hi - lo).contiguous()

    def gather_rows(self, a, axis: int = -2):
        """The whole tensor from every rank's rows `a` along `axis` (an
        all-gather over the ranks of this x)."""
        if self.ny == 1:
            return a
        a = a.contiguous()
        parts = [torch.empty_like(a) for _ in range(self.ny)]
        dist.all_gather(parts, a, group=self.y_group)
        return torch.cat(parts, axis)

    def psum(self, t):
        """The sum of `t` over the ranks of this x (an all_reduce)."""
        if self.ny == 1:
            return t
        out = t.clone()
        dist.all_reduce(out, group=self.y_group)
        return out


def make_mesh(n_devices: int | None = None, x_shards: int = 1,
              device=None) -> Mesh:
    """A ('y', 'x') mesh over the ranks of the default process group
    (latitude strips on y, x replicated), one rank a device; in a process
    without a group, a mesh of one. `n_devices`, where given, must be the
    number of ranks. `device`: the rank's device; by default the current
    CUDA device under NCCL, the CPU under gloo, and without a process
    group the card (raises where there is none)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh: a mesh spans the {world} ranks of the "
                         f"process group, got n_devices={n_devices}")
    if n % x_shards:
        raise ValueError(f"{n} devices not divisible by x_shards={x_shards}")
    ny, nx = n // x_shards, x_shards
    if device is None:
        if dist.is_initialized() and dist.get_backend() != "nccl":
            device = "cpu"
        elif torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = "cuda"
    group = None
    if nx > 1 and ny > 1:
        if (ny, nx) not in _Y_GROUPS:
            # every rank makes every group, in the same order
            groups = [dist.new_group([y * nx + x for y in range(ny)])
                      for x in range(nx)]
            _Y_GROUPS[(ny, nx)] = groups[rank % nx]
        group = _Y_GROUPS[(ny, nx)]
    return Mesh(devices=np.arange(n).reshape(ny, nx), rank=rank,
                device=resolve_device(device), y_group=group)


def field_spec(ndim: int) -> tuple:
    """The layout of a (..., jm, im) field: latitude on 'y', longitude
    replicated (None), JAX's PartitionSpec as a tuple."""
    return (None,) * (ndim - 2) + ("y", None)


def _tree_map(fn, x):
    """`fn` on every tensor of a tree of dataclasses, dicts, lists and
    tuples."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def _dims(state) -> tuple[int, int]:
    """(rows, im) of a dycore or coupled state's (..., rows, im) fields."""
    dyn = getattr(state, "dyn", state)
    return tuple(dyn.delp.shape[-2:])


def _spec(a, rows: int, im: int):
    """'rows' for a (..., rows, im) field, 'cols' for a batch of rows·im
    columns, None for a leaf kept whole."""
    if a.dim() >= 2 and tuple(a.shape[-2:]) == (rows, im):
        return "rows"
    if a.dim() >= 1 and a.shape[0] == rows * im:
        return "cols"
    return None


def state_shardings(mesh: Mesh, state):
    """The layout of each leaf of a whole state: field_spec for its
    (..., jm, im) fields, ('y',) for its column batches, () for the
    leaves kept whole."""
    jm, im = _dims(state)

    def one(a):
        kind = _spec(a, jm, im)
        return field_spec(a.dim()) if kind == "rows" else \
            ("y",) if kind == "cols" else ()
    return _tree_map(one, state)


def shard_state(state, mesh: Mesh, jm: int | None = None,
                im: int | None = None):
    """This rank's strip of a whole state: a DynState or an AtmState, or
    any tree of tensors (a PhysicsState, a CamIn) given the grid's jm and
    im."""
    if jm is None:
        jm, im = _dims(state)
    lo, hi = mesh.rows(jm)

    def one(a):
        kind = _spec(a, jm, im)
        if kind == "rows":
            return a[..., lo:hi, :].contiguous()
        if kind == "cols":
            return a[lo * im:hi * im].contiguous()
        return a
    return _tree_map(one, state)


def gather_state(state, mesh: Mesh):
    """The whole state from every rank's strip `state` (an all-gather over
    the ranks of this x; every rank gets it)."""
    rows, im = _dims(state)

    def one(a):
        kind = _spec(a, rows, im)
        if kind == "rows":
            return mesh.gather_rows(a, -2)
        if kind == "cols":
            return mesh.gather_rows(a, 0)
        return a
    return _tree_map(one, state)


def take_cols(a, mesh: Mesh, jm: int, im: int):
    """This rank's columns of a whole column batch `a`."""
    lo, hi = mesh.rows(jm)
    return a[lo * im:hi * im].contiguous()


def constrain(state, mesh: Mesh):
    """A strip state checked against the mesh's layout: its fields hold a
    strip's rows (the same count on every rank) and its leaves are
    contiguous, as the kernels take them. Raises where a leaf is not."""
    rows, im = _dims(state)
    if mesh.ny > 1:
        n = torch.tensor([rows], dtype=torch.int64, device=mesh.device)
        if int(mesh.psum(n)) != rows * mesh.ny:
            raise ValueError("constrain: the ranks hold strips of "
                             "different heights")

    def one(a):
        if not a.is_contiguous():
            raise ValueError(f"constrain: a leaf of shape "
                             f"{tuple(a.shape)} is not contiguous")
        return a
    return _tree_map(one, state)
