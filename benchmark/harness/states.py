"""The inputs a cell starts from, made by the benchmark from the seed, and
the passage of state between the program's classes and the reference's.

The initial state is the reference's `hs_initial_state` (the Held-Suarez
profile plus temperature noise), its noise drawn on the device from the
seed with a `torch.Generator`, made in float64 and rounded once to the
configuration's dtype: that rounded state is what both the program and
the reference start from.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

PORT = "cam_nor_physics_tpu_torch"
REF = "benchmark.reference"


class DeviceNormal:
    """`standard_normal(shape)` of numpy's Generator, drawn on `device`
    from `seed` (any integer below 2**64): what hs_initial_state takes as
    its `rng`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % 2**64)

    def standard_normal(self, shape):
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device, dtype=torch.float64)


def map_tensors(obj, fn):
    """`obj` with fn applied to every tensor in its dataclasses, dicts,
    lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _rebuild(obj, type(obj), fn)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    return obj


def _rebuild(obj, cls, fn):
    vals = {f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)}
    return cls(**vals)


def translate(obj, src: str, dst: str, fn=lambda t: t):
    """`obj`, a tree of dataclasses of package `src`, as the same tree of
    package `dst`'s classes of the same module path and name (the program's
    AtmState as the reference's, and back), with fn applied to every
    tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = type(obj).__module__
        if not mod.startswith(src + "."):
            raise TypeError(f"{type(obj).__qualname__} is not of {src}")
        cls = getattr(importlib.import_module(dst + mod[len(src):]),
                      type(obj).__name__)
        vals = {f.name: translate(getattr(obj, f.name), src, dst, fn)
                for f in dataclasses.fields(obj)}
        return cls(**vals)
    if isinstance(obj, dict):
        return {k: translate(v, src, dst, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(translate(v, src, dst, fn) for v in obj)
    return obj


def to_port(obj, dtype):
    """A reference tree as the program's, its floating tensors in dtype."""
    return translate(obj, REF, PORT, lambda t: _cast(t, dtype))


def to_ref(obj, dtype):
    """A program tree as the reference's, its floating tensors copied into
    dtype (a copy even where the dtype is the same)."""
    return translate(obj, PORT, REF, lambda t: _cast(t, dtype).clone())


def _cast(t, dtype):
    return t.to(dtype) if t.is_floating_point() else t


def initial_dyn(config: dict, seed: int, device) -> object:
    """The reference's DynState the cell starts from, in float64 with the
    values of the configuration's dtype (rounded once): the HS profile
    with noise from the seed, and, where the configuration has moisture
    ("q_init": "build_coupled"), q = 1e-6 but vapour 1e-2 (delp / max
    delp)**2, the port's coupled configuration."""
    from ..reference.models.fv.grid import make_grid
    from ..reference.models.fv.held_suarez import hs_initial_state
    from ..reference.models.fv.vertical import hybrid_coefficients
    g = config["grid"]
    dev = torch.device(device)
    grid = make_grid(g["im"], g["jm"], g["km"], dtype=torch.float64,
                     device=dev)
    coord = hybrid_coefficients(g["km"], dtype=torch.float64, device=dev)
    nq = config.get("nq", 1)
    s = hs_initial_state(grid, coord, nq=nq, pert=config["noise_k"],
                         rng=DeviceNormal(seed, dev))
    if config.get("q_init") == "build_coupled":
        q = torch.full_like(s.q, 1e-6)
        q[0] = 1e-2 * (s.delp / s.delp.max()) ** 2
        s = s.replace(q=q)
    dtype = getattr(torch, config["dtype"])
    return map_tensors(s, lambda t: t.to(dtype).to(torch.float64))
