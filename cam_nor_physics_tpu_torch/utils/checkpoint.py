"""Checkpoint / restart: the CAM restart-file role.

Twin of `cam_nor_physics_tpu.utils.checkpoint`. A checkpoint is a
directory with state.npz (one array leaf_i per leaf) and meta.json. The
leaves are the JAX driver's: `jax.tree.flatten` of the JAX AtmState, that
is dyn's u, v, pt, delp, q; phys's fields in PhysicsState order; the
pbuf's fields by sorted name; phis; nstep (0-d int32). The port writes
them in that order by explicit functions (`convert.atmstate_named_leaves`
and `atmstate_from_leaves`), so a checkpoint written by either package
restores into the other. A tuple (run_coupled's (state, sst)) is its
members' leaves in turn; a tensor is one leaf.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The leaves of an AtmState, a tensor, or a tuple/list of them, in
    the checkpoint's order."""
    from ..convert import atmstate_named_leaves
    from ..models.atm_comp import AtmState
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, AtmState):
        return [t for _, t in atmstate_named_leaves(tree)]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tree_leaves(x)]
    raise TypeError(f"no checkpoint leaves for {type(tree).__name__}")


def tree_unflatten(template, leaves):
    """`template`'s structure holding `leaves` (tree_leaves' order)."""
    from ..convert import atmstate_from_leaves
    from ..models.atm_comp import AtmState
    leaves = list(leaves)

    def build(tree, i):
        if isinstance(tree, torch.Tensor):
            return leaves[i], i + 1
        if isinstance(tree, AtmState):
            n = len(tree_leaves(tree))
            return atmstate_from_leaves(tree, leaves[i:i + n]), i + n
        if isinstance(tree, (tuple, list)):
            out = []
            for x in tree:
                y, i = build(x, i)
                out.append(y)
            return type(tree)(out), i
        raise TypeError(f"no checkpoint leaves for {type(tree).__name__}")

    out, n = build(template, 0)
    if n != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a template of {n}")
    return out


def save_checkpoint(path: str, state, meta: dict | None = None) -> None:
    """Write the coupled state and its metadata into the directory
    `path`."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "state.npz"),
             **{f"leaf_{i}": t.detach().cpu().numpy()
                for i, t in enumerate(tree_leaves(state))})
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta or {}, f)


def restore_checkpoint(path: str, template):
    """The checkpoint at `path` in the structure of `template`, each leaf
    in the template leaf's dtype and on its device (the reference's
    restart contract: same grid, same constituent set). A leaf count or
    shape that differs raises."""
    data = np.load(os.path.join(path, "state.npz"))
    leaves = tree_leaves(template)
    if len(leaves) != len(data.files):
        raise ValueError(
            f"checkpoint has {len(data.files)} leaves, template expects "
            f"{len(leaves)} — incompatible restart (grid/constituents?)")
    new = []
    for i, leaf in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != template "
                f"{tuple(leaf.shape)}")
        new.append(torch.as_tensor(arr, dtype=leaf.dtype,
                                   device=leaf.device).clone())
    return tree_unflatten(template, new)


def read_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)
