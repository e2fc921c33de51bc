"""ctypes binding of the native asynchronous checkpoint writer
(native/ckptio.cpp).

Twin of `cam_nor_physics_tpu.utils.ckptio_native`. `AsyncCheckpointWriter`
hands a state's leaves to a C++ worker thread that writes them as an
uncompressed .npz (np.load reads it), so restart IO overlaps the
simulation. The on-disk layout is utils/checkpoint.py's: state.npz of
leaf_i arrays in the JAX driver's leaf order, and meta.json.

`write` takes every tensor to the host before it returns (a synchronous
copy), so the caller may overwrite the state right after, as the next
replay of a CUDA graph does. 0-d leaves stay 0-d (the step counter's
shape is part of the restart contract). The library is built as
histio_native's is; `try_native=False` takes np.savez on purpose.
"""

from __future__ import annotations

import ctypes
import json
import os

import numpy as np

from .checkpoint import tree_leaves
from .histio_native import native_library


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native_library("ckptio")))
    lib.ckptio_create.restype = ctypes.c_void_p
    lib.ckptio_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.ckptio_flush.argtypes = [ctypes.c_void_p]
    lib.ckptio_pending.argtypes = [ctypes.c_void_p]
    lib.ckptio_pending.restype = ctypes.c_int
    lib.ckptio_destroy.argtypes = [ctypes.c_void_p]
    return lib


class AsyncCheckpointWriter:
    """Checkpoints through the native worker (`try_native=True`) or
    np.savez (`try_native=False`). Call `flush()` before a reader opens a
    checkpoint."""

    def __init__(self, try_native: bool = True):
        self._lib = _load() if try_native else None
        self._h = self._lib.ckptio_create() if self._lib else None

    @property
    def native(self) -> bool:
        return self._h is not None

    def write(self, path: str, state, meta: dict | None = None) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta or {}, f)
        # np.asarray(order="C") keeps a 0-d leaf 0-d (ascontiguousarray
        # would make it (1,))
        leaves = [np.asarray(t.detach().cpu().numpy(), order="C")
                  for t in tree_leaves(state)]
        npz = os.path.join(path, "state.npz")
        if self._h is None:
            np.savez(npz, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
            return
        n = len(leaves)
        names = (ctypes.c_char_p * n)(
            *[f"leaf_{i}".encode() for i in range(n)])
        dts = (ctypes.c_char_p * n)(*[a.dtype.str.encode() for a in leaves])
        nds = (ctypes.c_int * n)(*[a.ndim for a in leaves])
        flat_shape: list[int] = []
        for a in leaves:
            flat_shape += list(a.shape)
        shps = (ctypes.c_int64 * len(flat_shape))(*flat_shape)
        datas = (ctypes.c_void_p * n)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in leaves])
        # the C side copies the arrays inside the call; they stay alive
        # through it
        self._keepalive = leaves
        self._lib.ckptio_write(self._h, npz.encode(), n, names, dts, nds,
                               shps, datas)

    def pending(self) -> int:
        return self._lib.ckptio_pending(self._h) if self._h else 0

    def flush(self) -> None:
        if self._h:
            self._lib.ckptio_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ckptio_destroy(self._h)
            self._h = None
