"""ctypes binding of the native asynchronous history writer
(native/histio.cpp).

Twin of `cam_nor_physics_tpu.utils.histio_native`. `AsyncHistoryWriter`
hands resolved history tapes to a C++ worker thread, so the NetCDF
serialisation overlaps the simulation (the reference's PIO role).

The library is built at first use with g++ from the repo's
native/histio.cpp into the package's build/ directory (git ignores it),
under a name that carries a hash of the source and the flags; native/ is
only read. With `try_native=True` a failed build raises with the
compiler's message. `try_native=False` takes the synchronous scipy writer
(utils/history.write_history_netcdf) on purpose; `.native` says which
route a writer takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent.parent
NATIVE = PKG.parent / "native"           # the C++ sources, read only
BUILD = PKG / "build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-pthread")


def native_library(stem: str) -> Path:
    """The path of lib<stem>.so built from native/<stem>.cpp into BUILD,
    compiled first if it is not there; raises RuntimeError with the
    compiler's output if the build fails."""
    src = NATIVE / f"{stem}.cpp"
    if not src.is_file():
        raise RuntimeError(f"{src} not found: the native writers are built "
                           f"from a checkout of the repo")
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    h.update(src.read_bytes())
    out = BUILD / f"lib{stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"building {src.name} with {cxx!r} failed: "
                           f"{err}") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src.name} with {cxx!r} failed "
                           f"(rc={proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(native_library("histio")))
    lib.histio_create.restype = ctypes.c_void_p
    lib.histio_write_tape.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.histio_flush.argtypes = [ctypes.c_void_p]
    lib.histio_destroy.argtypes = [ctypes.c_void_p]
    lib.histio_pending.argtypes = [ctypes.c_void_p]
    lib.histio_pending.restype = ctypes.c_int
    return lib


_VDIM_CODE = {"srf": 0, "mid": 1, "int": 2}
_STAGGER_CODE = {"fv_u_stagger": 3, "fv_v_stagger": 4}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


class AsyncHistoryWriter:
    """History tapes through the native worker (`try_native=True`) or the
    scipy writer (`try_native=False`). lats/lons in radians."""

    def __init__(self, registry, lats, lons, pver: int,
                 try_native: bool = True):
        self.registry = registry
        self.lats_rad = _host(lats).astype(np.float64)
        self.lons_rad = _host(lons).astype(np.float64)
        self.lats = np.ascontiguousarray(np.degrees(self.lats_rad))
        self.lons = np.ascontiguousarray(np.degrees(self.lons_rad))
        self.pver = pver
        self._lib = _load() if try_native else None
        self._h = self._lib.histio_create() if self._lib else None
        self._keepalive: list = []

    @property
    def native(self) -> bool:
        return self._h is not None

    def write(self, path: str, buf: dict, time_days: float) -> None:
        """Resolve `buf` on the host (a device read) and write it as one
        tape at `path`."""
        from .history import history_resolve, write_history_netcdf
        if self._h is None:
            write_history_netcdf(path, self.registry, buf, self.lats_rad,
                                 self.lons_rad, self.pver, time_days)
            return
        vals = history_resolve(self.registry, buf)
        jm, im = len(self.lats), len(self.lons)
        names, units, vdims, datas = [], [], [], []
        for name, val in vals.items():
            fd = self.registry.fields[name]
            if fd.gridname in _STAGGER_CODE:
                rows = jm - 1 if fd.gridname == "fv_u_stagger" else jm
                arr = np.asarray(val, np.float32).reshape(
                    self.pver, rows, im)
                code = _STAGGER_CODE[fd.gridname]
            elif fd.vdim == "srf":
                arr = np.asarray(val, np.float32).reshape(jm, im)
                code = _VDIM_CODE[fd.vdim]
            else:
                nk = self.pver if fd.vdim == "mid" else self.pver + 1
                arr = np.asarray(val, np.float32).T.reshape(nk, jm, im)
                code = _VDIM_CODE[fd.vdim]
            names.append(name.encode())
            units.append(fd.units.encode())
            vdims.append(code)
            datas.append(np.ascontiguousarray(arr))
        n = len(names)
        c_names = (ctypes.c_char_p * n)(*names)
        c_units = (ctypes.c_char_p * n)(*units)
        c_vdims = (ctypes.c_int * n)(*vdims)
        c_data = (ctypes.POINTER(ctypes.c_float) * n)(
            *[d.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
              for d in datas])
        # the C side copies the arrays inside the call; they stay alive
        # through it
        self._keepalive = datas
        self._lib.histio_write_tape(
            self._h, path.encode(), jm, im, self.pver,
            self.lats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self.lons.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            float(time_days), n, c_names, c_units, c_vdims, c_data)

    def pending(self) -> int:
        return self._lib.histio_pending(self._h) if self._h else 0

    def flush(self) -> None:
        if self._h:
            self._lib.histio_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.histio_destroy(self._h)
            self._h = None
