"""The bench's health-check kernel: o = 2 x on one (8, 128) block.

Twin of the Pallas kernel `_k` in bench.py's `_PALLAS_PROBE`. `probe`
launches csrc/probe_kernels.cu for a CUDA tensor and takes `probe_ref`,
its plain PyTorch version, for a CPU tensor. There is no fallback between
the two: a kernel that does not build or launch raises.
The bench runs it in float32, as the Pallas probe ran; float64 takes the
same kernel. `probe.launches` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from . import cuda_build

SHAPE = (8, 128)       # the Pallas probe's one block


def probe_ref(x):
    """Plain version of `probe`: x * 2.0."""
    return x * 2.0


def _check(x):
    """The kernel takes one contiguous (8, 128) float32 or float64 block,
    on either device."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"probe: float32 or float64 expected, got "
                        f"{x.dtype}")
    if tuple(x.shape) != SHAPE or not x.is_contiguous():
        raise ValueError(f"probe: a contiguous {SHAPE} block expected, got "
                         f"{tuple(x.shape)}")


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_N = SHAPE[0] * SHAPE[1]
_ENTRY = {}         # dtype -> its C entry point, resolved at the first call


def _entry(dtype):
    """The C entry point for `dtype` (the library is built at first use)."""
    fn = _ENTRY[dtype] = getattr(cuda_build.library("probe_kernels"),
                                 "cam_probe_" + _SUFFIX[dtype])
    return fn


def probe(x):
    """2 x of one (8, 128) block, through the CUDA kernel for a CUDA
    tensor. A call costs three attribute tests, one allocation and one
    ctypes call: the entry point is resolved at the first call, and the
    stream is the raw handle (no Python stream object is built)."""
    if x.dtype not in _SUFFIX or x.shape != SHAPE or not x.is_contiguous():
        _check(x)
    if not x.is_cuda:
        return probe_ref(x)
    fn = _ENTRY.get(x.dtype) or _entry(x.dtype)
    out = torch.empty_like(x)
    rc = fn(x.data_ptr(), out.data_ptr(), _N,
            torch._C._cuda_getCurrentRawStream(x.get_device()))
    if rc != 0:
        raise RuntimeError(f"probe: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    probe.launches += 1
    return out


probe.launches = 0
