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
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"probe: float32 or float64 expected, got "
                        f"{x.dtype}")
    if tuple(x.shape) != SHAPE or not x.is_contiguous():
        raise ValueError(f"probe: a contiguous {SHAPE} block expected, got "
                         f"{tuple(x.shape)}")


def probe(x):
    """2 x of one (8, 128) block, through the CUDA kernel for a CUDA
    tensor."""
    _check(x)
    if not x.is_cuda:
        return probe_ref(x)
    out = torch.empty_like(x)
    lib = cuda_build.library("probe_kernels")
    fn = getattr(lib, "cam_probe_" +
                 ("f32" if x.dtype == torch.float32 else "f64"))
    rc = fn(x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe: CUDA kernel launch failed with "
                           f"cudaError {rc}")
    probe.launches += 1
    return out


probe.launches = 0
