"""Stream-copy bandwidth probe (kernel P1).

Torch counterpart of the Pallas copy probes of the JAX package's
profiling scripts (scripts/prof_r5.py::bench_copy, prof_r5b.py,
kernel_probe.py::make_copy): dst = 2 * src over a flat f32 array, one
read and one write per element and nothing else. Its rate, counted as
8 B per element, is the measured device-memory ceiling that the stencil
kernels' roofline shares are taken against.

``stream_scale`` launches the CUDA kernel ``csrc/stream.cu`` for a CUDA
tensor and runs the plain version ``stream_scale_torch`` for a CPU
tensor.
"""

from __future__ import annotations

import torch

from . import build
from .p1_const_stencil import _check_cuda_input


def stream_scale_torch(src: torch.Tensor) -> torch.Tensor:
    """Plain version: 2 * src into a fresh tensor."""
    dst = torch.empty_like(src)
    torch.mul(src, 2.0, out=dst)
    return dst


def stream_scale(src: torch.Tensor) -> torch.Tensor:
    """dst = 2 * src for a contiguous f32 tensor of any shape.

    A CPU tensor runs the plain version; a CUDA tensor launches kernel P1
    (csrc/stream.cu; 16-byte vector loads and stores, grid-stride) and
    counts the launch in ``stream_scale.launches``."""
    if src.device.type == "cpu":
        return stream_scale_torch(src)
    _check_cuda_input("src", src, src.shape)
    if src.data_ptr() % 16:
        raise ValueError("src must be 16-byte aligned")
    dst = torch.empty_like(src)
    rc = build.library().hyteg_stream_scale(
        src.data_ptr(), dst.data_ptr(), src.numel(), build.current_stream())
    build.check_launch(rc, "stream_scale")
    stream_scale.launches += 1
    return dst


stream_scale.launches = 0
