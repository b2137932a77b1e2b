"""Spectral bounds by power iteration (torch counterpart of
hyteg_tpu/numerictools/spectrum.py).

Reference: src/hyteg/solvers/numerictools/SpectrumEstimation.hpp:56
(estimateSpectralRadiusWithPowerIteration). Generic over an apply callable;
the Chebyshev glue in solvers/smoothers.py uses the same scheme specialized
to D^-1 A.
"""

from __future__ import annotations

from typing import Callable

import torch


def estimate_spectral_radius_op(apply_fn: Callable, dot_fn: Callable,
                                x0, iters: int = 20) -> torch.Tensor:
    """Power iteration for the dominant eigenvalue of apply_fn (a 0-dim
    tensor; nothing is read on the host)."""
    x = x0
    lam = torch.zeros((), dtype=torch.float32, device=x0.device)
    for _ in range(iters):
        y = apply_fn(x)
        lam = dot_fn(x, y) / torch.clamp(dot_fn(x, x), min=1e-300)
        nrm = torch.sqrt(dot_fn(y, y))
        x = y / torch.clamp(nrm, min=1e-300)
    return lam
