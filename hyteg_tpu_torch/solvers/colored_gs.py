"""Colored Gauss-Seidel / SOR smoothers; torch counterpart of
hyteg_tpu/solvers/colored_gs.py.

Reference: the generated colored GS/SOR kernels of
src/constant_stencil_operator/ (forward/backward sweeps per micro-grid).
Every P1 stencil direction has at least one odd component, so the 2^dim
parity classes (x%2, y%2, z%2) are an exact coloring: updating one color
at a time is a true Gauss-Seidel sweep, made of 2^dim masked residual
updates over the whole P1 block (each a full apply, kernel B2 on the
card).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from ..indexing import flat, micro


@functools.lru_cache(maxsize=None)
def parity_masks(level: int, dim: int, pitch: int | None = None):
    """Tuple of 2^dim float32 numpy masks over the flat (N, lanes) block,
    color c = sum_d ((x_d % 2) << d), each restricted to the simplex."""
    N = (1 << level) + 1
    pitch = N if (pitch is None or dim == 2) else pitch
    grids = np.meshgrid(*([np.arange(N)] * dim), indexing="ij")
    vm = micro.vertex_mask(level, dim)
    out = []
    for color in range(2 ** dim):
        bits = [(color >> d) & 1 for d in range(dim)]
        m = vm.copy()
        for g, bit in zip(grids, bits):
            m = m & (g % 2 == bit)
        if dim == 3:
            m = flat.flatten_field(m, pitch)
        out.append(np.asarray(m, dtype=np.float32))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _mask_tensors(level: int, dim: int, pitch, dtype, device):
    return tuple(torch.as_tensor(m, dtype=dtype, device=device)
                 for m in parity_masks(level, dim, pitch))


def colored_gs_smooth(
    apply_fn: Callable,
    inv_diag: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor,
    level: int,
    dim: int,
    omega: float = 1.0,
    backward: bool = False,
    num_sweeps: int = 1,
    pitch: int | None = None,
) -> torch.Tensor:
    """Multi-color GS/SOR sweep: omega = 1 -> GS, else SOR
    (reference: smooth_gs / smooth_sor capability)."""
    masks = _mask_tensors(level, dim, pitch, x.dtype, x.device)
    order = range(len(masks) - 1, -1, -1) if backward else range(len(masks))
    for _ in range(num_sweeps):
        for c in order:
            x = x + omega * masks[c] * inv_diag * (b - apply_fn(x))
    return x


def symmetric_colored_gs_smooth(apply_fn, inv_diag, b, x, level, dim,
                                omega: float = 1.0, num_sweeps: int = 1,
                                pitch: int | None = None):
    """Forward + backward sweep (reference: SymmetricGaussSeidelSmoother)."""
    for _ in range(num_sweeps):
        x = colored_gs_smooth(apply_fn, inv_diag, b, x, level, dim, omega,
                              False, pitch=pitch)
        x = colored_gs_smooth(apply_fn, inv_diag, b, x, level, dim, omega,
                              True, pitch=pitch)
    return x
