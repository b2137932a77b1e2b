"""P1 partial diagonal / lumped row sum from element matrices (kernel B3).

Torch counterpart of the diagonal path of hyteg_tpu/kernels/p1_stencil.py
and of hyteg_tpu/operators/p1_elementwise.py::_p1_diag_local: for every
micro-tet congruence class t and vertex a, each valid element base q
(x+y+z <= n - margin_t) adds elMat[t,a,a] (or the row sum when lumped) to
the slot q + off[t,a], optionally scaled by the mean of a nodal
coefficient over the element's vertices.

``p1_diagonal_local`` launches the CUDA kernel ``csrc/p1_diag.cu`` for a
CUDA tensor and runs the plain version ``p1_diagonal_local_torch`` for a
CPU tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..indexing import flat, micro
from ..operators.averaging import MODES, coeff_average
from . import build
from .p1_const_stencil import _check_cuda_input


@functools.lru_cache(maxsize=8)
def _class_masks(level: int, dim: int, pitch: int, dtype, device) -> tuple:
    return tuple(
        torch.as_tensor(micro.elem_base_mask_flat(level, t, dim, pitch),
                        dtype=dtype, device=device)
        for t in range(micro.num_classes(dim))
    )


def p1_diagonal_local_torch(elmats, level: int, dim: int, pitch: int,
                            lumped: bool = False, coeff=None,
                            coeff_avg: str = "arithmetic"):
    """Plain-torch per-cell partial diagonal (scatter form):
    dst[base + off_a] += elMat[t, a, a] (or sum_b elMat[t, a, b])."""
    N = (1 << level) + 1
    pitch = N if dim == 2 else pitch
    L = N * pitch if dim == 3 else N
    offs = micro.offsets(dim)
    T, nv = offs.shape[0], offs.shape[1]
    masks = _class_masks(level, dim, pitch, elmats.dtype, elmats.device)
    block_shape = (elmats.shape[0], N, L)
    dst = torch.zeros(block_shape, dtype=elmats.dtype, device=elmats.device)
    for t in range(T):
        if coeff is not None:
            creads = [flat.shift_read(coeff, offs[t, b], pitch, dim)
                      for b in range(nv)]
            scale = coeff_average(creads, coeff_avg)
        for a in range(nv):
            w = elmats[:, t, a, :].sum(-1) if lumped else elmats[:, t, a, a]
            acc = w.reshape(-1, 1, 1) * masks[t]
            if coeff is not None:
                acc = acc * scale
            dst = dst + flat.shift_write(acc, offs[t, a], pitch, dim)
    return dst


@functools.lru_cache(maxsize=None)
def _kernel_tables():
    """Host int32 tables for the CUDA launcher: (6, 4, 3) class vertex
    offsets and (6,) base margins."""
    return (np.ascontiguousarray(micro.offsets(3), dtype=np.int32),
            np.ascontiguousarray(micro.base_margin(3), dtype=np.int32))


def p1_diagonal_local(elmats, level: int, dim: int, pitch: int,
                      lumped: bool = False, coeff=None,
                      coeff_avg: str = "arithmetic"):
    """Per-cell partial (lumped) diagonal on the flat layout.

    elmats: (C, 6, 4, 4); coeff: optional nodal field (C, N, N*pitch).
    A CPU tensor runs the plain version; a CUDA tensor launches kernel B3
    (csrc/p1_diag.cu) and counts the launch in
    ``p1_diagonal_local.launches``."""
    if elmats.device.type == "cpu":
        return p1_diagonal_local_torch(elmats, level, dim, pitch, lumped,
                                       coeff, coeff_avg)
    if dim != 3:
        raise NotImplementedError("the CUDA kernel is 3D only")
    if coeff_avg not in MODES:
        raise ValueError(f"unknown averaging mode {coeff_avg!r}")
    N = (1 << level) + 1
    C = elmats.shape[0]
    offs, margins = _kernel_tables()
    _check_cuda_input("elmats", elmats, (C,) + offs.shape[:2] + (offs.shape[1],))
    if coeff is not None:
        _check_cuda_input("coeff", coeff, (C, N, N * pitch))
    dst = torch.empty((C, N, N * pitch), dtype=elmats.dtype,
                      device=elmats.device)
    rc = build.library().hyteg_p1_diag(
        elmats.data_ptr(), None if coeff is None else coeff.data_ptr(),
        dst.data_ptr(), C, N, pitch, int(lumped), MODES.index(coeff_avg),
        offs.ctypes.data, margins.ctypes.data, build.current_stream())
    build.check_launch(rc, "p1_diagonal_local")
    p1_diagonal_local.launches += 1
    return dst


p1_diagonal_local.launches = 0
