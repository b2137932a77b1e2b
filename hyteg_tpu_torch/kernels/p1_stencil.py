"""The general elementwise P1 apply (kernel B4) and the P1 partial
diagonal / lumped row sum (kernel B3), from element matrices.

Torch counterpart of hyteg_tpu/kernels/p1_stencil.py, of
hyteg_tpu/operators/p1_elementwise.py::p1_apply_local and of its
``_p1_diag_local``. For every micro-tet congruence class t and vertex a,
each valid element base q (x+y+z <= n - margin_t) adds

  * apply:    sum_b elMat[t,a,b] * src[q + off[t,b]]
  * diagonal: elMat[t,a,a] (or the row sum when lumped)

to the slot q + off[t,a], optionally scaled by the arithmetic, harmonic
or geometric mean of a nodal coefficient over the element's vertices.

In 2D (macro-faces, blocks (C, N, N)) the classes are the 2 micro-
triangles (up, down) with 3 vertices each.

``p1_apply_local`` and ``p1_diagonal_local`` launch the CUDA kernels
``csrc/p1_apply.cu`` and ``csrc/p1_diag.cu`` (3D) or ``csrc/p1_tri.cu``
(2D) for a CUDA tensor and run the plain versions
``p1_apply_local_torch`` and ``p1_diagonal_local_torch`` for a CPU
tensor. Their bf16 forms are those of B3 without a coefficient (3D and
2D); B3 with a coefficient and B4 refuse bf16 on both devices
(``_refuse_bf16``), so that what runs on the CPU also runs on the card.
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


def p1_apply_local_torch(src, elmats, level: int, dim: int, pitch: int,
                         coeff=None, coeff_avg: str = "arithmetic"):
    """Plain-torch per-cell apply, scatter form with zero-filled shifts
    (the ``unroll=True`` form of the JAX package's p1_apply_local; partial
    sums on interface rows):
    dst[q + off_a] += mean_t(coeff) * sum_b elMat[t,a,b] * src[q + off_b]."""
    N = (1 << level) + 1
    pitch = N if dim == 2 else pitch
    offs = micro.offsets(dim)
    T, nv = offs.shape[0], offs.shape[1]
    masks = _class_masks(level, dim, pitch, src.dtype, src.device)
    dst = torch.zeros_like(src)
    for t in range(T):
        reads = [flat.shift_read(src, offs[t, b], pitch, dim)
                 for b in range(nv)]
        if coeff is not None:
            scale = coeff_average([flat.shift_read(coeff, offs[t, b], pitch,
                                                   dim) for b in range(nv)],
                                  coeff_avg)
        for a in range(nv):
            acc = elmats[:, t, a, 0].reshape(-1, 1, 1) * reads[0]
            for b in range(1, nv):
                acc = acc + elmats[:, t, a, b].reshape(-1, 1, 1) * reads[b]
            if coeff is not None:
                acc = acc * scale
            dst = dst + flat.shift_write(acc * masks[t], offs[t, a], pitch,
                                         dim)
    return dst


@functools.lru_cache(maxsize=None)
def _kernel_tables(dim: int = 3):
    """Host int32 tables for the CUDA launchers of B3 and B4: class vertex
    offsets, (6, 4, 3) in 3D or (2, 3, 2) in 2D, and base margins, (6,) or
    (2,)."""
    return (np.ascontiguousarray(micro.offsets(dim), dtype=np.int32),
            np.ascontiguousarray(micro.base_margin(dim), dtype=np.int32))


def _refuse_bf16(what: str, *tensors) -> None:
    """Raise on a bf16 tensor where no kernel form takes one (B4, and B3
    with a coefficient), on every device."""
    if any(t is not None and t.dtype == torch.bfloat16 for t in tensors):
        raise ValueError(f"{what} has no bf16 form")


def p1_apply_local(src, elmats, level: int, dim: int, pitch: int,
                   coeff=None, coeff_avg: str = "arithmetic"):
    """Per-cell elementwise apply on the flat layout (partial sums on
    interface rows), with an optional nodal coefficient.

    src, coeff: (C, N, N*pitch) in 3D, (C, N, N) in 2D; elmats: (C, 6, 4,
    4) or (C, 2, 3, 3). A CPU tensor runs the plain version; a CUDA tensor
    launches kernel B4 (csrc/p1_apply.cu, or csrc/p1_tri.cu in 2D) and
    counts the launch in ``p1_apply_local.launches`` (3D) or
    ``p1_apply_local.launches_2d``. bf16 raises on both devices."""
    _refuse_bf16("p1_apply_local (kernel B4)", src, elmats, coeff)
    if src.device.type == "cpu":
        return p1_apply_local_torch(src, elmats, level, dim, pitch, coeff,
                                    coeff_avg)
    if coeff_avg not in MODES:
        raise ValueError(f"unknown averaging mode {coeff_avg!r}")
    N = (1 << level) + 1
    C = src.shape[0]
    block = (C, N, N * pitch if dim == 3 else N)
    offs = micro.offsets(dim)
    _check_cuda_input("src", src, block)
    _check_cuda_input("elmats", elmats, (C,) + offs.shape[:2] + (offs.shape[1],))
    if coeff is not None:
        _check_cuda_input("coeff", coeff, block)
    dst = torch.empty_like(src)
    offs, margins = _kernel_tables(dim)
    args = (src.data_ptr(), None if coeff is None else coeff.data_ptr(),
            elmats.data_ptr(), dst.data_ptr(), C, N)
    tail = (MODES.index(coeff_avg), offs.ctypes.data, margins.ctypes.data,
            build.current_stream())
    if dim == 3:
        rc = build.library().hyteg_p1_apply(*args, pitch, *tail)
    else:
        rc = build.library().hyteg_p1_apply_2d(*args, *tail)
    build.check_launch(rc, "p1_apply_local")
    build.count_launch(p1_apply_local, dim, level)
    return dst


p1_apply_local.launches = 0
p1_apply_local.launches_2d = 0
p1_apply_local.launches_by_level = {}
p1_apply_local.launches_by_level_2d = {}


def p1_diagonal_local_torch(elmats, level: int, dim: int, pitch: int,
                            lumped: bool = False, coeff=None,
                            coeff_avg: str = "arithmetic"):
    """Plain-torch per-cell partial diagonal (scatter form):
    dst[base + off_a] += elMat[t, a, a] (or sum_b elMat[t, a, b]).

    bf16 element matrices: the sums run in f32 on the widened entries and
    the result is rounded to bf16 once (kernel B3's bf16 rule)."""
    if elmats.dtype == torch.bfloat16:
        co = None if coeff is None else coeff.to(torch.float32)
        return p1_diagonal_local_torch(
            elmats.to(torch.float32), level, dim, pitch, lumped, co,
            coeff_avg).to(torch.bfloat16)
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


def p1_diagonal_local(elmats, level: int, dim: int, pitch: int,
                      lumped: bool = False, coeff=None,
                      coeff_avg: str = "arithmetic"):
    """Per-cell partial (lumped) diagonal on the flat layout.

    elmats: (C, 6, 4, 4) in 3D, (C, 2, 3, 3) in 2D; coeff: optional nodal
    field (C, N, N*pitch) or (C, N, N). A CPU tensor runs the plain
    version; a CUDA tensor launches kernel B3 (csrc/p1_diag.cu, or
    csrc/p1_tri.cu in 2D) and counts the launch in
    ``p1_diagonal_local.launches`` (3D) or
    ``p1_diagonal_local.launches_2d``. Without a coefficient the element
    matrices may be bf16 in either dimension (the block is then bf16, and
    the launch also counts in ``p1_diagonal_local.launches_bf16`` or
    ``launches_2d_bf16``); a bf16 coefficient, or bf16 element matrices
    with a coefficient, raise on both devices, and no type is cast."""
    if coeff is not None:
        _refuse_bf16("p1_diagonal_local with a coefficient (kernel B3)",
                     elmats, coeff)
    if elmats.device.type == "cpu":
        return p1_diagonal_local_torch(elmats, level, dim, pitch, lumped,
                                       coeff, coeff_avg)
    if coeff_avg not in MODES:
        raise ValueError(f"unknown averaging mode {coeff_avg!r}")
    N = (1 << level) + 1
    C = elmats.shape[0]
    block = (C, N, N * pitch if dim == 3 else N)
    offs = micro.offsets(dim)
    if elmats.dtype == torch.bfloat16:
        _check_cuda_input("elmats", elmats,
                          (C,) + offs.shape[:2] + (offs.shape[1],),
                          torch.bfloat16)
        dst = torch.empty(block, dtype=torch.bfloat16, device=elmats.device)
        offs, margins = _kernel_tables(dim)
        if dim == 3:
            rc = build.library().hyteg_p1_diag_bf16(
                elmats.data_ptr(), dst.data_ptr(), C, N, pitch, int(lumped),
                offs.ctypes.data, margins.ctypes.data, build.current_stream())
        else:
            rc = build.library().hyteg_p1_diag_2d_bf16(
                elmats.data_ptr(), dst.data_ptr(), C, N, int(lumped),
                offs.ctypes.data, margins.ctypes.data, build.current_stream())
        build.check_launch(rc, "p1_diagonal_local")
        build.count_launch(p1_diagonal_local, dim, level)
        build.count_bf16(p1_diagonal_local, dim)
        return dst
    _check_cuda_input("elmats", elmats, (C,) + offs.shape[:2] + (offs.shape[1],))
    if coeff is not None:
        _check_cuda_input("coeff", coeff, block)
    dst = torch.empty(block, dtype=elmats.dtype, device=elmats.device)
    co = None if coeff is None else coeff.data_ptr()
    offs, margins = _kernel_tables(dim)
    args = (elmats.data_ptr(), co, dst.data_ptr(), C, N)
    tail = (int(lumped), MODES.index(coeff_avg), offs.ctypes.data,
            margins.ctypes.data, build.current_stream())
    if dim == 3:
        rc = build.library().hyteg_p1_diag(*args, pitch, *tail)
    else:
        rc = build.library().hyteg_p1_diag_2d(*args, *tail)
    build.check_launch(rc, "p1_diagonal_local")
    build.count_launch(p1_diagonal_local, dim, level)
    return dst


p1_diagonal_local.launches = 0
p1_diagonal_local.launches_bf16 = 0
p1_diagonal_local.launches_2d = 0
p1_diagonal_local.launches_2d_bf16 = 0
p1_diagonal_local.launches_by_level = {}
p1_diagonal_local.launches_by_level_2d = {}
