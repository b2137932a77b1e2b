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
tensor. Each has a bf16 form in 3D and 2D, with and without a
coefficient. One dtype contract holds on both devices
(``p1_const_stencil.bf16_weights``, B2's): the block's type decides the
form, the source's for B4 and the element matrices' for B3; with a bf16
block, f32 element matrices or an f32 coefficient are rounded to bf16 as
the Pallas kernels cast them (hyteg_tpu/kernels/p1_stencil.py:205,218,
299), so they give the bits of bf16 ones; any other type beside a bf16
block, and a bf16 input beside another block, raise. The bf16 kernels
and plain versions widen every value to f32, sum and take the means in
f32, and round each result to bf16 once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..indexing import flat, micro
from ..operators.averaging import MODES, coeff_average
from . import build
from .p1_const_stencil import _check_cuda_input, bf16_weights


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
    dst[q + off_a] += mean_t(coeff) * sum_b elMat[t,a,b] * src[q + off_b].

    bf16 source: the sums and means run in f32 on the widened values and
    the result is rounded to bf16 once (kernel B4's bf16 rule)."""
    if src.dtype == torch.bfloat16:
        wide = [None if t is None else t.to(torch.float32)
                for t in (src, elmats, coeff)]
        return p1_apply_local_torch(wide[0], wide[1], level, dim, pitch,
                                    wide[2], coeff_avg).to(torch.bfloat16)
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


def p1_apply_local(src, elmats, level: int, dim: int, pitch: int,
                   coeff=None, coeff_avg: str = "arithmetic"):
    """Per-cell elementwise apply on the flat layout (partial sums on
    interface rows), with an optional nodal coefficient.

    src, coeff: (C, N, N*pitch) in 3D, (C, N, N) in 2D; elmats: (C, 6, 4,
    4) or (C, 2, 3, 3). A CPU tensor runs the plain version; a CUDA tensor
    launches kernel B4 (csrc/p1_apply.cu, or csrc/p1_tri.cu in 2D) and
    counts the launch in ``p1_apply_local.launches`` (3D) or
    ``p1_apply_local.launches_2d``. A bf16 source runs the bf16 form (the
    launch also counts in ``p1_apply_local.launches_bf16`` or
    ``launches_2d_bf16``); the element matrices and the coefficient follow
    ``bf16_weights`` on either device."""
    ins = bf16_weights(src, *(t for t in (elmats, coeff) if t is not None))
    elmats, coeff = ins[0], (None if coeff is None else ins[1])
    if src.device.type == "cpu":
        return p1_apply_local_torch(src, elmats, level, dim, pitch, coeff,
                                    coeff_avg)
    if coeff_avg not in MODES:
        raise ValueError(f"unknown averaging mode {coeff_avg!r}")
    N = (1 << level) + 1
    C = src.shape[0]
    block = (C, N, N * pitch if dim == 3 else N)
    offs = micro.offsets(dim)
    bf16 = src.dtype == torch.bfloat16
    dt = torch.bfloat16 if bf16 else torch.float32
    _check_cuda_input("src", src, block, dt)
    _check_cuda_input("elmats", elmats,
                      (C,) + offs.shape[:2] + (offs.shape[1],), dt)
    if coeff is not None:
        _check_cuda_input("coeff", coeff, block, dt)
    dst = torch.empty_like(src)
    offs, margins = _kernel_tables(dim)
    args = (src.data_ptr(), None if coeff is None else coeff.data_ptr(),
            elmats.data_ptr(), dst.data_ptr(), C, N)
    tail = (MODES.index(coeff_avg), offs.ctypes.data, margins.ctypes.data,
            build.current_stream())
    lib = build.library()
    if dim == 3:
        fn = lib.hyteg_p1_apply_bf16 if bf16 else lib.hyteg_p1_apply
        rc = fn(*args, pitch, *tail)
    else:
        fn = lib.hyteg_p1_apply_2d_bf16 if bf16 else lib.hyteg_p1_apply_2d
        rc = fn(*args, *tail)
    build.check_launch(rc, "p1_apply_local")
    build.count_launch(p1_apply_local, dim, level)
    if bf16:
        build.count_bf16(p1_apply_local, dim)
    return dst


p1_apply_local.launches = 0
p1_apply_local.launches_bf16 = 0
p1_apply_local.launches_2d = 0
p1_apply_local.launches_2d_bf16 = 0
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
    ``p1_diagonal_local.launches_2d``. bf16 element matrices run the bf16
    form and give a bf16 block (the launch also counts in
    ``p1_diagonal_local.launches_bf16`` or ``launches_2d_bf16``); the
    coefficient follows ``bf16_weights`` on either device."""
    if coeff is not None:
        (coeff,) = bf16_weights(elmats, coeff)
    if elmats.device.type == "cpu":
        return p1_diagonal_local_torch(elmats, level, dim, pitch, lumped,
                                       coeff, coeff_avg)
    if coeff_avg not in MODES:
        raise ValueError(f"unknown averaging mode {coeff_avg!r}")
    N = (1 << level) + 1
    C = elmats.shape[0]
    block = (C, N, N * pitch if dim == 3 else N)
    offs = micro.offsets(dim)
    bf16 = elmats.dtype == torch.bfloat16
    dt = torch.bfloat16 if bf16 else torch.float32
    _check_cuda_input("elmats", elmats,
                      (C,) + offs.shape[:2] + (offs.shape[1],), dt)
    if coeff is not None:
        _check_cuda_input("coeff", coeff, block, dt)
    dst = torch.empty(block, dtype=dt, device=elmats.device)
    co = None if coeff is None else coeff.data_ptr()
    offs, margins = _kernel_tables(dim)
    args = (elmats.data_ptr(), co, dst.data_ptr(), C, N)
    tail = (int(lumped), MODES.index(coeff_avg), offs.ctypes.data,
            margins.ctypes.data, build.current_stream())
    lib = build.library()
    if dim == 3:
        fn = lib.hyteg_p1_diag_bf16 if bf16 else lib.hyteg_p1_diag
        rc = fn(*args, pitch, *tail)
    else:
        fn = lib.hyteg_p1_diag_2d_bf16 if bf16 else lib.hyteg_p1_diag_2d
        rc = fn(*args, *tail)
    build.check_launch(rc, "p1_diagonal_local")
    build.count_launch(p1_diagonal_local, dim, level)
    if bf16:
        build.count_bf16(p1_diagonal_local, dim)
    return dst


p1_diagonal_local.launches = 0
p1_diagonal_local.launches_bf16 = 0
p1_diagonal_local.launches_2d = 0
p1_diagonal_local.launches_2d_bf16 = 0
p1_diagonal_local.launches_by_level = {}
p1_diagonal_local.launches_by_level_2d = {}
