"""BoxDomain 15-point stencil apply (kernel B1).

Torch counterpart of hyteg_tpu/kernels/box_stencil.py::box_apply_pallas:

    y[x, l] = sum_s w[c(x), s, l] * u[x + dx_s, l + dy_s*Z + dz_s]

with the row class c = 1 for row 0, 2 for row X-1 and 0 otherwise, and
reads outside the block zero-filled. The Pallas kernel rolls lanes
instead; every wrapped target carries an exactly zero weight
(structured/kuhn.py), so both give the same sums.

Mixed precision as in the Pallas kernel: the block may be f32 or bf16;
weights and the accumulator are f32 and the result is rounded to the
block dtype once. (The JAX package's plain box apply casts the weights to
the block dtype and accumulates bf16 blocks in bf16; the port follows the
kernel.)

``box_apply`` launches the CUDA kernel ``csrc/box_stencil.cu`` for a CUDA
tensor and runs the plain version ``box_apply_torch`` for a CPU tensor.
"""

from __future__ import annotations

import torch

from ..structured import kuhn
from . import build
from .p1_const_stencil import _check_cuda_input


def _span(d: int, n: int) -> tuple[slice, slice]:
    """(dst, src) slices of a zero-filled shift: dst[i] = src[i + d]."""
    lo, hi = max(0, -d), min(n, n - d)
    return slice(lo, hi), slice(lo + d, hi + d)


def _row(u, wc, x: int, Z: int) -> torch.Tensor:
    """One output row x with the (n_s, L) weight rows wc."""
    X, L = u.shape
    acc = torch.zeros(L, dtype=torch.float32, device=u.device)
    for s, (dx, dy, dz) in enumerate(kuhn.stencil_dirs().tolist()):
        if 0 <= x + dx < X:
            ld, lsrc = _span(dy * Z + dz, L)
            acc[ld].addcmul_(u[x + dx, lsrc], wc[s, ld])
    return acc


def box_apply_torch(u: torch.Tensor, w_vecs: torch.Tensor, dims) -> torch.Tensor:
    """Plain-torch box apply: u (X, Y*Z) f32 or bf16, w_vecs (3, 15, Y*Z).
    Accumulates in f32 (in place on strided views, so the only temporary
    is the f32 accumulator) and rounds once to u's dtype."""
    X, Y, Z = dims
    L = Y * Z
    uf = u.to(torch.float32)
    w = w_vecs.to(torch.float32)
    y = torch.zeros((X, L), dtype=torch.float32, device=u.device)
    for s, (dx, dy, dz) in enumerate(kuhn.stencil_dirs().tolist()):
        rd, rsrc = _span(dx, X)
        ld, lsrc = _span(dy * Z + dz, L)
        y[rd, ld].addcmul_(uf[rsrc, lsrc], w[0, s, ld])
    # rows 0 and X-1 re-evaluated with their own weight rows
    y[0] = _row(uf, w[1], 0, Z)
    y[X - 1] = _row(uf, w[2], X - 1, Z)
    return y.to(u.dtype)


def box_apply(u: torch.Tensor, w_vecs: torch.Tensor, dims) -> torch.Tensor:
    """Box stencil apply on every node, in u's dtype.

    u: (X, Y*Z) f32 or bf16; w_vecs: (3, 15, Y*Z) f32 from
    kuhn.lane_weights. A CPU tensor runs the plain version; a CUDA tensor
    launches kernel B1 (csrc/box_stencil.cu) and counts the launch in
    ``box_apply.launches`` and ``box_apply.launches_by_rows[X]`` (X
    tells a hierarchy's levels apart)."""
    if u.device.type == "cpu":
        return box_apply_torch(u, w_vecs, dims)
    X, Y, Z = dims
    L = Y * Z
    bf16 = u.dtype == torch.bfloat16
    _check_cuda_input("u", u, (X, L), torch.bfloat16 if bf16 else torch.float32)
    _check_cuda_input("w_vecs", w_vecs, (3, kuhn.stencil_dirs().shape[0], L))
    y = torch.empty_like(u)
    rc = build.library().hyteg_box_apply(
        u.data_ptr(), w_vecs.data_ptr(), y.data_ptr(), X, Y, Z, int(bf16),
        build.current_stream())
    build.check_launch(rc, "box_apply")
    box_apply.launches += 1
    box_apply.launches_by_rows[X] = box_apply.launches_by_rows.get(X, 0) + 1
    return y


box_apply.launches = 0
box_apply.launches_by_rows = {}
