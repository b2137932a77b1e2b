"""Flat-lane block layout for 3D micro-grids (torch counterpart of
hyteg_tpu/indexing/flat.py).

The canonical 3D layout is

    block = (C, N, L) with L = N * P,  lane l = y * P + z

where ``P >= N`` is the **pitch**. Standalone spaces use P = N; GMG stacks
share one pitch P = N_max across all levels, which makes grid transfers
pure stride-2 slicing (see operators/transfer.py). Lanes with z >= N are
padding and are kept at zero by every kernel.

The numpy helpers are copied from the JAX package; the shifts run on
tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def lanes(N: int, pitch: int) -> int:
    return N * pitch


@functools.lru_cache(maxsize=None)
def yz_maps(N: int, pitch: int) -> tuple[np.ndarray, np.ndarray]:
    """(y_of_lane, z_of_lane) int32 arrays of length N * pitch."""
    l = np.arange(N * pitch, dtype=np.int32)
    return l // pitch, l % pitch


@functools.lru_cache(maxsize=None)
def yz_sum(N: int, pitch: int) -> np.ndarray:
    """y + z per lane; a huge sentinel on padding lanes (z >= N) so that
    simplex masks ``x + y + z <= n`` exclude them automatically."""
    y, z = yz_maps(N, pitch)
    s = (y + z).astype(np.int32)
    s[z >= N] = np.int32(1 << 22)
    return s


def flatten_field(arr: np.ndarray, pitch: int, ncomp: int | None = None) -> np.ndarray:
    """(..., N, N, N[, k]) -> (..., N, N*pitch[, k]) zero-padded numpy.

    ``ncomp``: number of trailing component axes (0 = pure field, 1 = e.g.
    coords (..., 3)). If None it is guessed from the shape — ambiguous when
    N equals the component count, so pass it explicitly for such fields."""
    a = np.asarray(arr)
    if ncomp is None:
        ncomp = 0 if (a.shape[-1] == a.shape[-2] == a.shape[-3]) else 1
    if ncomp == 0:
        N = a.shape[-1]
        assert a.shape[-2] == a.shape[-3] == N
        pad = [(0, 0)] * a.ndim
        pad[-1] = (0, pitch - N)
        ap = np.pad(a, pad)
        return ap.reshape(a.shape[:-2] + (N * pitch,))
    assert ncomp == 1
    N = a.shape[-2]
    assert a.shape[-3] == a.shape[-4] == N
    pad = [(0, 0)] * a.ndim
    pad[-2] = (0, pitch - N)
    ap = np.pad(a, pad)
    return ap.reshape(a.shape[:-3] + (N * pitch, a.shape[-1]))


def unflatten_field(arr: np.ndarray, N: int, pitch: int) -> np.ndarray:
    """(..., N, N*pitch) -> (..., N, N, N) numpy (drops padding lanes)."""
    a = np.asarray(arr)
    g = a.reshape(a.shape[:-1] + (N, pitch))
    return g[..., :N]


def _axis_shift(u: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """out[i] = u[i + s] along ``axis`` with zero fill (signed s)."""
    if s == 0:
        return u
    out = torch.zeros_like(u)
    n = u.shape[axis]
    if abs(s) >= n:
        return out
    if s > 0:
        out.narrow(axis, 0, n - s).copy_(u.narrow(axis, s, n - s))
    else:
        out.narrow(axis, -s, n + s).copy_(u.narrow(axis, 0, n + s))
    return out


def shift_read(u: torch.Tensor, off, pitch: int, dim: int,
               ncomp: int = 0) -> torch.Tensor:
    """out[p] = u[p + off] on flat blocks (..., N, L[, comp...]) with zero
    fill beyond the block. ``off`` is a (signed) dim-tuple of micro-index
    offsets; in 3D the (y, z) parts become one lane shift oy*pitch + oz
    (exact inside the simplex masks; aliased lanes are masked by callers)."""
    ax_lane = u.ndim - 1 - ncomp
    ax_sub = ax_lane - 1
    if dim == 3:
        ls = int(off[1]) * pitch + int(off[2])
    else:
        ls = int(off[1])
    u = _axis_shift(u, ax_sub, int(off[0]))
    return _axis_shift(u, ax_lane, ls)


def shift_write(v: torch.Tensor, off, pitch: int, dim: int,
                ncomp: int = 0) -> torch.Tensor:
    """out[p + off] = v[p] (dropped beyond the block)."""
    neg = tuple(-int(o) for o in off)
    return shift_read(v, neg, pitch, dim, ncomp)


def repitch(u: torch.Tensor, N: int, p_old: int, p_new: int) -> torch.Tensor:
    """(..., N, N*p_old) -> (..., N, N*p_new): pad or drop padding lanes.
    A materialized relayout — GMG stacks share one pitch instead."""
    if p_old == p_new:
        return u
    g = u.reshape(u.shape[:-1] + (N, p_old))
    if p_new > p_old:
        g = torch.nn.functional.pad(g, (0, p_new - p_old))
    else:
        assert p_new >= N
        g = g[..., :p_new]
    return g.reshape(u.shape[:-1] + (N * p_new,))


def to_grid(u: torch.Tensor, N: int, pitch: int) -> torch.Tensor:
    """(C, N, N*pitch) -> (C, N, N, pitch) view (no copy for a contiguous
    block; callers slice ``[..., :N]`` for the exact grid)."""
    return u.reshape(u.shape[:-1] + (N, pitch))

