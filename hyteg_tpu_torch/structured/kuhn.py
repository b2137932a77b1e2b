"""Kuhn (Freudenthal) cube subdivision and the box stencil weight algebra
(torch counterpart of hyteg_tpu/structured/kuhn.py; the numpy tables are
copied as they are).

Every micro-cube of a box-structured grid is split into the same 6
tetrahedra (one per permutation of the axes), so the P1 operator on the
whole box is a translation-invariant 15-point stencil away from the
domain boundary.

Pointwise-exact weights.  For a grid point p and direction s the exact
stencil weight is

    w_s(p) = sum over terms (t, a, b) with off_b - off_a = s and
             p - off_a in [0, n_x-1] x [0, n_y-1] x [0, n_z-1]
             of  elMat[t, a, b]

(the base of a phantom element outside the box invalidates the term).
The x-validity of a term depends only on whether the row is 0, interior,
or n_x; the (y, z)-validity only on the lane.  So the full boundary
treatment collapses into THREE per-direction lane-weight vectors
(interior rows / row 0 / row n_x).  Any read whose target leaves the grid
carries an exactly zero weight.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

#: vertices of the 6 Kuhn tetrahedra as corner offsets of the unit cube:
#: for each axis permutation pi: 0, e_{pi0}, e_{pi0}+e_{pi1}, (1,1,1)
KUHN_OFFSETS = np.array(
    [
        [
            [0, 0, 0],
            [int(p[0] == i) for i in range(3)],
            [int(p[0] == i or p[1] == i) for i in range(3)],
            [1, 1, 1],
        ]
        for p in itertools.permutations(range(3))
    ],
    dtype=np.int64,
)  # (6, 4, 3)


@functools.lru_cache(maxsize=None)
def stencil_dirs():
    """The 15 stencil directions (monotone cube diagonals), (n_s, 3)."""
    dirs = set()
    for t in range(6):
        for a in range(4):
            for b in range(4):
                dirs.add(tuple(int(v) for v in
                               KUHN_OFFSETS[t, b] - KUHN_OFFSETS[t, a]))
    return np.asarray(sorted(dirs), dtype=np.int64)


@functools.lru_cache(maxsize=None)
def term_table():
    """Static per-term data: (s_idx, off_a) for the 96 (t, a, b) terms."""
    dirs = stencil_dirs()
    key = {tuple(int(x) for x in d): i for i, d in enumerate(dirs)}
    s_idx, off_a = [], []
    for t in range(6):
        for a in range(4):
            for b in range(4):
                s_idx.append(key[tuple(int(v) for v in
                                       KUHN_OFFSETS[t, b] - KUHN_OFFSETS[t, a])])
                off_a.append(KUHN_OFFSETS[t, a])
    return np.asarray(s_idx), np.asarray(off_a)  # (96,), (96, 3)


def micro_vertices(h) -> np.ndarray:
    """(6, 4, 3) physical vertex coords of the 6 Kuhn tets of one
    micro-cube with edge vector lengths h = (hx, hy, hz)."""
    return KUHN_OFFSETS.astype(np.float64) * np.asarray(h, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _lane_masks(Y: int, Z: int):
    """Static (2, 2, L) validity masks per (off_ay, off_az) pattern."""
    y = np.repeat(np.arange(Y), Z)
    z = np.tile(np.arange(Z), Y)
    out = np.zeros((2, 2, Y * Z), dtype=np.float32)
    for ay in range(2):
        for az in range(2):
            by, bz = y - ay, z - az
            out[ay, az] = ((by >= 0) & (by <= Y - 2)
                           & (bz >= 0) & (bz <= Z - 2))
    return out


@functools.lru_cache(maxsize=None)
def _selector():
    """Static (3, n_s, 2, 2, 96) selector: row-class c (0 interior,
    1 row 0, 2 row X-1), direction s, lane pattern (ay, az), term k."""
    s_idx, off_a = term_table()
    n_s = stencil_dirs().shape[0]
    sel = np.zeros((3, n_s, 2, 2, 96), dtype=np.float32)
    for k in range(96):
        ax, ay, az = (int(v) for v in off_a[k])
        s = int(s_idx[k])
        # interior rows: base_x = x - ax always in [0, X-2]
        sel[0, s, ay, az, k] = 1.0
        if ax == 0:       # row 0: base_x = -ax must be >= 0
            sel[1, s, ay, az, k] = 1.0
        if ax == 1:       # row X-1: base_x = X-1-ax must be <= X-2
            sel[2, s, ay, az, k] = 1.0
    return sel


def lane_weights(elmats: torch.Tensor, X: int, Y: int, Z: int) -> torch.Tensor:
    """(3, n_s, Y*Z) f32 pointwise-exact stencil weight vectors from the
    (6, 4, 4) Kuhn element matrices, on the element matrices' device."""
    del X  # x-dependence is fully captured by the three row classes
    kw = dict(dtype=torch.float32, device=elmats.device)
    sel = torch.as_tensor(_selector(), **kw)
    M = torch.as_tensor(_lane_masks(Y, Z), **kw)
    elm = elmats.to(torch.float32).reshape(96)
    # w[c, s, l] = sum_k sel[c,s,ay,az,k] elm[k] M[ay,az,l]
    coef = torch.einsum("cspqk,k->cspq", sel, elm)
    return torch.einsum("cspq,pql->csl", coef, M).contiguous()
