"""Grid transfers between nested BoxDomain levels (torch counterpart of
hyteg_tpu/structured/transfer.py).

FE-correct P1 transfers on the Kuhn-subdivided box grid: a fine node of
parity d in {0,1}^3 \\ {0} is the midpoint of the coarse Kuhn-mesh EDGE in
direction d (monotone diagonals only — NOT trilinear interpolation). Both
directions share one 15-direction stencil S with weight 1 at the center
and 1/2 on the 14 monotone directions:

    R = P^T:  r_c = decimate(S r_f)          (sample even positions)
    P:        u_f = S expand(u_c)            (zero-interleave then S)

The stencil runs on the (X, Y, Z) view with per-axis zero-filled shifts;
decimation and expansion are plain stride-2 views (the JAX package
contracts one-hot band matrices there, a TPU lowering workaround).
"""

from __future__ import annotations

import itertools

import torch

from .box import BoxDomain

#: the 14 monotone directions (all entries >= 0 or all <= 0), not the
#: macro-tet stencil directions of indexing/micro.py
_DIRS14 = [d for d in itertools.product((-1, 0, 1), repeat=3)
           if d != (0, 0, 0) and (all(v >= 0 for v in d)
                                  or all(v <= 0 for v in d))]


def _stencil15(u3: torch.Tensor) -> torch.Tensor:
    """S u on an (X, Y, Z) view: acc[p] = u[p] + 1/2 sum_d u[p + d],
    zero-filled per axis."""
    acc = u3.clone()
    for d in _DIRS14:
        dst, src = [], []
        for dv in d:
            dst.append(slice(max(0, -dv), u3.shape[len(dst)] - max(0, dv)))
            src.append(slice(max(0, dv), u3.shape[len(src)] - max(0, -dv)))
        acc[tuple(dst)].add_(u3[tuple(src)], alpha=0.5)
    return acc


def prolongate(u_c: torch.Tensor, coarse: BoxDomain, fine: BoxDomain):
    """Linear P1 prolongation, (X_c, L_c) -> (X_f, L_f)."""
    e = u_c.new_zeros(fine.dims)
    e[::2, ::2, ::2] = u_c.reshape(coarse.dims)
    return _stencil15(e).reshape(fine.block_shape)


def restrict(r_f: torch.Tensor, fine: BoxDomain, coarse: BoxDomain):
    """P^T residual restriction, (X_f, L_f) -> (X_c, L_c)."""
    s = _stencil15(r_f.reshape(fine.dims))
    return s[::2, ::2, ::2].reshape(coarse.block_shape)
