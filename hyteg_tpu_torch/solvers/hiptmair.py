"""Hiptmair hybrid smoother for H(curl) (N1E1) problems; torch
counterpart of hyteg_tpu/solvers/hiptmair.py.

Reference: src/mixed_operator/HybridSmoother.hpp. Point smoothing in the
edge space is blind to the large gradient kernel of the curl-curl
operator, so each sweep adds a correction in the potential space,

    x <- x + omega_e D_A^{-1} (b - A x)                 (edge relaxation)
    r <- b - A x
    q <- omega_v D_{G^T A G}^{-1} (G^T r)               (potential relaxation)
    x <- x + G q

with G the discrete gradient P1 -> N1E1 (potentials on the even nodes of
the N1E1 node grid, exchanged through the node P1Space). Both halves are
weighted Jacobi, damped against power-iterated spectral bounds; the JAX
package's jitted ``fori_loop`` power iterations are plain loops here,
from the same deterministic seed field.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.types import DoFType, FLAG_INNER
from ..functions.n1e1 import N1E1Space
from ..operators.n1e1_ops import N1E1ElementwiseOperator


def _varying_seed(shape, device) -> torch.Tensor:
    """Deterministic oscillating field for power iterations: sin(0.7 c +
    1.3 r + 2.1 l) + 0.01 over the block's (cell, row, lane) indices, in
    float32 as the JAX package computes it (not orthogonal to the
    dominant mode)."""
    idx = [torch.arange(k, dtype=torch.int32, device=device).to(torch.float32)
           for k in shape[:3]]
    c = idx[0].reshape(-1, 1, 1)
    r = idx[1].reshape(1, -1, 1)
    l = idx[2].reshape(1, 1, -1)
    return torch.sin(0.7 * c + 1.3 * r + 2.1 * l) + 0.01


class HiptmairSmoother:
    """Multiplicative two-space smoother bound to an N1E1 operator."""

    def __init__(self, op: N1E1ElementwiseOperator, sd=None,
                 omega_edge: float | None = None,
                 omega_vertex: float | None = None,
                 flag: DoFType = FLAG_INNER, power_iters: int = 15):
        self.op = op
        self.space: N1E1Space = op.space
        self.sd = self.space.resolve_sd(sd)
        self.flag = flag
        self.inv_diag_e = op.inverse_diagonal(self.sd)
        self.inv_diag_v = op.potential_inverse_diagonal(self.sd)
        # fixed omega = 2/3 diverges once lambda_max(D^-1 A) > 3 (observed
        # at level >= 2 for curl-curl); damp each half against its own
        # power-iterated spectral bound: omega = 4 / (3 lambda_max)
        if omega_edge is None:
            lam_e = self._power_edge(power_iters)
            omega_edge = 4.0 / (3.0 * max(lam_e, 1e-6))
        if omega_vertex is None:
            lam_v = self._power_vertex(power_iters)
            omega_vertex = 4.0 / (3.0 * max(lam_v, 1e-6))
        self.omega_e = omega_edge
        self.omega_v = omega_vertex

    def _dot(self, u, v):
        return self.space.dot(u, v, DoFType.ALL, self.sd)

    def _power(self, op_fn, mask, iters: int) -> float:
        sp = self.space
        x = _varying_seed(sp.block_shape, sp.device).to(sp.dtype) * mask[None]
        for _ in range(iters):
            y = op_fn(x)
            x = y / torch.clamp(torch.sqrt(self._dot(y, y)), min=1e-30)
        y = op_fn(x)
        return float(self._dot(x, y) / torch.clamp(self._dot(x, x),
                                                   min=1e-30))

    def _power_edge(self, iters: int) -> float:
        op, sd = self.op, self.sd
        return self._power(
            lambda x: self._masked(self.inv_diag_e * op.apply_raw(x, sd)),
            self.space.edge_mask_t, iters)

    def _rv(self, r):
        """G^T r on the vertex nodes, exchanged."""
        sp = self.space
        return sp.node_space._exchange_add_(
            sp.gradient_transpose_apply(r, self.sd), self.sd)

    def _power_vertex(self, iters: int) -> float:
        sp, op, sd = self.space, self.op, self.sd

        def AtGA(q):
            r = op.apply_raw(sp.gradient_apply(q), sd)
            return self._masked(self.inv_diag_v * self._rv(r))

        # varying seed: the constant potential is in the null space of
        # G^T A G — a flat seed collapses the iteration to zero
        return self._power(AtGA, sp.vertexnode_mask_t, iters)

    def _masked(self, upd):
        return self.space.node_space._restore_rows_(upd, None, self.flag,
                                                    self.sd)

    def smooth(self, x, b, num_sweeps: int = 1):
        """Symmetric multiplicative sweep: edge -> potential -> edge."""
        sp, op, sd = self.space, self.op, self.sd

        def edge(x):
            r = b - op.apply_raw(x, sd)
            return x + self._masked(self.omega_e * self.inv_diag_e * r)

        for _ in range(num_sweeps):
            x = edge(x)
            r = b - op.apply_raw(x, sd)
            q = self._masked(self.omega_v * self.inv_diag_v * self._rv(r))
            x = edge(x + sp.gradient_apply(q))
        return x

    def as_preconditioner(self) -> Callable:
        """Symmetric (additive) Hiptmair preconditioner for CG/MinRes:
        M^{-1} = D_A^{-1} + G D_{G^T A G}^{-1} G^T (SPD by construction)."""
        sp = self.space

        def prec(r):
            xe = self._masked(self.inv_diag_e * r)
            q = self._masked(self.inv_diag_v * self._rv(r))
            return xe + sp.gradient_apply(q)

        return prec
