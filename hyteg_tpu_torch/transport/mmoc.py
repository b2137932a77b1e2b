"""Semi-Lagrangian (MMOC) advection — the reference's Eulerian–Lagrangian
transport without particles (torch counterpart of
hyteg_tpu/transport/mmoc.py).

Reference: src/coupling_hyteg_convection_particles/MMOCTransport.hpp:1321-1390
seeds one particle per DoF, integrates it backwards through the velocity
field with RK schemes (migrating particles between MPI ranks as they cross
macro-cell boundaries), then interpolates the old field at the departure
points. Here the departure points of all DoF nodes are integrated in one
batched computation and the old field is evaluated at them with the point
locator (functions/evaluate.py): crossing macro-cell boundaries is just a
different argmax in the locator.

The JAX package evaluates every slot of the node blocks and zeroes the
padding outside each macro simplex afterwards (about 5/6 of a 3D block);
here only the slots the vertex mask keeps are integrated and evaluated,
and their values are scattered back into a zero block: the same result on
every kept slot.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch

from ..core.types import BoundaryCondition, DoFType
from ..functions.evaluate import FieldEvaluator
from ..primitives.storage import CellStorage

# Butcher tableaus (explicit): reference MMOCTransport TimeSteppingScheme
_RK = {
    1: ([], [1.0]),                                          # explicit Euler
    2: ([[0.5]], [0.0, 1.0]),                                # midpoint
    3: ([[0.5], [-1.0, 2.0]], [1 / 6, 2 / 3, 1 / 6]),        # Kutta RK3
    4: ([[0.5], [0.0, 0.5], [0.0, 0.0, 1.0]],
        [1 / 6, 1 / 3, 1 / 3, 1 / 6]),                       # classic RK4
}


class MMOCTransport:
    """Semi-Lagrangian advection of a scalar P1/P2 field.

    ``degree``: polynomial degree of the transported field c.
    ``vel_degree``: degree of the velocity components (P2 for Taylor-Hood).
    ``device`` has no default.
    """

    def __init__(self, storage: CellStorage, level: int, degree: int = 2,
                 vel_degree: int = 2, *, device, dtype=torch.float32):
        self.storage = storage
        self.level = level
        self.dim = storage.dim
        self.degree = degree
        kw = dict(device=device, dtype=dtype)
        self.eval_c = FieldEvaluator(storage, level, degree, **kw)
        self.eval_v = (self.eval_c if vel_degree == degree
                       else FieldEvaluator(storage, level, vel_degree, **kw))
        # node coordinates of the transported field's grid
        if degree == 2:
            from ..functions.p2 import P2Space

            self.space = P2Space(storage, level, device=device, dtype=dtype)
            self._node_space = self.space.node_space
        else:
            from ..functions.p1 import P1Space

            self.space = P1Space(storage, level, device=device, dtype=dtype)
            self._node_space = self.space
        self.dtype = dtype

    @functools.cached_property
    def _kept(self) -> torch.Tensor:
        """(Q,) flat block index of every slot the vertex mask keeps."""
        sp = self._node_space
        mask = sp.vertex_mask_t.bool().expand(sp.block_shape)
        return mask.reshape(-1).nonzero()[:, 0]

    @functools.cached_property
    def _node_coords_flat(self) -> torch.Tensor:
        """(Q, dim) physical coordinates of every kept node slot."""
        xyz = self._node_space.coords()  # (C, N, lanes, 3)
        return xyz.reshape(-1, 3)[self._kept, : self.dim].contiguous()

    def _vel_at(self, vel_blocks, pts) -> torch.Tensor:
        """vel_blocks: (dim, C, Nv, lanes) stacked components -> (Q, dim)."""
        return self.eval_v.evaluate(vel_blocks, pts).T

    def departure_points(self, vel_blocks, dt, rk: int = 4,
                         substeps: int = 1) -> torch.Tensor:
        """Backtrack every kept node through the (frozen) velocity field:
        (Q, dim) in the order of the kept slots."""
        a_rows, b = _RK[rk]
        h = dt / substeps
        x = self._node_coords_flat
        for _ in range(substeps):
            ks = []
            for i in range(len(b)):
                xi = x
                if i > 0:
                    for j, a in enumerate(a_rows[i - 1]):
                        if a != 0.0:
                            xi = xi - h * a * ks[j]
                ks.append(self._vel_at(vel_blocks, xi))
            xn = x
            for bi, ki in zip(b, ks):
                if bi != 0.0:
                    xn = xn - h * bi * ki
            x = xn
        return x

    def step(self, c, vel: Sequence, dt, rk: int = 4, substeps: int = 1,
             bc: BoundaryCondition | None = None,
             dirichlet_from=None) -> torch.Tensor:
        """One MMOC step: c(x, t+dt) = c(x_departure, t).

        ``vel``: dim velocity component blocks (a (dim, C, N, lanes) tensor
        or a sequence) on the vel_degree grid.
        ``dirichlet_from``: block providing values on Dirichlet rows
        (defaults to the pre-step c — inflow keeps its boundary value).
        """
        sp = self.space
        vel_blocks = vel if isinstance(vel, torch.Tensor) else torch.stack(
            list(vel))
        xd = self.departure_points(vel_blocks, dt, rk, substeps)
        new = torch.zeros_like(c)
        new.view(-1)[self._kept] = self.eval_c.evaluate(c, xd)
        # sync interface replicas (the padding stays zero)
        sd = sp.resolve_sd(bc)
        new = self._node_space._exchange_rep_(new, sd)
        old = c if dirichlet_from is None else dirichlet_from
        return sp.restore_rows(
            new, old, DoFType.INNER | DoFType.NEUMANN | DoFType.FREESLIP, sd
        )

    def mass_fix(self, c_new, c_old, mass_dot: Callable) -> torch.Tensor:
        """Global multiplicative mass-conservation fixup (the reference's
        local volume-fraction fixups collapse to a single global correction
        factor; reference: MMOCTransport mass-conservation modes)."""
        ones = torch.ones_like(c_new)
        m_new = mass_dot(c_new, ones)
        m_old = mass_dot(c_old, ones)
        safe = torch.where(m_new == 0, 1.0, m_new)
        return c_new * torch.where(m_new == 0, 1.0, m_old / safe)
