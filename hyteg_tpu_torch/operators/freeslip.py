"""Free-slip boundary handling: normal projection of vector fields; torch
counterpart of hyteg_tpu/operators/freeslip.py.

Reference: src/hyteg/p1functionspace/freeslip/ and
src/hyteg/composites/StrongFreeSlipWrapper.hpp. ProjectNormalOperator
removes the normal component of a velocity field on FREESLIP-flagged
boundary DoFs (u <- u - (u.n) n), and the wrapper conjugates an operator
with that projection so Krylov solvers see the constrained system
A_fs = P A P + (I - P). Velocities are (dim, C, M, lanes) blocks or
sequences of dim blocks; results are (dim, C, M, lanes) blocks.
"""

from __future__ import annotations

import torch

from ..core.types import BoundaryCondition, DoFType


class NormalProjection:
    """Projects out the normal component on FREESLIP rows.

    ``normal_fn(x) -> (..., dim)``: the outward normal (normalized here),
    evaluated at the node coordinates (e.g. radial on the annulus and the
    shell)."""

    def __init__(self, space, bc: BoundaryCondition, normal_fn,
                 shard: int = 0):
        self.space = space
        self.bc = bc
        self.dim = space.dim
        sd = space.resolve_sd(bc, shard)
        xyz = space.coords(shard)
        n = torch.as_tensor(normal_fn(xyz), dtype=xyz.dtype,
                            device=xyz.device)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                            min=1e-30)
        ns = getattr(space, "node_space", space)
        ones = torch.ones(ns.block_shape, dtype=n.dtype, device=n.device)
        #: 1 on freeslip rows, 0 elsewhere
        self.mask = ns.restore_rows(ones, torch.zeros_like(ones),
                                    DoFType.FREESLIP, sd)
        #: unit normals on freeslip rows, zero elsewhere, (C, M, lanes, dim)
        self.normals = n * self.mask[..., None]

    def _normal_component(self, vel) -> torch.Tensor:
        un = vel[0] * self.normals[..., 0]
        for d in range(1, self.dim):
            un = un + vel[d] * self.normals[..., d]
        return un

    def project(self, vel) -> torch.Tensor:
        """u <- u - (u.n) n on freeslip rows (reference: projectNormal)."""
        un = self._normal_component(vel)
        return torch.stack([vel[d] - un * self.normals[..., d]
                            for d in range(self.dim)])

    def normal_part(self, vel) -> torch.Tensor:
        """(u.n) n on freeslip rows, 0 elsewhere."""
        un = self._normal_component(vel)
        return torch.stack([un * self.normals[..., d]
                            for d in range(self.dim)])


class StrongFreeSlipWrapper:
    """A_fs x = P A (P x) + (I - P) x (reference: StrongFreeSlipWrapper).

    ``apply_vel`` maps a velocity to a velocity; a solver on the wrapped
    operator keeps u.n = 0 at convergence when the rhs is projected as
    well (``project_rhs``)."""

    def __init__(self, apply_vel, projection: NormalProjection):
        self.apply_vel = apply_vel
        self.proj = projection

    def __call__(self, vel) -> torch.Tensor:
        ap = self.proj.project(self.apply_vel(self.proj.project(vel)))
        return ap + self.proj.normal_part(vel)

    def project_rhs(self, rhs) -> torch.Tensor:
        return self.proj.project(rhs)
