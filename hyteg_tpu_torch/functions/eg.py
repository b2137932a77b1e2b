"""EG (enriched Galerkin) function space: [P1]^dim + P0 enrichment;
torch counterpart of hyteg_tpu/functions/eg.py.

Reference: src/hyteg/egfunctionspace/EGFunction.hpp and the generated
Nitsche forms under egfunctionspace/. A vector-valued function

    u = u_CG + c_T psi_T,     psi_T(x) = x - m_T   (per element T)

with a continuous [P1]^dim part (P1 node grids, one block per component)
and a discontinuous scalar enrichment coefficient per micro-element
(VolumeDoF/P0 layout). Its DG coupling lives in operators/eg_ops.py.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.types import BoundaryCondition, DoFType
from ..primitives.storage import CellStorage
from .p1 import P1Space
from .volume import VolumeDoFSpace


class EGSpace:
    """Bundle of the vector P1 space and the P0 enrichment space, on
    ``device`` (no default)."""

    def __init__(self, storage: CellStorage, level: int, *, device,
                 dtype=torch.float32):
        self.storage = storage
        self.level = level
        self.dim = storage.dim
        self.p1 = P1Space(storage, level, device=device, dtype=dtype)
        self.p0 = VolumeDoFSpace(storage, level, ndofs=1, device=device,
                                 dtype=dtype)
        self.device = self.p1.device
        self.dtype = dtype

    def zeros(self) -> "EGFunction":
        return EGFunction(tuple(self.p1.zeros() for _ in range(self.dim)),
                          self.p0.zeros(), self)

    def interpolate(self, fns, bc: BoundaryCondition | None = None,
                    flag: DoFType = DoFType.ALL) -> "EGFunction":
        """Nodal interpolation of the CG part (enrichment set to 0 — the
        canonical interpolant of the reference's EGFunction)."""
        bc = bc or BoundaryCondition.all_dirichlet()
        sd = self.p1.resolve_sd(bc)
        vel = tuple(self.p1.interpolate(fns[d], self.p1.zeros(), flag, sd)
                    for d in range(self.dim))
        return EGFunction(vel, self.p0.zeros(), self)

    def dot(self, a: "EGFunction", b: "EGFunction",
            flag: DoFType = DoFType.ALL) -> torch.Tensor:
        sd = self.p1.resolve_sd(None)
        acc = torch.zeros((), dtype=self.dtype, device=self.device)
        for d in range(self.dim):
            acc = acc + self.p1.dot(a.vel[d], b.vel[d], flag, sd)
        return acc + self.p0.dot(a.enr, b.enr)

    def norm(self, a: "EGFunction", flag: DoFType = DoFType.ALL):
        return torch.sqrt(self.dot(a, a, flag))

    def num_global_dofs(self) -> int:
        return (self.dim * self.p1.num_global_dofs()
                + self.p0.num_global_dofs())


@dataclasses.dataclass
class EGFunction:
    """vel: tuple of dim P1 blocks; enr: (C, T, n, ...) P0 block."""

    vel: tuple
    enr: torch.Tensor
    space: EGSpace

    def __add__(self, o):
        return EGFunction(tuple(a + b for a, b in zip(self.vel, o.vel)),
                          self.enr + o.enr, self.space)

    def __sub__(self, o):
        return EGFunction(tuple(a - b for a, b in zip(self.vel, o.vel)),
                          self.enr - o.enr, self.space)

    def __mul__(self, s):
        return EGFunction(tuple(s * a for a in self.vel), s * self.enr,
                          self.space)

    __rmul__ = __mul__

    def zeros_like(self) -> "EGFunction":
        return EGFunction(tuple(torch.zeros_like(v) for v in self.vel),
                          torch.zeros_like(self.enr), self.space)
