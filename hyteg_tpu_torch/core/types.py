"""Core enums and flag types.

Reference: src/hyteg/types/types.hpp:29-96 (DoFType bitmask, UpdateType,
CycleType) and src/hyteg/boundary/BoundaryConditions.hpp:42-88.
"""

from __future__ import annotations

import dataclasses
import enum


class UpdateType(enum.Enum):
    REPLACE = 0
    ADD = 1


class CycleType(enum.Enum):
    V = 1
    W = 2


class DoFType(enum.IntFlag):
    """Bitmask classifying DoFs by boundary role."""

    NONE = 0
    INNER = 1
    DIRICHLET = 2
    NEUMANN = 4
    FREESLIP = 8

    ALL = 1 | 2 | 4 | 8


#: the default flag set operators/solvers act on (everything but Dirichlet)
FLAG_INNER = DoFType.INNER | DoFType.NEUMANN | DoFType.FREESLIP


@dataclasses.dataclass(frozen=True)
class BoundaryCondition:
    """Maps mesh boundary flags -> DoFType.

    Mesh flag 0 is the interior; generators may assign arbitrary positive
    flags to boundary regions (e.g. annulus: 1 = inner rim, 2 = outer rim).
    """

    flag_to_type: tuple[tuple[int, DoFType], ...] = ()
    default_boundary: DoFType = DoFType.DIRICHLET

    def doftype_of(self, mesh_flag: int) -> DoFType:
        if mesh_flag == 0:
            return DoFType.INNER
        for f, t in self.flag_to_type:
            if f == mesh_flag:
                return t
        return self.default_boundary

    @staticmethod
    def all_dirichlet() -> "BoundaryCondition":
        """The reference's default: every boundary flag is Dirichlet."""
        return BoundaryCondition()

    @staticmethod
    def all_neumann() -> "BoundaryCondition":
        return BoundaryCondition(default_boundary=DoFType.NEUMANN)

    @staticmethod
    def create_0123() -> "BoundaryCondition":
        """flag 1 -> Dirichlet, 2 -> Neumann, 3 -> Freeslip (reference
        BoundaryCondition::create0123BC)."""
        return BoundaryCondition(
            flag_to_type=(
                (1, DoFType.DIRICHLET),
                (2, DoFType.NEUMANN),
                (3, DoFType.FREESLIP),
            )
        )

    def with_flag(self, mesh_flag: int, doftype: DoFType) -> "BoundaryCondition":
        kept = tuple((f, t) for f, t in self.flag_to_type if f != mesh_flag)
        return dataclasses.replace(
            self, flag_to_type=kept + ((mesh_flag, doftype),)
        )
