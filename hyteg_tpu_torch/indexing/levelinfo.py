"""Closed-form micro-entity counts on refined simplices.

TPU-native re-design of the reference's level bookkeeping
(reference: src/hyteg/Levelinfo.hpp:36-120). A macro-simplex refined to
``level`` has ``n = 2**level`` intervals per edge and ``N = n + 1``
micro-vertices per edge.
"""

from __future__ import annotations


def n_intervals(level: int) -> int:
    """Number of micro-intervals per macro-edge at ``level``."""
    return 1 << level


def num_points_per_edge(level: int) -> int:
    """Micro-vertices along a macro-edge (incl. endpoints)."""
    return (1 << level) + 1


def num_microvertices_per_edge(level: int) -> int:
    return (1 << level) + 1


def num_microvertices_per_face(level: int) -> int:
    """Micro-vertices in a triangle: C(N+1, 2)."""
    N = num_points_per_edge(level)
    return N * (N + 1) // 2


def num_microvertices_per_cell(level: int) -> int:
    """Micro-vertices in a tetrahedron: C(N+2, 3)."""
    N = num_points_per_edge(level)
    return N * (N + 1) * (N + 2) // 6


def num_microfaces_per_face(level: int) -> int:
    """Micro-triangles in a macro-face: n^2 (up: C(n+1,2), down: C(n,2))."""
    n = n_intervals(level)
    return n * n


def num_microcells_per_cell(level: int) -> int:
    """Micro-tets in a macro-cell: n^3 (6 congruence classes)."""
    n = n_intervals(level)
    return n * n * n


def num_microedges_per_edge(level: int) -> int:
    return 1 << level


def tri_region_size(N: int) -> int:
    """Points (x, y) with x, y >= 0 and x + y <= N - 1."""
    return N * (N + 1) // 2


def tet_region_size(N: int) -> int:
    """Points (x, y, z) with x, y, z >= 0 and x + y + z <= N - 1."""
    return N * (N + 1) * (N + 2) // 6
