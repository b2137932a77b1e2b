"""Structured micro-element classification on refined simplices.

The reference indexes micro-entities of a refined macro-simplex with
closed-form maps and six micro-cell congruence classes
(reference: src/hyteg/volumedofspace/CellDoFIndexing.hpp:38-55,
src/hyteg/p1functionspace/VertexDoFIndexing.hpp:43-495). Here the classes
are *derived* from Bey's red refinement of the reference tetrahedron
(see tests/test_micro_derivation.py, which re-runs the derivation) and the
index space is kept as a dense, masked (N, N, N) cube per macro-cell so that
every per-level operation is a static-shape XLA/Pallas computation.

Index convention: micro-vertex (x, y, z), 0 <= x+y+z <= n where
n = 2**level; barycentric weight of macro-vertex V0 is (n-x-y-z)/n and of
V1, V2, V3 is x/n, y/n, z/n.
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# 3D: the six micro-tet congruence classes of Bey red refinement.
# offsets[t]: (4, 3) integer vertex offsets from the class's base corner.
# base_margin[t]: base positions are {x,y,z>=0, x+y+z <= n - base_margin[t]}.
# Derived numerically (tests re-verify): one 'up' class, four octahedral
# classes, one 'down' class — volumes equal, union tiles the macro-tet.
# ---------------------------------------------------------------------------

TET_OFFSETS = np.array(
    [
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],  # UP
        [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1]],  # octahedral A
        [[1, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 1]],  # octahedral B
        [[0, 1, 0], [0, 0, 1], [1, 0, 1], [0, 1, 1]],  # octahedral C
        [[0, 1, 0], [1, 1, 0], [1, 0, 1], [0, 1, 1]],  # octahedral D
        [[1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]],  # DOWN
    ],
    dtype=np.int64,
)

TET_BASE_MARGIN = np.array([1, 2, 2, 2, 2, 3], dtype=np.int64)

NUM_TET_CLASSES = 6

# 2D: red refinement of the reference triangle -> 2 classes.
TRI_OFFSETS = np.array(
    [
        [[0, 0], [1, 0], [0, 1]],  # UP
        [[1, 0], [0, 1], [1, 1]],  # DOWN
    ],
    dtype=np.int64,
)

TRI_BASE_MARGIN = np.array([1, 2], dtype=np.int64)

NUM_TRI_CLASSES = 2


@functools.lru_cache(maxsize=None)
def vertex_mask_3d(level: int) -> np.ndarray:
    """Bool (N,N,N): True where (x,y,z) is a micro-vertex of the macro-tet."""
    n = 1 << level
    N = n + 1
    x, y, z = np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij")
    return (x + y + z) <= n


@functools.lru_cache(maxsize=None)
def vertex_mask_2d(level: int) -> np.ndarray:
    n = 1 << level
    N = n + 1
    x, y = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    return (x + y) <= n


@functools.lru_cache(maxsize=None)
def cell_base_mask(level: int, cls: int) -> np.ndarray:
    """Bool (N,N,N): True where a micro-tet of class ``cls`` has its base corner."""
    n = 1 << level
    N = n + 1
    x, y, z = np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij")
    return (x + y + z) <= n - int(TET_BASE_MARGIN[cls])


@functools.lru_cache(maxsize=None)
def face_base_mask(level: int, cls: int) -> np.ndarray:
    n = 1 << level
    N = n + 1
    x, y = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    return (x + y) <= n - int(TRI_BASE_MARGIN[cls])


@functools.lru_cache(maxsize=None)
def boundary_facet_masks_3d(level: int) -> np.ndarray:
    """Bool (4, N, N, N): micro-vertices lying on macro-face f.

    Face f is opposite macro-vertex f: face 0 = {x+y+z = n} (opposite V0),
    face 1 = {x = 0}, face 2 = {y = 0}, face 3 = {z = 0}.
    """
    n = 1 << level
    N = n + 1
    x, y, z = np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij")
    inside = (x + y + z) <= n
    return np.stack(
        [
            inside & ((x + y + z) == n),
            inside & (x == 0),
            inside & (y == 0),
            inside & (z == 0),
        ]
    )


@functools.lru_cache(maxsize=None)
def boundary_facet_masks_2d(level: int) -> np.ndarray:
    """Bool (3, N, N): micro-vertices on macro-edge e (opposite macro-vertex e)."""
    n = 1 << level
    N = n + 1
    x, y = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    inside = (x + y) <= n
    return np.stack([inside & ((x + y) == n), inside & (x == 0), inside & (y == 0)])


def interface_mask(level: int, dim: int) -> np.ndarray:
    """Micro-vertices shared with at least one neighboring macro-cell."""
    if dim == 3:
        return boundary_facet_masks_3d(level).any(axis=0)
    return boundary_facet_masks_2d(level).any(axis=0)


def interior_mask(level: int, dim: int) -> np.ndarray:
    if dim == 3:
        return vertex_mask_3d(level) & ~interface_mask(level, 3)
    return vertex_mask_2d(level) & ~interface_mask(level, 2)


def offsets(dim: int) -> np.ndarray:
    return TET_OFFSETS if dim == 3 else TRI_OFFSETS


def base_margin(dim: int) -> np.ndarray:
    return TET_BASE_MARGIN if dim == 3 else TRI_BASE_MARGIN


def num_classes(dim: int) -> int:
    return NUM_TET_CLASSES if dim == 3 else NUM_TRI_CLASSES


def vertex_mask(level: int, dim: int) -> np.ndarray:
    return vertex_mask_3d(level) if dim == 3 else vertex_mask_2d(level)


def elem_base_mask(level: int, cls: int, dim: int) -> np.ndarray:
    return cell_base_mask(level, cls) if dim == 3 else face_base_mask(level, cls)


# ---------------------------------------------------------------------------
# flat-layout variants (3D blocks are (N, N*pitch); see indexing/flat.py)
# ---------------------------------------------------------------------------


def _flatten3(m: np.ndarray, pitch: int) -> np.ndarray:
    from . import flat

    return flat.flatten_field(m, pitch)


@functools.lru_cache(maxsize=None)
def vertex_mask_flat(level: int, dim: int, pitch: int) -> np.ndarray:
    if dim == 2:
        return vertex_mask_2d(level)
    return _flatten3(vertex_mask_3d(level), pitch)


@functools.lru_cache(maxsize=None)
def interior_mask_flat(level: int, dim: int, pitch: int) -> np.ndarray:
    if dim == 2:
        return interior_mask(level, 2)
    return _flatten3(interior_mask(level, 3), pitch)


@functools.lru_cache(maxsize=None)
def elem_base_mask_flat(level: int, cls: int, dim: int, pitch: int) -> np.ndarray:
    if dim == 2:
        return face_base_mask(level, cls)
    return _flatten3(cell_base_mask(level, cls), pitch)


@functools.lru_cache(maxsize=None)
def boundary_facet_masks_flat(level: int, dim: int, pitch: int) -> np.ndarray:
    if dim == 2:
        return boundary_facet_masks_2d(level)
    return _flatten3(boundary_facet_masks_3d(level), pitch)


@functools.lru_cache(maxsize=None)
def stencil_directions(dim: int) -> np.ndarray:
    """Distinct vertex-to-vertex difference vectors over all classes (incl. 0).

    15 directions in 3D (the reference's 15-point P1 tet stencil), 7 in 2D.
    """
    offs = offsets(dim)
    dirs = set()
    for t in range(offs.shape[0]):
        for a in range(offs.shape[1]):
            for b in range(offs.shape[1]):
                dirs.add(tuple(int(v) for v in (offs[t, b] - offs[t, a])))
    return np.array(sorted(dirs), dtype=np.int64)
