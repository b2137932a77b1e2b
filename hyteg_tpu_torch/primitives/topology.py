"""Macro-mesh topology: vertices, edges, faces, cells + boundary flags.

Flat-array analog of the reference's primitive graph
(reference: src/hyteg/primitives/, src/hyteg/primitivestorage/
SetupPrimitiveStorage.cpp:86). Instead of per-primitive objects with
128-bit ids and neighborhood lists, we keep numpy index arrays: the TPU
runtime only needs (a) canonical sub-simplex enumeration to build global
DoF numbering and interface maps and (b) per-primitive boundary flags.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from ..mesh.meshinfo import MeshInfo, boundary_facets


@dataclasses.dataclass(frozen=True)
class MacroTopology:
    """Canonical macro-entity enumeration of a simplicial mesh.

    All sub-simplices are keyed by their *sorted* global vertex tuple; this
    canonical orientation makes micro-DoF enumeration on shared interfaces
    agree between neighboring elements without orientation tables.
    """

    dim: int
    points: np.ndarray               # (V, 3)
    elements: np.ndarray             # (C, dim+1) — vertex ids, as given by mesh
    edges: np.ndarray                # (E, 2) sorted vertex ids
    faces: np.ndarray                # (F, 3) sorted vertex ids (3D only, else (0,3))
    vertex_flag: np.ndarray          # (V,)
    edge_flag: np.ndarray            # (E,)
    face_flag: np.ndarray            # (F,)
    cell_flag: np.ndarray            # (C,)

    @property
    def num_vertices(self) -> int:
        return self.points.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_cells(self) -> int:
        return self.elements.shape[0]


def _unique_subsimplices(elements: np.ndarray, k: int) -> np.ndarray:
    """All unique sorted k-vertex sub-simplices of the elements."""
    combos = list(itertools.combinations(range(elements.shape[1]), k))
    allk = np.concatenate([elements[:, c] for c in combos], axis=0)
    allk = np.sort(allk, axis=1)
    return np.unique(allk, axis=0)


def build_topology(mesh: MeshInfo) -> MacroTopology:
    dim = mesh.dim
    # Canonical local vertex order: ascending global id (Bey's sorted-vertex
    # rule). This makes the per-cell Kuhn micro-refinement conforming across
    # every shared face/edge and turns all interface frame transforms into
    # identities (every face triple / edge pair of a sorted cell is itself
    # sorted) — the exchange fast paths in functions/ifc_dense.py and
    # tetpair/small.py rely on it. P1 spaces are insensitive to the
    # orientation change (forms use |det J|).
    elements = np.sort(np.asarray(mesh.elements, dtype=np.int64), axis=1)
    edges = _unique_subsimplices(elements, 2)
    faces = (
        _unique_subsimplices(elements, 3) if dim == 3 else np.zeros((0, 3), np.int64)
    )

    if mesh.vertex_boundary_flag is not None:
        vflag = np.asarray(mesh.vertex_boundary_flag, dtype=np.int64)
    else:
        vflag = mesh.with_computed_boundary_flags().vertex_boundary_flag

    # Boundary facets of the mesh determine edge/face flags: a sub-simplex is
    # flagged iff it lies inside some boundary facet; the flag value is the
    # (max-combined) flag of that facet's vertices — matching the reference's
    # convention that generator-assigned vertex flags induce facet flags.
    bfacets = boundary_facets(elements, dim)  # (B, dim) unsorted
    bf_sorted = np.sort(bfacets, axis=1) if bfacets.size else bfacets
    facet_flag = (
        vflag[bf_sorted].max(axis=1) if bfacets.size else np.zeros(0, np.int64)
    )
    # all flagged sub-simplices: map sorted tuple -> flag
    sub_flags: dict[tuple, int] = {}
    for facet, fl in zip(bf_sorted, facet_flag):
        fverts = [int(v) for v in facet]
        for k in range(1, dim + 1):
            for c in itertools.combinations(sorted(fverts), k):
                prev = sub_flags.get(c, 0)
                sub_flags[c] = max(prev, int(fl))

    def flags_for(simplices: np.ndarray) -> np.ndarray:
        out = np.zeros(simplices.shape[0], dtype=np.int64)
        for i, s in enumerate(simplices):
            out[i] = sub_flags.get(tuple(int(v) for v in s), 0)
        return out

    edge_flag = flags_for(edges)
    face_flag = flags_for(faces) if dim == 3 else np.zeros(0, np.int64)
    cell_flag = np.zeros(elements.shape[0], dtype=np.int64)

    return MacroTopology(
        dim=dim,
        points=np.asarray(mesh.points, dtype=np.float64),
        elements=elements,
        edges=edges,
        faces=faces,
        vertex_flag=vflag,
        edge_flag=edge_flag,
        face_flag=face_flag,
        cell_flag=cell_flag,
    )


def simplex_index_map(simplices: np.ndarray) -> dict[tuple, int]:
    """sorted-vertex-tuple -> row index."""
    return {tuple(int(v) for v in s): i for i, s in enumerate(simplices)}
