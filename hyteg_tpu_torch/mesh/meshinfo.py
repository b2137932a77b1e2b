"""Coarse macro-mesh description and inline generators.

TPU-native analog of the reference's MeshInfo
(reference: src/hyteg/mesh/MeshInfo.hpp:221-637): an in-memory simplicial
coarse mesh (triangles in 2D, tetrahedra in 3D) from which the distributed
storage and all per-level structured micro-grids are built. Unlike the
reference (per-primitive object graph), everything here is flat numpy:
``points (V,3)``, ``elements (C, dim+1)`` — the shape the sharded TPU
storage wants.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """A coarse simplicial mesh.

    points:   (V, 3) float64 vertex coordinates (z = 0 for 2D meshes).
    elements: (C, dim+1) int64 — triangles (dim=2) or tetrahedra (dim=3).
    dim:      topological dimension (2 or 3).
    vertex_boundary_flag: (V,) int64 — mesh boundary flag per vertex
        (0 = interior, 1 = domain boundary by default; generators may use
        custom flags, e.g. inner/outer shell boundaries).
    """

    points: np.ndarray
    elements: np.ndarray
    dim: int
    vertex_boundary_flag: np.ndarray | None = None

    def __post_init__(self):
        assert self.points.ndim == 2 and self.points.shape[1] == 3
        assert self.elements.ndim == 2 and self.elements.shape[1] == self.dim + 1

    @property
    def num_vertices(self) -> int:
        return self.points.shape[0]

    @property
    def num_elements(self) -> int:
        return self.elements.shape[0]

    def with_computed_boundary_flags(
        self, on_boundary_flag: int = 1, inner_flag: int = 0
    ) -> "MeshInfo":
        """Flag vertices lying on boundary facets (facets in exactly 1 element).

        Mirrors setMeshBoundaryFlagsOnBoundary of the reference setup storage.
        """
        facets = boundary_facets(self.elements, self.dim)
        flags = np.full(self.num_vertices, inner_flag, dtype=np.int64)
        if facets.size:
            flags[np.unique(facets)] = on_boundary_flag
        return dataclasses.replace(self, vertex_boundary_flag=flags)


def boundary_facets(elements: np.ndarray, dim: int) -> np.ndarray:
    """(F, dim) array of facets appearing in exactly one element."""
    elements = np.asarray(elements)
    combos = list(itertools.combinations(range(dim + 1), dim))
    all_facets = np.concatenate([elements[:, c] for c in combos], axis=0)
    key = np.sort(all_facets, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    return all_facets[counts[inv] == 1]


# ---------------------------------------------------------------------------
# Generators (reference: MeshInfo.hpp meshRectangle:262, meshAnnulus:288,
# meshSphericalShell:512, meshCuboid:562, meshFaceChain:..., singleTriangle).
# ---------------------------------------------------------------------------


def _grid_vertex_ids(nx: int, ny: int, nz: int) -> np.ndarray:
    return np.arange((nx + 1) * (ny + 1) * (nz + 1)).reshape(nx + 1, ny + 1, nz + 1)


def mesh_single_triangle() -> MeshInfo:
    pts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    els = np.array([[0, 1, 2]], dtype=np.int64)
    return MeshInfo(pts, els, 2).with_computed_boundary_flags()


def mesh_single_tet() -> MeshInfo:
    pts = np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )
    els = np.array([[0, 1, 2, 3]], dtype=np.int64)
    return MeshInfo(pts, els, 3).with_computed_boundary_flags()


def mesh_rectangle(
    lower=(0.0, 0.0),
    upper=(1.0, 1.0),
    nx: int = 1,
    ny: int = 1,
    flavor: str = "criss",
) -> MeshInfo:
    """Rectangle [lower, upper] split into nx*ny quads, 2 triangles each.

    flavor 'criss' uses the / diagonal everywhere, 'cross' the \\ diagonal,
    'crisscross' adds the quad centroid (4 triangles per quad).
    """
    xs = np.linspace(lower[0], upper[0], nx + 1)
    ys = np.linspace(lower[1], upper[1], ny + 1)
    vid = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)

    els = []
    if flavor == "crisscross":
        centers = []
        cid0 = pts.shape[0]
        for i in range(nx):
            for j in range(ny):
                a, b = vid[i, j], vid[i + 1, j]
                c, d = vid[i + 1, j + 1], vid[i, j + 1]
                m = cid0 + len(centers)
                centers.append(
                    [(xs[i] + xs[i + 1]) / 2, (ys[j] + ys[j + 1]) / 2, 0.0]
                )
                els += [[a, b, m], [b, c, m], [c, d, m], [d, a, m]]
        pts = np.concatenate([pts, np.array(centers)], axis=0)
    else:
        for i in range(nx):
            for j in range(ny):
                a, b = vid[i, j], vid[i + 1, j]
                c, d = vid[i + 1, j + 1], vid[i, j + 1]
                if flavor == "criss":
                    els += [[a, b, c], [a, c, d]]
                else:
                    els += [[a, b, d], [b, c, d]]
    return MeshInfo(pts, np.array(els, dtype=np.int64), 2).with_computed_boundary_flags()


_KUHN_PERMS = list(itertools.permutations(range(3)))


def mesh_cuboid(
    lower=(0.0, 0.0, 0.0),
    upper=(1.0, 1.0, 1.0),
    nx: int = 1,
    ny: int = 1,
    nz: int = 1,
) -> MeshInfo:
    """Cuboid split into nx*ny*nz hexes, each into 6 Kuhn tetrahedra.

    Kuhn's triangulation (one tet per axis permutation, all sharing the main
    diagonal) is conforming across identical neighboring hexes.
    """
    xs = np.linspace(lower[0], upper[0], nx + 1)
    ys = np.linspace(lower[1], upper[1], ny + 1)
    zs = np.linspace(lower[2], upper[2], nz + 1)
    vid = _grid_vertex_ids(nx, ny, nz)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    els = []
    e = np.eye(3, dtype=np.int64)
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                base = np.array([i, j, k])
                for perm in _KUHN_PERMS:
                    c0 = base
                    c1 = c0 + e[perm[0]]
                    c2 = c1 + e[perm[1]]
                    c3 = c2 + e[perm[2]]
                    els.append([vid[tuple(c)] for c in (c0, c1, c2, c3)])
    return MeshInfo(pts, np.array(els, dtype=np.int64), 3).with_computed_boundary_flags()


def mesh_unit_cube(n: int = 1) -> MeshInfo:
    return mesh_cuboid(nx=n, ny=n, nz=n)


def mesh_symmetric_cuboid(
    lower=(0.0, 0.0, 0.0), upper=(1.0, 1.0, 1.0), nx: int = 1, ny: int = 1, nz: int = 1
) -> MeshInfo:
    """Alias kept for reference parity (MeshInfo::meshSymmetricCuboid)."""
    return mesh_cuboid(lower, upper, 2 * nx, 2 * ny, 2 * nz)


def mesh_annulus(
    rmin: float, rmax: float, ntan: int, nrad: int, full: bool = True
) -> MeshInfo:
    """Annulus in the x-y plane: nrad rings x ntan angular segments.

    Straight-edged macro mesh; use geometry.AnnulusMap for blending onto
    true circles (reference: MeshInfo.hpp:288, geometry/AnnulusMap.hpp).
    Boundary flags: 1 = inner rim, 2 = outer rim.
    """
    assert ntan >= 3 and nrad >= 1
    thetas = np.linspace(0.0, 2.0 * np.pi, ntan, endpoint=False)
    radii = np.linspace(rmin, rmax, nrad + 1)
    vid = np.arange((nrad + 1) * ntan).reshape(nrad + 1, ntan)
    pts = np.zeros(((nrad + 1) * ntan, 3))
    for r in range(nrad + 1):
        pts[vid[r], 0] = radii[r] * np.cos(thetas)
        pts[vid[r], 1] = radii[r] * np.sin(thetas)
    els = []
    for r in range(nrad):
        for t in range(ntan):
            t1 = (t + 1) % ntan
            a, b = vid[r, t], vid[r, t1]
            c, d = vid[r + 1, t1], vid[r + 1, t]
            els += [[a, b, c], [a, c, d]]
    flags = np.zeros(pts.shape[0], dtype=np.int64)
    flags[vid[0]] = 1
    flags[vid[-1]] = 2
    return MeshInfo(pts, np.array(els, dtype=np.int64), 2, flags)


def _icosahedron() -> tuple[np.ndarray, np.ndarray]:
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def _subdivide_sphere(verts: np.ndarray, faces: np.ndarray, times: int):
    for _ in range(times):
        edge_mid: dict[tuple[int, int], int] = {}
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, dtype=np.int64)
    return verts, faces


def mesh_spherical_shell(ntan: int, nrad: int, rmin: float, rmax: float) -> MeshInfo:
    """Thick spherical shell: icosahedral sphere x nrad radial layers.

    ntan counts subdivision steps of the icosahedron (surface has
    20*4**ntan triangles). Each radial prism splits into 3 tets using the
    global-index diagonal rule, which is conforming across prisms.
    Straight edges; use geometry.IcosahedralShellMap for blending
    (reference: MeshInfo.hpp:512, geometry/IcosahedralShellMap.hpp).
    Boundary flags: 1 = inner sphere, 2 = outer sphere.
    """
    assert nrad >= 1 and ntan >= 0
    sv, sf = _icosahedron()
    sv, sf = _subdivide_sphere(sv, sf, ntan)
    ns = sv.shape[0]
    radii = np.linspace(rmin, rmax, nrad + 1)
    pts = np.concatenate([sv * r for r in radii], axis=0)
    els = []
    for layer in range(nrad):
        lo, hi = layer * ns, (layer + 1) * ns
        for a, b, c in sf:
            els.extend(_split_prism(lo + a, lo + b, lo + c, hi + a, hi + b, hi + c))
    flags = np.zeros(pts.shape[0], dtype=np.int64)
    flags[:ns] = 1
    flags[-ns:] = 2
    return MeshInfo(pts, np.array(els, dtype=np.int64), 3, flags)


def _split_prism(a0, b0, c0, a1, b1, c1):
    """Split prism (bottom a0,b0,c0 / top a1,b1,c1) into 3 tets conformingly.

    Each quad face is cut by the diagonal from its smallest global vertex id;
    since that rule depends only on the shared face, neighboring prisms agree.
    """
    # Order the three vertical columns by bottom id; relabel so p<q<r.
    cols = sorted([(a0, a1), (b0, b1), (c0, c1)])
    (p0, p1), (q0, q1), (r0, r1) = cols
    # Quad pq cut by diag p0-q1, quad pr by p0-r1, quad qr by q0-r1.
    return [[p0, q0, r0, r1], [p0, q0, r1, q1], [p0, q1, r1, p1]]


def mesh_thin_shell(ntan: int, radius: float = 1.0) -> MeshInfo:
    """Triangular surface mesh of a sphere (2D manifold embedded in 3D)."""
    sv, sf = _icosahedron()
    sv, sf = _subdivide_sphere(sv, sf, ntan)
    return MeshInfo(sv * radius, sf, 2, np.zeros(sv.shape[0], dtype=np.int64))


def mesh_face_chain(num_faces: int) -> MeshInfo:
    """Chain of triangles sharing edges — the weak-scaling benchmark mesh
    (reference: apps/benchmarks/ApplyBenchmark/ApplyBenchmark.cpp:48-52)."""
    assert num_faces >= 1
    pts = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.5, np.sqrt(3) / 2, 0.0]]
    els = [[0, 1, 2]]
    for f in range(1, num_faces):
        a, b, c = els[-1]
        # reflect previous apex across shared edge to extend the strip
        p = np.array(pts[b]) + np.array(pts[c]) - np.array(pts[a])
        pts.append(p.tolist())
        els.append([b, c, len(pts) - 1] if f % 2 else [c, b, len(pts) - 1])
    return MeshInfo(
        np.array(pts), np.array(els, dtype=np.int64), 2
    ).with_computed_boundary_flags()


def mesh_torus(
    toroidal_resolution: int,
    poloidal_resolution: int,
    radius_orig_to_center: float = 2.0,
    radius_tube: float = 1.0,
) -> MeshInfo:
    """Torus: toroidal x poloidal grid of hexes, each split into Kuhn tets
    with periodic wrap (reference: MeshInfo.hpp:600)."""
    nt, npol = toroidal_resolution, poloidal_resolution
    assert nt >= 3 and npol >= 3
    # vertices: center ring + tube surface rings -> use (nt) x (npol+1 radial?)
    # Simple conforming construction: hollow-free solid torus via prisms from
    # tube center line to surface: center ring points + surface grid.
    centers = []
    surface = []
    R, r = radius_orig_to_center, radius_tube
    for i in range(nt):
        phi = 2 * np.pi * i / nt
        cx, cy = R * np.cos(phi), R * np.sin(phi)
        centers.append([cx, cy, 0.0])
        for j in range(npol):
            theta = 2 * np.pi * j / npol
            rr = R + r * np.cos(theta)
            surface.append([rr * np.cos(phi), rr * np.sin(phi), r * np.sin(theta)])
    pts = np.array(centers + surface)
    cid = lambda i: i % nt
    sid = lambda i, j: nt + (i % nt) * npol + (j % npol)
    els = []
    for i in range(nt):
        for j in range(npol):
            # wedge between center segment (c_i, c_{i+1}) and surface quad
            a0, b0 = cid(i), cid(i + 1)
            p0, q0 = sid(i, j), sid(i, j + 1)
            p1, q1 = sid(i + 1, j), sid(i + 1, j + 1)
            # two prisms: (a0,p0,q0)-(b0,p1,q1) split conformingly
            els.extend(_split_prism(a0, p0, q0, b0, p1, q1))
    mesh = MeshInfo(pts, np.array(els, dtype=np.int64), 3)
    return mesh.with_computed_boundary_flags()


# ---------------------------------------------------------------------------
# Gmsh reader (MSH 2.2 and 4.1 ASCII; reference: MeshInfo::fromGmshFile)
# ---------------------------------------------------------------------------


def from_gmsh_file(path: str) -> MeshInfo:
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0

    def seek(tag: str) -> int:
        nonlocal i
        while i < len(lines) and lines[i].strip() != tag:
            i += 1
        if i == len(lines):
            raise ValueError(f"gmsh: missing {tag}")
        i += 1
        return i

    seek("$MeshFormat")
    version = lines[i].split()[0]
    i = 0
    if version.startswith("2"):
        return _read_msh2(lines)
    if version.startswith("4"):
        return _read_msh4(lines)
    raise ValueError(f"unsupported gmsh version {version}")


def _read_msh2(lines: list[str]) -> MeshInfo:
    idx = lines.index("$Nodes") + 1
    n = int(lines[idx])
    ids, coords = [], []
    for k in range(n):
        parts = lines[idx + 1 + k].split()
        ids.append(int(parts[0]))
        coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
    remap = {g: i for i, g in enumerate(ids)}
    pts = np.array(coords)

    idx = lines.index("$Elements") + 1
    ne = int(lines[idx])
    tris, tets = [], []
    for k in range(ne):
        parts = lines[idx + 1 + k].split()
        etype = int(parts[1])
        ntags = int(parts[2])
        nodes = [remap[int(p)] for p in parts[3 + ntags:]]
        if etype == 2:
            tris.append(nodes)
        elif etype == 4:
            tets.append(nodes)
    if tets:
        mesh = MeshInfo(pts, np.array(tets, dtype=np.int64), 3)
    elif tris:
        mesh = MeshInfo(pts, np.array(tris, dtype=np.int64), 2)
    else:
        raise ValueError("gmsh: no triangles or tetrahedra")
    return mesh.with_computed_boundary_flags()


def _read_msh4(lines: list[str]) -> MeshInfo:
    i = lines.index("$Nodes") + 1
    nblocks, ntotal = int(lines[i].split()[0]), int(lines[i].split()[1])
    i += 1
    ids, coords = [], []
    for _ in range(nblocks):
        _, _, parametric, nnodes = (int(v) for v in lines[i].split())
        i += 1
        block_ids = [int(lines[i + k]) for k in range(nnodes)]
        i += nnodes
        for k in range(nnodes):
            parts = lines[i + k].split()
            coords.append([float(parts[0]), float(parts[1]), float(parts[2])])
        i += nnodes
        ids.extend(block_ids)
    remap = {g: i for i, g in enumerate(ids)}
    pts = np.array(coords)

    i = lines.index("$Elements") + 1
    nblocks = int(lines[i].split()[0])
    i += 1
    tris, tets = [], []
    for _ in range(nblocks):
        _, _, etype, nelems = (int(v) for v in lines[i].split())
        i += 1
        for k in range(nelems):
            parts = [int(v) for v in lines[i + k].split()]
            nodes = [remap[p] for p in parts[1:]]
            if etype == 2:
                tris.append(nodes)
            elif etype == 4:
                tets.append(nodes)
        i += nelems
    if tets:
        mesh = MeshInfo(pts, np.array(tets, dtype=np.int64), 3)
    elif tris:
        mesh = MeshInfo(pts, np.array(tris, dtype=np.int64), 2)
    else:
        raise ValueError("gmsh: no triangles or tetrahedra")
    return mesh.with_computed_boundary_flags()
