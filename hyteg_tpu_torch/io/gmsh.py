"""Gmsh MSH 2.2 ASCII export for coarse meshes (torch counterpart of
hyteg_tpu/io/gmsh.py; host numpy, the same bytes).

Round-trips with the MSH readers in mesh/meshinfo.py (reference analog:
the reference reads .msh via MeshInfo::fromGmshFile and ships meshes in
data/meshes/; exporting lets users inspect generated meshes in Gmsh and
feed them back through any MSH pipeline)."""

from __future__ import annotations

import numpy as np

from ..mesh.meshinfo import MeshInfo

_ELEM_TYPE = {2: 2, 3: 4}  # gmsh: 2 = triangle, 4 = tetrahedron


def write_msh2(mesh: MeshInfo, path: str) -> None:
    """Write the coarse mesh as MSH 2.2 ASCII (1-based node ids)."""
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat"]
    lines.append("$Nodes")
    lines.append(str(mesh.num_vertices))
    for i, p in enumerate(np.asarray(mesh.points, dtype=float)):
        lines.append(f"{i + 1} {p[0]:.16g} {p[1]:.16g} {p[2]:.16g}")
    lines.append("$EndNodes")
    lines.append("$Elements")
    lines.append(str(mesh.num_elements))
    et = _ELEM_TYPE[mesh.dim]
    for i, el in enumerate(np.asarray(mesh.elements)):
        nodes = " ".join(str(v + 1) for v in el)
        # two default tags (physical group, geometric entity)
        lines.append(f"{i + 1} {et} 2 0 0 {nodes}")
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
