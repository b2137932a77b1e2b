"""VTK (VTU) export of P1 / P2 functions on refined micro-grids (torch
counterpart of hyteg_tpu/io/vtk.py; the same files for the same fields).

Reference: src/hyteg/dataexport/VTKOutput/VTKOutput.hpp:63-93. Writes
XML-format unstructured-grid files: all micro-vertices of every macro-cell
(replicated interface points included, as in the reference's per-primitive
output) and the micro-element connectivity.

Default encoding is inline base64 binary (format="binary",
header_type="UInt32"), ~4x smaller and ~100x faster to write than ASCII
tables; pass ``ascii=True`` for the human-readable form. Blocks may lie on
the card: they are copied to the host to be written. ``write(level)`` takes
the level of the spaces' node grid: a P2 space of level L is written at
L + 1, where its nodes lie (the JAX package's app passes L, which does not
fit; ROADMAP C-ref20).
"""

from __future__ import annotations

import base64
import struct

import numpy as np
import torch

from ..indexing import micro


def _host(a) -> np.ndarray:
    """A tensor (on any device; bf16 as its f32 values) or array as
    numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)

_VTK_TET = 10
_VTK_TRI = 5


def _b64(arr: np.ndarray) -> str:
    """Inline-binary VTU payload: base64(UInt32 byte count + raw data)."""
    raw = np.ascontiguousarray(arr).tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def _write_array(f, arr, vtk_type: str, name: str | None = None,
                 ncomp: int | None = None, ascii_: bool = False,
                 fmt: str = "%.8g"):
    attrs = f' type="{vtk_type}"'
    if name is not None:
        attrs += f' Name="{name}"'
    if ncomp is not None:
        attrs += f' NumberOfComponents="{ncomp}"'
    if ascii_:
        f.write(f"<DataArray{attrs} format=\"ascii\">\n")
        np.savetxt(f, arr, fmt=fmt)
    else:
        f.write(f"<DataArray{attrs} format=\"binary\">\n")
        f.write(_b64(arr))
        f.write("\n")
    f.write("</DataArray>\n")


def _micro_connectivity(level: int, dim: int) -> np.ndarray:
    """(n_elems, dim+1) indices into the flattened (N,)*dim cube of one cell."""
    N = (1 << level) + 1
    offs = micro.offsets(dim)
    conn = []
    for t in range(offs.shape[0]):
        bases = np.argwhere(micro.elem_base_mask(level, t, dim))
        ids = []
        for a in range(dim + 1):
            pos = bases + offs[t, a]
            flat = pos[:, 0]
            for d in range(1, dim):
                flat = flat * N + pos[:, d]
            ids.append(flat)
        conn.append(np.stack(ids, axis=1))
    return np.concatenate(conn, axis=0)


class VTKOutput:
    """Collects named functions and writes .vtu files."""

    def __init__(self, directory: str, basename: str, storage):
        self.dir = directory
        self.base = basename
        self.storage = storage
        self._functions = []  # (name, space, get_cells)

    def add(self, name: str, space, cells_array):
        self._functions.append((name, space, _host(cells_array)))

    def write(self, level: int, timestep: int = 0,
              ascii: bool = False) -> str:
        import os

        assert self._functions, "nothing registered"
        space = self._functions[0][1]
        dim = space.dim
        N = (1 << level) + 1
        vm = micro.vertex_mask(level, dim).reshape(-1)
        coords = _host(space.coords(0)).astype(np.float64)
        if coords.shape[1] != N:
            raise ValueError(
                f"level {level} has {N} points per macro-edge; the space's "
                f"node grid has {coords.shape[1]} (a P2 space of level L is "
                "written at level L + 1)")
        C = coords.shape[0]
        block = N**dim
        valid_cells = self.storage.cell_valid[: C]
        if dim == 3:  # flat (C, N, lanes, 3) -> grid (C, N, N, N, 3)
            from ..indexing import flat

            pitch = coords.shape[2] // coords.shape[1]
            coords = flat.unflatten_field(
                coords.transpose(0, 3, 1, 2), N, pitch
            ).transpose(0, 2, 3, 4, 1)

        # per-cell point blocks (masked positions included but unused)
        conn1 = _micro_connectivity(level, dim)
        pts = coords.reshape(C, block, 3)[valid_cells]
        ncell = pts.shape[0]
        points = pts.reshape(-1, 3)
        conn = (
            conn1[None, :, :] + (np.arange(ncell) * block)[:, None, None]
        ).reshape(-1, dim + 1)
        ctype = _VTK_TET if dim == 3 else _VTK_TRI

        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"{self.base}_ts{timestep}.vtu")
        with open(path, "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                    'byte_order="LittleEndian" header_type="UInt32">\n'
                    '<UnstructuredGrid>\n')
            f.write(f'<Piece NumberOfPoints="{points.shape[0]}" '
                    f'NumberOfCells="{conn.shape[0]}">\n')
            f.write("<Points>\n")
            _write_array(f, points.astype(np.float64), "Float64", ncomp=3,
                         ascii_=ascii, fmt="%.10g")
            f.write("</Points>\n<Cells>\n")
            _write_array(f, conn.astype(np.int64), "Int64", "connectivity",
                         ascii_=ascii, fmt="%d")
            _write_array(f, ((np.arange(conn.shape[0]) + 1)
                             * (dim + 1)).astype(np.int64), "Int64",
                         "offsets", ascii_=ascii, fmt="%d")
            _write_array(f, np.full(conn.shape[0], ctype, np.uint8),
                         "UInt8", "types", ascii_=ascii, fmt="%d")
            f.write("</Cells>\n<PointData>\n")
            for name, sp, cells in self._functions:
                if dim == 3:
                    from ..indexing import flat

                    pitch = cells.shape[2] // cells.shape[1]
                    cells = flat.unflatten_field(cells, N, pitch)
                vals = cells.reshape(C, -1)[valid_cells].reshape(-1)
                _write_array(f, vals.astype(np.float32), "Float32", name,
                             ascii_=ascii)
            f.write("</PointData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
        return path


def write_domain_partitioning_vtk(storage, directory: str, basename: str) -> str:
    """Macro-mesh + shard assignment (reference: writeDomainPartitioningVTK)."""
    import os

    topo = storage.topo
    dim = topo.dim
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{basename}_partitioning.vtu")
    els = topo.elements
    ctype = _VTK_TET if dim == 3 else _VTK_TRI
    shard_of = np.zeros(els.shape[0], dtype=np.int64)
    for slot in range(storage.num_cells):
        gci = storage.cell_global_index[slot]
        if gci >= 0:
            shard_of[gci] = slot // storage.cells_per_shard
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n<VTKFile type="UnstructuredGrid" '
                'version="0.1" byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{topo.num_vertices}" '
                f'NumberOfCells="{els.shape[0]}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        np.savetxt(f, topo.points, fmt="%.10g")
        f.write("</DataArray></Points>\n<Cells>\n")
        f.write('<DataArray type="Int64" Name="connectivity" format="ascii">\n')
        np.savetxt(f, els, fmt="%d")
        f.write('</DataArray>\n<DataArray type="Int64" Name="offsets" format="ascii">\n')
        np.savetxt(f, (np.arange(els.shape[0]) + 1) * (dim + 1), fmt="%d")
        f.write('</DataArray>\n<DataArray type="UInt8" Name="types" format="ascii">\n')
        np.savetxt(f, np.full(els.shape[0], ctype), fmt="%d")
        f.write("</DataArray>\n</Cells>\n<CellData>\n")
        f.write('<DataArray type="Int64" Name="shard" format="ascii">\n')
        np.savetxt(f, shard_of, fmt="%d")
        f.write("</DataArray>\n</CellData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
    return path
