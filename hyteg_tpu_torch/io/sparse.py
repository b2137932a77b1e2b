"""Sparse assembly of matrix-free operators + direct coarse solves; torch
counterpart of hyteg_tpu/io/sparse.py.

Analog of the reference's SparseMatrixProxy / PETSc bridge
(reference: src/hyteg/sparseassembly/SparseMatrixProxy.hpp:34-61,
src/hyteg/petsc/PETScLUSolver.hpp): an elementwise operator is assembled
into a scipy CSR matrix from its per-class element matrices and the global
DoF numbering, on the host. The direct solve factorizes once with scipy's
sparse LU; blocks move between the device and the host only at the
solver's edges (one copy in, one copy out per solve).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..indexing import micro


def _assemble(space, elmats, node_offs, bases_of, scale: int) -> sps.csr_matrix:
    """COO -> CSR over every valid cell and class: rows/cols are the global
    ids at ``scale * base + node_offs[t, a]`` of each class-t base."""
    storage = space.storage
    elmats = elmats.detach().cpu().numpy().astype(np.float64)
    nn = node_offs.shape[1]
    rows, cols, vals = [], [], []
    gids = space.global_ids_grid(0)
    for c in range(storage.cells_per_shard):
        if not storage.cell_valid[c]:
            continue
        for t in range(node_offs.shape[0]):
            bases = bases_of(t)
            if bases.size == 0:
                continue
            ids = np.stack([gids[(c,) + tuple((scale * bases
                                               + node_offs[t, a]).T)]
                            for a in range(nn)], axis=1)  # (nb, nn)
            rows.append(np.repeat(ids, nn, axis=1).ravel())
            cols.append(np.tile(ids, (1, nn)).ravel())
            vals.append(np.tile(elmats[c, t].ravel(), ids.shape[0]))
    ndof = space.num_global_dofs()
    return sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(ndof, ndof)).tocsr()


def assemble_p1_csr(op, bc=None) -> sps.csr_matrix:
    """Assemble a P1ElementwiseOperator into CSR (global DoF numbering)."""
    space = op.space
    return _assemble(
        space, op.elmats, micro.offsets(space.dim),
        lambda t: np.argwhere(micro.elem_base_mask(space.level, t, space.dim)),
        1)


def assemble_p2_csr(op) -> sps.csr_matrix:
    """Assemble a P2ElementwiseOperator into CSR."""
    from ..operators.p2_elementwise import p2_node_offsets

    space = op.space
    dim, n = space.dim, space.n
    return _assemble(
        space, op.elmats, p2_node_offsets(dim),
        lambda t: np.argwhere(micro.elem_base_mask(space.level, t, dim)[
            (slice(0, n),) * dim]),
        2)


def dirichlet_reduced(A: sps.csr_matrix, inner_mask: np.ndarray):
    """A restricted to inner x inner (Dirichlet elimination helper)."""
    idx = np.nonzero(inner_mask)[0]
    return A[np.ix_(idx, idx)], idx


class DirectCoarseSolver:
    """Sparse-LU solve of a P1 or P2 operator's Dirichlet-reduced matrix
    (reference: PETScLUSolver used as the GMG coarse solver)."""

    def __init__(self, op, bc: BoundaryCondition | None = None,
                 kind: str = "p1"):
        space = op.space
        A = assemble_p1_csr(op) if kind == "p1" else assemble_p2_csr(op)
        m = space.maps if kind == "p1" else space.node_space.maps
        ndof = space.num_global_dofs()
        bc = bc or BoundaryCondition.all_dirichlet()
        inner = np.ones(ndof, dtype=bool)
        # interface DoFs whose mesh flag is Dirichlet under ``bc``
        for f in np.unique(m.ifc_meshflag):
            if bc.doftype_of(int(f)) == DoFType.DIRICHLET:
                inner[: m.num_ifc][m.ifc_meshflag == f] = False
        Ared, self.idx = dirichlet_reduced(A, inner)
        self.lu = spla.splu(Ared.tocsc())
        self.space = space
        self.ndof = ndof
        self._gids = space.global_ids(0)
        self._sel = self._gids >= 0

    def _solve_host(self, b_blocks: np.ndarray) -> np.ndarray:
        bv = np.zeros(self.ndof, dtype=np.float64)
        bv[self._gids[self._sel]] = b_blocks[self._sel]
        x = np.zeros(self.ndof)
        x[self.idx] = self.lu.solve(bv[self.idx])
        out = np.zeros(self._gids.shape, dtype=np.float64)
        out[self._sel] = x[self._gids[self._sel]]
        return out

    def __call__(self, b: torch.Tensor, x0: torch.Tensor | None = None):
        """Solve A x = b on the inner rows; Dirichlet rows of the result
        are 0, or x0's when it is given. The result lies on b's device."""
        xh = self._solve_host(b.detach().cpu().numpy().astype(np.float64))
        x = torch.as_tensor(xh, dtype=b.dtype, device=b.device)
        if x0 is not None:
            x = self.space.restore_rows(x, x0, FLAG_INNER, None)
        return x
