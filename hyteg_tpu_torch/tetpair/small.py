"""Small-space halo exchange for the paired-tet path (torch counterpart of
hyteg_tpu/tetpair/small.py).

Operates entirely on compact face arrays (O(C * N^2) data, a few MB): the
canonical-frame face pairing, edge and vertex accumulation of the
reference's dimension-ordered halo protocol (reference:
src/hyteg/communication/BufferedCommunication.hpp:119 and the additive
PackInfos), with the metadata and triangle-symmetry transforms of
tetpair/ifc.py. Plain torch: gathers and ``index_add_``.

Data flow per apply:

    kernel face outputs (stored-coords layouts)
      -> per-cell own-coords planes (C, 4, N, N)     [B halves flipped]
      -> canon faces, pair-sum over macro faces
      -> edge lines from face borders, flip-canon, segment-sum
      -> vertex corners, segment-sum
      -> reassembled per-cell planes (borders overwritten with edge/vert
         sums, so every plane is fully consistent)
      -> kernel face input layouts
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .ifc import IfcMeta, _apply_seq, _transform_sequences


def _canon_grouped(ifc: IfcMeta, rows: torch.Tensor,
                   inverse: bool) -> torch.Tensor:
    """Map (R, N, N) face rows to (or from) their macro-face canonical
    frame: rows are grouped by their permutation id and each group gets
    exactly its own transform. With sorted-vertex storages every
    permutation is the identity and this is a no-op
    (primitives/topology.py)."""
    ident = ifc.perms.index((0, 1, 2))
    if bool(np.all(ifc.face_perm_id == ident)):
        return rows
    seqs = _transform_sequences(ifc.N)
    out = torch.empty_like(rows)
    for pid, perm in enumerate(ifc.perms):
        ridx = np.flatnonzero(ifc.face_perm_id == pid)
        if ridx.size:
            idx = torch.as_tensor(ridx, device=rows.device)
            seq, iseq = seqs[perm]
            out[idx] = _apply_seq(rows[idx], iseq if inverse else seq)
    return out


# face lf border -> local edge index (edges ordered as ifc._LOCAL_EDGES_3D)
_P0_EDGE = (4, 2, 2, 1)   # border p = 0, line parametrized by q
_Q0_EDGE = (3, 1, 0, 0)   # border q = 0, line parametrized by p
_DG_EDGE = (5, 5, 4, 3)   # border p + q = n, line parametrized by q
_LOCAL_FACES = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def faces_to_planes(xfo, yfo, zfo, dfo, N: int, P: int) -> torch.Tensor:
    """Kernel face layouts -> (C, 4, N, N) own-coords planes.

    C = 2 * Cp with cells interleaved (even = A half, odd = B half);
    planes follow the face[p, q] <-> (n-p-q, p, q) convention, in the
    order [diagonal, x, y, z] (local face k is opposite vertex k)."""
    Cp = xfo.shape[0]

    def grid(a):  # (Cp, L) -> (Cp, N, N)
        return a.reshape(Cp, N, P)[:, :, :N]

    fa = torch.stack(
        [grid(dfo[:, 0]), grid(xfo[:, 0]), yfo[:, 0, :, :N], zfo[:, 0]],
        dim=1)
    fb = torch.stack(
        [grid(dfo[:, 1]), grid(xfo[:, 1]), yfo[:, 1, :, :N], zfo[:, 1]],
        dim=1).flip(-2, -1)
    return torch.stack([fa, fb], dim=1).reshape(2 * Cp, 4, N, N)


def planes_to_faces(planes: torch.Tensor, N: int, P: int):
    """(C, 4, N, N) own-coords planes -> kernel face layouts
    (xf (Cp, 2, L), yf (Cp, 2, N, P), zf (Cp, 2, N, N), df (Cp, 2, L)),
    padding lanes zero."""
    Cp = planes.shape[0] // 2
    pr = planes.reshape(Cp, 2, 4, N, N)
    pr = torch.stack([pr[:, 0], pr[:, 1].flip(-2, -1)], dim=1)
    if P > N:
        padded = torch.nn.functional.pad(pr, (0, P - N))
    else:
        padded = pr
    xf = padded[:, :, 1].reshape(Cp, 2, N * P)
    df = padded[:, :, 0].reshape(Cp, 2, N * P)
    yf = padded[:, :, 2].contiguous()
    zf = pr[:, :, 3].contiguous()
    return xf.contiguous(), yf, zf, df.contiguous()


@functools.lru_cache(maxsize=8)
def _diag_index(N: int, device):
    t = torch.arange(N, device=device)
    return N - 1 - t, t


def _edges_from_planes(planes: torch.Tensor, N: int) -> torch.Tensor:
    """(C, 6, N) edge lines (param = weight of the edge's second vertex)."""
    f0, f1, f2, f3 = (planes[:, k] for k in range(4))
    rows, cols = _diag_index(N, planes.device)
    dg = lambda f: f[:, rows, cols]  # dg(f)[t] = f[n-t, t]
    e01 = f2[:, :, 0]
    e02 = f1[:, :, 0]
    e03 = f1[:, 0, :]
    e12 = dg(f3)
    e13 = dg(f2)
    e23 = dg(f1)
    return torch.stack([e01, e02, e03, e12, e13, e23], dim=1)


def _verts_from_planes(planes: torch.Tensor, N: int) -> torch.Tensor:
    n = N - 1
    f1, f2, f3 = planes[:, 1], planes[:, 2], planes[:, 3]
    return torch.stack(
        [f1[:, 0, 0], f2[:, n, 0], f3[:, 0, n], f1[:, 0, n]], dim=1)


@functools.lru_cache(maxsize=8)
def _exchange_tables(ifc: IfcMeta, device):
    """Device-resident index tables of one exchange."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return {
        "mA": t(np.maximum(ifc.face_members[:, 0], 0).astype(np.int64)),
        "mB": t(np.maximum(ifc.face_members[:, 1], 0).astype(np.int64)),
        "hasB": t((ifc.face_members[:, 1] >= 0).astype(np.float32)),
        "face_macro": t(ifc.face_macro.astype(np.int64)),
        "edge_macro": t(ifc.edge_macro.astype(np.int64)),
        "edge_flip": t(ifc.edge_flip[:, None]),
        "vert_macro": t(ifc.vert_macro.astype(np.int64)),
    }


def exchange_planes(ifc: IfcMeta, planes: torch.Tensor) -> torch.Tensor:
    """Additive exchange on per-cell face planes: returns planes where
    every position holds the full sum over all sharing cells."""
    N = ifc.N
    n = N - 1
    C = planes.shape[0]
    tab = _exchange_tables(ifc, planes.device)

    # faces: canon -> pair sum -> back
    canon = _canon_grouped(ifc, planes.reshape(C * 4, N, N), inverse=False)
    summed = canon[tab["mA"]] + canon[tab["mB"]] * tab["hasB"][:, None, None]
    fsum = _canon_grouped(ifc, summed[tab["face_macro"]],
                          inverse=True).reshape(C, 4, N, N)

    # edges: flip-canon -> segment sum -> back (flips vanish on
    # sorted-vertex storages)
    edges = _edges_from_planes(planes, N).reshape(C * 6, N)
    any_flip = bool(ifc.edge_flip.any())
    flip = tab["edge_flip"]
    canon_e = torch.where(flip, edges.flip(-1), edges) if any_flip else edges
    esum = torch.zeros((ifc.num_macro_edges, N), dtype=planes.dtype,
                       device=planes.device)
    esum.index_add_(0, tab["edge_macro"], canon_e)
    eback = esum[tab["edge_macro"]]
    if any_flip:
        eback = torch.where(flip, eback.flip(-1), eback)
    eback = eback.reshape(C, 6, N)

    # vertices
    verts = _verts_from_planes(planes, N).reshape(-1)
    vsum = torch.zeros(ifc.num_macro_verts, dtype=planes.dtype,
                       device=planes.device)
    vsum.index_add_(0, tab["vert_macro"], verts)
    vback = vsum[tab["vert_macro"]].reshape(C, 4)

    # reassemble: overwrite borders with edge sums, corners with vert sums
    rows, cols = _diag_index(N, planes.device)
    out = fsum.clone()
    for lf in range(4):
        pl_ = out[:, lf]
        pl_[:, 0, :] = eback[:, _P0_EDGE[lf]]
        pl_[:, :, 0] = eback[:, _Q0_EDGE[lf]]
        pl_[:, rows, cols] = eback[:, _DG_EDGE[lf]]
        tri = _LOCAL_FACES[lf]
        pl_[:, 0, 0] = vback[:, tri[0]]
        pl_[:, n, 0] = vback[:, tri[1]]
        pl_[:, 0, n] = vback[:, tri[2]]
    return out
