"""Interface metadata and triangle-symmetry transforms of the paired-tet
exchange (the part of hyteg_tpu/functions/ifc_dense.py that the engine
uses).

Every interface DoF of a macro-tet lies on one of its four faces, six
edges or four vertices. ``build_ifc`` maps each (cell, local face) row to
its macro-face and to the symmetry that takes the face's parametrization
into the macro-face's canonical frame (sorted global vertex ids), each
(cell, local edge) row to its macro-edge and orientation, and each
(cell, local vertex) to its macro-vertex. The exchange itself
(tetpair/small.py) sums over these maps with ``index_add_`` and gathers;
the JAX package's dense one-hot exchange is a TPU gather workaround and is
not ported.

Face planes: face[p, q] <-> barycentric weights (n-p-q, p, q) over the
face's ordered local vertex triple. The six symmetries of the triangle
are compositions of the transpose T and the shear S, out[p, q] =
in[p, n-p-q] (an index gather; 0 where p + q > n).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch

_LOCAL_FACES = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
_LOCAL_EDGES_3D = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


# ---------------------------------------------------------------------------
# triangle symmetries
# ---------------------------------------------------------------------------


def _apply_perm_coords(perm, p, q, n):
    """Coordinates (p', q') such that canon[p', q'] = face[p, q] when the
    face's ordered vertex triple is permuted by ``perm`` to the canonical
    (sorted) order: weights (n-p-q, p, q) -> take entries perm[1], perm[2]."""
    w = (n - p - q, p, q)
    return w[perm[1]], w[perm[2]]


def _op_T(a: torch.Tensor) -> torch.Tensor:  # transpose
    return a.transpose(-1, -2)


@functools.lru_cache(maxsize=None)
def _shear_index(N: int):
    """(k (N, N) int64, valid (N, N) bool): out[p, q] = in[p, k[p, q]]
    with k = n - p - q where p + q <= n."""
    n = N - 1
    p, q = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    k = n - p - q
    valid = k >= 0
    return np.where(valid, k, 0).astype(np.int64), valid


def _op_S(a: torch.Tensor) -> torch.Tensor:  # shear: out[p, q] = in[p, n-p-q]
    N = a.shape[-1]
    k, valid = _shear_index(N)
    k = torch.as_tensor(k, device=a.device).expand(a.shape)
    out = torch.gather(a, -1, k)
    return out * torch.as_tensor(valid, dtype=a.dtype, device=a.device)


@functools.lru_cache(maxsize=None)
def _transform_sequences(N: int):
    """For each vertex permutation (as tuple), a sequence of ops ('T'/'S')
    realizing canon = seq(face), plus the inverse sequence. Found by search
    over compositions (length <= 4)."""
    n = N - 1
    # sample coordinates: enough triangle points to identify each of the
    # 6 symmetries (the whole triangle for small N)
    samples = [(p, q) for p in range(N) for q in range(N - p)][:64]

    def sig(fn):
        return tuple(fn(p, q) for (p, q) in samples)

    # coordinate maps of the dense ops: out[p, q] = in[m(p, q)]
    def m_T(p, q):
        return (q, p)

    def m_S(p, q):
        return (p, n - p - q)

    def compose(seq):
        def f(p, q):
            for op in reversed(seq):  # out = op1(op2(...(in)))
                p, q = (m_T(p, q) if op == "T" else m_S(p, q))
            return (p, q)
        return f

    seq_by_sig = {}
    for L in range(0, 5):
        for seq in itertools.product("TS", repeat=L):
            s = sig(compose(list(seq)))
            seq_by_sig.setdefault(s, list(seq))

    out = {}
    for perm in itertools.permutations(range(3)):
        # canon[a, b] = face[m(a, b)]
        inv = {perm[i]: i for i in range(3)}  # position of weight i

        def m_canon(a, b, inv=inv):
            wc = (n - a - b, a, b)
            wf = tuple(wc[inv[j]] for j in range(3))
            return wf[1], wf[2]

        key = sig(m_canon)
        if key not in seq_by_sig:
            raise AssertionError(f"no op sequence for perm {perm}")

        # inverse: face[p, q] = canon[m'(p, q)]
        def m_face(p, q, perm=perm):
            return _apply_perm_coords(perm, p, q, n)

        ikey = sig(m_face)
        if ikey not in seq_by_sig:
            raise AssertionError(f"no inverse op sequence for perm {perm}")
        out[perm] = (tuple(seq_by_sig[key]), tuple(seq_by_sig[ikey]))
    return out


def _apply_seq(a: torch.Tensor, seq) -> torch.Tensor:
    for op in seq:
        a = _op_T(a) if op == "T" else _op_S(a)
    return a


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class IfcMeta:
    """Interface maps of a single-shard 3D storage (host numpy). Hashed by
    identity, so that per-device tables can be cached against it."""

    N: int
    face_perm_id: np.ndarray    # (C*4,) int32 in [0, 6): index into perms
    face_macro: np.ndarray      # (C*4,) int32 macro-face id
    face_members: np.ndarray    # (F, 2) int32 rows into C*4, -1 if none
    edge_flip: np.ndarray       # (C*6,) bool: canonical param = 1 - local
    edge_macro: np.ndarray      # (C*6,) int32 macro-edge id
    num_macro_edges: int
    vert_macro: np.ndarray      # (C*4,) int32 macro-vertex id
    num_macro_verts: int
    perms: tuple                # the 6 permutations of (0, 1, 2), in order


def build_ifc(storage, level: int) -> IfcMeta:
    """Interface maps for a single-shard 3D storage."""
    if storage.num_shards != 1:
        raise ValueError(
            "the paired-tet exchange is the single-shard path: its pair "
            "tables span the whole storage, and neither package has a "
            "sharded form of them (ROADMAP A8)")
    if storage.dim != 3:
        raise ValueError("the paired-tet exchange is 3D")
    N = (1 << level) + 1
    C = storage.cells_per_shard
    topo = storage.topo
    gids = storage.cell_gids  # (C, 4)
    valid = storage.cell_valid
    perms = tuple(itertools.permutations(range(3)))

    tri = gids[:, _LOCAL_FACES]                       # (C, 4, 3)
    order = np.argsort(tri, axis=-1, kind="stable").reshape(-1, 3)
    perm_index = {p: i for i, p in enumerate(perms)}
    face_perm_id = np.array([perm_index[tuple(int(v) for v in o)]
                             for o in order], dtype=np.int32)
    face_macro = storage._lookup_faces(
        np.sort(tri, axis=-1).reshape(-1, 3)).astype(np.int32)
    face_members = np.full((topo.num_faces, 2), -1, dtype=np.int32)
    for row in range(C * 4):
        if not valid[row // 4]:
            continue
        m = face_macro[row]
        if face_members[m, 0] < 0:
            face_members[m, 0] = row
        elif face_members[m, 1] < 0:
            face_members[m, 1] = row
        else:
            raise ValueError("macro-face shared by more than two cells")

    ends = gids[:, _LOCAL_EDGES_3D].reshape(-1, 2)    # (C*6, 2)
    edge_macro = storage._lookup_edges(np.sort(ends, axis=-1)).astype(np.int32)
    edge_flip = ends[:, 0] > ends[:, 1]  # canonical param = weight of hi

    return IfcMeta(
        N=N,
        face_perm_id=face_perm_id,
        face_macro=face_macro,
        face_members=face_members,
        edge_flip=edge_flip,
        edge_macro=edge_macro,
        num_macro_edges=topo.num_edges,
        vert_macro=gids.reshape(-1).astype(np.int32),
        num_macro_verts=topo.num_vertices,
        perms=perms,
    )
