"""Point evaluation of P1/P2 fields at arbitrary physical points (torch
counterpart of hyteg_tpu/functions/evaluate.py).

Reference: src/hyteg/p1functionspace/VertexDoFFunction.hpp `evaluate` /
`evaluateGradient`, src/hyteg/geometry/ closest-point search. The
containing macro-cell is found by barycentric coordinates of each query
point w.r.t. the candidate cells of its bucket (a uniform grid over the
mesh's bounding box, built once on the host), the containing micro-element
class the same way among the congruence-class candidates of its
refinement cube (reference: src/hyteg/volumedofspace/CellDoFIndexing.hpp:
38-55); both pick the first index among equal maxima, as ``argmax`` does
in the JAX package.

Points outside the domain are clamped to the barycentrically-closest cell
and evaluated at the clamped location (the analog of the reference's
clamping of departure points in MMOCTransport backtracking).

Queries run in chunks of ``chunk`` points: the per-query intermediates
are (Q, K, dim, dim) gathers over the K candidates of a bucket, which at
a full-size query set (tens of millions of points) would take tens of GB
at once. Per-element products are broadcast sums, not batched matmuls
(a batch of 3 x 3 products runs one cuBLAS tile per matrix).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..indexing import micro
from ..operators.quadrature import _p2_node_pairs
from ..primitives.storage import CellStorage

#: queries per chunk: (Q, K, 3, 3) f32 candidate gathers of ~0.5 GB at
#: K ~ 100 candidates
DEFAULT_CHUNK = 1 << 17


def _class_tables(dim: int):
    """Per-class (base offset O0, inverse edge matrix Minv) for membership
    tests + barycentric weights inside one refinement cube."""
    offs = micro.offsets(dim)  # (T, nv, dim)
    T = offs.shape[0]
    O0 = offs[:, 0, :].astype(np.float64)  # (T, dim)
    Minv = np.zeros((T, dim, dim))
    for t in range(T):
        M = (offs[t, 1:] - offs[t, :1]).astype(np.float64)  # rows = edges
        Minv[t] = np.linalg.inv(M.T)
    return offs, O0, Minv


def build_buckets(verts: np.ndarray, valid: np.ndarray, dim: int):
    """Host bucket table, as the JAX package builds it: (table (G,)*dim +
    (K,) int32 of candidate cells per bucket, lo (dim,), scale (dim,), G).
    A bucket lists the cells whose bounding box overlaps it, padded with
    its last cell; an empty bucket (e.g. inside an annulus hole) takes the
    list of the nearest non-empty bucket, so an out-of-domain query clamps
    to a geometrically close boundary cell."""
    C = verts.shape[0]
    lo = verts[valid].reshape(-1, dim).min(0)
    hi = verts[valid].reshape(-1, dim).max(0)
    G = max(2, int(round((2.0 * valid.sum()) ** (1.0 / dim))))
    scale = G / np.maximum(hi - lo, 1e-300)
    cand: dict[tuple, list] = {}
    for c in range(C):
        if not valid[c]:
            continue
        cl = np.clip(np.floor((verts[c].min(0) - lo) * scale
                              - 1e-9).astype(int), 0, G - 1)
        ch = np.clip(np.floor((verts[c].max(0) - lo) * scale
                              + 1e-9).astype(int), 0, G - 1)
        rng = [range(cl[d], ch[d] + 1) for d in range(dim)]
        for key in itertools.product(*rng):
            cand.setdefault(key, []).append(c)
    K = max(len(v) for v in cand.values())
    table = np.zeros((G,) * dim + (K,), dtype=np.int32)
    filled = np.zeros((G,) * dim, dtype=bool)
    for key, cells in cand.items():
        table[key] = np.asarray(cells + [cells[-1]] * (K - len(cells)))
        filled[key] = True
    if not filled.all():
        keys = np.argwhere(filled)
        for key in np.argwhere(~filled):
            d2 = ((keys - key[None]) ** 2).sum(1)
            table[tuple(key)] = table[tuple(keys[int(d2.argmin())])]
    return table, lo, scale, G


def _times(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., a, b) x (..., b) -> (..., a) as a broadcast sum."""
    return (A * x.unsqueeze(-2)).sum(-1)


class FieldEvaluator:
    """Evaluate a P1 (degree=1) or P2 (degree=2) DoF block at points.

    ``u`` blocks are the space's dense per-cell node grids, (C, N, lanes)
    or (B, C, N, lanes); all cells of the storage are present (one
    shard). A 3D block's lane pitch is read off its shape (lanes = N *
    pitch, see indexing/flat.py), so the block's space owns the layout.
    ``chunk``: queries per chunk (None: all at once); the results
    do not depend on it. ``device`` has no default.
    """

    def __init__(self, storage: CellStorage, level: int, degree: int = 1, *,
                 device, dtype=torch.float32,
                 chunk: int | None = DEFAULT_CHUNK):
        self.storage = storage
        self.level = level
        self.degree = degree
        self.device = torch.device(device)
        self.dim = dim = storage.dim
        self.n = n = 1 << level
        # node grid: P1 -> level grid; P2 -> doubled (level+1) grid
        self.N = (2 * n + 1) if degree == 2 else (n + 1)
        self.dtype = dtype
        self.chunk = chunk

        verts = np.asarray(storage.cell_vertices, dtype=np.float64)[..., :dim]
        valid = np.asarray(storage.cell_valid, dtype=bool)
        v0 = verts[:, 0, :]
        J = verts[:, 1:, :] - verts[:, :1, :]  # (C, dim, dim) rows = edges
        JTinv = np.zeros_like(J)
        for c in range(J.shape[0]):
            if valid[c]:
                JTinv[c] = np.linalg.inv(J[c].T)
        self._v0 = self._t(v0)
        self._JTinv = self._t(JTinv)
        self._invalid = torch.as_tensor(~valid, device=self.device)

        offs, O0, Minv = _class_tables(dim)
        self._offs = torch.as_tensor(offs, dtype=torch.int64,
                                     device=self.device)  # (T, nv, dim)
        self._O0 = self._t(O0)
        self._Minv = self._t(Minv)
        if degree == 2:
            self._pairs = _p2_node_pairs(dim)

        # uniform-grid bucket accelerator: per bucket, the cells whose
        # AABB overlaps it — the dense O(Q*C) scan becomes O(Q*K); a mesh
        # of at most 8 cells is scanned whole
        self._buckets = None
        if valid.sum() > 8:
            table, lo, scale, G = build_buckets(verts, valid, dim)
            self._buckets = (torch.as_tensor(table, dtype=torch.int64,
                                             device=self.device),
                             self._t(lo), self._t(scale), G)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    # -- stage 1: macro-cell location ----------------------------------------

    def locate_cells(self, pts: torch.Tensor):
        """pts (Q, dim) -> (cell index (Q,), barycentric tail lam (Q, dim))."""
        dim = self.dim
        if self._buckets is not None:
            table, lo, scale, G = self._buckets
            ib = torch.clamp(torch.floor((pts - lo) * scale).to(torch.int64),
                             0, G - 1)
            cand = table[tuple(ib[:, d] for d in range(dim))]  # (Q, K)
            d = pts[:, None, :] - self._v0[cand]                # (Q, K, dim)
            lam = _times(self._JTinv[cand], d)                  # (Q, K, dim)
            invalid = self._invalid[cand]
        else:
            cand = None
            d = pts[:, None, :] - self._v0[None]                # (Q, C, dim)
            lam = _times(self._JTinv[None], d)                  # (Q, C, dim)
            invalid = self._invalid[None]
        lam0 = 1.0 - lam.sum(-1)
        minl = torch.minimum(lam.amin(-1), lam0)
        minl = minl.masked_fill(invalid, -torch.inf)
        k = minl.argmax(1)
        c = k if cand is None else cand.gather(1, k[:, None])[:, 0]
        lam_c = lam.gather(1, k[:, None, None].expand(-1, 1, dim))[:, 0]
        return c, lam_c

    # -- stage 2: micro-element location within the macro-cell ----------------

    def locate_micro(self, lam: torch.Tensor):
        """lam (Q, dim) in [0,1] simplex coords -> (base (Q,dim) int,
        class t (Q,), local barycentric mu (Q, nv))."""
        n, dim = self.n, self.dim
        r = torch.clamp(lam * n, 0.0, float(n))
        base = torch.clamp(torch.floor(r).to(torch.int64), 0, n - 1)
        # keep the base corner inside the macro simplex: sum(base) <= n-1
        for _ in range(dim - 1):
            over = base.sum(-1) > (n - 1)
            frac = r - base
            # decrement the coordinate with the smallest fractional part
            j = torch.where(base > 0, frac, torch.inf).argmin(-1)
            dec = torch.nn.functional.one_hot(j, dim) * over[:, None]
            base = base - dec
        frac = r - base
        # congruence-class membership: barycentric w.r.t. each candidate tet
        mu_t = _times(self._Minv[None],
                      frac[:, None, :] - self._O0[None])       # (Q, T, dim)
        mu0 = 1.0 - mu_t.sum(-1)
        minmu = torch.minimum(mu_t.amin(-1), mu0)
        t = minmu.argmax(1)
        mu_tail = mu_t.gather(1, t[:, None, None].expand(-1, 1, dim))[:, 0]
        mu = torch.cat([1.0 - mu_tail.sum(-1, keepdim=True), mu_tail],
                       dim=-1)  # (Q, nv)
        return base, t, mu

    # -- stage 3: basis evaluation + gather -----------------------------------

    def _gather(self, u: torch.Tensor, c: torch.Tensor,
                node_idx: torch.Tensor) -> torch.Tensor:
        """u (..., C, N, lanes) flat blocks, node_idx (Q, nn, dim) int ->
        (..., Q, nn)."""
        N, lanes = self.N, u.shape[-1]
        if self.dim == 2:
            flat = node_idx[..., 0] * N + node_idx[..., 1]
        else:
            P = lanes // N
            flat = (node_idx[..., 0] * lanes + node_idx[..., 1] * P
                    + node_idx[..., 2])
        gidx = c[:, None] * (N * lanes) + flat          # (Q, nn)
        u2 = u.reshape(u.shape[:-3] + (-1,))
        return torch.index_select(u2, -1, gidx.reshape(-1)).reshape(
            u.shape[:-3] + gidx.shape)

    def _nodes_weights(self, base, t, mu):
        """(node indices (Q, nn, dim), basis weights (Q, nn))."""
        ot = self._offs[t]                               # (Q, nv, dim)
        if self.degree == 1:
            return base[:, None, :] + ot, mu
        cols, wts = [], []
        for (i, j) in self._pairs:
            cols.append(2 * base + ot[:, i] + ot[:, j])
            if i == j:
                wts.append(mu[:, i] * (2.0 * mu[:, i] - 1.0))
            else:
                wts.append(4.0 * mu[:, i] * mu[:, j])
        return torch.stack(cols, dim=1), torch.stack(wts, dim=1)

    def _points(self, points) -> torch.Tensor:
        return torch.as_tensor(points, dtype=self.dtype,
                               device=self.device)[..., : self.dim]

    def _chunked(self, fn, u: torch.Tensor, pts: torch.Tensor, tail: tuple):
        """fn(u, pts chunk) -> (..., q) + tail, over chunks of pts."""
        Q = pts.shape[0]
        if self.chunk is None or Q <= self.chunk:
            return fn(u, pts)
        out = torch.empty(u.shape[:-3] + (Q,) + tail, dtype=self.dtype,
                          device=self.device)
        for s in range(0, Q, self.chunk):
            rows = (Ellipsis, slice(s, s + self.chunk)) + (slice(None),) * len(tail)
            out[rows] = fn(u, pts[s : s + self.chunk])
        return out

    def _evaluate(self, u, pts):
        c, lam = self.locate_cells(pts)
        base, t, mu = self.locate_micro(lam)
        node_idx, w = self._nodes_weights(base, t, mu)
        return (self._gather(u, c, node_idx) * w).sum(-1)

    def evaluate(self, u: torch.Tensor, points) -> torch.Tensor:
        """u: (C, N, lanes) or (B, C, N, lanes); points: (Q, >=dim) ->
        (Q,) / (B, Q)."""
        return self._chunked(self._evaluate, u.to(self.dtype),
                             self._points(points), ())

    def _gradient(self, u, pts):
        c, lam = self.locate_cells(pts)
        base, t, mu = self.locate_micro(lam)
        vals = self._gather(u, c, base[:, None, :] + self._offs[t])
        # d(mu)/dx: mu_tail = Minv (n*lam - base - O0), lam = JTinv (x - v0)
        # => d(mu_tail)/dx = n * Minv @ JTinv_c ; d(mu0)/dx = -sum rows
        G = self.n * (self._Minv[t][..., None] * self._JTinv[c][:, None]).sum(-2)
        g_tail = (vals[..., 1:, None] * G).sum(-2)
        return g_tail - vals[..., :1] * G.sum(-2)

    def evaluate_gradient(self, u: torch.Tensor, points) -> torch.Tensor:
        """Gradient of a P1 field at points (reference: evaluateGradient).
        Piecewise-constant per micro-element: (Q, dim) (P1 only)."""
        if self.degree != 1:
            raise NotImplementedError("gradient evaluation is implemented "
                                      "for P1, as in the JAX package")
        return self._chunked(self._gradient, u.to(self.dtype),
                             self._points(points), (self.dim,))
