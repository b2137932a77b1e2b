"""Blended-geometry P2 epsilon / div / grad operators (on-the-fly
quadrature); torch counterpart of hyteg_tpu/operators/p2_blended_stokes.py,
plain torch on every device (the JAX package has no Pallas kernel for it
either).

The P2 x blending x epsilon operator family the reference generates per
(form, map) pair (reference: the epsilon / full_stokes x
IcosahedralShellMap operators under src/hyteg_operators/, and
P2P1ElementwiseBlendingStokesOperator): one matrix-free formulation for
every geometry map.

  * Geometry is isoparametric-P1: every micro-vertex is snapped onto the
    curved domain (geometry/maps.py), each micro-element is the straight
    simplex over its blended vertices, and its Jacobian is read from the
    blended node-coordinate field with stride-2 views (the node grid of
    level L + 1 holds the level-L vertices at even positions).
  * Element matrices are never materialized: per class, the apply runs
    the quadrature loop (a Python loop over the rule's points) over every
    element base at once, with physical gradients g_A(q) = J^-T ghat_A(q)
    from closed-form inverses (operators/forms.py).
  * A nodal viscosity enters by element-vertex-mean averaging (the
    reference's CoefficientQuadratureAveraging, arithmetic mode).

The blended node field is computed once per operator and kept on the
device; every read and write is a view over the (n,)*dim base cube of the
grid (C, M, M, pitch), as in operators/mixed.py, so no padding is read.
For the identity map the operators reproduce the affine epsilon and div
operators to round-off: P2 basis gradients are affine in the reference
point, so the degree-2 rule integrates the integrands exactly on straight
elements. Each class's temporaries are freed before the next class.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.types import DoFType, FLAG_INNER
from ..functions.p1 import P1Space
from ..functions.p2 import P2Space
from ..geometry.maps import GeometryMap
from ..indexing import micro
from . import quadrature as q
from .forms import det_small, inv_small
from .mixed import _shift_read_p1, _shift_write_p1_add
from .p2_elementwise import (_base_masks, _grid, _read_strided,
                             _scatter_strided_add, p2_node_offsets)


def node_coords_blended(vel_space: P2Space, gmap: GeometryMap,
                        shard: int = 0) -> torch.Tensor:
    """(C, M, lanes, 3) blended coordinates of every node-grid point."""
    ns = vel_space.node_space
    return gmap.apply(ns.coords(shard), ns._ref_coords,
                      ns._tensor(ns.cell_vertices(shard)))


def node_components_blended(vel_space: P2Space, gmap: GeometryMap,
                            shard: int = 0) -> torch.Tensor:
    """(dim, C, M, lanes) blended node coordinates, component-major (a 2D
    mesh's z = 0 dropped): the field the blended operators keep."""
    co = node_coords_blended(vel_space, gmap, shard)
    return co.movedim(-1, 0)[:vel_space.dim].contiguous()


def _class_geometry(coords3, t: int, n: int, dim: int, mask):
    """Per-element Jacobian data of class ``t`` from the blended node
    coordinates (``coords3``: dim grid views (C, M, M, pitch)).

    Returns (Jinv (C, n.., dim, dim), |det| (C, n..)) over the base cube.
    Elements outside the class base mask read coordinates of no element of
    the class; their Jacobians are replaced by the identity BEFORE
    inversion, so no inf / NaN can reach the zero of ``mask``."""
    voffs = micro.offsets(dim)
    reads = [torch.stack([_read_strided(coords3[k], 2 * voffs[t, i], n)
                          for k in range(dim)], dim=-1)
             for i in range(dim + 1)]  # nv tensors (C, n.., dim)
    # J columns are edge vectors v_i - v_0
    J = torch.stack([reads[i + 1] - reads[0] for i in range(dim)], dim=-1)
    eye = torch.eye(dim, dtype=J.dtype, device=J.device)
    J = torch.where((mask > 0)[..., None, None], J, eye)
    det = det_small(J)
    ok = det.abs() > 1e-30
    Jinv = inv_small(torch.where(ok[..., None, None], J, eye))
    return Jinv, torch.where(ok, det, 1.0).abs() * ok


def _mu_element(mu3, t: int, n: int, dim: int):
    """Element-vertex mean of a nodal viscosity field (or None)."""
    if mu3 is None:
        return None
    voffs = micro.offsets(dim)
    sc = _read_strided(mu3, 2 * voffs[t, 0], n)
    for i in range(1, dim + 1):
        sc = sc + _read_strided(mu3, 2 * voffs[t, i], n)
    return sc / (dim + 1)


@functools.lru_cache(maxsize=None)
def _rule(dim: int):
    """(weights (Q,), P2 reference gradients (Q, nn, dim), P1 values (Q,
    nv)) of the degree-2 simplex rule, float64 numpy."""
    pts, w = q.simplex_rule(dim, 2)
    ghat = np.transpose(np.asarray(q.p2_grads_at(dim, pts)), (1, 0, 2))
    lam = np.concatenate([1 - pts.sum(-1, keepdims=True), pts], -1)
    return np.asarray(w), ghat, lam


def _rule_tensors(dim: int, like: torch.Tensor):
    kw = dict(dtype=like.dtype, device=like.device)
    return tuple(torch.as_tensor(a, **kw) for a in _rule(dim))


def _times(a, b):
    """Per-element a @ b of (..., m, k) and (..., k, n) small matrices."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def _class_scale(det, mask, me):
    scale = det * mask
    return scale if me is None else scale * me


def _velocity_reads(x3, t: int, n: int, dim: int) -> torch.Tensor:
    """(C, n.., e, B): component e of the velocity at class t's node B."""
    node_offs = p2_node_offsets(dim)
    return torch.stack([torch.stack([_read_strided(x3[e], node_offs[t, B], n)
                                     for B in range(node_offs.shape[1])],
                                    dim=-1) for e in range(dim)], dim=-2)


def p2_eps_vargeom_apply(xs, coords3, level: int, dim: int, pitch: int,
                         mu=None, full: bool = False) -> torch.Tensor:
    """Per-cell partial ys[d] = sum_e K_eps[d, e] xs[e] with per-element
    blended geometry: xs a (dim, C, M, lanes) block or dim blocks; mu an
    optional nodal viscosity; returns a fresh (dim, C, M, lanes) block."""
    n = 1 << level
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[:2]
    x0 = xs[0]
    masks = _base_masks(level, dim, x0.dtype, x0.device)
    w, ghat, _ = _rule_tensors(dim, x0)
    x3 = [_grid(x.contiguous(), pitch, dim) for x in xs]
    mu3 = None if mu is None else _grid(mu.contiguous(), pitch, dim)
    ys = torch.zeros((dim,) + tuple(x0.shape), dtype=x0.dtype,
                     device=x0.device)
    y3 = [_grid(y, pitch, dim) for y in ys.unbind(0)]
    eye = torch.eye(dim, dtype=x0.dtype, device=x0.device)
    for t in range(T):
        Jinv, det = _class_geometry(coords3, t, n, dim, masks[t])
        scale = _class_scale(det, masks[t], _mu_element(mu3, t, n, dim))
        X = _velocity_reads(x3, t, n, dim)  # (..., e, B)
        acc = torch.zeros(X.shape[:-2] + (dim, nn), dtype=X.dtype,
                          device=X.device)
        for qp in range(w.shape[0]):
            gq = ghat[qp]  # (nn, dim)
            # reference gradients of u (one GEMM), then the per-element
            # products with J^-1 as broadcast sums: a batched matmul of
            # 3 x 3 matrices runs a tile per element on cuBLAS
            H = _times(torch.matmul(X, gq), Jinv)  # (..., e, j)
            tau = H + H.transpose(-1, -2)
            if full:
                tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
                tau = tau - (2.0 / 3.0) * tr[..., None, None] * eye
            rho = _times(tau, Jinv.transpose(-1, -2))  # (..., d, k)
            acc += w[qp] * torch.matmul(rho, gq.T)  # (..., d, A)
        del X, Jinv
        acc *= scale[..., None, None]
        for A in range(nn):
            for d in range(dim):
                _scatter_strided_add(y3[d], acc[..., d, A], node_offs[t, A], n)
        del acc
    return ys


def p2_eps_vargeom_diagonal(coords3, level: int, dim: int, pitch: int,
                            block_shape, mu=None, full: bool = False,
                            dtype=torch.float32) -> torch.Tensor:
    """Per-cell partial per-component diagonals of the blended epsilon
    operator, a (dim, C, M, lanes) block."""
    n = 1 << level
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[:2]
    c0 = coords3[0]
    masks = _base_masks(level, dim, dtype, c0.device)
    w, ghat, _ = _rule_tensors(dim, masks)
    mu3 = None if mu is None else _grid(mu.contiguous(), pitch, dim)
    ds = torch.zeros((dim,) + tuple(block_shape), dtype=dtype,
                     device=c0.device)
    d3 = [_grid(x, pitch, dim) for x in ds.unbind(0)]
    # 2 eps(phi e_d) : eps(phi e_d) = g_d^2 + |g|^2 (- 2/3 g_d^2 if full)
    fac = 1.0 - (2.0 / 3.0 if full else 0.0)
    for t in range(T):
        Jinv, det = _class_geometry(coords3, t, n, dim, masks[t])
        scale = _class_scale(det, masks[t], _mu_element(mu3, t, n, dim))
        JinvT = Jinv.transpose(-1, -2).contiguous()
        acc = torch.zeros(det.shape + (dim, nn), dtype=dtype,
                          device=c0.device)
        for qp in range(w.shape[0]):
            # physical gradients g_A = J^-T ghat_A: (..., j, A), one GEMM
            G2 = torch.matmul(JinvT, ghat[qp].T).square_()
            acc += w[qp] * (fac * G2 + G2.sum(-2, keepdim=True))
        del Jinv, JinvT
        acc *= scale[..., None, None]
        for A in range(nn):
            for d in range(dim):
                _scatter_strided_add(d3[d], acc[..., d, A], node_offs[t, A], n)
        del acc
    return ds


def p2p1_div_vargeom_apply(vels, coords3, level: int, dim: int, pitch: int,
                           p1_block_shape) -> torch.Tensor:
    """Per-cell partial pressure rows y(i) = -int psi_i div(u) over blended
    elements (the sign of operators/mixed.py's divergence element
    matrices); the pressure lives on the element-level vertex grid."""
    n = 1 << level
    voffs = micro.offsets(dim)
    T = voffs.shape[0]
    v0 = vels[0]
    masks = _base_masks(level, dim, v0.dtype, v0.device)
    w, ghat, lam = _rule_tensors(dim, v0)
    x3 = [_grid(v.contiguous(), pitch, dim) for v in vels]
    y = torch.zeros(p1_block_shape, dtype=v0.dtype, device=v0.device)
    y3 = _grid(y, pitch, dim)
    for t in range(T):
        Jinv, det = _class_geometry(coords3, t, n, dim, masks[t])
        X = _velocity_reads(x3, t, n, dim)
        JinvT = Jinv.transpose(-1, -2)
        acc = torch.zeros(det.shape + (dim + 1,), dtype=v0.dtype,
                          device=v0.device)
        for qp in range(w.shape[0]):
            gu = torch.matmul(X, ghat[qp])  # (..., e, k)
            divu = (gu * JinvT).sum((-1, -2))  # sum_ek gu[e,k] Jinv[k,e]
            acc -= w[qp] * divu[..., None] * lam[qp]
        del X, Jinv, JinvT
        acc *= (det * masks[t])[..., None]
        for i in range(dim + 1):
            _shift_write_p1_add(y3, acc[..., i], voffs[t, i], n)
        del acc
    return y


def p2p1_grad_vargeom_apply(p, coords3, level: int, dim: int, pitch: int,
                            comps, p2_block_shape) -> torch.Tensor:
    """Per-cell partial velocity rows of the gradient block,
    y[d](B) = -int p d_d(phi_B) (the transpose of the div block), for the
    components ``comps``: a (len(comps), C, M, lanes) block."""
    n = 1 << level
    voffs = micro.offsets(dim)
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[:2]
    masks = _base_masks(level, dim, p.dtype, p.device)
    w, ghat, lam = _rule_tensors(dim, p)
    p3 = _grid(p.contiguous(), pitch, dim)
    ys = torch.zeros((len(comps),) + tuple(p2_block_shape), dtype=p.dtype,
                     device=p.device)
    y3 = [_grid(y, pitch, dim) for y in ys.unbind(0)]
    for t in range(T):
        Jinv, det = _class_geometry(coords3, t, n, dim, masks[t])
        P = torch.stack([_shift_read_p1(p3, voffs[t, i], n)
                         for i in range(dim + 1)], dim=-1)  # (..., nv)
        JcT = Jinv[..., :, list(comps)].transpose(-1, -2).contiguous()
        acc = torch.zeros(det.shape + (len(comps), nn), dtype=p.dtype,
                          device=p.device)
        for qp in range(w.shape[0]):
            pq = torch.matmul(P, lam[qp])  # (...)
            # d_d phi_B(q) = sum_k Jinv[k, d] ghat_B^k(q): (..., d, B)
            dphi = torch.matmul(JcT, ghat[qp].T)
            acc -= w[qp] * dphi * pq[..., None, None]
        del P, Jinv, JcT
        acc *= (det * masks[t])[..., None, None]
        for di in range(len(comps)):
            for B in range(nn):
                _scatter_strided_add(y3[di], acc[..., di, B],
                                     node_offs[t, B], n)
        del acc
    return ys


class P2BlendedEpsilonOperator:
    """Vector P2 viscous block on blended geometry, with the methods of
    P2VectorEpsilonOperator (reference: the epsilon x ShellMap generated
    operator family). ``coords`` (optional): the (dim, C, M, lanes)
    blended node field, shared with other operators on the same space."""

    def __init__(self, space: P2Space, gmap: GeometryMap, shard: int = 0,
                 full: bool = False, coords=None):
        self.space = space
        self.gmap = gmap
        self.shard = shard
        self.full = full
        self.comps = (node_components_blended(space, gmap, shard)
                      if coords is None else coords)

    def _coords3(self):
        return [_grid(c, self.space.pitch, self.space.dim)
                for c in self.comps.unbind(0)]

    def apply_local(self, xs, coeff=None) -> torch.Tensor:
        """Per-cell partial apply (no exchange), a fresh (dim, C, M,
        lanes) block."""
        sp = self.space
        return p2_eps_vargeom_apply(xs, self._coords3(), sp.level, sp.dim,
                                    sp.pitch, mu=coeff, full=self.full)

    def _exchange_each_(self, ys, sd):
        for y in ys.unbind(0):
            self.space._exchange_add_(y, sd)
        return ys

    def apply_raw(self, xs, coeff=None, sd=None) -> torch.Tensor:
        sd = self.space.resolve_sd(sd, self.shard)
        return self._exchange_each_(self.apply_local(xs, coeff), sd)

    def apply_inner(self, xs, sd_or_bc=None, flag: DoFType = FLAG_INNER,
                    coeff=None) -> torch.Tensor:
        sd = self.space.resolve_sd(sd_or_bc, self.shard)
        ys = self.apply_raw(xs, coeff, sd)
        for y in ys.unbind(0):
            if flag & DoFType.INNER:
                self.space._restore_rows_(y, None, flag, sd)  # ys is fresh
            else:
                y.copy_(self.space.restore_rows(y, torch.zeros_like(y), flag,
                                                sd))
        return ys

    def diagonal_raw(self, coeff=None, sd=None) -> torch.Tensor:
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        ds = p2_eps_vargeom_diagonal(self._coords3(), sp.level, sp.dim,
                                     sp.pitch, sp.block_shape, mu=coeff,
                                     full=self.full, dtype=sp.dtype)
        return self._exchange_each_(ds, sd)

    def inverse_diagonal(self, coeff=None, sd=None) -> torch.Tensor:
        ds = self.diagonal_raw(coeff, sd)
        ok = self.space.vertex_mask_t.bool() & (ds != 0)
        return torch.where(ok, 1.0 / torch.where(ds == 0, 1.0, ds), 0.0)


class P2P1BlendedDivOperator:
    """Blended div / grad Stokes blocks, with the methods of
    P2ToP1DivOperator; partial per-cell sums, the caller exchanges
    additively. ``coords`` as for P2BlendedEpsilonOperator."""

    def __init__(self, p2: P2Space, p1: P1Space, gmap: GeometryMap,
                 shard: int = 0, coords=None):
        assert p1.level == p2.level
        if p2.dim == 3 and p1.pitch != p2.pitch:
            raise ValueError(
                f"P2P1BlendedDivOperator needs a shared lane pitch (P1 "
                f"{p1.pitch} != P2 {p2.pitch})")
        self.p2, self.p1 = p2, p1
        self.gmap = gmap
        self.shard = shard
        self.comps = (node_components_blended(p2, gmap, shard)
                      if coords is None else coords)

    def _coords3(self):
        return [_grid(c, self.p2.pitch, self.p2.dim)
                for c in self.comps.unbind(0)]

    def apply_div_local(self, vel_components) -> torch.Tensor:
        """Partial divergence of all components, one P1 block."""
        sp = self.p2
        return p2p1_div_vargeom_apply(vel_components, self._coords3(),
                                      sp.level, sp.dim, sp.pitch,
                                      self.p1.block_shape)

    def apply_gradient_component_local(self, p, d: int) -> torch.Tensor:
        """Partial B^T (gradient): pressure -> P2 component d."""
        sp = self.p2
        return p2p1_grad_vargeom_apply(p, self._coords3(), sp.level, sp.dim,
                                       sp.pitch, (d,), sp.block_shape)[0]

    def apply_gradient_local(self, p) -> torch.Tensor:
        """Partial B^T of every component: a (dim, C, M, lanes) block."""
        sp = self.p2
        return p2p1_grad_vargeom_apply(p, self._coords3(), sp.level, sp.dim,
                                       sp.pitch, range(sp.dim),
                                       sp.block_shape)
