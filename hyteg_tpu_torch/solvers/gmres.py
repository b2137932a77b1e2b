"""(F)GMRES and GKB solvers over tensors or Taylor-Hood vectors; torch
counterpart of hyteg_tpu/solvers/gmres.py.

Reference: src/hyteg/solvers/GMRESSolver.hpp, FGMRESSolver.hpp,
GKBSolver.hpp:61. The Krylov basis is a list of vectors; the Hessenberg
column, the Givens rotations and the reduced right-hand side are 0-dim
tensors on the operands' device, so a restart cycle reads nothing back to
the host; the stopping tests read one norm per restart (GMRES) or per
step (GKB).
"""

from __future__ import annotations

from typing import Callable

import torch

from .krylov import _nonzero


def fgmres_solve(
    apply_fn: Callable,
    dot_fn: Callable,
    b,
    x0,
    restart: int = 30,
    max_restarts: int = 10,
    rtol: float = 1e-8,
    prec_fn: Callable | None = None,
):
    """Flexible right-preconditioned restarted GMRES. Returns (x, |residual
    estimate|, restarts).

    With a constant (or no) preconditioner this is standard restarted
    GMRES; a varying preconditioner (e.g. an inner GMG cycle) is supported
    because the preconditioned vectors Z are stored explicitly. Every
    restart runs all ``restart`` Arnoldi steps, as in the JAX package.
    """
    prec = prec_fn if prec_fn is not None else (lambda r: r)
    m = restart

    def norm(v):
        return torch.sqrt(torch.clamp(dot_fn(v, v), min=0.0))

    b_norm = float(norm(b))
    tol = rtol * (1.0 if b_norm == 0 else b_norm)

    def one_cycle(x):
        r = b - apply_fn(x)
        beta = norm(r)
        V = [(1.0 / _nonzero(beta)) * r]
        Z, H, cs, sn = [], [], [], []
        g = [beta] + [torch.zeros_like(beta)] * m
        for k in range(m):
            zk = prec(V[k])
            w = apply_fn(zk)
            # modified Gram-Schmidt
            hcol = []
            for j in range(k + 1):
                hij = dot_fn(w, V[j])
                w = w - hij * V[j]
                hcol.append(hij)
            hk1 = norm(w)
            hcol.append(hk1)
            V.append((1.0 / _nonzero(hk1)) * w)
            Z.append(zk)
            # apply the accumulated Givens rotations to the new column
            for j in range(k):
                a, bb = hcol[j], hcol[j + 1]
                hcol[j] = cs[j] * a + sn[j] * bb
                hcol[j + 1] = -sn[j] * a + cs[j] * bb
            denom = _nonzero(torch.sqrt(hcol[k] ** 2 + hcol[k + 1] ** 2))
            ck, sk = hcol[k] / denom, hcol[k + 1] / denom
            hcol[k] = ck * hcol[k] + sk * hcol[k + 1]
            hcol[k + 1] = torch.zeros_like(beta)
            g[k], g[k + 1] = ck * g[k], -sk * g[k]
            H.append(torch.stack(hcol + [torch.zeros_like(beta)] * (m - k - 1)))
            cs.append(ck)
            sn.append(sk)
        # back substitution: solve H[:m, :m] y = g[:m]
        Hm = torch.stack(H, dim=1)[:m] + 1e-30 * torch.eye(
            m, dtype=beta.dtype, device=beta.device)
        y = torch.linalg.solve_triangular(Hm, torch.stack(g[:m])[:, None],
                                          upper=True)[:, 0]
        for k in range(m):
            x = x + y[k] * Z[k]
        return x, torch.abs(g[m])

    x, res, k = x0, norm(b - apply_fn(x0)), 0
    while k < max_restarts and float(res) > tol:
        x, res = one_cycle(x)
        k += 1
    return x, res, k


def gkb_solve(
    apply_K: Callable,
    apply_B: Callable,
    apply_Bt: Callable,
    inner_solve: Callable,
    dot_u: Callable,
    dot_p: Callable,
    f,
    g,
    u0,
    p0,
    max_iter: int = 30,
    tol: float = 1e-8,
):
    """Golub-Kahan bidiagonalization for the saddle-point system
    [K B^T; B 0] (reference: GKBSolver.hpp:61, Arioli's algorithm).
    Returns (u, p, iterations, |z|).

    inner_solve(rhs) must approximately solve K w = rhs. u-space vectors
    use the K-inner product (via inner_solve), p-space the mass-ish dot_p.
    Simplified: nu = 0 (no augmented Lagrangian); as in the JAX package,
    the start is u = K^-1 f and p from the first bidiagonalization step
    (``u0`` and ``p0`` are not read).
    """
    u = inner_solve(f)
    r0 = g - apply_B(u)
    beta = torch.sqrt(torch.clamp(dot_p(r0, r0), min=0.0))
    q = (1.0 / _nonzero(beta)) * r0

    w_raw = inner_solve(apply_Bt(q))
    alpha = torch.sqrt(torch.clamp(dot_u(w_raw, apply_K(w_raw)), min=1e-30))
    v = (1.0 / alpha) * w_raw

    z = beta / alpha
    u = u + z * v
    p = (-z / alpha) * q
    d = (1.0 / alpha) * q
    k, res = 1, torch.abs(z)
    while k < max_iter and float(res) > tol:
        q_new_raw = apply_B(v) - alpha * q
        beta = torch.sqrt(torch.clamp(dot_p(q_new_raw, q_new_raw), min=1e-30))
        q = (1.0 / beta) * q_new_raw
        w_raw = inner_solve(apply_Bt(q)) - (beta / alpha) * v
        alpha_new = torch.sqrt(torch.clamp(dot_u(w_raw, apply_K(w_raw)),
                                           min=1e-30))
        v = (1.0 / alpha_new) * w_raw
        z = -beta / alpha_new * z
        u = u + z * v
        d = (1.0 / beta) * (q - alpha * d)
        p = p + (-z / alpha_new) * d
        alpha = alpha_new
        k += 1
        res = torch.abs(z)
    return u, p, k, res
