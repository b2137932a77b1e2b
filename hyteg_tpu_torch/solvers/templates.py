"""Canned P1 and P2 GMG solver stacks; torch counterpart of
hyteg_tpu/solvers/templates.py.

Wires spaces, operators, transfers, smoothers and the coarse solver into
a ready GeometricMultigridSolver for one shard: the whole storage, or one
shard of a sharded one when ``sd_per_level`` carries a group
(parallel/spmd.py builds one such stack per shard).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..functions.p1 import P1ShardData, P1Space
from ..operators import forms
from ..operators.p1_elementwise import P1ElementwiseOperator
from ..operators.transfer import P1Transfer
from ..primitives.storage import CellStorage
from .gmg import GeometricMultigridSolver, GMGLevel
from .krylov import cg_solve_fixed
from .smoothers import (chebyshev_smooth, estimate_spectral_radius,
                        jacobi_smooth, p1_stencil_eig_fourier)


@dataclasses.dataclass
class P1GMGStack:
    storage: CellStorage
    spaces: dict[int, P1Space]
    operators: dict[int, P1ElementwiseOperator]
    transfers: dict[int, P1Transfer]  # keyed by fine level
    inv_diags: dict[int, torch.Tensor]
    sds: dict[int, P1ShardData]
    gmg: GeometricMultigridSolver
    flag: DoFType
    eigs: dict[int, float] | None = None

    def space(self, level=None) -> P1Space:
        return self.spaces[max(self.spaces) if level is None else level]

    def sd(self, level=None) -> P1ShardData:
        return self.sds[max(self.sds) if level is None else level]

    def residual(self, x, b, level=None):
        level = max(self.spaces) if level is None else level
        op, sp, sd = self.operators[level], self.spaces[level], self.sds[level]
        r = b - op.apply_inner(x, sd, self.flag)
        return sp._restore_rows_(r, None, self.flag, sd)  # r is fresh

    def residual_norm(self, x, b, level=None):
        level = max(self.spaces) if level is None else level
        r = self.residual(x, b, level)
        return torch.sqrt(self.spaces[level].dot(r, r, self.flag,
                                                 self.sds[level]))


def make_p1_gmg(
    storage: CellStorage,
    min_level: int,
    max_level: int,
    form: Callable = forms.laplace_form,
    bc: BoundaryCondition | None = None,
    flag: DoFType = FLAG_INNER,
    smoother: str = "chebyshev",
    pre_smooth: int = 3,
    post_smooth: int = 3,
    cheb_order: int = 4,
    jacobi_omega: float = 2.0 / 3.0,
    coarse_iters: int = 100,
    eigs: dict[int, float] | None = None,
    elmats: dict | None = None,
    dtype=torch.float32,
    *,
    device,
    space_kind: str = "p1",
    shard: int = 0,
    sd_per_level: dict | None = None,
    spaces: dict | None = None,
    coarse_solve_fn: Callable | None = None,
) -> P1GMGStack:
    """GMG stack for a scalar P1 (or, with ``space_kind="p2"``, P2)
    operator on ``device``, which has no default (reference pattern:
    tutorials/FA.01_GeometricMultigrid + GeometricMultigridSolver.hpp:39).

    ``eigs`` (level -> lambda_max(D^-1 A) bound) and ``elmats`` (level ->
    (C, 6, 4, 4) or, for P2, (C, 6, 10, 10) element matrices; (C, 2, 3, 3)
    and (C, 2, 6, 6) on 2D storage) may be carried over from another
    stack, e.g. the JAX package's (see interop.py). By default the P1
    eigenvalue bound is the host-side Fourier symbol bound of each level's
    stencil, and the P2 one 25 power iterations from a random start drawn
    from a torch.Generator seeded with the level. P2 levels take no
    separate residual callable, as in the JAX package. For P2, ``form`` is
    the kind ('laplace' or 'mass'); a callable means 'laplace'.

    Sharded: ``shard`` names the shard whose cells the operators hold,
    ``sd_per_level`` (level -> P1ShardData, e.g. with a group) replaces
    each level's shard data, ``spaces`` (level -> space) lets the shards
    of one storage share their spaces, and ``coarse_solve_fn(b, x0)``
    replaces the coarse CG (e.g. spmd.build_agglomerated_coarse_solve).
    With a group, the default P1 eigenvalue bound is the maximum over
    shards, which is the one-shard bound.
    """
    if not flag & DoFType.INNER:
        raise ValueError("the solved rows must include INNER")
    bc = bc or BoundaryCondition.all_dirichlet()
    lrange = range(min_level, max_level + 1)
    elm = lambda l: None if elmats is None else elmats[l]
    # one lane pitch across all levels -> grid transfers are pure strided
    # slicing on the flat layout (see indexing/flat.py); 2D spaces have no
    # pitch and ignore it
    if space_kind == "p1":
        pitch = (1 << max_level) + 1
        spaces = spaces or {l: P1Space(storage, l, device=device, dtype=dtype,
                                       pitch=pitch) for l in lrange}
        ops = {l: P1ElementwiseOperator(spaces[l], form, shard=shard,
                                        elmats=elm(l))
               for l in lrange}
        transfers = {l: P1Transfer(spaces[l - 1], spaces[l])
                     for l in range(min_level + 1, max_level + 1)}
    elif space_kind == "p2":
        from ..functions.p2 import P2Space
        from ..operators.p2_elementwise import P2ElementwiseOperator
        from ..operators.p2_transfer import P2Transfer

        pitch = (1 << (max_level + 1)) + 1
        kind = form if isinstance(form, str) else "laplace"
        spaces = spaces or {l: P2Space(storage, l, device=device, dtype=dtype,
                                       pitch=pitch) for l in lrange}
        ops = {l: P2ElementwiseOperator(spaces[l], kind, shard=shard,
                                        elmats=elm(l))
               for l in lrange}
        transfers = {l: P2Transfer(spaces[l - 1], spaces[l])
                     for l in range(min_level + 1, max_level + 1)}
    else:
        raise ValueError(f"unknown space_kind {space_kind!r}")
    sds = sd_per_level or {l: spaces[l].shard_data(shard, bc) for l in lrange}
    group = sds[max_level].group
    inv_diags = {l: ops[l].inverse_diagonal(sd=sds[l]) for l in lrange}

    def make_apply(l):
        return lambda x: ops[l].apply_inner(x, sds[l], flag)

    def make_dot(l):
        return lambda u, v: spaces[l].dot(u, v, flag, sds[l])

    applies = {l: make_apply(l) for l in lrange}
    dots = {l: make_dot(l) for l in lrange}

    if smoother == "chebyshev" and eigs is None and space_kind == "p1":
        # analytic symbol bound of lambda_max(D^-1 A) per level
        eigs = {l: p1_stencil_eig_fourier(ops[l].stencil, spaces[l].dim)
                for l in lrange}
        if group is not None:
            eigs = {l: float(group.all_reduce(torch.tensor(
                e, dtype=torch.float64, device=spaces[l].device), "max"))
                for l, e in eigs.items()}
    elif smoother == "chebyshev" and eigs is None:
        gen = torch.Generator(device=spaces[min_level].device)
        eigs = {}
        for l in lrange:
            gen.manual_seed(l)
            eigs[l] = float(estimate_spectral_radius(
                applies[l], inv_diags[l], dots[l], spaces[l].block_shape,
                num_iter=25, generator=gen, dtype=dtype))

    # every restore below writes in place into a tensor the step just made
    def make_smooth(l):
        sp = spaces[l]

        if smoother == "chebyshev":
            def smooth(x, b):
                xn = chebyshev_smooth(
                    applies[l], inv_diags[l], b, x, eigs[l], order=cheb_order)
                return sp._restore_rows_(xn, x, flag, sds[l])
        elif smoother == "jacobi":
            def smooth(x, b):
                xn = jacobi_smooth(applies[l], inv_diags[l], b, x, jacobi_omega)
                return sp._restore_rows_(xn, x, flag, sds[l])
        else:
            raise ValueError(f"unknown smoother {smoother!r}")
        return smooth

    def make_restrict(l):  # fine level l -> l-1
        sp_c = spaces[l - 1]

        def restrict(r):
            rc = transfers[l].restrict(r, sds[l], sds[l - 1])
            # rows outside the solved flag (Dirichlet/padding) must carry no
            # residual: the coarse apply zeroes them, and a CG coarse solve
            # on an rhs outside range(A) diverges
            return sp_c._restore_rows_(rc, None, flag, sds[l - 1])

        return restrict

    def make_prolongate_add(l):
        sp = spaces[l]

        def padd(xc, xf):
            xn = transfers[l].prolongate_and_add(xc, xf)
            return sp._restore_rows_(xn, xf, flag, sds[l])

        return padd

    def make_residual(l):
        sp = spaces[l]

        def residual(x, b):
            r = ops[l].residual(x, b, sd=sds[l])
            return sp._restore_rows_(r, None, flag, sds[l])

        return residual

    levels = {}
    for l in lrange:
        levels[l] = GMGLevel(
            apply=applies[l],
            smooth=make_smooth(l),
            dot=dots[l],
            zeros=(lambda l=l: spaces[l].zeros()),
            restrict=make_restrict(l) if l > min_level else None,
            prolongate_add=make_prolongate_add(l) if l > min_level else None,
            residual=make_residual(l) if space_kind == "p1" else None,
        )

    def coarse_solve(b, x0):
        if coarse_solve_fn is not None:
            return coarse_solve_fn(b, x0)
        return cg_solve_fixed(applies[min_level], dots[min_level], b, x0,
                              coarse_iters)

    gmg = GeometricMultigridSolver(
        levels, coarse_solve, min_level, max_level, pre_smooth, post_smooth)
    return P1GMGStack(storage, spaces, ops, transfers, inv_diags, sds, gmg,
                      flag, eigs)


def make_p2_gmg(storage: CellStorage, min_level: int, max_level: int,
                form: str = "laplace", *, device, **kwargs) -> P1GMGStack:
    """P2 GMG stack with quadratic transfers on ``device`` (reference
    pattern: P2 multigrid with P2toP2Quadratic P/R,
    GeometricMultigridSolver)."""
    return make_p1_gmg(storage, min_level, max_level, form=form,
                       device=device, space_kind="p2", **kwargs)
