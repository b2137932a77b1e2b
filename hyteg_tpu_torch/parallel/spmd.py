"""Sharded execution of the P1 and Stokes solvers over a shard group
(torch counterpart of hyteg_tpu/parallel/spmd.py).

Reference: the MPI distribution of macro-primitives
(src/hyteg/primitivestorage/PrimitiveStorage.cpp:62-140) with halo
exchange (communication/BufferedCommunication.*). Macro-cells are split
over the shards of a storage; every shard builds its own operators, shard
data and solver stack once, on the host, from its own cells, and runs the
same per-shard code under a LocalGroup (S shards in one process) or a
DistGroup (one shard per process over torch.distributed): see comm.py.

Sharded arrays are lists of per-shard blocks (C_loc, ...) aligned with
``group.local_ranks``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..functions.p1 import P1ShardData, P1Space
from ..primitives.storage import CellStorage


class SpmdContext:
    """A sharded storage, its group and BC, the shared lane pitch, and the
    spaces and shard data per level (the counterpart of the JAX package's
    SpmdContext over a device mesh)."""

    def __init__(self, storage: CellStorage, group,
                 bc: BoundaryCondition | None = None,
                 pitch: int | None = None, *, device, dtype=torch.float32):
        if group.size != storage.num_shards:
            raise ValueError(f"a group of {group.size} shards for a storage "
                             f"of {storage.num_shards}")
        self.storage = storage
        self.group = group
        self.bc = bc or BoundaryCondition.all_dirichlet()
        #: shared lane pitch of GMG stacks; None: each level's own N
        self.pitch = pitch
        self.device = torch.device(device)
        self.dtype = dtype
        self._spaces: dict = {}

    @property
    def local_ranks(self) -> list:
        return self.group.local_ranks

    def with_pitch(self, pitch: int) -> "SpmdContext":
        return SpmdContext(self.storage, self.group, self.bc, pitch,
                           device=self.device, dtype=self.dtype)

    def space(self, level: int) -> P1Space:
        """The level's space, shared by every local shard; its host tables
        are built here, once, before any shard runs."""
        if level not in self._spaces:
            sp = P1Space(self.storage, level, device=self.device,
                         dtype=self.dtype, pitch=self.pitch)
            warm_tables(sp)
            self._spaces[level] = sp
        return self._spaces[level]

    def sd(self, group, level: int) -> P1ShardData:
        return self.space(level).group_shard_data(group, self.bc)

    def run(self, fn: Callable, *per_shard) -> list:
        """``fn(group, *args)`` on every local shard (comm.py)."""
        return self.group.run(fn, *per_shard)

    def shard(self, fn: Callable, levels: list) -> Callable:
        """Wrap ``fn(x1..xn, sd_l1.., )`` to run per shard: the wrapper
        takes per-shard lists and hands fn each shard's blocks and its
        shard data per level (the JAX package's ``shard``)."""
        def wrapped(*arrays):
            return self.run(lambda g, *xs: fn(
                *xs, *[self.sd(g, l) for l in levels]), *arrays)

        return wrapped

    def interpolate(self, level: int, expr, flag: DoFType = DoFType.ALL):
        """Per-shard blocks of ``expr`` on the level's P1 space."""
        sp = self.space(level)
        return self.run(lambda g: sp.interpolate(
            expr, sp.zeros(), flag, self.sd(g, level)))


def warm_tables(space) -> None:
    """Build a sharded space's host tables (slot maps, neighbour and
    overlap tables) in the calling thread, so that shards running in
    threads only read them."""
    sp = getattr(space, "node_space", space)
    sp.maps
    if sp.storage.num_shards > 1:
        sp._nbr_tables
        sp._ovl_tables


def build_agglomerated_coarse_solve(ctx: SpmdContext, level: int, form=None,
                                    coarse_iters: int = 100) -> Callable:
    """Coarse solve in the agglomeration style (reference:
    solvers/controlflow/AgglomerationWrapper.hpp:75): all-gather the
    coarse blocks, run CG on the whole (small) coarse system redundantly
    on every shard with no communication, keep the local slice.

    Returns ``for_shard(group) -> coarse_solve(b, x0)``."""
    from ..operators import forms
    from ..operators.p1_elementwise import (P1ElementwiseOperator,
                                            compute_elmats)
    from ..solvers.krylov import cg_solve_fixed

    form = form or forms.laplace_form
    sp = ctx.space(level)
    gsd = sp.global_shard_data(ctx.bc)
    op = P1ElementwiseOperator(
        sp, form, elmats=compute_elmats(sp, form, gsd.cell_vertices))
    C = ctx.storage.cells_per_shard

    def for_shard(group):
        def coarse_solve(b, x0):
            xg = group.all_gather(x0)
            bg = group.all_gather(b)
            xg = cg_solve_fixed(lambda v: op.apply_inner(v, gsd, FLAG_INNER),
                                lambda u, v: sp.dot(u, v, FLAG_INNER, gsd),
                                bg, xg, coarse_iters)
            return xg[group.rank * C:(group.rank + 1) * C].contiguous()

        return coarse_solve

    return for_shard


class SpmdSolver:
    """Per-shard solver stacks and a cycle over them: ``self(xs, bs)``
    runs one V-cycle on every local shard and returns the new blocks."""

    def __init__(self, ctx: SpmdContext, stacks: list):
        self.ctx = ctx
        self.stacks = stacks

    def __call__(self, xs: list, bs: list) -> list:
        return self.ctx.run(lambda g, st, x, b: st.gmg.cycle(x, b),
                            self.stacks, xs, bs)


def build_spmd_poisson_vcycle(ctx: SpmdContext, min_level: int,
                              max_level: int, form=None,
                              smoother: str = "chebyshev",
                              eigs: dict | None = None,
                              agglomerate_coarse: bool = False,
                              **gmg_kwargs) -> SpmdSolver:
    """A sharded P1 V-cycle: (xs, bs) -> xs, one make_p1_gmg stack per
    shard over the group's shard data. With ``agglomerate_coarse`` the
    coarse level is all-gathered and solved redundantly on every shard
    (build_agglomerated_coarse_solve). Each stack's ``residual_norm`` is
    global."""
    from ..operators import forms
    from ..solvers.templates import make_p1_gmg

    form = form or forms.laplace_form
    if ctx.pitch is None and ctx.storage.dim == 3:
        ctx = ctx.with_pitch((1 << max_level) + 1)
    lrange = range(min_level, max_level + 1)
    spaces = {l: ctx.space(l) for l in lrange}
    coarse = (build_agglomerated_coarse_solve(
        ctx, min_level, form, gmg_kwargs.get("coarse_iters", 100))
        if agglomerate_coarse else None)

    def build(g):
        return make_p1_gmg(
            ctx.storage, min_level, max_level, form=form, bc=ctx.bc,
            smoother=smoother, eigs=eigs, dtype=ctx.dtype, device=ctx.device,
            shard=g.rank, sd_per_level={l: ctx.sd(g, l) for l in lrange},
            spaces=spaces,
            coarse_solve_fn=None if coarse is None else coarse(g),
            **gmg_kwargs)

    return SpmdSolver(ctx, ctx.run(build))


def build_spmd_apply(ctx: SpmdContext, level: int, form=None) -> Callable:
    """The sharded operator apply: xs -> [A x] per shard (overlapped with
    the neighbour exchange where the shard data has overlap tables)."""
    from ..operators import forms
    from ..operators.p1_elementwise import P1ElementwiseOperator

    form = form or forms.laplace_form
    sp = ctx.space(level)
    ops = ctx.run(lambda g: P1ElementwiseOperator(sp, form, shard=g.rank))

    def apply(xs: list) -> list:
        return ctx.run(lambda g, op, x: op.apply_raw(x, sd=ctx.sd(g, level)),
                       ops, xs)

    return apply


def build_spmd_stokes_vcycle(ctx: SpmdContext, min_level: int,
                             max_level: int, viscosity: float = 1.0,
                             mu=None, epsilon: bool = False,
                             eigs: dict | None = None,
                             spaces_per_level: dict | None = None,
                             **gmg_kwargs) -> SpmdSolver:
    """A sharded Stokes (Uzawa) V-cycle: (xs, bs) -> xs with per-shard
    TaylorHoodVec lists (the SPMD analog of the reference's distributed
    Stokes GMG, apps/2020-scaling-workshop/Helpers.cpp:103-173). Velocity
    shard data on the node grid (level + 1) under the context's BC,
    pressure on the vertex grid under all-Neumann. Pass ``eigs`` (per
    level eig_max) to skip the power iterations; ``spaces_per_level``
    ({level: stokes_spaces(...)} on the shared pitch) to reuse spaces."""
    from ..composites.stokes import stokes_spaces
    from ..solvers.uzawa import make_stokes_gmg

    lrange = range(min_level, max_level + 1)
    pitch = (1 << (max_level + 1)) + 1
    spaces = spaces_per_level or {
        l: stokes_spaces(ctx.storage, l, pitch, device=ctx.device,
                         dtype=ctx.dtype) for l in lrange}
    for vsp, psp in spaces.values():
        warm_tables(vsp)
        warm_tables(psp)
    neumann = BoundaryCondition.all_neumann()

    def build(g):
        sdl = {l: (spaces[l][0].group_shard_data(g, ctx.bc),
                   spaces[l][1].group_shard_data(g, neumann))
               for l in lrange}
        return make_stokes_gmg(
            ctx.storage, min_level, max_level, bc=ctx.bc,
            viscosity=viscosity, mu=mu, epsilon=epsilon, eigs=eigs,
            dtype=ctx.dtype, device=ctx.device, shard=g.rank,
            sd_per_level=sdl, spaces_per_level=spaces, **gmg_kwargs)

    return SpmdSolver(ctx, ctx.run(build))


def _by_gid(space, shard_blocks: list) -> dict:
    """{global DoF id: value} over every shard's block (host)."""
    out = {}
    for d, blk in enumerate(shard_blocks):
        ids = space.global_ids(d)
        v = blk.detach().cpu().numpy()
        sel = ids >= 0
        out.update(zip(ids[sel].tolist(), v[sel].tolist()))
    return out


def _rel_diff(space1, blocks1: list, spaceS, blocksS: list) -> float:
    """max |a - b| / max |a| over the global DoFs of two layouts."""
    a, b = _by_gid(space1, blocks1), _by_gid(spaceS, blocksS)
    scale = max(max(abs(v) for v in a.values()), 1e-30)
    return max(abs(a[g] - b[g]) for g in a) / scale


def dryrun_multichip(n: int, *, device) -> dict:
    """One pass over the sharded path with an n-shard LocalGroup on
    ``device``, each result held against the one-shard run of the same
    code (the JAX package's __graft_entry__.dryrun_multichip checks only
    finiteness): the P1 V-cycle, the Stokes (Uzawa) V-cycle, the box
    V-cycles and the coupled convection step. Returns the relative
    differences; raises when one is above its bound."""
    import math

    from ..mesh import meshinfo as mi
    from ..structured import BoxDomain
    from ..structured import spmd as box_spmd
    from ..terraneo.params import ConvectionParameters
    from ..terraneo.spmd_sim import ShardedConvectionSimulation
    from .comm import LocalGroup

    device = torch.device(device)
    mesh = mi.mesh_unit_cube(2) if n <= 48 else mi.mesh_unit_cube(4)
    res = {}

    def pair(S):
        st = CellStorage(mesh, num_shards=S, partitioner="sfc")
        return SpmdContext(st, LocalGroup(S), device=device)

    # P1 V-cycle from a smooth start, b = 0
    U = lambda p: p[..., 0] * p[..., 1] + p[..., 2]
    runs = {}
    for S in (1, n):
        vc = build_spmd_poisson_vcycle(pair(S), 0, 2, coarse_iters=10,
                                       agglomerate_coarse=S > 1)
        xs = vc.ctx.interpolate(2, U)
        runs[S] = (vc.ctx.space(2), vc(xs, [torch.zeros_like(x) for x in xs]))
    res["p1_vcycle_rel"] = _rel_diff(*runs[1], *runs[n])

    # Stokes V-cycle, b = (u_f, 0) per velocity component
    uf = lambda p: p[..., 0] * p[..., 1]
    eigs = {0: 2.0, 1: 2.0}
    runs = {}
    for S in (1, n):
        ctx = pair(S)
        vc = build_spmd_stokes_vcycle(ctx, 0, 1, coarse_iters=8, eigs=eigs)

        def one(g, stack):
            st = stack.stokes[1]
            b = st.interpolate_velocity([uf] * st.dim, st.zeros())
            return stack.gmg.cycle(st.zeros(), b)

        out = ctx.run(one, vc.stacks)
        runs[S] = (vc.stacks[0].stokes[1].vel_space, [o.vel[0] for o in out])
    res["stokes_vcycle_rel"] = _rel_diff(*runs[1], *runs[n])

    # box: two sharded V-cycles against two one-shard ones
    min_level = max(1, math.ceil(math.log2(max(n, 2))) - 1)
    dom = BoxDomain((2, 1, 1), level=min_level + 2, device=device)
    f = dom.interpolate(lambda x, y, z: torch.sin(math.pi * x) * y * (1 - z))
    rns = {}
    for S in (1, n):
        levels = box_spmd.build_spmd_hierarchy(dom, S, min_level=min_level)
        out = LocalGroup(S).run(
            lambda g, ff: box_spmd.spmd_solve_poisson(g, levels, ff, cycles=2),
            box_spmd.shard_field(f, levels[0].rows))
        rns[S] = out[0][1].cpu()
    res["box_residuals"] = rns[n].tolist()
    res["box_residual_rel"] = float(((rns[n] - rns[1]).abs()
                                     / rns[1].abs()).max())

    # coupled convection step on the annulus
    tp = ConvectionParameters(dim=2, level=2, ntan=4 * n, nrad=2,
                              rayleigh=1e4, max_dt=1e-4, energy_cg_iters=15)
    obs = {}
    for S in (1, n):
        sim = ShardedConvectionSimulation(tp, num_shards=S, device=device,
                                          stokes_cycles=1)
        T, x = sim.step(*sim.initial_state())
        obs[S] = sim.observables(T, x)
    res["convection_obs"] = obs[n]
    res["convection_rel"] = max(abs(a - b) / abs(b)
                                for a, b in zip(obs[n], obs[1]))

    bounds = {"p1_vcycle_rel": 1e-4, "stokes_vcycle_rel": 1e-4,
              "box_residual_rel": 1e-4, "convection_rel": 2e-5}
    for k, bound in bounds.items():
        if not res[k] <= bound:
            raise AssertionError(f"dryrun_multichip({n}): {k} {res[k]} > "
                                 f"{bound}")
    if not (res["box_residuals"][-1] < res["box_residuals"][0]):
        raise AssertionError("dryrun_multichip: the box residual did not drop")
    return res
