"""Geometric multigrid: V/W-cycles and full multigrid over a level
hierarchy; torch counterpart of hyteg_tpu/solvers/gmg.py.

Reference: src/hyteg/solvers/GeometricMultigridSolver.hpp:39-301 and
FullMultigridSolver.hpp:36. The recursion runs eagerly in Python;
smoothers and the coarse solver are injected as callables on raw DoF
blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..core.types import CycleType


@dataclasses.dataclass
class GMGLevel:
    """Per-level bundle of callables (all on raw tensors).

    apply:     x -> A x restricted to solved rows (zero on Dirichlet rows)
    smooth:    (x, b) -> x'
    restrict:  residual fine -> coarse
    prolongate_add: (coarse correction, fine x) -> fine x'
    dot:       (u, v) -> scalar (global, each DoF once)
    zeros:     () -> zero block of this level
    residual:  (x, b) -> b - A x on the solved rows
    """

    apply: Callable
    smooth: Callable
    dot: Callable
    zeros: Callable
    restrict: Callable | None = None        # to next-coarser level
    prolongate_add: Callable | None = None  # from next-coarser level
    residual: Callable | None = None


class GeometricMultigridSolver:
    """V/W-cycle over ``levels[min_level..max_level]``.

    levels: dict level -> GMGLevel; coarse_solve: (b, x0) -> x on min level.
    """

    def __init__(
        self,
        levels: dict[int, GMGLevel],
        coarse_solve: Callable,
        min_level: int,
        max_level: int,
        pre_smooth: int = 3,
        post_smooth: int = 3,
        cycle_type: CycleType = CycleType.V,
        smooth_increment_on_coarser: int = 0,
    ):
        self.levels = levels
        self.coarse_solve = coarse_solve
        self.min_level = min_level
        self.max_level = max_level
        self.pre = pre_smooth
        self.post = post_smooth
        self.cycle_type = cycle_type
        self.inc = smooth_increment_on_coarser

    def _smoothers(self, level: int, pre: bool) -> list:
        """The smoothing callables of ``level``'s pre (or post) half."""
        count = (self.pre if pre else self.post) + self.inc * (
            self.max_level - level)
        return [self.levels[level].smooth] * count

    def cycle(self, x, b, level: int | None = None):
        level = self.max_level if level is None else level
        if level == self.min_level:
            return self.coarse_solve(b, x)
        L = self.levels[level]
        for sm in self._smoothers(level, True):
            x = sm(x, b)
        r = L.residual(x, b) if L.residual is not None else b - L.apply(x)
        r_c = L.restrict(r)
        x_c = self.levels[level - 1].zeros()
        x_c = self.cycle(x_c, r_c, level - 1)
        if self.cycle_type == CycleType.W and level - 1 > self.min_level:
            x_c = self.cycle(x_c, r_c, level - 1)
        x = L.prolongate_add(x_c, x)
        for sm in self._smoothers(level, False):
            x = sm(x, b)
        return x

    def solve(self, x, b, num_cycles: int):
        for _ in range(num_cycles):
            x = self.cycle(x, b)
        return x


class FlexibleMultigridSolver(GeometricMultigridSolver):
    """Per-level smoother lists (reference: FlexibleMultigridSolver.hpp):
    ``pre_lists``/``post_lists`` map level -> list of (x, b) -> x smoothing
    callables applied in order, overriding the uniform pre/post counts; a
    level missing from a map smooths with ``[L.smooth] * 3``."""

    def __init__(self, levels, coarse_solve, min_level, max_level,
                 pre_lists: dict | None = None,
                 post_lists: dict | None = None,
                 cycle_type: CycleType = CycleType.V):
        super().__init__(levels, coarse_solve, min_level, max_level,
                         pre_smooth=0, post_smooth=0, cycle_type=cycle_type)
        self.pre_lists = pre_lists or {}
        self.post_lists = post_lists or {}

    def _smoothers(self, level: int, pre: bool) -> list:
        lists = self.pre_lists if pre else self.post_lists
        return lists.get(level, [self.levels[level].smooth] * 3)


class FullMultigridSolver:
    """FMG nested iteration (reference: FullMultigridSolver.hpp:36).

    prolongate_full[l]: coarse-level-l solution -> level l+1 initial guess
    rhs[l]: the RHS block on level l.
    """

    def __init__(
        self,
        gmg: GeometricMultigridSolver,
        prolongate_full: dict[int, Callable],
        cycles_per_level: int = 1,
    ):
        self.gmg = gmg
        self.prolongate_full = prolongate_full
        self.cycles_per_level = cycles_per_level

    def solve(self, rhs: dict, x_coarse):
        g = self.gmg
        x = g.coarse_solve(rhs[g.min_level], x_coarse)
        for level in range(g.min_level + 1, g.max_level + 1):
            x = self.prolongate_full[level - 1](x)
            sub = GeometricMultigridSolver(
                g.levels, g.coarse_solve, g.min_level, level,
                g.pre, g.post, g.cycle_type, g.inc,
            )
            for _ in range(self.cycles_per_level):
                x = sub.cycle(x, rhs[level], level)
        return x
