"""Full Approximation Scheme (nonlinear multigrid); torch counterpart of
hyteg_tpu/solvers/fas.py.

Reference: src/hyteg/solvers/FAS.hpp (tested by
tests/hyteg/convergence/P1FASConvergenceTest.cpp). The coarse problem is
 A_c(x_c) = A_c(R_inj x_f) + R (b_f - A_f(x_f)); the correction
 x_f += P (x_c - R_inj x_f). For a linear operator FAS reproduces the
linear V-cycle.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class FASLevel:
    apply: Callable              # nonlinear operator x -> A(x)
    smooth: Callable             # (x, b) -> x'
    restrict: Callable | None    # residual restriction (to coarser)
    restrict_inj: Callable | None  # solution restriction (injection)
    prolongate: Callable | None  # coarse correction -> fine
    zeros: Callable


class FASSolver:
    def __init__(self, levels: dict[int, FASLevel], coarse_solve: Callable,
                 min_level: int, max_level: int,
                 pre_smooth: int = 3, post_smooth: int = 3):
        self.levels = levels
        self.coarse_solve = coarse_solve
        self.min_level = min_level
        self.max_level = max_level
        self.pre = pre_smooth
        self.post = post_smooth

    def cycle(self, x, b, level: int | None = None):
        level = self.max_level if level is None else level
        if level == self.min_level:
            return self.coarse_solve(b, x)
        L = self.levels[level]
        for _ in range(self.pre):
            x = L.smooth(x, b)
        r = b - L.apply(x)
        x_c0 = L.restrict_inj(x)
        Lc = self.levels[level - 1]
        b_c = Lc.apply(x_c0) + L.restrict(r)
        x_c = self.cycle(x_c0, b_c, level - 1)
        x = x + L.prolongate(x_c - x_c0)
        for _ in range(self.post):
            x = L.smooth(x, b)
        return x

    def solve(self, x, b, cycles: int):
        for _ in range(cycles):
            x = self.cycle(x, b)
        return x
