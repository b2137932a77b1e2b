"""Counterpart of scripts/prof_apply.py: the P1 tet apply decomposed into
the stencil kernel and the exchange, beside a two-pass elementwise
``2 v + 1`` that calibrates what one read and one write of the block cost
through torch.

The apply, the kernel alone and the exchange alone are
``prof_r5.bench_tet``'s rungs on the same block, so this module adds only
``2 v + 1``.
"""

from __future__ import annotations

import functools

from . import Rung, TetSetup

SCRIPT = "scripts/prof_apply.py"


def _axpy(v):
    return v * 2.0 + 1.0


def decompose(tet: TetSetup) -> list[Rung]:
    return [Rung(SCRIPT, "axpy (copy cal)", tuple(tet.x.shape),
                 functools.partial(_axpy, tet.x))]
