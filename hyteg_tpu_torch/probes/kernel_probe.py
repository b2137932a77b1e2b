"""Counterpart of scripts/kernel_probe.py: the tet stencil kernel B2
beside its plain version, a stripped kernel and a copy, on the P1 tet
block.

Variants, as the script names them:

- A: the real kernel, B2: ``prof_r5.bench_tet``'s kernel rung;
- B: the plain path (``p1_const_apply_torch``, the counterpart of the
  script's XLA path);
- C: the stripped whole-cell kernel, ``kernels.probes.tet_stripped`` with
  15 taps, the operator's interior weights W = sum_j A[:, s, j] and the
  K0 mask (wrong at shells and faces by design);
- D: the copy, kernel P1: ``prof_r5b.bench_copy_cells``'s rung.

A and D are timed once, by the modules named, so this module builds B
and C.
"""

from __future__ import annotations

import functools

from ..kernels.p1_const_stencil import p1_const_apply_torch
from ..kernels.probes import tet_dirs, tet_stripped
from . import Rung, TetSetup

SCRIPT = "scripts/kernel_probe.py"


def variants(tet: TetSetup) -> list[Rung]:
    x, op, sp, level = tet.x, tet.op, tet.space, tet.level
    block = tuple(x.shape)
    A, E = op.stencil, op.stencil_face
    W = A.sum(-1).contiguous()
    return [
        Rung(SCRIPT, "B  plain const path", block,
             functools.partial(p1_const_apply_torch, x, A, level, 3,
                               sp.pitch, E=E), plain=True),
        Rung(SCRIPT, "C  stripped whole-cell 15pt", block,
             functools.partial(tet_stripped, x, W, tet_dirs(), 15, sp.pitch,
                               "k0"), ladder="+k0"),
    ]
