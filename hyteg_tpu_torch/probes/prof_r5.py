"""Counterpart of scripts/prof_r5.py: what bounds the box kernel B1 and
the tet apply.

- ``bench_copy``: the copy rung at the box shape, kernel P1
  (``stream_scale``: one read and one write per slot and nothing else).
  The script times its Pallas copy at two row tilings (TX = 32, 64); the
  CUDA copy picks its own blocks, so one rung stands for both.
- ``bench_box_variants``: B1 through its operator (``apply_raw``), then
  the four stripped variants of ``kernels.probes.box_variant`` that the
  script times, with unit weights: rolls + 15 taps, no rolls + 15 taps,
  rolls + 6 taps, no rolls + 1 tap.
- ``bench_tet``: on the P1 tet block, the kernel alone
  (``_apply_local``, B2: the real rung of the tet ladder, also
  kernel_probe's variant A and prof_apply's kernel), the additive
  exchange alone (``exchange_add``) and the full apply (``apply_raw``).
"""

from __future__ import annotations

import functools

import torch

from ..kernels.probes import N_DIRS, box_variant
from ..kernels.stream import stream_scale
from . import BoxSetup, Rung, TetSetup

SCRIPT = "scripts/prof_r5.py"
#: (shift, n_taps, the script's tag, ladder rung), in the script's order
BOX_VARIANTS = ((True, 15, "rolls+15fma", "shifted 15"),
                (False, 15, "no-rolls+15fma", "no-shift 15"),
                (True, 6, "rolls+6fma", "shifted 6"),
                (False, 1, "no-rolls+1fma", "no-shift 1"))


def bench_copy(box: BoxSetup) -> list[Rung]:
    u = box.u
    X, L = u.shape
    return [Rung(SCRIPT, f"copy ({X},{L})", (X, L),
                 functools.partial(stream_scale, u), ladder="copy")]


def bench_box_variants(box: BoxSetup) -> list[Rung]:
    u, op = box.u, box.op
    X, L = u.shape
    Z = box.dom.dims[2]
    w = torch.ones((N_DIRS, L), device=u.device)
    rungs = [Rung(SCRIPT, "box apply (current)", (X, L),
                  functools.partial(op.apply_raw, u), ladder="real")]
    for shift, n_taps, tag, rung in BOX_VARIANTS:
        rungs.append(Rung(SCRIPT, f"box variant {tag}", (X, L),
                          functools.partial(box_variant, u, w, Z, shift,
                                            n_taps), ladder=rung))
    return rungs


def bench_tet(tet: TetSetup) -> list[Rung]:
    op, sp, x = tet.op, tet.space, tet.x
    block = tuple(x.shape)
    return [Rung(SCRIPT, "tet kernel only", block,
                 functools.partial(op._apply_local, x), ladder="real"),
            Rung(SCRIPT, "tet exchange_add only", block,
                 functools.partial(sp.exchange_add, x)),
            Rung(SCRIPT, "tet full apply", block,
                 functools.partial(op.apply_raw, x))]
