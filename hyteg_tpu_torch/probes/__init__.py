"""The kernel-dissection path: ladders of stripped kernels that take the
box stencil kernel B1 and the tet stencil kernel B2 apart on the card.

    python -m hyteg_tpu_torch.probes [--shape jax|main|all]

One module per profiling script of the JAX package, so that each
counterpart is found by name:

- ``prof_r5``: the copy rung at the box shape, B1 and the four stripped
  box variants, and the tet apply split into kernel, exchange and both;
- ``prof_r5b``: the copy rung over the tet block and the stripped tet
  kernel with 15 or 6 taps, unmasked, and with 15 taps and the K0 and
  shell masks; then, beyond the script, one tap unmasked, with K0 and
  with K0 and the shell (B2's thread mapping with a single load), and
  15 taps with K0 and unit weights;
- ``kernel_probe``: B2's plain version and the stripped kernel with the
  K0 mask and the operator's interior weights (its B2 and copy variants
  are the rungs above);
- ``prof_apply``: ``2 v + 1`` (its apply, kernel and exchange are
  ``prof_r5``'s rungs).

Each module builds rungs (a rung's inputs and its callable) apart from
timing them, so the tests build and call every rung on the CPU; a call
that two scripts time is built once. ``ladder``
times one shape set's rungs with CUDA events (``core.benchtime``) and
returns one record per rung: its ms, its rate at 8 B per slot of the
block (the scripts' count: 8 B per DoF for the box, 2 NB for the tet
block) and its share of the real kernel's time on the same block. The
rungs, from the least work to the real kernel:

    copy; no-shift 1 / 15 taps; shifted 1 / 6 / 15 taps; + K0 1 tap;
    + shells 1 tap; + K0 (interior, unit weights); + shells; real.

Shape sets: ``jax``, the scripts' own (box level 7, (257, 66049); tet
level 6 with pitch 65, (48, 65, 4225)); ``main``, the port's main-path
blocks (tet level 7 with pitch 129, (48, 129, 16641), B2's timed block;
box level 9, (1025, 1050625), B1's level-9 solve block).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch

#: (kind, level) of each block of a shape set, in the order they are timed
SHAPE_SETS = {"jax": (("box", 7), ("tet", 6)),
              "main": (("tet", 7), ("box", 9))}
BOX_M = (2, 2, 2)  # prof_r5.py:70
TET_MESH_N = 2     # mesh_unit_cube(2), 48 macro-tets (prof_r5.py:146)
BYTES_PER_SLOT = 8
LADDER = ("copy", "no-shift 1", "no-shift 15", "shifted 1", "shifted 6",
          "shifted 15", "+k0 1 tap", "+shells 1 tap", "+k0", "+k0 unit w",
          "+shells", "real")


@dataclass
class Rung:
    """One timed call: ``fn()`` on a block of shape ``block``.

    ``ladder``: its place among LADDER, or None for a rung off the ladder
    (the apply, the exchange); the one "real" rung of a block, its real
    kernel, is the yardstick of every share on that block. ``plain``: a
    plain torch version (timed with fewer, single calls)."""

    script: str
    name: str
    block: tuple[int, ...]
    fn: Callable[[], object] = field(repr=False)
    ladder: str | None = None
    plain: bool = False


@dataclass
class BoxSetup:
    """prof_r5.py's box: BoxDomain(BOX_M, level), its default operator and
    a seeded random block."""

    dom: object
    op: object
    u: torch.Tensor


@dataclass
class TetSetup:
    """prof_r5.py's tet: P1 Laplace on mesh_unit_cube(2) at one level with
    the space's own pitch (N), and a seeded random block masked to the
    tet."""

    level: int
    space: object
    op: object
    x: torch.Tensor


def box_setup(level: int, *, device, seed: int = 0) -> BoxSetup:
    from ..structured import BoxDomain, BoxStencilOperator

    dom = BoxDomain(BOX_M, level, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn(dom.block_shape, generator=gen, device=device)
    return BoxSetup(dom, BoxStencilOperator(dom), u)


def tet_setup(level: int, *, device, seed: int = 0) -> TetSetup:
    from ..functions.p1 import P1Space
    from ..mesh.meshinfo import mesh_unit_cube
    from ..operators import forms
    from ..operators.p1_elementwise import P1ElementwiseOperator
    from ..primitives.storage import CellStorage

    sp = P1Space(CellStorage(mesh_unit_cube(TET_MESH_N)), level,
                 device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(sp.block_shape, generator=gen, device=device)
    x *= sp.vertex_mask_t
    return TetSetup(level, sp, P1ElementwiseOperator(sp, forms.laplace_form),
                    x)


def box_rungs(level: int, *, device) -> list[Rung]:
    """Every box rung at one level: prof_r5's copy, B1 and variants."""
    from . import prof_r5

    box = box_setup(level, device=device)
    return prof_r5.bench_copy(box) + prof_r5.bench_box_variants(box)


def tet_rungs(level: int, *, device) -> list[Rung]:
    """Every tet rung at one level, script by script."""
    from . import kernel_probe, prof_apply, prof_r5, prof_r5b

    tet = tet_setup(level, device=device)
    return (prof_r5.bench_tet(tet) + prof_r5b.bench_copy_cells(tet)
            + prof_r5b.bench_fma(tet) + kernel_probe.variants(tet)
            + prof_apply.decompose(tet))


def measure(rungs: list[Rung]) -> list[dict]:
    """Times each rung (kernels: median of 10 runs of 10 back-to-back
    calls; plain versions: median of 3 single calls) and returns one
    record per rung, with its share of the real rung's time."""
    from ..core.benchtime import median_ms

    rows = []
    for r in rungs:
        ms = (median_ms(r.fn, 3, warmup=1) if r.plain
              else median_ms(r.fn, 10, batch=10))
        slots = math.prod(r.block)
        rows.append({"script": r.script, "probe": r.name,
                     "block": list(r.block), "ladder": r.ladder,
                     "plain": r.plain, "ms": ms,
                     "gb_per_s": BYTES_PER_SLOT * slots / (ms * 1e-3) / 1e9})
    real = {tuple(row["block"]): row for row in rows
            if row["ladder"] == "real"}
    for row in rows:
        ref = real.get(tuple(row["block"]))
        row["share_of_real"] = ref and row["ms"] / ref["ms"]
        row["real_probe"] = ref and ref["probe"]
    return rows


def ladder(shape_set: str, *, device, card: str) -> list[dict]:
    """Times every rung of one shape set on the card, block by block;
    one record per rung, each with the shape set and the card."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("the probes time the card: pass a CUDA device")
    rows = []
    for kind, level in SHAPE_SETS[shape_set]:
        build = box_rungs if kind == "box" else tet_rungs
        rungs = build(level, device=device)
        rows += [{"shape_set": shape_set, "kind": kind, "level": level,
                  **row, "card": card} for row in measure(rungs)]
        del rungs
        torch.cuda.empty_cache()
    return rows


def summary(rows: list[dict]) -> list[dict]:
    """Per block, the ladder's rungs in LADDER order: (rung, probe, ms,
    share of the real kernel); for a tet block also the warps per cell
    that run the taps under each mask (``prof_r5b.active_warps``)."""
    from ..kernels.probes import MASKS
    from .prof_r5b import active_warps

    out = []
    for key in dict.fromkeys((r["shape_set"], r["kind"], tuple(r["block"]))
                             for r in rows):
        mine = [r for r in rows
                if (r["shape_set"], r["kind"], tuple(r["block"])) == key]
        steps = [[r["ladder"], r["probe"], r["ms"], r["share_of_real"]]
                 for name in LADDER for r in mine if r["ladder"] == name]
        line = {"shape_set": key[0], "kind": key[1],
                "block": list(key[2]), "ladder": steps}
        if key[1] == "tet":
            _, N, L = key[2]
            line["active_warps_per_cell"] = {
                m: active_warps(N, L // N, m) for m in MASKS}
        out.append(line)
    return out
