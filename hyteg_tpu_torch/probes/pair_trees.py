"""Times the paired-tet kernels B6 (``hyteg_pair_apply``), B7
(``hyteg_pair_install``) and B8 (``hyteg_pair_extract``) built from the
sources of several checkouts, in one process, at the paired-tet cases of
``chip_smoke.py``:

    python -m hyteg_tpu_torch.probes.pair_trees TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one); its
``hyteg_tpu_torch/csrc/tetpair.cu`` is compiled by ``nvcc`` (all trees at
once) into this checkout's ``hyteg_tpu_torch/_build/``. A tree may be
named more than once, so that ``parent . . parent`` times the trees in
the order parent, change, change, parent on the same card and the same
inputs. Each case builds the engine's lifted state once; every tree's
kernels are checked against their plain versions (B6: dst and the four
face arrays within 1e-5 of max|dst|, chip_smoke.py's B6_RTOL; B7 and B8
exactly) and timed by CUDA events (median of 10 replays of a CUDA graph
of 10 calls, ``core.benchtime.median_graph_ms``). Prints
the card's name and power limit, then one JSON line per tree and case.
Refuses to run without CUDA; exits 1 if a tree fails to build or to
match.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from ..core.benchtime import card, median_graph_ms
from ..kernels import build
from ..kernels import tetpair as tk

#: chip_smoke.py's TETPAIR_CASES, its meshes and its B6_RTOL
CASES = (("cube", 6), ("cube", 7), ("shell", 5))
SHELL = (2, 2, 0.55, 1.0)
RTOL = 1e-5
ENTRY_POINTS = ("hyteg_pair_apply", "hyteg_pair_install", "hyteg_pair_extract")


def compile_trees(trees: list[Path]) -> dict[Path, ctypes.CDLL]:
    """Each distinct tree's tetpair.cu built as a library of its own, the
    nvcc processes started together."""
    out_dir = build.BUILD_DIR / "pair_trees"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, tree in enumerate(dict.fromkeys(trees)):
        so = out_dir / f"tree{i}.so"
        src = tree / "hyteg_tpu_torch" / "csrc" / "tetpair.cu"
        procs[tree] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tree, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tree}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs[tree] = lib
        regs = [ln.strip() for ln in log.splitlines()
                if "Compiling entry" in ln or "Used" in ln]
        print(json.dumps({"tree": str(tree), "ptxas": regs}), flush=True)
    return libs


def engine(mesh: str, level: int, device, seed: int):
    """The paired-tet engine of chip_smoke.py's case and the lifted state
    of a consistent random x."""
    from ..functions.p1 import P1Space
    from ..mesh.meshinfo import mesh_spherical_shell, mesh_unit_cube
    from ..operators import forms
    from ..operators.p1_elementwise import P1ElementwiseOperator
    from ..primitives.storage import CellStorage
    from ..tetpair import TetPairEngine

    storage = CellStorage(mesh_unit_cube(2) if mesh == "cube"
                          else mesh_spherical_shell(*SHELL))
    sp = P1Space(storage, level, device=device)
    op = P1ElementwiseOperator(sp, forms.laplace_form)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(sp.block_shape, generator=gen, device=device)
    eng = TetPairEngine(sp, op.elmats)
    return eng, eng.lift(sp.exchange_rep(x * sp.vertex_mask_t))


def max_err(outs, refs) -> float:
    """The largest |out - ref| over the pairs of tensors, inf for a NaN."""
    errs = [(o - r).abs().max().item() for o, r in zip(outs, refs)]
    return max(math.inf if math.isnan(e) else e for e in errs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hyteg_tpu_torch.probes.pair_trees",
        description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path,
                    help="checkout roots, in the order to time them")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pair_trees: torch sees no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(card(), flush=True)
    trees = [t.resolve() for t in args.trees]
    libs = compile_trees(trees)
    dirs, tail_a, tail_b = tk._kernel_tables()
    ok = True
    for i, (mesh, level) in enumerate(CASES):
        eng, st = engine(mesh, level, device, seed=40 + i)
        N, P, Cp = eng.N, eng.P, eng.Cp
        faces = (st.xf, st.yf, st.zf, st.df)
        ins = (st.u, eng.W, *faces)
        refs = {"b6": tk.pair_apply_torch(*ins, N, P),
                "b7": (tk.pair_install_torch(st.u, *faces, N, P),),
                "b8": tk.pair_extract_torch(st.u, N, P)}
        outs = {k: [torch.empty_like(r) for r in v] for k, v in refs.items()}
        ptrs = {k: [o.data_ptr() for o in v] for k, v in outs.items()}
        args6 = [t.data_ptr() for t in ins] + ptrs["b6"]
        args7 = [t.data_ptr() for t in (st.u, *faces)] + ptrs["b7"]
        args8 = [st.u.data_ptr()] + ptrs["b8"]

        def calls(lib):  # each on the current stream, a graph's too
            return {
                "b6": lambda: lib.hyteg_pair_apply(
                    *args6, Cp, N, P, dirs.ctypes.data, tail_a, tail_b,
                    build.current_stream()),
                "b7": lambda: lib.hyteg_pair_install(
                    *args7, Cp, N, P, build.current_stream()),
                "b8": lambda: lib.hyteg_pair_extract(
                    *args8, Cp, N, P, build.current_stream())}

        scale = refs["b6"][0].abs().max().item()
        for tree in trees:
            rec = {"tree": str(tree), "mesh": mesh, "level": level,
                   "paired_block": [Cp, N, N * P]}
            for k, call in calls(libs[tree]).items():
                for o in outs[k]:
                    o.fill_(float("nan"))
                build.check_launch(call(), k)
                err = max_err(outs[k], refs[k])
                good = err <= (RTOL * scale if k == "b6" else 0.0)
                ok &= good
                rec.update({f"{k}_ms": median_graph_ms(
                    lambda: build.check_launch(call(), k), 10),
                    f"{k}_max_abs_err": err, f"{k}_ok": good})
            print(json.dumps(rec), flush=True)
        del eng, st, faces, ins, refs, outs
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
