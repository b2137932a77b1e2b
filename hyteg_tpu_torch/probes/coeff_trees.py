"""Times the f32 kernels B3 (``hyteg_p1_diag``), B4 (``hyteg_p1_apply``)
and their 2D forms built from the sources of several checkouts, in one
process, at the shapes of ``chip_smoke.py``'s coefficient path:

    python -m hyteg_tpu_torch.probes.coeff_trees TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one); its
``hyteg_tpu_torch/csrc/{p1_apply,p1_diag,p1_tri}.cu`` are compiled by
``nvcc`` (every source of every tree at once) and linked into one library
per tree under this checkout's ``hyteg_tpu_torch/_build/``. A tree may be
named more than once, so that ``parent . . parent`` times the trees in the
order parent, change, change, parent on the same card and the same
inputs: ``mesh_unit_cube(2)`` at P1 level 7 (pitch 129) and
``mesh_rectangle(nx=4, ny=4)`` at level 11, the Laplace element matrices,
a seeded source and k = 1 + x + 0.5 y, each kernel without a coefficient
and in the three means. Every tree's result is held against the plain
version (B4 within 1e-5, B3 within 1e-6 of max|y|: chip_smoke.py's B4_RTOL
and B3's) and against the first tree's, bit for bit (``same_bits``);
times are CUDA events, the median of 10 runs of 10 back-to-back calls
(``core.benchtime.median_ms``, the ``kernels`` line's method). Prints the
card's name and power limit, each tree's ptxas registers and spill stores
per f32 function (``ptxas_f32``), then one JSON line per tree, shape,
kernel and mode. Refuses to run without CUDA; exits 1 if a tree fails to
build or to match its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..core.benchtime import card, median_ms
from ..kernels import build
from ..kernels import p1_stencil as b34
from ..operators.averaging import MODES

SOURCES = ("p1_apply.cu", "p1_diag.cu", "p1_tri.cu")
ENTRY_POINTS = ("hyteg_p1_apply", "hyteg_p1_diag", "hyteg_p1_apply_2d",
                "hyteg_p1_diag_2d")
#: (dim, P1 level) of chip_smoke.py's coefficient path; its pitch
CASES = ((3, 7), (2, 11))
PITCH = (1 << 7) + 1
RTOL = {"b4": 1e-5, "b3": 1e-6}


def compile_trees(trees: list[Path]) -> dict[Path, ctypes.CDLL]:
    """Each distinct tree's three sources built and linked as a library of
    its own, every nvcc -c started together."""
    out_dir = build.BUILD_DIR / "coeff_trees"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, tree in enumerate(dict.fromkeys(trees)):
        for src in SOURCES:
            obj = out_dir / f"tree{i}_{src}.o"
            procs.append((i, tree, obj, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-c", "-o", str(obj),
                 str(tree / "hyteg_tpu_torch" / "csrc" / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, logs = {}, {}
    for i, tree, obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tree}:\n{log}")
        objs.setdefault(tree, (i, []))[1].append(str(obj))
        logs[tree] = logs.get(tree, "") + log
    libs = {}
    for tree, (i, files) in objs.items():
        so = out_dir / f"tree{i}.so"
        subprocess.run([build._nvcc(), *build.ARCH, "-shared", "-o", str(so),
                        *files], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs[tree] = lib
        print(json.dumps({"tree": str(tree),
                          "ptxas_f32": ptxas_f32(logs[tree])}), flush=True)
    return libs


def ptxas_f32(log: str) -> dict:
    """ptxas -v's registers and spill stores of each f32 function (the
    bf16 ones left out), by mangled name with the file-local namespace's
    hash taken out, so that two trees' reports compare as dicts."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", m.group(1))
            name = None if re.search(r"bf16|BF16", name) else name
            continue
        if name is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_stores", r"(\d+) bytes spill stores")):
            m = re.search(pat, line)
            if m:
                out.setdefault(name, {})[key] = int(m.group(1))
    return out


def inputs(dim: int, level: int, device, seed: int):
    """The case's space, Laplace element matrices, a seeded source on the
    simplex and k = 1 + x + 0.5 y."""
    from ..functions.p1 import P1Space
    from ..mesh.meshinfo import mesh_rectangle, mesh_unit_cube
    from ..operators import forms
    from ..operators.p1_elementwise import P1ElementwiseOperator
    from ..primitives.storage import CellStorage

    storage = CellStorage(mesh_unit_cube(2) if dim == 3
                          else mesh_rectangle(nx=4, ny=4))
    sp = P1Space(storage, level, device=device, pitch=PITCH)
    elm = P1ElementwiseOperator(sp, forms.laplace_form).elmats
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(sp.block_shape, generator=gen, device=device)
    x *= sp.vertex_mask_t
    p = sp.coords()
    k = ((1.0 + p[..., 0] + 0.5 * p[..., 1]) * sp.vertex_mask_t).contiguous()
    return sp, elm, x, k


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hyteg_tpu_torch.probes.coeff_trees",
        description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path,
                    help="checkout roots, in the order to time them")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("coeff_trees: torch sees no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(card(), flush=True)
    trees = [t.resolve() for t in args.trees]
    libs = compile_trees(trees)
    ok = True
    for i, (dim, level) in enumerate(CASES):
        sp, elm, x, k = inputs(dim, level, device, seed=90 + i)
        offs, margins = b34._kernel_tables(dim)
        C, N, s = sp.block_shape[0], sp.N, build.current_stream()
        tables = (offs.ctypes.data, margins.ctypes.data, s)
        dst = torch.empty_like(x)
        for kernel in ("b4", "b3"):
            for mode in (None,) + MODES:
                co = None if mode is None else k.data_ptr()
                m = MODES.index(mode or "arithmetic")

                def call(lib, kernel=kernel, co=co, m=m):
                    if kernel == "b4" and dim == 3:
                        return lib.hyteg_p1_apply(
                            x.data_ptr(), co, elm.data_ptr(), dst.data_ptr(),
                            C, N, PITCH, m, *tables)
                    if kernel == "b4":
                        return lib.hyteg_p1_apply_2d(
                            x.data_ptr(), co, elm.data_ptr(), dst.data_ptr(),
                            C, N, m, *tables)
                    if dim == 3:
                        return lib.hyteg_p1_diag(
                            elm.data_ptr(), co, dst.data_ptr(), C, N, PITCH,
                            0, m, *tables)
                    return lib.hyteg_p1_diag_2d(
                        elm.data_ptr(), co, dst.data_ptr(), C, N, 0, m,
                        *tables)

                kk = None if co is None else k
                mean = mode or "arithmetic"
                ref = (b34.p1_apply_local_torch(x, elm, level, dim, PITCH, kk,
                                                mean) if kernel == "b4" else
                       b34.p1_diagonal_local_torch(elm, level, dim, PITCH,
                                                   False, kk, mean))
                scale, first = ref.abs().max().item(), None
                for tree in trees:
                    dst.fill_(float("nan"))
                    build.check_launch(call(libs[tree]), kernel)
                    err = (dst - ref).abs().max().item()
                    good = err <= RTOL[kernel] * scale
                    ok &= good
                    if first is None:
                        first = dst.clone()
                    rec = {"tree": str(tree), "dim": dim, "level": level,
                           "kernel": kernel, "mode": mode or "none",
                           "ms": median_ms(lambda: call(libs[tree]), 10,
                                           batch=10),
                           "max_abs_err": err, "ok": good,
                           "same_bits": bool(torch.equal(dst, first))}
                    print(json.dumps(rec), flush=True)
                del ref, first
        del sp, elm, x, k, dst
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
