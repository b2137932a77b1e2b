"""Build and load the port's hand-written CUDA kernels.

The sources ``hyteg_tpu_torch/csrc/*.cu`` (plus their ``*.cuh``) are
compiled by ``nvcc`` for Hopper (``sm_90a``), one ``nvcc -c`` per source,
all started together, and linked into one shared library with a plain C
interface, on first use, into ``hyteg_tpu_torch/_build/``. The
library's name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. It is loaded with
ctypes; every pointer and the stream pass as ``c_void_p`` (ctypes would
otherwise pass a Python int as a 32-bit C int and cut the pointer).

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes (all return int = cudaGetLastError())
SIGNATURES = {
    # src, A, E, dst, C, N, pitch, dirs, gmask, stream
    "hyteg_p1_const_apply": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # src, A, E, dst, C, N, dirs, gmask, stream (2D)
    "hyteg_p1_const_apply_2d": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
    # elmats, coeff, dst, C, N, lumped, mode, offs, margins, stream (2D)
    "hyteg_p1_diag_2d": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # src, coeff, elmats, dst, C, N, mode, offs, margins, stream (2D)
    "hyteg_p1_apply_2d": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # src, W, dst, C, M, dirs, stream (2D)
    "hyteg_p2_const_apply_2d": [_P, _P, _P, _I, _I, _P, _P],
    # elmats, coeff, dst, C, N, pitch, lumped, mode, offs, margins, stream
    "hyteg_p1_diag": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # src, A, E, dst (all bf16), C, N, pitch, dirs, gmask, stream
    "hyteg_p1_const_apply_bf16": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # elmats, coeff, dst (all bf16), C, N, pitch, lumped, mode, offs,
    # margins, stream
    "hyteg_p1_diag_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # src, coeff, elmats, dst (all bf16), C, N, pitch, mode, offs,
    # margins, stream
    "hyteg_p1_apply_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # src, A, E, dst (all bf16), C, N, dirs, gmask, stream (2D)
    "hyteg_p1_const_apply_2d_bf16": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
    # elmats, coeff, dst (all bf16), C, N, lumped, mode, offs, margins,
    # stream (2D)
    "hyteg_p1_diag_2d_bf16": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # src, coeff, elmats, dst (all bf16), C, N, mode, offs, margins,
    # stream (2D)
    "hyteg_p1_apply_2d_bf16": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # src, W, dst (all bf16), C, M, pitch, dirs, stream
    "hyteg_p2_const_apply_bf16": [_P, _P, _P, _I, _I, _I, _P, _P],
    # src, W, dst (all bf16), C, M, dirs, stream (2D)
    "hyteg_p2_const_apply_2d_bf16": [_P, _P, _P, _I, _I, _P, _P],
    # u, w, y, X, Y, Z, bf16, stream
    "hyteg_box_apply": [_P, _P, _P, _I, _I, _I, _I, _P],
    # src, dst, n, stream
    "hyteg_stream_scale": [_P, _P, ctypes.c_longlong, _P],
    # u, W, xf, yf, zf, df, dst, xfo, yfo, zfo, dfo, Cp, N, P, dirs,
    # tail_a, tail_b, stream
    "hyteg_pair_apply": [_P] * 11 + [_I, _I, _I, _P, _I, _I, _P],
    # u, xf, yf, zf, df, out, Cp, N, P, stream
    "hyteg_pair_install": [_P] * 6 + [_I, _I, _I, _P],
    # u, xfo, yfo, zfo, dfo, Cp, N, P, stream
    "hyteg_pair_extract": [_P] * 5 + [_I, _I, _I, _P],
    # src, coeff, elmats, dst, C, N, pitch, mode, offs, margins, stream
    "hyteg_p1_apply": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # src, W, dst, C, M, pitch, dirs, stream
    "hyteg_p2_const_apply": [_P, _P, _P, _I, _I, _I, _P, _P],
    # u, w, y, X, L, Z, shift, n_taps, stream
    "hyteg_box_variant": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # u, w, y, C, N, pitch, dirs, n_taps, mask, stream
    "hyteg_tet_stripped": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _P],
}


def cuda_available() -> bool:
    """True when torch sees a CUDA device (the kernels need one)."""
    return torch.cuda.is_available()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"hyteg_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the library if it is missing. Returns (path, seconds spent
    compiling and linking (0.0 when it was there), nvcc's output:
    registers, shared memory and spills per kernel)."""
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = BUILD_DIR / f"obj.{os.getpid()}"
    objs.mkdir(exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{src.stem}.o"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for src in _sources() if src.suffix == ".cu"]
    logs = [(src, proc.communicate()[0], proc.returncode)
            for src, proc in jobs]
    failed = [f"{src.name} ({rc}):\n{log}" for src, log, rc in logs if rc]
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp),
             *[str(objs / f"{src.stem}.o") for src, _ in jobs]],
            capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr}")
    shutil.rmtree(objs, ignore_errors=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so, seconds, "".join(log for _, log, _ in logs)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def count_launch(wrapper, dim: int, level: int) -> None:
    """Add one launch to a kernel wrapper's counts: ``wrapper.launches``
    and ``wrapper.launches_by_level[level]`` for its 3D kernel,
    ``wrapper.launches_2d`` and ``wrapper.launches_by_level_2d[level]``
    for its 2D kernel."""
    suffix = "" if dim == 3 else "_2d"
    name = "launches" + suffix
    setattr(wrapper, name, getattr(wrapper, name) + 1)
    by_level = getattr(wrapper, "launches_by_level" + suffix)
    by_level[level] = by_level.get(level, 0) + 1


def count_bf16(wrapper, dim: int) -> None:
    """Add one bf16 launch to a kernel wrapper's counts, beside
    count_launch: ``wrapper.launches_bf16`` (3D) or
    ``wrapper.launches_2d_bf16``."""
    name = "launches_bf16" if dim == 3 else "launches_2d_bf16"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream
