"""ctypes loader for the native setup core, with numpy fallbacks (torch
counterpart of hyteg_tpu/native).

The shared library is compiled from setup_core.cpp with the host compiler
(``g++ -O3 -shared -fPIC -std=c++17``, or ``$CXX``) at first use, never at
import, into ``hyteg_tpu_torch/_build/`` (beside the CUDA kernels); each
process compiles into a file of its own and renames it into place, so
concurrent first uses do not collide. Without a compiler the numpy
fallbacks give the same results, more slowly (tests assert equality).
This is host set-up code: no device and no kernel is behind a fallback."""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "setup_core.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_LIB = os.path.join(_BUILD, "_setup_core.so")

_lib = None


def _build() -> bool:
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD, exist_ok=True)
        cxx = os.environ.get("CXX", "g++")
        subprocess.run(
            [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        if not _build():
            _lib = False
            return _lib
    try:
        lib = ctypes.CDLL(_LIB)
        lib.ht_morton_codes.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64)]
        lib.ht_argsort_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.ht_greedy_partition.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64)]
        lib.ht_sort_rows_i64.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64)]
        for fn in (lib.ht_morton_codes, lib.ht_argsort_u64,
                   lib.ht_greedy_partition, lib.ht_sort_rows_i64):
            fn.restype = None
        _lib = lib
    except Exception:
        _lib = False
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded (builds it on the
    first call)."""
    return bool(_load())


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def morton_codes(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Native Morton codes; falls back to numpy bit-interleaving."""
    p = np.ascontiguousarray(points, dtype=np.float64)
    n, dim = p.shape
    lib = _load()
    if lib:
        out = np.empty(n, dtype=np.uint64)
        lib.ht_morton_codes(_ptr(p, ctypes.c_double), n, dim, bits,
                            _ptr(out, ctypes.c_uint64))
        return out
    lo, hi = p.min(axis=0), p.max(axis=0)
    q = ((p - lo) / np.where(hi - lo == 0, 1.0, hi - lo)
         * ((1 << bits) - 1)).astype(np.uint64)
    codes = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        for d in range(dim):
            codes |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * dim + d)
    return codes


def argsort_u64(keys: np.ndarray) -> np.ndarray:
    k = np.ascontiguousarray(keys, dtype=np.uint64)
    lib = _load()
    if lib:
        out = np.empty(len(k), dtype=np.int64)
        lib.ht_argsort_u64(_ptr(k, ctypes.c_uint64), len(k),
                           _ptr(out, ctypes.c_int64))
        return out
    return np.argsort(k, kind="stable").astype(np.int64)


def greedy_partition(weights: np.ndarray, shards: int) -> np.ndarray:
    w = np.ascontiguousarray(weights, dtype=np.float64)
    lib = _load()
    if lib:
        out = np.empty(len(w), dtype=np.int64)
        lib.ht_greedy_partition(_ptr(w, ctypes.c_double), len(w), shards,
                                _ptr(out, ctypes.c_int64))
        return out
    from ..primitives.loadbalancing import partition_greedy

    return partition_greedy(shards, w)


def sort_rows_i64(rows: np.ndarray) -> np.ndarray:
    r = np.ascontiguousarray(rows, dtype=np.int64)
    n, k = r.shape
    lib = _load()
    if lib:
        out = np.empty_like(r)
        lib.ht_sort_rows_i64(_ptr(r, ctypes.c_int64), n, k,
                             _ptr(out, ctypes.c_int64))
        return out
    return np.sort(r, axis=1)
