"""Kernel B4 of the PyTorch port, the general elementwise P1 apply with a
nodal coefficient, in its plain version, and the variable-coefficient
operator built on it, against the JAX package on identical inputs.

The JAX side runs ``p1_apply_local`` in both of its forms: the default
``lax.scan`` over classes with cyclic rolls, and ``unroll=True``, the
zero-filled shifts that ``p1_apply_local_torch`` ports. The CUDA kernel's
per-point function and its plane walk (csrc/p1_apply.cuh) are compiled
with the host C++ compiler and held against the plain version.

Tolerance: 1e-5 * max|y| (f32 sums of 96 terms, and the coefficient
means, taken in another order).
"""

import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators import p1_elementwise as jop
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.kernels import p1_const_stencil as tk2
from hyteg_tpu_torch.kernels import p1_stencil as tk
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import forms as tforms
from hyteg_tpu_torch.operators.averaging import MODES
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage

from tests.test_torch_const_stencil import (CSRC, FORMS, _assert_close, _mesh,
                                          block_coords)

torch.set_num_threads(1)

CASES = [("tet", 2, None), ("cube1", 2, 9), ("cube1", 3, None)]


@functools.lru_cache(maxsize=None)
def _spaces(name, level, pitch):
    return (JSpace(JStorage(_mesh(jmi, name)), level, pitch=pitch),
            P1Space(CellStorage(_mesh(tmi, name)), level, device="cpu",
                    pitch=pitch))


def _setup(name, level, pitch, form="laplace", seed=0):
    """Spaces, element matrices, a random block and a coefficient
    k = 1 + x + 0.5 y (the JAX package's tests/test_operator.py) times a
    seeded random factor in [0.5, 1.5), both masked to the tet."""
    jsp, tsp = _spaces(name, level, pitch)
    elm = np.asarray(jop.compute_elmats(
        jsp, FORMS[form][0], jnp.asarray(jsp.cell_vertices(0))))
    rng = np.random.default_rng(seed)
    mask = jsp.vertex_mask[None]
    x = (rng.standard_normal(jsp.block_shape) * mask).astype(np.float32)
    p = np.asarray(jsp.coords(0))
    k = (1.0 + p[..., 0] + 0.5 * p[..., 1]) * rng.uniform(0.5, 1.5,
                                                           jsp.block_shape)
    return jsp, tsp, elm, x, (k * mask).astype(np.float32)


@pytest.mark.parametrize("mode", (None,) + MODES)
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch", CASES)
def test_plain_apply_matches_jax(name, level, pitch, form, mode):
    jsp, tsp, elm, x, k = _setup(name, level, pitch, form, seed=level)
    co = None if mode is None else k
    jc = None if co is None else jnp.asarray(co)
    got = tk.p1_apply_local(
        interop.block_from_reference(x, device="cpu"),
        interop.elmats_from_reference(elm, device="cpu"),
        level, 3, tsp.pitch,
        None if co is None else interop.block_from_reference(co, device="cpu"),
        mode or "arithmetic")
    for unroll in (False, True):
        ref = np.asarray(jop.p1_apply_local(
            jnp.asarray(x), jnp.asarray(elm), level, 3, jsp.pitch, jc,
            mode or "arithmetic", unroll=unroll))
        _assert_close(got, ref, np.abs(ref).max(), 1e-5)
    assert not got[:, ~tsp.vertex_mask_t.bool()].any()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,level,pitch", CASES)
def test_operator_with_coefficient_matches_jax(name, level, pitch, mode):
    jsp, tsp, elm, x, k = _setup(name, level, pitch, seed=10 + level)
    x = np.asarray(jsp.exchange_rep(jnp.asarray(x)))
    jo = jop.P1ElementwiseOperator(jsp, jforms.laplace_form,
                                   elmats=jnp.asarray(elm), coeff_avg=mode)
    to = P1ElementwiseOperator(tsp, tforms.laplace_form,
                               elmats=interop.elmats_from_reference(elm, device="cpu"),
                               coeff_avg=mode)
    kt = interop.block_from_reference(k, device="cpu")
    ref = np.asarray(jo.apply_raw(jnp.asarray(x), coeff=jnp.asarray(k)))
    _assert_close(to.apply_raw(interop.block_from_reference(x, device="cpu"),
                               coeff=kt),
                  ref, np.abs(ref).max(), 1e-5)
    ref = np.asarray(jo.inverse_diagonal(coeff=jnp.asarray(k)))
    _assert_close(to.inverse_diagonal(coeff=kt), ref, np.abs(ref).max(), 1e-6)


def test_unit_coefficient_equals_constant_stencil():
    """B4 with k = 1 is B2's operator (plain versions)."""
    jsp, tsp, elm, x, _ = _setup("cube1", 3, 17, seed=4)
    et = interop.elmats_from_reference(elm, device="cpu")
    xt = interop.block_from_reference(x, device="cpu")
    ones = tsp.vertex_mask_t.expand(tsp.block_shape).contiguous()
    got = tk.p1_apply_local(xt, et, 3, 3, tsp.pitch, ones)
    ref = tk2.p1_const_apply(xt, tk2.stencil_weights(et, 3),
                             tk2.face_weights_full(et, 3), 3, 3, tsp.pitch)
    _assert_close(got, ref, ref.abs().max().item(), 1e-5)


def test_wrapper_rejects_non_cpu_non_cuda_tensors():
    _, tsp, elm, _, _ = _setup("cube1", 2, None)
    et = interop.elmats_from_reference(elm, device="cpu").to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.p1_apply_local(torch.empty(tsp.block_shape, device="meta"), et, 2,
                          3, tsp.pitch)
    with pytest.raises(ValueError, match="averaging mode"):
        tk.p1_apply_local(torch.empty(tsp.block_shape, device="meta"), et, 2,
                          3, tsp.pitch, coeff_avg="median")


# ---------------------------------------------------------------------------
# the CUDA kernel's per-point math, compiled for the host
# ---------------------------------------------------------------------------

HOST_HARNESS = r"""
#include <cmath>
#define HYTEG_DEVICE inline
// transforms (0) and means finished (1) by coeff_term / coeff_finish
static long long coeff_work[2];
#define HYTEG_COEFF_HOOK(kind) (++coeff_work[kind])
#include "p1_apply.cuh"
using namespace hyteg;
// Runs the per-point function kernel B4 runs, one slot after another.
extern "C" void p1_apply(const float* src, const float* coeff,
                         const float* elmats, float* dst, int C, int N,
                         int pitch, int mode) {
  const int L = N * pitch;
  const long long cell = (long long)N * L;
  const int elm = kApplyClasses * kApplyVerts * kApplyVerts;
  for (int c = 0; c < C; ++c)
    for (long long q = 0; q < cell; ++q)
      dst[c * cell + q] = p1_apply_point(
          src + c * cell, coeff ? coeff + c * cell : nullptr, (int)(q / L),
          (int)(q % L), N, pitch, elmats + c * elm, mode);
}
// Counts each slot's writes beside the store.
struct CountStore {
  CellStore cell;
  int* count;
  void operator()(int i, float v) const { cell(i, v); ++count[i]; }
  int to_aligned(int i) const { return cell.to_aligned(i); }
  void quad(int i, float a, float b, float c, float d) const {
    cell.quad(i, a, b, c, d);
    for (int k = 0; k < 4; ++k) ++count[i + k];
  }
};
template <int MODE, class Out>
static void apply_block(const float* src, const float* coeff, const Out& out,
                        int x, int N, int pitch, const float* elm) {
  for (int tid = 0; tid < kApplyThreads; ++tid)
    apply_plane<MODE>(src, coeff, out, x, N, pitch, elm, tid >> 5, tid & 31,
                      kPlaneWarps);
}
template <class Out>
static void apply_mode(const float* src, const float* coeff, const Out& out,
                       int x, int N, int pitch, const float* elm, int mode) {
  if (!coeff)
    apply_block<-1>(src, coeff, out, x, N, pitch, elm);
  else if (mode == 0)
    apply_block<0>(src, coeff, out, x, N, pitch, elm);
  else if (mode == 1)
    apply_block<1>(src, coeff, out, x, N, pitch, elm);
  else
    apply_block<2>(src, coeff, out, x, N, pitch, elm);
}
// Kernel B4's launcher and thread blocks (cell, plane x) one after
// another: the table check, then every block through the walk. count:
// null, or one int per slot. work: null, or the transforms and means of
// the run. Returns the launcher's error (11, cudaErrorInvalidValue) for
// tables it refuses, else 0.
extern "C" int apply(const float* src, const float* coeff, const float* elm,
                     float* dst, int C, int N, int pitch, int mode,
                     const int* offs, const int* margins, int* count,
                     long long* work) {
  for (int t = 0; t < kClasses; ++t) {
    if (margins[t] != kDiagMargin[t]) return 11;
    for (int a = 0; a < kVerts; ++a)
      for (int d = 0; d < 3; ++d)
        if (offs[(t * kVerts + a) * 3 + d] != kDiagOff[t][a][d]) return 11;
  }
  const long long cell = (long long)N * N * pitch;
  const int ne = kClasses * kVerts * kVerts;
  coeff_work[0] = coeff_work[1] = 0;
  for (int c = 0; c < C; ++c) {
    const float* co = coeff ? coeff + c * cell : nullptr;
    for (int x = 0; x < N; ++x) {
      if (count)
        apply_mode(src + c * cell, co,
                   CountStore{CellStore{dst + c * cell}, count + c * cell}, x,
                   N, pitch, elm + c * ne, mode);
      else
        apply_mode(src + c * cell, co, CellStore{dst + c * cell}, x, N,
                   pitch, elm + c * ne, mode);
    }
  }
  if (work) {
    work[0] = coeff_work[0];
    work[1] = coeff_work[1];
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_p1_apply")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_p1_apply.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.p1_apply.argtypes = [P, P, P, P, I, I, I, I]
    lib.apply.argtypes = [P, P, P, P, I, I, I, I, P, P, P, P]
    return lib


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch", CASES + [("cube2", 2, 9)])
def test_kernel_point_math_matches_plain(host_kernel, name, level, pitch,
                                         form):
    _, tsp, elm, x, k = _setup(name, level, pitch, form, seed=20 + level)
    et = interop.elmats_from_reference(elm, device="cpu")
    xt = interop.block_from_reference(x, device="cpu")
    kt = interop.block_from_reference(k, device="cpu")
    for co, mode in [(None, "arithmetic")] + [(kt, m) for m in MODES]:
        ref = tk.p1_apply_local_torch(xt, et, level, 3, tsp.pitch, co, mode)
        out = torch.empty_like(xt)
        host_kernel.p1_apply(xt.data_ptr(),
                             None if co is None else co.data_ptr(),
                             et.data_ptr(), out.data_ptr(), xt.shape[0],
                             tsp.N, tsp.pitch, MODES.index(mode))
        _assert_close(out, ref, ref.abs().max().item(), 1e-5)


# ---------------------------------------------------------------------------
# kernel B4's plane walk, compiled for the host
# ---------------------------------------------------------------------------



def _walk_inputs(level, pitch, C, seed):
    """Random src and element matrices, the linear coefficient k = 1 + x +
    0.5 y (on the reference tet's coordinates) and a random one in [0.5,
    1.5), both 0 outside the tet and on padding lanes, and the mask of
    in-tet slots."""
    N = (1 << level) + 1
    n = N - 1
    rng = np.random.default_rng(seed)
    bx, by, bz = block_coords(N, pitch)
    inside = (bz < N) & (bx + by + bz <= n)
    src = torch.as_tensor(
        rng.standard_normal((C, N, N * pitch)).astype(np.float32))
    elm = torch.as_tensor(rng.standard_normal((C, 6, 4, 4)).astype(np.float32))
    lin = np.broadcast_to((1.0 + bx / n + 0.5 * by / n) * inside,
                          (C, N, N * pitch))
    rnd = rng.uniform(0.5, 1.5, (C, N, N * pitch)) * inside
    ks = {"linear": torch.as_tensor(lin.astype(np.float32)).contiguous(),
          "random": torch.as_tensor(rnd.astype(np.float32))}
    return N, src, elm, ks, torch.as_tensor(inside)


# None: no coefficient
WALK_MODES = (None,) + tuple(MODES)


def _host_walk(lib, src, co, elm, N, pitch, mode, tables=None, count=None,
               work=None):
    offs, margins = tables or tk._kernel_tables(3)
    out = torch.full_like(src, float("nan"))
    rc = lib.apply(src.data_ptr(), None if co is None else co.data_ptr(),
                   elm.data_ptr(), out.data_ptr(), src.shape[0], N, pitch,
                   MODES.index(mode or "arithmetic"), offs.ctypes.data,
                   margins.ctypes.data, None if count is None else count.data_ptr(),
                   None if work is None else work.ctypes.data)
    assert rc == 0
    return out


@pytest.mark.parametrize("mode", WALK_MODES)
@pytest.mark.parametrize("level,pitch_of", [(2, "own"), (2, "odd"),
                                            (3, "own"), (3, "odd"),
                                            (4, "own"), (4, "odd"),
                                            (6, "own")])
def test_kernel_walk_writes_every_slot_once(host_kernel, level, pitch_of,
                                            mode):
    """Kernel B4's walk over all its thread blocks (plane x, cell) through a
    counting store, at the level's own pitch N and at an odd pitch above
    it (level 6: rows longer than one chunk of 32 lanes), without a
    coefficient and in each mean, on a linear and a random coefficient:
    every slot written exactly once, exactly 0 outside the tet and on
    padding lanes, every slot equal to the plain version within 1e-5 *
    max|y|; and the same result, bit for bit, when src and the
    coefficient hold NaN outside the tet (neither is read there: no
    padding lane's 0 reaches a mean)."""
    N = (1 << level) + 1
    pitch = N if pitch_of == "own" else N + 2
    N, src, elm, ks, inside = _walk_inputs(level, pitch, 2, 300 + level)
    outside = ~inside.expand(src.shape)
    for kind in ("linear", "random") if mode is not None else (None,):
        co = None if kind is None else ks[kind]
        ref = tk.p1_apply_local_torch(src, elm, level, 3, pitch, co,
                                      mode or "arithmetic")
        count = torch.zeros(src.shape, dtype=torch.int32)
        out = _host_walk(host_kernel, src, co, elm, N, pitch, mode,
                         count=count)
        assert (count == 1).all()
        assert (out[outside] == 0).all()
        _assert_close(out, ref, ref.abs().max().item(), 1e-5)
        again = _host_walk(
            host_kernel, src.masked_fill(outside, float("nan")),
            None if co is None else co.masked_fill(outside, float("nan")),
            elm, N, pitch, mode)
        assert torch.equal(again, out)


@pytest.mark.parametrize("mode", WALK_MODES)
@pytest.mark.parametrize("level", [3, 4, 5])
def test_kernel_interior_sum_matches_point_math(host_kernel, level, mode):
    """The walk's untested interior sum against p1_apply_point, the tested
    per-point function, at every slot: within 2 ulps (the same terms in
    the same order), equal on the face and shell slots, which run
    p1_apply_point itself."""
    N = (1 << level) + 1
    pitch = N + 2
    N, src, elm, ks, inside = _walk_inputs(level, pitch, 2, 400 + level)
    co = None if mode is None else ks["random"]
    out = _host_walk(host_kernel, src, co, elm, N, pitch, mode)
    point = torch.empty_like(src)
    host_kernel.p1_apply(src.data_ptr(), None if co is None else co.data_ptr(),
                         elm.data_ptr(), point.data_ptr(), 2, N, pitch,
                         MODES.index(mode or "arithmetic"))
    a, b = out.numpy(), point.numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert (np.abs(a - b) <= 2 * ulp).all()
    bx, by, bz = block_coords(N, pitch)
    rim = inside.numpy() & ((bx == 0) | (by == 0) | (bz == 0)
                            | (bx + by + bz == N - 1))
    assert np.array_equal(a[:, rim], b[:, rim])


def test_kernel_launcher_refuses_other_tables(host_kernel):
    """The B4 launcher (mirrored by the host harness) takes the JAX
    package's micro.offsets(3) and micro.base_margin(3), the tables its
    walk was compiled with, and refuses any other."""
    from hyteg_tpu.indexing import micro as jmicro

    offs = np.ascontiguousarray(jmicro.offsets(3), dtype=np.int32)
    margins = np.ascontiguousarray(jmicro.base_margin(3), dtype=np.int32)
    N, src, elm, _, _ = _walk_inputs(1, 3, 1, 0)
    _host_walk(host_kernel, src, None, elm, N, 3, None, tables=(offs, margins))
    out = torch.empty_like(src)
    for o, m in ((offs[::-1].copy(), margins), (offs, margins + 1),
                 (offs[:, [1, 0, 2, 3]].copy(), margins)):
        assert host_kernel.apply(src.data_ptr(), None, elm.data_ptr(),
                                 out.data_ptr(), 1, N, 3, 0, o.ctypes.data,
                                 m.ctypes.data, None, None) == 11


def _work_per_slot(lib, level, mode):
    """Coefficient transforms and means finished per in-tet slot of one
    cell, at pitch N."""
    N = (1 << level) + 1
    N, src, elm, ks, inside = _walk_inputs(level, N, 1, 7)
    work = np.zeros(2, np.int64)
    _host_walk(lib, src, ks["random"], elm, N, N, mode, work=work)
    return work / int(inside.sum())


@pytest.mark.parametrize("mode", MODES)
def test_kernel_coeff_work_per_slot(host_kernel, mode):
    """The coefficient transforms and means finished per in-tet slot, on
    one cell at level 7 (the level chip_smoke.py times), in each mean: an
    interior slot transforms its 15 neighbours once each and finishes its
    24 means once each, a face or shell slot's tested gather fewer, so
    14.82 and 22.91 on average (the plane walk's thread-per-slot parent:
    15 and 24 at every in-tet slot)."""
    assert np.round(_work_per_slot(host_kernel, 7, mode), 2).tolist() \
        == [14.82, 22.91]
