"""Mixed precision in the PyTorch port: bf16 P1 spaces and stacks, the
bf16 forms of kernels B2 and B3 (their plain versions here; the kernels'
per-point math and walks compiled with the host C++ compiler, bf16
emulated), and f32 iterative refinement around a bf16 inner solve
(solvers/refinement.py); mirrors tests/test_mixed_precision.py.

Tolerances:
- bf16 results within one bf16 ulp of the f32 result of the same bf16
  inputs rounded to bf16: |d| <= 2^-7 |ref| + 1e-6 max|ref| elementwise
  (two roundings of f32 sums that differ in their last bits; the second
  term covers sums that cancel to near zero);
- against the JAX package's plain bf16 apply, which accumulates in bf16
  (ROADMAP C-ref11): |d| <= 16 * 2^-8 * (|A| |u|) elementwise, |A| |u| the
  apply of the absolute stencil weights to |u| (abs_apply);
- the two packages' bf16 stencil tables (ROADMAP C-ref12): within
  TABLE_ULPS = 2 bf16 ulps (2 * 2^-7) of each weight's sum of |terms|;
  their applies within (XLA_BOUND + 2 * 2^-7) |A||u|;
- iterative refinement: the JAX test's gates in both packages (rel <
  5e-5, < 0.1 x the bf16-only residual), the two solutions within 1e-3
  relative L2.
"""

import ctypes
import math
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import BoundaryCondition as JBC
from hyteg_tpu.core.types import DoFType as JDoF, FLAG_INNER as JINNER
from hyteg_tpu.functions.p1 import P1Space as JP1Space
from hyteg_tpu.kernels import p1_const_stencil as jk
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators import p1_elementwise as jop
from hyteg_tpu.primitives.storage import CellStorage as JCellStorage
from hyteg_tpu.solvers.refinement import iterative_refinement as j_refine
from hyteg_tpu.solvers.smoothers import jacobi_smooth as j_jacobi
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import (BoundaryCondition, DoFType,
                                        FLAG_INNER)
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.indexing import flat
from hyteg_tpu_torch.kernels import p1_const_stencil as tk
from hyteg_tpu_torch.kernels import p1_stencil as tk3
from hyteg_tpu_torch.mesh import meshinfo as mi
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.refinement import iterative_refinement
from hyteg_tpu_torch.solvers.smoothers import jacobi_smooth
from hyteg_tpu_torch.solvers.templates import make_p1_gmg

from tests.test_torch_const_stencil import FORMS, _setup, block_coords

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -7
CANCEL = 1e-6
XLA_BOUND = 16 * 2.0 ** -8
TABLE_ULPS = 2
bf16 = torch.bfloat16


def round_bf16(a) -> np.ndarray:
    """numpy f32 -> bf16 (round to nearest even) -> f32."""
    return torch.tensor(np.asarray(a, dtype=np.float32)).to(bf16).float().numpy()


def ulp_excess(got, ref) -> float:
    """max |got - ref| / (one bf16 ulp of ref + CANCEL * max|ref|)."""
    got = interop.block_to_numpy(got) if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, dtype=np.float32)
    tol = BF16_ULP * np.abs(ref) + CANCEL * np.abs(ref).max()
    return float((np.abs(got - ref) / tol).max())


def bf16_case(name, level, pitch, form, seed):
    """A bf16 source and bf16 weights A, E (rounded from f32 element
    matrices), as numpy f32 arrays holding bf16 values, with the tensors."""
    jsp, tsp, elm, x = _setup(name, level, pitch, form, seed)
    et = torch.tensor(elm)
    A = round_bf16(tk.stencil_weights(et, 3).numpy())
    E = round_bf16(tk.face_weights_full(et, 3).numpy())
    xb = round_bf16(x)
    return jsp, tsp, elm, xb, A, E


def abs_apply(u, A, E, level, pitch):
    """|A| |u|: the terms of the stencil apply (tk._combine's: the interior
    weights, the shell tails and the face corrections, each on its mask),
    every weight and read taken in absolute value and every term added."""
    dirs, _, n_j = tk.stencil_tables(3)
    groups = tk.face_tables_full(3)[0]
    K0, shells, faces = tk._mask_tensors(level, 3, pitch, torch.float32,
                                         torch.device("cpu"))
    reads = [flat.shift_read(u.abs(), tuple(int(v) for v in d), pitch, 3)
             for d in dirs]
    A, E = A.abs(), E.abs()
    w = lambda a: a.reshape(-1, 1, 1)
    out = K0 * sum(w(A[:, s].sum(-1)) * r for s, r in enumerate(reads))
    out = out + shells[0] * sum(w(A[:, s, 1]) * r for s, r in enumerate(reads))
    for g, G in enumerate(groups):
        sigma = faces[G[0]]
        for i in G[1:]:
            sigma = sigma * faces[i]
        e0 = sum(w(E[:, g, 0, s]) * r for s, r in enumerate(reads))
        e1 = sum(w(E[:, g, 1, s]) * r for s, r in enumerate(reads))
        out = out + sigma * (e0 + e1 * (1 + shells[0]))
    return out


CASES = [("tet", 3, None), ("cube1", 3, None), ("cube1", 3, 17),
         ("cube2", 2, 9)]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch", CASES)
def test_b2_plain_bf16_within_one_ulp_of_jax_f32(name, level, pitch, form):
    """The port's plain bf16 B2 against the JAX package's f32 apply of the
    same bf16-rounded source and weights, rounded to bf16."""
    jsp, tsp, _, xb, A, E = bf16_case(name, level, pitch, form, 60 + level)
    ref = np.asarray(jk.p1_const_apply_xla(jnp.asarray(xb), jnp.asarray(A),
                                           level, 3, jsp.pitch,
                                           E=jnp.asarray(E)))
    got = tk.p1_const_apply(torch.as_tensor(xb).to(bf16),
                            torch.as_tensor(A).to(bf16),
                            torch.as_tensor(E).to(bf16), level, 3, tsp.pitch)
    assert got.dtype == bf16
    assert ulp_excess(got, round_bf16(ref)) <= 1.0
    # f32 weights round to the source's type: the same result
    same = tk.p1_const_apply(torch.as_tensor(xb).to(bf16), torch.as_tensor(A),
                             torch.as_tensor(E), level, 3, tsp.pitch)
    assert torch.equal(same, got)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch", CASES[:3])
def test_bf16_plain_follows_kernel_not_xla(name, level, pitch, form):
    """The JAX package's plain P1 apply in bf16 (p1_const_apply_xla on a
    bf16 source) accumulates in bf16 (ROADMAP C-ref11, as C-ref5 for the
    box): it stays within 16 * 2^-8 of |A||u| of the port's f32-accumulated
    result, which is itself within one ulp of the exact one."""
    jsp, tsp, elm, xb, A, E = bf16_case(name, level, pitch, form, 70 + level)
    jxla = np.asarray(jk.p1_const_apply_xla(
        jnp.asarray(xb, dtype=jnp.bfloat16), jnp.asarray(A, jnp.bfloat16),
        level, 3, jsp.pitch, E=jnp.asarray(E, jnp.bfloat16)).astype(
            jnp.float32))
    port = tk.p1_const_apply(torch.as_tensor(xb).to(bf16),
                             torch.as_tensor(A).to(bf16),
                             torch.as_tensor(E).to(bf16), level, 3,
                             tsp.pitch).float().numpy()
    absA = abs_apply(torch.as_tensor(xb), torch.as_tensor(A),
                     torch.as_tensor(E), level, tsp.pitch).numpy()
    assert (np.abs(jxla - port) <= XLA_BOUND * absA).all()
    exact = np.asarray(jk.p1_const_apply_xla(jnp.asarray(xb), jnp.asarray(A),
                                             level, 3, jsp.pitch,
                                             E=jnp.asarray(E)))
    assert np.abs(jxla - exact).max() > np.abs(port - exact).max()


@pytest.mark.parametrize("lumped", [False, True])
@pytest.mark.parametrize("name,level,pitch", CASES)
def test_b3_plain_bf16_within_one_ulp_of_jax_f32(name, level, pitch, lumped):
    jsp, tsp, elm, *_ = bf16_case(name, level, pitch, "mass" if lumped
                                  else "laplace", 80 + level)
    eb = round_bf16(elm)
    fn = jop.p1_lumped_local if lumped else jop.p1_diagonal_local
    ref = np.asarray(fn(jnp.asarray(eb), level, 3, jsp.block_shape,
                        jsp.pitch))
    got = tk3.p1_diagonal_local(torch.as_tensor(eb).to(bf16), level, 3,
                                tsp.pitch, lumped)
    assert got.dtype == bf16
    assert ulp_excess(got, round_bf16(ref)) <= 1.0


# ---------------------------------------------------------------------------
# the kernels' per-point math and walks in bf16, compiled for the host
# ---------------------------------------------------------------------------

CSRC = pathlib.Path(tk.__file__).resolve().parent.parent / "csrc"
HOST_HARNESS = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define HYTEG_DEVICE inline
#include "p1_const_stencil.cuh"
#include "p1_diag.cuh"
using namespace hyteg;
// bf16 as the card stores it: the top 16 bits of an f32.
static float bf2f(uint16_t h) {
  uint32_t u = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// f32 -> bf16, round to nearest even (the card's __float2bfloat16_rn).
static uint16_t f2bf(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}
// The walks' source: widens each load (csrc/bf16.cuh's BF16Src).
struct HostBF16Src {
  const uint16_t* p;
  float operator[](int i) const { return bf2f(p[i]); }
  HostBF16Src operator+(long long k) const { return {p + k}; }
};
// The walks' store: rounds once (BF16CellStore), counting each write;
// quads at 8-byte boundaries as on the card.
struct HostBF16Store {
  uint16_t* dst;
  int* count;
  void operator()(int i, float v) const { dst[i] = f2bf(v); ++count[i]; }
  int to_aligned(int i) const {
    const unsigned half = (unsigned)(reinterpret_cast<uintptr_t>(dst + i) >> 1);
    return (int)((0u - half) & 3u);
  }
  void quad(int i, float a, float b, float c, float d) const {
    if (reinterpret_cast<uintptr_t>(dst + i) % 8) ++count[i];  // misaligned
    (*this)(i, a); (*this)(i + 1, b); (*this)(i + 2, c); (*this)(i + 3, d);
  }
};
// Kernel B2's bf16 thread blocks one after another: weights widened into
// f32 rows, then every thread of every (cell, plane x) block.
extern "C" void const_apply_bf16(const uint16_t* src, const uint16_t* A,
                                 const uint16_t* E, uint16_t* dst, int C,
                                 int N, int pitch, const int* dirs,
                                 const int* gmask, int* count) {
  ConstTables t;
  for (int s = 0; s < kConstDirs; ++s) {
    t.dx[s] = dirs[3 * s];
    t.dl[s] = dirs[3 * s + 1] * pitch + dirs[3 * s + 2];
  }
  for (int g = 0; g < kConstGroups; ++g) t.gmask[g] = gmask[g];
  constexpr int nA = kConstDirs * kConstShells;
  constexpr int nE = kConstGroups * kConstShells * kConstDirs;
  float a[nA], e[nE], rows[kConstRows * kConstDirs];
  const long long cell = (long long)N * N * pitch;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < nA; ++i) a[i] = bf2f(A[c * nA + i]);
    for (int i = 0; i < nE; ++i) e[i] = bf2f(E[c * nE + i]);
    const_fold_rows(a, e, t, rows, 0, 1);
    for (int x = 0; x < N; ++x)
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid)
        const_apply_plane(HostBF16Src{src + c * cell},
                          HostBF16Store{dst + c * cell, count + c * cell}, x,
                          N, pitch, t, rows, tid >> 5, tid & 31, kPlaneWarps);
  }
}
// Kernel B3's bf16 thread blocks (no coefficient).
extern "C" void diag_bf16(const uint16_t* elm, uint16_t* dst, int C, int N,
                          int pitch, int lumped, int* count) {
  constexpr int kElm = kClasses * kVerts * kVerts;
  float e[kElm], w[kClasses * kVerts], cls[kDiagRows];
  const long long cell = (long long)N * N * pitch;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < kElm; ++i) e[i] = bf2f(elm[c * kElm + i]);
    diag_fold_weights(e, lumped, w, 0, 1);
    diag_fold_classes(w, cls, 0, 1);
    for (int x = 0; x < N; ++x)
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid)
        diag_plane(HostBF16Store{dst + c * cell, count + c * cell}, x, N,
                   pitch, cls, tid >> 5, tid & 31, kPlaneWarps);
  }
}
extern "C" uint16_t round_bf16(float f) { return f2bf(f); }
"""


@pytest.fixture(scope="module")
def host_bf16():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    import tempfile

    d = pathlib.Path(tempfile.mkdtemp(prefix="host_bf16_"))
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_bf16.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.const_apply_bf16.argtypes = [P, P, P, P, I, I, I, P, P, P]
    lib.diag_bf16.argtypes = [P, P, I, I, I, I, P]
    lib.round_bf16.argtypes = [ctypes.c_float]
    lib.round_bf16.restype = ctypes.c_uint16
    return lib


def test_host_rounding_is_torch_rounding(host_bf16):
    """The harness's f32 -> bf16 rounding (round to nearest even, as the
    card's __float2bfloat16_rn) equals torch's on ties and specials."""
    vals = np.array([1.0, 1.00390625, 1.01171875, -3.3e-3, 65504.0, 1e-40,
                     3.4e38, np.inf, -np.inf, 0.0, -0.0, 1.0 + 2 ** -8,
                     1.0 + 3 * 2 ** -8], dtype=np.float32)
    rng = np.random.default_rng(0)
    vals = np.concatenate([vals, rng.standard_normal(2000).astype(np.float32)
                           * 10.0 ** rng.integers(-8, 8, 2000)])
    want = torch.as_tensor(vals).to(bf16).view(torch.int16).numpy().view(
        np.uint16)
    got = np.array([host_bf16.round_bf16(float(v)) for v in vals],
                   dtype=np.uint16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("pitch_of", ["gmg", "own"])
@pytest.mark.parametrize("level", [2, 3, 4, 5])
def test_host_b2_bf16_walk(host_bf16, level, pitch_of, form):
    """Kernel B2's bf16 walk (all thread blocks) on a bf16 operator's
    weights: every slot written once, the zero runs as 8-byte-aligned
    quads, 0 outside the tet and on padding lanes, and within one bf16
    ulp of the f32 apply of the same bf16 values and of the plain bf16
    version."""
    N = (1 << level) + 1
    pitch = 129 if pitch_of == "gmg" else N
    sp = P1Space(CellStorage(mi.mesh_unit_cube(1)), level, device="cpu",
                 dtype=bf16, pitch=pitch)
    op = P1ElementwiseOperator(sp, FORMS[form][1])
    A, E = op.stencil, op.stencil_face
    g = torch.Generator().manual_seed(level)
    src = (torch.randn(sp.block_shape, generator=g)
           * sp.vertex_mask_t.float()).to(bf16)
    dst = torch.full_like(src, float("nan"))
    count = torch.zeros(src.shape, dtype=torch.int32)
    dirs, gmask = tk._kernel_tables()
    host_bf16.const_apply_bf16(src.data_ptr(), A.data_ptr(), E.data_ptr(),
                               dst.data_ptr(), src.shape[0], N, pitch,
                               dirs.ctypes.data, gmask.ctypes.data,
                               count.data_ptr())
    assert (count == 1).all()
    assert (dst[:, ~sp.vertex_mask_t.bool()] == 0).all()
    exact = tk.p1_const_apply_torch(src.float(), A.float(), level, 3, pitch,
                                    E=E.float())
    assert ulp_excess(dst, exact.numpy()) <= 1.0
    ref = tk.p1_const_apply(src, A, E, level, 3, pitch)
    assert ulp_excess(dst, ref.float().numpy()) <= 1.0


@pytest.mark.parametrize("lumped", [False, True])
@pytest.mark.parametrize("level", [1, 3, 5])
def test_host_b3_bf16_walk(host_bf16, level, lumped):
    N = (1 << level) + 1
    pitch = 129
    rng = np.random.default_rng(90 + level)
    elm = torch.as_tensor(rng.standard_normal((2, 6, 4, 4)),
                          dtype=torch.float32).to(bf16)
    dst = torch.full((2, N, N * pitch), float("nan"), dtype=bf16)
    count = torch.zeros(dst.shape, dtype=torch.int32)
    host_bf16.diag_bf16(elm.data_ptr(), dst.data_ptr(), 2, N, pitch,
                        int(lumped), count.data_ptr())
    assert (count == 1).all()
    cx, cy, cz = block_coords(N, pitch)
    inside = torch.as_tensor((cz < N) & (cx + cy + cz <= N - 1))
    assert (dst[:, ~inside] == 0).all()
    exact = tk3.p1_diagonal_local_torch(elm.float(), level, 3, pitch, lumped)
    assert ulp_excess(dst, exact.numpy()) <= 1.0
    ref = tk3.p1_diagonal_local_torch(elm, level, 3, pitch, lumped)
    assert ulp_excess(dst, ref.float().numpy()) <= 1.0


# ---------------------------------------------------------------------------
# bf16 spaces, stacks and iterative refinement
# ---------------------------------------------------------------------------


def test_bf16_space_basic_ops():
    """tests/test_mixed_precision.py's case in the port, against the JAX
    package's bf16 space."""
    st = CellStorage(mi.mesh_unit_cube(1))
    sp = P1Space(st, 2, device="cpu", dtype=bf16)
    sd = sp.resolve_sd(BoundaryCondition.all_dirichlet())
    u = sp.interpolate(lambda p: p[..., 0], sp.zeros(), DoFType.ALL, sd)
    assert u.dtype == bf16
    s = float(sp.dof_sum(u, DoFType.ALL, sd))
    jsp = JP1Space(JCellStorage(jmi.mesh_unit_cube(1), num_shards=1), 2,
                   dtype=jnp.bfloat16)
    jsd = jsp.resolve_sd(JBC.all_dirichlet())
    ju = jsp.interpolate(lambda p: p[..., 0], jsp.zeros(), JDoF.ALL, jsd)
    js = float(jsp.dof_sum(ju, JDoF.ALL, jsd))
    assert np.isfinite(s) and s > 0 and abs(s - js) <= 2 * BF16_ULP * js
    assert ulp_excess(u, np.asarray(ju.astype(jnp.float32))) <= 1.0
    v = sp.exchange_add(u, sd)
    assert v.dtype == bf16
    assert ulp_excess(v, np.asarray(jsp.exchange_add(ju, jsd).astype(
        jnp.float32))) <= 1.0


def test_bf16_operator_tables():
    """A bf16 operator's element matrices and stencil weights are its f32
    operator's rounded once; its apply and diagonals are bf16."""
    st = CellStorage(mi.mesh_unit_cube(1))
    sp32 = P1Space(st, 3, device="cpu")
    sp16 = P1Space(st, 3, device="cpu", dtype=bf16)
    o32 = P1ElementwiseOperator(sp32, forms.laplace_form)
    o16 = P1ElementwiseOperator(sp16, forms.laplace_form)
    for name in ("elmats", "stencil", "stencil_face"):
        a, b = getattr(o16, name), getattr(o32, name)
        assert a.dtype == bf16 and torch.equal(a, b.to(bf16))
    x = sp16.exchange_rep(torch.randn(sp16.block_shape,
                                      generator=torch.Generator()
                                      .manual_seed(1)).to(bf16)
                          * sp16.vertex_mask_t)
    y = o16.apply_raw(x)
    assert y.dtype == bf16
    assert o16.inverse_diagonal().dtype == bf16
    assert o16.lumped_inverse_diagonal().dtype == bf16


def abs_terms(elmats):
    """sum |terms| of every stencil weight A and face weight E: the
    scatter-adds of stencil_weights / face_weights_full on |elmats|, each
    signed entry taken in absolute value."""
    ea = elmats.abs()
    groups, rows, cols, _, n_j = tk.face_tables_full(3)
    C = ea.shape[0]
    E = torch.zeros(C, len(groups) * n_j * 15).index_add_(
        1, torch.as_tensor(cols), ea.reshape(C, -1)[:, rows])
    return tk.stencil_weights(ea, 3), E.reshape(C, len(groups), n_j, 15)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("level", [2, 3])
def test_bf16_operator_tables_vs_jax(level, form):
    """Both packages' bf16 operators on one mesh (ROADMAP C-ref12): the
    JAX package rounds the element matrices to bf16 and sums the stencil
    weights in bf16, the port sums in f32 and rounds once. Element
    matrices: equal. A and E: within TABLE_ULPS bf16 ulps of their sum of
    |terms| (2^-7 each; 0.63 read on this mesh). The applies of a bf16
    source: within (XLA_BOUND + TABLE_ULPS 2^-7) |A||u| = 20 2^-8 |A||u|,
    the JAX apply's bf16 accumulation (C-ref11) plus the tables' gap (6.9
    2^-8 |A||u| read)."""
    jf, tf = FORMS[form]
    jsp = JP1Space(JCellStorage(jmi.mesh_unit_cube(1), num_shards=1), level,
                   dtype=jnp.bfloat16)
    jo = jop.P1ElementwiseOperator(jsp, jf)
    st = CellStorage(mi.mesh_unit_cube(1))
    sp16 = P1Space(st, level, device="cpu", dtype=bf16)
    o16 = P1ElementwiseOperator(sp16, tf)
    o32 = P1ElementwiseOperator(P1Space(st, level, device="cpu"), tf)
    A_abs, E_abs = abs_terms(o32.elmats)
    j = lambda a: torch.tensor(np.asarray(a.astype(jnp.float32)))
    assert torch.equal(j(jo.elmats), o16.elmats.float())
    for name, terms in (("stencil", A_abs), ("stencil_face", E_abs)):
        gap = (j(getattr(jo, name)) - getattr(o16, name).float()).abs()
        assert (gap <= TABLE_ULPS * BF16_ULP * terms).all(), name
    rng = np.random.default_rng(70 + level)
    xb = round_bf16(rng.standard_normal(jsp.block_shape)
                    * jsp.vertex_mask[None])
    ref = np.asarray(jo.apply_raw(jnp.asarray(xb, dtype=jnp.bfloat16))
                     .astype(jnp.float32))
    x = torch.as_tensor(xb).to(bf16)
    got = o16.apply_raw(x).float().numpy()
    bound = (XLA_BOUND + TABLE_ULPS * BF16_ULP) * abs_apply(
        x.float(), A_abs, E_abs, level, sp16.pitch).numpy()
    assert (np.abs(got - ref) <= bound).all()


def _problem_jax(level):
    storage = JCellStorage(jmi.mesh_unit_cube(1), num_shards=1)
    bc = JBC.all_dirichlet()
    sp32, sp16 = JP1Space(storage, level), JP1Space(storage, level,
                                                    dtype=jnp.bfloat16)
    sd32, sd16 = sp32.resolve_sd(bc), sp16.resolve_sd(bc)
    op32 = jop.P1ElementwiseOperator(sp32, jforms.laplace_form)
    op16 = jop.P1ElementwiseOperator(sp16, jforms.laplace_form)
    z32, z16 = sp32.zeros(), sp16.zeros()
    apply32 = lambda x: sp32.restore_rows(op32.apply_raw(x, sd=sd32), z32,
                                          JINNER, sd32)
    inv16 = sp16.restore_rows(op16.inverse_diagonal(sd=sd16), z16, JINNER,
                              sd16)
    ap16 = lambda x: sp16.restore_rows(op16.apply_raw(x, sd=sd16), z16,
                                       JINNER, sd16)
    inner16 = jax.jit(lambda r: j_jacobi(ap16, inv16, r, jnp.zeros_like(r),
                                         omega=0.66, num_sweeps=60))
    U = lambda p: (jnp.sin(jnp.pi * p[..., 0]) * jnp.sin(jnp.pi * p[..., 1])
                   * jnp.sin(jnp.pi * p[..., 2]))
    mass = jop.P1ElementwiseOperator(sp32, jforms.mass_form)
    f = sp32.interpolate(lambda p: 3 * jnp.pi ** 2 * U(p), sp32.zeros(),
                         JDoF.ALL, sd32)
    b = sp32.restore_rows(mass.apply_raw(f, sd=sd32), z32, JINNER, sd32)
    x = jax.jit(lambda: j_refine(apply32, inner16, b, z32, 30))()
    return np.asarray(b), np.asarray(x)


def _problem_port(level, b_np):
    storage = CellStorage(mi.mesh_unit_cube(1))
    bc = BoundaryCondition.all_dirichlet()
    sp32 = P1Space(storage, level, device="cpu")
    sp16 = P1Space(storage, level, device="cpu", dtype=bf16)
    sd32, sd16 = sp32.resolve_sd(bc), sp16.resolve_sd(bc)
    op32 = P1ElementwiseOperator(sp32, forms.laplace_form)
    op16 = P1ElementwiseOperator(sp16, forms.laplace_form)
    apply32 = lambda x: op32.apply_inner(x, sd32, FLAG_INNER)
    ap16 = lambda x: op16.apply_inner(x, sd16, FLAG_INNER)
    inv16 = sp16.restore_rows(op16.inverse_diagonal(sd=sd16),
                              sp16.zeros(), FLAG_INNER, sd16)
    inner16 = lambda r: jacobi_smooth(ap16, inv16, r, torch.zeros_like(r),
                                      omega=0.66, num_sweeps=60)
    b = interop.block_from_reference(b_np, device="cpu")
    x = iterative_refinement(apply32, inner16, b, sp32.zeros(), 30)
    rel = lambda v: float(torch.sqrt(sp32.dot(b - apply32(v), b - apply32(v),
                                              DoFType.ALL, sd32)
                                     / sp32.dot(b, b, DoFType.ALL, sd32)))
    b16, x16 = b.to(bf16), sp16.zeros()
    for _ in range(30):
        r16 = sp16.restore_rows(b16 - op16.apply_raw(x16, sd=sd16),
                                sp16.zeros(), FLAG_INNER, sd16)
        x16 = x16 + inner16(r16)
    return x, rel(x), rel(x16.float()), rel


def test_iterative_refinement_recovers_f32_accuracy_in_both():
    b, jx = _problem_jax(2)
    x, rel, rel16, rel_of = _problem_port(2, b)
    jrel = rel_of(interop.block_from_reference(jx, device="cpu"))
    for r in (rel, jrel):
        assert r < 5e-5 and r < 0.1 * rel16, (rel, jrel, rel16)
    diff = np.linalg.norm(interop.block_to_numpy(x) - jx)
    assert diff <= 1e-3 * np.linalg.norm(jx)


def test_refinement_around_a_bf16_vcycle():
    """mixed_precision's pattern at a CPU size: an f32 outer loop around
    one V(3,3) cycle of make_p1_gmg(dtype=bf16) (bf16 B2, B3, transfers
    and Chebyshev) reaches within 2x of the f32 stack's own plateau, and
    below 0.1x the bf16-only loop."""
    storage = CellStorage(mi.mesh_unit_cube(1))
    s32 = make_p1_gmg(storage, 0, 3, device="cpu")
    s16 = make_p1_gmg(storage, 0, 3, device="cpu", dtype=bf16)
    assert s16.space().dtype == bf16 and s16.inv_diags[3].dtype == bf16
    sp, sd = s32.space(), s32.sd()
    U = lambda p: (torch.sin(math.pi * p[..., 0]) * torch.sin(math.pi * p[..., 1])
                   * torch.sin(math.pi * p[..., 2]))
    bc = BoundaryCondition.all_dirichlet()
    mass = P1ElementwiseOperator(sp, forms.mass_form)
    f = sp.interpolate(lambda p: 3 * math.pi ** 2 * U(p), sp.zeros(),
                       DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), FLAG_INNER, bc)
    r0 = float(s32.residual_norm(sp.zeros(), b))
    x = sp.zeros()
    for _ in range(10):
        x = s32.gmg.cycle(x, b)
    plateau = float(s32.residual_norm(x, b)) / r0
    inner = lambda r: s16.gmg.cycle(s16.space().zeros(), r)
    apply_hi = lambda v: s32.operators[3].apply_inner(v, sd, FLAG_INNER)
    xr = iterative_refinement(apply_hi, inner, b, sp.zeros(), 10)
    rel = float(s32.residual_norm(xr, b)) / r0
    x16 = s16.space().zeros()
    b16 = b.to(bf16)
    for _ in range(10):
        x16 = x16 + inner(s16.residual(x16, b16))
    rel16 = float(s32.residual_norm(x16.float(), b)) / r0
    assert rel <= 2 * plateau and rel < 0.1 * rel16, (rel, plateau, rel16)
