"""The 2D arm of the PyTorch port's P2 path (macro-faces): the stencil and
face tables, the node-grid masks, element matrices, the general P2 apply
and diagonal, kernel B5's 2D form (plain version, and its CUDA thread
walk compiled with the host C++ compiler and run thread block by thread
block through a counting store), the quadratic transfers and
the P2 GMG stack, against the JAX package on identical numpy-seeded
inputs.

The JAX side runs as its own CPU tests run it: ``p2_const_apply_xla``
and the Pallas kernel in interpret mode on the reference's 2D case
``rect_l2`` (tests/test_p2_const_stencil.py:28), the dense assembly of
tests/test_p2.py:99-100, quadratic exactness of the prolongation
(tests/test_p2_transfer.py:24). The GMG stacks run in float64 (the JAX
package inside ``jax.enable_x64``) with the same eigenvalue bounds, so
their residual histories compare where float32 would sit at its floor.

Tolerances (f32 sums taken in another order): tables and masks exact;
element matrices 1e-6 of their largest entry; applies 1e-5 * max|y|
(19-term sums; 36-term sums in the general apply); diagonals 1e-6 *
max|d|; the dense assembly 2e-4 of max|A v| (the reference's own);
prolongation of a quadratic 5e-5 (the reference's own); transfers
against the JAX package and R = P^T 1e-6; GMG residual norms 1e-4
relative in float64.
"""

import ctypes
import functools
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.functions.p2 import P2Space as JP2Space
from hyteg_tpu.kernels import p2_const_stencil as jk
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import p2_elementwise as jop
from hyteg_tpu.operators import quadrature as jq
from hyteg_tpu.operators.p2_transfer import P2Transfer as JP2Transfer
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.solvers.templates import make_p2_gmg as jmake_p2_gmg
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.functions.p2 import P2Space
from hyteg_tpu_torch.kernels import p2_const_stencil as tk
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import p2_elementwise as top
from hyteg_tpu_torch.operators import quadrature as tq
from hyteg_tpu_torch.operators.p2_transfer import P2Transfer
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.templates import make_p2_gmg

from tests.test_p2 import (_assemble_p2_dense, _from_blocks,
                           _np_p2_stiffness, _to_blocks)
from tests.test_torch_const_stencil import CSRC

torch.set_num_threads(1)

T = functools.partial(interop.block_from_reference, device="cpu")
N_ = interop.block_to_numpy
KINDS = ("laplace", "mass")
MESHES = {"rect": lambda m: m.mesh_rectangle((0, 0), (1, 1), 2, 1),
          "square": lambda m: m.mesh_rectangle((0, 0), (1, 1), 1, 1),
          "annulus": lambda m: m.mesh_annulus(0.5, 1.0, 6, 1)}
CASES = [("rect", 2), ("rect", 1), ("annulus", 1)]


@functools.lru_cache(maxsize=None)
def _storages(name):
    return JStorage(MESHES[name](jmi)), CellStorage(MESHES[name](tmi))


@functools.lru_cache(maxsize=None)
def _spaces(name, level):
    js, ts = _storages(name)
    # a GMG stack passes a shared pitch; 2D spaces ignore it
    pitch = (2 << level) + 5
    return (JP2Space(js, level, pitch=pitch),
            P2Space(ts, level, device="cpu", pitch=pitch))


@functools.lru_cache(maxsize=None)
def _elmats(name, level, kind):
    jsp, _ = _spaces(name, level)
    return np.asarray(jop.compute_p2_elmats(jsp, kind))


def _block(jsp, seed, lo=None):
    rng = np.random.default_rng(seed)
    shape = jsp.block_shape
    v = rng.standard_normal(shape) if lo is None else rng.uniform(lo, lo + 1,
                                                                  shape)
    return (v * jsp.vertex_mask[None]).astype(np.float32)


def _close(got, ref, rtol, scale=None):
    got = N_(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    assert np.abs(got - ref).max() <= rtol * scale


# ---------------------------------------------------------------------------
# tables, masks, the space
# ---------------------------------------------------------------------------


def test_2d_rules_offsets_and_tables_match_jax():
    for degree in (2, 4):
        pts, w = tq.simplex_rule(2, degree)
        jpts, jw = jq.simplex_rule(2, degree)
        np.testing.assert_allclose(pts, jpts, atol=1e-12)
        np.testing.assert_allclose(w, jw, atol=1e-12)
        np.testing.assert_allclose(tq.p2_grads_at(2, pts),
                                   jq.p2_grads_at(2, pts), atol=1e-12)
        np.testing.assert_allclose(tq.p2_basis_at(2, pts),
                                   jq.p2_basis_at(2, pts), atol=1e-12)
    np.testing.assert_array_equal(top.p2_node_offsets(2),
                                  jop.p2_node_offsets(2))
    tables, jtables = tk.p2_stencil_tables(2), jk.p2_stencil_tables(2)
    for a, b in zip(tables, jtables):
        np.testing.assert_array_equal(a, b)
    dirs, _, _, n_par, n_j = tables
    assert dirs.shape == (19, 2) and (n_par, n_j) == (4, 3)
    groups, *arrays = tk.p2_face_tables(2)
    jgroups, *jarrays = jk.p2_face_tables(2)
    assert groups == jgroups == ((0,), (1,), (0, 1))
    for a, b in zip(arrays, jarrays):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tk._nz_tables(2), jk._nz_tables(2)):
        np.testing.assert_array_equal(a, b)
    assert tk.n_rows(2) == 48 and tk.n_rows(3) == 192


@pytest.mark.parametrize("level", [1, 2, 3])
def test_2d_node_masks_match_jax(level):
    M = (2 << level) + 1
    for a, b in zip(tk._mask_arrays_p2(level, 2, M),
                    jk._mask_arrays_p2(level, 2, M)):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,level", CASES)
def test_2d_p2_space_matches_jax(name, level):
    jsp, tsp = _spaces(name, level)
    assert tsp.block_shape == jsp.block_shape == (tsp.node_space.C_loc,
                                                  tsp.M, tsp.M)
    assert tsp.num_global_dofs() == jsp.num_global_dofs()
    assert np.array_equal(tsp.vertexdof_mask, jsp.vertexdof_mask)
    assert np.array_equal(tsp.edgedof_mask, jsp.edgedof_mask)
    for par in ((1, 0), (0, 1), (1, 1)):
        assert np.array_equal(tsp.edgedof_orientation_mask(par),
                              jsp.edgedof_orientation_mask(par))
    u = _block(jsp, 1)
    _close(tsp.vertexdof_view(T(u)), jsp.vertexdof_view(jnp.asarray(u)),
           0.0, 1.0)


# ---------------------------------------------------------------------------
# element matrices, the general apply and the diagonal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level", CASES)
def test_2d_p2_elmats_match_jax(name, level, kind):
    _, tsp = _spaces(name, level)
    elm = _elmats(name, level, kind)
    got = top.compute_p2_elmats(tsp, kind)
    assert tuple(got.shape) == elm.shape == (tsp.node_space.C_loc, 2, 6, 6)
    _close(got, elm, 1e-6)


@pytest.mark.parametrize("coeff", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level", CASES)
def test_2d_p2_apply_and_diagonal_match_jax(name, level, kind, coeff):
    jsp, tsp = _spaces(name, level)
    elm = _elmats(name, level, kind)
    x = _block(jsp, 2)
    k = _block(jsp, 3, lo=0.5) if coeff else None
    jkk = None if k is None else jnp.asarray(k)
    tkk = None if k is None else T(k)
    et = interop.elmats_from_reference(elm, device="cpu")
    ref = jop.p2_apply_local(jnp.asarray(x), jnp.asarray(elm), level, 2,
                             jsp.pitch, jkk)
    got = top.p2_apply_local(T(x), et, level, 2, tsp.pitch, tkk)
    _close(got, ref, 1e-5)
    ref = jop.p2_diagonal_local(jnp.asarray(elm), level, 2, jsp.block_shape,
                                jsp.pitch, jkk)
    got = top.p2_diagonal_local(et, level, 2, tsp.block_shape, tsp.pitch, tkk)
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level", CASES)
def test_2d_p2_operator_matches_jax(name, level, kind):
    jsp, tsp = _spaces(name, level)
    elm = _elmats(name, level, kind)
    jo = jop.P2ElementwiseOperator(jsp, kind, elmats=jnp.asarray(elm))
    to = top.P2ElementwiseOperator(tsp, kind, elmats=interop.elmats_from_reference(
        elm, device="cpu"))
    assert tuple(to.stencil_folded.shape) == (tsp.node_space.C_loc, 48, 19)
    x = _block(jsp, 4)
    _close(to.apply_raw(T(x)), jo.apply_raw(jnp.asarray(x)), 1e-5)
    _close(to.inverse_diagonal(), jo.inverse_diagonal(), 1e-6)


@pytest.mark.parametrize("name,level", [("rect", 1), ("square", 2)])
def test_2d_p2_laplace_matches_dense(name, level):
    """tests/test_p2.py:99-100: the port's apply against an independent
    numpy assembly over every micro-triangle (global ids from the JAX
    space, whose layout the port shares)."""
    jsp, _ = _spaces(name, level)
    _, ts = _storages(name)
    op = top.P2ElementwiseOperator(P2Space(ts, level, device="cpu"),
                                   "laplace")
    A = _assemble_p2_dense(_storages(name)[0], jsp, _np_p2_stiffness)
    v = np.random.default_rng(0).standard_normal(jsp.num_global_dofs())
    got = _from_blocks(jsp, N_(op.apply_raw(T(np.asarray(_to_blocks(jsp,
                                                                    v))))))
    scale = np.abs(A @ v).max()
    assert np.allclose(got, A @ v, atol=2e-4 * max(scale, 1.0))


# ---------------------------------------------------------------------------
# kernel B5-2D (plain version)
# ---------------------------------------------------------------------------


def _b5_inputs(name, level, kind, seed):
    jsp, tsp = _spaces(name, level)
    elm = _elmats(name, level, kind)
    x = _block(jsp, seed)
    jA, jE = jk.p2_stencil_weights(jnp.asarray(elm), 2), jk.p2_face_weights(
        jnp.asarray(elm), 2)
    et = interop.elmats_from_reference(elm, device="cpu")
    W = tk.p2_folded_weights(tk.p2_stencil_weights(et, 2),
                             tk.p2_face_weights(et, 2))
    return jsp, tsp, elm, x, jA, jE, W


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level", CASES)
def test_plain_b5_2d_matches_xla(name, level, kind):
    jsp, tsp, elm, x, jA, jE, W = _b5_inputs(name, level, kind, level)
    ref = np.asarray(jk.p2_const_apply_xla(jnp.asarray(x), jA, jE, level, 2,
                                           jsp.pitch))
    got = tk.p2_const_apply(T(x), W, level, tsp.pitch, 2)
    _close(got, ref, 1e-5)
    assert not N_(got)[:, ~tsp.vertex_mask].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level", [("rect", 2), ("annulus", 1)])
def test_plain_b5_2d_matches_pallas_interpret(name, level, kind):
    jsp, tsp, elm, x, jA, jE, W = _b5_inputs(name, level, kind, 10 + level)
    ref = np.asarray(jk.p2_const_apply_pallas(jnp.asarray(x), jA, jE, level,
                                              2, jsp.pitch, interpret=True))
    _close(tk.p2_const_apply_torch(T(x), W, level, tsp.pitch, 2), ref, 1e-5)


def test_2d_p2_wrapper_rejects_non_cpu_non_cuda_tensors():
    _, tsp = _spaces("rect", 1)
    et = interop.elmats_from_reference(_elmats("rect", 1, "laplace"),
                                       device="cpu")
    W = tk.p2_folded_weights(tk.p2_stencil_weights(et, 2),
                             tk.p2_face_weights(et, 2)).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.p2_const_apply(torch.empty(tsp.block_shape, device="meta"), W, 1,
                          tsp.pitch, 2)


HOST_HARNESS = r"""
#include <cmath>
#include <cstdint>
// Every pair load must start at an 8-byte boundary and overlap the face
// it serves (a window may start one element before the face only where
// the face does not start at an 8-byte boundary).
static const float* g_face_lo;
static const float* g_face_hi;
static long long g_bad_loads;
static void check_pair_load(const float* q) {
  if ((reinterpret_cast<uintptr_t>(q) & 7) != 0 || q + 1 < g_face_lo ||
      q >= g_face_hi)
    ++g_bad_loads;
}
#define HYTEG_PAIR_LOAD_HOOK(q) check_pair_load(q)
#define HYTEG_DEVICE inline
#include "p2_const_stencil.cuh"
using namespace hyteg;
// Counts each slot's writes beside the store, and pair stores that do not
// start at an 8-byte boundary.
struct CountStore {
  CellStore cell;
  int* count;
  void operator()(int i, float v) const { cell(i, v); ++count[i]; }
  int to_aligned(int i) const { return cell.to_aligned(i); }
  void pair(int i, float a, float b) const {
    if ((reinterpret_cast<uintptr_t>(cell.dst + i) & 7) != 0) ++g_bad_loads;
    cell.pair(i, a, b);
    ++count[i];
    ++count[i + 1];
  }
  void quad(int i, float a, float b, float c, float d) const {
    cell.quad(i, a, b, c, d);
    for (int k = 0; k < 4; ++k) ++count[i + k];
  }
};
// Kernel B5's 2D thread blocks one after another: per face and band of
// kBandRows2D rows, every thread (warp, lane) of the block through the
// same walk (p2_const_apply_band_2d) on the face's 48 rows. count: null,
// or one int per slot of the block. Returns the number of pair loads and
// pair stores that broke their rule (check_pair_load, CountStore::pair).
extern "C" long long p2_apply_2d(const float* src, const float* W, float* dst,
                                 int C, int M, int* count) {
  const long long face = (long long)M * M;
  g_bad_loads = 0;
  for (int c = 0; c < C; ++c) {
    const float* Wc = W + (long long)c * kP2Rows2D * kP2Dirs2D;
    g_face_lo = src + c * face;
    g_face_hi = g_face_lo + face;
    for (int x0 = 0; x0 < M; x0 += kBandRows2D)
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid) {
        if (count)
          p2_const_apply_band_2d(src + c * face, Wc,
                                 CountStore{CellStore{dst + c * face},
                                            count + c * face},
                                 x0, M, tid >> 5, tid & 31);
        else
          p2_const_apply_band_2d(src + c * face, Wc,
                                 CellStore{dst + c * face}, x0, M, tid >> 5,
                                 tid & 31);
      }
  }
  return g_bad_loads;
}
// The compile-time tables: kP2DirList2D (19 x 2), kP2NTaps2D (4) and
// kP2TapList2D (4 x 19).
extern "C" void p2_tap_tables_2d(int* dirs, int* ntaps, int* taps) {
  for (int s = 0; s < kP2Dirs2D; ++s)
    for (int d = 0; d < 2; ++d) dirs[2 * s + d] = kP2DirList2D[s][d];
  for (int p = 0; p < 4; ++p) {
    ntaps[p] = kP2NTaps2D[p];
    for (int i = 0; i < kP2Dirs2D; ++i)
      taps[p * kP2Dirs2D + i] = kP2TapList2D[p][i];
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_p2_2d")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_p2_2d.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.p2_apply_2d.argtypes = [P, P, P, I, I, P]
    lib.p2_apply_2d.restype = ctypes.c_longlong
    lib.p2_tap_tables_2d.argtypes = [P, P, P]
    return lib


def _host_weights(tsp, kind):
    et = top.compute_p2_elmats(tsp, kind)
    return tk.p2_folded_weights(tk.p2_stencil_weights(et, 2),
                                tk.p2_face_weights(et, 2)).contiguous()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level", CASES + [("rect", 3)])
def test_kernel_2d_point_math_matches_plain(host_kernel, name, level, kind):
    _, tsp = _spaces(name, level)
    W = _host_weights(tsp, kind)
    xt = T(_block(_spaces(name, level)[0], 20 + level))
    ref = tk.p2_const_apply_torch(xt, W, level, tsp.pitch, 2)
    out = torch.full_like(xt, float("nan"))
    assert host_kernel.p2_apply_2d(xt.data_ptr(), W.data_ptr(),
                                   out.data_ptr(), xt.shape[0], tsp.M,
                                   None) == 0
    _close(out, ref, 1e-5)
    assert not out[:, ~tsp.vertex_mask_t.bool()].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["rect", "annulus"])
@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_kernel_2d_walk_writes_every_node_once(host_kernel, name, level,
                                               kind):
    """The 2D kernel's walk over its thread blocks (band of rows, face) at
    P2 levels 0-4 (M = 3 ... 33): every slot of the block is written
    exactly once, exactly 0 past the triangle whatever the source holds
    there, and each node as the plain version computes it, to 1e-5 of
    max|y| (the operator's own weights, the source random everywhere);
    every pair load and pair store at an 8-byte boundary, every pair load
    overlapping its face (faces start at both parities here: M^2 is odd)."""
    _, tsp = _spaces(name, level)
    W = _host_weights(tsp, kind)
    rng = np.random.default_rng(30 + level)
    src = torch.as_tensor(
        rng.standard_normal(tsp.block_shape).astype(np.float32))
    ref = tk.p2_const_apply_torch(src, W, level, tsp.pitch, 2)
    dst = torch.full_like(src, float("nan"))
    count = torch.zeros(src.shape, dtype=torch.int32)
    assert host_kernel.p2_apply_2d(src.data_ptr(), W.data_ptr(),
                                   dst.data_ptr(), src.shape[0], tsp.M,
                                   count.data_ptr()) == 0
    assert (count == 1).all()
    inside = tsp.vertex_mask_t.bool()
    assert (dst[:, ~inside] == 0).all()
    assert (dst[:, inside] - ref[:, inside]).abs().max().item() <= (
        1e-5 * ref.abs().max().item())


def test_kernel_2d_tap_lists_match_jax_tables(host_kernel):
    """The 2D kernel's compile-time directions equal the JAX package's
    p2_stencil_tables(2), and each parity's tap list holds exactly the
    directions that its _nz_tables(2) marks structurally nonzero in some
    shell slot, in ascending order; no face correction adds one."""
    dirs = np.zeros((19, 2), dtype=np.int32)
    ntaps = np.zeros(4, dtype=np.int32)
    taps = np.zeros((4, 19), dtype=np.int32)
    host_kernel.p2_tap_tables_2d(dirs.ctypes.data, ntaps.ctypes.data,
                                 taps.ctypes.data)
    np.testing.assert_array_equal(dirs, jk.p2_stencil_tables(2)[0])
    np.testing.assert_array_equal(dirs, tk._kernel_dirs(2))
    nzm, nzf = jk._nz_tables(2)
    for par in range(4):
        want = np.nonzero(nzm[par].any(-1))[0]
        np.testing.assert_array_equal(taps[par, :ntaps[par]], want)
        assert not (nzf[:, par].any(-1).any(0) & ~nzm[par].any(-1)).any()


# ---------------------------------------------------------------------------
# quadratic transfers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _transfer_pair(name, clevel):
    js, ts = _storages(name)
    pitch = (4 << clevel) + 1
    return (JP2Transfer(JP2Space(js, clevel, pitch=pitch),
                        JP2Space(js, clevel + 1, pitch=pitch)),
            P2Transfer(P2Space(ts, clevel, device="cpu", pitch=pitch),
                       P2Space(ts, clevel + 1, device="cpu", pitch=pitch)))


@pytest.mark.parametrize("name,clevel", [("rect", 0), ("rect", 1),
                                         ("annulus", 0)])
def test_2d_p2_prolongation_exact_on_quadratics(name, clevel):
    """tests/test_p2_transfer.py:24: a quadratic interpolated on the coarse
    level prolongates to its interpolant on the fine level."""
    _, ttr = _transfer_pair(name, clevel)
    Q = lambda p: (1.0 + 2 * p[..., 0] - p[..., 1] + 0.5 * p[..., 0] * p[..., 1]
                   + p[..., 0] ** 2 - 0.3 * p[..., 1] ** 2)
    uc = ttr.coarse.function().interpolate(Q)
    uf = ttr.fine.function().interpolate(Q)
    err = (ttr.prolongate(uc.cells) - uf.cells).abs().max().item()
    assert err < 5e-5, err


@pytest.mark.parametrize("name,clevel", [("rect", 0), ("rect", 1),
                                         ("annulus", 0)])
def test_2d_p2_transfers_match_jax(name, clevel):
    jtr, ttr = _transfer_pair(name, clevel)
    uc = _block(jtr.coarse, clevel)
    _close(ttr.prolongate(T(uc)), jtr.prolongate_local(jnp.asarray(uc)), 1e-6)
    rf = _block(jtr.fine, clevel + 1)
    _close(ttr.restrict(T(rf)), jtr.restrict(jnp.asarray(rf)), 1e-6)


def test_2d_p2_restriction_is_transpose():
    jtr, ttr = _transfer_pair("rect", 0)
    cs, fs = jtr.coarse, jtr.fine
    nc, nf = cs.num_global_dofs(), fs.num_global_dofs()
    P = np.stack([_from_blocks(fs, N_(ttr.prolongate(T(np.asarray(
        _to_blocks(cs, e)))))) for e in np.eye(nc)], axis=1)
    R = np.stack([_from_blocks(cs, N_(ttr.restrict(T(np.asarray(
        _to_blocks(fs, e)))))) for e in np.eye(nf)], axis=1)
    assert np.abs(R - P.T).max() <= 1e-6 * np.abs(P).max()


# ---------------------------------------------------------------------------
# the 2D P2 GMG stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gmg_histories():
    """make_p2_gmg(rect, 0, 2) in both packages in float64 with the port's
    eigenvalue bounds; residual norms from 0 on a seeded rhs made
    consistent across interface replicas (C-ref7)."""
    js, ts = _storages("rect")
    stack = make_p2_gmg(ts, 0, 2, coarse_iters=60, dtype=torch.float64,
                        device="cpu")
    sp = stack.space()
    g = torch.Generator().manual_seed(0)
    b = torch.randn(sp.block_shape, generator=g, dtype=torch.float64)
    b = stack.residual(torch.zeros_like(b), sp.exchange_rep(
        b * sp.vertex_mask_t.to(torch.float64)))
    x = torch.zeros_like(b)
    norms = [float(stack.residual_norm(x, b))]
    for _ in range(4):
        x = stack.gmg.cycle(x, b)
        norms.append(float(stack.residual_norm(x, b)))
    with jax.enable_x64(True):
        jstack = jmake_p2_gmg(js, 0, 2, coarse_iters=60,
                              eigs=dict(stack.eigs), dtype=jnp.float64)
        cycle = jax.jit(jstack.gmg.cycle)
        jb = jnp.asarray(b.numpy())
        jx = jnp.zeros_like(jb)
        jnorms = [float(jstack.residual_norm(jx, jb))]
        for _ in range(4):
            jx = cycle(jx, jb)
            jnorms.append(float(jstack.residual_norm(jx, jb)))
    return norms, jnorms


def test_2d_p2_gmg_matches_jax(gmg_histories):
    norms, jnorms = gmg_histories
    for r, jr in zip(norms, jnorms):
        assert abs(r - jr) <= 1e-4 * jr, (norms, jnorms)


def test_2d_p2_gmg_converges(gmg_histories):
    norms, _ = gmg_histories
    assert norms[-1] < 1e-6 * norms[0], norms
    assert all(b < a for a, b in zip(norms, norms[1:])), norms
