"""The P2 path of the PyTorch port against the JAX package on identical
inputs: quadrature and bases, the P2 space's parity views, element
matrices, the general P2 apply (with and without a coefficient), kernel
B5's plain version (the parity-resolved constant stencil), and the diagonal
(tests/test_torch_p2_transfer.py and tests/test_torch_p2_gmg.py hold the
transfers and the GMG stack).

The JAX side runs as its own CPU tests run it: ``p2_const_apply_xla`` and
the Pallas kernel in interpret mode. Element matrices and blocks are
carried over through hyteg_tpu_torch.interop. The CUDA kernel's per-point
functions (csrc/p2_const_stencil.cuh) are compiled with the host C++
compiler and held against the plain version.

Tolerances (f32 sums taken in another order): rules and bases 1e-12
(float64 on both sides); element matrices 1e-6 of their largest entry;
applies 1e-5 * max|y| (65-term sums); diagonals 1e-6 * max|d|; masks and
tables exact.
"""

import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.functions.p2 import P2Space as JP2Space
from hyteg_tpu.kernels import p2_const_stencil as jk
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import p2_elementwise as jop
from hyteg_tpu.operators import quadrature as jq
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.functions.p2 import P2Space
from hyteg_tpu_torch.kernels import p2_const_stencil as tk
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import p2_elementwise as top
from hyteg_tpu_torch.operators import quadrature as tq
from hyteg_tpu_torch.primitives.storage import CellStorage

from tests.test_torch_const_stencil import CSRC, _assert_close, block_coords

torch.set_num_threads(1)

KINDS = ("laplace", "mass")


def _mesh(mod, name):
    return mod.mesh_single_tet() if name == "tet" else mod.mesh_unit_cube(
        int(name[-1]))


@functools.lru_cache(maxsize=None)
def _storages(name):
    return JStorage(_mesh(jmi, name)), CellStorage(_mesh(tmi, name))


@functools.lru_cache(maxsize=None)
def _spaces(name, level, pitch):
    js, ts = _storages(name)
    return (JP2Space(js, level, pitch=pitch),
            P2Space(ts, level, device="cpu", pitch=pitch))


@functools.lru_cache(maxsize=None)
def _elmats(name, level, pitch, kind):
    jsp, _ = _spaces(name, level, pitch)
    return np.asarray(jop.compute_p2_elmats(jsp, kind))


def _block(jsp, seed, lo=None):
    """A random block masked to the tet (uniform in [lo, lo + 1) when lo
    is given: a positive coefficient)."""
    rng = np.random.default_rng(seed)
    shape = jsp.block_shape
    v = rng.standard_normal(shape) if lo is None else rng.uniform(lo, lo + 1,
                                                                  shape)
    return (v * jsp.vertex_mask[None]).astype(np.float32)


# ---------------------------------------------------------------------------
# quadrature, bases, masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_quadrature_and_bases_match(degree):
    pts, w = tq.simplex_rule(3, degree)
    jpts, jw = jq.simplex_rule(3, degree)
    np.testing.assert_allclose(pts, jpts, atol=1e-12)
    np.testing.assert_allclose(w, jw, atol=1e-12)
    for ours, ref in ((tq.p1_offsets, jq.p1_offsets),
                      (tq.p2_offsets, jq.p2_offsets)):
        np.testing.assert_array_equal(ours(3), ref(3))
    for ours, ref in ((tq.p1_basis_at, jq.p1_basis_at),
                      (tq.p1_grads_at, jq.p1_grads_at),
                      (tq.p2_basis_at, jq.p2_basis_at),
                      (tq.p2_grads_at, jq.p2_grads_at)):
        np.testing.assert_allclose(ours(3, pts), ref(3, pts), atol=1e-12)


def test_node_offsets_and_stencil_tables_match():
    np.testing.assert_array_equal(top.p2_node_offsets(3),
                                  jop.p2_node_offsets(3))
    for a, b in zip(tk.p2_stencil_tables(3), jk.p2_stencil_tables(3)):
        np.testing.assert_array_equal(a, b)
    groups, *arrays = tk.p2_face_tables(3)
    jgroups, *jarrays = jk.p2_face_tables(3)
    assert groups == jgroups
    for a, b in zip(arrays, jarrays):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tk._nz_tables(3), jk._nz_tables(3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("level,pitch", [(1, None), (2, None), (2, 13)])
def test_masks_and_parity_views_match(level, pitch):
    jsp, tsp = _spaces("cube1", level, pitch)
    for a, b in zip(tk._mask_arrays_p2(level, 3, tsp.pitch),
                    jk._mask_arrays_p2(level, 3, jsp.pitch)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tsp.vertexdof_mask, jsp.vertexdof_mask)
    np.testing.assert_array_equal(tsp.edgedof_mask, jsp.edgedof_mask)
    for par in [(1, 0, 0), (0, 1, 1), (1, 1, 1)]:
        np.testing.assert_array_equal(tsp.edgedof_orientation_mask(par),
                                      jsp.edgedof_orientation_mask(par))
    x = _block(jsp, 1)
    ref = np.asarray(jsp.vertexdof_view(jnp.asarray(x)))
    np.testing.assert_array_equal(
        interop.block_to_numpy(tsp.vertexdof_view(torch.tensor(x))), ref)
    ref_e = np.asarray(jsp.embed_p1(jnp.asarray(ref)))
    got = tsp.embed_p1(torch.tensor(ref))
    _assert_close(got, ref_e, np.abs(ref_e).max(), 1e-6)


# ---------------------------------------------------------------------------
# element matrices and applies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", [1, 2])
def test_elmats_match(level, kind):
    _, tsp = _spaces("cube1", level, None)
    ref = _elmats("cube1", level, None, kind)
    got = top.compute_p2_elmats(tsp, kind)
    assert got.shape == (6, 6, 10, 10)
    _assert_close(got, ref, np.abs(ref).max(), 1e-6)


APPLY_CASES = [("cube1", 1, None), ("cube1", 2, None), ("cube1", 2, 13),
               ("tet", 2, None)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level,pitch", APPLY_CASES)
def test_general_apply_matches(name, level, pitch, kind):
    jsp, tsp = _spaces(name, level, pitch)
    elm = _elmats(name, level, pitch, kind)
    x, k = _block(jsp, level), _block(jsp, 7, lo=0.5)
    et = interop.elmats_from_reference(elm, device="cpu")
    for co in (None, k):
        ref = np.asarray(jop.p2_apply_local(
            jnp.asarray(x), jnp.asarray(elm), level, 3, jsp.pitch,
            None if co is None else jnp.asarray(co)))
        got = top.p2_apply_local(
            interop.block_from_reference(x, device="cpu"), et, level, 3, tsp.pitch,
            None if co is None else interop.block_from_reference(co, device="cpu"))
        _assert_close(got, ref, np.abs(ref).max(), 1e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level,pitch", APPLY_CASES)
def test_stencil_weights_and_plain_apply_match_xla(name, level, pitch, kind):
    jsp, tsp = _spaces(name, level, pitch)
    elm = _elmats(name, level, pitch, kind)
    A = jk.p2_stencil_weights(jnp.asarray(elm), 3)
    E = jk.p2_face_weights(jnp.asarray(elm), 3)
    et = interop.elmats_from_reference(elm, device="cpu")
    At, Et = tk.p2_stencil_weights(et, 3), tk.p2_face_weights(et, 3)
    _assert_close(At, np.asarray(A), np.abs(np.asarray(A)).max(), 1e-6)
    _assert_close(Et, np.asarray(E), np.abs(np.asarray(E)).max(), 1e-6)
    x = _block(jsp, 10 + level)
    ref = np.asarray(jk.p2_const_apply_xla(jnp.asarray(x), A, E, level, 3,
                                           jsp.pitch))
    got = tk.p2_const_apply(interop.block_from_reference(x, device="cpu"),
                            tk.p2_folded_weights(At, Et), level, tsp.pitch)
    _assert_close(got, ref, np.abs(ref).max(), 1e-5)
    assert not got[:, ~tsp.vertex_mask_t.bool()].any()


@pytest.mark.parametrize("name,level,pitch", [("cube1", 1, None),
                                              ("cube1", 2, 13)])
def test_plain_apply_matches_pallas_interpret(name, level, pitch):
    jsp, tsp = _spaces(name, level, pitch)
    elm = _elmats(name, level, pitch, "laplace")
    A = jk.p2_stencil_weights(jnp.asarray(elm), 3)
    E = jk.p2_face_weights(jnp.asarray(elm), 3)
    x = _block(jsp, 20 + level)
    ref = np.asarray(jk.p2_const_apply_pallas(jnp.asarray(x), A, E, level, 3,
                                              jsp.pitch, interpret=True))
    et = interop.elmats_from_reference(elm, device="cpu")
    W = tk.p2_folded_weights(tk.p2_stencil_weights(et, 3),
                             tk.p2_face_weights(et, 3))
    got = tk.p2_const_apply_torch(interop.block_from_reference(x, device="cpu"), W, level,
                                  tsp.pitch)
    _assert_close(got, ref, np.abs(ref).max(), 1e-5)


def test_folded_weights_keep_structural_zeros():
    """Kernel B5 skips zero weights: every (parity, direction) pair with
    no element-matrix entry must fold to an exact 0 in every row."""
    elm = interop.elmats_from_reference(
        _elmats("cube1", 2, None, "laplace"), device="cpu")
    W = tk.p2_folded_weights(tk.p2_stencil_weights(elm, 3),
                             tk.p2_face_weights(elm, 3))
    nzm, _ = tk._nz_tables(3)
    absent = ~nzm.any(-1)                     # (par, s)
    W = W.reshape(-1, 8, 8, 3, 65)            # (C, f, par, k, s)
    assert (W.permute(0, 1, 3, 2, 4)[..., torch.as_tensor(absent)] == 0).all()
    assert absent.sum() == 8 * 65 - 230


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level,pitch", [("cube1", 2, None),
                                              ("cube1", 2, 13)])
def test_operator_matches_jax(name, level, pitch, kind):
    jsp, tsp = _spaces(name, level, pitch)
    elm = _elmats(name, level, pitch, kind)
    jo = jop.P2ElementwiseOperator(jsp, kind, elmats=jnp.asarray(elm))
    to = top.P2ElementwiseOperator(tsp, kind,
                                   elmats=interop.elmats_from_reference(elm, device="cpu"))
    x = np.asarray(jsp.exchange_rep(jnp.asarray(_block(jsp, 30))))
    k = _block(jsp, 31, lo=0.5)
    xt, kt = (interop.block_from_reference(a, device="cpu") for a in (x, k))
    for co, cot in ((None, None), (jnp.asarray(k), kt)):
        ref = np.asarray(jo.apply_raw(jnp.asarray(x), coeff=co))
        _assert_close(to.apply_raw(xt, coeff=cot), ref, np.abs(ref).max(),
                      1e-5)
        ref = np.asarray(jo.diagonal_raw(coeff=co))
        _assert_close(to.diagonal_raw(coeff=cot), ref, np.abs(ref).max(),
                      1e-6)
        ref = np.asarray(jo.inverse_diagonal(coeff=co))
        _assert_close(to.inverse_diagonal(coeff=cot), ref, np.abs(ref).max(),
                      1e-6)


def test_operator_computes_same_elmats_and_buffers():
    _, tsp = _spaces("cube1", 2, None)
    to = top.P2ElementwiseOperator(tsp, "laplace")
    ref = _elmats("cube1", 2, None, "laplace")
    _assert_close(to.elmats, ref, np.abs(ref).max(), 1e-6)
    assert set(dict(to.named_buffers())) == {"elmats", "stencil_folded"}
    W = tk.p2_folded_weights(tk.p2_stencil_weights(to.elmats, 3),
                             tk.p2_face_weights(to.elmats, 3))
    assert torch.equal(to.stencil_folded, W)


def test_wrapper_rejects_non_cpu_non_cuda_tensors():
    _, tsp = _spaces("cube1", 1, None)
    elm = interop.elmats_from_reference(
        _elmats("cube1", 1, None, "laplace"), device="cpu")
    W = tk.p2_folded_weights(tk.p2_stencil_weights(elm, 3),
                             tk.p2_face_weights(elm, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tk.p2_const_apply(torch.empty(tsp.block_shape, device="meta"),
                          W.to("meta"), 1, tsp.pitch)


# ---------------------------------------------------------------------------
# the CUDA kernel's per-point math, compiled for the host
# ---------------------------------------------------------------------------

HOST_HARNESS = r"""
#include <cmath>
#define HYTEG_DEVICE inline
#include "p2_const_stencil.cuh"
using namespace hyteg;
// Kernel B5's staging of a cell's rows off the faces (face set 0).
static void p2_stage(const float* Wc, float* wr) {
  for (int i = 0; i < 24 * kP2Dirs; ++i) wr[i] = Wc[i];
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
// Kernel B5's thread blocks one after another: per cell the staging, per
// plane x every thread (warp, lane) of the block through the same walk
// (p2_const_apply_plane). count: null, or one int per slot of the block.
extern "C" void p2_apply(const float* src, const float* W, float* dst, int C,
                         int M, int pitch, int* count) {
  float wr[24 * kP2Dirs];
  const long long cell = (long long)M * M * pitch;
  for (int c = 0; c < C; ++c) {
    const float* Wc = W + (long long)c * kP2Rows * kP2Dirs;
    p2_stage(Wc, wr);
    for (int x = 0; x < M; ++x)
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid) {
        if (count)
          p2_const_apply_plane(src + c * cell, Wc, wr,
                               CountStore{CellStore{dst + c * cell}, count + c * cell},
                               x, M, pitch, tid >> 5, tid & 31, kPlaneWarps);
        else
          p2_const_apply_plane(src + c * cell, Wc, wr,
                               CellStore{dst + c * cell}, x, M, pitch,
                               tid >> 5, tid & 31, kPlaneWarps);
      }
  }
}
static float p2_interior_at(const float* p, int L, int pitch, const float* w,
                            int par) {
  switch (par) {
    case 0: return p2_interior_node<0>(p, L, pitch, w);
    case 1: return p2_interior_node<1>(p, L, pitch, w);
    case 2: return p2_interior_node<2>(p, L, pitch, w);
    case 3: return p2_interior_node<3>(p, L, pitch, w);
    case 4: return p2_interior_node<4>(p, L, pitch, w);
    case 5: return p2_interior_node<5>(p, L, pitch, w);
    case 6: return p2_interior_node<6>(p, L, pitch, w);
    default: return p2_interior_node<7>(p, L, pitch, w);
  }
}
// The two paths of the walk, each at every in-tet node it can take: off
// the coordinate faces (x, y, z >= 1, any shell key) through the
// compile-time tap lists on the staged row into interior[], every face
// node through p2_face_point into boundary[]; other slots are left as
// they are.
extern "C" void p2_paths(const float* src, const float* W, float* interior,
                         float* boundary, int C, int M, int pitch) {
  float wr[24 * kP2Dirs];
  const int L = M * pitch;
  const long long cell = (long long)M * L;
  for (int c = 0; c < C; ++c) {
    const float* Wc = W + (long long)c * kP2Rows * kP2Dirs;
    p2_stage(Wc, wr);
    const float* u = src + c * cell;
    for (int x = 0; x < M; ++x)
      for (int y = 0; x + y < M; ++y)
        for (int z = 0; x + y + z < M; ++z) {
          const int q = x * L + y * pitch + z;
          const int par = ((x & 1) << 2) | ((y & 1) << 1) | (z & 1);
          if (x > 0 && y > 0 && z > 0)
            interior[c * cell + q] = p2_interior_at(
                u + q, L, pitch, wr + p2_row(x, y, z, M) * kP2Dirs, par);
          else
            boundary[c * cell + q] = p2_face_point(u, x, y, z, M, pitch, Wc);
        }
  }
}
// The compile-time tables: kP2DirList (65 x 3), kP2NTaps (8) and
// kP2TapList (8 x 65).
extern "C" void p2_tap_tables(int* dirs, int* ntaps, int* taps) {
  for (int s = 0; s < kP2Dirs; ++s)
    for (int d = 0; d < 3; ++d) dirs[3 * s + d] = kP2DirList[s][d];
  for (int p = 0; p < 8; ++p) {
    ntaps[p] = kP2NTaps[p];
    for (int i = 0; i < kP2Dirs; ++i) taps[p * kP2Dirs + i] = kP2TapList[p][i];
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_p2")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_p2.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.p2_apply.argtypes = [P, P, P, I, I, I, P]
    lib.p2_paths.argtypes = [P, P, P, P, I, I, I]
    lib.p2_tap_tables.argtypes = [P, P, P]
    return lib


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level,pitch", [("cube1", 2, None),
                                              ("cube1", 2, 13),
                                              ("cube2", 1, None),
                                              ("tet", 3, None)])
def test_kernel_point_math_matches_plain(host_kernel, name, level, pitch,
                                         kind):
    jsp, tsp = _spaces(name, level, pitch)
    et = interop.elmats_from_reference(_elmats(name, level, pitch, kind), device="cpu")
    A, E = tk.p2_stencil_weights(et, 3), tk.p2_face_weights(et, 3)
    W = tk.p2_folded_weights(A, E)
    xt = interop.block_from_reference(_block(jsp, 50 + level), device="cpu")
    ref = tk.p2_const_apply_torch(xt, W, level, tsp.pitch)
    out = torch.empty_like(xt)
    host_kernel.p2_apply(xt.data_ptr(), W.data_ptr(), out.data_ptr(),
                         xt.shape[0], tsp.M, tsp.pitch, None)
    _assert_close(out, ref, ref.abs().max().item(), 1e-5)
    assert not out[:, ~tsp.vertex_mask_t.bool()].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level,pitch", [("cube1", 2, None),
                                              ("cube1", 2, 13),
                                              ("tet", 3, None),
                                              ("tet", 3, 33)])
def test_kernel_paths_match_plain_on_their_nodes(host_kernel, name, level,
                                                 pitch, kind):
    """The 3D kernel's compile-time tap lists, untested, at every node off
    the coordinate faces (face set 0, each shell key on its own row), and
    its face path (the tap lists on the node's own row, each read tested)
    at every face node, each against the plain version there."""
    jsp, tsp = _spaces(name, level, pitch)
    et = interop.elmats_from_reference(_elmats(name, level, pitch, kind),
                                       device="cpu")
    W = tk.p2_folded_weights(tk.p2_stencil_weights(et, 3),
                             tk.p2_face_weights(et, 3))
    xt = interop.block_from_reference(_block(jsp, 60 + level), device="cpu")
    ref = tk.p2_const_apply_torch(xt, W, level, tsp.pitch)
    interior = torch.full_like(xt, float("nan"))
    boundary = torch.full_like(xt, float("nan"))
    host_kernel.p2_paths(xt.data_ptr(), W.data_ptr(), interior.data_ptr(),
                         boundary.data_ptr(), xt.shape[0], tsp.M, tsp.pitch)
    cx, cy, cz = block_coords(tsp.M, tsp.pitch)
    S = cx + cy + cz
    inside = (cz < tsp.M) & (S <= tsp.M - 1)
    inner = inside & (cx > 0) & (cy > 0) & (cz > 0)
    scale = ref.abs().max().item()
    for got, mask in ((interior, inner), (boundary, inside & ~inner)):
        assert mask.any()
        m = torch.as_tensor(mask)
        assert (got[:, m] - ref[:, m]).abs().max().item() <= 1e-5 * scale
        assert torch.isnan(got[:, ~m]).all()


@pytest.mark.parametrize("pitch_of", ["gmg", "own"])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6])
def test_kernel_walk_writes_every_node_once(host_kernel, level, pitch_of):
    """The 3D kernel's walk over its thread blocks (plane x, cell) at each
    level a P2 GMG stack launches, at the stack's shared pitch 129 and at
    the level's own pitch M: every slot of the block is written exactly
    once, and exactly 0 outside the tet and on padding lanes, whatever
    the source holds there."""
    M = (2 << level) + 1
    pitch = 129 if pitch_of == "gmg" else M
    rng = np.random.default_rng(level)
    src = torch.as_tensor(
        rng.standard_normal((1, M, M * pitch)).astype(np.float32))
    W = torch.as_tensor(rng.standard_normal((1, 192, 65)).astype(np.float32))
    dst = torch.full_like(src, float("nan"))
    count = torch.zeros(src.shape, dtype=torch.int32)
    host_kernel.p2_apply(src.data_ptr(), W.data_ptr(), dst.data_ptr(), 1, M,
                         pitch, count.data_ptr())
    assert (count == 1).all()
    cx, cy, cz = block_coords(M, pitch)
    outside = torch.as_tensor((cz >= M) | (cx + cy + cz > M - 1))
    assert (dst[:, outside] == 0).all()
    assert torch.isfinite(dst).all() and dst[:, ~outside].ne(0).any()


def test_kernel_tap_lists_match_tables(host_kernel):
    """The kernel's compile-time directions equal p2_stencil_tables(3)'s,
    and each parity's tap list holds exactly the directions that
    _nz_tables(3) marks structurally nonzero in some shell slot, in
    ascending order."""
    dirs = np.zeros((65, 3), dtype=np.int32)
    ntaps = np.zeros(8, dtype=np.int32)
    taps = np.zeros((8, 65), dtype=np.int32)
    host_kernel.p2_tap_tables(dirs.ctypes.data, ntaps.ctypes.data,
                              taps.ctypes.data)
    np.testing.assert_array_equal(dirs, tk._kernel_dirs())
    nzm, _ = tk._nz_tables(3)
    for par in range(8):
        want = np.nonzero(nzm[par].any(-1))[0]
        np.testing.assert_array_equal(taps[par, :ntaps[par]], want)
    assert ntaps.mean() == 28.75


def test_p1_subspace_shares_pitch():
    _, tsp = _spaces("cube1", 2, 13)
    sub = tsp.p1_subspace()
    assert isinstance(sub, P1Space) and sub.pitch == 13 and sub.level == 2
