"""The paired-tet engine of the PyTorch port — plan, interface metadata,
small exchange, kernels B6 (apply), B7 (install) and B8 (extract) in
their plain versions, and the engine as a whole — against the JAX package
(hyteg_tpu/tetpair) on identical inputs, and against the port's classic
elementwise apply.

The JAX side runs as tests/test_tetpair.py runs it: the Pallas kernels in
interpret mode (``TetPairEngine(..., interpret=True)``,
``tetpair.kernel.*(interpret=True)``). Inputs are made with numpy from a
seed and carried over through hyteg_tpu_torch.interop.

The kernels' code in csrc/tetpair.cuh (B6's plane walk over every block
of its grid, its launcher's direction check, and B7's and B8's per-lane
maps) is also compiled with the host C++ compiler, run one block or
thread after another through counting stores, and held against the plain
versions, so the indexing that runs on the card is checked here without
a GPU.

Tolerances:
- tables, masks, interface metadata, pack/unpack, the lift -> lower round
  trip, the triangle transforms, install and extract: exact (they select
  and copy);
- weight_matrix: 1e-6 of its largest entry (the JAX package sums the
  stencil tables in f32 before combining them in f64; the port sums them
  in f64 too);
- the small exchange: 1e-6 of the largest |value| (sums in another order);
- pair_apply_torch vs the Pallas kernel, dst and the four face outputs:
  1e-6 * max|dst| (15-term f32 sums in another order; the Pallas kernel
  subtracts the shell tails as a separate sum);
- apply_full vs JAX apply_full and vs the port's classic apply_raw:
  2e-6 * max|y| (tests/test_tetpair.py:44); two chained applies 5e-6 *
  max|y| (:54);
- the host-compiled kernel math vs the plain versions: apply 1e-6 *
  max|dst| (fused multiply-adds), install and extract exact; the walk's
  untested interior sum vs the tested per-point math: 2 ulps (the same
  terms in the same order), equal on every other in-tet slot.
"""

import ctypes
import dataclasses
import functools
import pathlib
import shutil
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.functions import ifc_dense as jifc
from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator as JOp
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.tetpair import TetPairEngine as JEngine
from hyteg_tpu.tetpair import kernel as jtk
from hyteg_tpu.tetpair import plan as jplan
from hyteg_tpu.tetpair import small as jsmall
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.kernels import tetpair as tk
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import forms as tforms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.tetpair import TetPairEngine
from hyteg_tpu_torch.tetpair import ifc as tifc
from hyteg_tpu_torch.tetpair import plan as tplan
from hyteg_tpu_torch.tetpair import small as tsmall

torch.set_num_threads(1)

FORMS = {"laplace": (jforms.laplace_form, tforms.laplace_form),
         "mass": (jforms.mass_form, tforms.mass_form)}
MESHES = {"cube1": lambda m: m.mesh_unit_cube(1),
          "cube2": lambda m: m.mesh_unit_cube(2),
          "shell": lambda m: m.mesh_spherical_shell(2, 2, 0.55, 1.0)}
# (mesh, level, pitch): levels 2-3, pitch N and a pitch > N
CASES = [("cube1", 2, None), ("cube1", 3, None), ("cube1", 3, 11),
         ("cube2", 2, 7), ("cube2", 3, None), ("cube2", 3, 13)]
GEOMS = sorted({(l, p) for _, l, p in CASES}, key=str)


def _np(t):
    return interop.block_to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_close(got, ref, rtol, scale=None):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    assert np.abs(got - ref).max() <= rtol * scale


def _assert_equal(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _case(name, level, pitch, form="laplace"):
    """Both packages on one mesh, level and pitch: spaces, operators built
    from the JAX element matrices, engines, and one consistent x."""
    jsp = JSpace(JStorage(MESHES[name](jmi), num_shards=1), level,
                 pitch=pitch)
    jop = JOp(jsp, FORMS[form][0])
    elm = np.asarray(jop.elmats)
    tsp = P1Space(CellStorage(MESHES[name](tmi)), level, device="cpu",
                  pitch=pitch)
    top = P1ElementwiseOperator(tsp, FORMS[form][1],
                                elmats=interop.elmats_from_reference(elm, device="cpu"))
    x = _rand(jsp.block_shape, level) * jsp.vertex_mask[None]
    x = np.asarray(jsp.exchange_rep(jnp.asarray(x), jsp.resolve_sd(None)))
    return types.SimpleNamespace(
        jsp=jsp, jop=jop, tsp=tsp, top=top, elm=elm, x=x,
        jeng=JEngine(jsp, jop.elmats, interpret=True),
        teng=TetPairEngine(tsp, top.elmats),
        N=tsp.N, P=tsp.pitch, mask=jsp.vertex_mask[None])


def _geometry(level, pitch):
    N = (1 << level) + 1
    return N, N if pitch is None else pitch


def _random_state(c, seed):
    """A paired state with random values everywhere, padding lanes of
    the faces included (install and extract must select exactly)."""
    Cp, N, P = c.teng.Cp, c.N, c.P
    shapes = [(Cp, N, N * P), (Cp, 2, N * P), (Cp, 2, N, P), (Cp, 2, N, N),
              (Cp, 2, N * P)]
    return [_rand(s, seed + i) for i, s in enumerate(shapes)]


def _applied_state(c):
    """A realistic state: JAX's lift of x, with random face values on
    the tet lanes (zero on padding lanes, as the exchange leaves them)."""
    st = c.jeng.lift(jnp.asarray(c.x))
    N, P = c.N, c.P
    pad = (np.arange(N * P) % P) < N
    xf = _rand(st.xf.shape, 7) * pad
    df = _rand(st.df.shape, 8) * pad
    yf = _rand(st.yf.shape, 9) * (np.arange(P) < N)
    zf = _rand(st.zf.shape, 10)
    return [np.asarray(st.u), xf, yf, zf, df]


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


def test_dir_tables_match():
    jd, jn, ja, jb = jplan.dir_tables()
    td, tn, ta, tb = tplan.dir_tables()
    _assert_equal(td, jd)
    _assert_equal(tn, jn)
    assert (ta, tb) == (ja, jb)
    assert (tplan.N_VEC, tplan.N_MASKCOL, tplan.KINDS) == (
        jplan.N_VEC, jplan.N_MASKCOL, jplan.KINDS)


@pytest.mark.parametrize("level,pitch", GEOMS)
def test_plan_masks_match(level, pitch):
    N, P = _geometry(level, pitch)
    _assert_equal(tplan.mask_stack(N, P), jplan.mask_stack(N, P))
    jp, tp = jplan.PairPlan(N, P), tplan.PairPlan(N, P)
    for field in ("yz", "masks", "in_a", "in_b"):
        _assert_equal(getattr(tp, field), getattr(jp, field))
    assert (tp.n, tp.L) == (jp.n, jp.L)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", ["cube2", "shell"])
def test_weight_matrix_matches(name, form):
    c = _case(name, 2, None, form)
    ref = jplan.weight_matrix(c.elm)
    got = tplan.weight_matrix(interop.elmats_from_reference(c.elm, device="cpu"))
    assert got.dtype == torch.float32
    _assert_close(got, ref, 1e-6)


@pytest.mark.parametrize("name,level,pitch", CASES)
def test_pack_unpack_match(name, level, pitch):
    c = _case(name, level, pitch)
    u = _rand(c.jsp.block_shape, 3)  # values outside the tets too
    jp = jplan.pack_blocks(jnp.asarray(u), c.N, c.P)
    tp = tplan.pack_blocks(interop.block_from_reference(u, device="cpu"), c.N, c.P)
    _assert_equal(tp, jp)
    _assert_equal(tplan.unpack_blocks(tp, c.N, c.P),
                  jplan.unpack_blocks(jp, c.N, c.P))


@pytest.mark.parametrize("name,level,pitch", CASES)
def test_lift_lower_round_trip(name, level, pitch):
    c = _case(name, level, pitch)
    x = interop.block_from_reference(c.x, device="cpu")
    st = c.teng.lift(x)
    _assert_equal(c.teng.lower(st) * torch.as_tensor(c.mask), x)
    jst = c.jeng.lift(jnp.asarray(c.x))
    for got, ref in zip((st.u, st.xf, st.yf, st.zf, st.df),
                        (jst.u, jst.xf, jst.yf, jst.zf, jst.df)):
        _assert_equal(got, ref)


# ---------------------------------------------------------------------------
# interface metadata and triangle transforms
# ---------------------------------------------------------------------------

IFC_FIELDS = ("N", "face_perm_id", "face_macro", "face_members",
              "edge_flip", "edge_macro", "num_macro_edges", "vert_macro",
              "num_macro_verts", "perms")


@pytest.mark.parametrize("name", ["cube2", "shell"])
def test_ifc_metadata_matches(name):
    level = 2
    ref = jifc.build_dense_ifc(JStorage(MESHES[name](jmi), num_shards=1),
                               level)
    got = tifc.build_ifc(CellStorage(MESHES[name](tmi)), level)
    for field in IFC_FIELDS:
        g, r = getattr(got, field), getattr(ref, field)
        if isinstance(r, np.ndarray):
            _assert_equal(g, r)
        else:
            assert g == r, field


@pytest.mark.parametrize("N", [5, 9])
def test_transform_sequences_match(N):
    ref = jifc._transform_sequences(N)
    got = tifc._transform_sequences(N)
    assert got == ref
    a = _rand((3, N, N), N)
    W = jifc._shear_matrix(N)
    for perm, (seq, iseq) in ref.items():
        for s in (seq, iseq):
            _assert_equal(tifc._apply_seq(torch.tensor(a), s),
                          jifc._apply_seq(jnp.asarray(a), s, W))
    _assert_equal(tifc._op_S(torch.tensor(a)), jifc._op_S(jnp.asarray(a), W))


def _scrambled(c, seed):
    """Both packages' interface metadata with random face permutations and
    edge flips: the general (non-sorted) branch of the exchange."""
    rng = np.random.default_rng(seed)
    perm = rng.integers(0, 6, c.teng.ifc.face_perm_id.shape).astype(np.int32)
    flip = rng.random(c.teng.ifc.edge_flip.shape) < 0.5
    return (dataclasses.replace(c.jeng.ifc, face_perm_id=perm, edge_flip=flip),
            dataclasses.replace(c.teng.ifc, face_perm_id=perm, edge_flip=flip))


def test_canon_grouped_general_branch():
    c = _case("cube1", 2, None)
    jm, tm = _scrambled(c, 0)
    rows = _rand((c.jsp.storage.cells_per_shard * 4, c.N, c.N), 4)
    tri = np.add.outer(np.arange(c.N), np.arange(c.N)) <= c.N - 1
    rows = rows * tri
    for inverse in (False, True):
        _assert_equal(
            tsmall._canon_grouped(tm, torch.tensor(rows), inverse),
            jsmall._canon_grouped(jm, jnp.asarray(rows), inverse))
    back = tsmall._canon_grouped(
        tm, tsmall._canon_grouped(tm, torch.tensor(rows), False), True)
    _assert_equal(back, rows)


# ---------------------------------------------------------------------------
# small exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,level,pitch", CASES)
def test_faces_planes_match(name, level, pitch):
    c = _case(name, level, pitch)
    _, xf, yf, zf, df = _random_state(c, 20)
    jpl = jsmall.faces_to_planes(jnp.asarray(xf), jnp.asarray(yf),
                                 jnp.asarray(zf), jnp.asarray(df), c.N, c.P)
    tpl = tsmall.faces_to_planes(*(torch.tensor(a) for a in (xf, yf, zf, df)),
                                 c.N, c.P)
    _assert_close(tpl, jpl, 1e-6)
    for got, ref in zip(tsmall.planes_to_faces(tpl, c.N, c.P),
                        jsmall.planes_to_faces(jpl, c.N, c.P)):
        _assert_close(got, ref, 1e-6, scale=np.abs(_np(jpl)).max())


@pytest.mark.parametrize("scrambled", [False, True])
@pytest.mark.parametrize("name,level,pitch",
                         [("cube1", 2, None), ("cube2", 3, None),
                          ("shell", 2, None)])
def test_exchange_planes_match(name, level, pitch, scrambled):
    c = _case(name, level, pitch)
    jm, tm = _scrambled(c, 1) if scrambled else (c.jeng.ifc, c.teng.ifc)
    planes = _rand((c.jsp.storage.cells_per_shard, 4, c.N, c.N), 5)
    ref = jsmall.exchange_planes(jm, jnp.asarray(planes))
    got = tsmall.exchange_planes(tm, torch.tensor(planes))
    _assert_close(got, ref, 1e-6)


# ---------------------------------------------------------------------------
# kernels B6-B8, plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,level,pitch", CASES)
def test_extract_install_match_pallas(name, level, pitch):
    c = _case(name, level, pitch)
    u, xf, yf, zf, df = _random_state(c, 30)
    ref = jtk.pair_extract(jnp.asarray(u), c.N, c.P, interpret=True)
    got = tk.pair_extract(torch.tensor(u), c.N, c.P)
    for g, r in zip(got, ref):
        _assert_equal(g, r)
    ref = jtk.pair_install(*(jnp.asarray(a) for a in (u, xf, yf, zf, df)),
                           c.N, c.P, interpret=True)
    got = tk.pair_install(*(torch.tensor(a) for a in (u, xf, yf, zf, df)),
                          c.N, c.P)
    _assert_equal(got, ref)


@pytest.mark.parametrize("name,level,pitch", CASES + [("shell", 2, None)])
def test_pair_apply_matches_pallas(name, level, pitch):
    c = _case(name, level, pitch)
    state = _applied_state(c)
    W = jplan.weight_matrix(c.elm)
    ref = jtk.pair_apply(jnp.asarray(state[0]), jnp.asarray(W),
                         *(jnp.asarray(a) for a in state[1:]), c.N, c.P,
                         interpret=True)
    got = tk.pair_apply(torch.tensor(state[0]),
                        interop.pair_weights_from_reference(W, device="cpu"),
                        *(torch.tensor(a) for a in state[1:]), c.N, c.P)
    scale = np.abs(_np(ref[0])).max()
    for g, r in zip(got, ref):
        _assert_close(g, r, 1e-6, scale=scale)


def test_pair_state_from_reference():
    c = _case("cube1", 2, None)
    jst = c.jeng.lift(jnp.asarray(c.x))
    st = interop.pair_state_from_reference(jst.u, jst.xf, jst.yf, jst.zf,
                                           jst.df, device="cpu")
    for f in ("u", "xf", "yf", "zf", "df"):
        _assert_equal(getattr(st, f), getattr(jst, f))
    _assert_equal(c.teng.lower(st) * torch.as_tensor(c.mask),
                  np.asarray(c.jeng.lower(jst)) * c.mask)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,level,pitch", CASES)
def test_apply_full_matches(name, level, pitch):
    c = _case(name, level, pitch)
    x = interop.block_from_reference(c.x, device="cpu")
    got = _np(c.teng.apply_full(x)) * c.mask
    ref_j = np.asarray(c.jeng.apply_full(jnp.asarray(c.x))) * c.mask
    ref_t = _np(c.top.apply_raw(x)) * c.mask
    scale = np.abs(ref_t).max()
    _assert_close(got, ref_j, 2e-6, scale=scale)
    _assert_close(got, ref_t, 2e-6, scale=scale)


@pytest.mark.parametrize("name,level,pitch",
                         [("cube1", 3, None), ("cube2", 3, 13)])
def test_chained_apply_matches(name, level, pitch):
    c = _case(name, level, pitch)
    x = interop.block_from_reference(c.x, device="cpu")
    got = _np(c.teng.lower(c.teng.apply_ex(c.teng.apply_ex(c.teng.lift(x)))))
    ref_t = _np(c.top.apply_raw(c.top.apply_raw(x))) * c.mask
    jst = c.jeng.apply_ex(c.jeng.apply_ex(c.jeng.lift(jnp.asarray(c.x))))
    ref_j = np.asarray(c.jeng.lower(jst)) * c.mask
    scale = np.abs(ref_t).max()
    _assert_close(got * c.mask, ref_t, 5e-6, scale=scale)
    _assert_close(got * c.mask, ref_j, 5e-6, scale=scale)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_shell_apply_matches_classic(form):
    """1920 curved cells: reads that leave the block meet effective
    weights of up to ~5e-10 there, not exactly 0."""
    c = _case("shell", 2, None, form)
    x = interop.block_from_reference(c.x, device="cpu")
    got = _np(c.teng.apply_full(x)) * c.mask
    ref = _np(c.top.apply_raw(x)) * c.mask
    _assert_close(got, ref, 2e-6)
    ref_j = np.asarray(c.jeng.apply_full(jnp.asarray(c.x))) * c.mask
    _assert_close(got, ref_j, 2e-6, scale=np.abs(ref).max())


def test_engine_rejects_odd_cell_count():
    sp = P1Space(CellStorage(tmi.mesh_single_tet()), 2, device="cpu")
    op = P1ElementwiseOperator(sp, tforms.laplace_form)
    with pytest.raises(ValueError, match="even macro-cell count"):
        TetPairEngine(sp, op.elmats)


def test_engine_rejects_several_shards():
    sp = _case("cube1", 2, None).tsp
    stub = types.SimpleNamespace(
        dim=3, C_loc=3, storage=types.SimpleNamespace(
            num_shards=2, cell_valid=np.ones(6, dtype=bool)))
    with pytest.raises(ValueError, match="single-shard"):
        TetPairEngine(stub, None)
    with pytest.raises(ValueError, match="single-shard"):
        tifc.build_ifc(types.SimpleNamespace(num_shards=2, dim=3), sp.level)


# ---------------------------------------------------------------------------
# the CUDA kernels' per-point math, compiled for the host
# ---------------------------------------------------------------------------

CSRC = pathlib.Path(tk.__file__).resolve().parent.parent / "csrc"
HOST_HARNESS = r"""
#include <algorithm>
#include <cmath>
#include <vector>
#define HYTEG_DEVICE inline
#include "tetpair.cuh"
using namespace hyteg;
// Counts each slot's writes beside the store (count may be null).
struct CountStore {
  CellStore cell;
  int* count;
  void operator()(int i, float v) const {
    cell(i, v);
    if (count) ++count[i];
  }
  int to_aligned(int i) const { return cell.to_aligned(i); }
  void quad(int i, float a, float b, float c, float d) const {
    cell.quad(i, a, b, c, d);
    if (count)
      for (int k = 0; k < 4; ++k) ++count[i + k];
  }
};
static int* at(int* p, long long off) { return p ? p + off : nullptr; }
static PairOut<CountStore> outs(float* dst, float* xfo, float* yfo,
                                float* zfo, float* dfo, int* const* cnt,
                                int c, int N, int P) {
  const long long L = (long long)N * P;
  const PairFaces<float> f = pair_faces_of(xfo, yfo, zfo, dfo, c, N, P);
  return {CountStore{CellStore{dst + c * N * L}, at(cnt[0], c * N * L)},
          {CountStore{CellStore{f.xf}, at(cnt[1], c * 2 * L)},
           CountStore{CellStore{f.yf}, at(cnt[2], c * 2LL * N * P)},
           CountStore{CellStore{f.zf}, at(cnt[3], c * 2LL * N * N)},
           CountStore{CellStore{f.df}, at(cnt[4], c * 2 * L)}}};
}
// Kernel B6's launcher and grid, one block after another: the direction
// check, per pair and block row y the plane pair_plane_of(y), its class
// table (the classes it does not form NaN) and every thread (warp, lane)
// of the block through the same walk (pair_apply_plane). counts: five
// arrays (dst, xfo, yfo, zfo, dfo) of one int per entry, or null. Returns the launcher's error (11,
// cudaErrorInvalidValue) for directions it refuses, else 0.
extern "C" int pair_apply_host(const float* u, const float* W,
                               const float* xf, const float* yf,
                               const float* zf, const float* df, float* dst,
                               float* xfo, float* yfo, float* zfo,
                               float* dfo, int Cp, int N, int P,
                               const int* dirs, int tail_a, int tail_b,
                               int* const* counts) {
  if (!pair_dirs_match(dirs)) return 11;
  int* none[5] = {};
  int* const* cnt = counts ? counts : none;
  const PairTables t{tail_a, tail_b};
  const long long block = (long long)N * N * P;
  std::vector<float> tab(kPairTab);
  for (int c = 0; c < Cp; ++c) {
    const float* Wc = W + (long long)c * kPairW;
    for (int y = 0; y < N; ++y) {
      std::fill(tab.begin(), tab.end(), NAN);
      pair_weight_table(Wc, t, N - 1, pair_plane_of(y, N), tab.data(), 0, 1);
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid)
        pair_apply_plane(u + c * block, pair_faces_of(xf, yf, zf, df, c, N, P),
                         tab.data(),
                         outs(dst, xfo, yfo, zfo, dfo, cnt, c, N, P),
                         pair_plane_of(y, N), N, P, tid >> 5, tid & 31,
                         kPlaneWarps);
    }
  }
  return 0;
}
// The per-point math the walk reproduces, at every in-tet position (dst
// elsewhere untouched): pair_weights_at's weights, pair_source's reads
// (flat lanes, 0 beyond the block), summed by pair_stencil.
extern "C" void pair_points_host(const float* u, const float* W,
                                 const float* xf, const float* yf,
                                 const float* zf, const float* df, float* dst,
                                 int Cp, int N, int P, int tail_a,
                                 int tail_b) {
  const int n = N - 1;
  const long long block = (long long)N * N * P;
  const PairTables t{tail_a, tail_b};
  for (int c = 0; c < Cp; ++c) {
    const PairFaces<const float> f = pair_faces_of(xf, yf, zf, df, c, N, P);
    const float* uc = u + c * block;
    for (int x = 0; x < N; ++x)
      for (int ly = 0; ly < N; ++ly)
        for (int lz = 0; lz < P; ++lz) {
          const int h = pair_half(x, ly, lz, n);
          if (h < 0) continue;
          float w[kPairDirs];
          pair_weights_at(W + (long long)c * kPairW, t, x, ly, lz, n, h, w);
          const long long l = (long long)ly * P + lz;
          dst[c * block + x * N * P + l] = pair_stencil(
              [&](int dx, int dy, int dz) {
                const long long ll = l + dy * P + dz;
                if (x + dx < 0 || x + dx >= N || ll < 0 || ll >= N * P)
                  return 0.f;
                return *pair_source(uc, f, x + dx, (int)(ll / P),
                                    (int)(ll % P), N, P);
              },
              w);
        }
  }
}
extern "C" void pair_install_host(const float* u, const float* xf,
                                  const float* yf, const float* zf,
                                  const float* df, float* out, int Cp, int N,
                                  int P) {
  const long long L = (long long)N * P, block = N * L;
  for (int c = 0; c < Cp; ++c)
    for (int x = 0; x < N; ++x)
      for (int l = 0; l < L; ++l)
        out[c * block + x * L + l] = pair_installed(
            u + c * block, pair_faces_of(xf, yf, zf, df, c, N, P), x, l / P,
            l % P, N, P);
}
extern "C" void pair_extract_host(const float* u, float* xfo, float* yfo,
                                  float* zfo, float* dfo, int Cp, int N,
                                  int P) {
  const long long block = (long long)N * N * P;
  for (int c = 0; c < Cp; ++c)
    for (int l = 0; l < N * P; ++l)
      pair_extract_lane(u + c * block,
                        pair_stores_of(xfo, yfo, zfo, dfo, c, N, P), l / P,
                        l % P, N, P);
}
"""


@pytest.fixture(scope="module")
def host_pair_kernels(tmp_path_factory):
    """B6's plane walk and the per-lane functions of B7 and B8
    (csrc/tetpair.cuh) built with the host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_pair_kernels")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_pair.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.pair_apply_host.argtypes = [P_] * 11 + [I_, I_, I_, P_, I_, I_, P_]
    lib.pair_apply_host.restype = I_
    lib.pair_points_host.argtypes = [P_] * 7 + [I_] * 5
    lib.pair_install_host.argtypes = [P_] * 6 + [I_, I_, I_]
    lib.pair_extract_host.argtypes = [P_] * 5 + [I_, I_, I_]
    return lib


def _unwritten(*shapes):
    """NaN-filled outputs: a slot the kernel code leaves unwritten fails."""
    return [torch.full(s, float("nan")) for s in shapes]


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _host_apply(lib, c, state, dirs=None, counts=None):
    """B6's walk on the host over every block of the grid: (rc, dst, xfo,
    yfo, zfo, dfo), the outputs NaN where nothing was written."""
    Cp, N, P = c.teng.Cp, c.N, c.P
    u, xf, yf, zf, df = state
    got = _unwritten(u.shape, *tk._face_shapes(Cp, N, P))
    kd, tail_a, tail_b = tk._kernel_tables()
    d = kd if dirs is None else dirs
    cp = None
    if counts is not None:
        cp = (ctypes.c_void_p * 5)(*_ptrs(counts))
    rc = lib.pair_apply_host(*_ptrs((u, c.teng.W, xf, yf, zf, df)),
                             *_ptrs(got), Cp, N, P, d.ctypes.data, tail_a,
                             tail_b, cp)
    return (rc, *got)


def _state(c, state):
    arrays = _random_state(c, 40) if state == "random" else _applied_state(c)
    return [torch.tensor(a) for a in arrays]


# several planes per pair (rows of both tets, interior slots from level
# 4), pitches N, 13 and 37 (padding lanes), the curved shell
KERNEL_CASES = [("cube2", 3, None), ("cube2", 3, 13), ("shell", 2, None),
                ("cube1", 4, None), ("cube1", 5, 37)]


@pytest.mark.parametrize("state", ["random", "applied"])
@pytest.mark.parametrize("name,level,pitch", KERNEL_CASES)
def test_kernel_point_math_matches_plain(host_pair_kernels, name, level,
                                         pitch, state):
    c = _case(name, level, pitch)
    Cp, N, P = c.teng.Cp, c.N, c.P
    u, xf, yf, zf, df = st = _state(c, state)

    faces = tk._face_shapes(Cp, N, P)
    ref = tk.pair_extract_torch(u, N, P)
    got = _unwritten(*faces)
    host_pair_kernels.pair_extract_host(u.data_ptr(), *_ptrs(got), Cp, N, P)
    for g, r in zip(got, ref):
        _assert_equal(g, r)

    ref = tk.pair_install_torch(u, xf, yf, zf, df, N, P)
    got, = _unwritten(u.shape)
    host_pair_kernels.pair_install_host(*_ptrs((u, xf, yf, zf, df, got)),
                                        Cp, N, P)
    _assert_equal(got, ref)

    ref = tk.pair_apply_torch(u, c.teng.W, xf, yf, zf, df, N, P)
    rc, *got = _host_apply(host_pair_kernels, c, st)
    assert rc == 0
    scale = ref[0].abs().max().item()
    for g, r in zip(got, ref):
        _assert_close(g, r, 1e-6, scale=scale)


def _outside(c):
    """(Cp, N, N * P) bool: positions in neither tet (the middle of the
    block and the padding lanes)."""
    N, P = c.N, c.P
    plan = tplan.PairPlan(N, P)
    ins = torch.as_tensor(plan.in_a) | torch.as_tensor(plan.in_b)
    return ~ins.expand(c.teng.Cp, N, N * P)


@pytest.mark.parametrize("name,level,pitch", KERNEL_CASES)
def test_kernel_walk_writes_every_slot_once(host_pair_kernels, name, level,
                                            pitch):
    """B6's plane walk over all its thread blocks through a counting
    store: every slot of dst and every entry of the four face arrays
    written exactly once, the zeros included, and dst exactly 0 outside
    both tets."""
    c = _case(name, level, pitch)
    st = _state(c, "random")
    shapes = [st[0].shape, *tk._face_shapes(c.teng.Cp, c.N, c.P)]
    counts = [torch.zeros(s, dtype=torch.int32) for s in shapes]
    rc, *got = _host_apply(host_pair_kernels, c, st, counts=counts)
    assert rc == 0
    for cnt in counts:
        assert (cnt == 1).all()
    assert (got[0][_outside(c)] == 0).all()


@pytest.mark.parametrize("name,level,pitch", [("cube1", 4, None),
                                              ("cube1", 5, 37),
                                              ("shell", 3, None)])
def test_kernel_interior_sum_matches_point_math(host_pair_kernels, name,
                                                level, pitch):
    """The walk's untested interior sum (u read directly, the pair's
    column-0 weights at compile-time directions) against the per-point
    math (pair_source reads, pair_weights_at weights, pair_stencil) at
    every interior slot: within 2 ulps (the same terms in the same order);
    every other in-tet slot (layer and face slots: the same sum with
    compile-time face taps and the class table's weights; rim slots:
    reads through pair_source) equal to it bit for bit."""
    c = _case(name, level, pitch)
    st = _state(c, "applied")
    Cp, N, P = c.teng.Cp, c.N, c.P
    rc, dst, *_ = _host_apply(host_pair_kernels, c, st)
    assert rc == 0
    point = torch.zeros_like(dst)
    kd, tail_a, tail_b = tk._kernel_tables()
    host_pair_kernels.pair_points_host(
        *_ptrs((st[0], c.teng.W, *st[1:], point)), Cp, N, P, tail_a, tail_b)
    n = N - 1
    x = np.arange(N)[:, None, None]
    ly, lz = np.arange(N)[None, :, None], np.arange(P)[None, None, :]
    s = x + ly + lz
    inner_a = (x >= 2) & (ly >= 2) & (lz >= 2) & (s <= n - 2)
    inner_b = (x <= n - 2) & (ly <= n - 2) & (lz <= n - 2) & (s >= 2 * n + 2)
    inner = (inner_a | inner_b).reshape(N, N * P)
    assert inner.any()
    a, b = dst.numpy(), point.numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert (np.abs(a - b)[:, inner] <= 2 * ulp[:, inner]).all()
    rim = ~inner & ~_outside(c)[0].numpy()
    assert np.array_equal(a[:, rim], b[:, rim])


def test_kernel_launcher_refuses_other_dirs(host_pair_kernels):
    """The B6 launcher (mirrored by the host harness) takes only the
    direction table its walk was compiled with, plan.dir_tables in its
    order."""
    c = _case("cube2", 2, None)
    st = _state(c, "random")
    dirs, _, _ = tk._kernel_tables()
    assert _host_apply(host_pair_kernels, c, st, dirs=dirs)[0] == 0
    for d in (dirs[::-1].copy(), dirs[:, [1, 0, 2]].copy(), -dirs):
        rc, *got = _host_apply(host_pair_kernels, c, st, dirs=d)
        assert rc == 11
        assert all(torch.isnan(g).all() for g in got)
