"""The box path of the PyTorch port — Kuhn tables, BoxDomain, kernel B1
(box stencil apply) in its plain version, the box operator and the
stream-copy probe P1 — against the JAX package on identical inputs.

The JAX side runs as its own CPU tests run it: the XLA formulation
``_apply_xla`` and the Pallas kernel ``box_apply_pallas`` in interpret
mode. Inputs are made with numpy from a seed and carried over through
hyteg_tpu_torch.interop.

B1's thread walk (csrc/box_stencil.cuh: box_apply_thread, box_lane_walk)
is also compiled with the host C++ compiler, run thread block by thread
block through a counting store and held against the plain version, so
the code that runs on the card is checked here without a GPU.

Tolerances: tables exact; lane weights from the same element matrices
1e-7 of their largest entry (f32 sums in another order); element matrices
computed by each package 1e-6; f32 applies rtol 2e-4, atol 2e-5 (those of
tests/test_box.py); bf16 applies 2^-8 * max|y|, one bf16 rounding of the
f32 sum, which may land one ulp apart when the sums are taken in another
order.
"""

import ctypes
import functools
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.kernels.box_stencil import box_apply_pallas
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.structured import BoxDomain as JDomain
from hyteg_tpu.structured import BoxStencilOperator as JOp
from hyteg_tpu.structured import kuhn as jkuhn
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.kernels import box_stencil as tk
from hyteg_tpu_torch.kernels import stream
from hyteg_tpu_torch.operators import forms as tforms
from hyteg_tpu_torch.structured import BoxDomain, BoxStencilOperator
from hyteg_tpu_torch.structured import kuhn as tkuhn
from hyteg_tpu_torch.structured.box import rowclass_mul

from chip_smoke import bf16_ulp_excess

torch.set_num_threads(1)

FORMS = {"laplace": (jforms.laplace_form, tforms.laplace_form),
         "mass": (jforms.mass_form, tforms.mass_form)}
DOMAINS = [((2, 1, 1), (1.0, 1.0, 1.0)), ((1, 1, 1), (2.0, 1.0, 0.5))]
APPLY_CASES = [(m, ext, level) for m, ext in DOMAINS for level in (2, 3)]
BF16_ULP = 2.0 ** -8


@functools.lru_cache(maxsize=None)
def _ops(m, ext, level, form):
    """(JAX domain, JAX operator, port domain, port operator built from
    the JAX element matrices)."""
    jd, td = JDomain(m, level, ext), BoxDomain(m, level, ext, device="cpu")
    jo = JOp(jd, FORMS[form][0])
    to = BoxStencilOperator(td, FORMS[form][1],
                            elmats=interop.elmats_from_reference(
                                np.asarray(jo.elmats), device="cpu"))
    return jd, jo, td, to


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, rtol=2e-4, atol=2e-5):
    got = interop.block_to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref, dtype=np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Kuhn tables and lane weights
# ---------------------------------------------------------------------------


def test_kuhn_tables_match():
    np.testing.assert_array_equal(tkuhn.KUHN_OFFSETS, jkuhn.KUHN_OFFSETS)
    np.testing.assert_array_equal(tkuhn.stencil_dirs(), jkuhn.stencil_dirs())
    for a, b in zip(tkuhn.term_table(), jkuhn.term_table()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tkuhn._selector(), jkuhn._selector())
    np.testing.assert_array_equal(tkuhn._lane_masks(5, 9),
                                  jkuhn._lane_masks(5, 9))
    h = (0.25, 0.5, 0.125)
    np.testing.assert_array_equal(tkuhn.micro_vertices(h),
                                  jkuhn.micro_vertices(h))


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("m,ext,level", APPLY_CASES)
def test_lane_weights_match(m, ext, level, form):
    jd, jo, td, to = _ops(m, ext, level, form)
    ref = np.asarray(jo.w_vecs)
    got = interop.block_to_numpy(to.w_vecs)
    assert got.shape == ref.shape == (3, 15, td.L)
    assert np.abs(got - ref).max() <= 1e-7 * np.abs(ref).max()
    # the port's own element matrices (f32 forms in both packages)
    own = BoxStencilOperator(td, FORMS[form][1])
    elm = np.asarray(jo.elmats)
    assert np.abs(interop.block_to_numpy(own.elmats) - elm).max() \
        <= 1e-6 * np.abs(elm).max()
    assert np.abs(interop.block_to_numpy(own.w_vecs) - ref).max() \
        <= 1e-6 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# BoxDomain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,ext,level", APPLY_CASES + [((1, 2, 3), (1.0, 1.0, 1.0), 1)])
def test_domain_matches(m, ext, level):
    jd, td = JDomain(m, level, ext), BoxDomain(m, level, ext, device="cpu")
    assert td.dims == jd.dims and td.h == jd.h
    assert td.block_shape == jd.block_shape and td.num_dofs() == jd.num_dofs()
    assert td.coarse().dims == jd.coarse().dims
    for a, b in zip(td.lane_yz, jd.lane_yz):
        np.testing.assert_array_equal(a.numpy(), b)
    ones = torch.ones(td.block_shape)
    np.testing.assert_array_equal(td.mask_interior(ones).numpy(),
                                  jd.interior_mask)
    np.testing.assert_array_equal(td.mask_boundary(ones).numpy(),
                                  jd.boundary_mask)
    np.testing.assert_array_equal(
        td.mask_interior(ones).numpy(),
        np.asarray(jd.interior_mask_traced()))
    # coordinates: exactly the JAX package's (index * h in f64, one f32
    # rounding), handed out as (X, 1), (1, L), (1, L) factors
    fx, fy, fz = td.coord_factors()
    assert fx.shape == (td.X, 1) and fy.shape == fz.shape == (1, td.L)
    for i in range(3):
        got = td.interpolate(lambda *c: c[i])
        np.testing.assert_array_equal(got.numpy(), jd.coords[i])
    fn_j = lambda x, y, z: np.sin(np.pi * x) * np.cos(y) + z * z
    fn_t = lambda x, y, z: torch.sin(np.pi * x) * torch.cos(y) + z * z
    _close(td.interpolate(fn_t), jd.interpolate(fn_j), rtol=1e-6, atol=1e-6)
    # a function of x alone still fills the block
    got = td.interpolate(lambda x, y, z: 2.0 * x)
    assert got.shape == td.block_shape and got.is_contiguous()
    _close(got, 2.0 * jd.coords[0], rtol=0, atol=0)
    u, v = _rand(jd.block_shape, 1), _rand(jd.block_shape, 2)
    for inner in (False, True):
        ref = float(jd.dot(jnp.asarray(u), jnp.asarray(v), inner))
        got = td.dot(torch.tensor(u), torch.tensor(v), inner).item()
        assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref))
    assert td.zeros().shape == td.block_shape


def test_domain_needs_a_device():
    """No default device: the box path runs where the caller says."""
    with pytest.raises(TypeError):
        BoxDomain((1, 1, 1), 2)
    td = BoxDomain((1, 1, 1), 2, device="cpu")
    assert td.coarse().device == "cpu" and td.coarse().level == 1
    assert td.zeros().device.type == "cpu"


INTEROP_CALLS = {
    "elmats_from_reference": (np.zeros((6, 6, 4, 4)),),
    "block_from_reference": (np.zeros((6, 5, 25)),),
    "box_block_from_reference": (np.zeros((5, 25)),),
    "pair_weights_from_reference": (np.zeros((3, 120, 7)),),
    "pair_state_from_reference": tuple(np.zeros((2, 2, 4)) for _ in range(5)),
    "lane_weights_from_reference": (np.zeros((3, 15, 25)),),
}


@pytest.mark.parametrize("name", sorted(INTEROP_CALLS))
def test_interop_needs_a_device(name):
    fn, args = getattr(interop, name), INTEROP_CALLS[name]
    with pytest.raises(TypeError):
        fn(*args)
    with pytest.raises(TypeError):  # not positionally either
        fn(*args, "cpu")
    out = fn(*args, device="cpu")
    if name == "pair_state_from_reference":
        out = (out.u, out.xf, out.yf, out.zf, out.df)
    for t in (out if isinstance(out, tuple) else (out,)):
        assert t.device.type == "cpu" and t.dtype == torch.float32


# ---------------------------------------------------------------------------
# kernel B1, plain version, and the operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("m,ext,level", APPLY_CASES)
def test_plain_apply_matches_xla(m, ext, level, form):
    jd, jo, td, to = _ops(m, ext, level, form)
    u = _rand(jd.block_shape, level)
    ref = np.asarray(jo._apply_xla(jnp.asarray(u)))
    ut = interop.box_block_from_reference(u, device="cpu")
    _close(tk.box_apply_torch(ut, to.w_vecs, td.dims), ref)
    _close(to.apply_raw(ut), ref)  # a CPU tensor takes the plain version
    _close(to._apply_torch(ut), ref)
    _close(to(ut), ref)
    y = _rand(jd.block_shape, 7)
    _close(to.gemv(ut, torch.tensor(y), alpha=0.5, beta=-2.0),
           np.asarray(jo.gemv(jnp.asarray(u), jnp.asarray(y), 0.5, -2.0)))
    _close(to.residual(ut, torch.tensor(y)),
           np.asarray(jo.residual(jnp.asarray(u), jnp.asarray(y))))


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("m,ext,level", APPLY_CASES)
def test_plain_apply_matches_pallas_interpret(m, ext, level, form):
    jd, jo, td, to = _ops(m, ext, level, form)
    u = _rand(jd.block_shape, 10 + level)
    ref = np.asarray(box_apply_pallas(jnp.asarray(u), jo.w_vecs, jd.dims,
                                      interpret=True))
    _close(tk.box_apply_torch(interop.box_block_from_reference(u, device="cpu"),
                              to.w_vecs, td.dims), ref)


def _bf16_case(m, ext, level, form, seed):
    jd, jo, td, to = _ops(m, ext, level, form)
    ub = jnp.asarray(_rand(jd.block_shape, seed)).astype(jnp.bfloat16)
    u32 = np.asarray(ub.astype(jnp.float32))  # the bf16 values, exactly
    ut = interop.box_block_from_reference(u32, dtype=torch.bfloat16, device="cpu")
    return jd, jo, td, to, ub, u32, ut


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("m,ext,level", APPLY_CASES)
def test_bf16_plain_matches_pallas_interpret(m, ext, level, form):
    jd, jo, td, to, ub, u32, ut = _bf16_case(m, ext, level, form, 20 + level)
    ref = np.asarray(box_apply_pallas(ub, jo.w_vecs, jd.dims, interpret=True)
                     .astype(jnp.float32))
    got = to.apply_raw(ut)
    assert got.dtype == torch.bfloat16
    got = interop.block_to_numpy(got)
    assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max()


@pytest.mark.parametrize("m,ext", DOMAINS)
def test_bf16_plain_follows_kernel_not_xla(m, ext):
    """The JAX package's plain box apply casts the weights to the block
    dtype and so accumulates a bf16 block in bf16 (ROADMAP C-ref5); its
    Pallas kernel and the port accumulate in f32 and round once. Against
    the f32 apply of the same bf16 values, the port is off by at most one
    rounding of the result, and the XLA formulation by more."""
    jd, jo, td, to, ub, u32, ut = _bf16_case(m, ext, 3, "laplace", 5)
    exact = np.asarray(jo._apply_xla(jnp.asarray(u32)))
    port = interop.block_to_numpy(to.apply_raw(ut))
    pallas = np.asarray(box_apply_pallas(ub, jo.w_vecs, jd.dims,
                                         interpret=True).astype(jnp.float32))
    xla = np.asarray(jo._apply_xla(ub).astype(jnp.float32))
    port_gap = np.abs(port - exact)
    assert (port_gap <= BF16_ULP * np.abs(exact) + 1e-6).all()
    assert np.abs(pallas - exact).max() <= BF16_ULP * np.abs(exact).max()
    assert np.abs(xla - exact).max() > port_gap.max()


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("m,ext,level", APPLY_CASES)
def test_diagonal_and_dirichlet_match(m, ext, level, form):
    jd, jo, td, to = _ops(m, ext, level, form)
    ones = torch.ones(td.block_shape)
    assert to.diagonal.shape == to.inverse_diagonal.shape == (3, td.L)
    ref = np.asarray(jo.diagonal)
    _close(rowclass_mul(ones, to.diagonal), ref, rtol=1e-6, atol=0)
    ref = np.asarray(jo.inverse_diagonal)
    _close(rowclass_mul(ones, to.inverse_diagonal), ref, rtol=1e-6, atol=0)
    _close(rowclass_mul(ones, to.inverse_diagonal), np.asarray(
        jo.inverse_diagonal_traced()), rtol=1e-6, atol=0)
    u = _rand(jd.block_shape, 30 + level)
    _close(to.apply_dirichlet(torch.tensor(u)),
           np.asarray(jo.apply_dirichlet(jnp.asarray(u))))
    assert set(dict(to.named_buffers())) == {"elmats", "w_vecs", "diagonal",
                                             "inverse_diagonal"}


def test_wrappers_reject_non_cpu_non_cuda_tensors():
    td = BoxDomain((1, 1, 1), 1, device="cpu")
    w = torch.empty((3, 15, td.L), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.box_apply(torch.empty(td.block_shape, device="meta"), w, td.dims)
    with pytest.raises(ValueError, match="CUDA"):
        stream.stream_scale(torch.empty(17, device="meta"))


@pytest.mark.parametrize("shape", [(1,), (7,), (33, 65), (5, 17, 9)])
def test_stream_scale_plain(shape):
    src = torch.tensor(_rand(shape, 3))
    for got in (stream.stream_scale(src), stream.stream_scale_torch(src)):
        assert got.shape == src.shape and got.data_ptr() != src.data_ptr()
        assert torch.equal(got, 2.0 * src)


# ---------------------------------------------------------------------------
# interop round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_box_block_round_trip(dtype):
    jd = JDomain((2, 1, 1), 2)
    u = jnp.asarray(_rand(jd.block_shape, 4))
    if dtype == torch.bfloat16:
        u = u.astype(jnp.bfloat16)
    t = interop.box_block_from_reference(np.asarray(u), dtype=dtype, device="cpu")
    assert t.dtype == dtype and t.shape == jd.block_shape
    back = interop.block_to_numpy(t)
    np.testing.assert_array_equal(back, np.asarray(u.astype(jnp.float32)))
    # and back into the JAX package: the same block, the same apply
    jo = JOp(jd)
    np.testing.assert_array_equal(
        np.asarray(jo._apply_xla(jnp.asarray(back))),
        np.asarray(jo._apply_xla(u.astype(jnp.float32))))


def test_lane_weights_round_trip():
    jd, jo, td, to = _ops((2, 1, 1), (1.0, 1.0, 1.0), 2, "laplace")
    w = interop.lane_weights_from_reference(np.asarray(jo.w_vecs), device="cpu")
    assert w.dtype == torch.float32 and w.shape == (3, 15, td.L)
    np.testing.assert_array_equal(interop.block_to_numpy(w),
                                  np.asarray(jo.w_vecs))
    u = _rand(jd.block_shape, 6)
    _close(tk.box_apply_torch(torch.tensor(u), w, td.dims),
           np.asarray(jo._apply_xla(jnp.asarray(u))))


# ---------------------------------------------------------------------------
# kernel B1's thread walk, compiled for the host
# ---------------------------------------------------------------------------

CSRC = pathlib.Path(tk.__file__).resolve().parent.parent / "csrc"
HOST_HARNESS = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define HYTEG_DEVICE inline
#include "box_stencil.cuh"
using namespace hyteg;
struct LoadF32 {
  const float* p;
  float operator()(long long i) const { return p[i]; }
};
struct LoadBF16 {  // bf16 bits -> f32, exact
  const uint16_t* p;
  float operator()(long long i) const {
    uint32_t b = (uint32_t)p[i] << 16;
    float f;
    std::memcpy(&f, &b, 4);
    return f;
  }
};
static uint16_t bf16_rne(float f) {  // round to nearest even (finite f)
  uint32_t b;
  std::memcpy(&b, &f, 4);
  b += 0x7fffu + ((b >> 16) & 1u);
  return (uint16_t)(b >> 16);
}
struct StoreF32 {
  float* p;
  int* count;
  void operator()(long long i, float v) const {
    p[i] = v;
    if (count) ++count[i];
  }
};
struct StoreBF16 {
  uint16_t* p;
  int* count;
  void operator()(long long i, float v) const {
    p[i] = bf16_rne(v);
    if (count) ++count[i];
  }
};
// Kernel B1's thread blocks one after another, every thread (tz, ty) of
// each through the kernel's own code (box_apply_thread), with chunks of
// `rows` rows (0: the kernel's, box_chunk_rows(X)). count: null, or one int per
// slot of the block.
template <class Load, class Store>
static void run(const Load& load, const float* w, const Store& store, int X,
                int Y, int Z, int rows) {
  if (rows == 0) rows = box_chunk_rows(X);
  for (int bx = 0; bx < (X + rows - 1) / rows; ++bx)
    for (int by = 0; by < (Y + kBoxTileY - 1) / kBoxTileY; ++by)
      for (int bz = 0; bz < (Z + kBoxTileZ - 1) / kBoxTileZ; ++bz)
        for (int ty = 0; ty < kBoxTileY; ++ty)
          for (int tz = 0; tz < kBoxTileZ; ++tz)
            box_apply_thread(load, LoadF32{w}, store, bz, by, bx, tz, ty,
                             rows, X, Y, Z);
}
extern "C" void box_apply_f32(const float* u, const float* w, float* y, int X,
                              int Y, int Z, int rows, int* count) {
  run(LoadF32{u}, w, StoreF32{y, count}, X, Y, Z, rows);
}
extern "C" void box_apply_bf16(const uint16_t* u, const float* w, uint16_t* y,
                               int X, int Y, int Z, int rows, int* count) {
  run(LoadBF16{u}, w, StoreBF16{y, count}, X, Y, Z, rows);
}
extern "C" void box_dirs(int* out) {
  for (int s = 0; s < kBoxDirs; ++s)
    for (int a = 0; a < 3; ++a) out[3 * s + a] = box_dir(s, a);
}
"""


@pytest.fixture(scope="module")
def host_box_kernel(tmp_path_factory):
    """B1's per-point functions (csrc/box_stencil.cuh) built with the host
    C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_box_kernel")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_box.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.box_apply_f32, lib.box_apply_bf16):
        fn.argtypes = [P, P, P, I, I, I, I, P]
    lib.box_dirs.argtypes = [P]
    return lib


def test_kernel_directions_match_kuhn(host_box_kernel):
    out = np.zeros((15, 3), dtype=np.int32)
    host_box_kernel.box_dirs(out.ctypes.data)
    np.testing.assert_array_equal(out, tkuhn.stencil_dirs())


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("m,ext,level", APPLY_CASES + [((1, 2, 3), (1.0, 1.0, 1.0), 1)])
def test_kernel_point_math_matches_plain(host_box_kernel, m, ext, level, form):
    _, _, td, to = _ops(m, ext, level, form)
    X, Y, Z = td.dims
    w = to.w_vecs.contiguous()
    u = torch.tensor(_rand(td.block_shape, 40 + level))
    ref = tk.box_apply_torch(u, w, td.dims)
    out = torch.empty_like(u)
    host_box_kernel.box_apply_f32(u.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  X, Y, Z, 0, None)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()

    ub = u.to(torch.bfloat16)
    ref = tk.box_apply_torch(ub, w, td.dims).to(torch.float32)
    out = torch.empty_like(ub)
    host_box_kernel.box_apply_bf16(ub.data_ptr(), w.data_ptr(),
                                   out.data_ptr(), X, Y, Z, 0, None)
    err = (out.to(torch.float32) - ref).abs().max().item()
    assert err <= BF16_ULP * ref.abs().max().item()


@pytest.mark.parametrize("rows", [0, 5])
@pytest.mark.parametrize("m", [(1, 2, 3), (2, 1, 1), (2, 2, 2)])
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_kernel_walk_writes_every_node_once(host_box_kernel, level, m, rows):
    """Kernel B1's thread blocks (tiles of 32 z x 8 y lanes, chunks of the
    kernel's rows (rows = 0: 64 at these sizes) or of 5, so that chunks
    start past row 0 at every level) at box levels 1-4 on m = (1, 2, 3),
    (2, 1, 1), (2, 2, 2): X, Y and Z are multiples of no tile. Every node
    is written exactly once; f32 matches the plain version to 1e-5 of
    max|y|, bf16 within one bf16 ulp per element (chip_smoke.py's gate).
    Random weights, all 15 nonzero at every lane (the operators' own have
    exact zeros that would hide a wrong read), and a random source."""
    td = BoxDomain(m, level, device="cpu")
    X, Y, Z = td.dims
    w = torch.tensor(_rand((3, 15, Y * Z), 70 + level))
    u = torch.tensor(_rand(td.block_shape, 60 + level))
    ref = tk.box_apply_torch(u, w, td.dims)
    out = torch.full_like(u, float("nan"))
    count = torch.zeros(u.shape, dtype=torch.int32)
    host_box_kernel.box_apply_f32(u.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  X, Y, Z, rows, count.data_ptr())
    assert (count == 1).all()
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= 1e-5 * scale

    ub = u.to(torch.bfloat16)
    ref_b = tk.box_apply_torch(ub, w, td.dims)
    out_b = torch.full_like(ub, float("nan"))
    count.zero_()
    host_box_kernel.box_apply_bf16(ub.data_ptr(), w.data_ptr(),
                                   out_b.data_ptr(), X, Y, Z, rows,
                                   count.data_ptr())
    assert (count == 1).all()
    assert bf16_ulp_excess(out_b, ref_b, scale) <= 1.0
