"""The bf16 2D P1 path of the PyTorch port against the JAX package: kernel
B2's and B3's 2D bf16 forms (their plain versions here; the kernels'
walks compiled with the host C++ compiler, bf16 emulated), the parts of
the bf16 P1 V-cycle on 2D storage held one by one against the JAX
package's (apply, inverse diagonal, one Chebyshev step, restriction and
prolongation), an f32 iterative refinement around the port's whole bf16
cycle, the dtype contract of B3 and B4 (their bf16 forms with a
coefficient and the rounding of f32 inputs), and ROADMAP C-ref13: the JAX
package's bf16 P1 transfers return float32, so its bf16 P1 V-cycle
cannot run (and no whole-cycle comparison exists).

The JAX side runs as its own CPU tests run it: ``p1_const_apply_xla``,
the Pallas kernel in interpret mode, its operators' plain diagonals.

Tolerances (BF16_ULP = 2^-7, one bf16 ulp of a value at most):
- bf16 results within one bf16 ulp of the f32 result of the same bf16
  values (``ulp_excess`` <= 1, tests/test_torch_mixed_precision.py);
- against the JAX package's bf16 applies and diagonals, which accumulate
  in bf16 (C-ref11), and its bf16 tables, summed in bf16 (C-ref12):
  (XLA_BOUND + TABLE_ULPS 2^-7) = 20 2^-8 of the terms' magnitudes;
- inverse diagonals: within 2 bf16 ulps (the diagonal's gap, then one
  rounding of 1 / d);
- one Chebyshev step and the transfers: each entry within STEP_TERMS 2^-8
  of its terms' magnitudes (the port's transfers add in bf16, the JAX
  package's in f32, then rounded once here);
- refinement: within 2x the f32 stack's own plateau and below 0.1x the
  bf16-only loop (tests/test_torch_mixed_precision.py's gates).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import BoundaryCondition as JBC
from hyteg_tpu.core.types import FLAG_INNER as JINNER
from hyteg_tpu.functions.p1 import P1Space as JP1Space
from hyteg_tpu.kernels import p1_const_stencil as jk
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators import p1_elementwise as jop
from hyteg_tpu.operators.transfer import P1Transfer as JP1Transfer
from hyteg_tpu.primitives.storage import CellStorage as JCellStorage
from hyteg_tpu.solvers.smoothers import chebyshev_smooth as j_chebyshev
from hyteg_tpu.solvers.templates import make_p1_gmg as jmake_p1_gmg
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType, FLAG_INNER
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.kernels import p1_const_stencil as tk
from hyteg_tpu_torch.kernels import p1_stencil as tk3
from hyteg_tpu_torch.mesh import meshinfo as mi
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.operators.transfer import P1Transfer
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.refinement import iterative_refinement
from hyteg_tpu_torch.solvers.smoothers import chebyshev_smooth
from hyteg_tpu_torch.solvers.templates import make_p1_gmg

from tests.test_torch_bf16_p2 import build_host_bf16
from tests.test_torch_mixed_precision import (BF16_ULP, CANCEL, XLA_BOUND,
                                              round_bf16, ulp_excess)

torch.set_num_threads(1)

bf16 = torch.bfloat16
TABLE_ULPS = 2
STEP_TERMS = 8
FORMS = {"laplace": (jforms.laplace_form, forms.laplace_form),
         "mass": (jforms.mass_form, forms.mass_form)}
RECT = {"nx": 2, "ny": 2}


@pytest.fixture(scope="module")
def host_bf16(tmp_path_factory):
    return build_host_bf16(tmp_path_factory)


def _storages():
    return (JCellStorage(jmi.mesh_rectangle(**RECT), num_shards=1),
            CellStorage(mi.mesh_rectangle(**RECT)))


def _ops(level, form, storage=None):
    """The port's bf16 and f32 2D spaces and operators."""
    st = storage or _storages()[1]
    sp16 = P1Space(st, level, device="cpu", dtype=bf16)
    sp32 = P1Space(st, level, device="cpu")
    return (sp16, P1ElementwiseOperator(sp16, FORMS[form][1]),
            P1ElementwiseOperator(sp32, FORMS[form][1]))


def _source(sp, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(sp.block_shape, generator=g) * sp.vertex_mask_t.float()
    return sp.exchange_rep(x).to(bf16)


def _abs_apply(x, elmats, level):
    """The terms' magnitudes of the 2D apply: the elementwise apply of
    |elMat| to |x|, in f32."""
    return tk3.p1_apply_local_torch(x.float().abs(), elmats.float().abs(),
                                    level, 2, 0)


# ---------------------------------------------------------------------------
# the kernels' walks, compiled for the host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("level", [1, 2, 3, 5, 6])
def test_host_b2_b3_2d_bf16_walks(host_bf16, level, form):
    """Kernel B2's and B3's 2D bf16 walks (all thread blocks) on a bf16
    operator's tables: every slot written once, every quad at an 8-byte
    boundary (rows of odd width alternate their alignment), 0 outside the
    triangle, within one bf16 ulp of the f32 result of the same bf16
    values and of the plain bf16 versions; B3 plain and (mass) lumped."""
    sp, op, _ = _ops(level, form)
    A, E, elm = op.stencil, op.stencil_face, op.elmats
    C, N = sp.block_shape[0], sp.N
    src = _source(sp, 50 + level)
    outside = ~sp.vertex_mask_t.bool()
    dst = torch.full_like(src, float("nan"))
    count = torch.zeros(src.shape, dtype=torch.int32)
    _, gmask = tk._kernel_tables(2)
    assert host_bf16.b2_2d_bf16(src.data_ptr(), A.data_ptr(), E.data_ptr(),
                                dst.data_ptr(), C, N, gmask.ctypes.data,
                                count.data_ptr()) == 0
    assert (count == 1).all() and (dst[:, outside] == 0).all()
    exact = tk.p1_const_apply_torch(src.float(), A.float(), level, 2, N,
                                    E=E.float())
    assert ulp_excess(dst, exact.numpy()) <= 1.0
    plain = tk.p1_const_apply(src, A, E, level, 2, N)
    assert ulp_excess(dst, plain.float().numpy()) <= 1.0
    # a Laplace row sums to 0: the lumped form only for the mass
    for lumped in ((False, True) if form == "mass" else (False,)):
        dst = torch.full_like(src, float("nan"))
        count.zero_()
        assert host_bf16.b3_2d_bf16(elm.data_ptr(), dst.data_ptr(), C, N,
                                    int(lumped), count.data_ptr()) == 0
        assert (count == 1).all() and (dst[:, outside] == 0).all()
        exact = tk3.p1_diagonal_local_torch(elm.float(), level, 2, N, lumped)
        assert ulp_excess(dst, exact.numpy()) <= 1.0
        plain = tk3.p1_diagonal_local(elm, level, 2, N, lumped)
        assert plain.dtype == bf16
        assert ulp_excess(dst, plain.float().numpy()) <= 1.0


# ---------------------------------------------------------------------------
# B2-2D and B3-2D plain bf16 against the JAX package's 2D forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("level", [2, 4])
def test_b2_b3_2d_plain_bf16_vs_jax(level, form):
    """On the same bf16 source and bf16 tables (f32 element matrices
    rounded once): the port's plain B2-2D within one bf16 ulp of the JAX
    package's f32 apply of those values, and within 20 2^-8 of the terms
    of its bf16 apply (C-ref11) and of its Pallas kernel in interpret
    mode on bf16; B3-2D (plain and lumped) within one ulp of the JAX
    package's f32 diagonal of the same bf16 matrices and within 20 2^-8
    of its bf16 one (lumped: the mass). f32 tables with a bf16 source:
    the same result."""
    jst, tst = _storages()
    jsp = JP1Space(jst, level)
    sp16, _, o32 = _ops(level, form, tst)
    elm = round_bf16(o32.elmats.numpy())
    et = torch.as_tensor(elm)
    A = round_bf16(tk.stencil_weights(et, 2).numpy())
    E = round_bf16(tk.face_weights_full(et, 2).numpy())
    xb = round_bf16(_source(sp16, 60 + level).float().numpy())
    x = torch.as_tensor(xb).to(bf16)
    At, Et = torch.as_tensor(A), torch.as_tensor(E)
    got = tk.p1_const_apply(x, At.to(bf16), Et.to(bf16), level, 2, sp16.pitch)
    assert got.dtype == bf16
    assert torch.equal(tk.p1_const_apply(x, At, Et, level, 2, sp16.pitch), got)
    f32 = np.asarray(jk.p1_const_apply_xla(jnp.asarray(xb), jnp.asarray(A),
                                           level, 2, jsp.pitch,
                                           E=jnp.asarray(E)))
    assert ulp_excess(got, round_bf16(f32)) <= 1.0
    bound = (XLA_BOUND + TABLE_ULPS * BF16_ULP) * _abs_apply(
        x, et, level).numpy()
    j16 = lambda a: jnp.asarray(a, dtype=jnp.bfloat16)
    for ref in (jk.p1_const_apply_xla(j16(xb), j16(A), level, 2, jsp.pitch,
                                      E=j16(E)),
                jk.p1_const_apply_pallas(j16(xb), j16(A), j16(E), level, 2,
                                         jsp.pitch, interpret=True)):
        ref = np.asarray(ref.astype(jnp.float32))
        assert (np.abs(got.float().numpy() - ref) <= bound).all()
    for lumped in ((False, True) if form == "mass" else (False,)):
        fn = jop.p1_lumped_local if lumped else jop.p1_diagonal_local
        d = tk3.p1_diagonal_local(et.to(bf16), level, 2, sp16.pitch, lumped)
        assert d.dtype == bf16
        ref = np.asarray(fn(jnp.asarray(elm), level, 2, jsp.block_shape,
                            jsp.pitch))
        assert ulp_excess(d, round_bf16(ref)) <= 1.0
        ref16 = np.asarray(fn(j16(elm), level, 2, jsp.block_shape,
                              jsp.pitch).astype(jnp.float32))
        terms = tk3.p1_diagonal_local_torch(et.abs(), level, 2, sp16.pitch,
                                            lumped) if not lumped else \
            tk3.p1_apply_local_torch(torch.ones(sp16.block_shape)
                                     * sp16.vertex_mask_t.float(), et.abs(),
                                     level, 2, 0)
        assert (np.abs(d.float().numpy() - ref16)
                <= XLA_BOUND * terms.numpy() + CANCEL).all()


# ---------------------------------------------------------------------------
# the bf16 2D P1 V-cycle, part by part (the JAX package runs no whole
# bf16 P1 cycle: C-ref13)
# ---------------------------------------------------------------------------

LEVEL = 3


@pytest.fixture(scope="module")
def parts():
    """Both packages' bf16 spaces, Laplace operators and transfers at
    levels LEVEL - 1 and LEVEL, and a seeded consistent bf16 block."""
    jst, tst = _storages()
    bc = JBC.all_dirichlet()
    out = {}
    for lv in (LEVEL - 1, LEVEL):
        jsp = JP1Space(jst, lv, dtype=jnp.bfloat16)
        sp = P1Space(tst, lv, device="cpu", dtype=bf16)
        out[lv] = (jsp, jsp.resolve_sd(bc), jop.P1ElementwiseOperator(
            jsp, jforms.laplace_form), sp, sp.resolve_sd(
            BoundaryCondition.all_dirichlet()), P1ElementwiseOperator(
            sp, forms.laplace_form))
    jt = JP1Transfer(out[LEVEL - 1][0], out[LEVEL][0])
    tt = P1Transfer(out[LEVEL - 1][3], out[LEVEL][3])
    x = _source(out[LEVEL][3], 70)
    return out, jt, tt, x


def _jnp(t):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _np(a):
    return interop.host_array(a)


def test_bf16_2d_apply_and_inverse_diagonal_vs_jax(parts):
    """The bf16 2D operator's apply within 20 2^-8 of its terms of the JAX
    package's bf16 apply (C-ref11, C-ref12); its inverse diagonal within 2
    bf16 ulps of the JAX package's."""
    out, _, _, x = parts
    jsp, jsd, jo, sp, sd, op = out[LEVEL]
    y = op.apply_raw(x, sd=sd)
    assert y.dtype == bf16
    yj = _np(jo.apply_raw(_jnp(x), sd=jsd))
    terms = sp.exchange_add(_abs_apply(x, op.elmats, LEVEL), sd).numpy()
    bound = (XLA_BOUND + TABLE_ULPS * BF16_ULP) * terms
    assert (np.abs(y.float().numpy() - yj) <= bound).all()
    inv = op.inverse_diagonal(sd=sd)
    assert inv.dtype == bf16
    invj = _np(jo.inverse_diagonal(sd=jsd))
    assert (np.abs(inv.float().numpy() - invj)
            <= 2 * BF16_ULP * np.abs(invj)).all()


def test_bf16_2d_chebyshev_step_vs_jax(parts):
    """One Chebyshev step (order 4, as make_p1_gmg's) of each package on
    its own bf16 operator, from the same bf16 x and rhs b: within
    STEP_TERMS 2^-8 of the step's terms, |x| + |D^-1| (|b| + |A||x|)
    scaled by the polynomial's coefficient sum, entry by entry."""
    out, _, _, x = parts
    jsp, jsd, jo, sp, sd, op = out[LEVEL]
    b = _source(sp, 71)
    eig = 2.0
    inv = op.inverse_diagonal(sd=sd)
    invj = jo.inverse_diagonal(sd=jsd)
    ap = lambda v: op.apply_inner(v, sd, FLAG_INNER)
    zj = jsp.zeros()
    apj = lambda v: jsp.restore_rows(jo.apply_raw(v, sd=jsd), zj, JINNER,
                                     jsd)
    got = chebyshev_smooth(ap, inv, b, x, eig, order=4)
    assert got.dtype == bf16
    ref = _np(j_chebyshev(apj, invj, _jnp(b), _jnp(x), eig, order=4))
    terms = (x.float().abs() + inv.float().abs() * (
        b.float().abs() + sp.exchange_add(_abs_apply(x, op.elmats, LEVEL),
                                          sd))).numpy()
    assert (np.abs(got.float().numpy() - ref)
            <= STEP_TERMS * 2.0 ** -8 * terms + CANCEL).all()


def test_bf16_2d_transfers_vs_jax(parts):
    """Restriction and prolongation of bf16 blocks: the port's stay bf16;
    the JAX package's return float32 (C-ref13), rounded to bf16 here; each
    entry within STEP_TERMS 2^-8 of its terms (the transfer of |u|)."""
    out, jt, tt, x = parts
    jspc, jsdc, _, spc, sdc, _ = out[LEVEL - 1]
    _, jsdf, _, spf, sdf, _ = out[LEVEL]
    rc = tt.restrict(x, sdf, sdc)
    assert rc.dtype == bf16
    ref = round_bf16(_np(jt.restrict(_jnp(x), jsdf, jsdc)))
    terms = _f32_transfer(tt, "restrict", x.abs())
    assert (np.abs(rc.float().numpy() - ref)
            <= STEP_TERMS * 2.0 ** -8 * terms + CANCEL).all()
    xc = _source(spc, 72)
    pf = tt.prolongate(xc)
    assert pf.dtype == bf16
    ref = round_bf16(_np(jt.prolongate(_jnp(xc))))
    terms = _f32_transfer(tt, "prolongate", xc.abs())
    assert (np.abs(pf.float().numpy() - ref)
            <= STEP_TERMS * 2.0 ** -8 * terms + CANCEL).all()


def _f32_transfer(tt, name, u):
    """The f32 transfer of |u| on f32 copies of the same levels: the
    terms' magnitudes of each entry."""
    f32 = P1Transfer(P1Space(tt.coarse.storage, tt.coarse.level,
                             device="cpu"),
                     P1Space(tt.fine.storage, tt.fine.level, device="cpu"))
    return getattr(f32, name)(u.float()).numpy()


def test_jax_bf16_p1_cycle_cannot_run():
    """ROADMAP C-ref13: the JAX package's bf16 P1 transfers multiply by
    float32 one-hot matrices (hyteg_tpu/operators/transfer.py:45-46,
    140-168), so restrict and prolongate return float32 for a bf16 block,
    and its bf16 P1 V-cycle raises in the smoother's scan
    (hyteg_tpu/solvers/gmg.py:78): carry input bfloat16, output float32.
    The port's transfers keep bf16 (test_bf16_2d_transfers_vs_jax)."""
    jst, _ = _storages()
    # eigs= skips the power iterations: the cycle raises before it uses them
    jstack = jmake_p1_gmg(jst, 0, 1, dtype=jnp.bfloat16, coarse_iters=5,
                          eigs={0: 2.0, 1: 2.0})
    jsp = jstack.spaces[1]
    r = jnp.zeros(jsp.block_shape, jnp.bfloat16)
    assert jstack.transfers[1].restrict(r).dtype == jnp.float32
    rc = jnp.zeros(jstack.spaces[0].block_shape, jnp.bfloat16)
    assert jstack.transfers[1].prolongate(rc).dtype == jnp.float32
    with pytest.raises(TypeError, match="carry"):
        jstack.gmg.cycle(r, r)


# ---------------------------------------------------------------------------
# the whole bf16 2D P1 cycle under f32 iterative refinement
# ---------------------------------------------------------------------------


def test_refinement_around_a_bf16_2d_p1_vcycle():
    """The card's mixed_precision_2d at a CPU size: an f32 outer loop
    around one V(3,3) cycle of make_p1_gmg(dtype=bf16) on 2D storage
    (bf16 B2-2D, B3-2D, transfers and Chebyshev) on sin(pi x) sin(pi y)
    reaches within 2x of the f32 stack's own plateau and below 0.1x the
    bf16-only loop; the bf16 stack's diagonals and blocks are bf16. (On
    the card the scheme reaches the plateau up to rect(4, 4) P1 level 8;
    above, the bf16 rounding of the correction and the residual, grown
    with the condition number, stops it: chip_smoke.py's MP_GATE_2D.)"""
    st = CellStorage(mi.mesh_rectangle(**RECT))
    s32 = make_p1_gmg(st, 0, 4, device="cpu")
    s16 = make_p1_gmg(st, 0, 4, device="cpu", dtype=bf16)
    assert s16.space().dtype == bf16
    assert all(d.dtype == bf16 for d in s16.inv_diags.values())
    sp, sd = s32.space(), s32.sd()
    U = lambda p: torch.sin(math.pi * p[..., 0]) * torch.sin(math.pi * p[..., 1])
    bc = BoundaryCondition.all_dirichlet()
    mass = P1ElementwiseOperator(sp, forms.mass_form)
    f = sp.interpolate(lambda p: 2 * math.pi ** 2 * U(p), sp.zeros(),
                       DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), FLAG_INNER, bc)
    r0 = float(s32.residual_norm(sp.zeros(), b))
    x = sp.zeros()
    res = []
    for _ in range(10):
        x = s32.gmg.cycle(x, b)
        res.append(float(s32.residual_norm(x, b)))
    plateau = sum(res[-3:]) / 3
    inner = lambda r: s16.gmg.cycle(s16.space().zeros(), r)
    apply_hi = lambda v: s32.operators[4].apply_inner(v, sd, FLAG_INNER)
    xr = iterative_refinement(apply_hi, inner, b, sp.zeros(), 10)
    rel = float(s32.residual_norm(xr, b))
    x16, b16 = s16.space().zeros(), b.to(bf16)
    for _ in range(10):
        x16 = x16 + inner(s16.residual(x16, b16))
        assert x16.dtype == bf16
    rel16 = float(s32.residual_norm(x16.float(), b))
    assert rel <= 2 * plateau and rel < 0.1 * rel16, (rel, plateau, rel16, r0)


# ---------------------------------------------------------------------------
# the dtype contract of B3 and B4, the same on every device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
def test_bf16_refusals_on_the_cpu(dim):
    """The dtype contract of B3 and B4 on the CPU, as the card's
    bf16_refusals phase checks it (kernels/p1_const_stencil.py::
    bf16_weights): the calls refused before their bf16 forms were ported
    now run on a bf16 block and give, bit for bit, what their inputs
    rounded to bf16 give: B3 with bf16 element matrices and an f32
    coefficient, B4 on a bf16 source with f32 element matrices or an f32
    coefficient. A bf16 input beside an f32 block still raises (B3 with
    f32 element matrices and a bf16 coefficient; B4 on an f32 source with
    bf16 element matrices or a bf16 coefficient), and no source is cast.
    B3 without a coefficient runs, and the operator's coefficient apply
    stays bf16."""
    st = (CellStorage(mi.mesh_rectangle(**RECT)) if dim == 2
          else CellStorage(mi.mesh_unit_cube(1)))
    sp = P1Space(st, 2, device="cpu", dtype=bf16)
    op = P1ElementwiseOperator(sp, forms.laplace_form)
    x = _source(sp, 80)
    e32, x32 = op.elmats.float(), x.float()
    k32 = x32.abs() + sp.vertex_mask_t.float()  # a positive coefficient
    k16 = k32.to(bf16)
    args = (2, dim, sp.pitch)
    rounded = {
        "b3 bf16 elmats, f32 coefficient": (
            lambda: tk3.p1_diagonal_local(op.elmats, *args, False, k32),
            lambda: tk3.p1_diagonal_local(op.elmats, *args, False, k16)),
        "b4 bf16 source, f32 elmats": (
            lambda: tk3.p1_apply_local(x, e32, *args),
            lambda: tk3.p1_apply_local(x, op.elmats, *args)),
        "b4 bf16 source, f32 coefficient": (
            lambda: tk3.p1_apply_local(x, op.elmats, *args, k32),
            lambda: tk3.p1_apply_local(x, op.elmats, *args, k16)),
    }
    for name, (got, want) in rounded.items():
        y = got()
        assert y.dtype == bf16 and torch.equal(y, want()), name
    refused = {
        "b3 f32 elmats, bf16 coefficient": lambda: tk3.p1_diagonal_local(
            e32, *args, False, k16),
        "b4 bf16 elmats": lambda: tk3.p1_apply_local(x32, op.elmats, *args),
        "b4 bf16 coefficient": lambda: tk3.p1_apply_local(x32, e32, *args,
                                                          k16),
    }
    for name, call in refused.items():
        with pytest.raises(ValueError, match="bf16"):
            call()
    d = tk3.p1_diagonal_local(op.elmats, *args)
    assert d.dtype == bf16 and d.shape == tuple(sp.block_shape)
    assert op.apply_raw(x, coeff=k16).dtype == bf16
