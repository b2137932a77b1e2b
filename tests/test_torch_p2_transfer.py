"""The P2 quadratic transfers of the PyTorch port (operators/p2_transfer.py)
against the JAX package on identical blocks: prolongation, restriction,
exactness on quadratics and restriction as the transpose of
prolongation.

Tolerances: 1e-6 * max of the result (f32 sums of up to 35 terms taken
in another order, and the port averages shared fine nodes where the JAX
package overwrites them); the adjoint identity to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.operators.p2_transfer import P2Transfer as JP2Transfer
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.operators.p2_transfer import P2Transfer

from tests.test_torch_const_stencil import _assert_close
from tests.test_torch_p2 import _block, _spaces

torch.set_num_threads(1)

TRANSFER_CASES = [("cube1", 0, None), ("cube1", 1, None), ("cube1", 1, 17),
                  ("tet", 1, None)]


@pytest.mark.parametrize("name,clevel,pitch", TRANSFER_CASES)
def test_transfers_match(name, clevel, pitch):
    jc, tc = _spaces(name, clevel, pitch)
    jf, tf = _spaces(name, clevel + 1, pitch)
    jt, tt = JP2Transfer(jc, jf), P2Transfer(tc, tf)
    uc = np.asarray(jc.exchange_rep(jnp.asarray(_block(jc, 40))))
    ref = np.asarray(jt.prolongate_local(jnp.asarray(uc)))
    _assert_close(tt.prolongate(interop.block_from_reference(uc, device="cpu")), ref,
                  np.abs(ref).max(), 1e-6)
    rf = _block(jf, 41)
    ref = np.asarray(jt.restrict(jnp.asarray(rf)))
    _assert_close(tt.restrict(interop.block_from_reference(rf, device="cpu")), ref,
                  np.abs(ref).max(), 1e-6)


def test_prolongation_exact_on_quadratics():
    _, tc = _spaces("cube1", 1, None)
    _, tf = _spaces("cube1", 2, None)
    Q = lambda p: (1.0 + 2 * p[..., 0] - p[..., 1] + 0.5 * p[..., 0] * p[..., 1]
                   + p[..., 0] ** 2 - 0.3 * p[..., 1] ** 2
                   + 0.1 * p[..., 2] * p[..., 0])
    uf = P2Transfer(tc, tf).prolongate(tc.function().interpolate(Q).cells)
    assert (uf - tf.function().interpolate(Q).cells).abs().max() < 5e-5


def test_restriction_is_transpose():
    """<P uc, rf> == <uc, R rf> over global DoF vectors (the JAX space's
    global ids: both packages lay the blocks out alike)."""
    jc, tc = _spaces("cube1", 1, None)
    jf, tf = _spaces("cube1", 2, None)
    tr = P2Transfer(tc, tf)

    def to_blocks(jsp, vec):
        gids = jsp.global_ids(0)
        out = np.zeros(jsp.block_shape, dtype=np.float32)
        out[gids >= 0] = vec[gids[gids >= 0]]
        return torch.tensor(out)

    def from_blocks(jsp, blocks):
        gids = jsp.global_ids(0)
        vec = np.zeros(jsp.num_global_dofs())
        vec[gids[gids >= 0]] = interop.block_to_numpy(blocks)[gids >= 0]
        return vec

    rng = np.random.default_rng(5)
    for _ in range(3):
        uc = rng.standard_normal(jc.num_global_dofs())
        rf = rng.standard_normal(jf.num_global_dofs())
        lhs = np.dot(from_blocks(jf, tr.prolongate(to_blocks(jc, uc))), rf)
        rhs = np.dot(uc, from_blocks(jc, tr.restrict(to_blocks(jf, rf))))
        assert np.isclose(lhs, rhs, rtol=1e-5), (lhs, rhs)
