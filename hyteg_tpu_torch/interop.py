"""Carry state over from the JAX package (hyteg_tpu) as numpy arrays.

Both packages lay a P1 block out as (C, N, N*pitch) ((C, N, N) on 2D
macro-faces), a P2 block (on the level-(L+1) node grid) as (C, M, M*pitch)
((C, M, M) in 2D) and a box block as (X, Y*Z), with the same lane maps, so
no conversion repacks: these functions only
change the array type, dtype and device, and copy (an array read from JAX
is read-only).
They let a test run both packages on identical operators (element
matrices, eigenvalue bounds) and identical states. ``device`` is a
required keyword of every function that carries state across: a caller
that builds a CUDA space gets its weights on the card, never silently on
the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def host_array(a) -> np.ndarray:
    """A reference array as numpy. bf16 (numpy has none: the JAX package
    hands it over as ml_dtypes' bfloat16, which torch cannot read) comes as
    its float32 values, which hold every bf16 value exactly; rounding them
    back to bf16 gives the same bits."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def elmats_from_reference(elmats: np.ndarray, *, device,
                          dtype=torch.float32) -> torch.Tensor:
    """(C, 6, 4, 4) P1 or (C, 6, 10, 10) P2 element matrices (2D: (C, 2,
    3, 3) or (C, 2, 6, 6)) -> tensor for
    ``P1ElementwiseOperator(space, form, elmats=...)``,
    ``P2ElementwiseOperator(space, kind, elmats=...)``, or
    ``make_p1_gmg`` / ``make_p2_gmg(..., elmats={level: ...})``. bf16
    matrices (a bf16 operator's ``elmats``) cross as ``host_array`` says;
    with ``dtype=torch.bfloat16`` they keep their bits."""
    return torch.tensor(host_array(elmats), dtype=dtype, device=device)


def block_from_reference(block: np.ndarray, *, device,
                         dtype=torch.float32) -> torch.Tensor:
    """A (C, N, N*pitch) P1 or (C, M, M*pitch) P2 block ((C, N, N) or
    (C, M, M) in 2D; a state, or a nodal coefficient field) -> tensor on
    ``device``; a bf16 block as ``host_array`` says."""
    return torch.tensor(host_array(block), dtype=dtype, device=device)


def eigs_from_reference(eigs: dict) -> dict:
    """A level -> lambda_max(D^-1 A) bound dict (the JAX package's
    power-iteration or Fourier bounds, any scalar type, bf16 included) ->
    Python floats for ``make_p1_gmg`` / ``make_p2_gmg(..., eigs=...)``."""
    return {int(l): float(host_array(v)) for l, v in eigs.items()}


def p2_tables_from_reference(A, E, *, device,
                             dtype=torch.float32) -> torch.Tensor:
    """A JAX ``P2ElementwiseOperator``'s tables ``stencil`` (C, n_par,
    n_s, 3) and ``stencil_face`` (C, n_g, n_par, n_s, 3) -> the folded rows
    W (C, rows, n_s) that kernel B5 reads, folded in f32 from their values
    (bf16 ones exactly) and rounded to ``dtype`` once."""
    from .kernels.p2_const_stencil import p2_folded_weights

    t = lambda a: torch.tensor(host_array(a), dtype=torch.float32,
                               device=device)
    return p2_folded_weights(t(A), t(E)).to(dtype)


def block_to_numpy(block: torch.Tensor) -> np.ndarray:
    """A P1, P2 or box block tensor -> numpy on the host (bf16 as f32, which
    numpy lacks)."""
    block = block.detach().cpu()
    if block.dtype == torch.bfloat16:
        block = block.to(torch.float32)
    return block.numpy()


def box_block_from_reference(block: np.ndarray, *, device,
                             dtype=torch.float32) -> torch.Tensor:
    """An (X, Y*Z) BoxDomain block -> tensor on ``device``. Both packages
    use lane = y*Z + z, so nothing is repacked."""
    return torch.tensor(np.asarray(block, dtype=np.float32), dtype=dtype,
                        device=device)


def pair_weights_from_reference(W: np.ndarray, *, device) -> torch.Tensor:
    """(Cp, 120, 7) paired-tet coefficient matrices (the JAX package's
    ``tetpair.plan.weight_matrix``) -> f32 tensor for ``pair_apply``."""
    return torch.tensor(np.asarray(W, dtype=np.float32), dtype=torch.float32,
                        device=device)


def pair_state_from_reference(u, xf, yf, zf, df, *, device):
    """The five arrays of a JAX ``tetpair.engine.PairState`` -> the port's
    ``PairState`` (same layouts: blocks (Cp, N, L), faces (Cp, 2, L),
    (Cp, 2, N, P), (Cp, 2, N, N), (Cp, 2, L))."""
    from .tetpair.engine import PairState

    return PairState(*(torch.tensor(np.asarray(a, dtype=np.float32),
                                    dtype=torch.float32, device=device)
                       for a in (u, xf, yf, zf, df)))


def lane_weights_from_reference(w_vecs: np.ndarray, *, device) -> torch.Tensor:
    """(3, 15, Y*Z) box lane-weight vectors -> f32 tensor for
    ``box_apply`` (the kernel takes f32 weights whatever the block dtype)."""
    return torch.tensor(np.asarray(w_vecs, dtype=np.float32),
                        dtype=torch.float32, device=device)


STOKES_ELMATS = ("laplace", "div", "p1_mass", "epsilon")


def stokes_elmats_from_reference(arrays: dict, *, device,
                                 dtype=torch.float32) -> dict:
    """The element matrices of a JAX ``P2P1TaylorHoodStokes`` as numpy, by
    name: "laplace" (C, T, nn, nn) (``K.elmats``), "div" (C, T, nv, nn,
    dim) (``B.elmats``), "p1_mass" (C, T, nv, nv) (the pressure mass
    operator's), "epsilon" (C, T, dim, dim, nn, nn) (``K_eps.elmats``);
    any subset -> tensors for ``P2P1TaylorHoodStokes(..., elmats=...)`` or
    ``make_stokes_gmg(..., elmats={level: ...})``."""
    unknown = set(arrays) - set(STOKES_ELMATS)
    if unknown:
        raise ValueError(f"unknown Stokes element matrices {sorted(unknown)}")
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in arrays.items()}


def taylor_hood_from_reference(vel, pre, *, device, dtype=torch.float32):
    """A JAX ``TaylorHoodVec``'s arrays (``vel``: a sequence of dim
    (C, M, M*pitch) blocks, ``pre``: (C, N, N*pitch); 2D blocks square)
    -> the port's TaylorHoodVec, its velocity one (dim, C, M, lanes)
    block."""
    from .composites.stokes import TaylorHoodVec

    return TaylorHoodVec(
        torch.tensor(np.stack([np.asarray(v) for v in vel]), dtype=dtype,
                     device=device),
        torch.tensor(np.asarray(pre), dtype=dtype, device=device))


def taylor_hood_to_numpy(x) -> tuple:
    """The port's TaylorHoodVec -> (tuple of dim velocity blocks, pressure
    block) as numpy on the host."""
    return (tuple(block_to_numpy(v) for v in x.vel.unbind(0)),
            block_to_numpy(x.pre))


def surrogate_from_reference(space, coeffs, mono_fields, degree: int, *,
                             device, dtype=torch.float32):
    """A JAX ``P1SurrogateOperator``'s fitted ``_coeffs`` (a sequence per
    class of (C, n_mono, nv, nv)) and ``_mono_fields`` ((n_mono, N,
    lanes)) as numpy -> the port's P1SurrogateOperator on ``space`` with
    the same polynomials (no fit), its tables on ``device`` (the space's)."""
    from .operators.p1_blended import P1SurrogateOperator

    return P1SurrogateOperator(
        space, None, None, degree,
        coeffs=[torch.tensor(np.asarray(c), dtype=dtype, device=device)
                for c in coeffs],
        mono_fields=torch.tensor(np.asarray(mono_fields), dtype=dtype,
                                 device=device))


def convection_state_from_reference(T, vel, pre, time: float, step: int, *,
                                    device, dtype=torch.float32):
    """A JAX ``ConvectionSimulation``'s state as numpy (``T``: the P2 block
    ``sim.T``; ``vel``, ``pre``: the arrays of ``sim.x``; ``time``,
    ``step``: ``sim.time``, ``sim.step_count``) -> the port's
    ConvectionState, to set with ``sim.state = ...`` so that both simulations
    step on from the same state."""
    from .terraneo.simulation import ConvectionState

    return ConvectionState(
        T=torch.tensor(np.asarray(T), dtype=dtype, device=device),
        x=taylor_hood_from_reference(vel, pre, device=device, dtype=dtype),
        time=float(time), step_count=int(step))


def shards_from_reference(block: np.ndarray, num_shards: int, *, device,
                          dtype=torch.float32) -> list:
    """A sharded JAX array, shard-major (D * C_loc, N, lanes) with each
    shard's padding cells at the end of its range, -> the port's
    per-shard blocks [(C_loc, N, lanes)] * D (parallel/spmd.py)."""
    a = np.asarray(block)
    if a.shape[0] % num_shards:
        raise ValueError(f"{a.shape[0]} cells do not split into "
                         f"{num_shards} shards")
    return [torch.tensor(p, dtype=dtype, device=device)
            for p in np.split(a, num_shards, axis=0)]


def shards_to_reference(parts: list) -> np.ndarray:
    """Per-shard blocks (every shard's, in rank order) -> the JAX
    package's shard-major (D * C_loc, N, lanes) numpy array."""
    return np.concatenate([block_to_numpy(p) for p in parts], axis=0)


def box_slabs_from_reference(block: np.ndarray, rows: list, *, device,
                             dtype=torch.float32) -> list:
    """A row-sharded JAX box array (Xp, L), zero-padded to equal slabs
    (hyteg_tpu/structured/spmd.py:shard_field), -> the port's slabs on
    ``rows`` (structured/spmd.py:slab_rows)."""
    a = np.asarray(block, dtype=np.float32)
    return [torch.tensor(a[s:e], dtype=dtype, device=device) for s, e in rows]


def box_slabs_to_reference(parts: list, num_shards: int) -> np.ndarray:
    """The port's slabs -> the JAX package's (Xp, L) layout: rows
    concatenated and zero-padded to a multiple of ``num_shards``."""
    a = np.concatenate([block_to_numpy(p) for p in parts], axis=0)
    Xp = -(-a.shape[0] // num_shards) * num_shards
    return np.pad(a, ((0, Xp - a.shape[0]), (0, 0)))


def volume_block_from_reference(block: np.ndarray, *, device,
                                dtype=torch.float32) -> torch.Tensor:
    """A VolumeDoF block (C, T, n, ..., n[, ndofs]): a P0 field, a DG1
    field (ndofs = dim + 1), an EG enrichment or an EG-P0 pressure ->
    tensor on ``device``. Both packages use the same SoA layout. N1E1 and
    edge-DoF blocks live on the P1 level-(L+1) node grid and carry over
    with ``block_from_reference``."""
    return torch.tensor(np.asarray(block), dtype=dtype, device=device)


def eg_from_reference(vel, enr, space, *, device, dtype=torch.float32):
    """A JAX ``EGFunction``'s arrays (``vel``: dim P1 blocks, ``enr``: the
    P0 enrichment block) -> the port's ``EGFunction`` on ``space``."""
    from .functions.eg import EGFunction

    return EGFunction(tuple(block_from_reference(v, device=device,
                                                 dtype=dtype) for v in vel),
                      volume_block_from_reference(enr, device=device,
                                                  dtype=dtype), space)
