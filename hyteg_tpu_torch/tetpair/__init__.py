"""Paired-tet fast path for the general P1 constant-stencil apply (torch
counterpart of hyteg_tpu/tetpair/).

Two macro-tets share one dense (N, N*pitch) block: tet A in the lower
corner (x+y+z <= n), tet B point-reflected into the upper corner
(x+y+z >= 2n). That halves the slots a general-mesh apply streams, and the
halo exchange is chain-fused into the stencil kernel: the kernel installs
the summed interface values on read and extracts the partial boundary
sums of its result into compact face arrays, which a small torch exchange
sums across cells (tetpair/small.py).

The engine is imported on first use, so that kernels/tetpair.py can use
tetpair.plan without importing the engine that calls it.
"""

__all__ = ["PairState", "TetPairEngine"]


def __getattr__(name):
    if name in __all__:
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
