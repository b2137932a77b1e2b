"""Structured box path (torch counterpart of hyteg_tpu/structured/).

A box-structured Kuhn-tetrahedral mesh is stored as ONE dense node grid
of shape (X, Y*Z) instead of one padded block per macro-tet: no interface
duplication, no halo exchange on one device, and a translation-invariant
15-point stencil whose boundary corrections collapse into per-lane weight
vectors (see kuhn.py). The apply is kernel B1 (csrc/box_stencil.cu).
"""

from .box import BoxDomain
from .operator import BoxStencilOperator
