"""Adaptive macro refinement: red-green refinement, error indicators and
marking, and DoF transfer between storages (torch counterpart of
hyteg_tpu/adaptivity)."""

from .refine import refine_rg, refine_uniform, RefinementResult  # noqa: F401
from .estimator import macro_gradient_indicator, mark_dorfler  # noqa: F401
from .transfer import interpolate_between_storages  # noqa: F401
