from .time_discr import (  # noqa: F401
    BDF1,
    BDF2,
    CrankNicolson,
    UnsteadyDiffusion,
    cfl_max_dt,
)
from .spectrum import estimate_spectral_radius_op  # noqa: F401
