from .params import ConvectionParameters  # noqa: F401
from .profiles import RadialProfile, viscosity_profile_arrhenius  # noqa: F401
from .simulation import ConvectionSimulation  # noqa: F401
