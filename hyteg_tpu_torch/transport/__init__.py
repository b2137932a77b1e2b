from .mmoc import MMOCTransport  # noqa: F401
from .particles import ParticleDomain, ParticleSet, create_particles  # noqa: F401
