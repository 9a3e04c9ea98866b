"""Distributions (L2): samplers that take their noise, and exact log-densities."""
from . import hyperspherical_uniform, normal, von_mises_fisher, wrapped_normal

__all__ = ["normal", "wrapped_normal", "hyperspherical_uniform",
           "von_mises_fisher"]
