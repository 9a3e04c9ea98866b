"""Manifold operations: stable numerics (L0) and constant-curvature geometry (L1)."""
from . import euclidean, lorentz, manifold, sphere, stable
from .manifold import KINDS, Manifold

__all__ = ["stable", "euclidean", "lorentz", "sphere", "manifold",
           "Manifold", "KINDS"]
