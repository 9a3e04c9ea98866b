"""Manifold operations: stable numerics (L0) and constant-curvature geometry (L1)."""
from . import (euclidean, lorentz, manifold, poincare, sphere,
               spherical_projected, stable, stereographic, universal)
from .manifold import KINDS, Manifold

__all__ = ["stable", "euclidean", "lorentz", "sphere", "stereographic",
           "poincare", "spherical_projected", "universal", "manifold",
           "Manifold", "KINDS"]
