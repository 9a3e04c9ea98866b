"""Manifold descriptor + static dispatch over the geometry modules.

Counterpart of ``mvae_tpu/ops/manifold.py``: a :class:`Manifold` is a
static, hashable descriptor (kind + latent dim) and curvature is a tensor
passed at call time. Curvature parameterization: components store an
unconstrained scalar ``c_param``; ``K = sign * exp(c_param)`` for
sign-pinned manifolds (never crosses zero, dK/dc = K) and ``K = c_param``
for the universal manifold.

The kinds d/p/u are parsed and sized here, but their geometry belongs to a
later slice of the port: touching it raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import euclidean, lorentz, sphere

_MODULES = {"e": euclidean, "h": lorentz, "s": sphere}

# curvature sign and whether a point carries one extra (embedding) coordinate
_SIGN = {"e": 0, "h": -1, "d": -1, "s": 1, "p": 1, "u": 0}
_EMBEDDED = {"h", "s"}

KINDS = tuple(_SIGN)

FULL_NAMES = {
    "e": "Euclidean",
    "h": "Hyperboloid (Lorentz)",
    "d": "Poincare ball",
    "s": "Hypersphere",
    "p": "Projected sphere",
    "u": "Universal (kappa-stereographic)",
}


@dataclasses.dataclass(frozen=True)
class Manifold:
    """Static descriptor of one constant-curvature factor.

    kind: one of 'e','h','d','s','p','u' (the spec-DSL letters).
    dim:  intrinsic latent dimension n.
    """

    kind: str
    dim: int

    def __post_init__(self):
        if self.kind not in _SIGN:
            raise ValueError(f"unknown manifold kind {self.kind!r}; "
                             f"expected one of {sorted(_SIGN)}")
        if self.dim < 1:
            raise ValueError(f"manifold dim must be >= 1, got {self.dim}")

    @property
    def ops(self):
        if self.kind not in _MODULES:
            raise NotImplementedError(
                f"later slice: the {FULL_NAMES[self.kind]} geometry "
                f"('{self.kind}') is not ported yet")
        return _MODULES[self.kind]

    @property
    def ambient_dim(self) -> int:
        """Coordinate size of a point (n+1 for embedded h/s, n otherwise)."""
        return self.dim + (1 if self.kind in _EMBEDDED else 0)

    @property
    def curvature_sign(self) -> int:
        return _SIGN[self.kind]

    @property
    def has_curvature_param(self) -> bool:
        """Euclidean has no curvature degree of freedom."""
        return self.kind != "e"

    # --- curvature parameterization -----------------------------------------

    def curvature(self, c_param):
        """Unconstrained parameter -> sectional curvature K."""
        if self.kind == "e":
            return torch.zeros_like(c_param)
        if self.kind == "u":
            return c_param
        return float(self.curvature_sign) * torch.exp(c_param)

    def init_curvature_param(self, init_k: float = 1.0,
                             dtype=torch.float32, device=None):
        """Inverse of :meth:`curvature` at |K| = init_k (sign from kind)."""
        value = init_k if self.kind == "u" else math.log(abs(init_k))
        return torch.tensor(value, dtype=dtype, device=device)

    # --- dispatched geometry at mu0 (k = sectional curvature, 0-d tensor) ---

    def exp_map_mu0(self, v, k):
        return self.ops.exp_map_mu0(v, k)

    def log_map_mu0(self, z, k):
        return self.ops.log_map_mu0(z, k)

    def sample_projection_mu0(self, v, mu, k):
        return self.ops.sample_projection_mu0(v, mu, k)
