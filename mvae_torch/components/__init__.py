"""Latent components (L3): manifold factor + posterior + spec DSL."""
from .component import (DEFAULT_POSTERIOR, POSTERIORS, Component,
                        Reparametrized, draw_noise, reparametrize,
                        sample_prior)
from .spec import (canonical_name, parse_components, total_ambient_dim,
                   total_true_dim)

__all__ = [
    "Component", "Reparametrized", "reparametrize", "draw_noise",
    "sample_prior",
    "POSTERIORS", "DEFAULT_POSTERIOR", "parse_components", "canonical_name",
    "total_ambient_dim", "total_true_dim",
]
