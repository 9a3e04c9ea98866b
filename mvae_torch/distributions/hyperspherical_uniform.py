"""Uniform distribution on the sphere S^{m-1} of radius R = 1/sqrt(K).

Counterpart of ``mvae_tpu/distributions/hyperspherical_uniform.py``: the
prior paired with the von Mises-Fisher posterior.
"""
from __future__ import annotations

import math

import torch


def log_surface_area(m: int, k):
    """log Area(S^{m-1}_R) = log(2 pi^{m/2} / Gamma(m/2)) + (m-1) log R."""
    log_unit = (math.log(2.0) + (m / 2.0) * math.log(math.pi)
                - math.lgamma(m / 2.0))
    r = 1.0 / torch.sqrt(torch.clamp(k, min=1e-30))
    return log_unit + (m - 1) * torch.log(r)


def log_prob(z, k):
    """Constant density: -log Area. z has ambient coords (..., m)."""
    m = z.shape[-1]
    return torch.broadcast_to(-log_surface_area(m, k).to(z.dtype),
                              z.shape[:-1])


def entropy(m: int, k):
    """The uniform's entropy: log Area(S^{m-1}_R)."""
    return log_surface_area(m, k)


def sample(shape, m: int, k, like: torch.Tensor, generator=None):
    """Uniform draw on the radius-R sphere: a normalized Gaussian times R,
    (*shape, m) with ``like``'s dtype and device."""
    g = torch.randn(tuple(shape) + (m,), generator=generator,
                    dtype=like.dtype, device=like.device)
    g = g / torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True) + 1e-30)
    r = 1.0 / torch.sqrt(torch.clamp(k, min=1e-30))
    return g * r.to(like.dtype)
