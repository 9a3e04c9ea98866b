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
