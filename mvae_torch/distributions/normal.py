"""Diagonal Gaussian primitives (pure functions on tensors).

Counterpart of ``mvae_tpu/distributions/normal.py``, for the Euclidean
component and as the tangent-space base of the wrapped normal. ``sigma``
may have trailing dim 1 (isotropic) or ``n`` (diagonal).
"""
from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def standard_normal(shape, like: torch.Tensor,
                    generator: torch.Generator | None = None):
    """N(0, 1) draws of ``shape`` with ``like``'s dtype and device."""
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def sample(mu, sigma, noise=None, generator=None):
    """Reparameterized draw mu + sigma * eps; ``noise`` is eps when given,
    otherwise eps is drawn from ``generator``."""
    if noise is None:
        noise = standard_normal(torch.broadcast_shapes(mu.shape, sigma.shape),
                                mu, generator)
    return mu + sigma * noise


def log_prob(x, mu, sigma):
    """Summed (over last axis) diagonal Gaussian log-density."""
    sigma = torch.broadcast_to(sigma, x.shape)
    z = (x - mu) / sigma
    return torch.sum(-0.5 * (z * z + _LOG_2PI) - torch.log(sigma), dim=-1)


def kl_std(mu, sigma):
    """KL(q || N(0, I)), summed over the last axis."""
    sigma = torch.broadcast_to(sigma, mu.shape)
    return 0.5 * torch.sum(sigma * sigma + mu * mu - 1.0
                           - 2.0 * torch.log(sigma), dim=-1)
