"""Wrapped normal on a constant-curvature manifold (pure functions).

Counterpart of ``mvae_tpu/distributions/wrapped_normal.py``: push a tangent
Gaussian at mu0 through parallel transport to mu and the exponential map,

    v ~ N(0, sigma) in orthonormal coords of T_mu0 M
    z = exp_mu(PT_{mu0->mu}(v)).

Mu0-frame tangents are orthonormal on every manifold, so the log-det is
the single radial expression (n-1) log(sin_k(r)/r).

This slice ports the non-positive curvature path (kinds e and h, where
exp_mu0 is injective and the drawn tangent is the only preimage). The
positive-K wrap-image sums belong to a later slice and raise
``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from ..ops import stable
from . import normal


def _never_wraps(man) -> bool:
    return man.curvature_sign < 0 or man.kind == "e"


def _log_prob_from_principal(man, v, sigma, k, wraps: int):
    """Log q from the principal-branch tangent v (orthonormal mu0 frame)."""
    if _never_wraps(man):
        wraps = 0
    if wraps != 0:
        raise NotImplementedError(
            "later slice: positive-curvature wrap-image sums")
    n = man.dim
    r = stable.safe_norm(v)
    sigma = torch.clamp(sigma, min=stable.tiny(v.dtype))
    return (normal.log_prob(v, torch.zeros((), dtype=v.dtype,
                                           device=v.device), sigma)
            - (n - 1) * stable.log_sindiv_u_soft(k * r * r))


def _sample_log_prob_drawn(man, v, sigma, k, wraps: int):
    """log q(z) for z = exp_mu(PT(v)) evaluated from the drawn tangent,
    without the f32 exp -> log_map -> inverse-PT round trip (for K <= 0
    the drawn tangent is the principal preimage)."""
    if not _never_wraps(man):
        raise NotImplementedError(
            "later slice: positive-curvature drawn-radius branch sum")
    n = man.dim
    sig_b = torch.clamp(torch.broadcast_to(sigma, v.shape),
                        min=stable.tiny(v.dtype))
    eps_z = v / sig_b
    s2 = torch.sum(eps_z * eps_z, dim=-1)
    const = (-torch.sum(torch.log(sig_b), dim=-1)
             - 0.5 * n * math.log(2.0 * math.pi))
    vsq = torch.sum(v * v, dim=-1) + stable.tiny(v.dtype)
    return -0.5 * s2 + const - (n - 1) * stable.log_sindiv_u(k * vsq)


def sample_and_log_prob(man, mu, sigma, k, wraps: int = 1, noise=None,
                        generator=None):
    """Draw z and its log q(z). ``noise`` is the standard normal draw
    (..., dim); without it the draw comes from ``generator``."""
    if noise is None:
        noise = normal.standard_normal(mu.shape[:-1] + (man.dim,), mu,
                                       generator)
    v = sigma * noise
    z = man.sample_projection_mu0(v, mu, k)
    return z, _sample_log_prob_drawn(man, v, sigma, k, wraps)


def log_prob_mu0(man, z, sigma, k, wraps: int = 1):
    """log-density of the prior WrappedNormal(mu0, sigma)."""
    v = man.log_map_mu0(z, k)
    return _log_prob_from_principal(man, v, sigma, k, wraps)
