"""Euclidean manifold E^n as pure functions (flat, K = 0).

Counterpart of ``mvae_tpu/ops/euclidean.py``: exp = +, log = -, parallel
transport = identity. The curvature argument ``k`` is accepted and ignored
so every manifold module shares one calling convention.
"""
from __future__ import annotations

import torch

from . import stable

KIND = "e"
CURVATURE_SIGN = 0


def ambient_dim(dim: int) -> int:
    return dim


def mu0(dim: int, k, dtype) -> torch.Tensor:
    return torch.zeros((dim,), dtype=dtype, device=k.device)


def project(x, k):
    return x


def exp_map(x, u, k):
    return x + u


def log_map(x, y, k):
    return y - x


def parallel_transport(x, y, u, k):
    return u


def distance(x, y, k):
    return stable.safe_norm(y - x)


def exp_map_mu0(v, k):
    return v


def log_map_mu0(z, k):
    return z


def transp_mu0(mu, v, k):
    return v


def inv_transp_mu0(mu, u, k):
    return u


def sample_projection_mu0(v, mu, k):
    """z = exp_mu(PT_{mu0->mu}(v)); flat case: mu + v."""
    return mu + v


def inverse_sample_projection_mu0(z, mu, k):
    return z - mu
