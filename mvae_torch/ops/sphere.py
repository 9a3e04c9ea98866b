"""Embedded hypersphere S^n_K (K > 0) as pure functions.

Counterpart of ``mvae_tpu/ops/sphere.py``: the great-circle distance is the
chord form ``2R asin(|y-x| / 2R)``, stable where ``acos(<x,y>/R^2)`` loses
all digits; trig ratios ride the analytic series of ``stable``.

Points live in ambient R^{n+1} with |x| = R = 1/sqrt(K). Orthonormal
tangent coordinates at mu0 = (R, 0, ..., 0) are the last n ambient
coordinates.
"""
from __future__ import annotations

import torch

from . import stable

KIND = "s"
CURVATURE_SIGN = 1


def ambient_dim(dim: int) -> int:
    return dim + 1


def _kk(k):
    """K > 0, clamped away from 0."""
    return torch.clamp(k, min=stable.tiny(k.dtype))


def mu0(dim: int, k, dtype) -> torch.Tensor:
    r = 1.0 / torch.sqrt(_kk(k))
    return torch.cat([r.reshape(1).to(dtype),
                      torch.zeros((dim,), dtype=dtype, device=k.device)])


def project(x, k):
    """Renormalize onto the sphere of radius R."""
    r = 1.0 / torch.sqrt(_kk(k))
    return x * (r / stable.safe_norm(x, keepdim=True))


def _chord_sq(x, y):
    d = y - x
    return torch.sum(d * d, dim=-1, keepdim=True)


def distance(x, y, k):
    """d = 2R asin(|y - x| / (2R)) -- chord form, exact and stable."""
    kk = _kk(k)
    half_chord = torch.sqrt(
        _chord_sq(x, y) + stable.tiny(x.dtype)).squeeze(-1) / 2.0
    e = stable.eps(x.dtype)
    half_chord = torch.minimum(half_chord, (1.0 - e) / torch.sqrt(kk))
    return 2.0 * stable.arcsin_k(half_chord, kk)


def exp_map(x, u, k):
    """exp_x(u) = cos(theta) x + sindiv(theta) u, theta = sqrt(K)|u|."""
    kk = _kk(k)
    t = kk * torch.sum(u * u, dim=-1, keepdim=True)
    z = stable.cos_u(t) * x + stable.sindiv_u(t) * u
    return project(z, k)


def log_map(x, y, k):
    """Inverse of exp_x; stable as y -> x. The magnitude is pinned to the
    geodesic distance by normalizing the tangent direction."""
    kk = _kk(k)
    alpha = 1.0 - kk * _chord_sq(x, y) / 2.0
    u_dir = y - alpha * x
    d = distance(x, y, k)[..., None]
    return d * u_dir / stable.safe_norm(u_dir, keepdim=True)


def parallel_transport(x, y, u, k):
    """PT along the minimizing geodesic x -> y (x != -y), with the output
    norm pinned to the input norm (PT is an isometry)."""
    kk = _kk(k)
    alpha = 1.0 - kk * _chord_sq(x, y) / 2.0
    denom = torch.clamp(1.0 + alpha, min=stable.eps(x.dtype))
    coef = kk * torch.sum(y * u, dim=-1, keepdim=True) / denom
    w = u - coef * (x + y)
    return w * (stable.safe_norm(u, keepdim=True)
                / stable.safe_norm(w, keepdim=True))


# --- mu0-frame operations ----------------------------------------------------


def _embed(v):
    return torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)


def exp_map_mu0(v, k):
    base = mu0(v.shape[-1], k, v.dtype)
    return exp_map(base.expand(v.shape[:-1] + base.shape), _embed(v), k)


def log_map_mu0(z, k):
    base = mu0(z.shape[-1] - 1, k, z.dtype)
    return log_map(base.expand(z.shape), z, k)[..., 1:]


def transp_mu0(mu, v, k):
    base = mu0(v.shape[-1], k, v.dtype)
    return parallel_transport(base.expand(mu.shape), mu, _embed(v), k)


def inv_transp_mu0(mu, u, k):
    base = mu0(mu.shape[-1] - 1, k, mu.dtype)
    return parallel_transport(mu, base.expand(mu.shape), u, k)[..., 1:]


def sample_projection_mu0(v, mu, k):
    return exp_map(mu, transp_mu0(mu, v, k), k)


def inverse_sample_projection_mu0(z, mu, k):
    return inv_transp_mu0(mu, log_map(mu, z, k), k)
