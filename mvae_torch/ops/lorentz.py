"""Lorentz-hyperboloid model H^n_K (K < 0) as pure functions.

Counterpart of ``mvae_tpu/ops/lorentz.py``, with its float32 numerics:

* ``alpha - 1 = -<x,y>_L/R^2 - 1`` is computed as ``c*|y-x|_L^2 / 2`` from
  the difference vector -- no catastrophic cancellation for nearby points;
* ``acosh`` only ever appears as ``acosh(1+e)`` via ``stable.acosh_1p``;
* cosh/sinh ratios go through the analytic-in-``u`` series.

Points live in ambient R^{n+1} with <x,x>_L = -R^2, x_0 > 0, R = 1/sqrt(-K).
Orthonormal tangent coordinates at mu0 = (R, 0, ..., 0) are the last n
ambient coordinates.
"""
from __future__ import annotations

import torch

from . import stable

KIND = "h"
CURVATURE_SIGN = -1


def ambient_dim(dim: int) -> int:
    return dim + 1


def _c(k):
    """c = -K > 0, clamped away from 0."""
    return torch.clamp(-k, min=stable.tiny(k.dtype))


def lorentz_product(x, y, keepdim: bool = False):
    """Minkowski inner product <x,y>_L = -x0*y0 + sum_i xi*yi."""
    spatial = torch.sum(x[..., 1:] * y[..., 1:], dim=-1, keepdim=keepdim)
    time = x[..., :1] * y[..., :1] if keepdim else x[..., 0] * y[..., 0]
    return spatial - time


def mu0(dim: int, k, dtype) -> torch.Tensor:
    r = 1.0 / torch.sqrt(_c(k))
    return torch.cat([r.reshape(1).to(dtype),
                      torch.zeros((dim,), dtype=dtype, device=k.device)])


def project(x, k):
    """Recompute x0 from the spatial part so <x,x>_L = -R^2 exactly."""
    c = _c(k)
    spatial = x[..., 1:]
    x0 = torch.sqrt(1.0 / c + torch.sum(spatial * spatial, dim=-1,
                                        keepdim=True))
    return torch.cat([x0, spatial], dim=-1)


def _alpha_m1(x, y, k):
    """alpha - 1 where alpha = -c <x,y>_L, via the stable difference form."""
    d = y - x
    return torch.clamp(_c(k) * lorentz_product(d, d, keepdim=True),
                       min=0.0) / 2.0


def distance(x, y, k):
    e = _alpha_m1(x, y, k).squeeze(-1) + stable.tiny(x.dtype)
    return stable.acosh_1p(e) / torch.sqrt(_c(k))


def exp_map(x, u, k):
    """exp_x(u) = cosh(theta) x + sinhdiv(theta) u, theta = sqrt(c)|u|_L."""
    c = _c(k)
    usq = torch.clamp(lorentz_product(u, u, keepdim=True), min=0.0)
    t = -c * usq
    z = stable.cos_u(t) * x + stable.sindiv_u(t) * u
    return project(z, k)


def log_map(x, y, k):
    """Inverse of exp_x; stable as y -> x (ratio -> 1 smoothly)."""
    e = _alpha_m1(x, y, k)
    u_dir = y - (1.0 + e) * x
    s = torch.sqrt(e * (e + 2.0) + stable.tiny(x.dtype))
    ratio = torch.log1p(e + s) / s
    return ratio * u_dir


def parallel_transport(x, y, u, k):
    """PT along the geodesic x -> y: u + c<y,u>_L/(2+e) (x+y)."""
    c = _c(k)
    e = _alpha_m1(x, y, k)
    coef = c * lorentz_product(y, u, keepdim=True) / (2.0 + e)
    return u + coef * (x + y)


# --- mu0-frame operations (wrapped-normal support) ---------------------------


def _embed(v):
    """Orthonormal tangent coords at mu0 -> ambient: v -> (0, v)."""
    return torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)


def exp_map_mu0(v, k):
    base = mu0(v.shape[-1], k, v.dtype)
    return exp_map(base.expand(v.shape[:-1] + base.shape), _embed(v), k)


def log_map_mu0(z, k):
    base = mu0(z.shape[-1] - 1, k, z.dtype)
    return log_map(base.expand(z.shape), z, k)[..., 1:]


def transp_mu0(mu, v, k):
    """PT_{mu0 -> mu} of orthonormal coords v; returns ambient tangent."""
    base = mu0(v.shape[-1], k, v.dtype)
    return parallel_transport(base.expand(mu.shape), mu, _embed(v), k)


def inv_transp_mu0(mu, u, k):
    base = mu0(mu.shape[-1] - 1, k, mu.dtype)
    return parallel_transport(mu, base.expand(mu.shape), u, k)[..., 1:]


def sample_projection_mu0(v, mu, k):
    """z = exp_mu(PT_{mu0->mu}(embed v)): the wrapped-normal push-forward."""
    return exp_map(mu, transp_mu0(mu, v, k), k)


def inverse_sample_projection_mu0(z, mu, k):
    return inv_transp_mu0(mu, log_map(mu, z, k), k)
