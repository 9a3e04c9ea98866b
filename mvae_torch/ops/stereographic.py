"""kappa-stereographic gyrovector core: one implementation, any curvature.

Counterpart of ``mvae_tpu/ops/stereographic.py``, the backend of three
manifolds: the Poincare ball (K < 0), the projected sphere (K > 0) and the
sign-agnostic universal space. All trig goes through the analytic-in-
``u = K r^2`` series of :mod:`mvae_torch.ops.stable`, so every formula is a
single smooth expression valid for K < 0, K = 0 and K > 0: the universal
component's curvature can cross zero with finite values and gradients.

Points are coordinates x in R^n with K|x|^2 > -1 (the ball of radius
1/sqrt(-K) when K < 0; all of R^n when K >= 0). The metric is conformal:
g_x = lambda_x^2 I with lambda_x = 2 / (1 + K|x|^2).

Orthonormal tangent coordinates at mu0 = 0 are v = lambda_0 v_coord
= 2 v_coord; every mu0-frame function takes and returns that orthonormal v.
"""
from __future__ import annotations

import torch

from . import stable

KIND = "m"  # generic kappa-stereographic; wrappers specialize d/p/u
CURVATURE_SIGN = 0  # any


def ambient_dim(dim: int) -> int:
    return dim


def mu0(dim: int, k, dtype) -> torch.Tensor:
    return torch.zeros((dim,), dtype=dtype, device=k.device)


def _dot(x, y):
    return torch.sum(x * y, dim=-1, keepdim=True)


def lambda_x(x, k, keepdim: bool = True):
    """Conformal factor lambda_x = 2 / (1 + K|x|^2), clamped positive."""
    den = torch.clamp(1.0 + k * _dot(x, x), min=stable.eps(x.dtype))
    out = 2.0 / den
    return out if keepdim else out.squeeze(-1)


def project(x, k):
    """For K < 0 clamp into the open ball of radius (1-eps)/sqrt(-K); for
    K >= 0 the coordinate space is all of R^n."""
    e = stable.eps(x.dtype)
    norm = stable.safe_norm(x, keepdim=True)
    neg_k = torch.clamp(k, max=-stable.tiny(k.dtype))
    max_norm = (1.0 - e) / torch.sqrt(-neg_k)
    scale = torch.where(k < 0, torch.clamp(max_norm / norm, max=1.0),
                        torch.ones_like(norm))
    return x * scale


def mobius_add(x, y, k):
    """Mobius gyrovector addition x (+)_K y (Euclidean + at K = 0)."""
    x2 = _dot(x, x)
    y2 = _dot(y, y)
    xy = _dot(x, y)
    num = (1.0 - 2.0 * k * xy - k * y2) * x + (1.0 + k * x2) * y
    den = 1.0 - 2.0 * k * xy + k * k * x2 * y2
    # den -> 0 only at the K>0 antipode / K<0 boundary (measure zero)
    e = stable.eps(x.dtype)
    den = torch.where(torch.abs(den) < e, torch.full_like(den, e), den)
    return num / den


def mobius_scalar_mul(r, x, k):
    """r (*)_K x = tan_k(r * arctan_k(|x|)) * x/|x| (gyro scalar multiple)."""
    xn = stable.safe_norm(x, keepdim=True)
    t = stable.arctan_k(xn, k)
    return stable.tan_k(r * t, k) * x / xn


def gyration(a, b, v, k):
    """gyr[a,b]v = (-(a+b)) (+) (a (+) (b (+) v)): the gyrogroup rotation."""
    ab = mobius_add(a, b, k)
    bv = mobius_add(b, v, k)
    return mobius_add(-ab, mobius_add(a, bv, k), k)


def distance(x, y, k):
    """d(x,y) = 2 arctan_k(|(-x) (+) y|); 2|y-x| at K = 0."""
    w = mobius_add(-x, y, k)
    wsq = torch.sum(w * w, dim=-1)
    return 2.0 * torch.sqrt(wsq + stable.tiny(x.dtype)) * stable.arctandiv_u(
        k * wsq)


# --- exp/log at arbitrary basepoints -----------------------------------------


def exp_map(x, u, k):
    """exp_x(u) for coordinate tangent u: x (+) tan_k(lambda_x |u| / 2) u_hat,
    written without a norm division (smooth at u = 0)."""
    half = lambda_x(x, k) / 2.0
    g = half * stable.tandiv_u(k * half * half * _dot(u, u))
    return project(mobius_add(x, g * u, k), k)


def log_map(x, y, k):
    """Inverse of exp_x: (2/lambda_x) arctan_k(|w|) w_hat, w = (-x) (+) y."""
    w = mobius_add(-x, y, k)
    g = (2.0 / lambda_x(x, k)) * stable.arctandiv_u(k * _dot(w, w))
    return g * w


def parallel_transport(x, y, u, k):
    """PT_{x->y}(u) = (lambda_x / lambda_y) gyr[y, -x] u."""
    return (lambda_x(x, k) / lambda_x(y, k)) * gyration(y, -x, u, k)


# --- mu0-frame operations (wrapped-normal support) ---------------------------
# v below is in orthonormal coordinates at mu0 = 0 (v = 2 * v_coord).


def exp_map_mu0(v, k):
    """exp_0 of orthonormal v: tan_k(|v|/2) v_hat = (1/2) tandiv(...) v."""
    g = 0.5 * stable.tandiv_u(k * _dot(v, v) / 4.0)
    return project(g * v, k)


def log_map_mu0(z, k):
    """Inverse: v = 2 arctan_k(|z|) z_hat = 2 arctandiv(K|z|^2) z."""
    return 2.0 * stable.arctandiv_u(k * _dot(z, z)) * z


def transp_mu0(mu, v, k):
    """PT_{0->mu} of orthonormal v, as a coordinate tangent at mu:
    gyr[mu, 0] = id, so the transport is the conformal rescale v / lambda_mu."""
    return v / lambda_x(mu, k)


def inv_transp_mu0(mu, u, k):
    return u * lambda_x(mu, k)


def sample_projection_mu0(v, mu, k):
    """exp_mu(PT_{0->mu}(v)) == mu (+)_K exp_0(v) (gyro identity; one
    mobius_add instead of transport + general expmap)."""
    return project(mobius_add(mu, exp_map_mu0(v, k), k), k)


def inverse_sample_projection_mu0(z, mu, k):
    return log_map_mu0(mobius_add(-mu, z, k), k)
