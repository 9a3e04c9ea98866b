"""von Mises-Fisher distribution on the sphere.

Counterpart of ``mvae_tpu/distributions/von_mises_fisher.py`` for m = 3
(the ``s2`` latent): the exact inverse-CDF cosine, a Householder reflection
to the mean direction, log C_m(kappa) through the scaled Bessel function,
and the analytic KL to the hyperspherical uniform prior. The Wood
rejection sampler for m != 3 belongs to a later slice.

Points live on the radius-R sphere (R = 1/sqrt(K)); densities are w.r.t.
the Riemannian surface measure, so the (m-1) log R area term appears in
log_prob but cancels in every KL / IWAE weight.
"""
from __future__ import annotations

import math

import torch

from ..ops import stable
from ..utils.special import bessel_ratio, log_ive
from . import normal

# u is drawn on [U_MIN, 1): the inverse CDF is finite at both ends
U_MIN = 1e-7


def _unit(x):
    return x / stable.safe_norm(x, keepdim=True)


def log_normalizer(m: int, kappa):
    """log C_m(kappa) of the unit-sphere vMF density."""
    nu = m / 2.0 - 1.0
    kappa = torch.clamp(kappa, min=stable.tiny(kappa.dtype))
    return (nu * torch.log(kappa) - (m / 2.0) * math.log(2.0 * math.pi)
            - (log_ive(nu, kappa) + kappa))


def log_prob(z, mu, kappa, k):
    """log q(z) for z, mu ambient on the radius-R sphere; kappa (...)."""
    m = z.shape[-1]
    cos = torch.sum(_unit(mu) * _unit(z), dim=-1)
    r_area = (m - 1) / 2.0 * torch.log(torch.clamp(k, min=1e-30))
    return log_normalizer(m, kappa) + kappa * cos + r_area.to(z.dtype)


def uniform(shape, like: torch.Tensor, generator=None):
    """U[U_MIN, 1) draws with ``like``'s dtype and device."""
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=like.device)
    return U_MIN + (1.0 - U_MIN) * u


def _sample_w_m3(kappa, u):
    """Exact inverse-CDF cosine on S^2 (m = 3): the w-marginal is
    proportional to e^{kappa w} on [-1, 1], so
    w = 1 + log(u + (1-u) e^{-2 kappa}) / kappa, in the expm1/log1p form."""
    kap = torch.clamp(kappa, min=1e-6)
    w = 1.0 + torch.log1p((1.0 - u) * torch.expm1(-2.0 * kap)) / kap
    return torch.clamp(w, -1.0 + 1e-7, 1.0 - 1e-7)


def _householder_rotate(zprime, mu_unit):
    """Reflect so that e1 -> mu_unit (maps the frame-aligned sample home)."""
    e1 = torch.zeros_like(mu_unit)
    e1[..., 0] = 1.0
    u = e1 - mu_unit
    un = stable.safe_norm(u, keepdim=True)
    e = stable.eps(u.dtype)
    u_hat = u / torch.clamp(un, min=e)
    reflected = zprime - 2.0 * torch.sum(u_hat * zprime, dim=-1,
                                         keepdim=True) * u_hat
    return torch.where(un < e, zprime, reflected)


def sample(mu, kappa, k, noise=None, generator=None):
    """Reparameterized draw on the radius-R sphere.

    mu: (..., m) ambient mean direction (any radius; normalized inside).
    kappa: (...) concentration. k: curvature (R = 1/sqrt(k)).
    noise: (..., m) = [u, g_1 .. g_{m-1}]: the uniform for the cosine and
    the standard normals for the tangent direction; drawn from
    ``generator`` when not given.
    """
    m = mu.shape[-1]
    if m != 3:
        raise NotImplementedError(
            "later slice: the Wood rejection sampler for vMF with m != 3")
    if noise is None:
        noise = torch.cat([uniform(kappa.shape + (1,), mu, generator),
                           normal.standard_normal(mu.shape[:-1] + (m - 1,),
                                                  mu, generator)], dim=-1)
    w = _sample_w_m3(kappa, noise[..., 0])
    g = noise[..., 1:]
    v = g / stable.safe_norm(g, keepdim=True)
    sin_w = torch.sqrt(torch.clamp(1.0 - w * w, min=stable.tiny(mu.dtype)))
    zprime = torch.cat([w[..., None], sin_w[..., None] * v], dim=-1)
    z_unit = _householder_rotate(zprime, _unit(mu))
    r = 1.0 / torch.sqrt(torch.clamp(k, min=1e-30))
    return z_unit * r.to(mu.dtype)


def mean_resultant_length(m: int, kappa):
    """A_m(kappa) = I_{m/2}(kappa) / I_{m/2-1}(kappa) = E[<mu, z>]."""
    return bessel_ratio(m / 2.0 - 1.0, kappa)


def kl_to_uniform(m: int, kappa):
    """Analytic KL(vMF(mu, kappa) || Uniform(S^{m-1})); radius-independent."""
    unit_area = (math.log(2.0) + (m / 2.0) * math.log(math.pi)
                 - math.lgamma(m / 2.0))
    return (kappa * mean_resultant_length(m, kappa)
            + log_normalizer(m, kappa) + unit_area)
