"""Wrapped normal on a constant-curvature manifold (pure functions).

Counterpart of ``mvae_tpu/distributions/wrapped_normal.py``: push a tangent
Gaussian at mu0 through parallel transport to mu and the exponential map,

    v ~ N(0, sigma) in orthonormal coords of T_mu0 M
    z = exp_mu(PT_{mu0->mu}(v)).

Mu0-frame tangents are orthonormal on every manifold, so the log-det is
the single radial expression (n-1) log(sin_k(r)/r).

On positive curvature the exponential map is periodic, so the exact density
at z sums over the tangent preimages (wrap images)

    q(z) = sum_b N(v_b; 0, sigma) / |det J(v_b)|,  T = 2 pi / sqrt(K),

truncated at ``wraps`` extra periods. For K <= 0 the extra branches carry
no mass and are masked, smoothly in K, so one code path serves the
universal manifold as its curvature crosses zero.
"""
from __future__ import annotations

import math

import torch

from ..ops import stable
from . import normal

# A wrap image's z-score must stay far from float32 overflow after squaring
# and summing, or a zero-weight logsumexp gradient turns into 0 * inf.
# Branches beyond the cap carry no mass, so masking them is exact.
_ZSCORE_CAP = 1e15
# curvature floor inside the period: keeps d(period)/dK finite
_K_FLOOR = 1e-20


def _never_wraps(man) -> bool:
    return man.curvature_sign < 0 or man.kind == "e"


def _masked(live, value):
    """``value`` where ``live``, else the log of a zero-mass branch."""
    return torch.where(live, value, torch.full_like(value, -1e30))


def _log_abs_sindiv_k(r, k):
    """log(|sin_k(r)| / r), valid for any r >= 0 (multi-branch radii): the
    mollified |sin| at the principal-reduced angle, with the branch's
    unreduced radius as the mollifier taper."""
    u = k * r * r
    tin = stable.tiny(r.dtype)
    x = torch.sqrt(torch.clamp(u, min=tin))
    two_pi = 2.0 * math.pi
    x_red = torch.abs(x - two_pi * torch.floor(x / two_pi + 0.5))
    sph = (stable.log_abs_sin_soft(x_red, taper_x=x)
           - torch.log(torch.clamp(x, min=tin)))
    return torch.where(u > math.pi ** 2, sph, stable.log_sindiv_u_soft(u))


def _log_prob_from_principal(man, v, sigma, k, wraps: int):
    """Log q from the principal-branch tangent v (orthonormal mu0 frame).
    ``wraps`` counts the wrap-image pairs summed for K > 0 (0 = principal
    branch only)."""
    n = man.dim
    dtype = v.dtype
    tin = stable.tiny(dtype)
    if _never_wraps(man):
        wraps = 0
    if wraps == 0:
        r = stable.safe_norm(v)
        sigma = torch.clamp(sigma, min=tin)
        return (normal.log_prob(v, torch.zeros((), dtype=dtype,
                                               device=v.device), sigma)
                - (n - 1) * stable.log_sindiv_u_soft(k * r * r))

    r = stable.safe_norm(v, keepdim=True)
    v_hat = v / r
    period = 2.0 * math.pi / torch.sqrt(torch.clamp(k, min=_K_FLOOR))
    sig_b = torch.clamp(torch.broadcast_to(sigma, v.shape), min=tin)
    sig_min = torch.min(sig_b, dim=-1, keepdim=True).values
    # every branch shares the direction v_hat, so the Gaussian term is
    # scalar math in the branch radius (sums in float32 under bfloat16)
    acc = stable.acc_dtype(dtype)
    quad = torch.sum((v_hat / sig_b) ** 2, dim=-1, keepdim=True, dtype=acc)
    const = (-torch.sum(torch.log(sig_b), dim=-1, dtype=acc)
             - 0.5 * n * math.log(2.0 * math.pi))
    branches = [r]
    for m in range(1, wraps + 1):
        branches += [r + m * period, r - m * period]
    logps = []
    for i, rb_raw in enumerate(branches):
        if i == 0:
            rb, live = rb_raw, None
        else:
            # dead for K <= 0 and where (rb/sigma)^2 would overflow; a dead
            # branch is evaluated at the principal radius and masked
            live = (k > 0) & (torch.abs(rb_raw) < _ZSCORE_CAP * sig_min)
            rb = torch.where(live, rb_raw, r)
        logn = -0.5 * (rb * rb * quad).squeeze(-1) + const
        logp = logn - (n - 1) * _log_abs_sindiv_k(torch.abs(rb).squeeze(-1),
                                                  k)
        if live is not None:
            logp = _masked(live.squeeze(-1), logp)
        logps.append(logp)
    return torch.logsumexp(torch.stack(logps, dim=-1), dim=-1)


def log_prob(man, z, mu, sigma, k, wraps: int = 1):
    """Exact log-density w.r.t. the Riemannian measure. The principal
    preimage comes from the ``log_map`` + inverse-transport round trip; for
    the density of a distribution's own sample use
    ``sample_and_log_prob``, which has no round trip."""
    v = man.inverse_sample_projection_mu0(z, mu, k)
    return _log_prob_from_principal(man, v, sigma, k, wraps)


def _sample_log_prob_drawn(man, v, sigma, k, wraps: int):
    """log q(z) for z = exp_mu(PT(v)) evaluated from the drawn tangent,
    without the f32 exp -> log_map -> inverse-PT round trip: every preimage
    of z along the drawn geodesic is (r + m T) v_hat with r = |v|, so the
    density needs only the drawn direction and scalar radius arithmetic.
    ``wraps=0`` is the principal branch only, at the scalar wrap of r."""
    n = man.dim
    tin = stable.tiny(v.dtype)
    sig_b = torch.clamp(torch.broadcast_to(sigma, v.shape), min=tin)
    eps_z = v / sig_b
    acc = stable.acc_dtype(v.dtype)
    s2 = torch.sum(eps_z * eps_z, dim=-1, dtype=acc)
    const = (-torch.sum(torch.log(sig_b), dim=-1, dtype=acc)
             - 0.5 * n * math.log(2.0 * math.pi))
    vsq = torch.sum(v * v, dim=-1) + tin
    if _never_wraps(man):
        return -0.5 * s2 + const - (n - 1) * stable.log_sindiv_u(k * vsq)

    r = torch.sqrt(vsq)
    quad = s2 / vsq                         # r^2 * quad == s2 exactly
    kpos = torch.clamp(k, min=_K_FLOOR)
    sqrt_k = torch.sqrt(kpos)
    period = 2.0 * math.pi / sqrt_k
    rp = torch.abs(r - period * torch.floor(r / period + 0.5))
    pinned = man.curvature_sign > 0
    # the m = 0 branch's log-det argument; its zero at rp = 0 is removable
    u0 = kpos * rp * rp if pinned else torch.where(k > 0, kpos * rp * rp,
                                                   k * vsq)
    if wraps == 0:
        rp_eff = torch.where(k > 0, rp, r)
        return (-0.5 * rp_eff * rp_eff * quad + const
                - (n - 1) * stable.log_sindiv_u_soft(u0))

    # |sin(sqrt(K) rb)| is the same on every branch: one sin at the reduced
    # angle; each branch tapers its mollifier on its own unreduced radius
    x_red = sqrt_k * rp
    logps = []
    for m in range(-(wraps + 3), wraps + 4):
        rb_raw = rp + m * period
        if m == 0:
            live, rb = None, rb_raw
            logdet = (n - 1) * stable.log_sindiv_u_soft(u0)
        else:
            live = (k > 0) & (rb_raw * rb_raw * quad < 1e30)
            rb = torch.where(live, rb_raw, rp)
            xb = sqrt_k * torch.abs(rb)
            sph = (stable.log_abs_sin_soft(x_red, taper_x=xb)
                   - torch.log(torch.clamp(xb, min=tin)))
            if not pinned:
                sph = torch.where(k > 0, sph,
                                  stable.log_sindiv_u_soft(k * vsq))
            logdet = (n - 1) * sph
        logp = -0.5 * rb * rb * quad + const - logdet
        if live is not None:
            logp = _masked(live, logp)
        logps.append(logp)
    return torch.logsumexp(torch.stack(logps, dim=-1), dim=-1)


def sample(man, mu, sigma, k, noise=None, generator=None):
    """Draw z; mu has ambient coordinates, sigma broadcasts against
    (..., dim). ``noise`` is the standard normal draw; without it the draw
    comes from ``generator``."""
    if noise is None:
        noise = normal.standard_normal(mu.shape[:-1] + (man.dim,), mu,
                                       generator)
    return man.sample_projection_mu0(sigma * noise, mu, k)


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
