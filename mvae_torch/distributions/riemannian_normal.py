"""Riemannian normal on hyperbolic space: p(z) ~ exp(-d(mu, z)^2 / 2 sigma^2).

Counterpart of ``mvae_tpu/distributions/riemannian_normal.py``, as plain
PyTorch functions on tensors (the reference has no kernel here):

* The log-partition Z(sigma, c, n), the radial CDF and the radial pdf are
  positive-integrand log-space Gauss-Legendre quadratures (64 nodes) of
  w(s) = exp(-s^2 / 2 sigma^2) (sinh(sqrt(c) s) / sqrt(c))^(n-1) over a
  window of +-12 sigma around the radial mode. Every summand is positive,
  so float32 suffices at any (sigma, c); autograd differentiates through
  the nodes. The window's mode comes from 40 bisection steps without
  gradient: the integrand vanishes at the window's edges.
* The radius is drawn by rejection, each lane from a chi envelope (tight
  as sigma sqrt(c) -> 0) or a truncated-normal envelope (tight at large
  radius), as the reference's masked ``while_loop`` does. Here the rounds
  are data: a component's noise carries ``ROUNDS`` rounds of proposals
  (a Gamma(n/2) variate for the chi proposal, a standard normal for the
  truncated-normal one, an acceptance uniform on [1e-12, 1)), and each
  lane takes its first accepted round, or r = sigma when none of the
  128 accepts (the reference's cap), vectorised with no host-side loop.
  ``draw_rounds`` draws them from a ``torch.Generator`` (the gamma as a
  sum of exponentials, exact for the integer n); a test feeds the numbers
  the reference drew from its keys.
* The radius's gradient in (sigma, K) is the implicit reparameterization
  dr = -(dF/dtheta) / p(r) (Figurnov et al.), with F the quadrature CDF
  differentiated by autograd at the drawn radius.

Works on the Lorentz ('h') and Poincare ('d') models through the manifold
descriptor's distance and mu0-frame ops.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import stable
from . import normal
from .von_mises_fisher import _gamma_half_int, _uniform_open

# rejection rounds carried in the noise: the reference's loop cap
ROUNDS = 128

# 64-point Gauss-Legendre rule mapped to [0, 1] (float64; cast once per
# dtype and device, _gl_table)
_GL_X64, _GL_W64 = np.polynomial.legendre.leggauss(64)
_GL_X = (_GL_X64 + 1.0) / 2.0
_GL_W = _GL_W64 / 2.0
_GL_TABLES: dict = {}
# half-width of the integration window in units of sigma
_WINDOW = 12.0


def _c_of(k):
    return torch.clamp(-k, min=1e-30)


def _log_w_radial(n: int, s, sigma, c):
    """log w(s) = -s^2/2sigma^2 + (n-1) log(sinh(sqrt(c) s)/sqrt(c)), with
    sinh(sqrt(c) s)/sqrt(c) = s * sindiv_u(-c s^2), smooth at c s^2 -> 0."""
    return (-s * s / (2.0 * sigma * sigma)
            + (n - 1.0) * (stable.log_sindiv_u(-c * s * s)
                           + torch.log(torch.clamp(s, min=stable.tiny(
                               s.dtype)))))


@torch.no_grad()
def _window(n: int, sigma, c):
    """The integration window [lo, hi] around the radial mode, without
    gradient. The mode solves r / sigma^2 = (n-1) sqrt(c) coth(sqrt(c) r),
    found by 40 bisection steps."""
    sigma, c = sigma.detach(), c.detach()
    nm1 = n - 1.0
    sqc = torch.sqrt(c)
    hi0 = nm1 * sqc * sigma * sigma + sigma * math.sqrt(nm1 + 1.0)

    def h(r):
        # r - sigma^2 (n-1) sqrt(c) coth(sqrt(c) r); increasing in r
        x = torch.clamp(sqc * r, min=stable.tiny(r.dtype))
        coth = 1.0 / torch.tanh(torch.clamp(x, max=40.0))
        return r - sigma * sigma * nm1 * sqc * coth

    a = torch.zeros_like(hi0) + stable.tiny(sigma.dtype)
    b = hi0 + sigma
    for _ in range(40):
        m = 0.5 * (a + b)
        neg = h(m) < 0.0
        a, b = torch.where(neg, m, a), torch.where(neg, b, m)
    mode = 0.5 * (a + b)
    return (torch.clamp(mode - _WINDOW * sigma, min=0.0),
            mode + _WINDOW * sigma)


def _gl_table(dtype, device):
    """The GL-64 nodes and weights on [0, 1] as tensors, made once per
    (dtype, device) and cached: a copy from host memory cannot be captured
    into a CUDA graph, so the step that warms a graph up makes them."""
    table = _GL_TABLES.get((dtype, device))
    if table is None:
        table = _GL_TABLES[(dtype, device)] = (
            torch.as_tensor(_GL_X, dtype=dtype, device=device),
            torch.as_tensor(_GL_W, dtype=dtype, device=device))
    return table


def _log_integral(n: int, lo, hi, sigma, c):
    """log integral_lo^hi w(s) ds by GL-64, max-normalized."""
    dtype = sigma.dtype
    x, w = _gl_table(dtype, sigma.device)
    span = hi - lo
    s = lo[..., None] + span[..., None] * x
    logw = _log_w_radial(n, s, sigma[..., None], c[..., None]) + torch.log(w)
    m = torch.amax(logw, dim=-1)
    total = torch.sum(torch.exp(logw - m[..., None]), dim=-1)
    tiny = stable.tiny(dtype)
    return (m + torch.log(torch.clamp(total, min=tiny))
            + torch.log(torch.clamp(span, min=tiny)))


def log_partition(n: int, sigma, k):
    """log Z(sigma, K) of the n-dimensional Riemannian normal, K < 0:
    Z = S_{n-1} integral_0^inf w(s) ds."""
    c = _c_of(k) * torch.ones_like(sigma)
    lo, hi = _window(n, sigma, c)
    log_sphere = (math.log(2.0) + (n / 2.0) * math.log(math.pi)
                  - math.lgamma(n / 2.0))
    return log_sphere + _log_integral(n, lo, hi, sigma, c)


def log_prob(man, z, mu, sigma, k):
    """Exact log-density w.r.t. the Riemannian measure; sigma (...)."""
    d = man.distance(mu, z, k)
    return -d * d / (2.0 * sigma * sigma) - log_partition(man.dim, sigma, k)


# --- radial CDF / pdf (quadrature, for the implicit gradient) -----------------


def _radial_cdf(n: int, r, sigma, k):
    """F(r) = integral_0^r w / integral_0^inf w in [0, 1] (the mass below
    the window, ~e^-72, dropped from both)."""
    c = _c_of(k) * torch.ones_like(sigma)
    lo, hi = _window(n, sigma, c)
    m = torch.minimum(torch.maximum(r.detach(), lo), hi)
    log_num = _log_integral(n, lo, m, sigma, c)
    log_den = _log_integral(n, lo, hi, sigma, c)
    return torch.exp(torch.clamp(log_num - log_den, max=0.0))


def _radial_log_pdf(n: int, r, sigma, k):
    """log of the normalized radial density p(r) = w(r) / integral w."""
    c = _c_of(k) * torch.ones_like(sigma)
    lo, hi = _window(n, sigma, c)
    return _log_w_radial(n, r, sigma, c) - _log_integral(n, lo, hi, sigma, c)


# --- the rejection sampler ------------------------------------------------------


def draw_rounds(n: int, shape, like: torch.Tensor, generator=None):
    """The rejection rounds of one radius per lane of ``shape``:
    (*shape, 3 ROUNDS) = [Gamma(n/2) variates | standard normals |
    acceptance uniforms on [1e-12, 1)], with ``like``'s dtype and device."""
    shape = tuple(shape) + (ROUNDS,)
    return torch.cat([_gamma_half_int(n, shape, like, generator),
                      normal.standard_normal(shape, like, generator),
                      _uniform_open(shape, like, generator)], dim=-1)


def proposals(n: int, sigma, k, rounds):
    """Each round's proposed radius, log acceptance uniform and log
    acceptance threshold, each (..., R), for the lanes of ``sigma`` (...)
    and ``rounds`` (..., 3R); a round accepts where log u <= log_acc."""
    R = rounds.shape[-1] // 3
    gamma, xi, u = rounds[..., :R], rounds[..., R:2 * R], rounds[..., 2 * R:]
    c = _c_of(k) * torch.ones_like(sigma)
    sqc = torch.sqrt(c)[..., None]
    nm1 = n - 1.0
    # the chi envelope is valid and tight where sigma^2 c (n-1) / 3 < 0.9
    chi_ok = (sigma * sigma * c * nm1 / 3.0 < 0.9)[..., None]
    var_chi = sigma * sigma / torch.clamp(
        1.0 - sigma * sigma * c * nm1 / 3.0, min=0.1)
    sig_chi = torch.sqrt(var_chi)[..., None]
    mu_tn = (nm1 * torch.sqrt(c) * sigma * sigma)[..., None]
    # chi proposal: r = sig_chi sqrt(2 G), G ~ Gamma(n/2)
    r_chi = sig_chi * torch.sqrt(2.0 * gamma)
    x = sqc * r_chi
    log_acc_chi = nm1 * (stable.log_sindiv_u(-x * x) - x * x / 6.0)
    # truncated-normal proposal
    r_tn = mu_tn + sigma[..., None] * xi
    x_tn = sqc * torch.clamp(r_tn, min=0.0)
    log_acc_tn = torch.where(
        r_tn > 0.0,
        nm1 * torch.log1p(-torch.exp(-torch.clamp(2.0 * x_tn, min=1e-30))),
        -math.inf)
    r_prop = torch.where(chi_ok, r_chi, r_tn)
    log_acc = torch.where(chi_ok, log_acc_chi, log_acc_tn)
    return r_prop, torch.log(u), log_acc


@torch.no_grad()
def _sample_radius_raw(n: int, sigma, k, rounds):
    """The radius of each lane's first accepted round (sigma where none
    is), floored at 1e-30; no gradient."""
    sigma = sigma.detach()
    r_prop, log_u, log_acc = proposals(n, sigma, k.detach(), rounds)
    ok = log_u <= log_acc
    first = torch.argmax(ok.to(torch.int8), dim=-1, keepdim=True)
    r = torch.where(torch.any(ok, dim=-1),
                    torch.gather(r_prop, -1, first)[..., 0], sigma)
    return torch.clamp(r, min=1e-30)


class _SampleRadius(torch.autograd.Function):
    """The rejection radius with its implicit gradient in sigma and K."""

    @staticmethod
    def forward(ctx, n, sigma, k, rounds):
        r = _sample_radius_raw(n, sigma, k, rounds)
        ctx.n = n
        ctx.save_for_backward(r, sigma, k)
        return r

    @staticmethod
    def backward(ctx, g):
        r, sigma, k = ctx.saved_tensors
        n = ctx.n
        with torch.enable_grad():
            s = sigma.detach().requires_grad_(True)
            # one curvature per lane, so that dF/dk is per lane too
            kk = k.detach().expand(sigma.shape).clone().requires_grad_(True)
            dF_ds, dF_dk = torch.autograd.grad(
                _radial_cdf(n, r, s, kk).sum(), (s, kk))
        pdf = torch.exp(_radial_log_pdf(n, r, sigma, kk.detach()))
        inv = -g / torch.clamp(pdf, min=1e-20)
        grad_k = torch.sum(inv * dF_dk).reshape(k.shape)
        return None, inv * dF_ds, grad_k, None


def sample_radius(n: int, sigma, k, rounds):
    """The radius r > 0 per lane of ``rounds`` (..., 3R), reparameterized
    in sigma (broadcast to the lanes) and K (a scalar)."""
    return _SampleRadius.apply(n, sigma.expand(rounds.shape[:-1]), k, rounds)


def draw_noise(n: int, shape, like: torch.Tensor, generator=None):
    """One draw's standard noise (*shape, n + 3 ROUNDS): the direction's
    normals, then ``draw_rounds``."""
    return torch.cat([normal.standard_normal(tuple(shape) + (n,), like,
                                             generator),
                      draw_rounds(n, shape, like, generator)], dim=-1)


def sample(man, mu, sigma, k, noise=None, generator=None):
    """Draw z ~ RiemannianNormal(mu, sigma) on the hyperbolic manifold
    ``man``. sigma: (...) isotropic scale. noise: (..., n + 3 ROUNDS) as
    ``draw_noise`` (it may carry extra leading sample dims), drawn from
    ``generator`` when not given."""
    n = man.dim
    if noise is None:
        noise = draw_noise(n, mu.shape[:-1], mu, generator)
    r = sample_radius(n, sigma, k, noise[..., n:])
    g = noise[..., :n]
    direction = g / stable.safe_norm(g, keepdim=True)
    return man.sample_projection_mu0(r[..., None] * direction, mu, k)


def sample_and_log_prob(man, mu, sigma, k, noise=None, generator=None):
    z = sample(man, mu, sigma, k, noise, generator)
    return z, log_prob(man, z, mu, sigma, k)
