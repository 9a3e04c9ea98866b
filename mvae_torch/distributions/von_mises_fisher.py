"""von Mises-Fisher distribution on the sphere.

Counterpart of ``mvae_tpu/distributions/von_mises_fisher.py``: the cosine
w = <mu, z> by the exact inverse CDF for m = 3 (the ``s2`` latent) and by
the Wood (1994) rejection scheme otherwise, a Householder reflection to the
mean direction, log C_m(kappa) through the scaled Bessel function, and the
analytic KL to the hyperspherical uniform prior.

The rejection scheme has no loop: ``OVERSAMPLE`` proposals per lane are
drawn at once and the first accepted one is taken (all rejected with
probability ~3e-8: the lane takes the envelope's mode). The proposals are
data, not code: ``wood_proposals`` draws them (Beta variates and acceptance
uniforms) from a ``torch.Generator``, and ``sample`` takes them as an
optional tensor, so a test can feed the numbers another implementation
drew. The accepted cosine has no gradient of its own; its gradient in
kappa is the implicit reparameterization dw/dkappa = -(dF/dkappa) / p(w)
(Figurnov et al.), with the marginal CDF's pieces by Gauss-Legendre
quadrature under the substitution xi = kappa (w - t), which keeps the nodes
on the O(1 / kappa)-wide integrand at any concentration.

Points live on the radius-R sphere (R = 1/sqrt(K)); densities are w.r.t.
the Riemannian surface measure, so the (m-1) log R area term appears in
log_prob but cancels in every KL / IWAE weight.
"""
from __future__ import annotations

import math

import numpy as np
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


# --- the Wood rejection cosine (m != 3) ----------------------------------------

OVERSAMPLE = 16  # proposals drawn at once; P(all rejected) <~ 0.34^16 ~ 3e-8
_P_MIN = 1e-12   # lower end of the proposals' uniforms


def _wood_b(m: int, kappa):
    """b of Wood's envelope, in the overflow-free form
    (m - 1) / (2 kappa + sqrt(4 kappa^2 + (m - 1)^2))."""
    mm1 = m - 1.0
    return mm1 / (2.0 * kappa + torch.sqrt(4.0 * kappa * kappa + mm1 * mm1))


def _w_from_eps(eps, b):
    return (1.0 - (1.0 + b) * eps) / (1.0 - (1.0 - b) * eps)


def _uniform_open(shape, like, generator):
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=like.device)
    return _P_MIN + (1.0 - _P_MIN) * u


def _gamma_half_int(a2: int, shape, like, generator):
    """Gamma(a2 / 2, 1) for an integer a2 >= 1 without a loop: the sum of
    a2 // 2 exponentials plus (a2 odd) half a squared standard normal."""
    out = torch.zeros(shape, dtype=like.dtype, device=like.device)
    if a2 // 2:
        u = _uniform_open(tuple(shape) + (a2 // 2,), like, generator)
        out = -torch.sum(torch.log(u), dim=-1)
    if a2 % 2:
        z = normal.standard_normal(shape, like, generator)
        out = out + 0.5 * z * z
    return out


def _beta_sym_half_int(a2: int, shape, like, generator):
    """Beta(a2 / 2, a2 / 2) by the exact gamma composition."""
    g1 = _gamma_half_int(a2, shape, like, generator)
    g2 = _gamma_half_int(a2, shape, like, generator)
    return g1 / torch.clamp(g1 + g2, min=1e-30)


def wood_proposals(m: int, shape, like: torch.Tensor, generator=None):
    """The random numbers of one rejection draw per lane of ``shape``:
    (*shape, 2 OVERSAMPLE) = [Beta((m-1)/2, (m-1)/2) variates, acceptance
    uniforms on [1e-12, 1)], with ``like``'s dtype and device."""
    shape = tuple(shape) + (OVERSAMPLE,)
    return torch.cat([_beta_sym_half_int(m - 1, shape, like, generator),
                      _uniform_open(shape, like, generator)], dim=-1)


def _sample_w_raw(m: int, kappa, proposals):
    """The cosine w in [-1, 1] by rejection (Wood 1994), without gradient:
    each lane's first accepted proposal, or the envelope's mode x0 where all
    are rejected."""
    kappa = kappa.detach()
    b = _wood_b(m, kappa)
    x0 = (1.0 - b) / (1.0 + b)
    mm1 = m - 1.0
    c = kappa * x0 + mm1 * torch.log1p(-x0 * x0)
    eps, u = proposals[..., :OVERSAMPLE], proposals[..., OVERSAMPLE:]
    w = _w_from_eps(eps, b[..., None])
    ok = (kappa[..., None] * w
          + mm1 * torch.log1p(-torch.clamp(x0[..., None] * w, max=1.0 - 1e-7))
          - c[..., None]) >= torch.log(u)
    first = torch.argmax(ok.to(torch.int8), dim=-1, keepdim=True)
    w_first = torch.gather(w, -1, first)[..., 0]
    return torch.where(torch.any(ok, dim=-1), w_first, x0)


_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(32)
_XI_CAP = 30.0  # e^{-30} ~ 1e-13: where the quadrature's tail is cut
_GL_TABLES: dict = {}


def _gl_table(dtype, device):
    """The GL-32 nodes and half weights as tensors, made once per (dtype,
    device) and cached: a copy from host memory cannot be captured into a
    CUDA graph, so the step that warms a graph up makes them."""
    table = _GL_TABLES.get((dtype, device))
    if table is None:
        table = _GL_TABLES[(dtype, device)] = (
            torch.as_tensor(_GL_NODES, dtype=dtype, device=device),
            0.5 * torch.as_tensor(_GL_WEIGHTS, dtype=dtype, device=device))
    return table


def _quad_hat_integrals(w, kappa, alpha):
    """(I_hat, J_hat) with X_hat = int_{-1}^w e^{kappa (t - w)}
    (1 - t^2)^alpha (* t for J) dt, under xi = kappa (w - t)."""
    kap = torch.clamp(kappa, min=1e-6)
    xi_cap = torch.clamp(kap * (w + 1.0), max=_XI_CAP)
    nodes, wq = _gl_table(w.dtype, w.device)
    xi = xi_cap[..., None] * (0.5 * (nodes + 1.0))    # nodes on [0, 1]
    t = w[..., None] - xi / kap[..., None]
    base = torch.exp(-xi) * torch.clamp(
        1.0 - t * t, min=stable.tiny(w.dtype)) ** alpha
    scale = (xi_cap / kap)[..., None]
    return (torch.sum(base * wq * scale, dim=-1),
            torch.sum(base * t * wq * scale, dim=-1))


def _dw_dkappa(m: int, w, kappa):
    """The implicit reparameterization gradient of the accepted cosine."""
    alpha = (m - 3.0) / 2.0
    i_hat, j_hat = _quad_hat_integrals(w, kappa, alpha)
    a_mean = bessel_ratio(m / 2.0 - 1.0, kappa)
    dens = torch.clamp(1.0 - w * w, min=stable.tiny(w.dtype)) ** alpha
    return -(j_hat - i_hat * a_mean) / torch.clamp(dens, min=1e-30)


class _SampleW(torch.autograd.Function):
    """The rejection cosine with its implicit gradient in kappa."""

    @staticmethod
    def forward(ctx, m, kappa, proposals):
        w = _sample_w_raw(m, kappa, proposals)
        ctx.m = m
        ctx.save_for_backward(w, kappa)
        return w

    @staticmethod
    def backward(ctx, g):
        w, kappa = ctx.saved_tensors
        return None, g * _dw_dkappa(ctx.m, w, kappa.detach()), None


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


def sample(mu, kappa, k, noise=None, generator=None, proposals=None):
    """Reparameterized draw on the radius-R sphere.

    mu: (..., m) ambient mean direction (any radius; normalized inside).
    kappa: (...) concentration. k: curvature (R = 1/sqrt(k)).
    noise: (..., m) = [u, g_1 .. g_{m-1}]: the uniform of the m = 3 inverse
    CDF (not read for m != 3) and the standard normals for the tangent
    direction. proposals: (..., 2 OVERSAMPLE), the rejection draw's numbers
    for m != 3 (``wood_proposals``). Each is drawn from ``generator`` when
    not given.
    """
    m = mu.shape[-1]
    if noise is None:
        noise = torch.cat([uniform(kappa.shape + (1,), mu, generator),
                           normal.standard_normal(mu.shape[:-1] + (m - 1,),
                                                  mu, generator)], dim=-1)
    if m == 3:
        w = _sample_w_m3(kappa, noise[..., 0])
    else:
        if proposals is None:
            proposals = wood_proposals(m, kappa.shape, mu, generator)
        w = _SampleW.apply(m, kappa, proposals)
    g = noise[..., 1:m]
    v = g / stable.safe_norm(g, keepdim=True)
    sin_w = torch.sqrt(torch.clamp(1.0 - w * w, min=stable.tiny(mu.dtype)))
    zprime = torch.cat([w[..., None], sin_w[..., None] * v], dim=-1)
    z_unit = _householder_rotate(zprime, _unit(mu))
    r = 1.0 / torch.sqrt(torch.clamp(k, min=1e-30))
    return z_unit * r.to(mu.dtype)


def sample_and_log_prob(mu, kappa, k, noise=None, generator=None,
                        proposals=None):
    """A draw z (``sample``, its noise and proposals given or drawn from
    ``generator``) and its log q(z)."""
    z = sample(mu, kappa, k, noise, generator, proposals)
    return z, log_prob(z, mu, kappa, k)


def mean_resultant_length(m: int, kappa):
    """A_m(kappa) = I_{m/2}(kappa) / I_{m/2-1}(kappa) = E[<mu, z>]."""
    return bessel_ratio(m / 2.0 - 1.0, kappa)


def kl_to_uniform(m: int, kappa):
    """Analytic KL(vMF(mu, kappa) || Uniform(S^{m-1})); radius-independent."""
    unit_area = (math.log(2.0) + (m / 2.0) * math.log(math.pi)
                 - math.lgamma(m / 2.0))
    return (kappa * mean_resultant_length(m, kappa)
            + log_normalizer(m, kappa) + unit_area)
