"""Special functions for the vMF path, float32-safe.

PyTorch counterpart of ``mvae_tpu/utils/special.py``:

* ``log_ive(nu, x)`` -- log(I_nu(x) e^{-x}) for scalar nu >= 0 and x >= 0.
  Three branches: the ascending series in log-space below x = 40 (any
  nu); the Hankel asymptotic above for nu <= 8; the uniform (Debye)
  large-order asymptotic through u_4 above for nu > 8, where the Hankel
  series diverges near the switch point.
* ``bessel_ratio(nu, x)`` -- I_{nu+1}(x) / I_nu(x), the vMF mean resultant
  length at nu = m/2 - 1.
"""
from __future__ import annotations

import math

import torch

_SERIES_TERMS = 64
_SWITCH_X = 40.0
_NU_DEBYE = 8.0


def _log_ive_series(nu: float, x):
    """logsumexp over the ascending series of I_nu, minus x (scaling)."""
    x = torch.clamp(x, min=1e-30)
    j = torch.arange(_SERIES_TERMS, dtype=x.dtype, device=x.device)
    log_half_x = torch.log(x[..., None] / 2.0)
    terms = ((nu + 2.0 * j) * log_half_x
             - torch.lgamma(j + 1.0) - torch.lgamma(nu + j + 1.0))
    return torch.logsumexp(terms, dim=-1) - x


def _log_ive_asymptotic(nu: float, x):
    """Hankel expansion: I_nu(x) e^{-x} ~ (2 pi x)^{-1/2} * sum_k a_k."""
    mu = 4.0 * nu * nu
    xc = torch.clamp(x, min=1.0)
    inv8x = 1.0 / (8.0 * xc)
    s = torch.ones_like(x)
    a = torch.ones_like(x)
    for kk in range(1, 7):
        a = -a * (mu - (2.0 * kk - 1.0) ** 2) * inv8x / kk
        s = s + a
    s = torch.clamp(s, min=1e-12)
    return -0.5 * torch.log(2.0 * math.pi * xc) + torch.log(s)


def _log_ive_debye(nu: float, x):
    """Uniform large-order (Debye) asymptotic for I_nu(x) e^{-x}
    (A&S 9.7.7; polynomials 9.3.9/9.3.10 through u_4); error O(nu^-5)."""
    nu_s = max(nu, 1.0)
    z = x / nu_s
    sq = torch.sqrt(1.0 + z * z)
    t = 1.0 / sq
    eta = sq + torch.log(z / (1.0 + sq))
    t2 = t * t
    u1 = t * (3.0 - 5.0 * t2) / 24.0
    u2 = t2 * (81.0 + t2 * (-462.0 + 385.0 * t2)) / 1152.0
    u3 = (t * t2 * (30375.0 + t2 * (-369603.0
                    + t2 * (765765.0 - 425425.0 * t2)))) / 414720.0
    u4 = (t2 * t2 * (4465125.0 + t2 * (-94121676.0
                     + t2 * (349922430.0 + t2 * (-446185740.0
                             + 185910725.0 * t2))))) / 39813120.0
    inv = 1.0 / nu_s
    s = 1.0 + inv * (u1 + inv * (u2 + inv * (u3 + inv * u4)))
    return (nu_s * eta - x - 0.5 * math.log(2.0 * math.pi * nu_s)
            - 0.5 * torch.log(sq) + torch.log(torch.clamp(s, min=1e-12)))


def log_ive(nu: float, x):
    """log(I_nu(x) * exp(-x)) for x >= 0, elementwise in x; nu a scalar."""
    nu = float(nu)
    small = x < _SWITCH_X
    x_small = torch.where(small, x, torch.ones_like(x))
    x_big = torch.where(small, torch.full_like(x, _SWITCH_X + 1.0), x)
    # Hankel needs x >> nu^2; large orders take the uniform Debye form
    if nu > _NU_DEBYE:
        big = _log_ive_debye(nu, x_big)
    else:
        big = _log_ive_asymptotic(nu, x_big)
    return torch.where(small, _log_ive_series(nu, x_small), big)


def bessel_ratio(nu: float, x):
    """A(x) = I_{nu+1}(x) / I_nu(x), from log_ive (scale factors cancel)."""
    return torch.exp(log_ive(nu + 1.0, x) - log_ive(nu, x))
