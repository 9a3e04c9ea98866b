"""L0: numerically stable scalar math, safe in float32.

PyTorch counterpart of ``mvae_tpu/ops/stable.py``: the same algebraically
stable reformulations, copied expression for expression so that the port
and the reference agree to rounding.

* ``acosh(1+u)`` as ``log1p(u + sqrt(u*(u+2)))`` -- no cancellation near 1.
* sinc-family ratios (``sin_k(r)/r`` etc.) via one analytic series in
  ``u = K r**2`` that is smooth through K = 0, with closed forms outside
  the series window ``|u| < 1e-2``. Precision at the window edges is the
  main numerical risk of the port, so the window, the sanitized branch
  inputs and the polynomial coefficients are kept exactly.
* the `where`-trick: both branches are evaluated on sanitized inputs, so a
  gradient never sees NaN from the branch that is not selected.

The ``_sgn`` variants (and ``_cos_u_sgn`` / ``_sindiv_u_kernel``) are the
forms the fused tail kernel traces: cosh/sinh through ``exp`` clipped at
85, and the branch a curvature-pinned kind cannot take dropped. The CUDA
tail kernel (``kernels/csrc/tail_fwd.cu``) evaluates these same
expressions.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

# Window |u| < _SERIES_CUTOFF where the power series in u = K * r**2 is used.
# The series are truncated so the relative truncation error at the cutoff
# is < 1e-14: exact to f64 test tolerance and far below f32 eps.
_SERIES_CUTOFF = 1e-2


def eps(dtype) -> float:
    """Dtype-dependent epsilon for domain clamping."""
    if dtype == torch.float64:
        return 1e-12
    if dtype == torch.float32:
        return 1e-6
    return 1e-3  # bfloat16 / float16


def tiny(dtype) -> float:
    """Additive guard for sqrt/log arguments (value-preserving to ~eps**2)."""
    if dtype == torch.float64:
        return 1e-30
    if dtype == torch.float32:
        return 1e-15
    return 1e-7


def softplus(x: Tensor) -> Tensor:
    """log(1 + e^x) in the overflow-free form max(x, 0) + log1p(e^-|x|)
    (the form ``jax.nn.softplus`` evaluates; no threshold cut-over)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def safe_norm(x: Tensor, dim: int = -1, keepdim: bool = False) -> Tensor:
    """L2 norm with a finite gradient at 0 (adds `tiny` under the sqrt)."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim)
                      + tiny(x.dtype))


def acosh_1p(u: Tensor) -> Tensor:
    """acosh(1 + u) for u >= 0, stable near u = 0."""
    u = torch.clamp(u, min=0.0)
    return torch.log1p(u + torch.sqrt(u * (u + 2.0)))


def cosh_clamped(x: Tensor, max_arg: float = 85.0) -> Tensor:
    return torch.cosh(torch.clamp(x, -max_arg, max_arg))


def sinh_clamped(x: Tensor, max_arg: float = 85.0) -> Tensor:
    return torch.sinh(torch.clamp(x, -max_arg, max_arg))


def _split_series_window(u: Tensor):
    """Returns (in_window, u_series, u_closed) with sanitized branch inputs."""
    small = torch.abs(u) < _SERIES_CUTOFF
    zero = torch.zeros_like(u)
    u_series = torch.where(small, u, zero)
    u_closed = torch.where(small, torch.sign(u) * 4.0 * _SERIES_CUTOFF + 1e-8,
                           u)
    return small, u_series, u_closed


def _poly(u: Tensor, coeffs) -> Tensor:
    """Horner evaluation of 1 + c1*u + c2*u^2 + ... (coeffs = [c1, c2, ...])."""
    acc = torch.zeros_like(u)
    for c in reversed(coeffs):
        acc = u * (acc + c)
    return 1.0 + acc


_SINDIV = [-1.0 / 6, 1.0 / 120, -1.0 / 5040, 1.0 / 362880]
_COS = [-1.0 / 2, 1.0 / 24, -1.0 / 720, 1.0 / 40320]
_ARCSINDIV = [1.0 / 6, 3.0 / 40, 15.0 / 336, 105.0 / 3456]


def _log_sindiv_series(us: Tensor) -> Tensor:
    """log(sin(sqrt(u))/sqrt(u)) inside the window: log1p of the series of
    sindiv - 1, which is accurate directly."""
    sd_m1 = us * (-1.0 / 6 + us * (1.0 / 120 + us * (-1.0 / 5040
                                                     + us * (1.0 / 362880))))
    return torch.log1p(sd_m1)


def sindiv_u(u: Tensor) -> Tensor:
    """sin(sqrt(u))/sqrt(u), analytic in u (=> sinh for u < 0)."""
    small, us, uc = _split_series_window(u)
    series = _poly(us, _SINDIV)
    su = torch.sqrt(torch.abs(uc))
    closed = torch.where(uc > 0, torch.sin(su) / su, sinh_clamped(su) / su)
    return torch.where(small, series, closed)


def cos_u(u: Tensor) -> Tensor:
    """cos(sqrt(u)), analytic in u (=> cosh for u < 0)."""
    small, us, uc = _split_series_window(u)
    series = _poly(us, _COS)
    su = torch.sqrt(torch.abs(uc))
    closed = torch.where(uc > 0, torch.cos(su), cosh_clamped(su))
    return torch.where(small, series, closed)


def arcsindiv_u(w: Tensor) -> Tensor:
    """asin(sqrt(w))/sqrt(w), analytic in w (=> arsinh for w < 0).

    Callers must keep w <= 1 when w > 0; clamped at 1 - eps.
    """
    small, ws, wc = _split_series_window(w)
    series = _poly(ws, _ARCSINDIV)
    e = eps(w.dtype)
    sw_pos = torch.sqrt(torch.clamp(wc, tiny(w.dtype), 1.0 - e))
    sw_neg = torch.sqrt(torch.clamp(-wc, min=tiny(w.dtype)))
    closed = torch.where(wc > 0, torch.asin(sw_pos) / sw_pos,
                         torch.asinh(sw_neg) / sw_neg)
    return torch.where(small, series, closed)


def log_sindiv_u(u: Tensor) -> Tensor:
    """log(sin(sqrt(u))/sqrt(u)), analytic in u (=> log(sinh .../...) u < 0).

    The wrapped-normal log-det radial term per unit dimension; stable both
    near r = 0 (series via log1p) and for large hyperbolic radius (linear
    form)."""
    small, us, uc = _split_series_window(u)
    series = _log_sindiv_series(us)
    su = torch.sqrt(torch.abs(uc))
    e = eps(u.dtype)
    x_sph = torch.clamp(su, e, math.pi * (1.0 - 1e-6))
    sph = torch.log(torch.sin(x_sph) / x_sph)
    hyp = _log_sinhdiv(su)
    closed = torch.where(uc > 0, sph, hyp)
    return torch.where(small, series, closed)


def _log_sinhdiv(su: Tensor) -> Tensor:
    """log(sinh(x)/x) = x + log1p(-exp(-2x)) - log(2x), overflow-free."""
    return su + torch.log1p(-torch.exp(-2.0 * su)) - torch.log(2.0 * su)


# Mollification width for the wrapped-normal log-det near the positive-K
# injectivity shell (see log_abs_sin_soft); the reference's default.
SHELL_DELTA = 1e-3


def log_abs_sin_soft(x: Tensor, taper_x: Tensor | None = None,
                     delta: float = SHELL_DELTA) -> Tensor:
    """log|sin x| with a smooth floor near the sin zeros at m pi, m >= 1:
    0.5 log(sin^2 x + d^2), d = delta * min(taper_x/pi, 1)^3 (the
    removable zero at taper_x = 0 stays exact)."""
    s = torch.sin(x)
    t = torch.clamp((x if taper_x is None else taper_x) * (1.0 / math.pi),
                    max=1.0)
    d = delta * t * t * t
    return 0.5 * torch.log(s * s + d * d)


def log_sindiv_u_soft(u: Tensor) -> Tensor:
    """log_sindiv_u with the mollified spherical closed branch (bounded
    derivative at the injectivity shell u = pi^2; identical elsewhere).
    Wrapped-normal density paths use this form."""
    small, us, uc = _split_series_window(u)
    series = _log_sindiv_series(us)
    su = torch.sqrt(torch.abs(uc))
    e = eps(u.dtype)
    sph = log_abs_sin_soft(su) - torch.log(torch.clamp(su, min=e))
    hyp = _log_sinhdiv(su)
    closed = torch.where(uc > 0, sph, hyp)
    return torch.where(small, series, closed)


# --- the forms the fused tail kernel evaluates --------------------------------


def _sindiv_u_kernel(u: Tensor) -> Tensor:
    """sindiv_u with the sinh branch through exp (clipped at 85); same
    series window and clamps."""
    small, us, uc = _split_series_window(u)
    series = _poly(us, _SINDIV)
    su = torch.sqrt(torch.abs(uc))
    sc = torch.clamp(su, -85.0, 85.0)
    sinh = 0.5 * (torch.exp(sc) - torch.exp(-sc))
    closed = torch.where(uc > 0, torch.sin(su) / su, sinh / su)
    return torch.where(small, series, closed)


def _cos_u_sgn(u: Tensor, sign: int) -> Tensor:
    """cos_u with cosh through exp; a curvature-pinned kind drops the
    branch it cannot take."""
    small, us, uc = _split_series_window(u)
    series = _poly(us, _COS)
    x = torch.sqrt(torch.abs(uc))
    xc = torch.clamp(x, 0.0, 85.0)
    cosh = 0.5 * (torch.exp(xc) + torch.exp(-xc))
    if sign > 0:
        closed = torch.cos(x)
    elif sign < 0:
        closed = cosh
    else:
        closed = torch.where(uc > 0, torch.cos(x), cosh)
    return torch.where(small, series, closed)


def _log_sindiv_u_sgn(u: Tensor, sign: int) -> Tensor:
    """log_sindiv_u specialised on the sign of the curvature."""
    small, us, uc = _split_series_window(u)
    series = _log_sindiv_series(us)
    e = eps(u.dtype)
    su = torch.sqrt(torch.abs(uc))
    x_sph = torch.clamp(su, e, math.pi * (1.0 - 1e-6))
    if sign > 0:
        closed = torch.log(torch.sin(x_sph) / x_sph)
    elif sign < 0:
        closed = _log_sinhdiv(su)
    else:
        closed = torch.where(uc > 0, torch.log(torch.sin(x_sph) / x_sph),
                             _log_sinhdiv(su))
    return torch.where(small, series, closed)


def _log_sindiv_u_sgn_soft(u: Tensor, sign: int) -> Tensor:
    """_log_sindiv_u_sgn with the mollified spherical branch."""
    small, us, uc = _split_series_window(u)
    series = _log_sindiv_series(us)
    e = eps(u.dtype)
    su = torch.sqrt(torch.abs(uc))
    sph = log_abs_sin_soft(su) - torch.log(torch.clamp(su, min=e))
    if sign > 0:
        closed = sph
    elif sign < 0:
        closed = _log_sinhdiv(su)
    else:
        closed = torch.where(uc > 0, sph, _log_sinhdiv(su))
    return torch.where(small, series, closed)


def _acosh_1p(u: Tensor) -> Tensor:
    """The tail kernel's acosh(1 + u) (no clamp of the outer u)."""
    return torch.log1p(u + torch.sqrt(torch.clamp(u, min=0.0) * (u + 2.0)))


# --- in terms of (r, K) -------------------------------------------------------


def arcsin_k(y: Tensor, k: Tensor) -> Tensor:
    """Inverse of sin_k: asin(sqrt(K) y)/sqrt(K); arsinh-form for K < 0."""
    return y * arcsindiv_u(k * y * y)
