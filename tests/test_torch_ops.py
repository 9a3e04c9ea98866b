"""mvae_torch ops (stable scalar math, special functions, Lorentz and sphere
geometry) against the JAX package on the same numpy inputs.

Tolerances: 1e-10 in float64 (the two packages evaluate the same
expressions; what remains is the libraries' own last-digit differences in
exp/log/lgamma) and 1e-5 in float32 (a few ulps of float32 through chains
of a dozen transcendentals), relative with an equal absolute floor. The
JAX side runs under jit, so XLA's fusion rounds differently from PyTorch's
op-by-op evaluation; float32 cases stay where the functions are
well-conditioned in float32 (hyperbolic radii up to 1, Bessel orders up to
4 -- the vMF path uses orders 0.5 and 1.5), and float64 covers the rest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.kernels import manifold_kernels as jmk
from mvae_tpu.kernels import tail_kernels as jtk
from mvae_tpu.ops import lorentz as jl
from mvae_tpu.ops import sphere as js
from mvae_tpu.ops import stable as jst
from mvae_tpu.utils import special as jsp
from mvae_torch.ops import lorentz as tl
from mvae_torch.ops import sphere as ts
from mvae_torch.ops import stable as tst
from mvae_torch.utils import special as tsp

DTYPES = [pytest.param(np.float64, 1e-10, id="f64"),
          pytest.param(np.float32, 1e-5, id="f32")]

# u = K r^2 on both sides of the |u| < 1e-2 series window, at its edges,
# and K -> 0 (u ~ 1e-12)
_EDGE = [0.0, 1e-12, 1e-6, 1e-3, 5e-3, 9.99e-3, 1e-2, 1.001e-2, 0.02, 0.1,
         0.5, 1.0, 2.0, 4.0]
U_NEG = np.array([-v for v in _EDGE] + [-9.0, -30.0, -100.0, -400.0])
U_POS = np.array(_EDGE + [6.0, 9.0])
U_ALL = np.concatenate([U_NEG, U_POS])


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


def _both(a, dtype):
    a = np.asarray(a, dtype)
    return torch.from_numpy(a.copy()), jnp.asarray(a)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name,points", [
    ("sindiv_u", U_ALL), ("cos_u", U_ALL), ("log_sindiv_u", U_ALL),
    ("log_sindiv_u_soft", U_ALL), ("arcsindiv_u", U_NEG),
    ("acosh_1p", U_POS)])
def test_stable_series_functions(name, points, dtype, tol):
    t, j = _both(points, dtype)
    _close(getattr(tst, name)(t), jax.jit(getattr(jst, name))(j), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_arcsindiv_positive_branch(dtype, tol):
    w = np.array([0.0, 1e-3, 9.99e-3, 1.001e-2, 0.3, 0.9, 0.999])
    t, j = _both(w, dtype)
    _close(tst.arcsindiv_u(t), jax.jit(jst.arcsindiv_u)(j), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("sign", [-1, 0, 1])
def test_sign_specialised_kernel_forms(sign, dtype, tol):
    """The forms the tail kernel evaluates (exp-based cosh/sinh)."""
    pts = {-1: U_NEG, 1: U_POS, 0: U_ALL}[sign]
    t, j = _both(pts, dtype)
    ref = jax.jit(lambda u: (jtk._cos_u_sgn(u, sign),
                             jmk._log_sindiv_u_sgn(u, sign),
                             jmk._log_sindiv_u_sgn_soft(u, sign),
                             jmk._sindiv_u_kernel(u)))(j)
    _close(tst._cos_u_sgn(t, sign), ref[0], tol)
    _close(tst._log_sindiv_u_sgn(t, sign), ref[1], tol)
    _close(tst._log_sindiv_u_sgn_soft(t, sign), ref[2], tol)
    _close(tst._sindiv_u_kernel(t), ref[3], tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_acosh_1p_kernel_form(dtype, tol):
    t, j = _both(U_POS, dtype)
    _close(tst._acosh_1p(t), jax.jit(jtk._acosh_1p)(j), tol)


def test_eps_tiny_tables():
    for td, jd in ((torch.float64, jnp.float64), (torch.float32,
                                                  jnp.float32)):
        assert tst.eps(td) == jst.eps(jd)
        assert tst.tiny(td) == jst.tiny(jd)


@pytest.mark.parametrize("nu,dtype,tol", [
    (nu, np.float64, 1e-10) for nu in (0.5, 1.5, 4.0, 15.5)] + [
    (nu, np.float32, 1e-5) for nu in (0.5, 1.5, 4.0)])
def test_log_ive_and_bessel_ratio(nu, dtype, tol):
    """All three branches: series (x < 40), Hankel (nu <= 8), Debye."""
    x = np.array([1e-3, 0.5, 1.0, 5.0, 20.0, 39.9, 40.1, 100.0, 1000.0])
    t, j = _both(x, dtype)
    ref = jax.jit(lambda x: (jsp.log_ive(nu, x), jsp.bessel_ratio(nu, x)))(j)
    _close(tsp.log_ive(nu, t), ref[0], tol)
    _close(tsp.bessel_ratio(nu, t), ref[1], tol)


def _points(rng, n, dim, dtype):
    """Tangent vectors at radii from deep inside the series window to
    well outside it (radius 3 in float64 only)."""
    scales = (1e-4, 1e-2, 0.3, 1.0) + ((3.0,) if dtype == np.float64 else ())
    v = rng.standard_normal((len(scales) * n, dim))
    v *= np.repeat(np.asarray(scales), n)[:, None] / np.linalg.norm(
        v, axis=1, keepdims=True)
    return v.astype(dtype)


def _geometry(m, v, w, k):
    """exp/log at mu0, distance, push-forward and its inverse."""
    x = m.exp_map_mu0(v, k)
    y = m.exp_map_mu0(w, k)
    return (x, m.log_map_mu0(x, k), m.distance(x, y, k),
            m.sample_projection_mu0(w, x, k),
            m.inverse_sample_projection_mu0(y, x, k))


def _check_geometry(tmod, jmod, tv, tw, tk_, jv, jw, jk, tol):
    ref = jax.jit(lambda v, w, k: _geometry(jmod, v, w, k))(jv, jw, jk)
    for ours, theirs in zip(_geometry(tmod, tv, tw, tk_), ref):
        _close(ours, theirs, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("k", [-1.0, -1e-3, -4.0])
def test_lorentz_against_reference(k, dtype, tol):
    rng = np.random.default_rng(0)
    v = _points(rng, 6, 3, dtype)
    w = _points(rng, 6, 3, dtype)
    tk_, jk = _both(k, dtype)
    tv, jv = _both(v, dtype)
    tw, jw = _both(w, dtype)
    _check_geometry(tl, jl, tv, tw, tk_, jv, jw, jk, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("k", [1.0, 1e-3, 4.0])
def test_sphere_against_reference(k, dtype, tol):
    rng = np.random.default_rng(1)
    v = _points(rng, 6, 2, dtype)
    w = _points(rng, 6, 2, dtype)
    tk_, jk = _both(k, dtype)
    tv, jv = _both(v, dtype)
    tw, jw = _both(w, dtype)
    _check_geometry(ts, js, tv, tw, tk_, jv, jw, jk, tol)
