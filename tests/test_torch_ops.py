"""mvae_torch ops (stable scalar math, special functions, Lorentz, sphere
and kappa-stereographic geometry) against the JAX package on the same numpy
inputs.

Tolerances: 1e-10 in float64 (the two packages evaluate the same
expressions; what remains is the libraries' own last-digit differences in
exp/log/lgamma) and 1e-5 in float32 (a few ulps of float32 through chains
of a dozen transcendentals), relative with an equal absolute floor. The
JAX side runs under jit, so XLA's fusion rounds differently from PyTorch's
op-by-op evaluation; float32 cases stay where the functions are
well-conditioned in float32 (hyperbolic radii up to 1, Bessel orders up to
4 -- the vMF path uses orders 0.5 and 1.5), and float64 covers the rest.
The reference's kernel forms spell atan as a polynomial within 6.3e-9 of
it, so ``_arctandiv_u_sgn`` in float64 is held to 1e-7 on its positive
closed branch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.kernels import manifold_kernels as jmk
from mvae_tpu.kernels import tail_kernels as jtk
from mvae_tpu.ops import lorentz as jl
from mvae_tpu.ops import poincare as jpo
from mvae_tpu.ops import sphere as js
from mvae_tpu.ops import spherical_projected as jsproj
from mvae_tpu.ops import stable as jst
from mvae_tpu.ops import stereographic as jstereo
from mvae_tpu.ops import universal as juni
from mvae_tpu.utils import special as jsp
from mvae_torch.ops import Manifold
from mvae_torch.ops import lorentz as tl
from mvae_torch.ops import poincare as tpo
from mvae_torch.ops import sphere as ts
from mvae_torch.ops import spherical_projected as tsproj
from mvae_torch.ops import stable as tst
from mvae_torch.ops import stereographic as tstereo
from mvae_torch.ops import universal as tuni
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


# --- the kappa-stereographic family -------------------------------------------

# w = K |z|^2 > -1 for arctandiv; u < (pi/2)^2 for tandiv
W_ATAN = np.array([-0.999, -0.9, -0.5, -0.1] + [-v for v in _EDGE[:11]]
                  + _EDGE + [9.0, 100.0])
U_TAN = np.array([-v for v in _EDGE] + [-9.0, -30.0, -400.0] + _EDGE[:13]
                 + [2.2])


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name,points", [
    ("tandiv_u", U_TAN), ("arctandiv_u", W_ATAN),
    ("atanh_clamped", np.array([-1.5, -1.0, -0.9, 0.0, 1e-4, 0.5, 0.999,
                                1.0, 2.0]))])
def test_stereographic_series_functions(name, points, dtype, tol):
    t, j = _both(points, dtype)
    _close(getattr(tst, name)(t), jax.jit(getattr(jst, name))(j), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("sign", [-1, 0, 1])
def test_stereographic_kernel_forms(sign, dtype, tol):
    """The sign-specialised forms the stereographic tile evaluates; the
    reference's use sin / cos for tan and a polynomial for atan."""
    keep = {-1: lambda a: a[a <= 0], 1: lambda a: a[a >= 0],
            0: lambda a: a}[sign]
    t, j = _both(keep(U_TAN), dtype)
    _close(tst._tandiv_u_sgn(t, sign),
           jax.jit(lambda u: jmk._tandiv_u_sgn(u, sign))(j), tol)
    t, j = _both(keep(W_ATAN), dtype)
    _close(tst._arctandiv_u_sgn(t, sign),
           jax.jit(lambda w: jmk._arctandiv_u_sgn(w, sign))(j),
           max(tol, 1e-7))
    t, j = _both(np.array([0.0, 1e-20, 1e-3, 2.0]), dtype)
    _close(tst._log_max(t, 1e-15), jmk._log_max(j, 1e-15), tol)
    r, kk = np.array([0.1, 0.7, 1.2]), np.array([-0.8, 0.0, 0.9])
    (tr, jr), (tk_, jk) = _both(r, dtype), _both(kk, dtype)
    _close(tst.tan_k(tr, tk_), jst.tan_k(jr, jk), tol)
    _close(tst.arctan_k(tr, tk_), jst.arctan_k(jr, jk), tol)


def _stereo_ops(m, v, w, u, k):
    """Every op of the gyrovector API, on points x, y from tangents v, w."""
    x = m.exp_map_mu0(v, k)
    y = m.exp_map_mu0(w, k)
    return (x, m.project(3.0 * x, k), m.lambda_x(x, k), m.mobius_add(x, y, k),
            m.mobius_scalar_mul(0.7, x, k), m.gyration(x, y, u, k),
            m.distance(x, y, k), m.exp_map(x, u, k), m.log_map(x, y, k),
            m.parallel_transport(x, y, u, k), m.log_map_mu0(x, k),
            m.transp_mu0(x, u, k), m.inv_transp_mu0(x, u, k),
            m.sample_projection_mu0(w, x, k),
            m.inverse_sample_projection_mu0(y, x, k))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("name,k", [
    ("stereographic", -1.0), ("stereographic", 0.0), ("stereographic", 0.6),
    ("poincare", -1.0), ("poincare", -1e-3), ("poincare", -4.0),
    ("spherical_projected", 1.0), ("spherical_projected", 1e-3),
    ("spherical_projected", 4.0),
    ("universal", -0.7), ("universal", -1e-3), ("universal", 0.0),
    ("universal", 1e-3), ("universal", 0.7)])
def test_stereographic_family_against_reference(name, k, dtype, tol):
    tmod = {"stereographic": tstereo, "poincare": tpo,
            "spherical_projected": tsproj, "universal": tuni}[name]
    jmod = {"stereographic": jstereo, "poincare": jpo,
            "spherical_projected": jsproj, "universal": juni}[name]
    assert (tmod.KIND, tmod.CURVATURE_SIGN) == (jmod.KIND,
                                                jmod.CURVATURE_SIGN)
    rng = np.random.default_rng(2)
    scale = 1.0 / max(abs(k), 1.0) ** 0.5
    args = [_both(scale * _points(rng, 6, 3, dtype), dtype) for _ in range(3)]
    tk_, jk = _both(k, dtype)
    ref = jax.jit(lambda v, w, u, kk: _stereo_ops(jmod, v, w, u, kk))(
        *[a[1] for a in args], jk)
    for ours, theirs in zip(_stereo_ops(tmod, *[a[0] for a in args], tk_),
                            ref):
        _close(ours, theirs, tol)


def test_sign_pinned_wrappers_clamp_the_curvature():
    """poincare pins K < 0 and spherical_projected K > 0 whatever they are
    given; mu0 is the origin."""
    x = torch.tensor([[0.3, -0.2]])
    for tmod, jmod, k in ((tpo, jpo, 0.5), (tsproj, jsproj, -0.5)):
        _close(tmod.exp_map_mu0(x, torch.tensor(k)),
               jmod.exp_map_mu0(jnp.asarray(x.numpy()), jnp.float32(k)),
               1e-6)
    assert torch.equal(tuni.mu0(3, torch.tensor(0.1), torch.float32),
                       torch.zeros(3))


@pytest.mark.parametrize("kind", ["e", "h", "d", "s", "p", "u"])
def test_manifold_descriptor_matches_reference(kind):
    from mvae_tpu.ops import Manifold as JManifold
    tm, jm = Manifold(kind, 3), JManifold(kind, 3)
    assert (tm.ambient_dim, tm.curvature_sign, tm.has_curvature_param) == (
        jm.ambient_dim, jm.curvature_sign, jm.has_curvature_param)
    c = tm.init_curvature_param(0.5)
    np.testing.assert_allclose(c.numpy(),
                               np.asarray(jm.init_curvature_param(0.5)))
    k_t, k_j = tm.curvature(c), jm.curvature(jnp.asarray(c.numpy()))
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=1e-6)
    v = torch.tensor([[0.3, -0.2, 0.1]])
    z_t = tm.exp_map_mu0(v, k_t)
    z_j = jm.exp_map_mu0(jnp.asarray(v.numpy()), k_j)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        tm.inverse_sample_projection_mu0(z_t, z_t, k_t).numpy(),
        np.asarray(jm.inverse_sample_projection_mu0(z_j, z_j, k_j)),
        rtol=1e-5, atol=1e-5)


# --- isometries, tangent projections, the sphere tile's arcsin form -----------


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("k", [1.0, 1e-3, 4.0])
def test_sphere_projected_isometry_pair(k, dtype, tol):
    """sphere_to_projected / projected_to_sphere against the reference, the
    round trip both ways, distances carried over (the map is an isometry),
    and a huge finite coordinate at the projection point -mu0."""
    rng = np.random.default_rng(3)
    p = (_points(rng, 2, 3, dtype)[:8] / np.sqrt(k)).astype(dtype)
    tk_, jk = _both(k, dtype)
    tp, jp = _both(p, dtype)
    x_t = ts.projected_to_sphere(tp, tk_)
    _close(x_t, js.projected_to_sphere(jp, jk), tol)
    _close(ts.sphere_to_projected(x_t, tk_),
           js.sphere_to_projected(js.projected_to_sphere(jp, jk), jk), tol)
    _close(ts.sphere_to_projected(x_t, tk_), jp, 10 * tol / np.sqrt(k))
    _close((x_t * x_t).sum(-1) * k, np.ones(8), 10 * tol)
    assert tsproj.sphere_to_projected is ts.sphere_to_projected
    assert tsproj.projected_to_sphere is ts.projected_to_sphere
    d_s = ts.distance(x_t[:4], x_t[4:], tk_)
    d_p = tsproj.distance(tp[:4], tp[4:], tk_)
    _close(d_s, d_p.numpy(), 1e-4 if dtype == np.float32 else 1e-9)
    south = -ts.mu0(3, tk_, tk_.dtype)
    _close(ts.sphere_to_projected(south, tk_),
           js.sphere_to_projected(jnp.asarray(south.numpy()), jk), tol)
    assert bool(torch.isfinite(ts.sphere_to_projected(south, tk_)).all())


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("k", [-1.0, -1e-3, -4.0])
def test_lorentz_poincare_isometry_pair(k, dtype, tol):
    rng = np.random.default_rng(4)
    p = (0.6 * np.tanh(_points(rng, 2, 3, dtype)[:8])
         / np.sqrt(-k)).astype(dtype)
    tk_, jk = _both(k, dtype)
    tp, jp = _both(p, dtype)
    x_t = tl.poincare_to_lorentz(tp, tk_)
    _close(x_t, jl.poincare_to_lorentz(jp, jk), tol)
    _close(tl.lorentz_to_poincare(x_t, tk_),
           jl.lorentz_to_poincare(jl.poincare_to_lorentz(jp, jk), jk), tol)
    _close(tl.lorentz_to_poincare(x_t, tk_), jp, 10 * tol / np.sqrt(-k))
    assert tpo.lorentz_to_poincare is tl.lorentz_to_poincare
    assert tpo.poincare_to_lorentz is tl.poincare_to_lorentz
    d_h = tl.distance(x_t[:4], x_t[4:], tk_)
    d_d = tpo.distance(tp[:4], tp[4:], tk_)
    _close(d_h, d_d.numpy(), 1e-4 if dtype == np.float32 else 1e-9)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_project_tangent(dtype, tol):
    """project_tangent of both embedded models against the reference; the
    projected vector is orthogonal to x in the model's own product."""
    rng = np.random.default_rng(5)
    v = _points(rng, 2, 3, dtype)[:6]
    u = rng.standard_normal((6, 4)).astype(dtype)
    tu, ju = _both(u, dtype)
    tv, jv = _both(v, dtype)
    for tmod, jmod, k in ((ts, js, 2.0), (tl, jl, -2.0)):
        tk_, jk = _both(k, dtype)
        x_t, x_j = tmod.exp_map_mu0(tv, tk_), jmod.exp_map_mu0(jv, jk)
        got = tmod.project_tangent(x_t, tu, tk_)
        _close(got, jmod.project_tangent(x_j, ju, jk), tol)
        inner = (tl.lorentz_product(x_t, got) if tmod is tl
                 else (x_t * got).sum(-1))
        _close(inner, np.zeros(6), 100 * tol)


@pytest.mark.parametrize("dtype,tol", [pytest.param(np.float64, 1e-7,
                                                    id="f64"),
                                       pytest.param(np.float32, 1e-5,
                                                    id="f32")])
def test_arcsindiv_u_pos_kernel_form(dtype, tol):
    """The sphere tile's asin(sqrt w) / sqrt w: the reference spells its
    atan as a polynomial within 6.3e-9 of it and the port calls atan, so
    float64 is held to 1e-7 (against asin itself, 1e-12 away from the
    clamp at w -> 1)."""
    w = np.array(_EDGE[:10] + [0.3, 0.5, 0.9, 0.99, 0.999999, 1.0, 1.5])
    t, j = _both(w, dtype)
    _close(tst._arcsindiv_u_pos(t), jax.jit(jtk._arcsindiv_u_pos)(j), tol)
    if dtype == np.float64:
        inner = w[(w > 1e-2) & (w < 0.9999)]
        _close(tst._arcsindiv_u_pos(torch.from_numpy(inner)),
               np.arcsin(np.sqrt(inner)) / np.sqrt(inner), 1e-12)
