"""mvae_torch distributions and components against the JAX package, with
the noise given: JAX draws it from its keys exactly as its samplers do, and
the port receives the same numbers.

Tolerances: 1e-10 relative/absolute in float64 (same expressions, library
last-digit differences only) and 1e-5 in float32 (a few ulps through the
exp/log chains; values are O(1-10)). float32 cases keep hyperbolic radii
where float32 is well-conditioned; the vMF KL in float32 is held to 1e-4,
because its Bessel series sums 64 log-space terms of magnitude ~100.
The positive-curvature wrapped normal in float32 is held to 1e-4: near the
injectivity shell d logdet / d r ~ cot(theta) amplifies last-digit
differences of the radius.

The rejection cosine of the vMF (m != 3) is fed the proposals JAX drew
(``jax_noise`` rebuilds its key tree: Beta variates and acceptance
uniforms): the accepted cosine is a selection among the same candidates, so
z agrees to the tolerances above; the implicit gradient dw/dkappa (32-node
quadrature and a Bessel ratio) to 1e-9 in float64 and 1e-4 in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.components import parse_components as j_parse
from mvae_tpu.components import reparametrize as j_reparametrize
from mvae_tpu.components.component import cap_sigma_positive_k as j_cap
from mvae_tpu.distributions import normal as jn
from mvae_tpu.distributions import von_mises_fisher as jv
from mvae_tpu.distributions import wrapped_normal as jw
from mvae_tpu.kernels.tail_kernels import draw_noise_t
from mvae_tpu.ops import Manifold as JManifold
from mvae_torch.components import parse_components as t_parse
from mvae_torch.components import reparametrize as t_reparametrize
from mvae_torch.components.component import cap_sigma_positive_k as t_cap
from mvae_torch.convert import params_from_jax
from mvae_torch.distributions import normal as tn
from mvae_torch.distributions import von_mises_fisher as tv
from mvae_torch.distributions import wrapped_normal as tw
from mvae_torch.ops import Manifold as TManifold

DTYPES = [pytest.param(np.float64, 1e-10, id="f64"),
          pytest.param(np.float32, 1e-5, id="f32")]
B = 48


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_normal(dtype, tol):
    rng = np.random.default_rng(0)
    mu = rng.standard_normal((B, 3)).astype(dtype)
    sig = (0.2 + rng.random((B, 3))).astype(dtype)
    key = jax.random.key(1)
    eps = jax.random.normal(key, (B, 3), dtype)
    z_j = jn.sample(key, jnp.asarray(mu), jnp.asarray(sig))
    z_t = tn.sample(_t(mu), _t(sig), noise=_t(eps))
    _close(z_t, z_j, tol)
    _close(tn.log_prob(z_t, _t(mu), _t(sig)),
           jn.log_prob(z_j, jnp.asarray(mu), jnp.asarray(sig)), tol)
    _close(tn.kl_std(_t(mu), _t(sig)),
           jn.kl_std(jnp.asarray(mu), jnp.asarray(sig)), tol)


@pytest.mark.parametrize("k,dtype,tol", [
    (-1.0, np.float64, 1e-10), (-0.05, np.float64, 1e-10),
    (-3.0, np.float64, 1e-10), (-1.0, np.float32, 1e-5),
    (-0.05, np.float32, 1e-5)])
def test_wrapped_normal_hyperboloid(k, dtype, tol):
    rng = np.random.default_rng(2)
    jm, tm = JManifold("h", 2), TManifold("h", 2)
    kj = jnp.asarray(k, dtype)
    kt = torch.tensor(k, dtype=getattr(torch, dtype.__name__))
    v_mu = (0.7 * rng.standard_normal((B, 2))).astype(dtype)
    mu_j = jm.exp_map_mu0(jnp.asarray(v_mu), kj)
    mu_t = tm.exp_map_mu0(_t(v_mu), kt)
    sig = (0.1 + rng.random((B, 2))).astype(dtype)
    key = jax.random.key(3)
    noise = jax.random.normal(key, (B, 2), dtype)
    z_j, lq_j = jw.sample_and_log_prob(key, jm, mu_j, jnp.asarray(sig), kj)
    z_t, lq_t = tw.sample_and_log_prob(tm, mu_t, _t(sig), kt,
                                       noise=_t(noise))
    _close(z_t, z_j, tol)
    _close(lq_t, lq_j, tol)
    one = np.ones((), dtype)
    _close(tw.log_prob_mu0(tm, z_t, _t(one), kt),
           jw.log_prob_mu0(jm, z_j, jnp.asarray(one), kj), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("k", [1.0, 0.2, 5.0])
def test_vmf_m3(k, dtype, tol):
    rng = np.random.default_rng(4)
    mu = rng.standard_normal((B, 3)).astype(dtype)
    mu[0] = [1.0, 0.0, 0.0]              # Householder degeneracy guard
    kappa = (1.0 + 30.0 * rng.random(B)).astype(dtype)
    kj = jnp.asarray(k, dtype)
    kt = torch.tensor(k, dtype=getattr(torch, dtype.__name__))
    key = jax.random.key(5)
    k_w, k_dir = jax.random.split(key)
    u = jax.random.uniform(k_w, (B,), dtype=dtype, minval=1e-7)
    g = jax.random.normal(k_dir, (B, 2), dtype)
    noise = np.concatenate([np.asarray(u)[:, None], np.asarray(g)], axis=1)
    z_j = jv.sample(key, jnp.asarray(mu), jnp.asarray(kappa), kj)
    z_t = tv.sample(_t(mu), _t(kappa), kt, noise=_t(noise))
    _close(z_t, z_j, tol)
    _close(tv.log_prob(z_t, _t(mu), _t(kappa), kt),
           jv.log_prob(z_j, jnp.asarray(mu), jnp.asarray(kappa), kj), tol)
    _close(tv.kl_to_uniform(3, _t(kappa)),
           jv.kl_to_uniform(3, jnp.asarray(kappa)),
           max(tol, 1e-4) if dtype == np.float32 else tol)


def test_vmf_other_m_is_a_later_slice():
    """m != 3 was a later slice's and raised; it now draws its cosine by
    rejection, from the generator when no proposals are given."""
    g = torch.Generator().manual_seed(0)
    z = tv.sample(torch.ones(4, 5), torch.ones(4), torch.tensor(1.0),
                  noise=torch.rand(4, 5), generator=g)
    assert z.shape == (4, 5) and bool(torch.isfinite(z).all())
    np.testing.assert_allclose(z.norm(dim=1).numpy(), 1.0, rtol=1e-6)


def jax_noise(key, comps, batch, dtype):
    """(batch, E) noise of one draw of the JAX product in the port's layout:
    ``draw_noise_t``'s key discipline (split per component; the vMF splits
    again into cosine and direction), plus, for the rejection cosine, the
    proposals ``_sample_w_raw`` draws from the cosine's key."""
    cols = []
    for comp, ck in zip(comps, jax.random.split(key, len(comps))):
        if comp.posterior != "vmf":
            cols.append(jax.random.normal(ck, (batch, comp.dim), dtype))
            continue
        k_w, k_dir = jax.random.split(ck)
        cols += [jax.random.uniform(k_w, (batch, 1), dtype=dtype,
                                    minval=1e-7),
                 jax.random.normal(k_dir, (batch, comp.dim), dtype)]
        if comp.dim != 2:
            k_beta, k_u = jax.random.split(k_w)
            shape = (batch, jv._OVERSAMPLE)
            cols += [jv._beta_sym_half_int(k_beta, comp.dim, shape, dtype),
                     jax.random.uniform(k_u, shape, dtype=dtype,
                                        minval=1e-12)]
    return np.concatenate([np.asarray(c) for c in cols], axis=1)


def test_jax_noise_is_draw_noise_t_without_rejection():
    comps = j_parse("h2,s2,e2")
    key = jax.random.key(2)
    np.testing.assert_array_equal(
        jax_noise(key, comps, B, np.float32),
        np.asarray(draw_noise_t(key, comps, B, np.float32)).T)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m,k", [(7, 1.0), (4, 0.3), (2, 1.0), (13, 2.0)])
def test_vmf_wood_matches_jax_on_its_proposals(m, k, dtype, tol):
    """z, log q and the KL at m != 3, kappa from 1 to 60 (1 + softplus of a
    head), on the proposals JAX drew."""
    rng = np.random.default_rng(4)
    mu = rng.standard_normal((B, m)).astype(dtype)
    kappa = (1.0 + 60.0 * rng.random(B) ** 2).astype(dtype)
    kj = jnp.asarray(k, dtype)
    kt = torch.tensor(k, dtype=getattr(torch, dtype.__name__))
    key = jax.random.key(6)
    (comp,) = j_parse(f"s{m - 1}")
    # jax_noise splits per component first; sample() gets the component key
    (ck,) = jax.random.split(key, 1)
    noise = _t(jax_noise(key, (comp,), B, dtype))
    z_j = jv.sample(ck, jnp.asarray(mu), jnp.asarray(kappa), kj)
    z_t = tv.sample(_t(mu), _t(kappa), kt, noise=noise,
                    proposals=noise[:, m:])
    assert noise.shape == (B, m + 2 * tv.OVERSAMPLE)
    _close(z_t, z_j, tol)
    _close(tv.log_prob(z_t, _t(mu), _t(kappa), kt),
           jv.log_prob(z_j, jnp.asarray(mu), jnp.asarray(kappa), kj), tol)
    ktol = max(tol, 1e-4) if dtype == np.float32 else tol
    _close(tv.kl_to_uniform(m, _t(kappa)),
           jv.kl_to_uniform(m, jnp.asarray(kappa)), ktol)
    _close(tv.log_normalizer(m, _t(kappa)),
           jv.log_normalizer(m, jnp.asarray(kappa)), ktol)


@pytest.mark.parametrize("dtype,tol", [pytest.param(np.float64, 1e-9,
                                                    id="f64"),
                                       pytest.param(np.float32, 1e-4,
                                                    id="f32")])
@pytest.mark.parametrize("m", [7, 4, 2])
def test_vmf_wood_implicit_gradient_matches_jax(m, dtype, tol):
    """dw/dkappa of the accepted cosine (``_SampleW.backward``) against the
    reference's ``custom_jvp``, and no gradient into the proposals."""
    rng = np.random.default_rng(5)
    kappa = (1.0 + 40.0 * rng.random(B) ** 2).astype(dtype)
    wts = rng.standard_normal(B).astype(dtype)
    key = jax.random.key(7)
    k_beta, k_u = jax.random.split(key)
    shape = (B, jv._OVERSAMPLE)
    prop = np.concatenate([
        np.asarray(jv._beta_sym_half_int(k_beta, m - 1, shape, dtype)),
        np.asarray(jax.random.uniform(k_u, shape, dtype=dtype,
                                      minval=1e-12))], axis=1)
    w_j = jv._sample_w(key, m, jnp.asarray(kappa))
    g_j = jax.grad(lambda kap: jnp.sum(jv._sample_w(key, m, kap) * wts))(
        jnp.asarray(kappa))
    kap_t = _t(kappa).requires_grad_()
    prop_t = _t(prop).requires_grad_()
    w_t = tv._SampleW.apply(m, kap_t, prop_t)
    _close(w_t, w_j, tol)
    (w_t * _t(wts)).sum().backward()
    assert prop_t.grad is None
    _close(kap_t.grad, g_j, tol)
    assert bool((kap_t.grad != 0).any())


@pytest.mark.parametrize("kappa", [1.0, 10.0, 80.0])
def test_vmf_wood_mean_cosine_is_the_bessel_ratio(kappa):
    """E[<mu, z>] = A_m(kappa) at m = 7 over 40,000 draws from a seeded
    generator: within 5 standard errors (Var w <= 1 / m at any kappa)."""
    m, n = 7, 40000
    g = torch.Generator().manual_seed(11)
    like = torch.zeros((), dtype=torch.float64)
    kap = torch.full((n,), kappa, dtype=torch.float64)
    prop = tv.wood_proposals(m, (n,), like, g)
    assert prop.shape == (n, 2 * tv.OVERSAMPLE)
    assert float(prop.min()) > 0.0 and float(prop.max()) < 1.0
    w = tv._SampleW.apply(m, kap, prop)
    want = float(tv.mean_resultant_length(m, kap[:1]))
    se = float(w.std()) / n ** 0.5
    assert abs(float(w.mean()) - want) < 5.0 * se + 1e-4, (w.mean(), want)
    # the whole draw: unit vectors whose mean cosine to mu is the same
    mu = torch.zeros(n, m, dtype=torch.float64)
    mu[:, 2] = 3.0
    z = tv.sample(mu, kap, torch.tensor(1.0, dtype=torch.float64),
                  generator=g)
    assert abs(float(z[:, 2].mean()) - want) < 5.0 * se + 1e-4


WRAPPED_CASES = [(kind, k) for kind, ks in (
    ("d", (-1.0, -1e-3)), ("p", (1.0, 1e-3, 3.0)), ("s", (1.0, 0.3)),
    ("u", (-1.0, -1e-3, 0.0, 1e-3, 1.0))) for k in ks]


@pytest.mark.parametrize("dtype,tol", [
    pytest.param(np.float64, 1e-10, id="f64"),
    pytest.param(np.float32, 1e-4, id="f32")])
@pytest.mark.parametrize("wraps", [0, 1, 2])
@pytest.mark.parametrize("sig_scale", [0.3, 2.0])
@pytest.mark.parametrize("kind,k", WRAPPED_CASES)
def test_wrapped_normal_any_curvature(kind, k, sig_scale, wraps, dtype, tol):
    """The drawn-radius branch sum, ``log_prob`` through the inverse round
    trip and the prior's ``log_prob_mu0`` on d/p/s/u, small and large
    scales (at 2.0 the wrap images carry mass on K > 0)."""
    rng = np.random.default_rng(8)
    jm, tm = JManifold(kind, 3), TManifold(kind, 3)
    kj = jnp.asarray(k, dtype)
    kt = torch.tensor(k, dtype=getattr(torch, dtype.__name__))
    v_mu = (0.5 * rng.standard_normal((B, 3))).astype(dtype)
    mu_j = jm.exp_map_mu0(jnp.asarray(v_mu), kj)
    mu_t = tm.exp_map_mu0(_t(v_mu), kt)
    sig = (sig_scale * (0.1 + rng.random((B, 3)))).astype(dtype)
    key = jax.random.key(9)
    noise = jax.random.normal(key, (B, 3), dtype)
    z_j, lq_j = jw.sample_and_log_prob(key, jm, mu_j, jnp.asarray(sig), kj,
                                       wraps=wraps)
    z_t, lq_t = tw.sample_and_log_prob(tm, mu_t, _t(sig), kt, wraps=wraps,
                                       noise=_t(noise))
    _close(z_t, z_j, tol)
    _close(lq_t, lq_j, tol)
    one = np.ones((), dtype)
    _close(tw.log_prob_mu0(tm, z_t, _t(one), kt, wraps=wraps),
           jw.log_prob_mu0(jm, z_j, jnp.asarray(one), kj, wraps=wraps), tol)
    if dtype == np.float64:   # the round trip is ill-conditioned in float32
        iso = np.full((), 0.8 * sig_scale, dtype)
        _close(tw.log_prob(tm, z_t, mu_t, _t(iso), kt, wraps=wraps),
               jw.log_prob(jm, z_j, mu_j, jnp.asarray(iso), kj, wraps=wraps),
               1e-8)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cap_sigma_positive_k(dtype, tol):
    """The saturating scale cap: identity at K <= 0 and small sigma,
    pi / sqrt(K) at large sigma, and the same gradient in sigma and K."""
    sig = np.array([1e-3, 0.3, 1.0, 3.0, 10.0, 100.0], dtype)
    for k in (-1.0, 0.0, 1e-3, 1.0, 4.0):
        want = j_cap(jnp.asarray(sig), jnp.asarray(k, dtype))
        st = _t(sig).requires_grad_()
        kt = torch.tensor(k, dtype=st.dtype, requires_grad=True)
        got = t_cap(st, kt)
        _close(got, want, tol)
        got.sum().backward()
        g_s, g_k = jax.grad(lambda s, kk: jnp.sum(j_cap(s, kk)), (0, 1))(
            jnp.asarray(sig), jnp.asarray(k, dtype))
        _close(st.grad, g_s, tol)
        np.testing.assert_allclose(kt.grad.numpy(), np.asarray(g_k),
                                   rtol=10 * tol, atol=tol)
    assert float(t_cap(torch.tensor(100.0), torch.tensor(4.0))) == \
        pytest.approx(np.pi / 2, rel=1e-5)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("spec", ["s6", "s3", "p2:vmf", "p3:vmf", "p6:vmf"])
def test_reparametrize_vmf_component(spec, dtype, tol):
    """The vMF components beyond s2 through ``reparametrize``: the rejection
    cosine on JAX's proposals, and on 'p' the draw on the embedded sphere
    pushed through the stereographic isometry, densities at the sphere
    pre-images. float32 on 'p' is held to 1e-4: the projection divides by
    1 + sqrt(K) z_0, which amplifies the last digit toward the antipode."""
    (jc,) = j_parse(spec, fixed_curvature=False)
    (tc,) = t_parse(spec, fixed_curvature=False)
    params_j = jc.init_params(jax.random.key(2), 16, 1.0, dtype)
    params_j["c_param"] = jnp.asarray(np.log(1.7), dtype)
    feats = (0.5 * np.random.default_rng(8).standard_normal((B, 16))
             ).astype(dtype)
    key = jax.random.key(9)
    (ck,) = jax.random.split(key, 1)
    rep_j = j_reparametrize(ck, jc, params_j, jnp.asarray(feats))
    noise = jax_noise(key, (jc,), B, dtype)
    assert noise.shape == (B, tc.noise_width)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    rep_t = t_reparametrize(tc, params_t, _t(feats), noise=_t(noise))
    if dtype == np.float32 and tc.manifold.kind == "p":
        tol = 1e-4
    for ours, theirs in zip(rep_t, rep_j):
        _close(ours, theirs, tol)
    # drawn from a generator instead: same shapes, finite
    rep_g = t_reparametrize(tc, params_t, _t(feats),
                            generator=torch.Generator().manual_seed(0))
    assert all(a.shape == b.shape and bool(torch.isfinite(a).all())
               for a, b in zip(rep_g, rep_t))


@pytest.mark.parametrize("spec", ["e3", "h2", "s2", "s6", "p2:vmf", "p3",
                                  "d2", "u3", "s3:wrapped"])
def test_sample_prior_lies_on_the_manifold(spec):
    """``sample_prior``: shape, determinism under a seeded generator, and
    the manifold's constraint (radius R on h and s; inside the ball on d)."""
    from mvae_torch.components import sample_prior
    (tc,) = t_parse(spec, fixed_curvature=False)
    params = tc.init_params(8, init_k=2.0,
                            generator=torch.Generator().manual_seed(0))
    z = sample_prior(tc, params, (5, 7),
                     generator=torch.Generator().manual_seed(1))
    z2 = sample_prior(tc, params, (5, 7),
                      generator=torch.Generator().manual_seed(1))
    assert z.shape == (5, 7, tc.ambient_dim) and torch.equal(z, z2)
    assert bool(torch.isfinite(z).all())
    kind = tc.manifold.kind
    if kind == "s":
        np.testing.assert_allclose((z * z).sum(-1).numpy(), 0.5, rtol=1e-5)
    elif kind == "h":
        lor = (z[..., 1:] ** 2).sum(-1) - z[..., 0] ** 2
        np.testing.assert_allclose(lor.numpy(), -0.5, rtol=1e-4)
    elif kind == "d":
        assert float((z * z).sum(-1).max()) < 0.5
    (rc,) = t_parse("d3:riemannian")
    zr = sample_prior(rc, rc.init_params(
        8, generator=torch.Generator().manual_seed(0)), (2,),
        generator=torch.Generator().manual_seed(1))
    assert zr.shape == (2, 3) and bool(torch.isfinite(zr).all())
    assert float((zr * zr).sum(-1).max()) < 1.0


def test_sample_prior_on_p_is_the_projected_uniform():
    """The vMF prior on 'p' is the sphere's uniform pushed through the
    isometry: back on the sphere the mean of the draws is ~0."""
    from mvae_torch.components import sample_prior
    from mvae_torch.ops import sphere
    (tc,) = t_parse("p2:vmf")
    params = tc.init_params(8, generator=torch.Generator().manual_seed(0))
    z = sample_prior(tc, params, (20000,), torch.float64,
                     torch.Generator().manual_seed(2))
    zs = sphere.projected_to_sphere(z, torch.tensor(1.0, dtype=torch.float64))
    np.testing.assert_allclose((zs * zs).sum(-1).numpy(), 1.0, rtol=1e-9)
    assert float(zs.mean(0).abs().max()) < 5.0 * (1.0 / 3 / 20000) ** 0.5


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("spec", ["h2", "s2", "e2", "h3:wrapped", "e3"])
def test_reparametrize_component(spec, dtype, tol):
    """Component heads + draw + log q / log p / KL, noise from the JAX
    key discipline (draw_noise_t of the single component)."""
    (jc,) = j_parse(spec, fixed_curvature=False)
    (tc,) = t_parse(spec, fixed_curvature=False)
    params_j = jc.init_params(jax.random.key(0), 16, 1.0, dtype)
    feats = (0.5 * np.random.default_rng(6).standard_normal((B, 16))
             ).astype(dtype)
    key = jax.random.key(7)
    # draw_noise_t splits its key per component, as the model's router does
    (ck,) = jax.random.split(key, 1)
    rep_j = j_reparametrize(ck, jc, params_j, jnp.asarray(feats))
    noise = np.asarray(draw_noise_t(key, (jc,), B, dtype)).T
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    rep_t = t_reparametrize(tc, params_t, _t(feats), noise=_t(noise))
    for ours, theirs in zip(rep_t, rep_j):
        _close(ours, theirs, tol)


@pytest.mark.parametrize("dtype,tol", [
    pytest.param(np.float64, 1e-10, id="f64"),
    pytest.param(np.float32, 1e-4, id="f32")])
@pytest.mark.parametrize("spec,opts", [
    ("d2", {}), ("p2", {}), ("u3", {}), ("s3:wrapped", {}),
    ("p3", {"scalar_sigma": True}), ("u3", {"wraps": 0}),
    ("p3", {"sigma_cap": False})])
def test_reparametrize_wrapped_component(spec, opts, dtype, tol):
    """Wrapped components on d/p/u/s through ``reparametrize``: heads, the
    sigma cap under the reference's condition, draw, log q / log p / KL."""
    (jc,) = j_parse(spec, fixed_curvature=False, **opts)
    (tc,) = t_parse(spec, fixed_curvature=False, **opts)
    params_j = jc.init_params(jax.random.key(1), 16, 1.0, dtype)
    params_j["b_sig"] = params_j["b_sig"] + 1.5      # scales near the cap
    feats = (0.5 * np.random.default_rng(7).standard_normal((B, 16))
             ).astype(dtype)
    key = jax.random.key(8)
    (ck,) = jax.random.split(key, 1)
    rep_j = j_reparametrize(ck, jc, params_j, jnp.asarray(feats))
    noise = np.asarray(draw_noise_t(key, (jc,), B, dtype)).T
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    rep_t = t_reparametrize(tc, params_t, _t(feats), noise=_t(noise))
    for ours, theirs in zip(rep_t, rep_j):
        _close(ours, theirs, tol)
