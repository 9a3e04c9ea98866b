"""The port's Riemannian normal against ``mvae_tpu.distributions.
riemannian_normal``, on the CPU, with inputs from a numpy seed.

Tolerances:

* the quadrature (``_window``, ``log_partition``, ``_radial_cdf``,
  ``_radial_log_pdf``) over n in {2, 6, 200}, sigma in {0.05, 1, 5} and
  c in {0.1, 1, 4}: 1e-10 (1 + |ref|) in float64 and 1e-5 (1 + |ref|) in
  float32 (the same expressions; the log-partition reaches 2e6 at
  n = 200);
* the radius sampler on the rounds JAX drew (``jax_rounds`` rebuilds its
  key chain: each round splits the carried key into (key, k_g, k_n, k_u)),
  all 128 of them: equal within 1e-12 relative in float64. In float32 a
  lane whose acceptance test ``log u <= log_acc`` is within 1e-6 of its
  threshold in some round up to the one it takes may take another round
  than JAX does: such lanes are counted (at most 0.1% of the lanes) and
  every other lane agrees within 1e-6 relative;
* dr/dsigma and dr/dK (the implicit gradient) against ``jax.jvp`` of
  ``sample_radius``: 1e-6 relative in float64;
* ``log_prob`` on h and d, and the component's ``reparametrize`` (z,
  log q, log p, KL, and the gradients of their sum): 1e-10 in float64,
  1e-5 relative with a 1e-4 floor in float32;
* the generator's rounds (the gamma as a sum of exponentials): a
  Kolmogorov-Smirnov test of 10^5 radii against ``_radial_cdf`` at
  p > 1e-3, seed fixed, for each envelope.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.components import parse_components as j_parse
from mvae_tpu.components import reparametrize as j_reparametrize
from mvae_tpu.distributions import riemannian_normal as jr
from mvae_tpu.ops import Manifold as JManifold
from mvae_torch.components import parse_components as t_parse
from mvae_torch.components import reparametrize as t_reparametrize
from mvae_torch.components import sample_prior
from mvae_torch.convert import params_from_jax
from mvae_torch.distributions import riemannian_normal as tr
from mvae_torch.ops import Manifold as TManifold

DTYPES = [pytest.param(np.float64, 1e-10, id="f64"),
          pytest.param(np.float32, 1e-5, id="f32")]


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_rounds(key, n, shape, dtype, rounds=tr.ROUNDS):
    """(*shape, 3 rounds) = [gamma | xi | u]: the numbers JAX's
    ``_sample_radius_raw`` draws from ``key`` in its first ``rounds``
    rounds (the round keys depend on the chain only, never on acceptance)."""
    gam, xi, u = [], [], []
    for _ in range(rounds):
        key, k_g, k_n, k_u = jax.random.split(key, 4)
        gam.append(jax.random.gamma(k_g, n / 2.0, shape, dtype=dtype))
        xi.append(jax.random.normal(k_n, shape, dtype))
        u.append(jax.random.uniform(k_u, shape, dtype=dtype, minval=1e-12))
    return np.concatenate([np.stack([np.asarray(a) for a in cols], axis=-1)
                           for cols in (gam, xi, u)], axis=-1)


def jax_noise(ck, n, batch, dtype):
    """(batch, n + 3 ROUNDS) noise of one Riemannian draw from the
    component key ``ck``, as ``riemannian_normal.sample`` splits it: the
    radius's chain from the first half, the direction's normals from the
    second."""
    k_r, k_dir = jax.random.split(ck)
    g = np.asarray(jax.random.normal(k_dir, (batch, n), dtype))
    return np.concatenate([g, jax_rounds(k_r, n, (batch,), dtype)], axis=1)


def _grid(dtype):
    s, c = np.meshgrid([0.05, 1.0, 5.0], [0.1, 1.0, 4.0], indexing="ij")
    return s.ravel().astype(dtype), c.ravel().astype(dtype)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n", [2, 6, 200])
def test_quadrature_matches_jax(n, dtype, tol):
    sig, c = _grid(dtype)

    def close(ours, theirs):
        ref = np.asarray(theirs, np.float64)
        err = np.abs(ours.detach().numpy().astype(np.float64) - ref)
        assert np.all(err <= tol * (1.0 + np.abs(ref))), (err.max(), ref)

    lo_j, hi_j = jr._window(n, jnp.asarray(sig), jnp.asarray(c))
    lo_t, hi_t = tr._window(n, _t(sig), _t(c))
    close(lo_t, lo_j)
    close(hi_t, hi_j)
    # a curvature K = -c per lane, and 7 radii across each lane's window
    kj, kt = jnp.asarray(-c), _t(-c)
    close(tr.log_partition(n, _t(sig), kt), jr.log_partition(n, jnp.asarray(sig),
                                                             kj))
    lo, hi = np.asarray(lo_j, np.float64), np.asarray(hi_j, np.float64)
    r = (lo[:, None] + (hi - lo)[:, None] * np.linspace(0.02, 0.98, 7)
         ).astype(dtype)
    s = np.broadcast_to(sig[:, None], r.shape).copy()
    k2j, k2t = kj[:, None], kt[:, None]
    close(tr._radial_cdf(n, _t(r), _t(s), k2t),
          jr._radial_cdf(n, jnp.asarray(r), jnp.asarray(s), k2j))
    close(tr._radial_log_pdf(n, _t(r), _t(s), k2t),
          jr._radial_log_pdf(n, jnp.asarray(r), jnp.asarray(s), k2j))


def _scales(dtype, lanes=2048, seed=0):
    """Scales log-uniform over [0.02, 8]: both envelopes, and lanes whose
    truncated-normal proposals fall below 0."""
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(0.02), np.log(8.0), lanes)).astype(dtype)


SAMPLER = [(2, -1.0), (6, -0.3), (200, -2.0)]


@pytest.mark.parametrize("n,k", SAMPLER)
def test_sampler_matches_jax_on_its_rounds_f64(n, k):
    sig = _scales(np.float64)
    key = jax.random.key(n)
    r_j = np.asarray(jr._sample_radius_raw(key, n, jnp.asarray(sig),
                                           jnp.asarray(k)))
    rounds = _t(jax_rounds(key, n, sig.shape, np.float64))
    r_t = tr._sample_radius_raw(n, _t(sig), torch.tensor(k, dtype=torch.float64),
                                rounds)
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("n,k", SAMPLER)
def test_sampler_matches_jax_on_its_rounds_f32(n, k):
    sig = _scales(np.float32)
    key = jax.random.key(n + 1)
    r_j = np.asarray(jr._sample_radius_raw(key, n, jnp.asarray(sig),
                                           jnp.asarray(k, np.float32)))
    rounds = _t(jax_rounds(key, n, sig.shape, np.float32))
    r_t = tr._sample_radius_raw(n, _t(sig), torch.tensor(k), rounds).numpy()
    # the acceptance tests in float64 on the same numbers: a lane is
    # ambiguous where one of them, up to the round it takes, lies within
    # 1e-6 of its threshold
    _, log_u, log_acc = tr.proposals(n, _t(sig).double(),
                                     torch.tensor(k).double(),
                                     rounds.double())
    ok = (log_u <= log_acc).numpy()
    taken = np.where(ok.any(-1), ok.argmax(-1), tr.ROUNDS - 1)
    near = (log_u - log_acc).abs().numpy() < 1e-6
    upto = np.arange(tr.ROUNDS)[None, :] <= taken[:, None]
    ambiguous = np.any(near & upto, axis=-1)
    assert ambiguous.mean() <= 1e-3, int(ambiguous.sum())
    rel = np.abs(r_t - r_j) / np.abs(r_j)
    assert np.all(rel[~ambiguous] <= 1e-6), rel[~ambiguous].max()


@pytest.mark.parametrize("n,k", SAMPLER)
def test_radius_gradients_match_jax_jvp(n, k):
    """dr/dsigma per lane and sum_i w_i dr_i/dK against ``jax.jvp`` of
    the reference's ``sample_radius`` (its custom JVP)."""
    sig = _scales(np.float64, lanes=256, seed=1)
    key = jax.random.key(10 + n)
    kj = jnp.asarray(k)

    def radius(s, kk):
        return jr.sample_radius(key, n, s, kk)

    _, dr_ds = jax.jvp(radius, (jnp.asarray(sig), kj),
                       (jnp.ones_like(sig), jnp.zeros_like(kj)))
    _, dr_dk = jax.jvp(radius, (jnp.asarray(sig), kj),
                       (jnp.zeros_like(sig), jnp.ones_like(kj)))
    rounds = _t(jax_rounds(key, n, sig.shape, np.float64))
    st = _t(sig).requires_grad_(True)
    kt = torch.tensor(k, dtype=torch.float64, requires_grad=True)
    r = tr.sample_radius(n, st, kt, rounds)
    w = _t(np.random.default_rng(2).standard_normal(sig.shape))
    gs, gk = torch.autograd.grad((w * r).sum(), (st, kt))
    np.testing.assert_allclose(gs.numpy() / w.numpy(), np.asarray(dr_ds),
                               rtol=1e-6)
    np.testing.assert_allclose(gk.item(), float(np.sum(w.numpy()
                                                       * np.asarray(dr_dk))),
                               rtol=1e-6)


def _points(kind, n, k, dtype, rng, lanes=48, scale=0.8):
    """Points of the manifold with curvature K: exp_mu0 of normals."""
    v = (scale * rng.standard_normal((lanes, n))).astype(dtype)
    return np.asarray(JManifold(kind, n).exp_map_mu0(jnp.asarray(v),
                                                     jnp.asarray(k, dtype)))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("kind,n,k", [("h", 2, -1.0), ("h", 5, -0.4),
                                      ("d", 2, -1.0), ("d", 6, -2.0)])
def test_log_prob_matches_jax(kind, n, k, dtype, tol):
    rng = np.random.default_rng(3)
    mu = _points(kind, n, k, dtype, rng)
    z = _points(kind, n, k, dtype, rng)
    sig = (0.1 + 2.0 * rng.random(48)).astype(dtype)
    kj = jnp.asarray(k, dtype)
    kt = torch.tensor(k, dtype=getattr(torch, dtype.__name__))
    ours = tr.log_prob(TManifold(kind, n), _t(z), _t(mu), _t(sig), kt)
    theirs = jr.log_prob(JManifold(kind, n), jnp.asarray(z), jnp.asarray(mu),
                         jnp.asarray(sig), kj)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=tol,
                               atol=tol if dtype == np.float64 else 1e-4)


REPARAM = [("d6:riemannian", True), ("d2:riemannian", False),
           ("h3:riemannian", False)]


def _component(spec, fixed, dtype, lanes=48):
    """Both packages' component and the reference's head weights; in
    float32 the scales are cut (b_sig - 1.5) so that the draws stay where
    float32 resolves the ball's distance (near |z| = 1 one ulp of z moves
    it by 1e-4 and more)."""
    (jc,) = j_parse(spec, fixed_curvature=fixed)
    (tc,) = t_parse(spec, fixed_curvature=fixed)
    params_j = jc.init_params(jax.random.key(0), 16, 1.0, dtype)
    if dtype == np.float32:
        params_j["b_sig"] = params_j["b_sig"] - 1.5
    feats = (0.5 * np.random.default_rng(6).standard_normal((lanes, 16))
             ).astype(dtype)
    return jc, tc, params_j, feats


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("spec,fixed", REPARAM)
def test_reparametrize_component_matches_jax(spec, fixed, dtype, tol):
    """Heads, the draw on the rounds JAX drew, log q / log p / KL."""
    jc, tc, params_j, feats = _component(spec, fixed, dtype)
    ck = jax.random.key(7)
    rep_j = j_reparametrize(ck, jc, params_j, jnp.asarray(feats))
    noise = _t(jax_noise(ck, jc.dim, len(feats), dtype))
    assert noise.shape[-1] == tc.noise_width
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    rep_t = t_reparametrize(tc, params_t, _t(feats), noise=noise)
    atol = tol if dtype == np.float64 else 1e-4
    for ours, theirs in zip(rep_t, rep_j):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=tol, atol=atol)


@pytest.mark.parametrize("spec,fixed", REPARAM[1:])
def test_reparametrize_gradients_match_jax(spec, fixed):
    """The gradient of sum(kl + z) in every head weight and the curvature
    (through the implicit radius gradient), float64."""
    jc, tc, params_j, feats = _component(spec, fixed, np.float64, lanes=24)
    ck = jax.random.key(8)

    def objective(p):
        rep = j_reparametrize(ck, jc, p, jnp.asarray(feats))
        return jnp.sum(rep.kl) + jnp.sum(jnp.sin(rep.z))

    g_j = jax.jit(jax.grad(objective))(params_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    for t in params_t.values():
        t.requires_grad_(True)
    noise = _t(jax_noise(ck, jc.dim, len(feats), np.float64))
    rep = t_reparametrize(tc, params_t, _t(feats), noise=noise)
    (torch.sum(rep.kl) + torch.sum(torch.sin(rep.z))).backward()
    for name, t in params_t.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_j[name]),
                                   rtol=1e-8, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("spec", ["d3:riemannian", "h2:riemannian"])
def test_sample_prior_lands_on_the_manifold(spec):
    (tc,) = t_parse(spec, fixed_curvature=False)
    params = tc.init_params(8, init_k=2.0,
                            generator=torch.Generator().manual_seed(0))
    z = sample_prior(tc, params, (5, 7), torch.float64,
                     torch.Generator().manual_seed(1))
    assert z.shape == (5, 7, tc.ambient_dim) and bool(torch.isfinite(z).all())
    if tc.manifold.kind == "d":
        assert float((z * z).sum(-1).max()) < 0.5
    else:
        lor = (z[..., 1:] ** 2).sum(-1) - z[..., 0] ** 2
        np.testing.assert_allclose(lor.numpy(), -0.5, rtol=1e-9)


@pytest.mark.parametrize("n,sigma,k", [(6, 0.3, -1.0), (6, 1.5, -1.0),
                                       (2, 0.8, -0.5)])
def test_generator_rounds_follow_the_radial_law(n, sigma, k):
    """10^5 radii from ``draw_rounds`` (the gamma as a sum of
    exponentials) against the quadrature CDF: the chi envelope at
    sigma = 0.3, the truncated-normal one at sigma = 1.5 (n = 6)."""
    from scipy import stats
    g = torch.Generator().manual_seed(0)
    like = torch.zeros((), dtype=torch.float64)
    k_t = torch.tensor(k, dtype=torch.float64)
    sig = torch.full((10_000,), sigma, dtype=torch.float64)
    r = torch.cat([tr._sample_radius_raw(n, sig, k_t,
                                         tr.draw_rounds(n, sig.shape, like, g))
                   for _ in range(10)])
    cdf = tr._radial_cdf(n, r, torch.full_like(r, sigma), k_t).numpy()
    # the CDF at the draws is uniform under the law
    p = stats.kstest(cdf, "uniform").pvalue
    assert p > 1e-3, p
