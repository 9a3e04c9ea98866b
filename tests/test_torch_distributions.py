"""mvae_torch distributions and components against the JAX package, with
the noise given: JAX draws it from its keys exactly as its samplers do, and
the port receives the same numbers.

Tolerances: 1e-10 relative/absolute in float64 (same expressions, library
last-digit differences only) and 1e-5 in float32 (a few ulps through the
exp/log chains; values are O(1-10)). float32 cases keep hyperbolic radii
where float32 is well-conditioned; the vMF KL in float32 is held to 1e-4,
because its Bessel series sums 64 log-space terms of magnitude ~100.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.components import parse_components as j_parse
from mvae_tpu.components import reparametrize as j_reparametrize
from mvae_tpu.distributions import normal as jn
from mvae_tpu.distributions import von_mises_fisher as jv
from mvae_tpu.distributions import wrapped_normal as jw
from mvae_tpu.kernels.tail_kernels import draw_noise_t
from mvae_tpu.ops import Manifold as JManifold
from mvae_torch.components import parse_components as t_parse
from mvae_torch.components import reparametrize as t_reparametrize
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
    with pytest.raises(NotImplementedError):
        tv.sample(torch.ones(4, 5), torch.ones(4), torch.tensor(1.0),
                  noise=torch.rand(4, 5))


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
