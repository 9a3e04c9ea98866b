"""The JAX package's public functions that the port's modules carried last
(``stable.safe_sqrt``, ``asin_clamped``, ``sin_k``, ``cos_k``,
``log_sin_k_div``, ``logsumexp``; ``normal.kl_diag``;
``hyperspherical_uniform.entropy``; ``von_mises_fisher.sample_and_log_prob``;
``special.log_iv``, ``erfcx``), each against its JAX counterpart on the
same seeded numpy inputs.

Tolerances, relative and absolute (as in ``test_torch_distributions.py``:
a sample coordinate or a log near 0 carries an absolute float32 error):
1e-10 in float64 (the same expressions; library last-digit differences
only) and 1e-5 in float32. ``erfcx`` and ``log_iv``
are taken across every branch: erfcx's direct product (|x| < 8), its
asymptotic series (|x| >= 8) and the reflection for x < 0; log_iv's
ascending series (x < 40), the Hankel expansion (x >= 40, nu <= 8) and the
Debye expansion (x >= 40, nu > 8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.distributions import hyperspherical_uniform as jhu
from mvae_tpu.distributions import normal as jn
from mvae_tpu.distributions import von_mises_fisher as jv
from mvae_tpu.ops import stable as js
from mvae_tpu.utils import special as jsp
from mvae_torch.distributions import hyperspherical_uniform as thu
from mvae_torch.distributions import normal as tn
from mvae_torch.distributions import von_mises_fisher as tv
from mvae_torch.ops import stable as ts
from mvae_torch.utils import special as tsp

from .test_torch_distributions import jax_noise

DTYPES = [pytest.param(np.float64, 1e-10, id="f64"),
          pytest.param(np.float32, 1e-5, id="f32")]
N = 257


def _close(got, want, rtol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def _pair(a):
    return torch.from_numpy(np.ascontiguousarray(a)), jnp.asarray(a)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_safe_sqrt_and_asin_clamped(dtype, rtol):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, N).astype(dtype)
    x[:4] = [0.0, -0.0, 1.0, -1.0]
    t, j = _pair(x)
    _close(ts.safe_sqrt(t), js.safe_sqrt(j), rtol)
    _close(ts.asin_clamped(t), js.asin_clamped(j), rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("k", [-2.0, -1e-3, 0.0, 1e-3, 0.7])
def test_sin_k_cos_k_log_sin_k_div(k, dtype, rtol):
    """Both sides of the series window |K r^2| < 1e-2 at each curvature;
    spherical radii stay inside the injectivity radius pi / sqrt(K)."""
    rng = np.random.default_rng(1)
    rmax = 3.0 if k <= 0 else 0.95 * np.pi / np.sqrt(k)
    r = rng.uniform(1e-3, rmax, N).astype(dtype)
    kk = np.asarray(k, dtype)
    (rt, rj), (kt, kj) = _pair(r), _pair(kk)
    _close(ts.sin_k(rt, kt), js.sin_k(rj, kj), rtol)
    _close(ts.cos_k(rt, kt), js.cos_k(rj, kj), rtol)
    _close(ts.log_sin_k_div(rt, kt), js.log_sin_k_div(rj, kj), rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("axis,keepdims", [(None, False), (None, True),
                                           (1, False), (-1, True),
                                           ((0, 2), False)])
def test_logsumexp(axis, keepdims, dtype, rtol):
    rng = np.random.default_rng(2)
    a = (30.0 * rng.standard_normal((5, 7, 3))).astype(dtype)
    t, j = _pair(a)
    _close(ts.logsumexp(t, axis, keepdims),
           js.logsumexp(j, axis=axis, keepdims=keepdims), rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("sigma_width", [1, 4])
def test_kl_diag(sigma_width, dtype, rtol):
    """Diagonal and isotropic (trailing 1) scales."""
    rng = np.random.default_rng(3)
    mu_q, mu_p = (rng.standard_normal((N, 4)).astype(dtype)
                  for _ in range(2))
    s_q, s_p = (np.exp(rng.uniform(-2, 1, (N, sigma_width))).astype(dtype)
                for _ in range(2))
    args = [_pair(a) for a in (mu_q, s_q, mu_p, s_p)]
    _close(tn.kl_diag(*(t for t, _ in args)),
           jn.kl_diag(*(j for _, j in args)), rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("m", [2, 3, 7])
def test_hyperspherical_uniform_entropy(m, dtype, rtol):
    k = np.asarray([0.05, 1.0, 3.7], dtype)
    kt, kj = _pair(k)
    _close(thu.entropy(m, kt), jhu.entropy(m, kj), rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("m,k", [(3, 1.0), (7, 0.5), (4, 2.0)])
def test_vmf_sample_and_log_prob(m, k, dtype, rtol):
    """On the noise and proposals JAX draws from its key (``jax_noise``);
    the float32 log q through the Bessel series at 1e-4, as the vMF tests
    of ``test_torch_distributions.py`` hold it."""
    from mvae_tpu.components import parse_components
    rng = np.random.default_rng(4)
    mu = rng.standard_normal((N, m)).astype(dtype)
    kappa = (1.0 + 60.0 * rng.random(N) ** 2).astype(dtype)
    kk = np.asarray(k, dtype)
    key = jax.random.key(8)
    (comp,) = parse_components(f"s{m - 1}")
    (ck,) = jax.random.split(key, 1)
    noise = torch.from_numpy(jax_noise(key, (comp,), N, dtype))
    z_j, lp_j = jv.sample_and_log_prob(ck, jnp.asarray(mu),
                                       jnp.asarray(kappa), jnp.asarray(kk))
    (mt, _), (kat, _), (kt, _) = _pair(mu), _pair(kappa), _pair(kk)
    z_t, lp_t = tv.sample_and_log_prob(
        mt, kat, kt, noise=noise,
        proposals=None if m == 3 else noise[:, m:])
    _close(z_t, z_j, rtol)
    _close(lp_t, lp_j, max(rtol, 1e-4) if dtype == np.float32 else rtol)
    z_d, lp_d = tv.sample_and_log_prob(mt, kat, kt, generator=torch.Generator(
        ).manual_seed(0))
    assert z_d.shape == (N, m) and bool(torch.isfinite(lp_d).all())
    torch.testing.assert_close(lp_d, tv.log_prob(z_d, mt, kat, kt))


# x on each branch of log_ive: the series below 40 (near 0, moderate, just
# under the switch) and the asymptotic forms above it
_LOG_IV_X = [1e-3, 0.5, 3.0, 12.0, 39.5, 40.5, 55.0, 300.0]


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("nu", [0.0, 0.5, 2.5, 8.0, 9.5, 15.5],
                         ids=lambda v: f"nu{v}")
def test_log_iv(nu, dtype, rtol):
    """nu <= 8 reaches the Hankel expansion above x = 40, nu > 8 the Debye
    expansion."""
    x = np.asarray(_LOG_IV_X, dtype)
    t, j = _pair(x)
    _close(tsp.log_iv(nu, t), jsp.log_iv(nu, j), rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_erfcx(dtype, rtol):
    """The direct product (|x| < 8), the asymptotic series (|x| >= 8), the
    reflection for x < 0 (|x| up to 9, where e^{x^2} stays in float32's
    range), and 0."""
    x = np.concatenate([np.linspace(-9.0, 9.0, 37), [0.0, 7.999, 8.0, 12.0,
                                                     1e3, -1e-3]])
    x = x.astype(dtype)
    t, j = _pair(x)
    _close(tsp.erfcx(t), jsp.erfcx(j), rtol)
