"""The port's model, trainer, CLI and spec DSL against the JAX package.

The same weights (``params_from_jax``) and the same noise (the JAX key
tree, rebuilt with ``draw_noise_t``) go through both packages.

Tolerances: in float64 the port's plain per-component path and the JAX
jnp path evaluate the same expressions: 1e-9 on ELBO and IWAE values of
magnitude ~50. In float32 the port takes its kernel route (on the CPU the
kernels' plain versions), whose hyperboloid log p is the tile's acosh_1p
radius rather than the jnp path's log-map round trip; both are float32
evaluations of one quantity, held to 1e-5 relative with a 1e-4 absolute
floor on the per-example ELBO / IWAE sums of 64 Bernoulli pixels.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.components import parse_components as j_parse
from mvae_tpu.kernels.tail_kernels import draw_noise_t
from mvae_tpu.models import vae as jvae
from mvae_torch import cli
from mvae_torch.components import canonical_name, parse_components
from mvae_torch.components import total_ambient_dim, total_true_dim
from mvae_torch.convert import params_from_jax
from mvae_torch.data import ArrayDataset
from mvae_torch.data.base import binarize_rows
from mvae_torch.models import vae as tvae
from mvae_torch.train import TrainConfig, Trainer

SPEC, D, H, B = "h2,s2,e2", 64, 32, 24
DTYPES = [pytest.param(np.float64, 1e-9, 1e-9, id="f64"),
          pytest.param(np.float32, 1e-5, 1e-4, id="f32")]


def _models(dtype, seed=0):
    jcfg = jvae.VAEConfig(j_parse(SPEC, fixed_curvature=False), (D,),
                          h_dim=H)
    tcfg = tvae.VAEConfig(parse_components(SPEC, fixed_curvature=False),
                          (D,), h_dim=H)
    jparams = jvae.init_params(jax.random.key(seed), jcfg, dtype=dtype)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    x = (np.random.default_rng(seed).random((B, D)) < 0.3).astype(dtype)
    return jcfg, tcfg, jparams, tparams, x


def test_params_from_jax_round_trip():
    jcfg, tcfg, jparams, tparams, _ = _models(np.float32)
    flat_j, tree_j = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    flat_t, tree_t = jax.tree.flatten(
        jax.tree.map(lambda t: t.numpy(), tparams))
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    w = tparams["decoder"]["out"]["w"]
    assert tuple(w.shape) == (H, D)          # (in, out), as nets._linear


@pytest.mark.parametrize("dtype,tol,atol", DTYPES)
def test_elbo_matches_jax(dtype, tol, atol):
    jcfg, tcfg, jparams, tparams, x = _models(dtype)
    key = jax.random.key(11)
    val_j, stats_j = jvae.elbo(key, jcfg, jparams, jnp.asarray(x))
    noise = np.asarray(draw_noise_t(key, jcfg.components, B, dtype)).T
    val_t, stats_t = tvae.elbo(tcfg, tparams, torch.from_numpy(x),
                               noise=torch.from_numpy(noise.copy()))
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=tol,
                               atol=atol)
    for k in ("kl_per_comp", "curvature", "bce"):
        np.testing.assert_allclose(stats_t[k].numpy(),
                                   np.asarray(stats_j[k]), rtol=tol,
                                   atol=atol)


def _iwae_noise(key, comps, n, chunk, dtype):
    """The JAX estimator's key tree: split(key, n_chunks) -> split(ck,
    chunk) -> per-sample draw_noise_t (exact for the m = 3 vMF)."""
    rows = []
    for ck in jax.random.split(key, n // chunk):
        for sk in jax.random.split(ck, chunk):
            rows.append(np.asarray(draw_noise_t(sk, comps, B, dtype)).T)
    return torch.from_numpy(np.stack(rows))


@pytest.mark.parametrize("dtype,tol,atol", DTYPES)
def test_log_likelihood_matches_jax(dtype, tol, atol):
    jcfg, tcfg, jparams, tparams, x = _models(dtype)
    key = jax.random.key(12)
    n, chunk = 8, 4
    ll_j = jvae.log_likelihood(key, jcfg, jparams, jnp.asarray(x), n, chunk)
    noise = _iwae_noise(key, jcfg.components, n, chunk, dtype)
    ll_t = tvae.log_likelihood(tcfg, tparams, torch.from_numpy(x), n, chunk,
                               noise=noise)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=tol,
                               atol=atol)


def test_log_weights_do_not_depend_on_chunking():
    """Noise is indexed by global sample, so the plain (float64) path at
    chunk 2 and at chunk 6 gives the same weights."""
    _, tcfg, _, tparams, x = _models(np.float64)
    g = torch.Generator().manual_seed(0)
    noise = tvae.tail_kernels.draw_noise(tcfg.components, (6, B),
                                         torch.zeros((), dtype=torch.float64),
                                         g)
    xt = torch.from_numpy(x)
    a = tvae._log_weights(tcfg, tparams, xt, 6, 2, noise=noise)
    b = tvae._log_weights(tcfg, tparams, xt, 6, 6, noise=noise)
    assert a.shape == (6, B)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_fused_path_report_names_the_port_kernels():
    _, tcfg, _, tparams, _ = _models(np.float32)
    rep = tvae.fused_path_report(tcfg, tparams)
    assert rep["train_tail"]["active"] and "tail_fwd.cu" in \
        rep["train_tail"]["why"]
    assert rep["iwae_decoder"]["active"] and "decode_bce.cu" in \
        rep["iwae_decoder"]["why"]
    _, tcfg, _, tparams64, _ = _models(np.float64)
    rep = tvae.fused_path_report(tcfg, tparams64)
    assert not rep["train_tail"]["active"]
    assert not rep["iwae_decoder"]["active"]


def _dataset(n_test=40):
    rng = np.random.default_rng(3)
    return ArrayDataset("toy", rng.random((32, 8, 8), dtype=np.float32),
                        rng.random((n_test, 8, 8), dtype=np.float32), (8, 8),
                        True)


def _trainer(**tc):
    cfg = tvae.VAEConfig(parse_components(SPEC), (8, 8), h_dim=16)
    return Trainer(cfg, _dataset(), TrainConfig(eval_batch_size=16,
                                                likelihood_n=6, **tc),
                   device="cpu")


@pytest.mark.parametrize("mode", ["dynamic", "fixed"])
def test_trainer_eval_on_cpu(mode):
    tr = _trainer(eval_binarize=mode)
    stats = tr.evaluate_elbo("test")
    ll = tr.evaluate_log_likelihood("test")
    assert np.isfinite(stats["elbo"]) and np.isfinite(ll)
    assert set(stats) >= {"elbo", "bce", "kl", "kl/h2#0", "curvature/s2#1"}
    assert ll > stats["elbo"] - 50.0
    # a new trainer from the same seed repeats the pass draw for draw
    tr2 = _trainer(eval_binarize=mode)
    assert tr2.evaluate_elbo("test") == stats
    assert tr2.evaluate_log_likelihood("test") == ll
    assert tr.evaluate_log_likelihood("test", max_examples=10,
                                      repeats=2) < 0.0
    with pytest.raises(NotImplementedError):
        tr.fit()


def test_fixed_binarization_is_independent_of_batching():
    x = torch.from_numpy(_dataset().test).reshape(40, -1)
    rows = torch.arange(40)
    whole = binarize_rows(7, rows, x, True)
    parts = torch.cat([binarize_rows(7, rows[i:i + 16], x[i:i + 16], True)
                       for i in range(0, 40, 16)])
    assert torch.equal(whole, parts)
    assert 0.3 < float(whole.mean() / x.mean()) < 1.7
    assert not torch.equal(whole, binarize_rows(8, rows, x, True))


def test_cli_eval_only_on_cpu(capsys):
    result = cli.main(["--dataset", "bdp", "--model", SPEC, "--h_dim", "16",
                       "--likelihood_n", "4", "--ll_max_examples", "16",
                       "--eval_only", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["test/log_likelihood_iwae"] == result[
        "test/log_likelihood_iwae"]
    assert np.isfinite(line["test/elbo"])
    assert line["fused_paths"]["train_tail"]["active"]
    with pytest.raises(NotImplementedError):
        cli.main(["--dataset", "bdp", "--device", "cpu"])


# --- the spec DSL, on the strings of tests/components TestSpecParser --------


def test_spec_basic():
    comps = parse_components("h2,s2,e2")
    assert [c.name for c in comps] == ["h2", "s2", "e2"]
    assert [c.posterior for c in comps] == ["wrapped", "vmf", "normal"]
    assert total_true_dim(comps) == 6
    assert total_ambient_dim(comps) == 3 + 3 + 2
    assert canonical_name(comps) == "(H^2)x(S^2)x(E^2)"


def test_spec_multiplier_and_suffix():
    assert len(parse_components("3h2")) == 3
    assert parse_components("2h2,s3") == parse_components("h2,h2,s3")
    assert parse_components("s6:wrapped")[0].posterior == "wrapped"
    assert parse_components("d3:riemannian")[0].posterior == "riemannian"
    assert not parse_components("h2", fixed_curvature=False)[0] \
        .fixed_curvature
    comps = parse_components("e2,h2,d2,s2,p2,u2")
    assert total_ambient_dim(comps) == 2 + 3 + 2 + 3 + 2 + 2


@pytest.mark.parametrize("bad", ["", "x3", "h", "h2;s2", "0h2", "e3:vmf",
                                 "s2:riemannian", "h2:bogus"])
def test_spec_rejects(bad):
    with pytest.raises(ValueError):
        parse_components(bad)


def test_later_slice_geometry_raises():
    (comp,) = parse_components("d2")
    with pytest.raises(NotImplementedError):
        comp.manifold.exp_map_mu0(torch.zeros(3, 2), torch.tensor(-1.0))
