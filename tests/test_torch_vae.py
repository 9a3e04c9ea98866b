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

The stereographic family (d2,p2,e2, u6, p6): in float64 both packages take
their plain library paths (1e-9). In float32 the port takes its kernel
route, so the JAX package runs its Pallas kernels in interpret mode
(MVAE_FUSED_TAIL=1, and MVAE_FUSED_REPARAM=1 with MVAE_FUSED_DECODER=1 for
IWAE, whose kernel components draw their noise from ``fold_in(ck, ci)``):
the same expressions, 1e-5 relative with a 1e-4 floor, except that the
reference's IWAE decode kernel splits its float32 products in three bf16
passes (~2e-3 nats per sample against plain float32): the IWAE estimate is
held to 5e-3 nats and the chunk reparam alone to the tight tolerance.

The spherical family (s6:wrapped, s3:wrapped,h2,e2, s6, p2:vmf,e2) likewise:
wrapped-on-s takes the kernel route in float32 (the JAX tile in interpret
mode on the other side), the vMF beyond s2 the plain per-component tail in
both packages, fed the rejection proposals JAX drew (``jax_noise``).
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
from mvae_torch.models import route as troute
from mvae_torch.models import vae as tvae
from mvae_torch.train import TrainConfig, Trainer
from tests.test_torch_distributions import jax_noise

SPEC, D, H, B = "h2,s2,e2", 64, 32, 24
DTYPES = [pytest.param(np.float64, 1e-9, 1e-9, id="f64"),
          pytest.param(np.float32, 1e-5, 1e-4, id="f32")]


def _models(dtype, seed=0, spec=SPEC, c_params=None, **spec_opts):
    """Both packages' configs and the same weights; ``c_params`` overrides
    the curvature leaves (in component order, those that have one)."""
    jcfg = jvae.VAEConfig(j_parse(spec, fixed_curvature=False, **spec_opts),
                          (D,), h_dim=H)
    tcfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=False,
                                           **spec_opts), (D,), h_dim=H)
    jparams = jvae.init_params(jax.random.key(seed), jcfg, dtype=dtype)
    if c_params is not None:
        with_c = [cp for cp in jparams["components"] if "c_param" in cp]
        for cp, c in zip(with_c, c_params, strict=True):
            cp["c_param"] = jnp.asarray(c, dtype)
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
    r = troute.route(tcfg, tparams)
    a = tvae._log_weights(tcfg, tparams, r, xt, 6, 2, noise=noise)
    b = tvae._log_weights(tcfg, tparams, r, xt, 6, 6, noise=noise)
    assert a.shape == (6, B)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_fused_path_report_names_the_port_kernels():
    _, tcfg, _, tparams, _ = _models(np.float32)
    rep = troute.report(tcfg, tparams, "cpu")
    assert rep["train_tail"]["active"] and "tail_fwd.cu" in \
        rep["train_tail"]["why"]
    assert rep["iwae_decoder"]["active"] and "decode_bce.cu" in \
        rep["iwae_decoder"]["why"]
    _, tcfg, _, tparams64, _ = _models(np.float64)
    rep = troute.report(tcfg, tparams64, "cpu")
    assert not rep["train_tail"]["active"]
    assert not rep["iwae_decoder"]["active"]


def _bf16_models(spec="h2,e2"):
    """The JAX package's bfloat16 weights, and the same values in the port
    (through float32: numpy has no bfloat16 torch reads), with x."""
    jcfg = jvae.VAEConfig(j_parse(spec, fixed_curvature=False), (D,), h_dim=H)
    tcfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=False),
                          (D,), h_dim=H)
    jparams = jvae.init_params(jax.random.key(0), jcfg, dtype=jnp.bfloat16)
    tparams = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16), jparams)
    x = (np.random.default_rng(0).random((B, D)) < 0.3).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, x


def _bf16_noise(key, comps):
    """JAX's bfloat16 draws, through float32, as bfloat16 tensors."""
    return torch.from_numpy(np.asarray(draw_noise_t(
        key, comps, B, jnp.bfloat16).astype(jnp.float32)).T.copy()).to(
            torch.bfloat16)


def _not_on_bf16_grid(v):
    """A float32 result that a bfloat16 sum would have quantized (at a
    magnitude of 50-150 bfloat16 steps are 0.25-1 nat) has entries that
    bfloat16 cannot hold."""
    return bool((v.to(torch.bfloat16).float() != v).any())


def test_bf16_elbo_accumulates_in_float32():
    """Under --dtype bfloat16 the per-pixel terms, the Gaussian and wrapped
    sums accumulate in float32, as the reference's: log p(x|z), log q,
    log p and the ELBO come back float32 and equal the JAX package's at
    bfloat16 on the same weights and noise. Both frameworks round each
    bfloat16 op of the same sequence here; the tolerance, 1e-3 nats, is
    far under the 0.25-nat bfloat16 step a bfloat16 sum would leave."""
    jcfg, tcfg, jparams, tparams, x = _bf16_models()
    key = jax.random.key(11)
    xj = jnp.asarray(x, jnp.bfloat16)
    fj = jvae.forward(key, jcfg, jparams, xj)
    val_j, _ = jvae.elbo(key, jcfg, jparams, xj)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    noise = _bf16_noise(key, jcfg.components)
    ft = tvae.forward(tcfg, tparams, xt, noise=noise)
    val_t, _ = tvae.elbo(tcfg, tparams, xt, noise=noise)
    for ours, theirs in ((ft.log_px_z, fj.log_px_z), (ft.log_q, fj.log_q),
                         (ft.log_p, fj.log_p), (val_t, val_j)):
        assert ours.dtype == torch.float32 and theirs.dtype == jnp.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=0, atol=1e-3)
    assert _not_on_bf16_grid(ft.log_px_z) and _not_on_bf16_grid(val_t)


def test_bf16_iwae_accumulates_in_float32():
    """IWAE-40 under bfloat16: the log-weights come back float32, each equal
    to the JAX package's forward of that importance sample on the same
    weights and noise (1e-3 nats, as the ELBO), and the estimate within
    0.05 nats of ``jvae.log_likelihood``: XLA rounds the reference's
    vmapped bfloat16 samples otherwise than one sample at a time (its
    log-weights move up to ~0.5 nats between the two on these weights,
    its estimate ~0.02), while a bfloat16 log-weight sum moves the
    estimate by 0.25-0.35 nats."""
    jcfg, tcfg, jparams, tparams, x = _bf16_models()
    key = jax.random.key(12)
    n, chunk = 40, 20
    xj = jnp.asarray(x, jnp.bfloat16)
    feats = jvae.encode(jcfg, jparams, xj)
    noise, lw_j = [], []
    for ck in jax.random.split(key, n // chunk):
        for sk in jax.random.split(ck, chunk):
            noise.append(_bf16_noise(sk, jcfg.components))
            f = jvae.forward_from_features(sk, jcfg, jparams, xj, feats)
            lw_j.append(np.asarray(f.log_px_z + f.log_p - f.log_q))
    noise = torch.stack(noise)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    lw_t = tvae._log_weights(tcfg, tparams, troute.route(tcfg, tparams), xt,
                             n, chunk, noise=noise)
    assert lw_t.dtype == torch.float32
    np.testing.assert_allclose(lw_t.numpy(), np.stack(lw_j), rtol=0,
                               atol=1e-3)
    ll_t = tvae.log_likelihood(tcfg, tparams, xt, n, chunk, noise=noise)
    ll_j = jvae.log_likelihood(key, jcfg, jparams, xj, n, chunk)
    assert ll_t.dtype == torch.float32 and _not_on_bf16_grid(ll_t)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=0,
                               atol=0.05)


def _dataset(n_test=40):
    rng = np.random.default_rng(3)
    return ArrayDataset("toy", rng.random((32, 8, 8), dtype=np.float32),
                        rng.random((n_test, 8, 8), dtype=np.float32), (8, 8),
                        True)


def _trainer(run_dir, **tc):
    cfg = tvae.VAEConfig(parse_components(SPEC), (8, 8), h_dim=16)
    return Trainer(cfg, _dataset(), TrainConfig(eval_batch_size=16,
                                                likelihood_n=6, **tc),
                   run_dir=str(run_dir), device="cpu")


@pytest.mark.parametrize("mode", ["dynamic", "fixed"])
def test_trainer_eval_on_cpu(mode, tmp_path):
    tr = _trainer(tmp_path, eval_binarize=mode)
    stats = tr.evaluate_elbo("test")
    ll = tr.evaluate_log_likelihood("test")
    assert np.isfinite(stats["elbo"]) and np.isfinite(ll)
    assert set(stats) >= {"elbo", "bce", "kl", "kl/h2#0", "curvature/s2#1"}
    assert ll > stats["elbo"] - 50.0
    # a new trainer from the same seed repeats the pass draw for draw
    tr2 = _trainer(tmp_path, eval_binarize=mode)
    assert tr2.evaluate_elbo("test") == stats
    assert tr2.evaluate_log_likelihood("test") == ll
    assert tr.evaluate_log_likelihood("test", max_examples=10,
                                      repeats=2) < 0.0
    # evaluation takes no optimizer step and leaves no gradients
    assert tr.step == 0 and not tr.opt.state
    assert all(cp["w_mu"].grad is None for cp in tr.params["components"])


def test_fixed_binarization_is_independent_of_batching():
    x = torch.from_numpy(_dataset().test).reshape(40, -1)
    rows = torch.arange(40)
    whole = binarize_rows(7, rows, x, True)
    parts = torch.cat([binarize_rows(7, rows[i:i + 16], x[i:i + 16], True)
                       for i in range(0, 40, 16)])
    assert torch.equal(whole, parts)
    assert 0.3 < float(whole.mean() / x.mean()) < 1.7
    assert not torch.equal(whole, binarize_rows(8, rows, x, True))


def test_cli_eval_only_on_cpu(capsys, tmp_path):
    """--eval_only restores the run's latest checkpoint (and refuses a run
    directory that has none), then prints the test ELBO and IWAE LL."""
    args = ["--dataset", "bdp", "--model", SPEC, "--h_dim", "16",
            "--likelihood_n", "4", "--ll_max_examples", "16", "--device",
            "cpu", "--run_dir", str(tmp_path)]
    with pytest.raises(FileNotFoundError):
        cli.main(args + ["--eval_only"])
    cli.main(args + ["--epochs", "1"])
    result = cli.main(args + ["--eval_only"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["test/log_likelihood_iwae"] == result[
        "test/log_likelihood_iwae"]
    assert np.isfinite(line["test/elbo"])
    assert line["fused_paths"]["train_tail"]["active"]
    # --generate with --eval_only samples from the restored checkpoint
    cli.main(args + ["--eval_only", "--generate", "4"])
    with np.load(tmp_path / "samples.npz") as f:
        assert {k: f[k].shape for k in f.files} == {
            k: (4,) + tuple(f["originals"].shape[1:])
            for k in ("generated", "originals", "reconstructions")}


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
    """The stereographic kinds are ported: their geometry runs, and so does
    the vMF on the projected sphere. The Riemannian normal, which raised
    before its slice, now draws too: a point inside the ball."""
    from mvae_torch.components import reparametrize
    (comp,) = parse_components("d2")
    z = comp.manifold.exp_map_mu0(torch.ones(3, 2), torch.tensor(-1.0))
    assert bool(torch.isfinite(z).all()) and float(z.norm(dim=1).max()) < 1.0
    (comp,) = parse_components("p2:vmf")
    params = comp.init_params(8, generator=torch.Generator())
    rep = reparametrize(comp, params, torch.zeros(3, 8),
                        generator=torch.Generator())
    assert rep.z.shape == (3, 2) and bool(torch.isfinite(rep.z).all())
    (comp,) = parse_components("d2:riemannian")
    params = comp.init_params(8, generator=torch.Generator())
    rep = reparametrize(comp, params, torch.zeros(3, 8),
                        generator=torch.Generator())
    assert rep.z.shape == (3, 2) and bool(torch.isfinite(rep.z).all())
    assert float(rep.z.norm(dim=1).max()) < 1.0
    assert all(bool(torch.isfinite(t).all()) for t in rep[1:])


# --- the stereographic family ------------------------------------------------

STEREO = [pytest.param("d2,p2,e2", None, id="d2p2e2"),
          pytest.param("d2,p2,e2", (np.log(0.3), np.log(2.5)),
                       id="d2p2e2-K-0.3+2.5"),
          pytest.param("u6", None, id="u6"),
          pytest.param("u6", (-1e-3,), id="u6-K-1e-3"),
          pytest.param("u6", (0.0,), id="u6-K0"),
          pytest.param("u6", (1e-3,), id="u6-K+1e-3"),
          pytest.param("p6", None, id="p6")]


def _fused_env(monkeypatch, dtype, iwae=False):
    if dtype == np.float32:
        monkeypatch.setenv("MVAE_FUSED_TAIL", "1")
        if iwae:
            monkeypatch.setenv("MVAE_FUSED_REPARAM", "1")
            monkeypatch.setenv("MVAE_FUSED_DECODER", "1")


@pytest.mark.parametrize("dtype,tol,atol", DTYPES)
@pytest.mark.parametrize("spec,c_params", STEREO)
def test_elbo_matches_jax_stereo(monkeypatch, spec, c_params, dtype, tol,
                                 atol):
    _fused_env(monkeypatch, dtype)
    jcfg, tcfg, jparams, tparams, x = _models(dtype, 1, spec, c_params)
    key = jax.random.key(21)
    val_j, stats_j = jvae.elbo(key, jcfg, jparams, jnp.asarray(x))
    noise = np.asarray(draw_noise_t(key, jcfg.components, B, dtype)).T
    val_t, stats_t = tvae.elbo(tcfg, tparams, torch.from_numpy(x),
                               noise=torch.from_numpy(noise.copy()))
    assert troute.report(tcfg, tparams, "cpu")["train_tail"]["active"] == (
        dtype == np.float32)
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=tol,
                               atol=atol)
    for k in ("kl_per_comp", "curvature", "bce"):
        np.testing.assert_allclose(stats_t[k].numpy(),
                                   np.asarray(stats_j[k]), rtol=tol,
                                   atol=atol)


def _chunk_noise(ck, jcfg, jparams, chunk, dtype, fused):
    """(chunk, B, E) noise of one IWAE chunk of the JAX estimator: per
    sample ``jax_noise(split(ck, chunk)[s])`` (``draw_noise_t`` plus the
    rejection cosine's proposals); with the fused reparam, a kernel
    component ci instead reads its block
    ``normal(fold_in(ck, ci), (dim, chunk, B))``."""
    comps = jcfg.components
    rows = np.stack([jax_noise(sk, comps, B, dtype)
                     for sk in jax.random.split(ck, chunk)])
    off = 0
    for ci, (comp, cp) in enumerate(zip(comps, jparams["components"])):
        width = comp.dim
        if comp.posterior == "vmf":
            width += 1 + (0 if comp.dim == 2 else 32)
        if fused and jvae._fused_reparam_eligible(comp, cp):
            eps = jax.random.normal(jax.random.fold_in(ck, ci),
                                    (comp.dim, chunk, B), dtype)
            rows[:, :, off:off + width] = np.asarray(eps).transpose(1, 2, 0)
        off += width
    return rows


@pytest.mark.parametrize("spec,c_params", STEREO)
def test_reparam_chunk_matches_jax(monkeypatch, spec, c_params):
    """One IWAE chunk through the JAX package's fused reparam (Pallas,
    interpret mode) and through the port's route (B5 for d / p / u, P2 for
    e), on the fold_in noise."""
    monkeypatch.setenv("MVAE_FUSED_REPARAM", "1")
    jcfg, tcfg, jparams, tparams, x = _models(np.float32, 2, spec, c_params)
    ck, chunk = jax.random.key(5), 4
    feats = jvae.encode(jcfg, jparams, jnp.asarray(x))
    zt_j, lq_j, lp_j = jvae._reparam_chunk_t(ck, jcfg, jparams, feats, chunk)
    noise = _chunk_noise(ck, jcfg, jparams, chunk, np.float32, True)
    rep = troute.report(tcfg, tparams, "cpu")["iwae_reparam"]
    assert [r["active"] for r in rep] == [
        c.manifold.kind in "dpu" or tvae.tail_kernels.chunk_supported(c)
        for c in tcfg.components]
    zt, lq, lp = tvae._reparam_chunk_t(
        tcfg, tparams, troute.route(tcfg, tparams), torch.from_numpy(np.asarray(feats)), chunk,
        torch.from_numpy(noise))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zt_j), rtol=3e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lq.numpy(), np.asarray(lq_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dtype,tol,atol", [
    pytest.param(np.float64, 1e-9, 1e-9, id="f64"),
    pytest.param(np.float32, 1e-5, 5e-3, id="f32")])
@pytest.mark.parametrize("spec,c_params", STEREO[:4])
def test_log_likelihood_matches_jax_stereo(monkeypatch, spec, c_params,
                                           dtype, tol, atol):
    _fused_env(monkeypatch, dtype, iwae=True)
    jcfg, tcfg, jparams, tparams, x = _models(dtype, 3, spec, c_params)
    key = jax.random.key(22)
    n, chunk = 8, 4
    ll_j = jvae.log_likelihood(key, jcfg, jparams, jnp.asarray(x), n, chunk)
    if dtype == np.float32:  # the fused decoder regroups 8 samples as one chunk
        chunk = 8
    noise = np.concatenate([
        _chunk_noise(ck, jcfg, jparams, chunk, dtype, dtype == np.float32)
        for ck in jax.random.split(key, n // chunk)])
    ll_t = tvae.log_likelihood(tcfg, tparams, torch.from_numpy(x), n, chunk,
                               noise=torch.from_numpy(noise))
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=tol,
                               atol=atol)


PREDICATE_SPECS = ["e2", "h2", "d2", "p2", "u2", "s2", "s3", "s2:wrapped",
                   "s6:wrapped", "p2:vmf", "d3:riemannian", "h33", "u32",
                   "e2:wrapped", "d2,p2,e2", "u6", "s32:wrapped",
                   "s33:wrapped", "s6", "s3:wrapped,h2,e2"]


@pytest.mark.parametrize("sigma_cap", [True, False])
def test_kernel_predicates_agree_with_jax(monkeypatch, sigma_cap):
    """``component_supported`` and the route's B5 components agree with
    the JAX predicates on every spec."""
    from mvae_tpu.kernels import tail_kernels as jtk
    monkeypatch.setenv("MVAE_FUSED_REPARAM", "1")
    for spec in PREDICATE_SPECS:
        jcs = j_parse(spec, sigma_cap=sigma_cap)
        tcs = parse_components(spec, sigma_cap=sigma_cap)
        for jc, tc in zip(jcs, tcs, strict=True):
            want = jtk.component_supported(jc)
            if tc.posterior == "wrapped" and tc.manifold.kind == "s":
                assert want == (sigma_cap and tc.dim <= 32)
            assert tvae.tail_kernels.component_supported(tc) == want, spec
        for dt_j, dt_t in ((jnp.float32, torch.float32),
                           (jnp.float64, torch.float64)):
            cfg = tvae.VAEConfig(tcs, (D,), h_dim=H)
            r = troute.route(cfg, tvae.init_params(cfg, dtype=dt_t,
                                                   device="meta"))
            assert [k == "stereo" for k in r.chunk] == [
                jvae._fused_reparam_eligible(jc, {"w_mu": jnp.zeros(1, dt_j)})
                for jc in jcs], spec


@pytest.mark.parametrize("spec,opts", [("s6:wrapped", {"sigma_cap": False}),
                                       ("p6", {"sigma_cap": False}),
                                       ("p6", {"wraps": 0}),
                                       ("u6", {"sigma_cap": False}),
                                       ("s6", {}), ("p2:vmf,e2", {}),
                                       ("s3,s2", {})])
def test_plain_tail_products_match_jax(spec, opts):
    """Products outside the tail kernel's family (an uncapped
    positive-capable component; a vMF beyond s2 or on the projected sphere)
    take the plain per-component tail and match the JAX package's jnp path:
    float32, 1e-5 relative with a 2e-4 floor (library path against library
    path); the capped wraps = 0 product stays on the kernel route."""
    jcfg, tcfg, jparams, tparams, x = _models(np.float32, 4, spec, **opts)
    rep = troute.report(tcfg, tparams, "cpu")
    assert rep["train_tail"]["active"] == ("wraps" in opts)
    assert rep["iwae_reparam"][0]["active"] == spec.startswith(("p6", "u6"))
    key = jax.random.key(31)
    val_j, _ = jvae.elbo(key, jcfg, jparams, jnp.asarray(x))
    noise = jax_noise(key, jcfg.components, B, np.float32)
    val_t, _ = tvae.elbo(tcfg, tparams, torch.from_numpy(x),
                         noise=torch.from_numpy(noise.copy()))
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=1e-5,
                               atol=2e-4)
    key = jax.random.key(32)
    ll_j = jvae.log_likelihood(key, jcfg, jparams, jnp.asarray(x), 4, 2)
    noise = np.concatenate([
        _chunk_noise(ck, jcfg, jparams, 2, np.float32, False)
        for ck in jax.random.split(key, 2)])
    ll_t = tvae.log_likelihood(tcfg, tparams, torch.from_numpy(x), 4, 2,
                               noise=torch.from_numpy(noise))
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-5,
                               atol=5e-4)


# --- the spherical family -----------------------------------------------------

SPHERE = [pytest.param("s6:wrapped", None, {}, id="s6w"),
          pytest.param("s6:wrapped", (np.log(4.0),), {}, id="s6w-K4"),
          pytest.param("s6:wrapped", (np.log(1e-3),), {"wraps": 0},
                       id="s6w-K1e-3-wraps0"),
          pytest.param("s3:wrapped,h2,e2", None, {"scalar_sigma": True},
                       id="s3w-h2-e2-scalar"),
          pytest.param("s6", (np.log(2.0),), {}, id="s6-vmf"),
          pytest.param("p2:vmf,e2", None, {}, id="p2vmf-e2"),
          pytest.param("3s2", None, {}, id="3s2")]


@pytest.mark.parametrize("dtype,tol,atol", DTYPES)
@pytest.mark.parametrize("spec,c_params,opts", SPHERE)
def test_elbo_matches_jax_sphere(monkeypatch, spec, c_params, opts, dtype,
                                 tol, atol):
    """``forward`` / ``elbo`` of the spherical family on converted weights
    and the JAX draw's noise; wrapped-on-s and 3s2 on the kernel route in
    float32."""
    _fused_env(monkeypatch, dtype)
    jcfg, tcfg, jparams, tparams, x = _models(dtype, 5, spec, c_params,
                                              **opts)
    key = jax.random.key(41)
    val_j, stats_j = jvae.elbo(key, jcfg, jparams, jnp.asarray(x))
    noise = torch.from_numpy(jax_noise(key, jcfg.components, B, dtype))
    val_t, stats_t = tvae.elbo(tcfg, tparams, torch.from_numpy(x),
                               noise=noise)
    on_tail = dtype == np.float32 and "vmf" not in spec and spec != "s6"
    assert troute.report(tcfg, tparams, "cpu")["train_tail"]["active"] == \
        on_tail
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=tol,
                               atol=atol)
    for k in ("kl_per_comp", "curvature", "bce"):
        np.testing.assert_allclose(stats_t[k].numpy(),
                                   np.asarray(stats_j[k]), rtol=tol,
                                   atol=atol)
    fwd_j = jvae.forward(key, jcfg, jparams, jnp.asarray(x))
    fwd_t = tvae.forward(tcfg, tparams, torch.from_numpy(x), noise=noise)
    for name in ("z", "log_q", "log_p", "log_px_z"):
        np.testing.assert_allclose(getattr(fwd_t, name).numpy(),
                                   np.asarray(getattr(fwd_j, name)),
                                   rtol=max(tol, 1e-5) * 3, atol=atol)


@pytest.mark.parametrize("dtype,tol,atol", [
    pytest.param(np.float64, 1e-9, 1e-9, id="f64"),
    pytest.param(np.float32, 1e-5, 5e-4, id="f32")])
@pytest.mark.parametrize("spec,c_params,opts", SPHERE[:1] + SPHERE[3:6])
def test_log_likelihood_matches_jax_sphere(spec, c_params, opts, dtype, tol,
                                           atol):
    """IWAE on the spherical family: the wrapped sphere and the vMF beyond
    s2 or on p draw per sample in plain PyTorch (no chunk reparam kernel
    covers them); in float32 the h and e components take P2 (its plain
    version on CPU tensors), against the JAX package's library path."""
    jcfg, tcfg, jparams, tparams, x = _models(dtype, 6, spec, c_params,
                                              **opts)
    rep = troute.report(tcfg, tparams, "cpu")["iwae_reparam"]
    assert [r["active"] for r in rep] == [
        dtype == np.float32 and tvae.tail_kernels.chunk_supported(c)
        for c in tcfg.components]
    assert not any("reparam_stereo" in r["why"] for r in rep)
    key = jax.random.key(42)
    n, chunk = 6, 3
    ll_j = jvae.log_likelihood(key, jcfg, jparams, jnp.asarray(x), n, chunk)
    noise = np.concatenate([
        _chunk_noise(ck, jcfg, jparams, chunk, dtype, False)
        for ck in jax.random.split(key, n // chunk)])
    ll_t = tvae.log_likelihood(tcfg, tparams, torch.from_numpy(x), n, chunk,
                               noise=torch.from_numpy(noise))
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=tol,
                               atol=atol)


def test_fused_path_report_of_the_spherical_family():
    """Wrapped-on-s products ride the fused tail; the rejection-cosine vMF
    and an uncapped wrapped sphere the plain per-component tail."""
    def tail(spec, **opts):
        cfg = tvae.VAEConfig(parse_components(spec, **opts), (D,), h_dim=H)
        params = tvae.init_params(cfg,
                                  generator=torch.Generator().manual_seed(0))
        return troute.report(cfg, params, "cpu")["train_tail"]

    for spec in ("s6:wrapped", "s3:wrapped,h2,e2", "3s2"):
        assert tail(spec)["active"] and "tail_bwd.cu" in tail(spec)["why"]
    assert not tail("s6")["active"] and "s6:vmf" in tail("s6")["why"]
    assert not tail("p2:vmf,e2")["active"]
    assert not tail("s6:wrapped", sigma_cap=False)["active"]


@pytest.mark.parametrize("spec", ["s6", "s6:wrapped", "p2:vmf,e2"])
def test_params_from_jax_carries_the_spherical_family(spec):
    """No new leaves: the reference's pytree of these products converts
    leaf by leaf, in the structure ``init_params`` builds."""
    jcfg, tcfg, jparams, tparams, _ = _models(np.float32, 2, spec)
    flat_j, tree_j = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    flat_t, tree_t = jax.tree.flatten(
        jax.tree.map(lambda t: t.numpy(), tparams))
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    own = tvae.init_params(tcfg, generator=torch.Generator().manual_seed(0))
    assert jax.tree.structure(jax.tree.map(lambda t: t.numpy(), own)) == \
        tree_t
    assert [tuple(a.shape) for a in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), own))] == [a.shape for a in flat_t]


@pytest.mark.parametrize("dtype,tol,atol", DTYPES)
@pytest.mark.parametrize("spec", ["h2,s2,e2", "s6:wrapped", "s6",
                                  "p2:vmf,e2"])
def test_reconstruct_matches_jax(monkeypatch, spec, dtype, tol, atol):
    _fused_env(monkeypatch, dtype)
    jcfg, tcfg, jparams, tparams, x = _models(dtype, 7, spec)
    key = jax.random.key(43)
    rec_j = jvae.reconstruct(key, jcfg, jparams, jnp.asarray(x))
    noise = torch.from_numpy(jax_noise(key, jcfg.components, B, dtype))
    rec_t = tvae.reconstruct(tcfg, tparams, torch.from_numpy(x), noise=noise)
    assert rec_t.shape == (B, D)
    np.testing.assert_allclose(rec_t.numpy(), np.asarray(rec_j), rtol=tol,
                               atol=atol)


@pytest.mark.parametrize("spec", ["h2,s2,e2", "d2,p2,e2", "u6", "s6:wrapped",
                                  "s6", "p2:vmf,e2", "s3:wrapped,h2,e2"])
def test_generate_and_reconstruct(spec):
    """``generate`` / ``reconstruct``: shapes, Bernoulli means in [0, 1],
    finite, the same under the same seeded generator and different under
    another."""
    cfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=False),
                         (8, 8), h_dim=16)
    params = tvae.init_params(cfg, generator=torch.Generator().manual_seed(0))
    x = (torch.rand(5, 8, 8, generator=torch.Generator().manual_seed(1))
         < 0.3).float()

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return (tvae.generate(cfg, params, 6, g),
                    tvae.reconstruct(cfg, params, x, generator=g))

    gen, rec = run(3)
    assert gen.shape == (6, 8, 8) and rec.shape == (5, 8, 8)
    for out in (gen, rec):
        assert bool(torch.isfinite(out).all())
        assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    gen2, rec2 = run(3)
    assert torch.equal(gen, gen2) and torch.equal(rec, rec2)
    gen3, rec3 = run(4)
    assert not torch.equal(gen, gen3) and not torch.equal(rec, rec3)


@pytest.mark.parametrize("model", ["s6:wrapped", "s6", "p2:vmf,e2"])
def test_cli_trains_and_generates_the_spherical_family(model, capsys,
                                                       tmp_path):
    """``--device cpu --generate 4`` trains one epoch with learnable
    curvature, evaluates and writes ``samples.npz``."""
    result = cli.main(["--dataset", "bdp", "--model", model,
                       "--fixed_curvature", "false", "--epochs", "1",
                       "--h_dim", "16", "--generate", "4", "--device", "cpu",
                       "--likelihood_n", "4", "--ll_max_examples", "16",
                       "--run_dir", str(tmp_path)])
    assert np.isfinite(result["test/log_likelihood_iwae"])
    assert np.isfinite(result["history"][-1]["test/elbo"])
    assert result["fused_paths"]["train_tail"]["active"] == (
        model == "s6:wrapped")
    out = capsys.readouterr().out
    assert "samples.npz" in out
    with np.load(tmp_path / "samples.npz") as f:
        gen, orig, rec = f["generated"], f["originals"], f["reconstructions"]
    assert gen.shape == orig.shape == rec.shape and len(gen) == 4
    assert set(np.unique(orig)) <= {0.0, 1.0}        # the binarized inputs
    for a in (gen, rec):
        assert np.isfinite(a).all() and a.min() >= 0.0 and a.max() <= 1.0
    # the file is a function of the checkpoint and the seed alone
    first = gen.copy()
    cli.main(["--dataset", "bdp", "--model", model, "--fixed_curvature",
              "false", "--h_dim", "16", "--generate", "4", "--device", "cpu",
              "--likelihood_n", "4", "--ll_max_examples", "16", "--run_dir",
              str(tmp_path), "--eval_only"])
    with np.load(tmp_path / "samples.npz") as f:
        assert np.array_equal(f["generated"], first)
