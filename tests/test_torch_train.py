"""The port's training path against the JAX package's Trainer, and its
burn-in, guard, checkpoint, metrics and CLI behaviour, on the CPU.

One epoch of both trainers from the same initial weights
(``params_from_jax``), the same batch order, the same binarization
uniforms and the same reparameterization noise (the JAX Trainer's
threefry stream, mirrored by ``tests/parity/torch_trainer.epoch_noise``
and fed through ``Trainer._train_step``) must land on the same weights
within the budget of ``tests/parity/test_training_parity.py``: a maximum
relative parameter delta of 5e-4 (float32 Adam in two frameworks over a
few steps, and the port's tile log p against the JAX jnp path's log-map
round trip, both float32 evaluations of one quantity). The spherical
family runs the same way: wrapped-on-s through the sphere tile's plain
version and its autograd backward, the vMF beyond s2 through the rejection
cosine on the proposals the JAX Trainer drew, implicit gradient included.
"""
import json

import jax
import numpy as np
import pytest
import torch

from mvae_torch import cli
from mvae_torch.components import parse_components
from mvae_torch.convert import params_from_jax
from mvae_torch.data import ArrayDataset
from mvae_torch.models import route as troute
from mvae_torch.models import vae as tvae
from mvae_torch.train import NonFiniteError, TrainConfig, Trainer
from mvae_torch.train.trainer import _leaves

D, N_TRAIN, BS = 24, 32, 8


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(N_TRAIN, D)) > 0.5).astype(np.float32) * 0.8


def _port_noise(kinds, comp_noise):
    """epoch_noise's per-component draws in the port's (B, E) layout: the
    tangent normals, led by the cosine's uniform for the vMF and, for its
    rejection cosine (dim != 2), followed by the proposals (Beta variates,
    acceptance uniforms); the leading uniform is then not read."""
    cols = []
    for (_, dim, posterior), nz in zip(kinds, comp_noise):
        if posterior == "vmf" and dim != 2:
            cols += [nz["u"][:, :1], nz["g"], nz["eps_beta"], nz["u"]]
        elif posterior == "vmf":
            cols += [nz["u"][:, None], nz["g"]]
        else:
            cols.append(nz["eps"])
    return torch.from_numpy(np.concatenate(cols, axis=1).astype(np.float32))


def _max_rel_delta(jax_params, torch_params):
    import jax
    out = 0.0
    for a, b in zip(jax.tree.leaves(jax_params), _leaves(torch_params)):
        a = np.asarray(a, np.float64)
        b = b.detach().numpy().astype(np.float64)
        out = max(out, float(np.max(np.abs(a - b) / (np.abs(b) + 1e-3))))
    return out


@pytest.mark.parametrize("spec,fixed,burnin", [("e2", True, 0),
                                               ("h2", False, 1),
                                               ("h2,s2,e2", False, 0),
                                               ("d2,p2,e2", False, 0),
                                               ("u6", False, 0),
                                               ("p6", False, 1),
                                               ("s6:wrapped", False, 0),
                                               ("s3:wrapped,h2,e2", False, 0),
                                               ("s6", False, 0),
                                               ("p2:vmf,e2", False, 0)])
def test_one_epoch_matches_jax_trainer(tmp_path, spec, fixed, burnin):
    import jax
    from mvae_tpu.components import parse_components as j_parse
    from mvae_tpu.data.base import ArrayDataset as JArrayDataset
    from mvae_tpu.models import vae as jvae
    from mvae_tpu.train.trainer import TrainConfig as JTrainConfig
    from mvae_tpu.train.trainer import Trainer as JTrainer
    from tests.parity.torch_trainer import epoch_noise

    train = _data()
    jcomps = j_parse(spec, fixed_curvature=fixed)
    jtr = JTrainer(jvae.VAEConfig(jcomps, (D,), h_dim=16),
                   JArrayDataset("tiny", train, train[:8], (D,), True),
                   JTrainConfig(epochs=1, batch_size=BS, burnin_epochs=burnin,
                                seed=3, train_rng="threefry",
                                eval_batch_size=8),
                   run_dir=str(tmp_path / "jax"))
    tr = Trainer(tvae.VAEConfig(parse_components(spec, fixed_curvature=fixed),
                                (D,), h_dim=16),
                 ArrayDataset("tiny", train, train[:8], (D,), True),
                 TrainConfig(epochs=1, batch_size=BS, burnin_epochs=burnin,
                             seed=3, eval_batch_size=8),
                 run_dir=str(tmp_path / "port"), device="cpu")
    with torch.no_grad():
        for leaf, value in zip(_leaves(tr.params), _leaves(params_from_jax(
                jax.tree.map(np.asarray, jtr.params)))):
            leaf.copy_(value)

    # the JAX Trainer's key after init, then one epoch of its stream
    key, _ = jax.random.split(jax.random.key(3))
    kinds = [(c.manifold.kind, c.dim, c.posterior) for c in jcomps]
    _, perm, noises = epoch_noise(key, kinds, 0, jtr.steps_per_epoch, BS,
                                  (D,), N_TRAIN)
    jtr.train_one_epoch(0)
    xs = torch.from_numpy(train)
    for s, nz in enumerate(noises):
        idx = torch.from_numpy(perm[s * BS:(s + 1) * BS].astype(np.int64))
        tr._train_step(xs[idx], torch.from_numpy(nz["u_bin"].copy()),
                       _port_noise(kinds, nz["comps"]))
    assert tr.step == jtr.steps_per_epoch == int(jtr.step)
    delta = _max_rel_delta(jtr.params, tr.params)
    assert delta < 5e-4, f"params diverged after one epoch: {delta}"


def _epoch_noise64(key, kinds, steps, bs, n_train):
    """``epoch_noise`` of a float64 JAX Trainer (its draws take the data's
    dtype) for products of normal / wrapped / Riemannian components, with
    all 128 rounds of each Riemannian radius: (perm, per-step u_bin and
    the port's (B, E) noise)."""
    from tests.test_torch_riemannian import jax_noise
    f64 = np.float64
    _, k_perm, k_epoch = jax.random.split(key, 3)
    perm = np.asarray(jax.random.permutation(k_perm, n_train)[:steps * bs])
    out = []
    for s in range(steps):
        k_bin, k_model = jax.random.split(jax.random.fold_in(k_epoch, s))
        u_bin = np.asarray(jax.random.uniform(k_bin, (bs, D), dtype=f64))
        cols = [jax_noise(ck, dim, bs, f64) if posterior == "riemannian"
                else np.asarray(jax.random.normal(ck, (bs, dim), f64))
                for (_, dim, posterior), ck in zip(
                    kinds, jax.random.split(k_model, len(kinds)))]
        out.append((u_bin, np.concatenate(cols, axis=1)))
    return perm, out


@pytest.mark.parametrize("spec,fixed", [("d6:riemannian", False),
                                        ("h2:riemannian,e2", True)])
def test_one_epoch_riemannian_matches_jax_trainer(tmp_path, spec, fixed):
    """The Riemannian normal beside the JAX Trainer, in float64: in
    float32 both packages' gradients of this posterior (its quadrature
    log-partition and implicit radius gradient) lie far from their
    float64 value, and Adam's normalized step turns that into sign flips
    of near-zero weights within an epoch, in either package."""
    from mvae_tpu.components import parse_components as j_parse
    from mvae_tpu.data.base import ArrayDataset as JArrayDataset
    from mvae_tpu.models import vae as jvae
    from mvae_tpu.train.trainer import TrainConfig as JTrainConfig
    from mvae_tpu.train.trainer import Trainer as JTrainer

    train = _data().astype(np.float64)
    jcomps = j_parse(spec, fixed_curvature=fixed)
    jtr = JTrainer(jvae.VAEConfig(jcomps, (D,), h_dim=16),
                   JArrayDataset("tiny", train, train[:8], (D,), True),
                   JTrainConfig(epochs=1, batch_size=BS, burnin_epochs=0,
                                seed=3, train_rng="threefry",
                                eval_batch_size=8, dtype="float64"),
                   run_dir=str(tmp_path / "jax"))
    tr = Trainer(tvae.VAEConfig(parse_components(spec, fixed_curvature=fixed),
                                (D,), h_dim=16),
                 ArrayDataset("tiny", train, train[:8], (D,), True),
                 TrainConfig(epochs=1, batch_size=BS, burnin_epochs=0,
                             seed=3, eval_batch_size=8, dtype="float64"),
                 run_dir=str(tmp_path / "port"), device="cpu")
    with torch.no_grad():
        for leaf, value in zip(_leaves(tr.params), _leaves(params_from_jax(
                jax.tree.map(np.asarray, jtr.params)))):
            leaf.copy_(value)
    key, _ = jax.random.split(jax.random.key(3))
    kinds = [(c.manifold.kind, c.dim, c.posterior) for c in jcomps]
    perm, noises = _epoch_noise64(key, kinds, jtr.steps_per_epoch, BS,
                                  N_TRAIN)
    jtr.train_one_epoch(0)
    xs = torch.from_numpy(train)
    for s, (u_bin, noise) in enumerate(noises):
        idx = torch.from_numpy(perm[s * BS:(s + 1) * BS].astype(np.int64))
        tr._train_step(xs[idx], torch.from_numpy(u_bin.copy()),
                       torch.from_numpy(noise))
    assert tr.step == jtr.steps_per_epoch == int(jtr.step)
    delta = _max_rel_delta(jtr.params, tr.params)
    assert delta < 5e-4, f"params diverged after one epoch: {delta}"


def test_one_epoch_conv_matches_jax_trainer(tmp_path):
    """The conv VAE (a u4 with learnable curvature on a tiny 8x8x3
    dataset of intensities, not binarized, as CIFAR) beside the JAX
    Trainer with ``arch="conv"``, as above."""
    import jax
    from mvae_tpu.components import parse_components as j_parse
    from mvae_tpu.data.base import ArrayDataset as JArrayDataset
    from mvae_tpu.models import vae as jvae
    from mvae_tpu.train.trainer import TrainConfig as JTrainConfig
    from mvae_tpu.train.trainer import Trainer as JTrainer
    from tests.parity.torch_trainer import epoch_noise

    shape = (8, 8, 3)
    train = np.random.default_rng(1).random((N_TRAIN,) + shape).astype(
        np.float32)
    jcomps = j_parse("u4", fixed_curvature=False)
    jtr = JTrainer(jvae.VAEConfig(jcomps, shape, arch="conv", h_dim=16),
                   JArrayDataset("tiny", train, train[:8], shape, False),
                   JTrainConfig(epochs=1, batch_size=BS, burnin_epochs=0,
                                seed=3, train_rng="threefry",
                                eval_batch_size=8),
                   run_dir=str(tmp_path / "jax"))
    tr = Trainer(tvae.VAEConfig(parse_components("u4", fixed_curvature=False),
                                shape, arch="conv", h_dim=16),
                 ArrayDataset("tiny", train, train[:8], shape, False),
                 TrainConfig(epochs=1, batch_size=BS, burnin_epochs=0,
                             seed=3, eval_batch_size=8),
                 run_dir=str(tmp_path / "port"), device="cpu")
    with torch.no_grad():
        for leaf, value in zip(_leaves(tr.params), _leaves(params_from_jax(
                jax.tree.map(np.asarray, jtr.params)))):
            leaf.copy_(value)
    key, _ = jax.random.split(jax.random.key(3))
    kinds = [(c.manifold.kind, c.dim, c.posterior) for c in jcomps]
    _, perm, noises = epoch_noise(key, kinds, 0, jtr.steps_per_epoch, BS,
                                  shape, N_TRAIN)
    jtr.train_one_epoch(0)
    xs = torch.from_numpy(train)
    for s, nz in enumerate(noises):
        idx = torch.from_numpy(perm[s * BS:(s + 1) * BS].astype(np.int64))
        tr._train_step(xs[idx], torch.from_numpy(nz["u_bin"].copy()),
                       _port_noise(kinds, nz["comps"]))
    assert tr.step == jtr.steps_per_epoch == int(jtr.step)
    delta = _max_rel_delta(jtr.params, tr.params)
    assert delta < 5e-4, f"params diverged after one epoch: {delta}"


def _toy(n_train=64):
    rng = np.random.default_rng(4)
    base = rng.random((4, D)) < 0.5
    train = base[rng.integers(0, 4, n_train)] * 0.9 + 0.05
    return ArrayDataset("toy", train.astype(np.float32),
                        train[:16].astype(np.float32), (D,), True)


def _trainer(run_dir, spec="h2,s2,e2", fixed=False, **tc):
    cfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=fixed), (D,),
                         h_dim=16)
    tc = {"batch_size": 16, "eval_batch_size": 16, "likelihood_n": 4,
          "burnin_epochs": 0, "seed": 1, **tc}
    return Trainer(cfg, _toy(), TrainConfig(**tc), run_dir=str(run_dir),
                   device="cpu")


def _curvature(tr):
    return [cp["c_param"].detach().clone() for cp in tr.params["components"]
            if "c_param" in cp]


def test_burnin_freezes_curvature_then_releases(tmp_path):
    tr = _trainer(tmp_path, burnin_epochs=1)
    c0 = _curvature(tr)
    tr.train_one_epoch(0)
    assert all(torch.equal(a, b) for a, b in zip(_curvature(tr), c0))
    tr.train_one_epoch(1)
    assert all(not torch.equal(a, b) for a, b in zip(_curvature(tr), c0))
    # Adam counted every step of the curvature group, burn-in included
    c = tr.params["components"][0]["c_param"]
    assert int(tr.opt.state[c]["step"]) == tr.step


def test_fixed_curvature_never_moves(tmp_path):
    tr = _trainer(tmp_path, fixed=True)
    c0 = _curvature(tr)
    tr.train_one_epoch(0)
    tr.train_one_epoch(1)
    assert all(torch.equal(a, b) for a, b in zip(_curvature(tr), c0))


@pytest.mark.parametrize("spec", ["d2,p2,e2", "u6"])
def test_stereographic_curvature_gets_the_curvature_group(tmp_path, spec):
    """The curvature leaves of d/p/u (for 'u', K itself) train in the
    ``curvature_lr`` group, frozen through burn-in and moving after."""
    tr = _trainer(tmp_path, spec=spec, burnin_epochs=1, curvature_lr=3e-3)
    c0 = _curvature(tr)
    group = tr.opt.param_groups[-1]
    assert group["lr"] == 3e-3 and len(group["params"]) == len(c0)
    tr.train_one_epoch(0)
    assert all(torch.equal(a, b) for a, b in zip(_curvature(tr), c0))
    tr.train_one_epoch(1)
    assert all(not torch.equal(a, b) for a, b in zip(_curvature(tr), c0))
    assert all(bool(torch.isfinite(t).all()) for t in _leaves(tr.params))


def test_universal_curvature_crosses_zero_in_training(tmp_path):
    """Two u3 runs started at K = +1e-3 and K = -1e-3 with a curvature
    step of 1e-3: every statistic stays finite on both sides of K = 0 and
    through it (the run the gradient pushes toward 0 crosses)."""
    crossed = 0
    for name, k0 in (("pos", 1e-3), ("neg", -1e-3)):
        tr = _trainer(tmp_path / name, spec="u3", init_k=k0,
                      curvature_lr=1e-3)
        assert float(_curvature(tr)[0]) == pytest.approx(k0)
        for epoch in range(2):
            stats = tr.train_one_epoch(epoch)
            assert all(np.isfinite(v) for v in stats.values()), stats
        k1 = float(_curvature(tr)[0])
        assert np.isfinite(tr.evaluate_log_likelihood("test"))
        crossed += (k1 > 0) != (k0 > 0)
    assert crossed >= 1


def test_loss_falls_over_five_epochs(tmp_path):
    tr = _trainer(tmp_path, epochs=5)
    elbos = [tr.train_one_epoch(e)["elbo"] for e in range(5)]
    assert all(np.isfinite(elbos))
    assert elbos[-1] > elbos[0] + 1.0, elbos


def test_resume_is_exact(tmp_path):
    """Two epochs straight equal one epoch, a checkpoint, a fresh Trainer
    restored from it, and one more epoch: bit for bit on the CPU."""
    straight = _trainer(tmp_path / "a")
    for e in range(2):
        straight.train_one_epoch(e)
    first = _trainer(tmp_path / "b")
    first.train_one_epoch(0)
    first.save_checkpoint()
    resumed = _trainer(tmp_path / "b")
    resumed.restore_checkpoint()
    assert resumed.step == first.step
    resumed.train_one_epoch(1)
    assert resumed.step == straight.step
    for a, b in zip(_leaves(straight.params), _leaves(resumed.params)):
        assert torch.equal(a, b)
    sa, sb = straight.opt.state_dict(), resumed.opt.state_dict()
    for k in sa["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])
    assert torch.equal(straight.generator.get_state(),
                       resumed.generator.get_state())


def test_nonfinite_guard_halts_and_checkpoints(tmp_path):
    tr = _trainer(tmp_path, epochs=5)
    tr.train_one_epoch(0)  # a healthy epoch first
    with torch.no_grad():
        tr.params["encoder"]["layers"][0]["w"][0, 0] = float("nan")
    with pytest.raises(NonFiniteError) as exc_info:
        tr.fit(verbose=False)
    assert exc_info.value.epoch == 0
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    fail = [r for r in recs if r.get("status") == "FAILED_NONFINITE"]
    assert fail and fail[-1]["nonfinite_epoch"] == 0
    assert (tmp_path / "ckpt").exists()
    # rewound to the last finite state, which the checkpoint holds
    assert exc_info.value.last_finite_step == tr.step


def test_fit_writes_metrics_jsonl(tmp_path):
    tr = _trainer(tmp_path, epochs=2)
    result = tr.fit(verbose=False, ll_repeats=2)
    assert np.isfinite(result["test/log_likelihood_iwae"])
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["epoch"] for r in recs if "epoch" in r] == [0, 1]
    assert all(np.isfinite(r["train/elbo"]) and np.isfinite(r["test/elbo"])
               for r in recs if "epoch" in r)
    assert recs[-1]["train_steps_per_sec"] > 0
    assert any("test/log_likelihood_iwae_repeats" in r for r in recs)


def test_cli_trains_resumes_and_evaluates(tmp_path, capsys):
    run = str(tmp_path / "run")
    common = ["--dataset", "bdp", "--model", "h2,s2,e2", "--h_dim", "16",
              "--likelihood_n", "4", "--ll_max_examples", "16", "--device",
              "cpu", "--run_dir", run, "--fixed_curvature", "false"]
    first = cli.main(common + ["--epochs", "1", "--burnin", "0"])
    summary = json.loads((tmp_path / "run" / "result.json").read_text())
    assert summary["test/log_likelihood_iwae"] == \
        first["test/log_likelihood_iwae"]
    assert summary["fused_paths"]["train_tail"]["active"]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(printed["fused_paths"]["iwae_reparam"]) == 3
    resumed = cli.main(common + ["--epochs", "1", "--resume"])
    assert "resumed at step" in capsys.readouterr().out
    # the rates count the steps of this run (one epoch), not the resumed
    # total of two epochs
    for result in (first, resumed):
        steps = result["train_steps_per_sec"] * result["train_wall_seconds"]
        assert steps == pytest.approx(summary["train_steps_per_sec"]
                                      * summary["train_wall_seconds"])
    ev = cli.main(common + ["--eval_only"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["eval_only"] and line["step"] == ev["step"] > 0
    assert np.isfinite(line["test/elbo"])
    assert np.isfinite(line["test/log_likelihood_iwae"])


def test_fused_train_decoder_path_matches_plain(monkeypatch):
    """With the switch on, the training forward takes train_decode_bce (on
    the CPU its plain version through the Function): the same loss and
    gradients as the plain decode, to float32 rounding."""
    cfg = tvae.VAEConfig(parse_components("h2,s2,e2"), (D,), h_dim=16)
    params = tvae.init_params(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy((_data() > 0.5).astype(np.float32))
    noise = tvae.tail_kernels.draw_noise(cfg.components, (N_TRAIN,), x,
                                         torch.Generator().manual_seed(1))

    def run():
        p = tvae._tree_map(lambda t: t.detach().clone().requires_grad_(),
                           params)
        leaves = _leaves(p)
        loss, _ = tvae.loss_fn(cfg, p, x, noise=noise)
        loss.backward()
        return loss.detach(), [t.grad for t in leaves]

    monkeypatch.setenv("MVAE_FUSED_TRAIN_DECODER", "0")
    loss0, g0 = run()
    monkeypatch.setenv("MVAE_FUSED_TRAIN_DECODER", "1")
    assert troute.route(cfg, params).train_decoder
    loss1, g1 = run()
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=1e-5)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
