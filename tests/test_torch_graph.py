"""The trainer's compiled programs (``mvae_torch/train/graphs.py``) on the
CPU, where they run as the eager loop of the same bodies.

* The curvature mask the optimizer applies (``optim_kernels.masked_grad``
  at the kinds ``make_optimizer`` gives each leaf) on a device step counter
  equals the JAX package's traced ``_mask_curvature_grads`` on the same
  gradients, bit for bit (fixed, burn-in, after; an infinite gradient
  included: both multiply).
* Two epochs with ``burnin_epochs=1`` through ``graphs.TrainEpoch.step``,
  the body a CUDA graph captures (here run eagerly), land on the JAX
  ``Trainer``'s weights within 5e-4 (the budget of
  ``tests/test_torch_train.py``) on its threefry draws
  (``tests/parity/torch_trainer.epoch_noise``); the curvature is frozen in
  epoch 0 and moves in epoch 1.
* The same body on the trainer's own generator equals the eager epoch
  (``Trainer._train_one_epoch_eager``) bit for bit: the static-buffer
  gather, the device step counter and the statistics buffers change no
  arithmetic.
* The graph cache key follows ``MVAE_FUSED_TRAIN_DECODER`` and each kernel
  wrapper of ``kernels.launches.WRAPPERS``.
* A ``TorchFunctionMode`` finds no host read (``item``, ``tolist``,
  ``__bool__``, ...) and no host-to-device copy (``torch.tensor`` /
  ``torch.as_tensor`` of host data) in a training step or an eval batch of
  the flagship, ``s6``, ``d6:riemannian`` and a conv ``u6``, the
  optimizer's step included, after one warm-up call as the graphs take:
  any would break a capture on the card.
* On a card (``cuda`` marker; skipped here): N graphed steps equal N eager
  steps bit for bit.
"""
import dataclasses
import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from mvae_torch.components import parse_components
from mvae_torch.convert import params_from_jax
from mvae_torch.data import ArrayDataset
from mvae_torch.kernels import (decoder_kernels, launches, optim_kernels,
                                tail_kernels)
from mvae_torch.models import vae as tvae
from mvae_torch.train import TrainConfig, Trainer, graphs
from mvae_torch.train.trainer import _leaves
from mvae_torch.utils import profiling

D, N_TRAIN, BS = 24, 32, 8


def _data(seed=0, n=N_TRAIN, shape=(D,)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n,) + shape) > 0.5).astype(np.float32) * 0.8


def _trainer(tmp_path, spec, fixed=False, shape=(D,), arch="mlp", **tc):
    train = _data(shape=shape)
    cfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=fixed),
                         shape, arch, h_dim=16)
    return Trainer(cfg, ArrayDataset("tiny", train, train[:8], shape, True),
                   TrainConfig(**{"epochs": 1, "batch_size": BS, "seed": 3,
                                  "eval_batch_size": 8, **tc}),
                   run_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("fixed,step,burnin", [(True, 0, 4), (True, 9, 4),
                                               (False, 3, 4), (False, 4, 4),
                                               (False, 0, 0)])
def test_curvature_mask_matches_reference(tmp_path, fixed, step, burnin):
    import jax.numpy as jnp
    from mvae_tpu.components import parse_components as j_parse
    from mvae_tpu.train.trainer import _mask_curvature_grads as j_mask

    spec = "h2,s2,e2"
    tr = _trainer(tmp_path, spec, fixed)
    rng = np.random.default_rng(step)
    grads = []
    for cp in tr.params["components"]:
        g = {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
             for k, v in cp.items()}
        if "c_param" in g:
            g["c_param"] = np.float32(np.inf if len(grads) == 1 else
                                      rng.normal())
        grads.append(g)
    kinds = dict(zip((id(p) for g in tr.opt.param_groups
                      for p in g["params"]), tr.opt.kinds))
    unfrozen = torch.tensor(step) >= burnin
    for cp, g in zip(tr.params["components"], grads):
        for k, v in cp.items():
            v.grad = optim_kernels.masked_grad(
                v, torch.from_numpy(np.array(g[k])), kinds[id(v)], unfrozen)
    want = j_mask({"components": tuple({k: jnp.asarray(v) for k, v in
                                        g.items()} for g in grads)},
                  j_parse(spec, fixed_curvature=fixed), jnp.asarray(step),
                  burnin)
    for cp, wg in zip(tr.params["components"], want["components"]):
        for k, v in cp.items():
            np.testing.assert_array_equal(v.grad.numpy(), np.asarray(wg[k]))


@pytest.mark.parametrize("spec", ["h2,s2,e2", "d2,p2,e2"])
def test_two_epochs_of_graph_body_match_jax_trainer(tmp_path, spec):
    import jax
    from mvae_tpu.components import parse_components as j_parse
    from mvae_tpu.data.base import ArrayDataset as JArrayDataset
    from mvae_tpu.models import vae as jvae
    from mvae_tpu.train.trainer import TrainConfig as JTrainConfig
    from mvae_tpu.train.trainer import Trainer as JTrainer
    from tests.parity.torch_trainer import epoch_noise
    from tests.test_torch_train import _max_rel_delta, _port_noise

    train = _data()
    jcomps = j_parse(spec, fixed_curvature=False)
    jtr = JTrainer(jvae.VAEConfig(jcomps, (D,), h_dim=16),
                   JArrayDataset("tiny", train, train[:8], (D,), True),
                   JTrainConfig(epochs=2, batch_size=BS, burnin_epochs=1,
                                seed=3, train_rng="threefry",
                                eval_batch_size=8),
                   run_dir=str(tmp_path / "jax"))
    tr = _trainer(tmp_path / "port", spec, epochs=2, burnin_epochs=1)
    with torch.no_grad():
        for leaf, value in zip(_leaves(tr.params), _leaves(params_from_jax(
                jax.tree.map(np.asarray, jtr.params)))):
            leaf.copy_(value)
    c0 = [cp["c_param"].detach().clone() for cp in tr.params["components"]
          if "c_param" in cp]

    key, _ = jax.random.split(jax.random.key(3))
    kinds = [(c.manifold.kind, c.dim, c.posterior) for c in jcomps]
    body = graphs.TrainEpoch(tr)
    S = tr.steps_per_epoch
    for epoch in range(2):
        key, perm, noises = epoch_noise(key, kinds, epoch * S, S, BS, (D,),
                                        N_TRAIN)
        jtr.train_one_epoch(epoch)
        u_bin = torch.stack([torch.from_numpy(nz["u_bin"].copy())
                             for nz in noises])
        noise = torch.stack([_port_noise(kinds, nz["comps"])
                             for nz in noises])
        stats = body.run(torch.from_numpy(perm.astype(np.int64)), u_bin,
                         noise, graph=False)
        tr.step += S
        c = [cp["c_param"].detach() for cp in tr.params["components"]
             if "c_param" in cp]
        moved = [not torch.equal(a, b) for a, b in zip(c0, c)]
        assert all(moved) if epoch else not any(moved), (epoch, moved)
        if epoch == 0:      # the snapshot of the frozen curvature
            assert torch.equal(stats["curvature"][-1], torch.stack(
                [comp.curvature(cp) for comp, cp in zip(
                    tr.model_cfg.components, tr.params["components"])]))
    assert tr.step == int(jtr.step) == 2 * S
    assert int(tr._step_t) == tr.step
    delta = _max_rel_delta(jtr.params, tr.params)
    assert delta < 5e-4, f"params diverged after two epochs: {delta}"


@pytest.mark.parametrize("spec", ["h2,s2,e2", "s6"])
def test_graph_body_equals_eager_epoch(tmp_path, spec):
    a = _trainer(tmp_path / "a", spec, burnin_epochs=1)
    b = _trainer(tmp_path / "b", spec, burnin_epochs=1)
    body = graphs.TrainEpoch(b)
    for epoch in range(2):
        got = a._train_one_epoch_eager(epoch)
        stats = body.run(b._epoch_perm(), graph=False)
        b.step += b.steps_per_epoch
        assert got == b._epoch_means(stats)
    for x, y in zip(_leaves(a.params), _leaves(b.params)):
        assert torch.equal(x, y)
    assert a.step == b.step == int(b._step_t)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_graph_key_follows_routing(tmp_path, monkeypatch):
    tr = _trainer(tmp_path, "h2,s2,e2")
    cfg, params = tr.model_cfg, tr.params
    monkeypatch.setenv("MVAE_FUSED_TRAIN_DECODER", "1")
    on = graphs.routing_key(cfg, params)
    assert graphs.routing_key(cfg, params) == on
    monkeypatch.setenv("MVAE_FUSED_TRAIN_DECODER", "0")
    off = graphs.routing_key(cfg, params)
    assert off != on
    monkeypatch.setattr(tail_kernels, "tail_forward",
                        tail_kernels.tail_forward_ref)
    assert graphs.routing_key(cfg, params) != off


# the plain version of each wrapper whose signature it shares
PLAIN = {"tail_forward": tail_kernels.tail_forward_ref,
         "tail_backward": tail_kernels.tail_backward_ref,
         "reparam_chunk_t": tail_kernels.reparam_chunk_plain,
         "fused_decode_bce_t": decoder_kernels.decode_bce_ref,
         "train_decode_fwd": decoder_kernels.train_decode_ref}


@pytest.mark.parametrize("mod,name", launches.WRAPPERS,
                         ids=[name for _, name in launches.WRAPPERS])
def test_graph_key_follows_each_wrapper(monkeypatch, mod, name):
    """Swapping any one kernel wrapper (for its plain version, or for
    another function where the signatures differ) changes the graph cache
    key, so a graph captured through the kernel is not replayed for it."""
    cfg = tvae.VAEConfig(parse_components("d2,p2,e2"), (D,), h_dim=16)
    params = tvae.init_params(cfg, generator=torch.Generator().manual_seed(0))
    before = graphs.routing_key(cfg, params)
    monkeypatch.setattr(mod, name, PLAIN.get(name, lambda *a, **kw: None))
    assert graphs.routing_key(cfg, params) != before


def test_path_reports_eager_with_reason(tmp_path):
    tr = _trainer(tmp_path, "h2,s2,e2")
    assert tr.graph_path["path"] == "eager"
    assert "CUDA devices only" in tr.graph_path["why"]


def test_state_load_keeps_optimizer_tensors(tmp_path):
    """A rewind copies Adam's state into the tensors a captured graph
    holds (and the device step counter follows the step)."""
    tr = _trainer(tmp_path, "h2,s2,e2", epochs=2)
    tr.train_one_epoch(0)
    saved = tr._guard_state()
    held = {id(t) for st in tr.opt.state.values() for t in st.values()}
    tr.train_one_epoch(1)
    tr._load_state(saved["params"], saved["opt_state"], saved["step"],
                   saved["rng"], saved["perm_rng"])
    assert {id(t) for st in tr.opt.state.values() for t in st.values()} \
        == held
    assert int(tr._step_t) == tr.step == saved["step"]
    for p, i in zip([p for g in tr.opt.param_groups for p in g["params"]],
                    range(len(held))):
        for name, v in tr.opt.state[p].items():
            assert torch.equal(v, saved["opt_state"]["state"][i][name])


class HostReads(TorchFunctionMode):
    """Records every host read of a tensor and every tensor made from host
    data."""

    READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__bool__,
             torch.Tensor.__float__, torch.Tensor.__int__,
             torch.Tensor.__index__, torch.Tensor.numpy, torch.Tensor.cpu}
    MAKES = {torch.tensor, torch.as_tensor, torch.from_numpy}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.READS or (func in self.MAKES and args
                                  and not torch.is_tensor(args[0])):
            frames = traceback.extract_stack()
            self.seen.append(f"{getattr(func, '__name__', func)} at "
                             f"{frames[-2].filename}:{frames[-2].lineno}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("spec,shape,arch", [
    ("h2,s2,e2", (D,), "mlp"), ("s6", (D,), "mlp"),
    ("d6:riemannian", (D,), "mlp"), ("u6", (8, 8, 3), "conv")])
def test_no_host_reads_in_step_or_eval_batch(tmp_path, monkeypatch, spec,
                                             shape, arch):
    monkeypatch.setenv("MVAE_FUSED_TRAIN_DECODER", "1")
    tr = _trainer(tmp_path, spec, shape=shape, arch=arch, burnin_epochs=1)
    body = graphs.TrainEpoch(tr)
    x = tr._test_data[:BS]
    mask = torch.ones(BS)
    rows = torch.arange(BS)
    tr.tc = dataclasses.replace(tr.tc, likelihood_n=10, likelihood_chunk=5)

    def calls():
        body.step()
        with torch.no_grad():
            tr._elbo_batch(tr.params, x, mask, None)
            tr._elbo_batch(tr.params, x, mask, rows)
            tr._ll_batch(tr.params, x, None, None)

    body.perm.copy_(tr._epoch_perm().reshape(body.perm.shape))
    calls()                                   # the warm-up
    with HostReads() as mode:
        calls()
    assert mode.seen == [], f"{spec}: host reads {sorted(set(mode.seen))}"
    assert tr.opt.defaults["capturable"] is False     # the CPU's Adam


def test_nan_guard_takes_the_eager_path(tmp_path):
    tr = _trainer(tmp_path, "h2,s2,e2")
    tr.device = torch.device("cuda")          # as a CUDA trainer would see
    assert tr.graph_path["path"] == "graph"
    profiling.enable_nan_guard()
    try:
        assert tr.graph_path["path"] == "eager"
        assert "--debug_nans" in tr.graph_path["why"]
    finally:
        profiling.disable_nan_guard()


@pytest.mark.cuda
def test_graphed_steps_equal_eager_steps_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs exist only there")
    train = _data(n=64 * 20, shape=(784,))
    cfg = tvae.VAEConfig(parse_components("h2,s2,e2", fixed_curvature=False),
                         (784,), h_dim=400)
    ds = ArrayDataset("tiny", train, train[:512], (784,), True)
    tc = TrainConfig(epochs=2, batch_size=64, burnin_epochs=1, seed=3)
    eager = Trainer(cfg, ds, tc, str(tmp_path / "e"))
    graph = Trainer(cfg, ds, tc, str(tmp_path / "g"))
    assert graph.graph_path["path"] == "graph"
    for epoch in range(2):
        want = eager._train_one_epoch_eager(epoch)
        got = graph.train_one_epoch(epoch)
        assert got == want, epoch
    for a, b in zip(_leaves(eager.params), _leaves(graph.params)):
        assert torch.equal(a, b)
    captures = [p.captures for k, p in graph._programs.items()
                if k[0] == "train_step"]
    assert captures == [1]
