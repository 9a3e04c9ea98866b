"""The system under test: ``mvae_torch``'s ``Trainer`` and the programs it
replays on the card, driven with the benchmark's own inputs.

* ``Train``: ``graphs.TrainEpoch``, the CUDA graph of one training step
  (binarize, encoder, fused heads, the tail kernels, the training decode,
  the backward, the curvature mask, Adam) replayed once a step over the
  epoch's batch order, with the binarization uniforms and the noise handed
  in, then the epoch's statistics read once (``Trainer._epoch_means``):
  ``Trainer.train_one_epoch`` with its draws given.
* ``Iwae``: the IWAE pass of ``Trainer.evaluate_log_likelihood``: one CUDA
  graph of an eval batch (``graphs.Graphed`` over ``vae.log_likelihood``
  of the pinned binarization, the whole chunk loop inside) replayed over
  the test split's batches, with the importance noise handed in.
* ``reset``: the trainer's state back to given weights in place (the
  parameters, Adam's moments and step counts, the step counters), so a
  captured step graph goes on updating the same tensors.
* ``FirstSteps``: the parameters and Adam's first moments as the
  optimizer leaves them after its first steps of an epoch: read after the
  step graph's first replays, or on the eager path after Adam's first
  steps (a hook that only reads).

On the CPU the same bodies run eagerly (the trainer's own choice,
``Trainer.graph_path``).
"""
from __future__ import annotations

import torch

from mvae_torch.components import parse_components
from mvae_torch.data.base import ArrayDataset
from mvae_torch.kernels import (_build, decoder_kernels, manifold_kernels,
                                tail_kernels)
from mvae_torch.models import vae
from mvae_torch.train import graphs
from mvae_torch.train.trainer import TrainConfig, Trainer

COUNTERS = {"tail_forward": tail_kernels.tail_forward,
            "tail_backward": tail_kernels.tail_backward,
            "train_decode_bce": decoder_kernels.train_decode_bce,
            "fused_decode_bce_t": decoder_kernels.fused_decode_bce_t,
            "wrapped_reparam_stereo_t":
                manifold_kernels.wrapped_reparam_stereo_t}


# the kernel library (``kernels/csrc/<name>.cu``) each counted wrapper
# launches
LIBRARIES = {"tail_forward": "tail_fwd", "tail_backward": "tail_bwd",
             "train_decode_bce": "train_decode",
             "fused_decode_bce_t": "decode_bce",
             "wrapped_reparam_stereo_t": "reparam_stereo"}


def load_kernels(wrappers) -> list:
    """Load the libraries of the given counted wrappers, each compiled
    first where the build cache (``mvae_torch/_build``) has none; returns
    the names of those compiled."""
    compiled = []
    for name in sorted({LIBRARIES[w] for w in wrappers}):
        if not _build.library_path(name).exists():
            compiled.append(name)
        _build.load(name)
    return compiled


def launches() -> dict:
    """Each counted kernel wrapper's launches so far (graph replays
    included)."""
    return {k: f.launches for k, f in COUNTERS.items()}


def flatten(tree, prefix: str = "") -> dict:
    """Name -> tensor of a parameter tree (``"decoder.out.w"``)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(flatten(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def build(cfg: dict, traffic: dict, seed: int, train, test, device,
          run_dir: str) -> Trainer:
    """A ``Trainer`` of the configuration on the given splits (device
    tensors)."""
    comps = parse_components(cfg["spec"],
                             fixed_curvature=cfg["fixed_curvature"])
    data_shape = tuple(cfg["data_shape"])
    mcfg = vae.VAEConfig(comps, data_shape, cfg["arch"],
                         h_dim=cfg["h_dim"],
                         encoder_depth=cfg["encoder_depth"],
                         decoder_depth=cfg["decoder_depth"])
    ds = ArrayDataset(cfg["name"], train, test, data_shape, cfg["binarize"],
                      synthetic=True)
    tc = TrainConfig(epochs=1, batch_size=traffic.get("batch_size", 128),
                     lr=cfg["lr"], curvature_lr=cfg["curvature_lr"],
                     burnin_epochs=cfg["burnin_epochs"], beta=cfg["beta"],
                     seed=seed,
                     likelihood_n=traffic.get("samples", cfg["likelihood_n"]),
                     eval_batch_size=cfg["eval_batch_size"],
                     eval_binarize=cfg["eval_binarize"], dtype=cfg["dtype"],
                     init_k=cfg["init_k"])
    return Trainer(mcfg, ds, tc, run_dir=run_dir, device=device)


@torch.no_grad()
def load_weights(trainer: Trainer, weights: dict) -> None:
    """The benchmark's weights into the trainer's parameters, in place."""
    for name, t in flatten(trainer.params).items():
        t.copy_(weights[name])


def graphed(trainer: Trainer) -> bool:
    return trainer.graph_path["path"] == "graph"


class Train:
    """``Trainer.train_one_epoch`` with its draws handed in."""

    def __init__(self, trainer: Trainer):
        self.trainer = trainer
        self.epoch = graphs.TrainEpoch(trainer)
        self.graph = graphed(trainer)
        self.steps = trainer.steps_per_epoch

    def run(self, perm, u_bin, noise) -> dict:
        """One epoch; returns the (steps, ...) statistics buffers. Without
        binarization uniforms (a configuration that does not binarize) the
        epoch gets an (S, B) placeholder: ``TrainEpoch`` takes given noise
        only beside them, and a step that does not binarize never reads
        them."""
        if u_bin is None:
            u_bin = torch.zeros(perm.shape, device=perm.device)
        stats = self.epoch.run(perm, u_bin, noise, graph=self.graph)
        self.trainer.step += self.steps
        return stats

    def means(self, stats: dict) -> dict:
        """The epoch's means, read to the host (the epoch's one sync)."""
        return self.trainer._epoch_means(stats)


@torch.no_grad()
def reset(trainer: Trainer, weights: dict) -> None:
    """The trainer's state as a fresh one's with ``weights``, in place:
    the parameters, Adam's moments and step counts zeroed, the device and
    host step counters at 0."""
    load_weights(trainer, weights)
    for state in trainer.opt.state.values():
        for t in state.values():
            if torch.is_tensor(t):
                t.zero_()
            else:
                raise TypeError("an Adam state entry is no tensor")
    trainer._step_t.zero_()
    trainer.step = 0


def step_graph(trainer: Trainer):
    """The captured graph of the trainer's training step."""
    progs = [p for k, p in trainer._programs.items() if k[0] == "train_step"]
    if len(progs) != 1 or progs[0].graph is None:
        raise RuntimeError(f"{len(progs)} training step programs, "
                           "none captured")
    return progs[0].graph


class FirstSteps:
    """What the optimizer holds after the first ``n`` steps from here: the
    first step's gradients as Adam took them (its first moment over
    1 - beta1) and the parameters after step ``n``. On the graph path the
    steps are replays of the captured step (read after each replay), else
    Adam's eager steps (read by a step hook). A missing moment reads
    NaN."""

    def __init__(self, trainer: Trainer, n: int = 3):
        self.opt = trainer.opt
        self.named = flatten(trainer.params)
        self.n, self.calls = n, 0
        self.grad = self.after = None
        self.graph = step_graph(trainer) if graphed(trainer) else None
        if self.graph is not None:
            replay = type(self.graph).replay.__get__(self.graph)

            def counted():
                replay()
                self._read()
            self.graph.replay = counted
        else:
            self.handle = self.opt.register_step_post_hook(
                lambda *_: self._read())

    def _read(self):
        self.calls += 1
        if self.calls == 1:
            b1 = self.opt.param_groups[0]["betas"][0]
            self.grad = {}
            for k, t in self.named.items():
                m = self.opt.state.get(t, {}).get("exp_avg")
                self.grad[k] = (torch.full_like(t, float("nan")) if m is None
                                else m.detach().clone() / (1.0 - b1))
        if self.calls == self.n:
            self.after = {k: t.detach().clone()
                          for k, t in self.named.items()}

    def close(self) -> None:
        if self.graph is not None:
            del self.graph.replay
        else:
            self.handle.remove()


class Iwae:
    """The trainer's IWAE pass over the test split with the importance
    noise handed in: the eval batch's graph, replayed batch by batch."""

    def __init__(self, trainer: Trainer):
        tr = self.trainer = trainer
        bs = min(tr.tc.eval_batch_size, len(tr._test_data))
        self.batches, _, self.n = tr._split_batches(tr._test_data, bs)
        self.nb = self.batches.shape[0]
        self.rows = tr._eval_keys(self.nb, bs)
        samples, chunk = tr.tc.likelihood_n, tr.tc.likelihood_chunk

        def body(x, rows, noise):
            return vae.log_likelihood(tr.model_cfg, tr.params,
                                      tr._binarize(x, rows), samples, chunk,
                                      noise=noise)

        self.body = body
        self.prog = None
        self.graph = graphed(tr)

    @torch.no_grad()
    def run(self, noise):
        """One pass: (n_test,) IWAE estimates, pad rows dropped."""
        if self.prog is None:
            self.prog = self.body
            if self.graph:
                self.prog = graphs.Graphed(
                    self.body, (torch.empty_like(self.batches[0]),
                                torch.empty_like(self.rows[0]),
                                torch.empty_like(noise[0])),
                    self.trainer.generator, graphs.WARMUP_BATCHES,
                    copy_out=True)
        lls = [self.prog(self.batches[i], self.rows[i], noise[i])
               for i in range(self.nb)]
        return torch.cat(lls)[:self.n]
