"""Training / evaluation loop (L5).

Counterpart of ``mvae_tpu/train/trainer.py``: a ``Trainer`` holds a
model's parameters on one device and trains it with Adam (a separate
learning rate for the curvature leaves ``c_param``, curvature frozen for
``burnin_epochs`` and always when fixed), evaluates the test ELBO after
every epoch and the IWAE-n marginal log-likelihood at the end, guards
against non-finite epochs, logs to ``<run_dir>/metrics.jsonl`` and
checkpoints the full state (params, optimizer, step, generator).

Differences from the reference:

* training and evaluation are Python loops over batches of eager
  PyTorch (no scan); the host reads the statistics once per epoch or
  pass, and a training step never waits on the device;
* randomness (batch order, binarization, reparameterization noise, eval
  draws) comes from one ``torch.Generator`` on the device (Philox on
  CUDA), seeded from ``TrainConfig.seed``; it replaces the reference's
  ``train_rng`` ("rbg"/"threefry") and ``TrainConfig`` has no field for
  it. The pinned binarization mode (``eval_binarize="fixed"``) is a
  counter hash of (seed, example index);
* the optimizer is ``torch.optim.Adam`` with optax's defaults (betas
  (0.9, 0.999), eps 1e-8). Masked curvature gradients are zeroed, never
  dropped, so Adam counts every step as optax does and the bias
  correction after burn-in uses the global step.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time

import numpy as np
import torch

from ..data.base import (ArrayDataset, binarize_batch, binarize_rows,
                         to_device_dataset)
from ..models import vae
from ..utils import profiling
from ..utils.device import resolve_device
from .metrics import MetricsLogger
from .stats import EpochStats

# seed offset of the pinned eval binarization (the reference's 0xB1A)
_FIXED_BINARIZE_SALT = 0xB1A


class NonFiniteError(RuntimeError):
    """Raised when an epoch's training stats go non-finite (NaN/inf).

    The guard halts at the first non-finite epoch boundary, restores and
    checkpoints the last finite state, and surfaces the offending epoch's
    stats for postmortem."""

    def __init__(self, epoch: int, stats: dict, last_finite_step: int):
        self.epoch = epoch
        self.stats = stats
        self.last_finite_step = last_finite_step
        bad = {k: v for k, v in stats.items()
               if np.ndim(v) == 0 and not np.isfinite(v)}
        super().__init__(
            f"non-finite training stats at epoch {epoch} "
            f"({', '.join(sorted(bad)) or 'n/a'}); last finite state at "
            f"step {last_finite_step} checkpointed")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 100
    batch_size: int = 128
    lr: float = 1e-3
    curvature_lr: float = 1e-4
    burnin_epochs: int = 10
    beta: float = 1.0
    seed: int = 42
    likelihood_n: int = 500
    likelihood_chunk: int = 20
    eval_batch_size: int = 512
    checkpoint_every: int = 0      # epochs; 0 = only at the end
    # "dynamic": fresh Bernoulli pixels per eval pass (reference protocol).
    # "fixed": one deterministic binarization per example (seeded by
    # `seed`), so repeated evals measure pure IWAE noise
    eval_binarize: str = "dynamic"
    dtype: str = "float32"
    init_k: float = 1.0            # initial |curvature| per component
    mesh_shape: tuple[int, int] | None = None


def _leaves(tree):
    """The tensors of a params tree, dict keys in sorted order (the
    reference's pytree order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _curvature_leaves(params):
    return [cp["c_param"] for cp in params["components"] if "c_param" in cp]


def make_optimizer(params, tc: TrainConfig) -> torch.optim.Adam:
    """One Adam over two parameter groups: the ``c_param`` leaves at
    ``curvature_lr``, everything else at ``lr`` (optax's defaults)."""
    curv = _curvature_leaves(params)
    ids = {id(t) for t in curv}
    groups = [{"params": [t for t in _leaves(params) if id(t) not in ids],
               "lr": tc.lr}]
    if curv:
        groups.append({"params": curv, "lr": tc.curvature_lr})
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def _mask_curvature_grads(params, components, step: int, burnin_steps: int):
    """Zero the curvature gradients when fixed or during burn-in, in place.
    Zeroed, not dropped: Adam then advances its step as optax does."""
    frozen = step < burnin_steps
    for comp, cp in zip(components, params["components"]):
        if "c_param" not in cp:
            continue
        if comp.fixed_curvature or frozen:
            c = cp["c_param"]
            if c.grad is None:
                c.grad = torch.zeros_like(c)
            else:
                c.grad.zero_()


class Trainer:
    """Orchestrates training and evaluation on a device-resident dataset."""

    def __init__(self, model_cfg: vae.VAEConfig, dataset: ArrayDataset,
                 tc: TrainConfig, run_dir: str = "runs/default",
                 device=None):
        if tc.mesh_shape is not None:
            raise NotImplementedError(
                "later slice: the device mesh (torch.distributed)")
        if tc.eval_binarize not in ("dynamic", "fixed"):
            raise ValueError(f"unknown eval_binarize {tc.eval_binarize!r}")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.dataset = dataset
        self.tc = tc
        self.run_dir = run_dir
        self.dtype = getattr(torch, tc.dtype)

        # weights from a CPU generator: one seed, the same model everywhere
        init_gen = torch.Generator().manual_seed(tc.seed)
        self.params = vae.init_params(model_cfg, tc.init_k, self.dtype,
                                      init_gen, self.device)
        for t in _leaves(self.params):
            t.requires_grad_(True)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tc.seed)
        self.opt = make_optimizer(self.params, tc)
        self.step = 0
        self.steps_per_epoch = len(dataset.train) // tc.batch_size
        self.burnin_steps = tc.burnin_epochs * self.steps_per_epoch

        self._train_data, self._test_data = to_device_dataset(
            dataset, self.device, self.dtype)
        self.component_names = [
            f"{c.name}#{i}" for i, c in enumerate(model_cfg.components)]
        self.history: list[dict] = []
        self._logger = None
        self.fused_paths = vae.fused_path_report(model_cfg, self.params)

    @property
    def logger(self) -> MetricsLogger:
        """``<run_dir>/metrics.jsonl``, opened at the first record."""
        if self._logger is None:
            self._logger = MetricsLogger(self.run_dir)
        return self._logger

    # --- training ---------------------------------------------------------------

    def _train_step(self, x, u_bin=None, noise=None) -> dict:
        """One Adam step on the batch ``x`` of intensities. ``u_bin`` (x's
        shape) are the binarization uniforms and ``noise`` (B, E) the
        reparameterization noise (``tail_kernels.draw_noise`` layout); each
        is drawn from the trainer's generator when not given. Returns the
        step's stats as device tensors (no host sync)."""
        x = binarize_batch(x, self.dataset.binarize, self.generator, u_bin)
        self.opt.zero_grad(set_to_none=True)
        loss, stats = vae.loss_fn(self.model_cfg, self.params, x,
                                  self.tc.beta, noise, self.generator)
        loss.backward()
        _mask_curvature_grads(self.params, self.model_cfg.components,
                              self.step, self.burnin_steps)
        self.opt.step()
        self.step += 1
        return {k: v.detach() for k, v in stats.items()}

    def train_one_epoch(self, epoch: int) -> dict:
        """``steps_per_epoch`` steps over a permutation of the train split
        drawn from the generator; stats averaged over the steps, the
        curvature the last step's snapshot."""
        bs = self.tc.batch_size
        n = self.steps_per_epoch * bs
        perm = torch.randperm(len(self._train_data), generator=self.generator,
                              device=self.device)[:n]
        seq = [self._train_step(self._train_data[perm[s * bs:(s + 1) * bs]])
               for s in range(self.steps_per_epoch)]
        stacked = {k: torch.stack([st[k] for st in seq]) for k in seq[0]}
        means = {k: torch.mean(v, dim=0) for k, v in stacked.items()}
        means["curvature"] = stacked["curvature"][-1]
        es = EpochStats(self.component_names)
        es.update({k: v.cpu().numpy() for k, v in means.items()})
        return es.means()

    def _guard_state(self) -> dict:
        """Device copy of the resumable state: the non-finite guard's
        last-finite snapshot (read back only if the guard trips)."""
        state = self.state()
        return {"params": [t.detach().clone() for t in _leaves(self.params)],
                "opt_state": copy.deepcopy(state["opt_state"]),
                "step": state["step"], "rng": state["rng"]}

    def _load_state(self, params_leaves, opt_state, step, rng) -> None:
        with torch.no_grad():
            for t, v in zip(_leaves(self.params), params_leaves):
                t.copy_(v)
        self.opt.load_state_dict(opt_state)
        self.step = int(step)
        self.generator.set_state(rng)

    def _check_finite(self, epoch: int, train_stats: dict,
                      prev_state: dict | None):
        """Halt on the first non-finite epoch: rewind to the last finite
        state, checkpoint it, log FAILED_NONFINITE and raise."""
        scalars = {k: v for k, v in train_stats.items() if np.ndim(v) == 0}
        if all(np.isfinite(v) for v in scalars.values()):
            return
        last_step = int(prev_state["step"]) if prev_state else -1
        if prev_state is not None:
            self._load_state(prev_state["params"], prev_state["opt_state"],
                             prev_state["step"], prev_state["rng"])
            self.save_checkpoint()
        self.logger.log(last_step, {
            "status": "FAILED_NONFINITE", "nonfinite_epoch": epoch,
            **{f"train/{k}": v for k, v in scalars.items()}})
        raise NonFiniteError(epoch, train_stats, last_step)

    def fit(self, verbose: bool = True, ll_max_examples: int | None = None,
            profile_epochs: int = 0, ll_repeats: int = 1) -> dict:
        """``tc.epochs`` epochs, each followed by the test ELBO; then the
        IWAE-n test log-likelihood and a final checkpoint. Records go to
        ``metrics.jsonl``; ``train_steps_per_sec`` counts the training
        epochs' wall time only (ended by a device sync). Both rates count
        the steps this call takes, not those of a run it resumed (the
        reference divides the global step count). With ``profile_epochs``
        N, the training of epochs 0 .. N-1 is traced into
        ``<run_dir>/profile`` (``utils.profiling.trace``)."""
        t0 = time.time()
        train_wall = 0.0
        step0 = self.step
        with contextlib.ExitStack() as tracing:
            for epoch in range(self.tc.epochs):
                if profile_epochs and epoch == 0:
                    tracing.enter_context(profiling.trace(
                        f"{self.run_dir}/profile", self.device))
                state_before = self._guard_state()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                te0 = time.time()
                train_stats = self.train_one_epoch(epoch)
                train_wall += time.time() - te0
                if epoch + 1 == profile_epochs:
                    tracing.close()
                self._check_finite(epoch, train_stats, state_before)
                rec = {f"train/{k}": v for k, v in train_stats.items()}
                test_stats = self.evaluate_elbo("test")
                rec.update({f"test/{k}": v for k, v in test_stats.items()})
                rec["epoch"] = epoch
                self.logger.log(self.step, rec)
                self.history.append(rec)
                if verbose:
                    print(f"epoch {epoch + 1}/{self.tc.epochs} "
                          f"train[{_fmt(train_stats)}] "
                          f"test[{_fmt(test_stats)}]")
                if (self.tc.checkpoint_every
                        and (epoch + 1) % self.tc.checkpoint_every == 0):
                    self.save_checkpoint()
        ll = self.evaluate_log_likelihood("test", max_examples=ll_max_examples,
                                          repeats=ll_repeats)
        wall = time.time() - t0
        # steps_per_sec is whole-run wall (train + per-epoch evals + final
        # IWAE); train_steps_per_sec excludes eval wall
        steps = self.step - step0
        final = {"test/log_likelihood_iwae": ll, "wall_seconds": wall,
                 "steps_per_sec": steps / max(wall, 1e-9),
                 "train_wall_seconds": train_wall,
                 "train_steps_per_sec": steps / max(train_wall, 1e-9)}
        self.logger.log(self.step, final)
        self.save_checkpoint()
        if verbose:
            print(f"final IWAE-{self.tc.likelihood_n} test LL: {ll:.3f} "
                  f"({wall:.1f}s, {final['steps_per_sec']:.1f} steps/s)")
        return {**final, "history": self.history}

    # --- checkpointing ----------------------------------------------------------

    def state(self) -> dict:
        return {"params": self.params, "opt_state": self.opt.state_dict(),
                "step": self.step, "rng": self.generator.get_state()}

    def save_checkpoint(self) -> str:
        from .. import checkpoint
        return checkpoint.save(f"{self.run_dir}/ckpt", self.step,
                               self.state())

    def restore_checkpoint(self, step: int | None = None) -> None:
        """Load a checkpoint of ``run_dir`` (the latest by default). It is
        read onto the CPU: the parameters are copied into the trainer's
        tensors, Adam moves its moments to the parameters' device and keeps
        its step counters on the CPU, and the generator takes a CPU state."""
        from .. import checkpoint
        st = checkpoint.restore(f"{self.run_dir}/ckpt", step,
                                map_location="cpu")
        self._load_state(_leaves(st["params"]), st["opt_state"], st["step"],
                         st["rng"])

    # --- evaluation -------------------------------------------------------------

    def _eval_keys(self, nb: int, bs: int):
        """The binarization source of one eval pass: in "fixed" mode the
        (nb, bs) global example indices that key each row's pixels (a pure
        function of (seed, example index), so the pinned binarization is
        the same at any eval batch size); in "dynamic" mode None -- fresh
        pixels are drawn from the session generator."""
        if self.tc.eval_binarize != "fixed":
            return None
        return torch.arange(nb * bs, device=self.device).reshape(nb, bs)

    def _binarize(self, x, row_ids):
        if row_ids is None:
            return binarize_batch(x, self.dataset.binarize, self.generator)
        return binarize_rows(_FIXED_BINARIZE_SALT ^ self.tc.seed, row_ids, x,
                             self.dataset.binarize)

    def _split_batches(self, data, bs):
        """(Nb, bs, ...) padded batches + (Nb, bs) valid mask + n. The tail
        is padded with a real example (finite math on pad rows) and masked
        out of every statistic."""
        n = len(data)
        nb = -(-n // bs)
        pad = nb * bs - n
        if pad:
            data = torch.cat([data, data[:1].expand((pad,) + data.shape[1:])])
        batches = data.reshape((nb, bs) + data.shape[1:])
        masks = (torch.arange(nb * bs, device=data.device) < n).to(
            torch.float32).reshape(nb, bs)
        return batches, masks, n

    @torch.no_grad()
    def evaluate_elbo(self, split: str = "test") -> dict:
        """Masked-mean ELBO over the full split: the padded tail is masked
        out and per-batch stats are weighted by their real example count."""
        data = self._test_data if split == "test" else self._train_data
        bs = min(self.tc.eval_batch_size, len(data))
        batches, masks, n = self._split_batches(data, bs)
        nb = batches.shape[0]
        row_ids = self._eval_keys(nb, bs)
        per_batch = []
        for i in range(nb):
            x = self._binarize(batches[i],
                               None if row_ids is None else row_ids[i])
            fwd = vae.forward(self.model_cfg, self.params, x,
                              generator=self.generator)
            kl_total = torch.sum(fwd.kl_per_comp, dim=-1)
            value = fwd.log_px_z - self.tc.beta * kl_total
            w = (masks[i] / torch.clamp(torch.sum(masks[i]), min=1.0)).to(
                value.dtype)
            per_batch.append({
                "elbo": torch.sum(w * value),
                "bce": torch.sum(w * -fwd.log_px_z),
                "kl": torch.sum(w * kl_total),
                "kl_per_comp": torch.sum(w[:, None] * fwd.kl_per_comp, dim=0),
                "curvature": fwd.curvatures,
            })
        stacked = {k: torch.stack([s[k] for s in per_batch]).cpu().numpy()
                   for k in per_batch[0]}
        es = EpochStats(self.component_names)
        for i in range(nb):
            es.update({k: v[i] for k, v in stacked.items()},
                      weight=min(bs, n - i * bs))
        return es.means()

    @torch.no_grad()
    def evaluate_log_likelihood(self, split: str = "test",
                                max_examples: int | None = None,
                                repeats: int = 1) -> float:
        """Mean IWAE-n log-likelihood over the full split (the padded tail
        dropped from the mean). ``repeats`` > 1 averages that many
        independent passes (fresh binarization and importance draws)."""
        if repeats > 1:
            vals = [self.evaluate_log_likelihood(split, max_examples)
                    for _ in range(repeats)]
            self.logger.log(self.step, {
                f"{split}/log_likelihood_iwae_repeats": vals,
                f"{split}/log_likelihood_iwae_std": float(np.std(vals))})
            return float(np.mean(vals))
        data = self._test_data if split == "test" else self._train_data
        if max_examples:
            data = data[:max_examples]
        bs = min(self.tc.eval_batch_size, len(data))
        batches, _, n = self._split_batches(data, bs)
        row_ids = self._eval_keys(batches.shape[0], bs)
        lls = []
        for i in range(batches.shape[0]):
            x = self._binarize(batches[i],
                               None if row_ids is None else row_ids[i])
            lls.append(vae.log_likelihood(
                self.model_cfg, self.params, x, self.tc.likelihood_n,
                self.tc.likelihood_chunk, generator=self.generator))
        return float(torch.cat(lls)[:n].mean().cpu())


def _fmt(stats: dict) -> str:
    parts = []
    for k in ("elbo", "bce", "kl"):
        if k in stats:
            parts.append(f"{k}={stats[k]:.2f}")
    curvs = [f"{v:+.2f}" for k, v in sorted(stats.items())
             if k.startswith("curvature/")]
    if curvs:
        parts.append("K=" + ",".join(curvs))
    return " ".join(parts)
