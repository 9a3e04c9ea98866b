"""Evaluation half of the trainer (L5).

Counterpart of ``mvae_tpu/train/trainer.py`` for the serving path: a
``Trainer`` holds a model's parameters on one device and answers "what is
the test ELBO / IWAE marginal log-likelihood of this split", over the
whole split with the padded tail masked out of every statistic.

Differences from the reference:

* evaluation is a Python loop over batches of eager PyTorch (no scan);
  the host reads the statistics once, after the last batch;
* randomness comes from one ``torch.Generator`` on the device, seeded
  from ``TrainConfig.seed``; the pinned binarization mode
  (``eval_binarize="fixed"``) is a counter hash of (seed, example index);
* training (``train_one_epoch`` / ``fit``) is the next slice of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.base import (ArrayDataset, binarize_batch, binarize_rows,
                         to_device_dataset)
from ..models import vae
from ..utils.device import resolve_device
from .stats import EpochStats

# seed offset of the pinned eval binarization (the reference's 0xB1A)
_FIXED_BINARIZE_SALT = 0xB1A


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


class Trainer:
    """Holds one model on one device and evaluates it on a dataset."""

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
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tc.seed)

        self._train_data, self._test_data = to_device_dataset(
            dataset, self.device, self.dtype)
        self.component_names = [
            f"{c.name}#{i}" for i, c in enumerate(model_cfg.components)]
        self.fused_paths = vae.fused_path_report(model_cfg, self.params)

    # --- training: the next slice ---------------------------------------------

    def train_one_epoch(self, epoch: int) -> dict:
        raise NotImplementedError("slice 2: training (tail backward kernel, "
                                  "Adam, curvature burn-in)")

    def fit(self, *args, **kwargs) -> dict:
        raise NotImplementedError("slice 2: training (tail backward kernel, "
                                  "Adam, curvature burn-in)")

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
