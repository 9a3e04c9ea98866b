"""Training / evaluation loop (L5).

Counterpart of ``mvae_tpu/train/trainer.py``: a ``Trainer`` holds a
model's parameters on one device and trains it with Adam (a separate
learning rate for the curvature leaves ``c_param``, curvature frozen for
``burnin_epochs`` and always when fixed), evaluates the test ELBO after
every epoch and the IWAE-n marginal log-likelihood at the end, guards
against non-finite epochs, logs to ``<run_dir>/metrics.jsonl`` and
checkpoints the full state (params, optimizer, step, generator).

Differences from the reference:

* on one CUDA device, and on each rank of an NCCL mesh, the reference's
  compiled programs are CUDA graphs (``graphs``): a training step, an ELBO
  batch and an IWAE batch are each captured once per (shape, routing) and
  replayed, the step reading its batch from a static permutation at a
  device step index and the burn-in mask traced on a device step counter,
  so one capture serves burn-in and after -- the counterpart of the
  reference's ``lax.scan`` epoch; a rank's collectives are inside its
  graphs. On the CPU and on a gloo mesh the same bodies run as Python loops
  of eager PyTorch (``graph_path`` says which ran, and why). Either way the host reads the
  statistics once per epoch or pass, and a step never waits on the device;
* randomness (batch order, binarization, reparameterization noise, eval
  draws) comes from one ``torch.Generator`` on the device (Philox on
  CUDA), seeded from ``TrainConfig.seed``; it replaces the reference's
  ``train_rng`` ("rbg"/"threefry") and ``TrainConfig`` has no field for
  it. The pinned binarization mode (``eval_binarize="fixed"``) is a
  counter hash of (seed, example index);
* the optimizer is the port's own ``optim.Adam`` with optax's defaults
  (betas (0.9, 0.999), eps 1e-8): on CUDA parameters one launch of
  ``kernels/optim_kernels.adam`` a step over every leaf, the curvature mask,
  both learning rates and the step counters inside (its count on the card,
  so the graphed and the eager step do the same arithmetic); on CPU ones the
  kernel's plain version. Masked curvature gradients are multiplied by zero,
  never dropped, so Adam counts every step as optax does and the bias
  correction after burn-in uses the global step. Its state dicts are
  ``torch.optim.Adam``'s.

With ``mesh_shape`` (D, M) the trainer is one rank of a ("data", "model")
mesh (``parallel``; the ranks are started by ``parallel.launch``): it holds
its "model" slice of the wide weights and of their Adam moments (Adam is
elementwise, so Adam over the slices is Adam over the whole), takes its B / D
rows of every batch, and averages the gradients and the step's statistics
over the mesh before Adam. Every rank draws the same batch order (a
generator seeded by ``seed``); binarization and reparameterization noise come
from a generator seeded by (seed, data index), the counterpart of the
reference's ``fold_in(key, axis_index("data"))``. The evaluations shard the
rows over "data" (and the IWAE's samples over "model", drawn from a
generator seeded once a pass by (a draw of the rank's generator, model
index)); the pinned binarization hashes each row's global example index. Checkpoints hold the
whole parameters and Adam moments, written by rank 0 in the one-device
layout, so a mesh checkpoint restores on one device and the other way round;
rank 0 alone logs and prints.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.base import (ArrayDataset, binarize_batch, binarize_rows,
                         to_device_dataset)
from ..models import vae
from ..parallel import param_shardings, shard_batch, shard_params
from ..parallel.collectives import (all_reduce_mean_, all_reduce_sum_,
                                    gather_model, gather_params)
from ..parallel.mesh import fold_seed
from ..utils import profiling
from ..utils.device import resolve_device
from . import graphs
from .metrics import MetricsLogger
from .optim import Adam
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
    # (data, model) mesh shape; None = one device. The batch must divide
    # the data axis; the model axis shards the wide encoder/decoder weights
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


def make_optimizer(params, tc: TrainConfig, components, step_t,
                   burnin_steps: int) -> Adam:
    """One Adam over two parameter groups: the ``c_param`` leaves at
    ``curvature_lr``, everything else at ``lr`` (optax's defaults); the
    curvature mask of ``components`` at the device step ``step_t``
    (``optim.Adam``)."""
    curv = _curvature_leaves(params)
    ids = {id(t) for t in curv}
    groups = [{"params": [t for t in _leaves(params) if id(t) not in ids],
               "lr": tc.lr}]
    if curv:
        groups.append({"params": curv, "lr": tc.curvature_lr})
    fixed = [cp["c_param"] for comp, cp in zip(components,
                                               params["components"])
             if "c_param" in cp and comp.fixed_curvature]
    return Adam(groups, betas=(0.9, 0.999), eps=1e-8, learnable=curv,
                fixed=fixed, step_t=step_t, burnin_steps=burnin_steps)


class Trainer:
    """Orchestrates training and evaluation on a device-resident dataset."""

    def __init__(self, model_cfg: vae.VAEConfig, dataset: ArrayDataset,
                 tc: TrainConfig, run_dir: str = "runs/default",
                 device=None):
        if tc.eval_binarize not in ("dynamic", "fixed"):
            raise ValueError(f"unknown eval_binarize {tc.eval_binarize!r}")
        self.mesh = None
        if tc.mesh_shape is not None:
            from ..parallel import make_mesh
            if tc.batch_size % tc.mesh_shape[0]:
                raise ValueError("batch_size must divide the data-mesh axis")
            self.mesh = make_mesh(*tc.mesh_shape, device=device)
            if self.mesh is None:
                raise ValueError(f"this rank is outside the mesh "
                                 f"{tc.mesh_shape}")
            self.device = self.mesh.device
        else:
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
        # the batch order: one generator, the same on every rank
        self._perm_generator = self.generator
        if self.mesh is not None:
            self._axes = param_shardings(self.mesh, self.params)
            self.params = shard_params(self.params, self.mesh)
            self.generator.manual_seed(fold_seed(tc.seed,
                                                 self.mesh.data_index))
            self._perm_generator = torch.Generator(device=self.device)
            self._perm_generator.manual_seed(tc.seed)
            # the sharded IWAE's importance draws, apart for each model index
            self._sample_generator = torch.Generator(device=self.device)
        for t in _leaves(self.params):
            t.requires_grad_(True)
        self.step = 0
        # the global step on the device: the curvature mask reads it, and
        # each optimizer step advances it
        self._step_t = torch.zeros((), dtype=torch.int64, device=self.device)
        # captured programs by key (graphs.Graphed) and the epoch's buffers
        self._programs: dict = {}
        self._epoch = None
        self.steps_per_epoch = len(dataset.train) // tc.batch_size
        self.burnin_steps = tc.burnin_epochs * self.steps_per_epoch
        self.opt = make_optimizer(self.params, tc, model_cfg.components,
                                  self._step_t, self.burnin_steps)

        self._train_data, self._test_data = to_device_dataset(
            dataset, self.device, self.dtype)
        self.component_names = [
            f"{c.name}#{i}" for i, c in enumerate(model_cfg.components)]
        self.history: list[dict] = []
        self._logger = None
        self.fused_paths = vae.fused_path_report(model_cfg, self.params,
                                                 self.mesh)
        self.fused_paths["optimizer"] = (
            {"active": True, "why": "kernel csrc/adam.cu: one launch a step "
             "over every leaf, the curvature mask and both learning rates "
             "inside"} if self.device.type == "cuda" else
            {"active": False, "why": f"{self.device.type} parameters: the "
             "kernel's plain version adam_ref (the kernel runs on CUDA "
             "tensors only)"})

    @property
    def chief(self) -> bool:
        """Whether this trainer logs, prints and writes checkpoints: rank 0
        of a mesh, or the one device."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def graph_path(self) -> dict:
        """Whether training and evaluation replay CUDA graphs ("graph") or
        run the eager loop ("eager"), and why (``graphs.path``)."""
        return graphs.path(self)

    def _program(self, key, build):
        """The captured program of ``key``, built on first use (the
        reference's ``_memoized``; here per trainer: a graph holds this
        trainer's tensors)."""
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = build()
        return prog

    @property
    def logger(self) -> MetricsLogger:
        """``<run_dir>/metrics.jsonl``, opened at the first record."""
        if self._logger is None:
            self._logger = MetricsLogger(self.run_dir)
        return self._logger

    def _log(self, step: int, record: dict) -> None:
        if self.chief:
            self.logger.log(step, record)

    def whole_params(self):
        """The whole parameters: on a mesh gathered over "model" (every
        rank takes part), detached; on one device ``params`` itself."""
        if self.mesh is None:
            return self.params
        with torch.no_grad():
            return gather_params(self.params, self.mesh, self._axes)

    # --- training ---------------------------------------------------------------

    def _train_step(self, x, u_bin=None, noise=None) -> dict:
        """One Adam step on the batch ``x`` of intensities. ``u_bin`` (x's
        shape) are the binarization uniforms and ``noise`` (B, E) the
        reparameterization noise (``tail_kernels.draw_noise`` layout); each
        is drawn from the trainer's generator when not given. On a mesh they
        are the global batch's, and the rank takes its rows. Returns the
        step's stats as device tensors (no host sync on one device). This
        is the eager step: ``train_one_epoch`` replays a graph of the same
        body on one CUDA device."""
        profiling.mark("encode", x)
        if self.mesh is not None:
            x, u_bin, noise = (None if t is None else shard_batch(t, self.mesh)
                               for t in (x, u_bin, noise))
        stats = self._step_body(x, u_bin, noise)
        self.step += 1
        profiling.mark("end", x)
        return stats

    def _step_body(self, x, u_bin, noise) -> dict:
        """The step on this rank's rows, the body a CUDA graph captures:
        binarize, the loss and its backward, the mesh average, then one
        optimizer step: the curvature mask at the device step counter,
        Adam, the counters advanced. Issues no host read and no
        host-to-device copy. Its callers mark where a step starts and ends (``profiling.mark``); the
        forward marks its layers (``vae``), the backward's start here, its
        boundaries at z's and the encoder features' gradients, and the
        optimizer's."""
        x = binarize_batch(x, self.dataset.binarize, self.generator, u_bin)
        self.opt.zero_grad()
        loss, stats = vae.loss_fn(self.model_cfg, self.params, x,
                                  self.tc.beta, noise, self.generator,
                                  self.mesh)
        profiling.mark("bwd_decode", loss)
        loss.backward()
        stats = {k: v.detach() for k, v in stats.items()}
        if self.mesh is not None:
            self._average_over_mesh(stats)
        profiling.mark("optimizer", loss)
        self.opt.step()
        return stats

    def _average_over_mesh(self, stats: dict) -> None:
        """Average this step's gradients and statistics over the mesh, in
        place. A replicated leaf's gradient and the statistics are averaged
        over every rank in one collective (the ranks of a data index hold
        copies, so that is the mean over "data"); a sharded leaf's, already
        reduce-scattered over "model" by its gather, over "data"."""
        mesh = self.mesh
        whole, sharded = [stats[k] for k in ("elbo", "bce", "kl",
                                             "kl_per_comp")], []
        for t, axis in zip(_leaves(self.params), _leaves(self._axes)):
            if t.grad is not None:
                (whole if axis is None or mesh.n_model == 1
                 else sharded).append(t.grad)
        all_reduce_mean_(mesh, whole)
        all_reduce_mean_(mesh, sharded, mesh.data_group)

    def _epoch_perm(self):
        """The epoch's batch order: a permutation of the train split from
        the batch-order generator, cut to whole batches (the reference's
        ``perm``, drawn outside the compiled epoch)."""
        n = self.steps_per_epoch * self.tc.batch_size
        return torch.randperm(len(self._train_data),
                              generator=self._perm_generator,
                              device=self.device)[:n]

    def train_one_epoch(self, epoch: int) -> dict:
        """``steps_per_epoch`` steps over a permutation of the train split
        drawn from the generator; stats averaged over the steps, the
        curvature the last step's snapshot. On one CUDA device each step is
        a replay of the step's graph (``graphs.TrainEpoch``), elsewhere the
        eager loop (``graph_path``)."""
        if self.graph_path["path"] == "eager":
            return self._train_one_epoch_eager(epoch)
        if self._epoch is None:
            self._epoch = graphs.TrainEpoch(self)
        stacked = self._epoch.run(self._epoch_perm())
        self.step += self.steps_per_epoch
        return self._epoch_means(stacked)

    def _train_one_epoch_eager(self, epoch: int) -> dict:
        """``train_one_epoch`` as a Python loop of eager steps
        (``_train_step``): the CPU's and a mesh rank's epoch."""
        bs = self.tc.batch_size
        perm = self._epoch_perm()
        seq = [self._train_step(self._train_data[perm[s * bs:(s + 1) * bs]])
               for s in range(self.steps_per_epoch)]
        return self._epoch_means({k: torch.stack([st[k] for st in seq])
                                  for k in seq[0]})

    def _epoch_means(self, stacked: dict) -> dict:
        """An epoch's (steps, ...) statistics averaged over the steps, the
        curvature the last step's snapshot, read to the host once."""
        means = {k: torch.mean(v, dim=0) for k, v in stacked.items()}
        means["curvature"] = stacked["curvature"][-1]
        es = EpochStats(self.component_names)
        with profiling.host_sync("epoch.stats_read"):
            es.update({k: v.cpu().numpy() for k, v in means.items()})
        return es.means()

    def _guard_state(self) -> dict:
        """Device copy of this rank's resumable state: the non-finite
        guard's last-finite snapshot (read back only if the guard trips)."""
        return {"params": [t.detach().clone() for t in _leaves(self.params)],
                "opt_state": copy.deepcopy(self.opt.state_dict()),
                "step": self.step, "rng": self.generator.get_state(),
                "perm_rng": self._perm_generator.get_state()}

    def _load_state(self, params_leaves, opt_state, step, rng,
                    perm_rng=None) -> None:
        with torch.no_grad():
            for t, v in zip(_leaves(self.params), params_leaves):
                t.copy_(v)
        self.opt.load_state_dict(opt_state)
        self.step = int(step)
        self._step_t.fill_(self.step)
        self.generator.set_state(rng)
        if perm_rng is not None:
            self._perm_generator.set_state(perm_rng)

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
                             prev_state["step"], prev_state["rng"],
                             prev_state["perm_rng"])
            self.save_checkpoint()
        self._log(last_step, {
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
                if profile_epochs and epoch == 0 and self.chief:
                    tracing.enter_context(profiling.trace(
                        f"{self.run_dir}/profile", self.device))
                state_before = self._guard_state()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                te0 = time.time()
                train_stats = self.train_one_epoch(epoch)
                train_wall += time.time() - te0
                if epoch + 1 == profile_epochs and self.chief:
                    tracing.close()
                self._check_finite(epoch, train_stats, state_before)
                rec = {f"train/{k}": v for k, v in train_stats.items()}
                test_stats = self.evaluate_elbo("test")
                rec.update({f"test/{k}": v for k, v in test_stats.items()})
                rec["epoch"] = epoch
                self._log(self.step, rec)
                self.history.append(rec)
                if verbose and self.chief:
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
        self._log(self.step, final)
        self.save_checkpoint()
        if verbose and self.chief:
            print(f"final IWAE-{self.tc.likelihood_n} test LL: {ll:.3f} "
                  f"({wall:.1f}s, {final['steps_per_sec']:.1f} steps/s)")
        return {**final, "history": self.history}

    # --- checkpointing ----------------------------------------------------------

    def state(self) -> dict:
        """The resumable state in the one-device layout. On a mesh (every
        rank takes part) the parameters and Adam moments are gathered whole,
        ``rng`` is rank 0's generator, and ``mesh`` adds the mesh's shape,
        each data index's generator and the batch order's generator."""
        if self.mesh is None:
            return {"params": self.params, "opt_state": self.opt.state_dict(),
                    "step": self.step, "rng": self.generator.get_state()}
        mesh = self.mesh
        rngs = [None] * mesh.size
        dist.all_gather_object(rngs, self.generator.get_state(),
                               group=mesh.group)
        return {"params": self.whole_params(),
                "opt_state": self._whole_opt_state(), "step": self.step,
                "rng": rngs[0],
                "mesh": {"shape": [mesh.n_data, mesh.n_model],
                         "rng": rngs[::mesh.n_model],
                         "perm_rng": self._perm_generator.get_state()}}

    def _map_moments(self, sd: dict, fn) -> dict:
        """Adam's state_dict ``sd`` with ``fn(moment, axis)`` applied to each
        sharded leaf's moments (exp_avg, exp_avg_sq)."""
        order = [t for g in self.opt.param_groups for t in g["params"]]
        axis_of = {id(t): a for t, a in zip(_leaves(self.params),
                                            _leaves(self._axes))}
        state = {}
        for i, st in sd["state"].items():
            axis = axis_of[id(order[int(i)])]
            state[i] = {k: fn(v, axis) if axis is not None
                        and torch.is_tensor(v) and v.dim() > 0 else v
                        for k, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def _whole_opt_state(self) -> dict:
        """Adam's state with the sharded moments gathered whole (every rank
        takes part)."""
        with torch.no_grad():
            return self._map_moments(
                self.opt.state_dict(),
                lambda v, axis: gather_model(v, axis, self.mesh))

    def _shard_opt_state(self, sd: dict) -> dict:
        """A whole Adam state sliced to this rank's shards."""
        mesh = self.mesh
        return self._map_moments(sd, lambda v, axis: v.chunk(
            mesh.n_model, axis)[mesh.model_index].clone())

    def save_checkpoint(self) -> str | None:
        """Write the state (``state``) under ``run_dir/ckpt``; on a mesh
        rank 0 writes it, every rank waits for the write, and the path is
        returned on rank 0 only."""
        from .. import checkpoint
        state = self.state()
        path = (checkpoint.save(f"{self.run_dir}/ckpt", self.step, state)
                if self.chief else None)
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group)
        return path

    def restore_checkpoint(self, step: int | None = None) -> None:
        """Load a checkpoint of ``run_dir`` (the latest by default). It is
        read onto the CPU: the parameters and Adam's state are copied into
        the trainer's tensors (``optim.Adam.load_state_dict``), and the
        generator takes a CPU state.
        On a mesh each rank keeps its slice; a checkpoint of the same mesh
        shape restores each generator, any other re-seeds them from (seed,
        step, data index)."""
        from .. import checkpoint
        st = checkpoint.restore(f"{self.run_dir}/ckpt", step,
                                map_location="cpu")
        if self.mesh is None:
            self._load_state(_leaves(st["params"]), st["opt_state"],
                             st["step"], st["rng"])
            return
        mesh, saved = self.mesh, st.get("mesh")
        if saved is not None and saved["shape"] == [mesh.n_data,
                                                    mesh.n_model]:
            rng, perm_rng = saved["rng"][mesh.data_index], saved["perm_rng"]
        else:
            rng = self.generator.manual_seed(fold_seed(fold_seed(
                self.tc.seed, int(st["step"])), mesh.data_index)).get_state()
            perm_rng = self._perm_generator.manual_seed(fold_seed(
                self.tc.seed, int(st["step"]))).get_state()
        self._load_state(_leaves(shard_params(st["params"], mesh)),
                         self._shard_opt_state(st["opt_state"]), st["step"],
                         rng, perm_rng)

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

    def _eval_batch_size(self, n: int) -> int:
        """The eval batch: ``eval_batch_size`` (at most the split), on a
        mesh rounded up to a multiple of the data axis (the pad rows are
        masked out)."""
        bs = min(self.tc.eval_batch_size, n)
        if self.mesh is not None:
            bs = -(-bs // self.mesh.n_data) * self.mesh.n_data
        return bs

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

    def _eval_program(self, kind: str, body, x, mask, rows, graph: bool,
                      whole: bool = True):
        """The per-batch evaluation ``body(params, x, mask, rows)`` as a
        function of (x, mask, rows): without ``graph`` the body run eagerly,
        else its graph (``graphs.Graphed``) over static buffers shaped as
        this pass's batch ``x``, ``mask`` and ``rows``, keyed by those
        shapes, the fields the body reads and the routing (the reference's
        ``make_eval_elbo`` / ``make_eval_ll`` keys). The body gets the
        whole parameters (``whole``: on a mesh gathered once a pass
        eagerly, once a batch inside a graph) or this rank's shards."""
        if not graph:
            params = self.whole_params() if whole else self.params
            return lambda *batch: body(params, *batch)
        fields = ((self.tc.beta,) if kind == "eval_elbo" else
                  (self.tc.likelihood_n, self.tc.likelihood_chunk))
        key = (kind, tuple(x.shape), x.dtype, mask is None, rows is None,
               whole, fields,
               graphs.routing_key(self.model_cfg, self.params))
        params = self.whole_params if whole else lambda: self.params
        gens = (self.generator,) + ((self._sample_generator,)
                                    if self.mesh is not None else ())
        return self._program(key, lambda: graphs.Graphed(
            lambda *batch: body(params(), *batch),
            tuple(None if t is None else torch.empty_like(t)
                  for t in (x, mask, rows)),
            gens, graphs.WARMUP_BATCHES, copy_out=True))

    def _elbo_batch(self, params, x, mask, rows) -> dict:
        """One eval batch's masked sums (weights ``mask`` / its count): the
        body of the ELBO pass's graph (``make_eval_elbo``'s scan body),
        marked from ``encode`` to ``end``."""
        profiling.mark("encode", x)
        w = mask / torch.clamp(torch.sum(mask), min=1.0)
        if self.mesh is not None:
            x, w = shard_batch(x, self.mesh), shard_batch(w, self.mesh)
            rows = None if rows is None else shard_batch(rows, self.mesh)
        x = self._binarize(x, rows)
        fwd = vae.forward(self.model_cfg, params, x, generator=self.generator)
        profiling.mark("loss", x)
        kl_total = torch.sum(fwd.kl_per_comp, dim=-1)
        value = fwd.log_px_z - self.tc.beta * kl_total
        w = w.to(value.dtype)
        out = {"elbo": torch.sum(w * value),
               "bce": torch.sum(w * -fwd.log_px_z),
               "kl": torch.sum(w * kl_total),
               "kl_per_comp": torch.sum(w[:, None] * fwd.kl_per_comp, dim=0),
               "curvature": fwd.curvatures}
        profiling.mark("end", x)
        return out

    def evaluate_elbo(self, split: str = "test") -> dict:
        """Masked-mean ELBO over the full split: the padded tail is masked
        out and per-batch stats are weighted by their real example count.
        On one CUDA device each batch is a replay of the ELBO graph, else
        the eager loop (``graph_path``)."""
        return self._evaluate_elbo(split, self.graph_path["path"] == "graph")

    @torch.no_grad()
    def _evaluate_elbo(self, split: str, graph: bool) -> dict:
        data = self._test_data if split == "test" else self._train_data
        bs = self._eval_batch_size(len(data))
        batches, masks, n = self._split_batches(data, bs)
        nb = batches.shape[0]
        row_ids = self._eval_keys(nb, bs)
        rows = [None] * nb if row_ids is None else row_ids
        run = self._eval_program("eval_elbo", self._elbo_batch, batches[0],
                                 masks[0], rows[0], graph)
        per_batch = [run(batches[i], masks[i], rows[i]) for i in range(nb)]
        stacked = {k: torch.stack([s[k] for s in per_batch])
                   for k in per_batch[0]}
        if self.mesh is not None:
            # the data shards' weighted sums add up to the batch's
            all_reduce_sum_(self.mesh, [stacked[k] for k in (
                "elbo", "bce", "kl", "kl_per_comp")], self.mesh.data_group)
        with profiling.host_sync("elbo.read"):
            stacked = {k: v.cpu().numpy() for k, v in stacked.items()}
        es = EpochStats(self.component_names)
        for i in range(nb):
            es.update({k: v[i] for k, v in stacked.items()},
                      weight=min(bs, n - i * bs))
        return es.means()

    def evaluate_log_likelihood(self, split: str = "test",
                                max_examples: int | None = None,
                                repeats: int = 1) -> float:
        """Mean IWAE-n log-likelihood over the full split (the padded tail
        dropped from the mean). ``repeats`` > 1 averages that many
        independent passes (fresh binarization and importance draws).

        On a mesh whose model axis divides n, each data shard's rows go
        through ``vae.log_likelihood_sharded`` (the samples over "model",
        drawn from a generator seeded once a pass) and the sums meet over
        "data"; otherwise every rank runs the one-device estimator on the
        whole parameters and rank 0's value is returned on every rank. On
        one CUDA device and on an NCCL rank each batch is a replay of the
        IWAE graph (the whole chunk loop), else the eager loop
        (``graph_path``)."""
        if repeats > 1:
            vals = [self.evaluate_log_likelihood(split, max_examples)
                    for _ in range(repeats)]
            self._log(self.step, {
                f"{split}/log_likelihood_iwae_repeats": vals,
                f"{split}/log_likelihood_iwae_std": float(np.std(vals))})
            return float(np.mean(vals))
        return self._evaluate_log_likelihood(
            split, max_examples, self.graph_path["path"] == "graph")

    @torch.no_grad()
    def _evaluate_log_likelihood(self, split: str, max_examples: int | None,
                                 graph: bool) -> float:
        data = self._test_data if split == "test" else self._train_data
        if max_examples:
            data = data[:max_examples]
        mesh = self.mesh
        if mesh is not None and self.tc.likelihood_n % mesh.n_model == 0:
            return self._log_likelihood_sharded(data, graph)
        bs = min(self.tc.eval_batch_size, len(data))
        batches, _, n = self._split_batches(data, bs)
        nb = batches.shape[0]
        row_ids = self._eval_keys(nb, bs)
        rows = [None] * nb if row_ids is None else row_ids
        run = self._eval_program("eval_ll", self._ll_batch, batches[0],
                                 None, rows[0], graph)
        lls = [run(batches[i], None, rows[i]) for i in range(nb)]
        ll = torch.cat(lls)[:n].mean()
        if mesh is not None:
            ll = ll.reshape(1).to(torch.float64)
            if mesh.backend == "gloo":
                ll = ll.cpu()
            dist.broadcast(ll, src=0, group=mesh.group)
        with profiling.host_sync("iwae.read"):
            return float(ll.cpu())

    def _ll_batch(self, params, x, mask, rows):
        """One eval batch's IWAE estimates, (B,) (``mask`` unused: the
        caller drops the pad rows): the body of the IWAE pass's graph
        (``make_eval_ll``'s scan body), the whole chunk loop of
        ``vae._log_weights`` in it."""
        return vae.log_likelihood(
            self.model_cfg, params, self._binarize(x, rows),
            self.tc.likelihood_n, self.tc.likelihood_chunk,
            generator=self.generator)

    def _ll_batch_sharded(self, params, x, mask, rows):
        """One eval batch's masked IWAE sum over this rank's rows (``params``
        its shards): the body of a mesh rank's IWAE graph, its samples
        drawn from ``_sample_generator`` and its partial logsumexps met over
        "model" inside."""
        mesh = self.mesh
        x, mask = shard_batch(x, mesh), shard_batch(mask, mesh)
        rows = None if rows is None else shard_batch(rows, mesh)
        ll = vae.log_likelihood_sharded(
            self.model_cfg, params, self._binarize(x, rows), mesh,
            self.tc.likelihood_n, self.tc.likelihood_chunk,
            generator=self._sample_generator)
        return torch.sum(ll * mask.to(ll.dtype))

    def _log_likelihood_sharded(self, data, graph: bool) -> float:
        mesh = self.mesh
        bs = self._eval_batch_size(len(data))
        batches, masks, n = self._split_batches(data, bs)
        nb = batches.shape[0]
        row_ids = self._eval_keys(nb, bs)
        rows = [None] * nb if row_ids is None else row_ids
        # one seed a pass from the data shard's generator (the same on its
        # model ranks), folded with the model index: each model rank draws
        # its own samples of the same rows
        with profiling.host_sync("iwae.seed_read"):
            seed = int(torch.randint(0, 2**62, (), generator=self.generator,
                                     device=self.device))
        self._sample_generator.manual_seed(fold_seed(seed, mesh.model_index))
        run = self._eval_program("eval_ll", self._ll_batch_sharded,
                                 batches[0], masks[0], rows[0], graph,
                                 whole=False)
        total = torch.stack([run(batches[i], masks[i], rows[i])
                             for i in range(nb)]).to(torch.float64).sum()
        all_reduce_sum_(mesh, [total], mesh.data_group)
        with profiling.host_sync("iwae.read"):
            return float(total.cpu()) / n


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
