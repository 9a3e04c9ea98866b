"""The trainer's optimizer: Adam over parameter groups, the curvature mask
inside, one launch of ``kernels/optim_kernels.adam`` a step.

``Adam`` is no ``torch.optim.Optimizer``: its construction imports nothing
(``torch.optim.Optimizer``'s first construction imports ``torch._dynamo``),
and its step is the one kernel (the plain version on CPU tensors). It keeps
the face the trainer, its checkpoints and the benchmark read:

* ``param_groups`` and ``defaults`` carry ``torch.optim.Adam``'s keys;
* ``state`` maps each parameter to ``{"step", "exp_avg", "exp_avg_sq"}``,
  made at the first step; every ``step`` is a view of one count on the
  parameters' device, so zeroing each entry in place restarts the count;
* ``state_dict`` / ``load_state_dict`` use ``torch.optim.Adam``'s format,
  so each loads the other's checkpoints; a load copies into the tensors the
  optimizer holds (a captured graph goes on updating them) and keeps the
  groups' hyperparameters;
* ``zero_grad`` (to None), ``step`` and ``register_step_post_hook``.

The mask: a leaf in ``learnable`` (a learnable curvature) takes its gradient
times ``step_t >= burnin_steps``, a leaf in ``fixed`` a zero gradient, so
Adam counts every step, as optax does. ``step_t`` is the trainer's global
step on the device; each step advances it with Adam's count.
"""
from __future__ import annotations

import collections

import torch
from torch.utils.hooks import RemovableHandle

from ..kernels import optim_kernels

# torch.optim.Adam's hyperparameter keys beyond lr, betas, eps and
# capturable, at the values this optimizer implements, so that a state
# dict of either loads into the other
_TORCH_KEYS = {"weight_decay": 0, "amsgrad": False, "maximize": False,
               "foreach": None, "differentiable": False, "fused": None,
               "decoupled_weight_decay": False}


class Adam:
    """Adam over ``groups`` (dicts of ``params`` and ``lr``), betas and eps
    shared, with the curvature mask of ``learnable`` and ``fixed`` at
    ``step_t`` (a 0-d int64 on the parameters' device; one of its own when
    None) and ``burnin_steps``."""

    def __init__(self, groups, betas=(0.9, 0.999), eps: float = 1e-8,
                 learnable=(), fixed=(), step_t=None, burnin_steps: int = 0):
        params = [p for g in groups for p in g["params"]]
        if not params:
            raise ValueError("Adam: no parameters")
        device = params[0].device
        self.defaults = {"lr": groups[0]["lr"], "betas": tuple(betas),
                         "eps": eps, **_TORCH_KEYS,
                         "capturable": device.type == "cuda"}
        self.param_groups = [{**self.defaults, **g,
                              "params": list(g["params"])} for g in groups]
        ids_learnable = {id(t) for t in learnable}
        ids_fixed = {id(t) for t in fixed}
        self.kinds = [optim_kernels.FIXED if id(p) in ids_fixed else
                      optim_kernels.CURVATURE if id(p) in ids_learnable else
                      optim_kernels.PLAIN for p in params]
        self.step_t = (torch.zeros((), dtype=torch.int64, device=device)
                       if step_t is None else step_t)
        self.burnin_steps = int(burnin_steps)
        self.state: dict = {}
        self._count = None
        self._ticket = torch.zeros((), dtype=torch.int32, device=device)
        self._post_hooks: collections.OrderedDict = collections.OrderedDict()

    def _params(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    def _init_state(self) -> None:
        """Zero moments and one zero count, as torch makes them at the
        first step."""
        if self.state:
            return
        params = self._params()
        self._count = torch.zeros((), dtype=torch.float32,
                                  device=params[0].device)
        for p in params:
            self.state[p] = {
                "step": self._count.view(()),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format)}

    def zero_grad(self) -> None:
        """Every gradient set to None (the next backward makes them)."""
        for p in self._params():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One Adam step of every leaf, the mask inside: one launch of the
        kernel on CUDA parameters, the plain version on CPU ones."""
        self._init_state()
        params = self._params()
        lrs = [g["lr"] for g in self.param_groups for _ in g["params"]]
        optim_kernels.adam(
            params, [p.grad for p in params],
            [self.state[p]["exp_avg"] for p in params],
            [self.state[p]["exp_avg_sq"] for p in params], self.kinds, lrs,
            self._count, self.step_t, self._ticket, self.burnin_steps,
            self.defaults["betas"], self.defaults["eps"])
        for hook in list(self._post_hooks.values()):
            hook(self, (), {})

    def register_step_post_hook(self, hook) -> RemovableHandle:
        """``hook(optimizer, args, kwargs)`` after every step."""
        handle = RemovableHandle(self._post_hooks)
        self._post_hooks[handle.id] = hook
        return handle

    def state_dict(self) -> dict:
        """``torch.optim.Adam``'s format: state by parameter index (each
        ``step`` a tensor of its own), the groups with their keys."""
        index = {id(p): i for i, p in enumerate(self._params())}
        state = {index[id(p)]: {"step": st["step"].clone(),
                                "exp_avg": st["exp_avg"],
                                "exp_avg_sq": st["exp_avg_sq"]}
                 for p, st in self.state.items()}
        groups, start = [], 0
        for g in self.param_groups:
            n = len(g["params"])
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": list(range(start, start + n))})
            start += n
        return {"state": state, "param_groups": groups}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Adam's state ``sd`` (this format, or ``torch.optim.Adam``'s)
        copied into the tensors this optimizer holds, made first if it has
        none. The groups keep their hyperparameters (the reference's
        optimizer state holds none). Raises on another layout of groups or
        on step counts that differ between parameters."""
        sizes = [len(g["params"]) for g in sd["param_groups"]]
        held = [len(g["params"]) for g in self.param_groups]
        if sizes != held:
            raise ValueError(f"Adam.load_state_dict: groups of {sizes} "
                             f"parameters, this optimizer's of {held}")
        steps = {float(st["step"]) for st in sd["state"].values()}
        if len(steps) > 1:
            raise ValueError(f"Adam.load_state_dict: one step count for "
                             f"every parameter, got {sorted(steps)}")
        self._init_state()
        for i, p in enumerate(self._params()):
            st, mine = sd["state"].get(i), self.state[p]
            for name in ("exp_avg", "exp_avg_sq"):
                if st is None:
                    mine[name].zero_()
                else:
                    mine[name].copy_(st[name])
        self._count.fill_(steps.pop() if steps else 0.0)
