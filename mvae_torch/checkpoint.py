"""Checkpoint / resume of the full training state.

Counterpart of ``mvae_tpu/checkpoint.py``, with its names and layout: one
directory ``<ckpt_dir>/step_XXXXXXXX`` per saved step. The port stores the
state with ``torch.save`` as ``state.pt`` in that directory: the params
(nested dicts/tuples of tensors), the optimizer's ``state_dict``, the step
and the training generator's ``get_state()``. It is read back with
``weights_only=True``.

The port cannot restore an orbax checkpoint of the JAX package; the bridge
for weights is ``convert.params_from_jax``.
"""
from __future__ import annotations

from pathlib import Path

import torch

_FILE = "state.pt"


def save(ckpt_dir: str, step: int, state: dict) -> str:
    """state: {'params', 'opt_state', 'step', 'rng'}; returns the path."""
    path = Path(ckpt_dir).absolute() / f"step_{step:08d}"
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (_FILE + ".tmp")
    torch.save(state, tmp)
    tmp.replace(path / _FILE)
    return str(path)


def latest_step(ckpt_dir: str) -> int | None:
    p = Path(ckpt_dir)
    if not p.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in p.iterdir()
             if d.is_dir() and d.name.startswith("step_")
             and (d / _FILE).exists()]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int | None = None, map_location=None):
    """The training state saved by :func:`save` (the latest step when
    ``step`` is None), its tensors on ``map_location``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = Path(ckpt_dir).absolute() / f"step_{step:08d}" / _FILE
    return torch.load(path, map_location=map_location, weights_only=True)
