"""The benchmark's plain references: each model family the cells run, written
again in plain PyTorch, independent of the program under test (a reference
imports nothing of ``mvae_torch``).

A configuration names its family's module by ``"reference"``
(``reference/<name>.py``); ``load`` finds it in the checkout's own
``benchmark/reference``, so a family enters as a new file. The harness
(``generate``, ``check``, ``run.shapes``) reads a module through this
contract alone:

* ``parse_spec(spec)``: the latent factors of the configuration's
  ``"spec"``, each with ``ambient`` (its width in z), ``head_width`` (its
  encoder head's outputs), ``noise_width`` (its standard noise a draw) and
  ``posterior`` (``"vmf"`` draws its noise's first coordinate from
  U[``U_MIN``, 1), every other coordinate and posterior N(0, 1));
* ``U_MIN``; optionally ``noise(lats, shape, gen, device)``, the
  (*shape, E) standard noise of the product latent drawn from ``gen``, for
  a family whose posteriors draw more than that (rejection proposals), in
  the layout the program takes;
* ``param_shapes(lats, cfg)``: name -> shape of every parameter, in the
  program's tree order (``programs.flatten``'s names);
* ``init(lats, cfg)``: name -> ``("normal", std)`` for a leaf drawn from
  the seed (one flat N(0, 1) draw over these leaves in
  ``param_shapes``' order, each scaled by its std) or ``("fill", value)``;
* ``loss(lats, p, x, eps, beta)``, ``adam(lats, p, batches, lr,
  curvature_lr, burnin_steps, beta=)`` and ``iwae(lats, p, x, eps, chunk)``
  on data batches of the configuration's ``data_shape`` (binary where it
  says ``binarize``), and ``tf32_matmuls()``, the control's precision;
* ``work(cfg, lats, traffic)``: ``{"train_step": {"gemm_macs",
  "executed_macs", "bytes"} or None, "iwae_example_flops": int}``, a
  training step's executed multiply-adds and bytes at the traffic's batch
  (None without one) and an IWAE example's FLOPs at its samples.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def load(directory: Path, name: str):
    """The reference module ``<directory>/<name>.py``, loaded anew (as
    ``reference_<name>`` in ``sys.modules``, where ``dataclasses`` looks
    its module up)."""
    path = Path(directory) / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference module {path}")
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod
