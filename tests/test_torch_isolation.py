"""The port stands alone: importing every mvae_torch module, its CLI and
chip_smoke.py loads neither JAX nor the JAX package; and an entry point
asked for no device on a machine without CUDA raises instead of running
on the CPU."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import mvae_torch
names = [m.name for m in pkgutil.walk_packages(mvae_torch.__path__,
                                               "mvae_torch.")]
for name in names:
    importlib.import_module(name)
import mvae_torch.cli
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mvae_tpu"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 25
    assert bad == "[]"


def test_trainer_without_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from mvae_torch import TrainConfig, Trainer, VAEConfig, parse_components
    from mvae_torch.data import ArrayDataset
    ds = ArrayDataset("toy", np.zeros((4, 8), np.float32),
                      np.zeros((4, 8), np.float32), (8,), True)
    cfg = VAEConfig(parse_components("e2"), (8,), h_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, ds, TrainConfig())
