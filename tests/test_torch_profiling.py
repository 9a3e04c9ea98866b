"""The port's tracing and NaN/Inf guard (``mvae_torch.utils.profiling``),
and the CLI flags and ``Trainer.fit`` option that use them, on the CPU.

The guard is the counterpart of the reference's ``jax_debug_nans`` +
``jax_debug_infs``: with it on, the first op whose floating output holds a
NaN or an Inf raises ``FloatingPointError`` naming the op, in a forward and
in a backward; the kernel wrappers, which ctypes takes past the dispatcher,
check their outputs themselves (``check_outputs``). A healthy run of the
flagship trains under it unchanged (the CLI case).
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from mvae_torch import cli
from mvae_torch.components import parse_components
from mvae_torch.data import ArrayDataset
from mvae_torch.models import vae as tvae
from mvae_torch.train import TrainConfig, Trainer
from mvae_torch.utils import profiling

D = 24


@pytest.fixture
def guard():
    profiling.enable_nan_guard()
    try:
        yield
    finally:
        profiling.disable_nan_guard()


def _toy():
    rng = np.random.default_rng(0)
    x = (rng.uniform(size=(32, D)) > 0.5).astype(np.float32) * 0.8
    return ArrayDataset("toy", x, x[:16].copy(), (D,), True)


def _trainer(run_dir, **tc):
    cfg = tvae.VAEConfig(parse_components("h2,s2,e2", fixed_curvature=False),
                         (D,), h_dim=16)
    tc = {"batch_size": 16, "eval_batch_size": 16, "likelihood_n": 4,
          "burnin_epochs": 0, "seed": 1, "epochs": 2, **tc}
    return Trainer(cfg, _toy(), TrainConfig(**tc), run_dir=str(run_dir),
                   device="cpu")


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "prof"), device="cpu"):
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    files = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    assert len(files) == 1
    names = {e.get("name", "") for e in _events(files[0])}
    assert any("aten::mm" in n for n in names)


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path), device="cpu"):
            torch.ones(3).sum()
            raise ZeroDivisionError
    assert len(glob.glob(str(tmp_path / "trace_*.json"))) == 1


def test_guard_raises_on_a_nan_in_a_forward(guard):
    x = torch.tensor([1.0, -1.0])
    with pytest.raises(FloatingPointError, match="aten.log"):
        torch.log(x)
    with pytest.raises(FloatingPointError, match="aten.div"):
        torch.ones(2) / torch.zeros(2)
    assert torch.equal(torch.exp(torch.zeros(2)), torch.ones(2))


class _NanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2.0

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def test_guard_raises_on_a_nan_in_a_backward(guard):
    x = torch.ones(3, requires_grad=True)
    y = _NanGrad.apply(x).sum()          # a finite forward
    with pytest.raises((FloatingPointError, RuntimeError),
                       match="aten.mul|NanGradBackward|nan"):
        y.backward()


def test_guard_raises_on_an_inf_gradient(guard):
    x = torch.zeros(1, requires_grad=True)
    y = torch.sqrt(x).sum()              # 0: finite
    with pytest.raises(FloatingPointError):
        y.backward()                     # d sqrt / dx at 0 is inf


def test_guard_off_lets_nan_through_and_is_idempotent():
    assert not profiling._GUARD
    assert bool(torch.isnan(torch.log(torch.tensor(-1.0))))
    profiling.enable_nan_guard()
    profiling.enable_nan_guard()
    assert bool(profiling._GUARD)
    profiling.disable_nan_guard()
    profiling.disable_nan_guard()
    assert not profiling._GUARD
    assert not torch.is_anomaly_enabled()
    assert bool(torch.isnan(torch.log(torch.tensor(-1.0))))


def test_check_outputs_only_with_the_guard_on():
    bad = torch.tensor([0.0, float("inf")])
    profiling.check_outputs("tail_fwd", bad)
    profiling.enable_nan_guard()
    try:
        with pytest.raises(FloatingPointError, match="kernel tail_fwd"):
            profiling.check_outputs("tail_fwd", torch.ones(2), bad)
        profiling.check_outputs("tail_fwd", torch.ones(2))
    finally:
        profiling.disable_nan_guard()


def test_guard_ignores_uninitialized_buffers_and_views(guard):
    buf = torch.empty(4, 8)
    view = buf[:, 2:5]                   # a view of uninitialized memory
    view.copy_(torch.ones(4, 3))
    assert torch.equal(view, torch.ones(4, 3))


def test_guard_names_the_op_of_a_poisoned_training_step(tmp_path):
    tr = _trainer(tmp_path)
    with torch.no_grad():
        tr.params["encoder"]["layers"][0]["w"][0, 0] = float("nan")
    profiling.enable_nan_guard()
    try:
        with pytest.raises(FloatingPointError, match="non-finite"):
            tr.train_one_epoch(0)
    finally:
        profiling.disable_nan_guard()


@pytest.mark.parametrize("epochs", [0, 1])
def test_fit_traces_the_first_epochs(tmp_path, epochs):
    tr = _trainer(tmp_path)
    tr.fit(verbose=False, profile_epochs=epochs)
    files = glob.glob(str(tmp_path / "profile" / "trace_*.json"))
    assert len(files) == epochs
    if epochs:
        names = {e.get("name", "") for e in _events(files[0])}
        assert any("aten::addmm" in n or "aten::mm" in n for n in names)


def test_cli_debug_nans_and_profile_epochs(tmp_path, monkeypatch, capsys):
    calls = []
    enable = profiling.enable_nan_guard

    def spy():
        calls.append(torch.is_anomaly_enabled())
        enable()
        calls.append(bool(profiling._GUARD))

    monkeypatch.setattr(profiling, "enable_nan_guard", spy)
    args = cli.build_parser().parse_args(["--debug_nans", "--profile_epochs",
                                          "2"])
    assert args.debug_nans and args.profile_epochs == 2
    run = str(tmp_path / "run")
    result = cli.main(["--dataset", "bdp", "--model", "h2,s2,e2", "--h_dim",
                       "16", "--likelihood_n", "4", "--ll_max_examples",
                       "16", "--device", "cpu", "--run_dir", run,
                       "--fixed_curvature", "false", "--epochs", "1",
                       "--burnin", "0", "--debug_nans", "--profile_epochs",
                       "1"])
    assert calls == [False, True]            # the guard was on for the run
    assert not profiling._GUARD  # and is off after it
    assert np.isfinite(result["test/log_likelihood_iwae"])
    assert len(glob.glob(os.path.join(run, "profile", "trace_*.json"))) == 1
    assert "test/log_likelihood_iwae" in capsys.readouterr().out
