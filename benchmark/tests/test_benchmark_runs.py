"""Whole runs of every cell on the CPU at tiny sizes (the program's plain
versions, eagerly): the result line, the comparison with the reference,
and the comparison failing under each fault a cell can have."""
from __future__ import annotations

import json

import pytest
import torch

import run
from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 1234


@pytest.fixture(scope="module")
def programs():
    import programs
    return programs


def one_run(tiny, programs, cell, trace=False, seed=SEED):
    root, names = tiny
    return run.run_cell(names[cell], seed, 0.1, trace, "cpu", root=root,
                        programs=programs)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cpu_run_gives_the_result_line(tiny, programs, cell, trace):
    r = one_run(tiny, programs, cell, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    dev = r["device"]
    assert dev["platform"] == "cpu"
    assert dev["kind"] is None and dev["memory_peak_bytes"] is None
    assert "busy_s" not in dev
    assert all(m["value"] is None for m in r["metrics"].values())
    assert bool(r["metrics"]) != trace
    json.loads(json.dumps(r))


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""


def test_a_checkout_without_the_program_is_refused(tmp_path):
    with pytest.raises(run.Refused) as e:
        run.import_program(tmp_path)
    assert e.value.code == 3


# Each planting returns its count of calls (a one-item list), which the
# test holds above 0: a planting whose target the program no longer calls
# fails the test instead of planting nothing.


def _adam_does_nothing(monkeypatch):
    """The trainer's optimizer (``optim.Adam``) steps without updating
    anything: no state, no moments, no hooks."""
    from mvae_torch.train import optim
    calls = [0]

    def step(self):
        calls[0] += 1
    monkeypatch.setattr(optim.Adam, "step", step)
    return calls


def _half_batch_loss(monkeypatch):
    from mvae_torch.models import vae
    loss_fn = vae.loss_fn
    calls = [0]

    def half(cfg, params, x, beta=1.0, noise=None, generator=None,
             mesh=None):
        calls[0] += 1
        k = x.shape[0] // 2
        return loss_fn(cfg, params, x[:k], beta,
                       None if noise is None else noise[:k], generator, mesh)
    monkeypatch.setattr(vae, "loss_fn", half)
    return calls


def _answer_altered(monkeypatch):
    from mvae_torch.models import vae
    ll = vae.log_likelihood
    calls = [0]

    def altered(*args, **kwargs):
        calls[0] += 1
        out = ll(*args, **kwargs).clone()
        out[0] += 1.0
        return out
    monkeypatch.setattr(vae, "log_likelihood", altered)
    return calls


def _half_batch_answers(monkeypatch):
    from mvae_torch.models import vae
    ll = vae.log_likelihood
    calls = [0]

    def half(cfg, params, x, n_samples=500, chunk_size=20, noise=None,
             generator=None):
        calls[0] += 1
        k = x.shape[0] // 2
        out = ll(cfg, params, x[:k], n_samples, chunk_size,
                 None if noise is None else noise[:, :k], generator)
        return torch.cat([out, out[:x.shape[0] - k]])
    monkeypatch.setattr(vae, "log_likelihood", half)
    return calls


FAULTS = {"train": [_adam_does_nothing, _half_batch_loss],
          "iwae": [_answer_altered, _half_batch_answers]}


@pytest.mark.parametrize("fault", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, programs, monkeypatch,
                                            cell, fault):
    kind = "train" if ".train" in cell else "iwae"
    calls = FAULTS[kind][fault](monkeypatch)
    r = one_run(tiny, programs, cell)
    assert calls[0] > 0, "the planted fault never ran"
    assert not r["correct"], r["checks"]


def _replays_leave_the_state_unchanged(monkeypatch):
    """The step's graph captured without Adam's update (``optim.Adam``, the
    trainer's optimizer): the eager steps before the capture update, every
    replay leaves the parameters and Adam's state as they were. Returns the
    count of steps left out while capturing."""
    from mvae_torch.train import graphs, optim
    capture = graphs.Graphed._capture
    calls = [0]

    def no_step(self):
        calls[0] += 1

    def without_update(self):
        step = optim.Adam.step
        monkeypatch.setattr(optim.Adam, "step", no_step)
        try:
            capture(self)
        finally:
            monkeypatch.setattr(optim.Adam, "step", step)
    monkeypatch.setattr(graphs.Graphed, "_capture", without_update)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS if ".train" in c])
def test_a_fault_in_the_replays_alone_is_not_correct(tiny, programs, card,
                                                     monkeypatch, cell):
    """On the card the window replays the step's graph: a fault that only
    the replays have is caught, and a sound run is correct."""
    root, names = tiny
    r = run.run_cell(names[cell], SEED, 0.1, False, card, root=root,
                     programs=programs)
    assert r["correct"], r["checks"]
    calls = _replays_leave_the_state_unchanged(monkeypatch)
    r = run.run_cell(names[cell], SEED, 0.1, False, card, root=root,
                     programs=programs)
    assert calls[0] > 0, "no step was captured without its update"
    assert not r["correct"], r["checks"]
    assert r["checks"]["change_median_gap"]["value"] > 0.5, r["checks"]
