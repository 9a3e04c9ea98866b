"""The port's matrix runner (``mvae_torch/matrix.py``) against the
reference's ``scripts/run_r5_matrix.py``: the same configurations,
settings, statuses and summary; rows patched by (tag, seed); one real row
on the CPU; and the comparison rule of ``scripts/torch_matrix_compare.py``.
"""
import argparse
import importlib.util
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mvae_torch.cli
import mvae_torch.data
from mvae_torch import matrix
from mvae_torch.data import ArrayDataset
from mvae_torch.train import NonFiniteError

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _load("run_r5_matrix", "scripts/run_r5_matrix.py")


@pytest.fixture(scope="module")
def cmp():
    return _load("torch_matrix_compare", "scripts/torch_matrix_compare.py")


def _args(**kw):
    base = dict(epochs=100, batch_size=256, ll_repeats=2,
                eval_binarize="fixed")
    return argparse.Namespace(**{**base, **kw})


def _ok(tag, seed, ll):
    return {"tag": tag, "seed": seed, "status": "OK",
            "test/log_likelihood_iwae": ll}


def test_configs_equal_the_reference(ref):
    assert matrix.CONFIGS == ref.CONFIGS
    assert len(matrix.CONFIGS) == 15
    assert matrix.SEED_SPREAD_FLAG_NATS == ref.SEED_SPREAD_FLAG_NATS


def test_flags_and_defaults_are_the_reference_runner_s():
    args = matrix.build_parser().parse_args([])
    assert (args.epochs, args.batch_size, args.ll_repeats,
            args.eval_binarize, args.seeds, args.only, args.summary_out) == (
        100, 256, 2, "fixed", "11", None, None)
    assert args.out == "RESULTS_torch_matrix.json"
    flags = {a.dest for a in matrix.build_parser()._actions} - {"help"}
    assert flags == {"epochs", "batch_size", "out", "summary_out",
                     "ll_repeats", "eval_binarize", "seeds", "only"}


_ROWS = {
    "five seeds": [_ok("e6/mnist", s, -299.5 + 0.07 * i)
                   for i, s in enumerate((11, 0, 7, 19, 23))],
    "NAN and FAIL rows": [
        _ok("e6/mnist", 11, -299.41), _ok("e6/mnist", 0, -299.93),
        {"tag": "e6/mnist", "seed": 7, "status": "NAN",
         "test/log_likelihood_iwae": None},
        {"tag": "h6/mnist", "seed": 11, "status": "FAIL ValueError",
         "error": "boom"},
        {"tag": "h6/mnist", "seed": 0, "status": "FAILED_NONFINITE",
         "nonfinite_epoch": 3, "last_finite_step": 700},
        _ok("h6/mnist", 7, -300.2)],
    "tags out of order, a wide spread": [
        _ok("p6/mnist", 0, -301.0), _ok("d6/mnist", 11, -299.9),
        _ok("p6/mnist", 11, -299.0), _ok("d6/mnist", 0, -299.95)],
    "no OK row": [{"tag": "e6/mnist", "seed": 11, "status": "FAIL X"}],
}


@pytest.mark.parametrize("case", sorted(_ROWS))
def test_summarize_matches_the_reference(ref, case):
    rows = _ROWS[case]
    assert matrix.summarize(rows) == ref.summarize(rows)


@pytest.mark.parametrize("obj", [
    {"a": float("nan"), "b": [1.0, float("inf"), (2, -float("inf"))],
     "c": {"d": "x", "e": 3}},
    [float("nan")], 1.5, "text", None])
def test_finite_or_none_matches_the_reference(ref, obj):
    ours = matrix.finite_or_none(obj)
    assert ours == ref.finite_or_none(obj)
    json.dumps(ours, allow_nan=False)


def test_row_args_are_the_reference_runner_s(monkeypatch):
    seen = []

    def fake(argv):
        seen.append(argv)
        return {"test/log_likelihood_iwae": -299.0, "device": "cpu",
                "history": [1]}
    monkeypatch.setattr(mvae_torch.cli, "main", fake)
    tag, cli_args = matrix.CONFIGS[7]
    row = matrix.run_row(tag, cli_args, 19, _args(ll_repeats=3))
    assert seen == [cli_args + [
        "--epochs", "100", "--batch_size", "256", "--burnin", "10",
        "--seed", "19", "--likelihood_n", "500", "--run_dir",
        "runs/torch_matrix/h2s2e2-learnK_mnist_s19", "--ll_repeats", "3",
        "--eval_binarize", "fixed"]]
    assert row["status"] == "OK" and "history" not in row
    assert row["routing_policy"] == "unknown" and row["card"] is None


def _raise(exc):
    def fake(argv):
        raise exc
    return fake


@pytest.mark.parametrize("fake, status", [
    (_raise(NonFiniteError(3, {"elbo": float("nan")}, 700)),
     "FAILED_NONFINITE"),
    (_raise(ValueError("bad spec")), "FAIL ValueError"),
    (lambda argv: {"test/log_likelihood_iwae": float("nan"),
                   "device": "cpu"}, "NAN"),
])
def test_row_status(monkeypatch, fake, status):
    monkeypatch.setattr(mvae_torch.cli, "main", fake)
    row = matrix.run_row("e6/mnist", matrix.CONFIGS[0][1], 11, _args())
    assert row["status"] == status
    assert (row["tag"], row["seed"]) == ("e6/mnist", 11)
    json.dumps(row, allow_nan=False)
    if status == "FAILED_NONFINITE":
        assert (row["nonfinite_epoch"], row["last_finite_step"]) == (3, 700)
    if status == "NAN":
        assert row["test/log_likelihood_iwae"] is None
    if status.startswith("FAIL "):
        assert row["error"] == "bad spec"


def test_rerun_replaces_its_row_and_keeps_the_others(tmp_path, monkeypatch):
    out = tmp_path / "m.json"
    old = [_ok("e6/mnist", 11, -1.0), _ok("e6/mnist", 0, -2.0),
           _ok("h6/mnist", 11, -3.0)]
    out.write_text(json.dumps(old))
    calls = []

    def fake_row(tag, cli_args, seed, args, extra=()):
        calls.append((tag, seed, args.epochs))
        return _ok(tag, seed, -9.0)
    monkeypatch.setattr(matrix, "run_row", fake_row)
    monkeypatch.setattr(matrix, "resolve_device", lambda: None)
    assert matrix.main(["--only", "e6", "--seeds", "11", "--epochs", "2",
                        "--out", str(out)]) == 0
    assert calls == [("e6/mnist", 11, 2)]
    rows = json.loads(out.read_text())
    got = {(r["tag"], r["seed"]): r["test/log_likelihood_iwae"]
           for r in rows}
    assert got == {("e6/mnist", 11): -9.0, ("e6/mnist", 0): -2.0,
                   ("h6/mnist", 11): -3.0}
    assert len(rows) == 3
    summary = json.loads((tmp_path / "m_summary.json").read_text())
    assert summary == matrix.summarize(rows)
    assert summary["e6/mnist"]["seeds"] == [0, 11]


def test_only_and_seeds_order_the_rows_as_the_reference(tmp_path,
                                                        monkeypatch):
    calls = []
    monkeypatch.setattr(matrix, "run_row", lambda tag, a, seed, args:
                        calls.append((tag, seed)) or _ok(tag, seed, -1.0))
    monkeypatch.setattr(matrix, "resolve_device", lambda: None)
    matrix.main(["--only", "d6,h2s2e2-learnK/mnist", "--seeds", "0,7",
                 "--out", str(tmp_path / "m.json"), "--summary_out",
                 str(tmp_path / "s.json")])
    assert calls == [(t, s) for s in (0, 7) for t in (
        "d6/mnist", "h2s2e2-learnK/mnist", "d6-riemannian/mnist")]
    assert (tmp_path / "s.json").exists()


def test_main_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the matrix would run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        matrix.main(["--out", str(tmp_path / "m.json")])
    assert not (tmp_path / "m.json").exists()


def test_one_real_row_on_the_cpu(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    ds = ArrayDataset("toy", (rng.random((64, 16)) > 0.5).astype(np.float32),
                      (rng.random((24, 16)) > 0.5).astype(np.float32),
                      (16,), True)
    monkeypatch.setattr(mvae_torch.data, "load_dataset", lambda name: ds)
    tag, cli_args = matrix.CONFIGS[7]
    row = matrix.run_row(tag, cli_args, 11,
                         _args(epochs=1, batch_size=16, ll_repeats=1),
                         extra=("--device", "cpu", "--h_dim", "16"),
                         run_root=str(tmp_path))
    assert row["status"] == "OK", row
    assert math.isfinite(row["test/log_likelihood_iwae"])
    assert row["device"] == "cpu" and row["card"] is None
    assert row["graph_path"]["path"] == "eager"
    assert row["graph_captures"] == {}
    assert row["fused_paths"]["train_tail"]["active"]
    assert row["train_steps_per_sec"] > 0 and row["wall_s"] >= 0
    saved = json.loads((tmp_path / "h2s2e2-learnK_mnist_s11" /
                        "result.json").read_text())
    assert saved["test/log_likelihood_iwae"] == row[
        "test/log_likelihood_iwae"]


def test_the_isolation_probe_walks_the_matrix_module():
    probe = ("import pkgutil, sys, mvae_torch; "
             "names = [m.name for m in pkgutil.walk_packages("
             "mvae_torch.__path__, 'mvae_torch.')]; "
             "import mvae_torch.matrix; "
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'mvae_tpu')]; "
             "print('mvae_torch.matrix' in names, bad)")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "[]"]


def _summary(mean, std, n=5):
    return {"n_seeds": n, "ll_mean": mean, "ll_std": std}


@pytest.mark.parametrize("port, ref, verdict", [
    (_summary(-299.60, 0.15), _summary(-299.504, 0.148), "agree"),
    (_summary(-299.90, 0.15), _summary(-299.504, 0.148), "differ"),
    (_summary(-301.464 + 0.70, 0.40), _summary(-301.464, 0.396), "agree"),
    (_summary(-301.464 + 0.80, 0.40), _summary(-301.464, 0.396), "differ"),
    (_summary(-299.5, 0.1, n=4), _summary(-299.5, 0.1), "incomplete"),
    (None, _summary(-299.5, 0.1), "incomplete"),
])
def test_comparison_rule(cmp, port, ref, verdict):
    rows = cmp.compare({} if port is None else {"t": port}, {"t": ref},
                       ["t"])
    assert rows[0]["verdict"] == verdict
    if verdict != "incomplete":
        b = 3 * math.sqrt((port["ll_std"] ** 2 + ref["ll_std"] ** 2) / 5)
        assert rows[0]["bound"] == pytest.approx(b)
        assert rows[0]["diff"] == pytest.approx(port["ll_mean"]
                                                - ref["ll_mean"])


def test_comparison_bounds_of_the_issue_s_rows(cmp):
    # e6's reference spread with an equal port spread: about 0.29 nats; the
    # conv CIFAR row's: about 2.1
    ref = json.loads((ROOT / "RESULTS_r5_matrix_summary.json").read_text())
    e6, conv = ref["e6/mnist"]["ll_std"], ref["u6-learnK-conv/cifar"]["ll_std"]
    assert cmp.bound(e6, e6) == pytest.approx(0.29, abs=0.03)
    assert cmp.bound(conv, conv) == pytest.approx(2.1, abs=0.3)


def test_compare_script_prints_every_configuration(tmp_path, cmp, capsys):
    ref = json.loads((ROOT / "RESULTS_r5_matrix_summary.json").read_text())
    port = {t: dict(v) for t, v in ref.items() if t != "h4/bdp"}
    (tmp_path / "p.json").write_text(json.dumps(port))
    assert cmp.main(["--port", str(tmp_path / "p.json"),
                     "--rows", str(tmp_path / "none.json")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 + 15 + 1
    assert lines[-1] == "14 agree, 0 differ, 1 incomplete of 15"
    assert [ln.split(" | ")[0][2:] for ln in lines[2:17]] == [
        t for t, _ in matrix.CONFIGS]


def test_compare_script_rates_table(cmp, capsys):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    graph = {"path": "graph", "why": "-"}
    caps = {"train_step": 1, "eval_elbo": 1, "eval_ll": 1}
    rows = [{**_ok("e6/mnist", s, -299.0), "train_steps_per_sec": sps,
             "wall_s": w, "graph_path": graph, "graph_captures": caps,
             "card": card} for s, sps, w in ((11, 2000.0, 20.0),
                                             (0, 2100.5, 15.5))]
    rows.append({"tag": "e6/mnist", "seed": 7, "status": "FAIL X",
                 "wall_s": 1.0})
    cmp.rates(rows, ["e6/mnist", "h6/mnist"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[2] == (
        "| e6/mnist | 1 FAIL X, 2 OK | 2000.0-2100.5 | 1.0-20.0 | 36.5 | "
        'None null; graph {"train_step": 1, "eval_elbo": 1, "eval_ll": 1} '
        f"| {card}; None |")
    assert lines[3] == "| h6/mnist | none | - | - | 0.0 |  |  |"


def test_graph_captures_count_each_program_kind():
    from types import SimpleNamespace

    from mvae_torch.train import graphs
    progs = {("train_step", (784,)): SimpleNamespace(captures=1),
             ("eval_elbo", (512, 784)): SimpleNamespace(captures=1),
             ("eval_ll", (512, 784)): SimpleNamespace(captures=1),
             ("eval_ll", (24, 784)): SimpleNamespace(captures=1),
             ("eval_ll", (8, 784)): SimpleNamespace(captures=0)}
    assert graphs.captures(SimpleNamespace(_programs=progs)) == {
        "train_step": 1, "eval_elbo": 1, "eval_ll": 2}
    assert graphs.captures(SimpleNamespace(_programs={})) == {}
