"""The plain reference against the program's plain path, and the control:
the reference in TF32 in the program's place, and the program in
bfloat16, each failing the cell's limits."""
from __future__ import annotations

import json

import pytest
import torch

import control
import run
from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_plain_program(tiny, cell):
    """A sound run reads well inside the limits: under half of each."""
    import programs
    root, names = tiny
    r = run.run_cell(names[cell], 77, 0.1, False, "cpu", root=root,
                     programs=programs)
    for k, c in r["checks"].items():
        assert c["value"] < 0.5 * c["limit"], (k, c)


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails(tiny, cell):
    root, names = tiny
    c = run.find_cell(root, names[cell])
    limits = c["workload"]["limits"]
    for seed in (3, 2**31 + 3):
        rows = control.READINGS[c["traffic"]["program"]](
            c, seed, torch.device("cpu"), {"control"})
        assert any(rows["control"][k] > limits[k] for k in limits), rows


@pytest.mark.parametrize("cell", CELLS)
def test_program_in_bfloat16_fails(tiny, monkeypatch, cell):
    """The program's own bfloat16 switch (``MVAE_BF16_MATMUL``: the linear
    layers' operands rounded to bfloat16) on."""
    import programs
    from mvae_torch.models import nets
    root, names = tiny
    monkeypatch.setattr(nets, "_BF16_MATMUL", True)
    r = run.run_cell(names[cell], 5, 0.1, False, "cpu", root=root,
                     programs=programs)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(tiny, card, cell):
    """On the card at tiny sizes: the program passes, the reference in TF32
    (the card's own switch) in its place does not."""
    import programs
    root, names = tiny
    r = run.run_cell(names[cell], 9, 0.1, False, card, root=root,
                     programs=programs)
    assert r["correct"], r["checks"]
    c = run.find_cell(root, names[cell])
    rows = control.READINGS[c["traffic"]["program"]](c, 9, card, {"control"})
    limits = c["workload"]["limits"]
    assert any(rows["control"][k] > limits[k] for k in limits), rows
