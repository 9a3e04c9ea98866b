"""BENCHMARK.json and the files it names: found by name, within the
contract's limits, and extended by new files alone."""
from __future__ import annotations

import json
import re

import run
from conftest import BENCH, ROOT, digests, tiny_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_names_and_units():
    b = bench()
    assert set(b) == KEYS
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    entries = (b["configs"] + b["workloads"] + b["end_to_end"]
               + b["per_layer"])
    names = [e["name"] for e in entries]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in b[group]]
        assert len(set(group_names)) == len(group_names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_reports_setup_a_rate_and_a_layer():
    b = bench()
    for w in b["workloads"]:
        def reports(m):
            return "workloads" not in m or w["name"] in m["workloads"]
        e2e = [m["name"] for m in b["end_to_end"] if reports(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(reports(m) for m in b["per_layer"]), w["name"]
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_file_is_found_by_name():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = run.find_cell(ROOT, w["name"])
        assert (cell["workload"]["config"], cell["workload"]["traffic"]) == (
            w["config"], w["traffic"])
        rate = cell["traffic"]["rate_metric"]
        assert w["name"] in e2e[rate]["workloads"]
        assert set(cell["workload"]["limits"])
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "benchmark/")
        assert c["reduced"] == []
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_every_metric_reader_is_found_by_name():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        assert path.is_file(), path
        assert "def read(ctx)" in path.read_text()
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved["workloads"], (m["name"], w)
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["source"] == "device_trace"


def test_new_cell_config_and_metric_need_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric as new files and new BENCHMARK.json entries; a
    run of the new cell finds all of them, and no file that was there
    changed but BENCHMARK.json."""
    import programs
    names = tiny_copy(tmp_path)
    before = digests(tmp_path)
    (tmp_path / "benchmark/metrics/steps_seen.train.py").write_text(
        "def read(ctx):\n    return float(ctx['units'] * ctx['steps_per_unit'])\n")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = names["h2s2e2.train_b1024"]
    b["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "programs",
                           "moves": "train_examples_per_s",
                           "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    r = run.run_cell(cell, 3, 0.1, True, "cpu", root=tmp_path,
                     programs=programs)
    assert r["correct"]
    assert r["metrics"]["steps_seen.train"]["value"] > 0
    after = digests(tmp_path)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {p for p in before if p.name == "BENCHMARK.json"}
