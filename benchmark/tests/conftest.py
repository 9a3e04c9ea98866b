"""The benchmark's own tests: the harness's modules and the program on the
import path, and the tiny CPU copy of the benchmark that the tests run."""
from __future__ import annotations

import hashlib
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# the kind of each cell's traffic, and the tiny sizes its CPU copy runs at
TINY_CONFIG = {"h_dim": 16, "train_examples": 64, "test_examples": 40,
               "eval_batch_size": 16}
TINY_TRAFFIC = {"batch_size": 16, "samples": 10, "trace_epochs": 1,
                "trace_passes": 1}


def tiny_copy(dst: Path) -> dict:
    """A copy of the benchmark under ``dst`` with, beside every cell, a
    ``<cell>.tiny`` cell of the same configuration and traffic at tiny
    sizes (new files and new ``BENCHMARK.json`` entries only). Returns
    {cell: tiny cell}."""
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {}
    for w in list(bench["workloads"]):
        cfg_name, tr_name = f"{w['config']}.tiny", f"{w['traffic']}.tiny"
        cfg = json.loads((BENCH / "configs" / f"{w['config']}.json")
                         .read_text())
        (dst / "benchmark/configs" / f"{cfg_name}.json").write_text(
            json.dumps({**cfg, **TINY_CONFIG, "name": cfg_name}))
        if not any(c["name"] == cfg_name for c in bench["configs"]):
            bench["configs"].append({
                "name": cfg_name, "source": "tiny copy", "reduced": [],
                "file": f"benchmark/configs/{cfg_name}.json", "why": "test"})
        tr = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                        .read_text())
        (dst / "benchmark/traffic" / f"{tr_name}.json").write_text(
            json.dumps({**tr, **{k: v for k, v in TINY_TRAFFIC.items()
                                 if k in tr}}))
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                        .read_text())
        name = f"{w['name']}.tiny"
        (dst / "benchmark/workloads" / f"{name}.json").write_text(
            json.dumps({**wl, "config": cfg_name, "traffic": tr_name}))
        bench["workloads"].append({**w, "name": name, "config": cfg_name,
                                   "traffic": tr_name})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
        names[w["name"]] = name
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return names


def digests(root: Path) -> dict:
    """Each file under ``root`` (bytecode caches left out) -> its SHA-256."""
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    return root, tiny_copy(root)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the kernels exist only there")
    return torch.device("cuda", 0)
