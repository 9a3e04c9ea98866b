"""The layer-span readers on made-up device operations: units cut at the
program's marker kernels, the markers' own time and the gap after each left
out, units cut by the window's edges left out, and each new metric's
reader on such a trace and on the CPU, where it reads None."""
from __future__ import annotations

import importlib.util

import pytest

import layerspans
from conftest import BENCH

US = 1000


def op(name, s, e):
    return (name, s * US, e * US)


def mk(layer, s):
    return op(f"mvae_span_{layer}", s, s + 1)


def step(t0):
    """One training step from t0 (us): 9 markers, 1 us each, and
    operations 2 us after each marker; the optimizer's Adam kernel 20 us."""
    return [mk("encode", t0), op("gather", t0 + 3, t0 + 10),
            op("gemm", t0 + 12, t0 + 30),
            mk("tail", t0 + 33), op("tail_fwd_kernel", t0 + 36, t0 + 40),
            mk("decode", t0 + 42), op("train_decode_kernel", t0 + 45,
                                      t0 + 60),
            mk("loss", t0 + 62), op("reduce", t0 + 65, t0 + 66),
            mk("bwd_decode", t0 + 68), op("bwd", t0 + 71, t0 + 80),
            mk("bwd_tail", t0 + 82), op("tail_bwd_kernel", t0 + 85, t0 + 90),
            mk("bwd_encode", t0 + 92), op("gemm_bwd", t0 + 95, t0 + 100),
            mk("optimizer", t0 + 102), op("mask", t0 + 105, t0 + 106),
            op("multi_tensor_apply_kernel", t0 + 108, t0 + 128),
            mk("end", t0 + 131)]


def test_a_unit_is_cut_at_its_markers_and_leaves_their_overhead_out():
    (u,) = layerspans.units(step(0))
    names = [l["layer"] for l in u["layers"]]
    assert names == ["encode", "tail", "decode", "loss", "bwd_decode",
                     "bwd_tail", "bwd_encode", "optimizer"]
    enc = u["layers"][0]
    # from the first operation after its marker to the next marker
    assert (enc["start"], enc["end"]) == (3 * US, 33 * US)
    assert enc["busy"] == 25 * US and enc["ops"] == 2
    opt = u["layers"][-1]
    # the last layer ends with its last operation, not at the end marker
    assert (opt["start"], opt["end"]) == (105 * US, 128 * US)
    assert opt["busy"] == 21 * US
    assert u["interval"] == sum(l["end"] - l["start"] for l in u["layers"])
    assert u["interval"] == (128 - 3 - 7 * 3) * US   # a marker + gap: 3 us
    assert u["ops"] == 10


def test_units_cut_by_the_window_are_left_out():
    ops = step(0) + step(200) + step(400)
    assert len(layerspans.units(ops)) == 3
    head = [o for o in ops if o[1] >= 50 * US]        # starts mid-unit
    tail = [o for o in ops if o[1] < 500 * US]        # ends before `end`
    assert len(layerspans.units(head)) == 2
    assert len(layerspans.units(tail)) == 2
    # a unit opened again before its end is dropped
    again = step(0)[:5] + step(200)
    assert len(layerspans.units(again)) == 1
    assert layerspans.units([op("gemm", 0, 5)]) == []


def test_an_empty_layer_has_no_interval():
    ops = [mk("encode", 0), op("a", 3, 5), mk("reparam", 6),
           mk("decode", 8), op("b", 11, 20), mk("end", 21)]
    (u,) = layerspans.units(ops)
    rep = u["layers"][1]
    assert rep["end"] - rep["start"] == 0 and rep["ops"] == 0
    assert layerspans.layer_time([u], "decode") == 9 * US


def test_gap_share_counts_the_idle_time_inside_units():
    us = layerspans.units(step(0) + step(200))
    busy = sum(u["busy"] for u in us)
    total = sum(u["interval"] for u in us)
    assert layerspans.gap_pct(us) == pytest.approx(100 * (total - busy) /
                                                   total)
    assert layerspans.gap_pct([]) is None


def test_issue_idle_counts_long_gaps_under_the_program_spans():
    merged = [[0, 100 * US], [150 * US, 160 * US], [165 * US, 300 * US]]
    summary = {"span": (0, 400 * US), "merged": merged}
    spans = [("graph.replay", 90 * US, 140 * US, "epoch.replays"),
             ("epoch.stats_read", 300 * US, 350 * US, None),
             ("benchmark.epoch_draws", 350 * US, 400 * US, None),
             ("graph.replay", 155 * US, 170 * US, None)]   # a 5 us gap
    got = layerspans.issue_idle_pct(summary, spans, ("epoch.", "graph."))
    # 40 us of the 100..150 gap and 50 of the 300..400 gap, over 400
    assert got == pytest.approx(100 * 90 / 400)
    assert layerspans.issue_idle_pct(summary, spans, ("iwae.read",)) is None


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


NEW = ["graph_gap_pct.train", "graph_gap_pct.iwae",
       "optimizer_us_per_step.train", "reparam_share_pct.iwae",
       "issue_idle_pct.train", "issue_idle_pct.iwae"]


def ctx(program, ops, span=None):
    merged = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    trace = {"ops": ops, "merged": merged,
             "span": span or (0, max(e for _, _, e in ops) + 10 * US)}
    return {"program": program, "trace": trace}


def batch(t0, chunks=2):
    ops = [mk("encode", t0), op("gemm", t0 + 3, t0 + 10)]
    t = t0 + 12
    for _ in range(chunks):
        ops += [mk("reparam", t), op("elementwise", t + 3, t + 23),
                mk("decode", t + 25), op("decode_bce_kernel", t + 28,
                                         t + 88)]
        t += 90
    return ops + [mk("logsumexp", t), op("reduce", t + 3, t + 8),
                  mk("end", t + 10)]


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_none_on_the_cpu(name):
    program = name.split(".")[-1]
    assert reader(name)({"program": program, "trace": None}) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_none_without_markers_or_spans(name, monkeypatch):
    monkeypatch.setattr(layerspans, "program_host_spans", lambda: None)
    program = name.split(".")[-1]
    assert reader(name)(ctx(program, [op("gemm", 0, 5)])) is None


def test_readers_of_the_training_step():
    c = ctx("train", step(0) + step(200))
    steps = layerspans.units(c["trace"]["ops"])
    assert reader("graph_gap_pct.train")(c) == pytest.approx(
        layerspans.gap_pct(steps))
    # the optimizer layer: 23 us a step, Adam's 20 us inside it
    assert reader("optimizer_us_per_step.train")(c) == pytest.approx(23.0)
    assert reader("graph_gap_pct.iwae")(c) is None


def test_readers_of_the_iwae_batch(monkeypatch):
    c = ctx("iwae", batch(0) + batch(300))
    assert reader("reparam_share_pct.iwae")(c) == pytest.approx(
        100 * 2 * 22 / (9 + 2 * (22 + 62) + 5))
    assert 0 < reader("graph_gap_pct.iwae")(c) < 100
    spans = [("graph.replay", 0, 500 * US, None)]
    monkeypatch.setattr(layerspans, "program_host_spans", lambda: spans)
    assert reader("issue_idle_pct.iwae")(c) == pytest.approx(
        layerspans.issue_idle_pct(c["trace"], spans, ("graph.",)))
    assert reader("issue_idle_pct.train")(c) is None


def test_program_host_spans_are_read_as_data():
    from mvae_torch.utils import profiling
    profiling.clear_host_spans()
    assert layerspans.program_host_spans() == []
