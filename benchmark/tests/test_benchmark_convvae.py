"""The conv VAE's configuration and its reference module
(``reference/convvae.py``): what it loads, its work counts against hand
counts and against PyTorch's count of the program's plain step, and the
conv layers' roofline read from a made-up trace. The cell's whole CPU runs
and its faults are ``test_benchmark_runs.py``'s, over every cell."""
from __future__ import annotations

import importlib.util
import json
import math

import pytest
from torch.utils.flop_counter import FlopCounterMode

import generate
import reference
import work
from conftest import BENCH
from test_benchmark_imports import loaded

CELL = "u6conv.train_b128"
US = 1000


def config() -> dict:
    return json.loads((BENCH / "configs/u6conv-cifar.json").read_text())


@pytest.fixture(scope="module")
def ref():
    return reference.load(BENCH / "reference", "convvae")


def test_reference_loads_nothing_of_the_program():
    mods = loaded("import reference, pathlib; reference.load(pathlib.Path("
                  "reference.__file__).parent, 'convvae')")
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "mvae_tpu", "mvae_torch"}


def test_counts_at_batch_128_equal_hand_counts(ref):
    cfg = config()
    lats = ref.parse_spec(cfg["spec"])
    # forward multiply-adds an example: output pixels x taps x channels
    conv1 = 16 * 16 * 64 * (4 * 4 * 3)
    conv2 = 8 * 8 * 128 * (4 * 4 * 64)
    deconv1 = 8 * 8 * 128 * (4 * 4 * 64)     # input pixels x taps x ...
    deconv2 = 16 * 16 * 64 * (4 * 4 * 3)
    assert (conv1, conv2, deconv1, deconv2) == (786432, 8388608, 8388608,
                                                786432)
    fc, heads, fc1, fc2 = 8192 * 400, 400 * 12, 6 * 400, 400 * 8192
    forward = conv1 + conv2 + fc + heads + fc1 + fc2 + deconv1 + deconv2
    assert forward == 24910880
    n_params = 6838352
    counts = ref.work(cfg, lats, {"batch_size": 128, "samples": 500})
    step = counts["train_step"]
    assert step["gemm_macs"] == 3 * 128 * forward == 9565777920
    assert step["executed_macs"] == 3 * 128 * forward - 128 * conv1
    acts = 2 * 3072 + 2 * 16384 + 2 * 8192 + 2 * 400
    assert step["bytes"] == 4 * (8 * n_params + 2 * 128 * acts)
    # the convs: forward, weight gradient and (but conv1) data gradient
    assert counts["conv_step"]["flops"] == 2 * 128 * (
        2 * conv1 + 3 * conv2 + 3 * deconv1 + 3 * deconv2) == 13891534848
    # each product: the batch's input and output activations and the kernel
    words = (2 * (128 * (3072 + 16384) + 3072)
             + 3 * (128 * (16384 + 8192) + 131072)
             + 3 * (128 * (8192 + 16384) + 131072)
             + 3 * (128 * (16384 + 3072) + 3072))
    assert counts["conv_step"]["bytes"] == 4 * words == 128512000
    assert counts["iwae_example_flops"] == 2 * (
        conv1 + conv2 + fc + heads + 500 * (fc1 + fc2 + deconv1 + deconv2))
    iw = ref.work(cfg, lats, {"samples": 500})
    assert iw["train_step"] is None and iw["conv_step"] is None
    shapes = ref.param_shapes(lats, cfg)
    assert len(shapes) == 19
    assert sum(math.prod(s) for s in shapes.values()) == n_params


def test_train_step_count_equals_the_flop_counter(ref):
    """The program's plain conv step (CPU tensors) at a small size executes
    exactly ``train_step``'s products: the convs' (conv1 with no data
    gradient) and the fc GEMMs'."""
    import programs
    cfg = {**config(), "data_shape": [8, 8, 3], "h_dim": 24,
           "train_examples": 32, "test_examples": 8}
    traffic = {"batch_size": 8}
    train, test = generate.dataset(cfg, 5, "cpu")
    tr = programs.build(cfg, traffic, 5, train, test, "cpu", "unused")
    perm, u, nz = generate.train_draws(ref, cfg, traffic, 5, 0, "cpu")
    assert u is None
    with FlopCounterMode(display=False) as counter:
        tr._step_body(train[perm[0]], None, nz[0])
    lats = ref.parse_spec(cfg["spec"])
    n_params = sum(t.numel() for t in programs.flatten(tr.params).values())
    expect = ref.work(cfg, lats, traffic)["train_step"]["executed_macs"]
    assert n_params == sum(math.prod(s) for s in ref.param_shapes(
        lats, cfg).values())
    assert counter.get_total_flops() == 2 * expect


def op(name, s, e):
    return (name, s * US, e * US)


def mk(layer, s):
    return op(f"mvae_span_{layer}", s, s + 1)


def conv_step(t0):
    """A conv training step from t0 (us): the conv layers' operations
    10 + 8 + 12 + 10 us long, the others 2 us, 1 us markers, 2 us gaps."""
    layers = [("encode", 10), ("encode_fc", 2), ("tail", 2), ("decode", 2),
              ("decode_conv", 8), ("loss", 2), ("bwd_decode", 12),
              ("bwd_decode_fc", 2), ("bwd_tail", 2), ("bwd_encode", 2),
              ("bwd_encode_conv", 10), ("optimizer", 2)]
    ops, t = [], t0
    for layer, length in layers:
        ops += [mk(layer, t), op("k", t + 3, t + 3 + length)]
        t += 3 + length
    return ops + [mk("end", t)]


def read_metric(name, ctx):
    spec = importlib.util.spec_from_file_location(
        "metric", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def test_conv_roofline_reads_the_conv_layers():
    """Least time 2 us (330 MFLOP at 165 TFLOP/s; the bytes take 0.1 us)
    over 10 + 8 + 12 + 10 = 40 us a step: 5%."""
    peaks = {"float32_grade_tflops": 165, "hbm_tbps": 3.35}
    ctx = {"program": "train", "work": work, "peaks": peaks,
           "model_work": {"conv_step": {"flops": 330_000_000,
                                        "bytes": 335_000}},
           "trace": {"ops": conv_step(0) + conv_step(200)}}
    assert read_metric("conv_roofline.train", ctx) == pytest.approx(5.0)
    # a step without the conv layers' markers (the MLP's, or a program
    # without them) reads nothing
    mlp = [mk(l, 10 * i) for i, l in enumerate(
        ["encode", "tail", "decode", "loss", "bwd_decode", "bwd_tail",
         "bwd_encode", "optimizer", "end"])]
    assert read_metric("conv_roofline.train", {**ctx, "trace": {
        "ops": mlp}}) is None
    assert read_metric("conv_roofline.train", {**ctx, "trace": None}) is None
    assert read_metric("conv_roofline.train", {
        **ctx, "model_work": {"train_step": None}}) is None


def test_the_cell_is_in_the_benchmark():
    b = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    w = next(w for w in b["workloads"] if w["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("u6conv-cifar",
                                                       "train_b128", 1)
    c = next(c for c in b["configs"] if c["name"] == "u6conv-cifar")
    assert c["reduced"] == []
    reports = {m["name"] for m in b["end_to_end"] + b["per_layer"]
               if CELL in m.get("workloads", ())}
    assert reports == {"train_examples_per_s", "mfu_pct.train",
                       "tail_us_per_step.train", "device_idle_pct.train",
                       "graph_gap_pct.train", "optimizer_us_per_step.train",
                       "issue_idle_pct.train", "conv_roofline.train"}
    cfg = config()
    assert (cfg["arch"], cfg["data_shape"], cfg["binarize"]) == (
        "conv", [32, 32, 3], False)
