"""``mvae_torch.bench`` (``python bench_torch.py``) on the CPU: the step
model against ``bench.py``'s arithmetic on the JAX package's own
configuration and parameters, the counted MACs, the bench's step against
the trainer's, the CPU run's line (every key of ``bench.py``'s line or its
renamed one, every device number null), the error line without a card, the
baseline files untouched, and the bf16 switches restored after a failure.
"""
import ast
import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mvae_tpu.components import parse_components as j_parse
from mvae_tpu.models import VAEConfig as JVAEConfig
from mvae_tpu.models import init_params as j_init_params
from mvae_torch import bench
from mvae_torch.models import nets, vae
from mvae_torch.train.trainer import _leaves

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU_ARGS = ["--device", "cpu", "--steps", "2", "--repeats", "1",
            "--conv_steps", "1"]
BASELINES = (ROOT / "BENCH_TORCH_BASELINE.json", ROOT / "BENCH_BASELINE.json")
# the line's times, rates and shares: measured on a card only
DEVICE_FIELDS = (
    "value", "vs_baseline", "step_mfu_pct", "hbm_gbps_est",
    "step_ceiling_steps_per_sec", "pct_of_step_ceiling",
    "step_mfu_peak_tflops", "step_binding_resource", "device_busy_pct",
    "chunk_seconds",
    "bf16_encoder_steps_per_sec_h400", "bf16_encoder_steps_per_sec_h1024",
    "conv_u6_steps_per_sec", "conv_step_ceiling_steps_per_sec",
    "conv_pct_of_step_ceiling", "conv_device_us_per_step",
    "conv_device_floor_steps_per_sec", "conv_pct_of_device_floor",
    "conv_bf16_act_steps_per_sec", "conv_bf16_act_speedup",
    "conv_iwae_ms_per_chunk_s25_b512", "baseline")
STEP_MODEL_RATES = ("t_fp32_us", "t_3xtf32_us", "t_hbm_us", "stream_gbps",
                    "fma_tflops", "tf32_tflops")


def reference_line_keys() -> set:
    """The keys of ``bench.py``'s printed line (``step_model``'s as
    ``step_model.<key>``), read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    line = next(node for node in ast.walk(tree)
                if isinstance(node, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == "metric"
                    for k in node.keys) and len(node.keys) > 5)
    keys = set()
    for k, v in zip(line.keys, line.values):
        keys.add(k.value)
        if k.value == "step_model":
            keys |= {f"step_model.{kk.value}" for kk in v.keys}
    return keys


def _has(line: dict, dotted: str) -> bool:
    head, _, tail = dotted.partition(".")
    return head in line and (not tail or tail in line[head])


def _run_bench(args):
    before = [(p.exists(), p.read_bytes() if p.exists() else None,
               p.stat().st_mtime_ns if p.exists() else None)
              for p in BASELINES]
    out = subprocess.run([sys.executable, "bench_torch.py", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    after = [(p.exists(), p.read_bytes() if p.exists() else None,
              p.stat().st_mtime_ns if p.exists() else None)
             for p in BASELINES]
    assert before == after, "a bench run wrote a baseline file"
    return out


@pytest.mark.parametrize("h_dim", [400, 1024])
def test_step_model_is_bench_py_arithmetic(h_dim):
    """bench.py's MACs and bytes on the JAX package's VAEConfig and
    init_params at batch 1024, exact integers; the port's bytes are the
    reference's with the gradient's own write (8P, not 7P)."""
    B, D = 1024, 784
    cfg_j = JVAEConfig(components=j_parse("h2,s2,e2", fixed_curvature=False),
                       data_shape=(D,), arch="mlp", h_dim=h_dim)
    params_j = j_init_params(jax.random.key(0), cfg_j)
    n_params = sum(x.size for x in jax.tree.leaves(params_j))
    head_w = sum(c.head_width for c in cfg_j.components)
    z_dim = cfg_j.z_dim
    gemm_macs = 3 * B * (D * h_dim + h_dim * head_w + z_dim * h_dim
                         + h_dim * D)
    ref_bytes = (7 * n_params + 2 * B * (2 * D + h_dim)) * 4

    cfg = bench.flagship_config(h_dim)
    n_port = sum(t.numel() for t in _leaves(vae.init_params(
        cfg, generator=torch.Generator().manual_seed(0))))
    model = bench.step_model(cfg, n_port, B)
    assert n_port == n_params
    assert (model["head_width"], model["z_dim"]) == (head_w, z_dim)
    assert model["gemm_macs"] == gemm_macs
    assert model["hbm_bytes"] == ref_bytes + 4 * n_params
    assert model["first_layer_input_grad_macs"] == B * D * h_dim
    assert model["executed_macs"] == gemm_macs - B * D * h_dim
    if h_dim == 400:
        assert (n_params, head_w, z_dim) == (636397, 11, 8)
        assert gemm_macs == 1_950_105_600


def test_price_and_ceiling_arithmetic():
    model = bench.step_model(bench.flagship_config(), 636397, 1024)
    cal = {"fma_tflops": 64.67, "tf32_tflops": 373.1, "stream_gbps": 3084.0}
    p = bench.price(model, cal)
    executed = 1_950_105_600 - 1024 * 784 * 400
    assert model["executed_macs"] == executed == 1_628_979_200
    assert p["t_fp32_us"] == pytest.approx(2 * executed / 64.67e6)
    assert p["t_fp32_us"] == pytest.approx(50.38, abs=0.01)
    assert p["t_3xtf32_us"] == pytest.approx(3 * 2 * executed / 373.1e6)
    assert p["t_hbm_us"] == pytest.approx(model["hbm_bytes"] / 3084e3)
    assert p["rates_calibrated"]
    assert all(v is None for k, v in bench.price(model, None).items()
               if k != "rates_calibrated")


def test_counted_macs_are_the_hand_model_less_the_input_gradient():
    B = 8
    cfg = bench.flagship_config()
    n = sum(t.numel() for t in _leaves(vae.init_params(cfg)))
    model = bench.step_model(cfg, n, B)
    assert bench.counted_macs(cfg, B) == model["executed_macs"] == (
        model["gemm_macs"] - model["first_layer_input_grad_macs"])


def test_bench_step_is_the_trainers_step():
    """The bench's step (eager on the CPU) and ``Trainer._train_step`` on
    the same seed and state: the same statistics and parameters, bit for
    bit, over two steps."""
    cfg = bench.flagship_config(32)
    a = bench.bench_trainer(cfg, 16, "cpu")
    b = bench.bench_trainer(cfg, 16, "cpu")
    step = bench.step_program(a)
    for _ in range(2):
        sa = step()
        sb = b._train_step(b._train_data)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a.params),
                                                 _leaves(b.params)))


def test_cpu_run_prints_one_complete_line_with_device_numbers_null():
    out = _run_bench(CPU_ARGS)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    for key in reference_line_keys():
        renamed = bench.RENAMED.get(key, key)
        names = renamed if isinstance(renamed, tuple) else (renamed,)
        assert all(_has(line, n) for n in names), (key, names)
    assert line["metric"] == "vae_train_steps_per_sec_per_chip"
    assert line["unit"] == "steps/s (batch=1024, h2s2e2 MNIST VAE, f32)"
    assert line["train_rng"] == "philox"
    assert line["conv_iwae_precision"] == "fp32"
    assert line["device"]["type"] == "cpu" and line["device"]["name"] == "cpu"
    assert line["device"]["power_limit_w"] is None
    for key in DEVICE_FIELDS:
        assert line[key] is None, key
    for key in STEP_MODEL_RATES:
        assert line["step_model"][key] is None, key
    assert line["step_model"]["rates_calibrated"] is False
    for row in line["bf16_matmul_rows"].values():
        assert row["steps_per_sec"] is None and row["finite"]
        assert row["decode_route"].startswith("plain decode")
        assert row["rounded_gemms"] == ["encoder", "decoder"]
    counted = line["step_model_counted"]
    B = bench.CPU_BATCH
    assert line["step_model"]["batch"] == B
    assert counted["hand_minus_counted"] == B * 784 * 400
    assert counted["executed_minus_counted"] == 0
    assert line["conv_batch"] == bench.CPU_CONV_BATCH
    assert line["step_model"]["gemm_macs"] == counted["hand_macs"]
    assert line["conv_step_model"]["macs"] > 0
    assert line["graph_path"] == "eager"
    assert np.isfinite(line["final_loss"])


def test_without_a_card_the_bench_prints_its_error_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run_bench(["--steps", "2"])
    assert out.returncode == 1
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "error" in line
    assert line["metric"] == "vae_train_steps_per_sec_per_chip"


@pytest.mark.parametrize("card, peak", [
    ({"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}, 67.0),
    ({"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 500.0}, None),
    ({"name": "NVIDIA H100 80GB HBM3", "power_limit_w": None}, None),
    ({"name": "NVIDIA H100 PCIe", "power_limit_w": 350.0}, None),
    ({"name": "cpu", "power_limit_w": None}, None)])
def test_fp32_peak_only_for_the_card_it_is_quoted_for(card, peak):
    assert bench.fp32_peak_tflops(card) == peak


def test_card_sizes_are_not_options():
    """The card runs the line's batches; no flag changes them."""
    assert (bench.BATCH, bench.CONV_BATCH) == (1024, 128)
    assert "batch=1024" in bench.UNIT
    opts = {o for a in bench.build_parser()._actions for o in a.option_strings}
    assert not {"--batch", "--conv_batch"} & opts


def _failing_timer(*a, **k):
    raise RuntimeError("timing failed")


@pytest.mark.parametrize("before", [False, True])
def test_bf16_matmul_switch_restored_after_a_failure(monkeypatch, before):
    monkeypatch.setattr(nets, "_BF16_MATMUL", before)
    monkeypatch.setattr(bench, "time_chunks", _failing_timer)
    with pytest.raises(RuntimeError, match="timing failed"):
        bench.bf16_row(400, 4, 1, "cpu", lambda *a: None)
    assert nets._BF16_MATMUL is before


def test_bf16_conv_switch_restored_after_a_failure(monkeypatch):
    """The conv row fails inside its bf16-activation A/B."""
    warm = bench.warm

    def failing_warm(step, device):
        if nets._BF16_CONV_ACT:
            raise RuntimeError("capture failed")
        warm(step, device)

    monkeypatch.setattr(bench, "warm", failing_warm)
    assert nets._BF16_CONV_ACT is False
    with pytest.raises(RuntimeError, match="capture failed"):
        bench.conv_rows(2, 1, "cpu", None, lambda *a: None)
    assert nets._BF16_CONV_ACT is False
