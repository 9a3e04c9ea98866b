"""Benchmark: VAE train steps/sec/chip on the flagship configuration.

Counterpart of the reference's ``bench.py`` (which stays as it is), for the
port on an NVIDIA card. Prints ONE JSON line last on stdout (logs go to
stderr), with the reference's keys: ``{"metric", "value", "unit",
"vs_baseline", ...}``.

    python bench_torch.py                 # one CUDA card
    python -m mvae_torch.bench --steps 300 --repeats 2 --conv_steps 100

It measures what ``bench.py`` measures, in its order, through the port's
own training step and kernels:

1. the card, read in a killable subprocess (``probe_card``: its name, the
   count, ``nvidia-smi``'s power limit); without one the line is an
   ``"error"`` line and the exit code 1;
2. the card's rates first (``kernels.roofline.calibrate``: the triad B8b,
   the FMA and tanh probes B8a, the GEMM chains), in this fresh process; a
   ``CalibrationError`` is the error line (no nominal fallback);
3. the flagship step: ``h2,s2,e2`` with learnable curvature, an MLP of
   h_dim 400 on D = 784, batch ``BATCH`` (1024), no burn-in, fixed uniform intensities
   from a seed, a fresh binarization and fresh noise each step. The step is
   the trainer's own (``Trainer._step_body``: binarize, loss, backward,
   the optimizer's one launch of ``csrc/adam.cu`` with the curvature mask
   inside) captured once as a CUDA graph
   (``graphs.Graphed``, the trainer's generator registered). ``--repeats``
   chunks of ``--steps`` replays, each between two device syncs, the best
   chunk kept; B1, B3 and B6's launches a step from the wrappers' counts;
   the device's busy share of one more chunk (at most ``PROFILE_STEPS``)
   from ``torch.profiler``;
4. ``step_model``: the reference's GEMM MACs and the port's bytes of a
   step; the MACs the step executes (the reference's less the first
   layer's input gradient, which nothing computes) and the bytes priced at
   the calibrated rates into a step ceiling and ``step_mfu_pct``;
5. ``step_model_counted``: ``FlopCounterMode`` over one eager step on the
   plain path (the same shapes on CPU tensors, so B6's products, which run
   inside a ctypes launch on the card, are plain matmuls there);
6. the bf16-operand rows (``nets.set_bf16_matmul``) at h_dim 400 and 1024,
   each a fresh trainer and capture, with the decode's route and the GEMMs
   the switch rounds (B6 and the fused head GEMM do not read it: where the
   decode is B6's, only the encoder's operands are rounded);
7. the conv ``u6`` row (32x32x3, batch ``CONV_BATCH``, 128): steps/s, the convolutions'
   MACs (``FlopCounterMode``) at the FP32 rate, the device time a step from
   the profiler, and the bf16-activation A/B (a new capture);
8. the conv IWAE chunk: S = 25 samples by B = 4 x the conv batch (512)
   through the conv decoder and the Bernoulli log-likelihood, by CUDA
   events, at full float32 (the convs' TF32 is off, ``nets._ConvF32``);
9. ``vs_baseline`` against ``BENCH_TORCH_BASELINE.json``, written by the
   first card run with the card's name and power limit
   (``BENCH_BASELINE.json`` is the TPU's and is never read).

The reference's keys renamed here (TPU words only): ``mxu_util_pct`` ->
``step_mfu_pct`` (the step's executed FLOP/s over the data sheet's 67
TFLOP/s FP32); ``step_model_hlo_cost`` -> ``step_model_counted``; ``train_rng``
"rbg" -> "philox"; ``bf16_matmul_steps_per_sec_h400`` / ``_h1024`` ->
``bf16_encoder_steps_per_sec_h400`` / ``_h1024`` (the GEMMs the switch
rounds on the card's B6 route); in ``step_model``, ``mxu_tmacs`` -> ``fma_tflops`` and
``tf32_tflops``, ``t_mxu_us`` -> ``t_fp32_us`` and ``t_3xtf32_us``;
``conv_iwae_high_ms_per_chunk_s25_b512`` ->
``conv_iwae_ms_per_chunk_s25_b512`` (with ``"conv_iwae_precision":
"fp32"``). The binding resources read "fp32" or "bytes" for "mxu" or
"hbm" (``RENAMED`` holds the map).

``step_mfu_pct`` is priced on the data sheet's FP32 peak of the card it
names (``FP32_PEAK_TFLOPS``: the H100 SXM at its 700 W limit); on any other
card, or below that limit, it is null.

``--device cpu`` runs the same path on the CPU with the kernels' plain
versions at the tests' small batches (``CPU_BATCH``, ``CPU_CONV_BATCH``),
for the tests: there every time, rate and share is null (no CPU number
stands under a device metric's name), the baseline is neither read nor
written, and the MACs, bytes and launch counts are printed for those
batches. The card always runs ``BATCH`` and ``CONV_BATCH``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from .components import parse_components
from .data import ArrayDataset
from .kernels import _build, decoder_kernels, roofline, tail_kernels
from .models import VAEConfig, nets, vae
from .ops.stable import softplus
from .train import TrainConfig, Trainer, graphs
from .train.trainer import _leaves
from .utils import profiling

METRIC = "vae_train_steps_per_sec_per_chip"
UNIT = "steps/s (batch=1024, h2s2e2 MNIST VAE, f32)"
BASELINE_FILE = (Path(__file__).resolve().parent.parent
                 / "BENCH_TORCH_BASELINE.json")
SPEC = "h2,s2,e2"
DATA_DIM = 784
H_DIM = 400
BATCH = 1024
CONV_BATCH = 128
# the tests' batches under --device cpu
CPU_BATCH = 8
CPU_CONV_BATCH = 4
BF16_H_DIMS = (400, 1024)
CONV_SPEC = "u6"
CONV_HWC = (32, 32, 3)
IWAE_SAMPLES = 25
# steps of the chunk the profiler traces (~160 device ops a flagship step:
# a longer trace only slows the profiler's own bookkeeping)
PROFILE_STEPS = 500
# the data sheet's FP32 peak outside the tensor cores (TFLOP/s) by card
# name, and the power limit (W) it is quoted at: the denominator of
# step_mfu_pct
FP32_PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": (67.0, 700.0)}

# the reference's line keys renamed in this one: TPU words only
RENAMED = {"mxu_util_pct": "step_mfu_pct",
           "step_model_hlo_cost": "step_model_counted",
           "conv_iwae_high_ms_per_chunk_s25_b512":
               "conv_iwae_ms_per_chunk_s25_b512",
           "bf16_matmul_steps_per_sec_h400":
               "bf16_encoder_steps_per_sec_h400",
           "bf16_matmul_steps_per_sec_h1024":
               "bf16_encoder_steps_per_sec_h1024",
           "step_model.mxu_tmacs": ("step_model.fma_tflops",
                                    "step_model.tf32_tflops"),
           "step_model.t_mxu_us": ("step_model.t_fp32_us",
                                   "step_model.t_3xtf32_us")}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class BenchError(RuntimeError):
    """A failure the line reports as its ``"error"``."""


def error_line(msg: str) -> dict:
    return {"metric": METRIC, "value": 0.0, "unit": "steps/s",
            "vs_baseline": 0.0, "error": msg}


# ------------------------------------------------------------------- card


_PROBE = ("import torch; print(torch.cuda.get_device_name(0)); "
          "print(torch.cuda.device_count())")


def probe_card(timeout_s: float = 300.0) -> dict | None:
    """The card, read in a throwaway subprocess that a hang cannot take
    down with this one: ``{"type": "cuda", "name", "count", "nvidia_smi",
    "power_limit_w"}`` (``nvidia-smi --query-gpu=name,power.limit``), or
    None when no card answers."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE],
                           capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None
    out = r.stdout.strip().splitlines()
    if r.returncode != 0 or len(out) < 2:
        return None
    card = {"type": "cuda", "name": out[-2], "count": int(out[-1]),
            "nvidia_smi": None, "power_limit_w": None}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return card
    lines = smi.stdout.strip().splitlines()
    if smi.returncode == 0 and lines:
        card["nvidia_smi"] = lines[0].strip()
        card["power_limit_w"] = _watts(lines[0])
    return card


def fp32_peak_tflops(card: dict) -> float | None:
    """The data sheet's FP32 peak of ``card`` when it is a card of
    ``FP32_PEAK_TFLOPS`` at the power limit the peak is quoted at, else
    None."""
    peak = FP32_PEAK_TFLOPS.get(card["name"])
    limit = card["power_limit_w"]
    if peak is None or limit is None or limit < peak[1]:
        return None
    return peak[0]


def _watts(smi_line: str) -> float | None:
    """700.0 from "NVIDIA H100 80GB HBM3, 700.00 W"."""
    try:
        return float(smi_line.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        return None


# ------------------------------------------------------------- step model


def step_model(cfg, n_params: int, batch: int) -> dict:
    """The reference's step model (``bench.py``) for ``cfg`` at ``batch``,
    with the port's bytes.

    MACs, as the reference counts them (``gemm_macs``): the forward GEMMs
    (encoder D x H, the fused heads H x head width, the decoder Z x H and
    H x D) once a row, times 3 for the forward, the input gradient and the
    weight gradient. The step executes B*D*H fewer (``executed_macs``):
    nothing needs the first layer's input gradient, and autograd does not
    compute it. The times are priced on ``executed_macs``.

    Bytes, float32 words times 4:

    * 8P for the parameters: the optimizer's kernel (``csrc/adam.cu``)
      reads p, g, m, v and writes p, m, v (7P), and the gradient is a
      tensor of its own that autograd writes first (P). The reference's 7P
      counts XLA fusing the weight gradient into the Adam update, which
      PyTorch does not do;
    * 2B(2D + H) for the activations, as the reference: three (B, D) /
      (B, H) buffers each written once forward and read once backward: the
      binarized x, the hidden h (B6 writes it for the backward), and B6's
      (B, D) logit gradient x - sigmoid(l), the one (B, D) buffer that
      replaces the logits the plain decoder would keep. The small heads,
      the (B, Z) latents and the tail's rows are left out, as there."""
    D = cfg.flat_dim
    H = cfg.h_dim
    head_w = sum(c.head_width for c in cfg.components)
    z = cfg.z_dim
    macs = 3 * batch * (D * H + H * head_w + z * H + H * D)
    adam_words = 8 * n_params
    act_words = 2 * batch * (2 * D + H)
    return {"gemm_macs": macs, "executed_macs": macs - batch * D * H,
            "hbm_bytes": 4 * (adam_words + act_words),
            "adam_words": adam_words, "activation_words": act_words,
            "n_params": n_params, "head_width": head_w, "z_dim": z,
            "batch": batch, "first_layer_input_grad_macs": batch * D * H}


def price(model: dict, cal: dict | None) -> dict:
    """The step model's times (us) at the calibrated rates: the executed
    MACs on the FP32 pipe (``t_fp32_us``, where the port's cuBLAS products run: TF32
    off) and as three TF32 tensor products (``t_3xtf32_us``, the contract
    B6's forward products run under), the bytes at the triad's stream rate
    (``t_hbm_us``). The step's ceiling is the larger of the FP32 and the
    bytes term: the least time the card can take for the step at the
    float32 grade the port computes it at. Nulls without ``cal``."""
    keys = ("t_fp32_us", "t_3xtf32_us", "t_hbm_us", "stream_gbps",
            "fma_tflops", "tf32_tflops")
    if cal is None:
        return {**{k: None for k in keys}, "rates_calibrated": False}
    flops = 2 * model["executed_macs"]
    return {"t_fp32_us": flops / (cal["fma_tflops"] * 1e6),
            "t_3xtf32_us": 3 * flops / (cal["tf32_tflops"] * 1e6),
            "t_hbm_us": model["hbm_bytes"] / (cal["stream_gbps"] * 1e3),
            "stream_gbps": cal["stream_gbps"],
            "fma_tflops": cal["fma_tflops"],
            "tf32_tflops": cal["tf32_tflops"], "rates_calibrated": True}


# ------------------------------------------------------------------- steps


def flagship_config(h_dim: int = H_DIM):
    return VAEConfig(parse_components(SPEC, fixed_curvature=False),
                     (DATA_DIM,), "mlp", h_dim=h_dim)


def conv_config():
    return VAEConfig(parse_components(CONV_SPEC, fixed_curvature=False),
                     CONV_HWC, "conv", h_dim=H_DIM)


def intensities(cfg, batch: int, seed: int = 1) -> np.ndarray:
    """Fixed uniform intensities (batch, *data_shape) from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((batch,) + tuple(cfg.data_shape),
                      generator=gen).numpy()


def bench_trainer(cfg, batch: int, device, seed: int = 0):
    """A ``Trainer`` of ``cfg`` whose train split is one batch of fixed
    intensities (``intensities``), without burn-in, on ``device``."""
    x = intensities(cfg, batch)
    ds = ArrayDataset("bench", x, x[:1], tuple(cfg.data_shape), True)
    tc = TrainConfig(batch_size=batch, burnin_epochs=0, seed=seed)
    return Trainer(cfg, ds, tc, "runs/bench_torch", device=device)


def step_program(trainer):
    """The trainer's step on its batch (binarize, loss, backward, mask,
    Adam; a fresh binarization and fresh noise from its generator each
    call): on a CUDA device a ``graphs.Graphed`` capture of it, whose first
    calls are real warm-up steps; elsewhere the body itself, eagerly. A
    CUDA trainer that cannot take the graph path raises."""
    x = trainer._train_data

    def body():
        return trainer._step_body(x, None, None)

    path = trainer.graph_path
    if path["path"] == "graph":
        return graphs.Graphed(body, (), trainer.generator,
                              graphs.WARMUP_STEPS)
    if trainer.device.type == "cuda":
        raise BenchError(f"the step is not graphed on the card: {path}")
    return body


def warm(step, device) -> None:
    """The warm-up calls and the capture (one replay after them)."""
    for _ in range(graphs.WARMUP_STEPS + 1):
        step()
    _sync(device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_chunks(step, steps: int, repeats: int, device):
    """``repeats`` chunks of ``steps`` calls, each between two device
    syncs: (wall seconds of each chunk, the last call's output)."""
    times, out = [], None
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            out = step()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times, out


def counted_kernels() -> dict:
    """The launch counters of the step's kernels by name (B1, B3, B6)."""
    return {"tail_fwd": tail_kernels.tail_forward,
            "tail_bwd": tail_kernels.tail_backward,
            "train_decode": decoder_kernels.train_decode_bce}


def launch_counts() -> dict:
    return {k: f.launches for k, f in counted_kernels().items()}


def launches_since(before: dict, steps: int) -> dict:
    """Each counted kernel's launches since ``before``, a step of
    ``steps``."""
    return {k: (n - before[k]) / steps for k, n in launch_counts().items()}


def device_seconds(run, device) -> tuple[float, float] | None:
    """(device busy s, wall s) of ``run()`` from ``torch.profiler``'s CUDA
    trace, the program's layer markers off (the plain graphs replayed);
    None off CUDA or when the trace holds no device time."""
    if torch.device(device).type != "cuda":
        return None
    _sync(device)
    with profiling.marking(False), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        _sync(device)
        wall = time.perf_counter() - t0
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()) / 1e6
    if busy <= 0:
        log("the profiler's trace holds no device time")
        return None
    return busy, wall


def counted_macs(cfg, batch: int) -> int:
    """MACs (FLOP / 2) that ``FlopCounterMode`` counts over one eager step
    of ``cfg`` at ``batch`` on the plain path: a trainer on CPU tensors
    (the training decode is then plain matmuls and not B6's ctypes launch,
    which the counter cannot see). The convolutions are ``aten`` ops and
    are counted; the first layer's input gradient is never computed."""
    trainer = bench_trainer(cfg, batch, "cpu")
    with FlopCounterMode(display=False) as counter:
        trainer._step_body(trainer._train_data, None, None)
    return counter.get_total_flops() // 2


@contextlib.contextmanager
def bf16_switch(setter, flag: str):
    """One of ``nets``' process-wide bf16 switches on inside the block
    (``setter``, its value read from ``nets.<flag>``), restored to what it
    was after it, also when the block raises."""
    before = getattr(nets, flag)
    setter(True)
    try:
        yield
    finally:
        setter(before)


def _loss(stats) -> float:
    return -float(stats["elbo"])


def decode_route(cfg, params) -> str:
    """Which decode the training step of ``cfg`` takes, in words: B6 (whose
    3xTF32 products do not read the bf16 switch, so under it only the
    encoder's operands are rounded) or the plain decode."""
    gate = vae.fused_path_report(cfg, params)["train_decoder"]
    if gate["active"]:
        return (f"B6 csrc/train_decode.cu at (Z, H) = ({cfg.z_dim}, "
                f"{cfg.h_dim}): 3xTF32 products, the bf16 switch reaches "
                f"the encoder only")
    fits = decoder_kernels.shape_supported(cfg.z_dim, cfg.h_dim)
    return (f"plain decode (matmuls on bf16-rounded operands; B6 plan "
            f"{'fits' if fits else 'does not fit'}): {gate['why']}")


# --------------------------------------------------------------------- run


def run(args) -> dict:

    device = torch.device(args.device or "cuda")
    on_card = device.type == "cuda"
    card = None
    cal = None
    if on_card:
        card = probe_card()
        if card is None or not torch.cuda.is_available():
            raise BenchError(
                "no CUDA card answered the probe subprocess (python "
                "bench_torch.py runs on the card; --device cpu is for the "
                "tests)")
        log(f"bench device: {card['nvidia_smi'] or card['name']}")
        if torch.backends.cuda.matmul.allow_tf32:
            raise BenchError("torch.backends.cuda.matmul.allow_tf32 is on: "
                             "the step's products must run at full FP32")
        t0 = time.time()
        _build.build_all()
        log(f"kernels built in {time.time() - t0:.1f} s")
        log("calibrating the card's rates (triad, FMA, tanh, GEMMs)...")
        try:
            cal = roofline.calibrate()
        except roofline.CalibrationError as e:
            raise BenchError(f"calibration failed: {e}") from e
        if torch.backends.cuda.matmul.allow_tf32:
            raise BenchError("calibration left allow_tf32 on")
    else:
        card = {"type": "cpu", "name": "cpu", "count": 1,
                "nvidia_smi": None, "power_limit_w": None}

    def rate(steps, seconds):
        return steps / seconds if on_card else None

    batch, conv_batch = ((BATCH, CONV_BATCH) if on_card
                         else (CPU_BATCH, CPU_CONV_BATCH))
    peak = fp32_peak_tflops(card)

    # ---- the flagship step
    cfg = flagship_config()
    trainer = bench_trainer(cfg, batch, device)
    step = step_program(trainer)
    log("capturing the flagship step...")
    t0 = time.time()
    warm(step, device)
    log(f"warm-up and capture: {time.time() - t0:.1f} s")
    before = launch_counts()
    times, stats = time_chunks(step, args.steps, args.repeats, device)
    launches = launches_since(before, args.steps * args.repeats)
    loss = _loss(stats)
    steps_per_sec = rate(args.steps, min(times))
    log(f"chunk times: {['%.4f' % t for t in times]} s -> "
        f"{steps_per_sec} steps/s, final loss {loss:.3f}; launches a step "
        f"{launches}")
    if not math.isfinite(loss):
        raise BenchError("non-finite loss in bench")
    profiled = min(args.steps, PROFILE_STEPS)
    dev = device_seconds(lambda: time_chunks(step, profiled, 1, device),
                         device)
    busy_pct = None if dev is None else 100.0 * dev[0] / dev[1]

    # ---- the step model at the calibrated rates
    n_params = sum(t.numel() for t in _leaves(trainer.params))
    model = step_model(cfg, n_params, batch)
    prices = price(model, cal)
    step_out = {**model, **prices}
    ceiling = binding = pct_ceiling = mfu = hbm_gbps = None
    if on_card:
        t_step = 1.0 / steps_per_sec
        t_ceil = max(prices["t_fp32_us"], prices["t_hbm_us"]) * 1e-6
        binding = "fp32" if prices["t_fp32_us"] >= prices["t_hbm_us"] \
            else "bytes"
        ceiling = 1.0 / t_ceil
        pct_ceiling = 100.0 * t_ceil / t_step
        if peak is not None:
            mfu = 100.0 * 2 * model["executed_macs"] / t_step / (peak * 1e12)
        else:
            log(f"step_mfu_pct null: no FP32 peak for {card['name']} at "
                f"{card['power_limit_w']} W in FP32_PEAK_TFLOPS")
        hbm_gbps = model["hbm_bytes"] / t_step / 1e9
        log(f"step model: {model['executed_macs'] / 1e6:.0f} MMACs "
            f"executed (the reference counts {model['gemm_macs'] / 1e6:.0f})"
            f" -> FP32 "
            f"{prices['t_fp32_us']:.1f} us (3xTF32 "
            f"{prices['t_3xtf32_us']:.1f} us); {model['hbm_bytes'] / 1e6:.2f}"
            f" MB -> {prices['t_hbm_us']:.1f} us; binding {binding}, "
            f"ceiling {ceiling:.0f} steps/s; measured {steps_per_sec:.0f} = "
            f"{pct_ceiling:.1f}% of it, step_mfu_pct {mfu}")

    # ---- the counted cross-check
    counted = counted_macs(cfg, batch)
    model_counted = {
        "macs": counted, "hand_macs": model["gemm_macs"],
        "hand_minus_counted": model["gemm_macs"] - counted,
        "executed_minus_counted": model["executed_macs"] - counted,
        "first_layer_input_grad_macs": model["first_layer_input_grad_macs"],
        "how": "torch.utils.flop_counter.FlopCounterMode over one eager "
               "step on the plain path (CPU tensors: B6's products are "
               "plain matmuls there)"}
    log(f"counted step: {counted / 1e6:.1f} MMACs (hand model "
        f"{model['gemm_macs'] / 1e6:.1f}; the difference "
        f"{(model['gemm_macs'] - counted) / 1e6:.1f} is the skipped "
        f"first-layer input gradient, B*D*H = "
        f"{model['first_layer_input_grad_macs'] / 1e6:.1f})")

    # ---- the bf16-operand rows
    bf16 = {}
    for hd in BF16_H_DIMS:
        bf16[hd] = bf16_row(hd, batch, args.steps, device, rate)
        log(f"bf16-matmul h_dim={hd}: {bf16[hd]}")

    # ---- the conv u6 row
    conv = conv_rows(conv_batch, args.conv_steps, device, cal, rate)

    # ---- the baseline
    vs_baseline = baseline = None
    if on_card:
        baseline = read_or_write_baseline(steps_per_sec, card)
        vs_baseline = steps_per_sec / baseline["steps_per_sec"]

    def r(v, nd):
        return None if v is None else round(v, nd)

    return {
        "metric": METRIC,
        "value": r(steps_per_sec, 2),
        "unit": UNIT,
        "vs_baseline": r(vs_baseline, 3),
        "step_mfu_pct": r(mfu, 2),
        "step_mfu_peak_tflops": peak,
        "hbm_gbps_est": r(hbm_gbps, 1),
        "step_ceiling_steps_per_sec": r(ceiling, 1),
        "pct_of_step_ceiling": r(pct_ceiling, 2),
        "step_binding_resource": binding,
        "step_model": {k: (r(v, 3) if isinstance(v, float) else v)
                       for k, v in step_out.items()},
        "train_rng": "philox",
        "launches_per_step": launches,
        "device_busy_pct": r(busy_pct, 1),
        "profiled_steps": profiled,
        "chunk_seconds": [round(t, 5) for t in times] if on_card else None,
        "steps_per_chunk": args.steps,
        "final_loss": round(loss, 4),
        "graph_path": trainer.graph_path["path"],
        "bf16_encoder_steps_per_sec_h400": bf16[400]["steps_per_sec"],
        "bf16_encoder_steps_per_sec_h1024": bf16[1024]["steps_per_sec"],
        "bf16_matmul_rows": {str(k): v for k, v in bf16.items()},
        "step_model_counted": model_counted,
        **conv,
        "baseline": baseline,
        "device": {"name": card["name"], "type": card["type"],
                   "power_limit_w": card["power_limit_w"],
                   "nvidia_smi": card["nvidia_smi"],
                   "count": card["count"]},
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }


def bf16_row(h_dim: int, batch: int, steps: int, device, rate) -> dict:
    """The flagship at ``h_dim`` with ``nets.set_bf16_matmul`` on: a fresh
    trainer and capture, one chunk of ``steps``; steps/s (null off the
    card), the loss, the decode's route, the GEMMs the switch rounds and
    B6's launches a step."""
    cfg = flagship_config(h_dim)
    trainer = bench_trainer(cfg, batch, device)
    route = decode_route(cfg, trainer.params)
    with bf16_switch(nets.set_bf16_matmul, "_BF16_MATMUL"):
        step = step_program(trainer)
        warm(step, device)
        before = launch_counts()
        times, stats = time_chunks(step, steps, 1, device)
        launches = launches_since(before, steps)
    loss = _loss(stats)
    sps = rate(steps, times[0])
    finite = math.isfinite(loss)
    return {"steps_per_sec": None if sps is None else round(sps, 1),
            "loss": round(loss, 4) if finite else None, "finite": finite,
            "decode_route": route,
            "rounded_gemms": (["encoder"] if launches["train_decode"]
                              else ["encoder", "decoder"]),
            "train_decode_launches_per_step": launches["train_decode"]}


def conv_rows(CB: int, conv_steps: int, device, cal, rate) -> dict:
    """The conv ``u6`` row (``bench.py``'s CIFAR stand-in), its ceiling,
    device floor, bf16-activation A/B and IWAE chunk, under the
    reference's keys."""
    on_card = torch.device(device).type == "cuda"
    cfg = conv_config()
    trainer = bench_trainer(cfg, CB, device)
    step = step_program(trainer)
    warm(step, device)
    before = launch_counts()
    times, stats = time_chunks(step, conv_steps, 2, device)
    launches = launches_since(before, 2 * conv_steps)
    loss = _loss(stats)
    if not math.isfinite(loss):
        raise BenchError("non-finite conv loss in bench")
    conv_sps = rate(conv_steps, min(times))

    # the MAC ceiling: the counted MACs at the FP32 rate (the convs and
    # linears run TF32 off), the only resource term, as the reference's
    # loose conv ceiling
    conv_macs = counted_macs(cfg, CB)
    t_ceil = pct_ceil = None
    if cal is not None:
        t_ceil = 2 * conv_macs / (cal["fma_tflops"] * 1e12)
        pct_ceil = 100.0 * t_ceil * conv_sps
    log(f"conv {CONV_SPEC} B={CB}: {conv_sps} steps/s, {conv_macs / 1e6:.0f}"
        f" MMACs counted, ceiling {None if t_ceil is None else 1 / t_ceil}"
        f" steps/s; launches a step {launches}")

    # the device-time floor: the profiler's device time a step over a chunk
    profiled = min(conv_steps, PROFILE_STEPS)
    dev = device_seconds(lambda: time_chunks(step, profiled, 1, device),
                         device)
    dev_us = floor_sps = pct_dev = None
    if dev is not None:
        dev_us = dev[0] * 1e6 / profiled
        floor_sps = 1e6 / dev_us
        pct_dev = 100.0 * conv_sps / floor_sps
        log(f"conv device floor: {dev_us:.1f} us a step -> {floor_sps:.0f} "
            f"steps/s; wall {conv_sps:.0f} = {pct_dev:.1f}% of it")
    elif on_card:
        log("conv device floor: the profiler showed no device time; null")

    # the bf16-activation A/B: a new capture of the same trainer's step
    with bf16_switch(nets.set_bf16_conv_activations, "_BF16_CONV_ACT"):
        step_b = step_program(trainer)
        warm(step_b, device)
        tb, stats_b = time_chunks(step_b, conv_steps, 2, device)
    loss_b = _loss(stats_b)
    bf16_sps = rate(conv_steps, min(tb))
    log(f"conv bf16-act A/B: {bf16_sps} against {conv_sps} steps/s (loss "
        f"{loss_b:.3f})")

    # the conv IWAE chunk: S x 4 CB through the decoder and the BCE
    eb = 4 * CB
    gen = torch.Generator().manual_seed(10)
    z = (0.5 * torch.randn((IWAE_SAMPLES, eb, cfg.z_dim),
                           generator=gen)).to(device)
    xc = trainer._train_data[:CB]
    xc = (torch.rand(xc.shape, generator=torch.Generator(
        device=device).manual_seed(11), device=device) < xc).to(xc.dtype)
    xc = xc.repeat(4, 1, 1, 1)
    dec = trainer.params["decoder"]

    @torch.no_grad()
    def chunk(zz):
        logits = nets.conv_decoder_apply(dec, zz)
        t = xc * logits - softplus(logits)
        return torch.sum(t, dim=(-1, -2, -3))

    ll = chunk(z)
    if not bool(torch.isfinite(ll).all()):
        raise BenchError("non-finite conv IWAE chunk")
    iwae_ms = None
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for i in range(4):
            chunk(z + i * 1e-6)
        end.record()
        torch.cuda.synchronize()
        iwae_ms = start.elapsed_time(end) / 4

    def r(v, nd):
        return None if v is None else round(v, nd)

    return {
        "conv_u6_steps_per_sec": r(conv_sps, 1),
        "conv_batch": CB,
        "conv_launches_per_step": launches,
        "conv_final_loss": round(loss, 4),
        "conv_step_ceiling_steps_per_sec": (None if t_ceil is None
                                            else round(1 / t_ceil, 1)),
        "conv_pct_of_step_ceiling": r(pct_ceil, 2),
        "conv_step_binding_resource": "fp32 (loose: the elementwise and "
                                      "byte terms are not counted)",
        "conv_step_model": {"macs": conv_macs,
                            "how": "FlopCounterMode over one eager step on "
                                   "CPU tensors"},
        "conv_device_us_per_step": r(dev_us, 2),
        "conv_device_floor_steps_per_sec": r(floor_sps, 1),
        "conv_pct_of_device_floor": r(pct_dev, 1),
        "conv_bf16_act_steps_per_sec": r(bf16_sps, 1),
        "conv_bf16_act_speedup": (None if bf16_sps is None
                                  else round(bf16_sps / conv_sps, 3)),
        "conv_bf16_act_loss_finite": math.isfinite(loss_b),
        "conv_iwae_ms_per_chunk_s25_b512": r(iwae_ms, 3),
        "conv_iwae_chunk": [IWAE_SAMPLES, eb],
        "conv_iwae_precision": "fp32",
    }


def read_or_write_baseline(steps_per_sec: float, card: dict) -> dict:
    """``BENCH_TORCH_BASELINE.json``: read when present, else written with
    this card run's figure, card and power limit."""
    if BASELINE_FILE.exists():
        return json.loads(BASELINE_FILE.read_text())
    base = {"steps_per_sec": steps_per_sec,
            "card": card["nvidia_smi"] or card["name"],
            "power_limit_w": card["power_limit_w"],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "note": "the port's first recorded card run (python "
                    "bench_torch.py); later runs report their speed-up "
                    "against it"}
    BASELINE_FILE.write_text(json.dumps(base, indent=2) + "\n")
    log(f"wrote {BASELINE_FILE}")
    return base


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m mvae_torch.bench")
    ap.add_argument("--device", default=None, choices=[None, "cpu"],
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions with every device number null (tests)")
    # ~1.2 s a chunk at the H100's ~1,660 steps/s (batch 1024)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=3)
    # ~1 s a chunk at batch 128
    ap.add_argument("--conv_steps", type=int, default=600)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        line = run(args)
    except BenchError as e:  # the one JSON line names the failure
        print(json.dumps(error_line(str(e))))
        return 1
    except Exception as e:
        traceback.print_exc()
        print(json.dumps(error_line(f"{type(e).__name__}: {e}")))
        return 1
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
