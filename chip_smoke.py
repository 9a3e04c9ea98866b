#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py          # one CUDA card; exits non-zero on any failure

Phases:
 1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
    full-f32 matmuls (TF32 off);
 2. build every kernel of ``mvae_torch/kernels/csrc`` with nvcc (parallel);
 3. the tail kernel (tail_fwd.cu) against ``tail_forward_ref`` at the
    flagship product h2,s2,e2, B = 512 and B = 1000 (ragged), random heads
    with large-|mu| rows and curvatures that put rows on both sides of the
    series window;
 4. the IWAE decode kernel (decode_bce.cu) against ``decode_bce_ref`` at
    (S=125, Z=8, B=512, H=400, D=784);
 5. the slice end to end: ``Trainer.evaluate_elbo`` and
    ``Trainer.evaluate_log_likelihood`` (IWAE-500) of the h2,s2,e2 MLP VAE
    at h_dim 400 over the 10,000-example MNIST test split (the synthetic
    stand-in when no data is present), launch counts read right after,
    then both recomputed on the same noise with the plain versions (pass
    means, and per example on one batch), and a profile of where each
    pass spends the device's time;
 6. one JSON line of kernel numbers, then the result line.

A kernel's ``ms`` is its device time per launch from the CUPTI trace of
``torch.profiler`` (CUDA events around a loop of launches when the trace
shows none); the events time, which includes the host's launch cost, is
printed beside it.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mvae_torch import TrainConfig, Trainer, VAEConfig, parse_components
from mvae_torch.data import load_mnist
from mvae_torch.kernels import _build, decoder_kernels, tail_kernels
from mvae_torch.models import vae

# NVIDIA H100 SXM data sheet (dense, 700 W): HBM rate and FP32 FMA peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SPEC = "h2,s2,e2"
# rough per-row arithmetic of the tail tiles (transcendentals count one op)
_TAIL_OPS = {"normal": lambda n: 12 * n, "wrapped": lambda n: 30 * n + 80,
             "vmf": lambda n: 120}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls
    after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int, kernel: str):
    """(device ms per launch of ``kernel`` from the profiler trace or None,
    ms per call by CUDA events)."""
    per_call = time_ms(fn, iters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += ev.device_time_total
            count += ev.count
    return (total / count / 1e3 if count else None), per_call


def profile_pass(what: str, fn) -> None:
    """Device busy share and the kernels that take the device's time over
    one call of ``fn`` (CUPTI trace; host-side profiling off)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"[profile] {what}: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100.0 * busy / wall:.1f}%), {sum(r[1] for r in rows)} device "
          f"ops")
    for us, count, key in rows[:8]:
        print(f"[profile]   {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")


@contextlib.contextmanager
def plain_kernels():
    """Route the two kernel wrappers to their plain versions (the
    reference recomputation of phase 5)."""
    saved = (tail_kernels.tail_forward, decoder_kernels.fused_decode_bce_t)
    tail_kernels.tail_forward = tail_kernels.tail_forward_ref
    decoder_kernels.fused_decode_bce_t = decoder_kernels.decode_bce_ref
    try:
        yield
    finally:
        (tail_kernels.tail_forward,
         decoder_kernels.fused_decode_bce_t) = saved


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 is False")
    return card


def phase_build() -> None:
    t0 = time.time()
    reports = _build.build_all()
    print(f"[build] {len(reports)} kernels in {time.time() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_tail(comps, gen) -> dict:
    W = sum(c.head_width for c in comps)
    nc = len(comps)
    mu_cols, off = [], 0
    for c in comps:
        mu_cols += range(off, off + c.dim)
        off += c.head_width
    worst = 0.0
    for B in (512, 1000):
        # curvatures that put rows on both sides of the |K r^2| < 1e-2
        # series window (|mu| ~ 0.1 at K = -1, ~ 1 at K = -1e-2)
        for kset in ((-1.0, 1.0, 0.0), (-1e-2, 1e-2, 0.0), (-0.25, 4.0, 0.0)):
            raw = torch.randn(B, W, generator=gen, device="cuda")
            raw[::13, mu_cols] *= 3.0             # large |mu| rows
            eps = tail_kernels.draw_noise(comps, (B,), raw, gen)
            k = torch.tensor(kset, device="cuda")
            z, aux = tail_kernels.tail_forward(comps, raw, eps, k)
            zr, auxr = tail_kernels.tail_forward_ref(comps, raw, eps, k)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(zr).all() and torch.isfinite(auxr).all()),
                  f"plain tail finite at B={B}, k={kset}")
            check(bool(torch.isfinite(z).all() and torch.isfinite(aux).all()),
                  f"tail kernel finite at B={B}, k={kset}")
            dz = (z - zr).abs()
            check(bool((dz <= 1e-5 * (1.0 + zr.abs())).all()),
                  f"tail z within 1e-5 (1+|z|) at B={B}, k={kset}: "
                  f"max {dz.max().item():.3g}")
            da = (aux - auxr).abs().max().item()
            check(da <= 1e-4, f"tail aux within 1e-4 at B={B}, k={kset}: "
                              f"{da:.3g}")
            worst = max(worst, dz.max().item(), da)
    B = 512
    raw = torch.randn(B, W, generator=gen, device="cuda")
    eps = tail_kernels.draw_noise(comps, (B,), raw, gen)
    k = torch.tensor((-1.0, 1.0, 0.0), device="cuda")
    dev_ms, call_ms = kernel_ms(
        lambda: tail_kernels.tail_forward(comps, raw, eps, k), 500,
        "tail_fwd_kernel")
    ms = call_ms if dev_ms is None else dev_ms
    plain_ms = time_ms(
        lambda: tail_kernels.tail_forward_ref(comps, raw, eps, k), 50)
    Z = z.shape[1]
    nbytes = 4 * (raw.numel() + eps.numel() + nc + B * Z + B * (nc + 2))
    ops = B * sum(_TAIL_OPS[c.posterior](c.dim) for c in comps)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    print(f"[tail_fwd] max err {worst:.3g}; B=512: kernel device "
          f"{'not measured' if dev_ms is None else f'{dev_ms * 1e3:.2f} us'}, "
          f"per call (events) {call_ms * 1e3:.2f} us, "
          f"plain {plain_ms * 1e3:.1f} us, bytes bound "
          f"{bytes_ms * 1e3:.4f} us ({nbytes} B), ops bound "
          f"{ops_ms * 1e3:.4f} us")
    return {"name": "tail_fwd", "route": "cuda",
            "source": "mvae_torch/kernels/csrc/tail_fwd.cu",
            "replaces": "mvae_tpu/kernels/tail_kernels.py:704",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def phase_decode(gen) -> dict:
    S, Z, B, H, D = 125, 8, 512, 400, 784
    dev = "cuda"
    zt = torch.randn(S, Z, B, generator=gen, device=dev)
    xt = (torch.rand(D, B, generator=gen, device=dev) < 0.3).float()
    w1 = math.sqrt(2.0 / Z) * torch.randn(Z, H, generator=gen, device=dev)
    b1 = 0.1 * torch.randn(H, generator=gen, device=dev)
    w2 = math.sqrt(2.0 / H) * torch.randn(H, D, generator=gen, device=dev)
    b2 = 0.1 * torch.randn(D, generator=gen, device=dev)
    out = decoder_kernels.fused_decode_bce_t(zt, xt, w1, b1, w2, b2)
    ref = decoder_kernels.decode_bce_ref(zt, xt, w1, b1, w2, b2)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "decode kernel finite")
    err = (out - ref).abs().max().item()
    check(err <= 1e-3, f"decode within 1e-3 nats per row: {err:.3g}")
    dev_ms, call_ms = kernel_ms(
        lambda: decoder_kernels.fused_decode_bce_t(zt, xt, w1, b1, w2, b2),
        20, "decode_bce_kernel")
    ms = call_ms if dev_ms is None else dev_ms
    plain_ms = time_ms(
        lambda: decoder_kernels.decode_bce_ref(zt, xt, w1, b1, w2, b2), 10)
    zf = zt.transpose(1, 2).reshape(S * B, Z).contiguous()
    hf = torch.relu(zf @ w1 + b1)
    lib_ms = time_ms(lambda: (torch.mm(zf, w1), torch.mm(hf, w2)), 10)
    flops = 2.0 * S * B * (Z * H + H * D)
    nbytes = 4 * (zt.numel() + xt.numel() + w1.numel() + H + w2.numel() + D
                  + S * B)
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[decode_bce] max err {err:.3g} nats/row; kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s; events {call_ms:.3f} ms), "
          f"plain {plain_ms:.3f} ms, two cuBLAS SGEMMs {lib_ms:.3f} ms, "
          f"FP32 bound {ops_ms:.3f} ms "
          f"({flops / 1e9:.1f} GFLOP), bytes bound {bytes_ms * 1e3:.2f} us")
    return {"name": "decode_bce", "route": "cuda",
            "source": "mvae_torch/kernels/csrc/decode_bce.cu",
            "replaces": "mvae_tpu/kernels/decoder_kernels.py:154",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms}


def _evaluate(trainer, seed):
    trainer.generator.manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.time()
    elbo = trainer.evaluate_elbo("test")["elbo"]
    t1 = time.time()
    ll = trainer.evaluate_log_likelihood("test")
    t2 = time.time()
    return elbo, ll, t1 - t0, t2 - t1


@torch.no_grad()
def per_example_check(cfg, trainer, n_samples: int) -> None:
    """Per-example ELBO and IWAE values of one 512-example batch through the
    kernels and through the plain versions, on the same explicit noise:
    a pass mean in float32 cannot resolve differences below ~6e-5 nats."""
    x = (trainer._test_data[:512] > 0.5).float()
    gen = torch.Generator(device="cuda").manual_seed(7)
    noise_elbo = tail_kernels.draw_noise(cfg.components, (512,), x, gen)
    noise_ll = tail_kernels.draw_noise(cfg.components, (n_samples, 512), x,
                                       gen)

    def both():
        return (vae.elbo(cfg, trainer.params, x, noise=noise_elbo)[0],
                vae.log_likelihood(cfg, trainer.params, x, n_samples,
                                   noise=noise_ll))

    elbo_k, ll_k = both()
    with plain_kernels():
        elbo_p, ll_p = both()
    d_elbo = (elbo_k - elbo_p).abs().max().item()
    d_ll = (ll_k - ll_p).abs().max().item()
    print(f"[e2e] per example, 512 examples, same noise: max |dELBO| "
          f"{d_elbo:.3g}, max |dLL| {d_ll:.3g} nats")
    check(d_elbo <= 1e-3 and d_ll <= 1e-3,
          "per-example ELBO and IWAE LL match the plain versions")


def phase_end_to_end() -> dict:
    ds = load_mnist()
    cfg = VAEConfig(parse_components(SPEC, fixed_curvature=False),
                    ds.data_shape, "mlp", h_dim=400)
    tc = TrainConfig(seed=0)
    trainer = Trainer(cfg, ds, tc)
    check(trainer.fused_paths["train_tail"]["active"]
          and trainer.fused_paths["iwae_decoder"]["active"],
          f"both kernels routed: {trainer.fused_paths}")
    n = len(ds.test)
    _evaluate(trainer, 1)  # warm-up pass (cuBLAS handles, allocator)

    tail_kernels.tail_forward.launches = 0
    decoder_kernels.fused_decode_bce_t.launches = 0
    elbo, ll, t_elbo, t_ll = _evaluate(trainer, tc.seed)
    launches = {"tail_fwd": tail_kernels.tail_forward.launches,
                "decode_bce": decoder_kernels.fused_decode_bce_t.launches}
    print(f"[e2e] {SPEC} h_dim 400 on {n} test examples "
          f"({'synthetic' if ds.synthetic else 'real'} MNIST): ELBO {elbo:.4f} "
          f"in {t_elbo:.3f} s ({n / t_elbo:.0f} ex/s); IWAE-"
          f"{tc.likelihood_n} LL {ll:.4f} in {t_ll:.3f} s "
          f"({n / t_ll:.0f} ex/s); launches {launches}")
    check(math.isfinite(elbo) and math.isfinite(ll), "finite ELBO and LL")
    check(launches["tail_fwd"] >= 20, "tail kernel launched >= 20 times")
    check(launches["decode_bce"] >= 80, "decode kernel launched >= 80 times")

    with plain_kernels():
        elbo_p, ll_p, t_elbo_p, t_ll_p = _evaluate(trainer, tc.seed)
    print(f"[e2e] plain versions on the same noise: ELBO {elbo_p:.4f} "
          f"({t_elbo_p:.3f} s), IWAE LL {ll_p:.4f} ({t_ll_p:.3f} s); "
          f"|dELBO| {abs(elbo - elbo_p):.3g}, |dLL| {abs(ll - ll_p):.3g}")
    check(abs(elbo - elbo_p) <= 1e-3, "ELBO matches the plain versions")
    check(abs(ll - ll_p) <= 1e-3, "IWAE LL matches the plain versions")
    per_example_check(cfg, trainer, tc.likelihood_n)

    profile_pass("ELBO pass, 10000 examples",
                 lambda: trainer.evaluate_elbo("test"))
    profile_pass("IWAE-500 pass, 1024 examples",
                 lambda: trainer.evaluate_log_likelihood("test", 1024))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = phase_card()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    comps = parse_components(SPEC, fixed_curvature=False)
    kernels = [phase_tail(comps, gen), phase_decode(gen)]
    launches = phase_end_to_end()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
