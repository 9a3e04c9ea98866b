#!/usr/bin/env python3
"""Where the training decode kernel (B6) spends its time, on the card.

    python3 scripts/torch_train_decode_phases.py [--batches 16,128,512,1024]

Builds ``mvae_torch/kernels/csrc/train_decode.cu`` as it is and in variants
that each leave out phases (the h compute, the product, W2's fetch) or take
W2 by cp.async copies instead of the Tensor Memory Accelerator, and times
every variant, the two cuBLAS FP32 SGEMMs of the same decoder and an empty
kernel by ``roofline.measure`` (CUDA events around a CUDA-graph replay of
100 calls) at the flagship's widths (Z = 8, H = 400, D = 784). Each time
is the mean of two turns (all variants, then all again in reverse order).
A variant that leaves a phase out computes wrong values: only the whole
kernel and the cp.async variant are held to the plain version (ll within
1e-3 nats per row). Prints one line a batch and the card's name and power
limit. Needs a CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mvae_torch.kernels import _build, decoder_kernels, roofline  # noqa: E402

SRC = _build.CSRC / "train_decode.cu"
# each knob, the source text it leaves out (from the first marker to the
# second), or the plan's fetch it forces
KNOBS = {
    "SKIP_H": ("  for (int j4 = tid; j4 < hk4; j4 += TD_NT) {",
               "  if (FETCH == TD_FETCH_TMA) wait_parity0(bar);"),
    "SKIP_PROD": ("  if (!RING) {\n    Step cur", "  // 5. the 4 warps"),
    "SKIP_FETCH": ("  if (FETCH == TD_FETCH_TMA) {\n    if (tid == 0)",
                   "  // 3. h"),
    "SKIP_WAIT": ("  if (FETCH == TD_FETCH_TMA) wait_parity0(bar);",
                  "  __syncthreads();\n\n  // 4."),
}
VARIANTS = {
    "kernel": [],
    "cp.async": ["-DFORCE_COPY"],
    "no h": ["-DSKIP_H"],
    "no product": ["-DSKIP_PROD"],
    "no h, no product": ["-DSKIP_H", "-DSKIP_PROD"],
    "loads, epilogue, fold": ["-DSKIP_H", "-DSKIP_PROD", "-DSKIP_FETCH",
                              "-DSKIP_WAIT"],
}


def variant_source() -> str:
    """The kernel's source with an ``#ifndef`` around each knob's text and
    FORCE_COPY in the launcher."""
    s = SRC.read_text().replace('#include "', f'#include "{_build.CSRC}/')
    for flag, (start, end) in KNOBS.items():
        a = s.index(start)
        b = s.index(end, a)
        s = s[:a] + f"#ifndef {flag}\n" + s[a:b] + "#endif\n" + s[b:]
    anchor = "  if (B == 0) return (int)cudaGetLastError();\n"
    assert anchor in s
    return s.replace(anchor, anchor + "#ifdef FORCE_COPY\n  if (p.fetch =="
                     " TD_FETCH_TMA) p.fetch = TD_FETCH_COPY;\n#endif\n")


def build() -> dict:
    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "train_decode_phases.cu"
    src.write_text(variant_source())
    procs = {}
    for i, (name, flags) in enumerate(VARIANTS.items()):
        cmd = [_build.nvcc_path(), *_build._ARCH, *_build._COMMON, *flags,
               "-o", str(out / f"v{i}.so"), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out / f"v{i}.so")
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).train_decode_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="16,128,512,1024")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_decode_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    Z, H, D = 8, 400, 784
    w1 = math.sqrt(2.0 / Z) * torch.randn(Z, H, generator=gen, device="cuda")
    b1 = 0.1 * torch.randn(H, generator=gen, device="cuda")
    w2 = math.sqrt(2.0 / H) * torch.randn(H, D, generator=gen, device="cuda")
    b2 = 0.1 * torch.randn(D, generator=gen, device="cuda")
    tiny = torch.zeros(1, device="cuda")
    shipped = decoder_kernels._lib_train
    try:
        for B in (int(b) for b in args.batches.split(",")):
            z = torch.randn(B, Z, generator=gen, device="cuda")
            x = (torch.rand(B, D, generator=gen, device="cuda") < 0.3).float()
            h = torch.relu(z @ w1 + b1)
            ref = decoder_kernels.train_decode_ref(z, x, w1, b1, w2, b2)[0]
            runs = {"two SGEMMs": lambda: (torch.mm(z, w1), torch.mm(h, w2)),
                    "empty kernel": tiny.zero_}

            def call(fn):
                decoder_kernels._lib_train = lambda: fn
                return decoder_kernels.train_decode_fwd(z, x, w1, b1, w2, b2)

            for name in ("kernel", "cp.async"):
                err = (call(fns[name])[0] - ref).abs().max().item()
                if not err <= 1e-3:
                    raise RuntimeError(f"{name} at B={B}: ll off by {err}")
            times = {}
            order = list(runs) + list(fns)
            for name in order + order[::-1]:
                if name in runs:
                    t = roofline.measure(runs[name], iters=100, graph=True)
                else:
                    fn = fns[name]
                    t = roofline.measure(lambda fn=fn: call(fn), iters=100,
                                         graph=True)
                times.setdefault(name, []).append(t.us)
            print(f"[phases] B={B}: " + "; ".join(
                f"{n} {sum(u) / 2:.2f} us ({u[0]:.2f}, {u[1]:.2f})"
                for n, u in times.items()), flush=True)
    finally:
        decoder_kernels._lib_train = shipped
    print(roofline.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
