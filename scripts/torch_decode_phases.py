#!/usr/bin/env python3
"""Where the IWAE decode kernel (B2) spends its time, on the card.

    python3 scripts/torch_decode_phases.py [--shapes 125,8,512,400,784;...]

Builds the previous design (``scripts/decode_bce_previous.cu``: 64
examples a block, W2 loaded, split and stored by the threads that
multiply, h read back with ldmatrix every stage) as it is and in variants
that leave phases out, and the package's ``csrc/decode_bce.cu`` as it is
and in variants: without its h product (the A fragments made once, not
zero: the tensor cores run faster on zeros), without the copies after each
slot's first stage, and with a ring of up to 6 slots. (A variant whose
products' results are never read times nothing: ptxas drops them.) Times
every build by ``roofline.measure`` (CUDA events around a CUDA-graph
replay of 20 calls), in two turns (all builds,
then all again in reverse order), beside the two cuBLAS FP32 SGEMMs of the
same decoder, at each shape (S, Z, B, H, D). Variants of the previous
design:

- ``products alone``: no W2 staging (the products read the shared memory
  as the first stage left it) and the A fragments loaded once;
- ``products + A``: no W2 staging, h's fragments read and split every
  stage;
- ``products + staging``: W2 loaded, split and stored every stage, the A
  fragments loaded once;
- ``whole``: the kernel as it was.

A variant that leaves a phase out computes wrong values: only the whole
kernels are held to the plain version (1e-3 nats a row). Prints ptxas's
registers and spills of every build, one line a shape and the card's name
and power limit. Needs a CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mvae_torch.kernels import _build, decoder_kernels, roofline  # noqa: E402

PREVIOUS = Path(__file__).resolve().parent / "decode_bce_previous.cu"
# each knob of the previous design: the source text it leaves out (from the
# first marker to the second), and what it adds after a marker
PREV_KNOBS = {
    "SKIP_W2": ("    if (loader) {\n      if (it + 1 < T) {",
                "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
                "\"memory\");\n    load_a(nh"),
    "SKIP_A": ("    load_a(nh, nl, arow + ((it + 1) % nK) * BK);\n",
               "#pragma unroll\n    for (int ks = 0; ks < KSTEPS; ++ks)\n"
               "#pragma unroll\n      for (int c = 0; c < 4; ++c)\n"
               "        asm volatile(\"\" : \"+r\"(nh"),
}
PREV_ADD = {"SKIP_A": ("  load_a(ah0, al0, arow);\n",
                       "  load_a(ah1, al1, arow);\n")}
PREV_VARIANTS = {
    "previous, products alone": ["-DSKIP_W2", "-DSKIP_A"],
    "previous, products + A": ["-DSKIP_W2"],
    "previous, products + staging": ["-DSKIP_A"],
    "previous, whole": [],
}
# the package's kernel without its h product: the A fragments stay as made
# once (not zero: the tensor cores run faster on zeros)
NEW_KNOBS = {
    "SKIP_H": ("// + b1, ReLU, split", "// the half's products"),
}
NEW_ADD = {"SKIP_H": ("auto h_block = [&]", "return;\n")}
NEW_VARIANTS = {"new, no h product": ["-DSKIP_H"], "new, whole": []}
# variants of the package's kernel made by replacing source text, name:
# (replacements, flags): without the refill copies (each slot keeps its
# first stage, its full barrier arrived on at once), and with a ring of up
# to 6 slots
_NO_COPY = [("load_stage(ring, full, sbytes, img, it + slots, slots);",
             'asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" :: '
             '"r"(full + 8 * (it % slots)) : "memory");')]
NEW_PATCHES = {
    "new, no copy": (_NO_COPY, []),
    "new, 6 slots": ([("#define MAX_SLOTS 4", "#define MAX_SLOTS 6")], []),
}

def _knobbed(src: str, knobs: dict, adds: dict) -> str:
    s = src.replace('#include "', f'#include "{_build.CSRC}/')
    for flag, (start, end) in knobs.items():
        # from the start of the line that holds `start` to that of `end`
        a = s.rindex("\n", 0, s.index(start)) + 1
        b = s.rindex("\n", 0, s.index(end, a)) + 1
        s = s[:a] + f"#ifndef {flag}\n" + s[a:b] + "#endif\n" + s[b:]
    for flag, (anchor, text) in adds.items():
        # after the line that holds `anchor`
        a = s.index("\n", s.index(anchor)) + 1
        s = s[:a] + f"#ifdef {flag}\n{text}#endif\n" + s[a:]
    return s


def build(only: str = "") -> dict:
    out = _build.BUILD_DIR / "decode_phases"
    out.mkdir(parents=True, exist_ok=True)
    prev = out / "previous.cu"
    prev.write_text(_knobbed(PREVIOUS.read_text(), PREV_KNOBS, PREV_ADD))
    new = out / "new.cu"
    new_src = (_build.CSRC / "decode_bce.cu").read_text()
    fixed_a = ("unsigned ah[2][4], al[2][4];  // a half stage's A fragments\n",
            "unsigned ah[2][4], al[2][4];\n#ifdef SKIP_H\n"
            "  for (int i = 0; i < 8; ++i)\n"
            "    tf32_split(0.5f + 1e-3f * (tid + 7 * i), ah[i / 4][i % 4],\n"
            "               al[i / 4][i % 4]);\n#endif\n")
    assert fixed_a[0] in new_src
    new.write_text(_knobbed(new_src.replace(*fixed_a), NEW_KNOBS, NEW_ADD))
    variants = {name: (prev, flags) for name, flags in PREV_VARIANTS.items()}
    variants.update({name: (new, flags) for name, flags in
                     NEW_VARIANTS.items()})
    for i, (name, (patches, flags)) in enumerate(NEW_PATCHES.items()):
        text = new_src.replace(*fixed_a)
        for a, b in patches:
            assert a in text, a
            text = text.replace(a, b)
        src = out / f"patched{i}.cu"
        src.write_text(_knobbed(text, NEW_KNOBS, NEW_ADD))
        variants[name] = (src, flags)
    if only:
        keep = only.split(",")
        variants = {n: v for n, v in variants.items()
                    if any(k in n for k in keep)}
    tags = {name: f"v{i}" for i, name in enumerate(variants)}
    built = _build.build_variants(
        {tags[n]: (src, flags) for n, (src, flags) in variants.items()}, out)
    libs = {}
    for name in variants:
        lib, report = built[tags[name]]
        for line in report.splitlines():
            if any(w in line for w in ("decode_bce_kernel", "Used", "spill",
                                       "arning")):
                print(f"[build] {name}: {line.strip()}", flush=True)
        fn = lib.decode_bce_launch
        fn.restype = ctypes.c_int
        if name.startswith("new"):
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
        libs[name] = fn
    return libs


def caller(name, fn, args, S, Z, B, H, D):
    zt, xt, w1, b1, w2, b2 = args
    out = torch.empty((S, B), dtype=torch.float32, device="cuda")
    ptrs = [t.data_ptr() for t in args] + [out.data_ptr()]
    if name.startswith("new"):
        img = torch.empty(decoder_kernels.decode_image_bytes(Z, H, D) // 4,
                          dtype=torch.int32, device="cuda")
        ptrs.append(img.data_ptr())

    def call():
        _build.check(fn(*ptrs, S, Z, B, H, D,
                        torch.cuda.current_stream().cuda_stream), name)
        return out
    return call


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="125,8,512,400,784;125,6,512,400,784;"
                    "16,8,2048,400,784")
    ap.add_argument("--only", default="", help="build and time only the "
                    "variants whose names hold one of these comma-separated "
                    "words")
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(a.only)
    print(f"[card] {roofline.card()}", flush=True)
    for spec in a.shapes.split(";"):
        S, Z, B, H, D = (int(v) for v in spec.split(","))
        gen = torch.Generator(device="cuda").manual_seed(S * B + Z)
        zt = torch.randn((S, Z, B), generator=gen, device="cuda")
        xt = (torch.rand((D, B), generator=gen, device="cuda") < 0.3).float()
        w1 = (2.0 / Z) ** 0.5 * torch.randn((Z, H), generator=gen,
                                            device="cuda")
        b1 = 0.1 * torch.randn((H,), generator=gen, device="cuda")
        w2 = (2.0 / H) ** 0.5 * torch.randn((H, D), generator=gen,
                                            device="cuda")
        b2 = 0.1 * torch.randn((D,), generator=gen, device="cuda")
        args = [zt, xt, w1, b1, w2, b2]
        ref = decoder_kernels.decode_bce_ref(*args)
        calls = {n: caller(n, fn, args, S, Z, B, H, D)
                 for n, fn in libs.items()}
        for n in ("previous, whole", "new, whole"):
            if n not in calls:
                continue
            err = float((calls[n]() - ref).abs().max())
            print(f"[check] {spec} {n}: max |err| {err:.3g} nats a row "
                  f"{'ok' if err <= 1e-3 else 'FAILED'}", flush=True)
        lib_args = roofline.two_sgemm_operands(zt, w1, b1, w2)
        calls["two SGEMMs"] = lambda: roofline.two_sgemms(*lib_args)
        order = list(calls)
        times = {n: [] for n in order}
        for turn in (order, order[::-1]):
            for n in turn:
                times[n].append(roofline.measure(calls[n], iters=20,
                                                 graph=True).us)
        floor = roofline.decode_flops(S, B, Z, H, D)["tensor_3xtf32"] / 495e6
        print(f"[phases] (S, Z, B, H, D) = ({spec}); 3xTF32 at 495 TFLOP/s "
              f"{floor:.1f} us; us a call (two turns, mean):", flush=True)
        for n in order:
            m = sum(times[n]) / 2
            print(f"[phases]   {n:32s} {times[n][0]:9.1f} {times[n][1]:9.1f}"
                  f"  mean {m:9.1f}  {100 * floor / m:5.1f}% of 3xTF32 at "
                  f"495", flush=True)
        img_call = lambda: decoder_kernels.decode_w_image(w1, b1, w2)  # noqa
        t = roofline.measure(img_call, iters=20, graph=True).us
        print(f"[phases]   image launch alone: {t:.2f} us", flush=True)


if __name__ == "__main__":
    main()
