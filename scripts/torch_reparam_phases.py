#!/usr/bin/env python3
"""Where the IWAE chunk reparam (B5, reparam_stereo.cu) and the HBM triad
probe (B8b, roofline_probes.cu) spend their time, on the card.

    python3 scripts/torch_reparam_phases.py [--baseline DIR]

B5. Builds the package's ``reparam_stereo.cu`` (the kernel: 1 or 2
samples a thread by the chunk's size, the vectors in registers for n = 2,
3, 6, an instantiation for each curvature sign), its previous design
(``scripts/reparam_stereo_previous.cu``: a thread per (sample, example)
through the generic draw), variants of the kernel that this script
compiles from ``_VARIANT`` (a kernel on ``reparam_stereo.cu``'s device
functions with build flags, ``VARIANTS``: the generic instantiation for
every n; the per-example scalars recomputed for every sample; 1 and 2
samples a thread fixed; the sign taken at run time; 64-thread blocks; and
no flag, which must time as the kernel) and, with ``--baseline``, ``DIR``'s
``reparam_stereo.cu`` against ``DIR``'s headers (another copy of the
sources with the same entry point, such as an earlier commit's). Prints
ptxas's registers, stack frame and spills of every instantiation of every
build. Then, for the rows of ``ROWS`` (the IWAE chunks of d2,p2,e2's
components at sign +1 and -1, of u6 at sign 0, and the production chunk
over rotating buffer sets), times every build, the kernel on a
contiguous copy of the noise (where the row's noise is a strided view of
the product's block), the reparam skeleton (``roofline.skel_reparam``,
B8d, at the row's sign) and an empty kernel by ``roofline.measure`` (CUDA
events around a CUDA-graph replay of 100 calls), each the mean of two
turns (all runs, then all again in reverse order). Every build is held
bit for bit to the kernel, and the kernel to its plain version (z within
1e-5 (1 + |z|), log-densities within 1e-4 (1 + 0.01 |ref|)).

B8b. Builds the triad kernel of ``roofline_probes.cu`` (the text between
its ``triad`` markers) with 1, 2, 4 and 8 words of each input in flight a
thread (``TRIAD_UNROLL``), with its streaming cache hints and with plain
loads and stores in their place, behind a launcher that
takes the grid, and times each on grids of 8, 16 and 32 blocks of 256
threads an SM (1, 2 and 4 waves of a full SM) and of one block a tile, in
turns with ``torch.add(x, y, out=o)`` and the package's ``probe_triad``, at
the calibration shape (1,048,576, 128). Prints the instructions one
accurate ``tanhf`` takes in the tanh probe (``roofline.tanh_instructions``,
from ``cuobjdump -sass``) and the card's name and power limit. Needs a CUDA
card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mvae_torch.kernels import _build, manifold_kernels, roofline  # noqa: E402
from mvae_torch.ops import stereographic  # noqa: E402

PREVIOUS = Path(__file__).resolve().parent / "reparam_stereo_previous.cu"
# build flags of _VARIANT
VARIANTS = {
    "variant, no flag": [],
    "generic": ["-DVARIANT_GENERIC"],
    "no hoist": ["-DVARIANT_NOHOIST"],
    "spt 1": ["-DVARIANT_SPT=1"],
    "spt 2": ["-DVARIANT_SPT=2"],
    "runtime sign": ["-DVARIANT_ANY_SIGN"],
    "64 threads": ["-DVARIANT_THREADS=64"],
}
# reparam_stereo_kernel again, on the same device functions, with what the
# flags change: VARIANT_GENERIC draws every n by the generic instantiation,
# VARIANT_SPT fixes the samples a thread, VARIANT_NOHOIST recomputes the
# per-example scalars for every sample (stereo_draw), VARIANT_ANY_SIGN takes
# the sign at run time, VARIANT_THREADS sets the threads a block
_VARIANT = r"""
#include "reparam_stereo.cu"

#ifndef VARIANT_THREADS
#define VARIANT_THREADS REPARAM_THREADS
#endif
#define ANY_SIGN 2

template <int N, int SPT, int SIGN>
__global__ void __launch_bounds__(VARIANT_THREADS, 1)
variant_kernel(const float* __restrict__ eps, long long eps_stride,
               const float* __restrict__ mu, const float* __restrict__ sigma,
               const float* __restrict__ kptr, float* __restrict__ zt,
               int z_off, float* __restrict__ lq, float* __restrict__ lp,
               int S, int B, int n, int Z, int sign, int wraps) {
  const long long idx = (long long)blockIdx.x * VARIANT_THREADS + threadIdx.x;
  if (idx >= reparam_threads(S, B, SPT)) return;
  const int sgn = SIGN == ANY_SIGN ? sign : SIGN;
  const int nn = TAIL_DIM(N, n);
  const int b = (int)(idx % B);
  const int s0 = (int)(idx / B) * SPT;
  float m[TAIL_ARR(N)], sg[TAIL_ARR(N)];
  #pragma unroll
  for (int j = 0; j < nn; ++j) {
    m[j] = mu[(size_t)b * nn + j];
    sg[j] = sigma[(size_t)b * nn + j];
  }
  const float k = kptr[0];
  const float smax = ball_smax(k);
  float x2, ls;
  stereo_example<N>(n, m, sg, &x2, &ls);
  #pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = s0 + i < S ? s0 + i : S - 1;
    const long long pt = (long long)s * B + b;
    float* zr = zt + ((size_t)s * Z + z_off) * B + b;
#ifdef VARIANT_NOHOIST
    const float* ep = eps + eps_stride * pt;
    float e[TAIL_ARR(N)];
    #pragma unroll
    for (int j = 0; j < nn; ++j) e[j] = ep[j];
    StereoSaved<N> sv;
    float q, p;
    stereo_draw<N>(n, sgn, wraps, k, m, sg, e, &q, &p, sv);
    if (s0 + i >= S) continue;
    #pragma unroll
    for (int j = 0; j < nn; ++j) zr[(size_t)j * B] = sv.z[j];
    lq[pt] = q;
    lp[pt] = p;
#else
    reparam_point<N>(n, sgn, wraps, k, smax, x2, ls, m, sg,
                     eps + eps_stride * pt, s0 + i < S, zr, B, lq + pt,
                     lp + pt);
#endif
  }
}

template <int D, int SPT>
static const void* variant_sign(int sign) {
#ifdef VARIANT_ANY_SIGN
  return (const void*)variant_kernel<D, SPT, ANY_SIGN>;
#else
  return sign < 0   ? (const void*)variant_kernel<D, SPT, -1>
         : sign > 0 ? (const void*)variant_kernel<D, SPT, 1>
                    : (const void*)variant_kernel<D, SPT, 0>;
#endif
}

template <int D>
static const void* variant_spt(int spt, int sign) {
  return spt == 2 ? variant_sign<D, 2>(sign) : variant_sign<D, 1>(sign);
}

extern "C" int variant_launch(const float* eps, long long eps_stride,
                              const float* mu, const float* sigma,
                              const float* k, float* zt, int z_off, float* lq,
                              float* lp, int S, int B, int n, int Z, int sign,
                              int wraps, void* stream) {
  if (n < 1 || n > MAX_DIM || z_off < 0 || z_off + n > Z || sign < -1
      || sign > 1 || wraps < 0 || S < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
#ifdef VARIANT_SPT
  int spt = VARIANT_SPT;
#else
  int spt = 1;
  const cudaError_t err = reparam_spt(S, B, n, sign, &spt);
  if (err != cudaSuccess) return (int)err;
#endif
#ifdef VARIANT_GENERIC
  const int d = 0;
#else
  const int d = n == 2 || n == 3 || n == 6 ? n : 0;
#endif
  const void* kern = d == 2   ? variant_spt<2>(spt, sign)
                     : d == 3 ? variant_spt<3>(spt, sign)
                     : d == 6 ? variant_spt<6>(spt, sign)
                              : variant_spt<0>(spt, sign);
  const long long total = reparam_threads(S, B, spt);
  if (total == 0) return (int)cudaGetLastError();
  const long long blocks = (total + VARIANT_THREADS - 1) / VARIANT_THREADS;
  void* args[] = {&eps, &eps_stride, &mu, &sigma, &k, &zt, &z_off, &lq,
                  &lp,  &S,          &B,  &n,     &Z, &sign, &wraps};
  return (int)cudaLaunchKernel(kern, dim3((unsigned)blocks),
                               dim3(VARIANT_THREADS), args, 0,
                               (cudaStream_t)stream);
}
"""
# (label, S, B, n, sign, K, noise width E, rotating sets): n < E reads the
# component's columns of a (S, B, E) block, as d2,p2,e2's chunk does
ROWS = (("(125, 512, 2) sign +1", 125, 512, 2, 1, 1.0, 6, False),
        ("(125, 512, 2) sign -1", 125, 512, 2, -1, -1.0, 6, False),
        ("(125, 512, 6) sign 0", 125, 512, 6, 0, 0.5, 6, False),
        ("production (125, 2048, 6) sign -1", 125, 2048, 6, -1, -1.0, 6,
         True))
TRIAD_UNROLLS = (1, 2, 4, 8)
TRIAD_GRIDS = (8, 16, 32, 0)       # blocks an SM; 0: one block a tile
_TRIAD_PLAIN = """#define __ldcs(p) (*(p))
#define __stcs(p, v) (*(p) = (v))
"""
_TRIAD_LAUNCHER = r"""
extern "C" int triad_grid_launch(const float* x, const float* y, float* o,
                                 long long n4, int blocks, void* stream) {
  probe_triad_kernel<<<blocks, ELEM_THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y),
      reinterpret_cast<float4*>(o), n4);
  return (int)cudaGetLastError();
}
"""


def _turns(runs: dict, iters: int = 100) -> dict:
    """name -> [us, us]: every run timed, then all again in reverse."""
    times = {}
    order = list(runs)
    for name in order + order[::-1]:
        t = roofline.measure(runs[name], iters=iters, graph=True)
        times.setdefault(name, []).append(t.us)
    return times


def _fmt(times: dict) -> str:
    return "; ".join(f"{n} {sum(u) / 2:.2f} us ({u[0]:.2f}, {u[1]:.2f})"
                     for n, u in times.items())


def build_reparam(baseline: Path | None) -> dict:
    flags = _build.EXTRA_FLAGS["reparam_stereo"]
    out = _build.BUILD_DIR / "reparam_phases"
    out.mkdir(parents=True, exist_ok=True)
    variant = out / "variant.cu"
    variant.write_text(_VARIANT)
    specs = {"kernel": (_build.CSRC / "reparam_stereo.cu", flags),
             "previous design": (PREVIOUS, flags)}
    specs.update({tag: (variant, flags + f) for tag, f in VARIANTS.items()})
    if baseline is not None:
        specs["baseline"] = (baseline / "reparam_stereo.cu", flags)
    t0 = time.time()
    built = _build.build_variants(
        {tag.replace(" ", "_").replace(",", ""): spec
         for tag, spec in specs.items()}, out)
    print(f"[reparam] {len(specs)} builds together in "
          f"{time.time() - t0:.1f} s")
    fns = {}
    for tag, (lib, report) in zip(specs, built.values()):
        for ln in _build.ptxas_lines(report):
            print(f"[ptxas {tag}] {ln}")
        entry = "variant_launch" if tag in VARIANTS else "reparam_stereo_launch"
        fns[tag] = manifold_kernels.bind_reparam(lib, entry)
    return fns


def _inputs(S, B, n, kval, E, gen):
    noise = torch.randn(S, B, E, generator=gen, device="cuda")
    eps = noise[..., :n] if n < E else noise
    k = torch.tensor(kval, device="cuda")
    mu = stereographic.exp_map_mu0(
        0.3 * torch.randn(B, n, generator=gen, device="cuda")
        / max(abs(kval), 1.0) ** 0.5, k)
    sig = 0.2 + torch.rand(B, n, generator=gen, device="cuda")
    out = torch.zeros(S, E, B, device="cuda")
    lq = torch.empty(S, B, device="cuda")
    lp = torch.empty(S, B, device="cuda")
    return eps, mu, sig, k.reshape(1), out, lq, lp


def reparam_rows(fns: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    tiny = torch.zeros(1, device="cuda")
    for label, S, B, n, sign, kval, E, rotate in ROWS:
        n_sets = (roofline.buffer_sets(roofline.reparam_bytes(S, B, n),
                                       roofline._l2_bytes()) if rotate else 1)
        sets = [_inputs(S, B, n, kval, E, gen) for _ in range(n_sets)]

        def call(fn, a, contiguous=False):
            eps, mu, sig, k1, out, lq, lp, eps_c = a
            manifold_kernels.reparam_launch(fn, eps_c if contiguous else eps,
                                            mu, sig, k1, out, 0, lq, lp, sign,
                                            1)

        # contiguous copies of the noise, kept beside each set
        sets = [a + (a[0].contiguous(),) for a in sets]
        got = {}
        for name, fn in fns.items():
            a = sets[0]
            call(fn, a)
            torch.cuda.synchronize()
            got[name] = [a[4][:, :n].clone(), a[5].clone(), a[6].clone()]
        eps, mu, sig, k1 = sets[0][:4]
        ref = manifold_kernels.wrapped_reparam_stereo_ref(
            eps, mu, sig, k1.reshape(()), wraps=1, sign=sign)
        z, lq, lp = got["kernel"]
        ok = (bool(((z - ref[0]).abs() <= 1e-5 * (1 + ref[0].abs())).all())
              and all(bool(((a - r).abs() <= 1e-4 * (1 + 1e-2 * r.abs()))
                           .all()) for a, r in ((lq, ref[1]), (lp, ref[2]))))
        bits = {name: all(torch.equal(a, b) for a, b in zip(g, got["kernel"]))
                for name, g in got.items()}
        spt = manifold_kernels.reparam_spt(S, B, n, sign)
        print(f"[reparam {label}] {spt} sample(s) a thread; kernel within its "
              f"tolerance of the plain version: {ok}; bit-equal to the "
              f"kernel: {bits}", flush=True)
        if not ok or not all(bits.values()):
            raise RuntimeError(f"{label}: a variant disagrees")
        runs = {"empty kernel": tiny.zero_}
        for name, fn in fns.items():
            runs[name] = [functools.partial(call, fn, a) for a in sets]
        if n < E:
            runs["kernel, contiguous noise"] = [
                functools.partial(call, fns["kernel"], a, True) for a in sets]
        hoist = [roofline.reparam_scalars(a[1], a[2]) for a in sets]
        runs["skeleton"] = [
            functools.partial(roofline.skel_reparam, a[0], a[1], a[2],
                              a[3].reshape(()), h, a[4], sign=sign)
            for a, h in zip(sets, hoist)]
        times = _turns(runs)
        print(f"[reparam {label}] ({n_sets} buffer sets): {_fmt(times)}",
              flush=True)
        mean = {k: sum(v) / 2 for k, v in times.items()}
        print(f"[reparam {label}] previous design / kernel: "
              f"{mean['previous design'] / mean['kernel']:.3f}x"
              + (f"; baseline / kernel: "
                 f"{mean['baseline'] / mean['kernel']:.3f}x"
                 if "baseline" in mean else ""), flush=True)


def triad_phases() -> None:
    text = (_build.CSRC / "roofline_probes.cu").read_text()
    a = text.index("// --- triad (B8b) ---")
    b = text.index("// --- end triad ---")
    out = _build.BUILD_DIR / "triad_phases"
    out.mkdir(parents=True, exist_ok=True)
    head = "#include <cuda_runtime.h>\n#define ELEM_THREADS 256\n"
    (out / "triad_s1.cu").write_text(head + text[a:b] + _TRIAD_LAUNCHER)
    # the hints replaced by plain loads and stores
    (out / "triad_s0.cu").write_text(head + _TRIAD_PLAIN + text[a:b]
                                     + _TRIAD_LAUNCHER)
    specs = {f"u{u}s{st}": (out / f"triad_s{st}.cu", [f"-DTRIAD_UNROLL={u}"])
             for u in TRIAD_UNROLLS for st in (0, 1)}
    built = _build.build_variants(specs, out)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, N = roofline.B, roofline.N
    x = roofline._normal((B, N), 0, 0.05)
    y = roofline._normal((B, N), 1, 0.05)
    o = torch.empty_like(x)
    n4 = B * N // 4
    ref = x + y
    runs = {"torch.add": lambda: torch.add(x, y, out=o),
            "probe_triad (package)": lambda: roofline.probe_triad(x, y),
            "probe_triad (package, out=o)":
                lambda: roofline.probe_triad(x, y, out=o)}
    for tag, (lib, _) in built.items():
        fn = lib.triad_grid_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        u = int(tag[1:tag.index("s")])
        tiles = math.ceil(n4 / (256 * u))
        for per_sm in TRIAD_GRIDS:
            blocks = tiles if per_sm == 0 else min(tiles, sms * per_sm)

            def run(fn=fn, blocks=blocks):
                _build.check(fn(x.data_ptr(), y.data_ptr(), o.data_ptr(), n4,
                                blocks,
                                torch.cuda.current_stream().cuda_stream),
                             "triad_grid_launch")

            o.zero_()
            run()
            torch.cuda.synchronize()
            if not torch.equal(o, ref):
                raise RuntimeError(f"triad {tag} grid {per_sm}: not x + y")
            runs[f"{tag} grid {per_sm or 'tiles'}"] = run
    times = _turns(runs, iters=20)
    lib_us = sum(times["torch.add"]) / 2
    words = 3 * 4 * B * N
    for name, u in times.items():
        us = sum(u) / 2
        print(f"[triad] {name}: {us:.1f} us ({u[0]:.1f}, {u[1]:.1f}), "
              f"{words / us / 1e3:.1f} GB/s, {us / lib_us:.4f}x torch.add",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="a directory with another reparam_stereo.cu and "
                         "its headers, timed beside the package's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_reparam_phases: no CUDA device", file=sys.stderr)
        return 1
    baseline = Path(args.baseline).resolve() if args.baseline else None
    reparam_rows(build_reparam(baseline))
    triad_phases()
    tanh = roofline.tanh_instructions()
    print(f"[tanh probe] {tanh['instructions']} instructions in its loop "
          f"with {tanh['tanh']} tanh: {tanh['per_tanh']:.2f} a tanh")
    print(roofline.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
