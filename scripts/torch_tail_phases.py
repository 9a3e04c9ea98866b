#!/usr/bin/env python3
"""Where the tail kernels (B1 tail_fwd.cu, B3 tail_bwd.cu) spend their time,
on the card.

    python3 scripts/torch_tail_phases.py [--csrc DIR] [--batches 128,512]

Builds the two kernel sources of ``DIR`` (default: the tail kernels'
previous design, ``scripts/tail_previous``: one warp a component and each
tile serial on one thread, the layout the knobs below patch; the
package's split kernels have another layout, timed in turns with this
one by ``scripts/torch_tail_turns.py``) as they are and in variants
that leave a phase out or add one. It times every variant, the tail's I/O
skeleton (``roofline.skel_tail``, B1's and B3's floor) and an empty kernel
by ``roofline.measure`` (CUDA events around a CUDA-graph replay of 100
calls) for h2,s2,e2, d2,p2,e2 and s6:wrapped at each batch (at most
1024). Each time is the mean of two turns (all runs, then all again in
reverse order). The variants:

- ``kernel``: the source as it is;
- ``loads/stores``: every tile replaced by a sum of its row's inputs
  written to its outputs (B1 and B3);
- ``recompute`` (B3): the forward tiles alone, the reverse sweeps left out;
- ``residual writes`` (B1): the kernel, and every tile's saved
  intermediates written per (component, row) to a device array;
- ``residual reads`` (B3): the reverse sweeps on the intermediates that
  ``residual writes`` wrote for the same inputs, read from that array in
  place of the recompute. The two are the design that keeps residuals
  instead of recomputing the forward in B3: both are held bit for bit to
  the kernels, and a ``[residuals]`` line sets the sums of the two
  designs side by side;
- ``tile i``: the whole kernel on a one-component table (component i of
  the product alone, at its offsets); for a d/p/u or s component also with
  its wraps set to 0 (``tile i, wraps 0``: the drawn-radius sum at one
  branch instead of 9).

The variants that leave a phase out compute wrong values. The whole
kernels are held to the plain versions (B1 z within 1e-5 (1 + |z|) and the
log-densities 1e-4 (1 + 0.01 |ref|), B3 the raw gradient within rtol 1e-3 /
atol 5e-4 at these heads of training size). Prints one line a (kernel,
spec, batch), the ptxas report of the whole kernels and of single library
functions (``libm_frames``), and the card's name and power limit. Needs a
CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from mvae_torch.components import parse_components  # noqa: E402
from mvae_torch.kernels import _build, roofline, tail_kernels  # noqa: E402

SPECS = {"h2,s2,e2": (-1.0, 1.0, 0.0), "d2,p2,e2": (-1.0, 1.0, 0.0),
         "s6:wrapped": (1.0,)}

# The loads/stores body: the sum of the tile's inputs (k, the head slice,
# the noise slice and, for B3, the cotangents) written to its outputs
_SKEL_FWD = """  {
    const int nw = n + ns;
    float s_ = k;
    for (int j = 0; j < nw; ++j) s_ = s_ + r[j];
    for (int j = 0; j < n; ++j) s_ = s_ + e[j];
    for (int j = 0; j < n; ++j) z[j] = s_;
    *kl = s_;
    *q = s_;
    *p = s_;
    return;
  }
"""
_SKEL_BWD = """  {
    const int nw = n + ns;
    float s_ = k + gkl + glq + glp;
    for (int j = 0; j < nw; ++j) s_ = s_ + r[j];
    for (int j = 0; j < n; ++j) s_ = s_ + e[j] + gz[j];
    for (int j = 0; j < nw; ++j) dr[j] = s_;
    return s_;
  }
"""
# B3 with its reverse sweeps left out: the forward recompute, kept live
_RECOMPUTE_ONLY = """  {
    float zb_[MAX_DIM + 1], kl_, q_, p_;
    fwd_tile<D>(t, i, r, e, k, zb_, &kl_, &q_, &p_);
    for (int j = 0; j < n; ++j) dr[j] = zb_[j] * gz[j];
    return kl_ + q_ + p_;
  }
"""
# The residual design's array: a tile's saved intermediates per (component,
# row), word j of a slot at tail_res[j * RES_SLOTS + slot], slot =
# component * RES_ROWS + row, so a warp's 32 rows touch 32 adjacent words.
# B1's variant puts them (tail_res_put), B3's gets them in place of its
# recompute (tail_res_get).
_RES = r"""
#include <string.h>
#define RES_ROWS 1024
#define RES_WORDS 1024
#define RES_SLOTS (MAX_COMPS * RES_ROWS)
__device__ float* tail_res;
extern "C" int tail_res_set(float* p) {
  return (int)cudaMemcpyToSymbol(tail_res, &p, sizeof(p));
}
template <class S>
__device__ __forceinline__ void tail_res_put(const S& x, int base, int slot) {
  static_assert(sizeof(S) % 4 == 0, "saved structs are words");
  #pragma unroll
  for (int j = 0; j < (int)(sizeof(S) / 4); ++j) {
    float v;
    memcpy(&v, reinterpret_cast<const char*>(&x) + 4 * j, 4);
    tail_res[(size_t)(base + j) * RES_SLOTS + slot] = v;
  }
}
template <class S>
__device__ __forceinline__ void tail_res_get(S& x, int base, int slot) {
  #pragma unroll
  for (int j = 0; j < (int)(sizeof(S) / 4); ++j) {
    const float v = tail_res[(size_t)(base + j) * RES_SLOTS + slot];
    memcpy(reinterpret_cast<char*>(&x) + 4 * j, &v, 4);
  }
}
#define TAIL_RES_FWD_SLOT(i) \
  ((i) * RES_ROWS + blockIdx.x * TAIL_ROWS + threadIdx.x % TAIL_ROWS)
#define TAIL_RES_BWD_SLOT \
  (blockIdx.y * RES_ROWS + blockIdx.x * blockDim.x + threadIdx.x)
"""
RES_ROWS, RES_WORDS = 1024, 1024


def _body(text: str, sig: str) -> tuple[int, int]:
    """Start and end of the body of the function whose signature starts
    with ``sig`` (after its opening brace, at its closing one)."""
    a = text.index("{", text.index(sig)) + 1
    depth, i = 1, a
    while depth:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        i += 1
    return a, i - 1


def _knob_body(text: str, sig: str, flag: str, alt: str) -> str:
    a, b = _body(text, sig)
    a = text.index("switch", a)
    return (text[:a] + f"#ifdef {flag}\n{alt}#else\n" + text[a:b]
            + "#endif\n" + text[b:])


def _res_io(call: str, get: bool, slot: str) -> str:
    """The saved structs that a tile ``call`` fills (``h`` and ``s`` for the
    stereographic tile, ``s`` for the others), put to or got from the
    residual array."""
    structs = ["h", "s"] if re.search(r"\bh,\s*s\);", call) else ["s"]
    base, out = "0", ""
    for x in structs:
        out += f"  tail_res_{'get' if get else 'put'}({x}, {base}, {slot});\n"
        base = f"(int)(sizeof({x}) / 4)"
    return out


def variant_sources(csrc: Path, out: Path) -> None:
    """Copy ``csrc`` into ``out`` with the knobs in."""
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.glob("*.cu*"):
        shutil.copy(f, out / f.name)
    if not (out / "tail_grid.cuh").exists():
        raise SystemExit(f"{csrc}: no tail_grid.cuh, another layout")
    grid = (out / "tail_grid.cuh").read_text()
    mark = "// Warps of a forward block for nc components"
    grid = grid.replace(mark, _RES + "\n" + mark)
    grid = _knob_body(grid, "__device__ __forceinline__ void fwd_tile(",
                      "SKIP_TILES", _SKEL_FWD)
    # every tile that fills saved structs, followed by their writes
    a, b = _body(grid, "__device__ __forceinline__ void fwd_tile(")
    body, n = re.subn(
        r"      tile_\w+(<D>)?\(r, e,[^;]*\bs\);\n",
        lambda m: (m.group(0) + "#ifdef RES_WRITE\n"
                   + _res_io(m.group(0), False, "TAIL_RES_FWD_SLOT(i)")
                   + "#endif\n"), grid[a:b])
    if n != 4:
        raise RuntimeError(f"fwd_tile: {n} tiles with saved structs, not 4")
    (out / "tail_grid.cuh").write_text(grid[:a] + body + grid[b:])
    bwd = (out / "tail_bwd.cu").read_text()
    bwd = _knob_body(bwd, "__device__ __forceinline__ float bwd_tile(",
                     "SKIP_TILES", _SKEL_BWD)
    bwd = _knob_body(bwd, "__device__ __forceinline__ float bwd_tile(",
                     "SKIP_REVERSE", _RECOMPUTE_ONLY)
    # every recompute inside a reverse sweep (the tile call that writes
    # zbuf), replaced by a read of its saved structs
    bwd, n = re.subn(
        r"  tile_\w+(<N>)?\(raw, eps,[^;]*zbuf[^;]*;\n",
        lambda m: ("#ifdef RES_READ\n"
                   + _res_io(m.group(0), True, "TAIL_RES_BWD_SLOT")
                   + f"#else\n{m.group(0)}#endif\n"), bwd)
    if n != 4:
        raise RuntimeError(f"tail_bwd.cu: {n} recomputes, not 4")
    (out / "tail_bwd.cu").write_text(bwd)


def build(csrc: Path, tag: str, res: torch.Tensor) -> tuple[dict, str]:
    """{(kernel, variant): launcher} and the ptxas report of the whole
    kernels; the residual variants' array is ``res``."""
    out = _build.BUILD_DIR / "tail_phases" / tag
    variant_sources(csrc, out)
    variants = {("fwd", "kernel"): [], ("fwd", "loads/stores"):
                ["-DSKIP_TILES"], ("fwd", "residual writes"): ["-DRES_WRITE"],
                ("bwd", "kernel"): [], ("bwd", "loads/stores"):
                ["-DSKIP_TILES"], ("bwd", "recompute"): ["-DSKIP_REVERSE"],
                ("bwd", "residual reads"): ["-DRES_READ"]}
    procs = {}
    for i, ((kern, name), flags) in enumerate(variants.items()):
        lib = out / f"v{i}.so"
        src = out / f"tail_{kern}.cu"
        cmd = [_build.nvcc_path(), *_build._ARCH, *_build._COMMON,
               "--fmad=false", *flags, "-I", str(out), "-o", str(lib),
               str(src)]
        procs[(kern, name)] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    fns, report = {}, ""
    for (kern, name), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {kern} {name}:\n{log}")
        if name == "kernel":
            report += "".join(f"[ptxas {tag} {kern}] {ln.strip()}\n"
                              for ln in log.splitlines()
                              if "registers" in ln or "stack" in ln
                              or "Compiling entry" in ln)
        so = ctypes.CDLL(str(lib))
        fn = getattr(so, f"tail_{kern}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (5 if kern == "fwd" else 10)
                       + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fns[(kern, name)] = fn
        so.tail_res_set.argtypes = [ctypes.c_void_p]
        _build.check(so.tail_res_set(res.data_ptr()), "tail_res_set")
    return fns, report


# One library function a kernel: what each takes of a stack frame on its
# own (the accurate sinf / cosf reduce a huge argument through a local
# array, the Payne-Hanek slow path)
_LIBM = "".join(
    f"__global__ void libm_{f}(float* x) {{ x[0] = {f}(x[0]); }}\n"
    for f in ("sinf", "cosf", "tanf", "expf", "logf", "log1pf", "atanf",
              "tanhf", "sqrtf")) + (
    "__global__ void libm_powf(float* x) { x[0] = powf(x[0], x[1]); }\n"
    "__global__ void libm_sinf_x8(float* x) {\n"
    "  float s = 0.f;\n"
    "  for (int i = 0; i < 8; ++i) s = s + sinf(x[i]) * cosf(x[8 + i]);\n"
    "  x[0] = s;\n"
    "}\n")


def libm_frames() -> str:
    """ptxas's report of ``_LIBM``, built as the tail kernels are."""
    out = _build.BUILD_DIR / "tail_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "libm.cu").write_text("#include <math.h>\n" + _LIBM)
    proc = subprocess.run([_build.nvcc_path(), *_build._ARCH,
                           *_build._COMMON, "--fmad=false", "-o",
                           str(out / "libm.so"), str(out / "libm.cu")],
                          capture_output=True, text=True, check=True)
    lines, name = [], ""
    for ln in proc.stdout.splitlines() + proc.stderr.splitlines():
        if "Compiling entry" in ln:
            name = ln.split("'")[1]
        elif "stack frame" in ln:
            lines.append(f"[ptxas libm] {name}: {ln.strip()}")
    return "\n".join(lines) + "\n"


def _table(comps, only=None, wraps0=False):
    """The kernels' component table (8 ints a row), of component ``only``
    alone when given, with every wraps set to 0 on request."""
    rows = list(tail_kernels._table(comps))
    tab = [rows[8 * i:8 * i + 8] for i in range(len(comps))]
    if only is not None:
        tab = [tab[only]]
    if wraps0:
        tab = [r[:7] + [0] for r in tab]
    flat = [v for r in tab for v in r]
    return (ctypes.c_int * len(flat))(*flat), len(tab)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=str(Path(__file__).resolve().parent
                                          / "tail_previous"))
    ap.add_argument("--batches", default="128,512")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tail_phases: no CUDA device", file=sys.stderr)
        return 1
    batches = [int(b) for b in args.batches.split(",")]
    if max(batches) > RES_ROWS:
        raise SystemExit(f"batches up to {RES_ROWS}")
    csrc = Path(args.csrc).resolve()
    tag = "current" if csrc == _build.CSRC.resolve() else csrc.name
    res = torch.zeros(RES_WORDS * tail_kernels.MAX_COMPS * RES_ROWS,
                      device="cuda")
    fns, report = build(csrc, tag, res)
    print(libm_frames() + report, end="")
    tiny = torch.zeros(1, device="cuda")
    counter = torch.zeros(tail_kernels.MAX_COMPS, dtype=torch.int32,
                          device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for spec, kset in SPECS.items():
        comps = tuple(parse_components(spec, fixed_curvature=False))
        W, E, Z = tail_kernels._dims(comps)
        nc = len(comps)
        for B in batches:
            raw = 0.5 * torch.randn(B, W, generator=gen, device="cuda")
            eps = tail_kernels.draw_noise(comps, (B,), raw, gen)
            k = torch.tensor(kset, device="cuda")
            dz = torch.randn(B, Z, generator=gen, device="cuda")
            daux = torch.randn(B, nc + 2, generator=gen, device="cuda")
            outs = {"fwd": [torch.empty(B, Z, device="cuda"),
                            torch.empty(B, nc + 2, device="cuda")],
                    "bwd": [torch.empty(B, W, device="cuda"),
                            torch.empty(B, nc, device="cuda"),
                            torch.empty(nc, device="cuda")]}
            part = torch.empty(-(-B // 32), nc, device="cuda")

            def call(kern, name, only=None, wraps0=False):
                fn = fns[(kern, name)]
                tab, n = _table(comps, only, wraps0)
                st = torch.cuda.current_stream().cuda_stream
                if kern == "fwd":
                    a = [raw, eps, k, *outs["fwd"]]
                else:
                    a = [raw, eps, k, dz, daux, *outs["bwd"], part, counter]
                _build.check(fn(*[t.data_ptr() for t in a], B, W, E, Z, n,
                                tab, st), f"tail_{kern}_launch")

            def got(kern):
                torch.cuda.synchronize()
                return [t.clone() for t in outs[kern]]

            # the whole kernels against the plain versions, then the
            # residual design against the whole kernels, bit for bit
            call("fwd", "kernel")
            call("bwd", "kernel")
            whole = {kern: got(kern) for kern in ("fwd", "bwd")}
            z, aux = whole["fwd"]
            draw = whole["bwd"][0]
            z_r, aux_r = tail_kernels.tail_forward_ref(comps, raw, eps, k)
            d_r = tail_kernels.tail_backward_ref(comps, raw, eps, k, dz,
                                                 daux)[0]
            if not (bool(((z - z_r).abs() <= 1e-5 * (1 + z_r.abs())).all())
                    and bool(((aux - aux_r).abs()
                              <= 1e-4 * (1 + 1e-2 * aux_r.abs())).all())
                    and bool(((draw - d_r).abs()
                              <= 1e-3 * d_r.abs() + 5e-4).all())):
                raise RuntimeError(f"{tag} {spec} B={B}: the whole kernels "
                                   f"disagree with the plain versions")
            res.zero_()
            call("fwd", "residual writes")
            fw = got("fwd")
            call("bwd", "residual reads")
            bw = got("bwd")
            if not all(torch.equal(a, b) for a, b in
                       zip(fw + bw, whole["fwd"] + whole["bwd"])):
                raise RuntimeError(f"{tag} {spec} B={B}: the residual "
                                   f"design differs from the kernels")
            cot = {"fwd": (), "bwd": (dz, daux)}
            means = {}
            for kern in ("fwd", "bwd"):
                runs = {"empty kernel": tiny.zero_}
                for (kk, name) in fns:
                    if kk == kern:
                        runs[name] = (lambda n=name: call(kern, n))
                runs["skeleton"] = (lambda c=cot[kern]: roofline.skel_tail(
                    comps, raw, eps, k, *c))
                for i, c in enumerate(comps):
                    runs[f"tile {i} ({c.manifold.kind}{c.dim})"] = (
                        lambda i=i: call(kern, "kernel", only=i))
                    if c.posterior == "wrapped" and c.manifold.kind in "dpus":
                        runs[f"tile {i}, wraps 0"] = (
                            lambda i=i: call(kern, "kernel", only=i,
                                             wraps0=True))
                times = {}
                order = list(runs)
                for name in order + order[::-1]:
                    t = roofline.measure(runs[name], iters=100, graph=True)
                    times.setdefault(name, []).append(t.us)
                means[kern] = {n: sum(u) / 2 for n, u in times.items()}
                print(f"[phases {tag}] B{'1' if kern == 'fwd' else '3'} "
                      f"{spec} B={B}: " + "; ".join(
                          f"{n} {sum(u) / 2:.2f} us ({u[0]:.2f}, {u[1]:.2f})"
                          for n, u in times.items()), flush=True)
            f, b = means["fwd"], means["bwd"]
            rec = f["kernel"] + b["kernel"]
            kept = f["residual writes"] + b["residual reads"]
            print(f"[residuals {tag}] {spec} B={B}: recompute B1 "
                  f"{f['kernel']:.2f} + B3 {b['kernel']:.2f} = {rec:.2f} us; "
                  f"residuals B1 {f['residual writes']:.2f} + B3 "
                  f"{b['residual reads']:.2f} = {kept:.2f} us "
                  f"({'residuals' if kept < rec else 'recompute'} shorter "
                  f"by {abs(rec - kept):.2f} us)", flush=True)
    print(roofline.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
