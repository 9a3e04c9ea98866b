"""The CUDA sources of the tail, reparam and distance kernels, compiled for
the host.

The device code of ``mvae_torch/kernels/csrc`` is plain C++ apart from its
qualifiers and its launch syntax, so a machine without ``nvcc`` can still
check its arithmetic: each source is cut before its ``extern "C"`` launcher,
compiled by ``g++`` against a small stand-in for ``cuda_runtime.h`` (empty
qualifiers, ``blockIdx`` / ``threadIdx`` as globals, ``rsqrtf``), and its
kernel function is called once per thread index from a host loop. The
forward tiles, the hand-derived backward and the IWAE chunk reparam are held
against their plain PyTorch versions on the same inputs. The distance
kernels sum a row across a warp by shuffles, which a host loop cannot
stand in for, so of them the scalar tails (from a row's Gram values to the
distance) are compiled and held here, and the reductions on the card. Of
the IWAE decode, which runs on the tensor cores, the TF32 split of its
operands (``csrc/tf32.cuh``) is compiled and held to ``tf32_split_ref``
bit for bit, and its image launch (``w_image_kernel``: W2, b1 and W1 split
into the stage images the main launch streams, cut before the main launch)
against ``decode_image_ref``; of the training decode, its tile plan and h
shares (``csrc/train_decode_plan.cuh``), against ``train_tile_plan``.

This checks the expressions and the reverse sweep, not the build for the
card or the launch: those are ``chip_smoke.py``'s and the ``-m cuda`` tests'.
Compiled with ``-ffp-contract=off`` (the card's build uses ``--fmad=false``).

Tolerances: forward z within 1e-5 (1 + |z|) and log-densities within 1e-4
(the card's contract; libm and CUDA round transcendentals differently from
PyTorch's vectorized CPU kernels by a few ulps). Backward: the float32
contract of the reference's in-kernel VJP, rtol 1e-3 / atol 5e-4 on the raw
gradient and rtol 2e-3 on the batch-summed curvature gradient.
"""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from mvae_torch.components import parse_components
from mvae_torch.kernels import decoder_kernels as tdk
from mvae_torch.kernels import manifold_kernels as tmk
from mvae_torch.kernels import tail_kernels as ttk

CSRC = Path(ttk.__file__).resolve().parent / "csrc"
# the tail kernels' previous design, frozen (scripts/tail_previous)
PREVIOUS = Path(__file__).resolve().parents[1] / "scripts" / "tail_previous"

_STUB = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
struct HostIdx { int x, y; };
static HostIdx blockIdx, threadIdx;
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
struct float4 { float x, y, z, w; };
static inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
#define __shared__ static
static inline void __syncthreads() {}
static inline void __threadfence() {}
static inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p += v;
  return old;
}
static inline float __ldcg(const float* p) { return *p; }
static inline int min(int a, int b) { return a < b ? a : b; }
static HostIdx gridDim;
struct uint4 { unsigned x, y, z, w; };
static inline uint4 make_uint4(unsigned x, unsigned y, unsigned z,
                               unsigned w) {
  return {x, y, z, w};
}
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline unsigned __float_as_uint(float f) {
  unsigned u;
  __builtin_memcpy(&u, &f, sizeof u);
  return u;
}
"""

_HARNESS = {
    "tail_fwd": r"""
#include <vector>

template <int D>
static void run_fwd(const float* raw, const float* eps, const float* k,
                    float* z, float* aux, int B, int W, int E, int Z,
                    const TailTable& t) {
  if (!tail_any_split(t)) {
    float sh[2 * MAX_COMPS * TAIL_ROWS];
    const int threads = TAIL_ROWS * tail_warps(t.nc);
    for (int b = 0; b < tail_blocks(B); ++b) {
      for (int tid = 0; tid < threads; ++tid)
        fwd_rows<D>(raw, eps, k, z, aux, B, W, E, Z, t, b, tid, sh);
      for (int tid = 0; tid < threads; ++tid)
        fwd_sums(aux, B, t.nc, b, tid, sh);
    }
    return;
  }
  // the split geometry: each block's shared floats NaN before it runs, so a
  // read of a float no phase wrote shows
  std::vector<float> sh(TAIL_SPLIT_ROWS * t.row_floats);
  for (int b = 0; b < tail_split_blocks(B); ++b) {
    for (float& v : sh) v = NAN;
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      fwd_split_coords<D>(raw, eps, k, z, aux, B, W, E, Z, t, b, tid,
                          sh.data());
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      fwd_split_owners<D>(k, z, B, Z, t, b, tid, sh.data());
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      fwd_split_branches(B, t, b, tid, sh.data());
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      fwd_split_sums(aux, B, t, b, tid, sh.data());
  }
}

// One block after another, each thread of a block through a phase before
// any thread starts the next (the kernel's __syncthreads), on the geometry
// and instantiation the launcher picks
extern "C" void host_run(const float* raw, const float* eps, const float* k,
                         float* z, float* aux, int B, int W, int E, int Z,
                         int nc, const int* table) {
  TailTable t;
  if (!tail_table_from(table, nc, &t)) return;
  switch (tail_dim_class(t)) {
    case 2: run_fwd<2>(raw, eps, k, z, aux, B, W, E, Z, t); break;
    case 3: run_fwd<3>(raw, eps, k, z, aux, B, W, E, Z, t); break;
    case 6: run_fwd<6>(raw, eps, k, z, aux, B, W, E, Z, t); break;
    default: run_fwd<0>(raw, eps, k, z, aux, B, W, E, Z, t);
  }
}
""",
    "tail_bwd": r"""
#include <vector>

// The blocks of a component that runs a row on one thread (bwd_rows), with
// `threads` threads a block (the split geometry launches TAIL_THREADS)
template <int D>
static void run_rows(const float* raw, const float* eps, const float* k,
                     const float* dz, const float* daux, float* draw,
                     float* dk_rows, float* dk, float* part,
                     unsigned* counter, int B, int W, int E, int Z,
                     const TailTable& t, int c, int threads) {
  float sh[TAIL_GROUPS * TAIL_ROWS], gs[TAIL_GROUPS];
  const int blocks = tail_bwd_blocks(B);
  for (int bx = 0; bx < blocks; ++bx) {
    for (int tid = 0; tid < threads; ++tid)
      bwd_rows<D>(raw, eps, k, dz, daux, draw, dk_rows, B, W, E, Z, t, c, bx,
                  tid, sh);
    for (int tid = 0; tid < threads; ++tid)
      tail_fold_groups(B, bx, tid, sh, gs);
    if (blocks == 1) {
      for (int tid = 0; tid < threads; ++tid)
        tail_fold_direct(B, c, tid, gs, dk);
      continue;
    }
    for (int tid = 0; tid < threads; ++tid)
      tail_fold_publish(B, t.nc, c, bx, tid, gs, part);
    if (tail_fold_ticket(counter + c, blocks))
      for (int tid = 0; tid < threads; ++tid)
        tail_fold_last(B, t.nc, c, tid, part, dk, counter);
  }
}

// A split component's blocks: its phases for every thread in turn, each
// thread's saved intermediates `S` kept from its phase 1 to its phase 4
// (the registers a thread keeps across the kernel's barriers), the shared
// floats NaN before each block; then the ticket and the last block's fold
template <int D, class S>
static void run_split(const float* raw, const float* eps, const float* k,
                      const float* dz, const float* daux, float* draw,
                      float* dk_rows, float* dk, float* part,
                      unsigned* counter, int B, int W, int E, int Z,
                      const TailTable& t, int c) {
  std::vector<float> sh(TAIL_SPLIT_ROWS * TAIL_BWD_ROW);
  std::vector<S> st(TAIL_THREADS);
  const int blocks = tail_split_blocks(B);
  for (int bx = 0; bx < blocks; ++bx) {
    for (float& v : sh) v = NAN;
    float* s = sh.data();
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      bwd_split_coords<D>(raw, eps, k, dz, daux, B, W, E, Z, t, c, bx, tid, s,
                          st[tid]);
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      bwd_split_owner<D>(k, B, t, c, bx, tid, s, st[tid]);
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      bwd_split_branches(B, t, c, bx, tid, s);
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      bwd_split_records(B, t, c, bx, tid, s);
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      bwd_split_reverse<D>(k, draw, B, W, t, c, bx, tid, s, st[tid]);
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      bwd_split_sigma<D>(k, draw, B, W, t, c, bx, tid, s, st[tid]);
    for (int tid = 0; tid < TAIL_THREADS; ++tid)
      bwd_split_final<D>(k, draw, dk_rows, B, W, t, c, bx, tid, s, st[tid]);
    if (tail_fold_ticket(counter + c, blocks)) {
      float total = NAN;
      for (int r0 = 0; r0 < B; r0 += TAIL_FOLD_CHUNK) {
        for (float& v : sh) v = NAN;
        for (int tid = 0; tid < TAIL_THREADS; ++tid)
          tail_split_fold_stage(B, t.nc, c, r0, tid, dk_rows, s);
        for (int tid = 0; tid < TAIL_THREADS; ++tid)
          tail_split_fold_groups(B, r0, tid, s);
        for (int tid = 0; tid < TAIL_THREADS; ++tid)
          tail_split_fold_total(B, c, r0, tid, s, &total, dk, counter);
      }
    }
  }
}

template <int D>
static void run_bwd(const float* raw, const float* eps, const float* k,
                    const float* dz, const float* daux, float* draw,
                    float* dk_rows, float* dk, float* part,
                    unsigned* counter, int B, int W, int E, int Z,
                    const TailTable& t) {
  for (int c = 0; c < t.nc; ++c) {
    if (!tail_any_split(t))
      run_rows<D>(raw, eps, k, dz, daux, draw, dk_rows, dk, part, counter, B,
                  W, E, Z, t, c, tail_bwd_threads(B));
    else if (!t.split[c])
      run_rows<D>(raw, eps, k, dz, daux, draw, dk_rows, dk, part, counter, B,
                  W, E, Z, t, c, TAIL_THREADS);
    else if (t.kind[c] == KIND_WRAPPED_STEREO)
      run_split<D, SplitStereo<D>>(raw, eps, k, dz, daux, draw, dk_rows, dk,
                                   part, counter, B, W, E, Z, t, c);
    else
      run_split<D, SplitSphere<D>>(raw, eps, k, dz, daux, draw, dk_rows, dk,
                                   part, counter, B, W, E, Z, t, c);
  }
}

// Block (bx, c) after block, each thread of a block through a phase before
// any thread starts the next (the kernel's __syncthreads), on the geometry
// and instantiation the launcher picks
extern "C" void host_run(const float* raw, const float* eps, const float* k,
                         const float* dz, const float* daux, float* draw,
                         float* dk_rows, float* dk, float* part,
                         unsigned* counter, int B, int W, int E, int Z,
                         int nc, const int* table) {
  TailTable t;
  if (!tail_table_from(table, nc, &t)) return;
  switch (tail_dim_class(t)) {
    case 2:
      run_bwd<2>(raw, eps, k, dz, daux, draw, dk_rows, dk, part, counter, B,
                 W, E, Z, t);
      break;
    case 3:
      run_bwd<3>(raw, eps, k, dz, daux, draw, dk_rows, dk, part, counter, B,
                 W, E, Z, t);
      break;
    case 6:
      run_bwd<6>(raw, eps, k, dz, daux, draw, dk_rows, dk, part, counter, B,
                 W, E, Z, t);
      break;
    default:
      run_bwd<0>(raw, eps, k, dz, daux, draw, dk_rows, dk, part, counter, B,
                 W, E, Z, t);
  }
}
""",
    "tail_fwd_previous": r"""
template <int D>
static void run_fwd(const float* raw, const float* eps, const float* k,
                    float* z, float* aux, int B, int W, int E, int Z,
                    const TailTable& t) {
  float sh[2 * MAX_COMPS * TAIL_ROWS];
  const int threads = TAIL_ROWS * tail_warps(t.nc);
  for (int b = 0; b < tail_blocks(B); ++b) {
    for (int tid = 0; tid < threads; ++tid)
      fwd_rows<D>(raw, eps, k, z, aux, B, W, E, Z, t, b, tid, sh);
    for (int tid = 0; tid < threads; ++tid) fwd_sums(aux, B, t.nc, b, tid, sh);
  }
}

// One block after another, each thread of a block through a phase before
// any thread starts the next (the kernel's __syncthreads), on the
// instantiation the launcher picks
extern "C" void host_run(const float* raw, const float* eps, const float* k,
                         float* z, float* aux, int B, int W, int E, int Z,
                         int nc, const int* table) {
  TailTable t;
  if (!tail_table_from(table, nc, &t)) return;
  switch (tail_dim_class(t)) {
    case 2: run_fwd<2>(raw, eps, k, z, aux, B, W, E, Z, t); break;
    case 3: run_fwd<3>(raw, eps, k, z, aux, B, W, E, Z, t); break;
    case 6: run_fwd<6>(raw, eps, k, z, aux, B, W, E, Z, t); break;
    default: run_fwd<0>(raw, eps, k, z, aux, B, W, E, Z, t);
  }
}
""",
    "tail_bwd_previous": r"""
template <int D>
static void run_bwd(const float* raw, const float* eps, const float* k,
                    const float* dz, const float* daux, float* draw,
                    float* dk_rows, float* dk, float* part,
                    unsigned* counter, int B, int W, int E, int Z,
                    const TailTable& t) {
  float sh[TAIL_GROUPS * TAIL_ROWS], gs[TAIL_GROUPS];
  const int threads = tail_bwd_threads(B), blocks = tail_bwd_blocks(B);
  for (int c = 0; c < t.nc; ++c) {
    for (int bx = 0; bx < blocks; ++bx) {
      for (int tid = 0; tid < threads; ++tid)
        bwd_rows<D>(raw, eps, k, dz, daux, draw, dk_rows, B, W, E, Z, t, c,
                    bx, tid, sh);
      for (int tid = 0; tid < threads; ++tid)
        tail_fold_groups(B, bx, tid, sh, gs);
      if (blocks == 1) {
        for (int tid = 0; tid < threads; ++tid)
          tail_fold_direct(B, c, tid, gs, dk);
        continue;
      }
      for (int tid = 0; tid < threads; ++tid)
        tail_fold_publish(B, t.nc, c, bx, tid, gs, part);
      if (tail_fold_ticket(counter + c, blocks))
        for (int tid = 0; tid < threads; ++tid)
          tail_fold_last(B, t.nc, c, tid, part, dk, counter);
    }
  }
}

// Block (bx, c) after block, each thread of a block through a phase before
// any thread starts the next (the kernel's __syncthreads), on the
// instantiation the launcher picks
extern "C" void host_run(const float* raw, const float* eps, const float* k,
                         const float* dz, const float* daux, float* draw,
                         float* dk_rows, float* dk, float* part,
                         unsigned* counter, int B, int W, int E, int Z,
                         int nc, const int* table) {
  TailTable t;
  if (!tail_table_from(table, nc, &t)) return;
  switch (tail_dim_class(t)) {
    case 2:
      run_bwd<2>(raw, eps, k, dz, daux, draw, dk_rows, dk, part, counter, B,
                 W, E, Z, t);
      break;
    case 3:
      run_bwd<3>(raw, eps, k, dz, daux, draw, dk_rows, dk, part, counter, B,
                 W, E, Z, t);
      break;
    case 6:
      run_bwd<6>(raw, eps, k, dz, daux, draw, dk_rows, dk, part, counter, B,
                 W, E, Z, t);
      break;
    default:
      run_bwd<0>(raw, eps, k, dz, daux, draw, dk_rows, dk, part, counter, B,
                 W, E, Z, t);
  }
}
""",
    "reparam_stereo": r"""
template <int D, int SPT>
static void run_reparam(const float* eps, long long stride, const float* mu,
                        const float* sigma, const float* k, float* zt,
                        int z_off, float* lq, float* lp, int S, int B, int n,
                        int Z, int sign, int wraps) {
  for (long long i = 0; i < reparam_threads(S, B, SPT); ++i) {
    blockIdx.x = (int)(i / REPARAM_THREADS);
    threadIdx.x = (int)(i % REPARAM_THREADS);
    if (sign < 0)
      reparam_stereo_kernel<D, SPT, -1>(eps, stride, mu, sigma, k, zt, z_off,
                                        lq, lp, S, B, n, Z, wraps);
    else if (sign > 0)
      reparam_stereo_kernel<D, SPT, 1>(eps, stride, mu, sigma, k, zt, z_off,
                                       lq, lp, S, B, n, Z, wraps);
    else
      reparam_stereo_kernel<D, SPT, 0>(eps, stride, mu, sigma, k, zt, z_off,
                                       lq, lp, S, B, n, Z, wraps);
  }
}

template <int D>
static void run_spt(const float* eps, long long stride, const float* mu,
                    const float* sigma, const float* k, float* zt, int z_off,
                    float* lq, float* lp, int S, int B, int n, int Z,
                    int sign, int wraps, int spt) {
  if (spt == 2)
    run_reparam<D, 2>(eps, stride, mu, sigma, k, zt, z_off, lq, lp, S, B, n,
                      Z, sign, wraps);
  else
    run_reparam<D, 1>(eps, stride, mu, sigma, k, zt, z_off, lq, lp, S, B, n,
                      Z, sign, wraps);
}

// The kernel, thread after thread, on the instantiation the launcher picks
// for n, the sign and spt samples a thread
extern "C" void host_run(const float* eps, long long stride, const float* mu,
                         const float* sigma, const float* k, float* zt,
                         int z_off, float* lq, float* lp, int S, int B, int n,
                         int Z, int sign, int wraps, int spt) {
  switch (n) {
    case 2: run_spt<2>(eps, stride, mu, sigma, k, zt, z_off, lq, lp, S, B, n,
                       Z, sign, wraps, spt); break;
    case 3: run_spt<3>(eps, stride, mu, sigma, k, zt, z_off, lq, lp, S, B, n,
                       Z, sign, wraps, spt); break;
    case 6: run_spt<6>(eps, stride, mu, sigma, k, zt, z_off, lq, lp, S, B, n,
                       Z, sign, wraps, spt); break;
    default: run_spt<0>(eps, stride, mu, sigma, k, zt, z_off, lq, lp, S, B,
                        n, Z, sign, wraps, spt);
  }
}

// The generic draw a point at a time: stereo_draw<0>, the per-example
// scalars recomputed for every sample
extern "C" void host_generic(const float* eps, long long stride,
                             const float* mu, const float* sigma,
                             const float* k, float* zt, int z_off, float* lq,
                             float* lp, int S, int B, int n, int Z, int sign,
                             int wraps, int) {
  for (long long i = 0; i < (long long)S * B; ++i) {
    const int b = (int)(i % B), s = (int)(i / B);
    float m[MAX_DIM], sg[MAX_DIM], e[MAX_DIM];
    for (int j = 0; j < n; ++j) {
      m[j] = mu[b * n + j];
      sg[j] = sigma[b * n + j];
      e[j] = eps[stride * i + j];
    }
    StereoSaved<0> sv;
    stereo_draw<0>(n, sign, wraps, k[0], m, sg, e, lq + i, lp + i, sv);
    for (int j = 0; j < n; ++j)
      zt[((long long)s * Z + z_off + j) * B + b] = sv.z[j];
  }
}
""",
    "tf32": r"""
extern "C" void host_run(const float* a, unsigned* hi, unsigned* lo, int n) {
  for (int i = 0; i < n; ++i) tf32_split(a[i], hi[i], lo[i]);
}
""",
    "decode_bce": r"""
extern "C" void host_run(const float* w1, const float* b1, const float* w2,
                         unsigned* img, int Z, int H, int D) {
  const int nK = (H + BK - 1) / BK, nD = (D + BN - 1) / BN;
  for (blockIdx.x = 0; blockIdx.x < nK * nD; ++blockIdx.x)
    for (blockIdx.y = 0; blockIdx.y < IMAGE_PARTS; ++blockIdx.y)
      for (threadIdx.x = 0; threadIdx.x < IMAGE_NT; ++threadIdx.x)
        w_image_kernel(w1, b1, w2, img, Z, H, D, nK, (Z + ZK - 1) / ZK);
}
""",
    "train_decode_plan": r"""
extern "C" void host_run(const int* shape, long long* plan, int* share) {
  TdPlan p;
  plan[0] = td_plan(shape[0], shape[1], shape[2], shape[3], &p);
  if (!plan[0]) return;
  const long long v[8] = {p.row_tiles, p.pixel_tiles, p.stages, p.slots,
                          p.hp,        p.fetch,       (long long)p.smem,
                          (long long)p.part};
  for (int i = 0; i < 8; ++i) plan[1 + i] = v[i];
  const int rows = shape[0] < TD_BM ? shape[0] : TD_BM;
  for (int pt = 0; pt < p.pixel_tiles; ++pt)
    td_share(rows, shape[2], p.pixel_tiles, pt, share + 2 * pt,
             share + 2 * pt + 1);
}
""",
    "manifold_dist": r"""
extern "C" void host_run(int lorentz, const float* k, const float* a,
                         const float* b, const float* c, float* out, int B) {
  for (int i = 0; i < B; ++i)
    out[i] = lorentz ? lorentz_dist_tail(k[0], a[i])
                     : stereo_dist_tail(k[0], a[i], b[i], c[i]);
}
""",
}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """name -> the kernel function's host harness, built once per module
    (one g++ a source, all started together). ``*_previous`` is the tail
    kernels' previous design (``scripts/tail_previous``), built against its
    own headers."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    work = tmp_path_factory.mktemp("csrc_host")
    for d, headers in ((work, CSRC), (work / "previous", PREVIOUS)):
        d.mkdir(exist_ok=True)
        (d / "cuda_runtime.h").write_text(_STUB)
        for header in headers.glob("*.cuh"):
            shutil.copy(header, d / header.name)
    procs = {}
    for name, harness in _HARNESS.items():
        base = name.removesuffix("_previous")
        d = work / "previous" if base != name else work
        source = (PREVIOUS if base != name else CSRC) / f"{base}.cu"
        text = source.read_text() if source.exists() else ""
        cut = next((m for m in ("// --- launchers", "// --- the main launch")
                    if m in text), 'extern "C"')
        body = text.split(cut)[0] if text else f'#include "{name}.cuh"\n'
        src = d / f"{base}.cpp"
        src.write_text(body + harness)
        out = d / f"{base}.so"
        procs[name] = (subprocess.Popen(
            [gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I",
             str(d), "-o", str(out), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ failed for {name}:\n{log}"
        lib = ctypes.CDLL(str(out))
        libs[name] = lib.host_run
        libs[name].restype = None
        if name == "reparam_stereo":
            libs["reparam_generic"] = lib.host_generic
            libs["reparam_generic"].restype = None
    return libs


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _inputs(comps, B, kset, seed, big_sigma=False):
    W, E, Z = ttk._dims(comps)
    nc = len(comps)
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn(B, W, generator=g)
    for i, c in enumerate(comps):
        off = sum(cc.head_width for cc in comps[:i])
        mu_cols = slice(off, off + c.dim)
        sig_cols = slice(off + c.dim, off + c.head_width)
        # keep most rows off the K < 0 ball's rim, where float32 resolves
        # nothing; every 7th row has a large |mu|
        raw[:, mu_cols] *= 0.5 / max(abs(kset[i]), 1.0) ** 0.5
        raw[::7, mu_cols] *= 4.0
        raw[:, sig_cols] -= 1.0
        if big_sigma:                  # the cap saturated where K > 0
            raw[::5, sig_cols] += (7.0 if kset[i] > 0
                                   else 2.0 if kset[i] >= -1.0 else 0.5)
    raw[1] = 0.0                                   # mu_tan = 0 ...
    for i, c in enumerate(comps):
        if c.manifold.kind == "s" and c.posterior == "wrapped":
            # rows 2 and 3: the mean at the antipode of mu0 (the transport's
            # denominator at its floor) and just short of it
            off = sum(cc.head_width for cc in comps[:i])
            raw[2:4, off:off + c.dim] = 0.0
            raw[2, off] = math.pi / kset[i] ** 0.5
            raw[3, off + c.dim - 1] = 0.999 * math.pi / kset[i] ** 0.5
    eps = ttk.draw_noise(comps, (B,), raw, g)
    eps[1] = 0.0                                   # ... and eps = 0
    eps[4] = 0.0                                   # eps = 0 alone
    k = torch.tensor(kset, dtype=torch.float32)
    dz = torch.randn(B, Z, generator=g)
    daux = torch.randn(B, nc + 2, generator=g)
    return raw, eps, k, dz, daux


CASES = [
    ("d2,p2,e2", (-1.0, 1.0, 0.0), {}),
    ("d2,p2,e2", (-1e-3, 1e-3, 0.0), {}),
    ("d2,p2,e2", (-0.3, 2.5, 0.0), {"scalar_sigma": True}),
    ("d2,p2,e2", (-1.0, 1.0, 0.0), {"wraps": 0}),
    ("u6", (1.0,), {}), ("u6", (-1.0,), {}), ("u6", (0.0,), {}),
    ("u6", (1e-3,), {}), ("u6", (-1e-3,), {}),
    ("u6", (0.7,), {"wraps": 0}),
    ("p6", (1.0,), {}), ("p6", (4.0,), {"scalar_sigma": True}),
    ("d6", (-1.0,), {}), ("d6", (-4.0,), {}),
    ("h2,s2,e2", (-1.0, 1.0, 0.0), {}),
    ("u2,h2,p3", (0.5, -0.7, 1.3), {}),
    ("s6:wrapped", (1.0,), {}), ("s6:wrapped", (1e-3,), {}),
    ("s6:wrapped", (4.0,), {"scalar_sigma": True}),
    ("s6:wrapped", (0.7,), {"wraps": 0}),
    ("s4:wrapped,s2", (2.5, 1.0), {}),
    ("s3:wrapped,h2,e2", (1.0, -1.0, 0.0), {}),
    ("s32:wrapped", (0.25,), {}),
    # the instantiation for n = 3, the generic one for n = 7 and 12, and
    # nc = 16 (two components a warp)
    ("p3,h3,s3:wrapped", (1.0, -1.0, 1.0), {}),
    ("h7,e12", (-0.7, 0.0), {}),
    ("h2,s2,e2,d2,p2,u2,h2,e2,d2,p2,u2,h2,s2,e2,s2:wrapped,e2",
     (-1.0, 1.0, 0.0, -0.5, 0.8, 0.3, -2.0, 0.0, -1e-3, 1e-3, -0.4, -0.3,
      2.0, 0.0, 1.5, 0.0), {}),
    # the split geometry: u with K on both sides of 0 in one batch, a
    # table mixing split components with the flagship's kinds, wraps 2
    # (the owner's serial sums)
    ("u6,u6", (0.5, -0.5), {}),
    ("d2,p2,e2,h2,s2,e2", (-1.0, 1.0, 0.0, -1.0, 1.0, 0.0), {}),
    ("u6", (0.7,), {"wraps": 2}), ("s6:wrapped", (0.7,), {"wraps": 2}),
]


def _held(ours, ref, ref64, tol, min_resolved):
    """``ours`` within ``tol`` of the float32 plain version ``ref`` wherever
    float32 resolves the value (``ref`` within a tenth of ``tol`` of its
    float64 evaluation ``ref64``). At the K < 0 ball's rim and within an ulp
    of the K > 0 injectivity shell the value is set by float32 rounding
    (here also by the stand-in rsqrtf and libm); there ``ours`` must be
    finite and no farther from float64 than ten times the plain version."""
    assert bool(torch.isfinite(ours).all())
    plain_err = (ref.double() - ref64).abs()
    res = plain_err <= 0.1 * tol
    assert float(res.double().mean()) >= min_resolved, float(
        res.double().mean())
    ratio = ((ours - ref).abs() / tol)[res]
    assert float(ratio.max()) <= 1.0, float(ratio.max())
    far = (ours.double() - ref64).abs() / (plain_err + tol)
    assert float(far.max()) <= 10.0, float(far.max())


def _host_bwd(host_libs, comps, raw, eps, k, dz, daux, name="tail_bwd"):
    """The compiled backward source on the host (``name``: ``tail_bwd`` or
    ``tail_bwd_previous``): (draw, dk_rows, dk). The folded dk equals
    ``fold_rows_ref(dk_rows)`` (the kernel's order) bit for bit and the
    fold's counters are back at zero."""
    B = raw.shape[0]
    W, E, Z = ttk._dims(comps)
    nc = len(comps)
    draw = torch.full((B, W), float("nan"))
    dk_rows = torch.full((B, nc), float("nan"))
    dk = torch.full((nc,), float("nan"))
    part = torch.full((-(-B // 32), nc), float("nan"))
    counter = torch.zeros(nc, dtype=torch.int32)
    host_libs[name](_ptr(raw), _ptr(eps), _ptr(k), _ptr(dz), _ptr(daux),
                    _ptr(draw), _ptr(dk_rows), _ptr(dk), _ptr(part),
                    _ptr(counter), B, W, E, Z, nc, ttk._table(comps))
    assert not counter.any()
    assert torch.equal(dk, ttk.fold_rows_ref(dk_rows))
    return draw, dk_rows, dk


def _comps(spec, opts):
    return tuple(parse_components(spec, fixed_curvature=False, **opts))


def _host_fwd(host_libs, name, comps, raw, eps, k):
    """A compiled forward source on the host (``name``: ``tail_fwd`` or its
    previous design ``tail_fwd_previous``): (z, aux)."""
    B = raw.shape[0]
    W, E, Z = ttk._dims(comps)
    nc = len(comps)
    z = torch.full((B, Z), float("nan"))
    aux = torch.full((B, nc + 2), float("nan"))
    host_libs[name](_ptr(raw), _ptr(eps), _ptr(k), _ptr(z), _ptr(aux), B, W,
                    E, Z, nc, ttk._table(comps))
    return z, aux


def _assert_previous_design(host_libs, comps, raw, eps, k, dz, daux):
    """The compiled sources against the previous design's
    (``scripts/tail_previous``, the same compiler and libm): the forward's z
    and aux and the backward's draw, dk_rows and folded dk bit for bit (the
    split geometry evaluates every expression of the previous tiles and
    sums every sum in the same order), each fold equal to ``fold_rows_ref``
    with its counters back at 0. Returns the backward."""
    z, aux = _host_fwd(host_libs, "tail_fwd", comps, raw, eps, k)
    z0, aux0 = _host_fwd(host_libs, "tail_fwd_previous", comps, raw, eps, k)
    assert bool(torch.isfinite(z).all() and torch.isfinite(aux).all())
    assert torch.equal(z, z0) and torch.equal(aux, aux0)
    new = _host_bwd(host_libs, comps, raw, eps, k, dz, daux)
    old = _host_bwd(host_libs, comps, raw, eps, k, dz, daux,
                    "tail_bwd_previous")
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    return new


@pytest.mark.parametrize("big_sigma", [False, True])
@pytest.mark.parametrize("spec,kset,opts", CASES)
def test_forward_source_matches_plain_version(host_libs, spec, kset, opts,
                                              big_sigma):
    comps = _comps(spec, opts)
    B = 64
    W, E, Z = ttk._dims(comps)
    nc = len(comps)
    raw, eps, k, _, _ = _inputs(comps, B, kset, 0, big_sigma)
    z = torch.full((B, Z), float("nan"))
    aux = torch.full((B, nc + 2), float("nan"))
    host_libs["tail_fwd"](_ptr(raw), _ptr(eps), _ptr(k), _ptr(z), _ptr(aux),
                          B, W, E, Z, nc, ttk._table(comps))
    z_r, aux_r = ttk.tail_forward_ref(comps, raw, eps, k)
    z64, aux64 = ttk.tail_forward_ref(comps, raw.double(), eps.double(),
                                      k.double())
    _held(z, z_r, z64, 1e-5 * (1 + z_r.abs()), 0.9)
    _held(aux, aux_r, aux64, 1e-4 * (1 + 1e-2 * aux_r.abs()), 0.7)


@pytest.mark.parametrize("big_sigma", [False, True])
@pytest.mark.parametrize("spec,kset,opts", CASES)
def test_backward_source_matches_plain_version(host_libs, spec, kset, opts,
                                               big_sigma):
    comps = _comps(spec, opts)
    B = 64
    W, E, Z = ttk._dims(comps)
    nc = len(comps)
    raw, eps, k, dz, daux = _inputs(comps, B, kset, 1, big_sigma)
    draw, dk, _ = _host_bwd(host_libs, comps, raw, eps, k, dz, daux)
    draw_r, dk_r, _ = ttk.tail_backward_ref(comps, raw, eps, k, dz, daux)
    d64, k64, _ = ttk.tail_backward_ref(
        comps, *[t.double() for t in (raw, eps, k, dz, daux)])
    assert bool(torch.isfinite(dk).all())
    tol = 1e-3 * draw_r.abs() + 5e-4
    _held(draw, draw_r, d64, tol, 0.7)
    # the curvature gradient, summed over the rows whose raw gradient the
    # float32 plain backward resolves
    res = ((draw_r.double() - d64).abs() <= 0.1 * tol).all(1)
    dks, dks_r = dk[res].sum(0), dk_r[res].sum(0)
    assert bool(((dks - dks_r).abs() <= 2e-3 * dks_r.abs() + 5e-4).all()), (
        dks, dks_r)


@pytest.mark.parametrize("big_sigma", [False, True])
@pytest.mark.parametrize("spec,kset,opts", CASES)
def test_tail_source_bit_equal_to_previous_design(host_libs, spec, kset,
                                                  opts, big_sigma):
    """Every case, forward and backward, against the previous design's
    sources bit for bit (the split geometry for the products with a d/p/u
    or s component, the warp-a-component one for the others)."""
    comps = _comps(spec, opts)
    _assert_previous_design(host_libs, comps,
                            *_inputs(comps, 64, kset, 2, big_sigma))


@pytest.mark.parametrize("B", [1, 31, 33, 257])
@pytest.mark.parametrize("spec,kset", [
    ("u6", (0.5,)), ("s6:wrapped", (1.0,)), ("d2,p2,e2", (-1.0, 1.0, 0.0)),
    ("d2,p2,e2,h2,s2,e2", (-1.0, 1.0, 0.0, -1.0, 1.0, 0.0))])
def test_tail_source_ragged_batches(host_libs, spec, kset, B):
    """Ragged batches (a split block of 16 rows part-filled; at 257 the
    warp-a-component blocks of the mixed table past their one block, and
    the split fold over 9 groups): bit for bit against the previous design,
    and within the plain version's contract."""
    comps = _comps(spec, {})
    raw, eps, k, dz, daux = _inputs(comps, max(B, 5), kset, 3)
    raw, eps, dz, daux = (t[:B].contiguous() for t in (raw, eps, dz, daux))
    draw, _, _ = _assert_previous_design(host_libs, comps, raw, eps, k, dz,
                                         daux)
    z, aux = _host_fwd(host_libs, "tail_fwd", comps, raw, eps, k)
    z_r, aux_r = ttk.tail_forward_ref(comps, raw, eps, k)
    z64, aux64 = ttk.tail_forward_ref(comps, raw.double(), eps.double(),
                                      k.double())
    _held(z, z_r, z64, 1e-5 * (1 + z_r.abs()), 0.5)
    _held(aux, aux_r, aux64, 1e-4 * (1 + 1e-2 * aux_r.abs()), 0.5)
    draw_r, _, _ = ttk.tail_backward_ref(comps, raw, eps, k, dz, daux)
    d64, _, _ = ttk.tail_backward_ref(
        comps, *[t.double() for t in (raw, eps, k, dz, daux)])
    _held(draw, draw_r, d64, 1e-3 * draw_r.abs() + 5e-4, 0.5)


@pytest.mark.parametrize("spec,kset", [
    ("u6", (0.5,)), ("d2,p2,e2,h2,s2,e2", (-1.0, 1.0, 0.0, -1.0, 1.0, 0.0))])
def test_tail_source_fold_past_a_chunk(host_libs, spec, kset):
    """4100 rows: the split fold stages dk_rows a chunk of 4096 rows at a
    time, the running sum crossing the chunk; the backward bit for bit
    against the previous design, whose fold takes the rows in one pass."""
    comps = _comps(spec, {})
    _assert_previous_design(host_libs, comps, *_inputs(comps, 4100, kset, 4))


@pytest.mark.parametrize("sign,kval", [(-1, -1.0), (-1, -1e-3), (0, -0.5),
                                       (0, 0.0), (0, 1e-3), (0, 0.9),
                                       (1, 1.0), (1, 0.3)])
@pytest.mark.parametrize("wraps", [0, 1])
@pytest.mark.parametrize("n", [2, 6])
def test_reparam_source_matches_plain_version(host_libs, sign, kval, wraps,
                                              n):
    S, B, Z, z_off, E = 5, 37, n + 3, 2, n + 4
    g = torch.Generator().manual_seed(n + wraps)
    noise = torch.randn(S, B, E, generator=g)
    eps = noise[..., 1:1 + n]                      # a strided view
    k = torch.tensor(kval)
    mu = 0.4 * torch.randn(B, n, generator=g)
    sigma = 0.1 + 1.5 * torch.rand(B, n, generator=g)
    if kval < 0:                     # inside the ball, away from its rim
        mu = 0.5 * mu / max(-kval, 1.0) ** 0.5
        sigma = 0.6 * sigma
    zt = torch.zeros(S, Z, B)
    lq = torch.empty(S, B)
    lp = torch.empty(S, B)
    host_libs["reparam_stereo"](
        _ptr(eps), ctypes.c_longlong(E), _ptr(mu), _ptr(sigma),
        _ptr(k.reshape(1)), _ptr(zt), z_off, _ptr(lq), _ptr(lp), S, B, n, Z,
        sign, wraps, 2)
    z_r, lq_r, lp_r = tmk.wrapped_reparam_stereo_ref(eps, mu, sigma, k,
                                                     wraps=wraps, sign=sign)
    _, lq64, lp64 = tmk.wrapped_reparam_stereo_ref(
        eps.double(), mu.double(), sigma.double(), k.double(), wraps=wraps,
        sign=sign)
    z = zt[:, z_off:z_off + n]
    assert bool((zt[:, :z_off] == 0).all() and (zt[:, z_off + n:] == 0).all())
    assert bool(((z - z_r).abs() <= 1e-5 * (1 + z_r.abs())).all())
    _held(lq, lq_r, lq64, 1e-4 * (1 + 1e-2 * lq_r.abs()), 0.9)
    _held(lp, lp_r, lp64, 1e-4 * (1 + 1e-2 * lp_r.abs()), 0.9)


def _reparam_inputs(n, kval, seed, S=5, B=37, E=None):
    """Noise as a strided view of a wider (S, B, E) block, means and scales
    (inside the K < 0 ball, every 9th example at its rim)."""
    E = n + 4 if E is None else E
    g = torch.Generator().manual_seed(seed)
    eps = torch.randn(S, B, E, generator=g)[..., 1:1 + n]
    mu = 0.4 * torch.randn(B, n, generator=g)
    sigma = 0.1 + 1.5 * torch.rand(B, n, generator=g)
    if kval < 0:
        mu = 0.5 * mu / max(-kval, 1.0) ** 0.5
        mu[::9] *= 0.9999 / (-kval) ** 0.5 / mu[::9].norm(dim=1, keepdim=True)
    return eps, mu, sigma, torch.tensor([kval])


@pytest.mark.parametrize("sign,kval", [(-1, -1.0), (0, -0.5), (0, 0.0),
                                       (0, 0.9), (1, 1.0), (1, 0.3)])
@pytest.mark.parametrize("wraps", [0, 1])
@pytest.mark.parametrize("n,spt", [(2, 1), (2, 2), (3, 2), (6, 1), (6, 2),
                                   (7, 2)])
def test_reparam_hoisted_draw_is_bit_equal_to_generic_draw(host_libs, sign,
                                                           kval, wraps, n,
                                                           spt):
    """The kernel (its per-example scalars once a thread, its samples drawn
    by stereo_draw_at on the instantiation for n: 2, 3, 6, else the generic
    one) against the generic draw a point at a time (stereo_draw<0>, which
    recomputes the scalars for every sample): z, log q and log p bit for
    bit, a sample a thread and two (over an S that leaves the last thread a
    sample short)."""
    S, B, Z, z_off = 5, 37, n + 3, 2
    eps, mu, sigma, k = _reparam_inputs(n, kval, 40 + n + wraps)
    outs = []
    for name in ("reparam_stereo", "reparam_generic"):
        zt = torch.full((S, Z, B), 7.0)
        lq = torch.full((S, B), float("nan"))
        lp = torch.full((S, B), float("nan"))
        host_libs[name](_ptr(eps), ctypes.c_longlong(eps.stride(1)),
                        _ptr(mu), _ptr(sigma), _ptr(k), _ptr(zt), z_off,
                        _ptr(lq), _ptr(lp), S, B, n, Z, sign, wraps, spt)
        outs.append((zt, lq, lp))
    (zt, lq, lp), (zt0, lq0, lp0) = outs
    assert bool(torch.isfinite(lq).all() and torch.isfinite(lp).all())
    assert torch.equal(zt, zt0) and torch.equal(lq, lq0)
    assert torch.equal(lp, lp0)
    assert bool((zt[:, :z_off] == 7.0).all() and (zt[:, z_off + n:] == 7.0)
                .all())


def _sphere_floor_rows(comps, kval, seed):
    """Inputs for one wrapped component on the embedded sphere whose first
    rows sit where the tile's K-dependent floors act: row 0 the mean 1e-3 rad
    from the antipode of mu0 (the transport's denominator 1 + alpha = 5e-7
    under its floor eps, where the floored coefficient is ~1e3 |v|), row 1
    the mean at the antipode with eps = 0 (z at the antipode: the half chord
    at its cap),
    row 2 mu_tan = 0 with a saturated scale and a unit draw (|v| at the
    cap radius, z next to the antipode), row 3 a saturated cap with a free
    draw, row 4 mu_tan = 0 with eps = 0 (the norm pin at 0 / 0)."""
    (c,) = comps
    n = c.dim
    raw, eps, k, dz, daux = _inputs(comps, 16, (kval,), seed)
    raw[:5, :n] = 0.0
    raw[0, 0] = (math.pi - 1e-3) / kval ** 0.5
    raw[1, 0] = math.pi / kval ** 0.5
    eps[1] = 0.0
    raw[2:4, n:] = 10.0 * math.pi / kval ** 0.5
    eps[2] = 0.0
    eps[2, 1] = 1.0
    eps[4] = 0.0
    return raw, eps, k, dz, daux


FLOOR_CASES = [("s3:wrapped", {}), ("s6:wrapped", {"scalar_sigma": True}),
               ("s2:wrapped", {"wraps": 0})]


def _check_floor_rows(spec, opts, kval, device, forward, backward):
    """Where a floor of the embedded-sphere tile is taken, the float64 plain
    version floors elsewhere (eps(float64) = 1e-12), so ``_held`` compares
    nothing there. These rows hold ``forward`` / ``backward`` (the compiled
    source, or the kernels on the card) to the float32 plain version
    directly: the forward within the card's contract, the raw gradient
    within rtol 1e-2 of the row's largest entry, the row's own curvature
    gradient within rtol 1e-2. Where z sits at the antipode (rows 1-2) the
    prior's log-det has a slope of ~1 / (2 delta) = 500 and the curvature
    gradient is what is left of two cancelling terms ~1e5 times larger,
    through the chord's cap and through K itself: float32 quantizes it to
    ~1/32, so it is held to rtol 0.1 there (dropping either term misses by
    1e5). First checks that the floors are taken."""
    from mvae_torch.ops import sphere
    comps = _comps(spec, opts)
    n = comps[0].dim
    raw, eps, k, dz, daux = [t.to(device) for t in
                             _sphere_floor_rows(comps, kval, 7)]
    z, aux = forward(comps, raw, eps, k)
    z_r, aux_r = ttk.tail_forward_ref(comps, raw, eps, k)
    # the floors act: 1 + alpha < eps at rows 0-1, the half chord beyond its
    # cap at rows 1-2
    mu0 = sphere.mu0(n, k[0], torch.float32)
    mu = sphere.exp_map_mu0(raw[:, :n], k[0])
    den_in = 2.0 - k[0] * ((mu - mu0) ** 2).sum(1) / 2.0
    assert bool((den_in[:2] < 1e-6).all() and (den_in[2:] > 1e-3).all())
    half = ((z_r - mu0) ** 2).sum(1).sqrt() / 2.0
    assert bool((half[1:3] > (1.0 - 1e-6) / kval ** 0.5).all())
    assert bool((half[3:] < (1.0 - 1e-6) / kval ** 0.5).all())
    assert bool(((z - z_r).abs() <= 1e-5 * (1 + z_r.abs())).all())
    assert bool(((aux - aux_r).abs() <= 1e-4 * (1 + 1e-2 * aux_r.abs()))
                .all())

    draw, dk, _ = backward(comps, raw, eps, k, dz, daux)
    draw_r, dk_r, _ = ttk.tail_backward_ref(comps, raw, eps, k, dz, daux)
    assert bool(torch.isfinite(draw).all() and torch.isfinite(dk).all())
    assert bool(torch.isfinite(draw_r).all() and torch.isfinite(dk_r).all())
    scale = draw_r.abs().amax(1, keepdim=True)
    assert bool(((draw - draw_r).abs() <= 1e-2 * scale + 5e-4).all())
    rtol = torch.full_like(dk_r, 1e-2)
    rtol[1:3] = 0.1
    assert bool(((dk - dk_r).abs() <= rtol * dk_r.abs() + 5e-4).all())


@pytest.mark.parametrize("kval", [1.0, 2.5, 0.2])
@pytest.mark.parametrize("spec,opts", FLOOR_CASES)
def test_sphere_tile_floor_rows(host_libs, spec, opts, kval):
    """The compiled source on the rows where the sphere tile's floors act."""

    def forward(comps, raw, eps, k):
        B = raw.shape[0]
        W, E, Z = ttk._dims(comps)
        z = torch.full((B, Z), float("nan"))
        aux = torch.full((B, 3), float("nan"))
        host_libs["tail_fwd"](_ptr(raw), _ptr(eps), _ptr(k), _ptr(z),
                              _ptr(aux), B, W, E, Z, 1, ttk._table(comps))
        return z, aux

    def backward(comps, raw, eps, k, dz, daux):
        return _host_bwd(host_libs, comps, raw, eps, k, dz, daux)

    _check_floor_rows(spec, opts, kval, "cpu", forward, backward)


@pytest.mark.cuda
@pytest.mark.parametrize("kval", [1.0, 2.5, 0.2])
@pytest.mark.parametrize("spec,opts", FLOOR_CASES)
def test_sphere_tile_floor_rows_on_card(spec, opts, kval):
    """The CUDA kernels on the same rows (the card has no JAX: run with
    ``--noconftest -m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tail kernels have no CPU mode")
    _check_floor_rows(spec, opts, kval, "cuda", ttk.tail_forward,
                      ttk.tail_backward)


@pytest.mark.parametrize("kval", [-1.0, -1e-3, 0.0, 1e-3, 1.0, 2.5])
def test_stereo_distance_tail_matches_plain_version(host_libs, kval):
    """The scalar tail of the stereographic distance kernel, fed the Gram
    values PyTorch sums, against ``stereo_distance_ref``: 1e-5 relative
    (libm's atan and log1p against PyTorch's). Rows include x = y (w2 = 0
    under the 1e-30 floor), the K > 0 antipodal pair (the guarded Mobius
    denominator) and, for K < 0, a point next to the ball's rim (the atanh
    clamp sets the value)."""
    g = torch.Generator().manual_seed(3)
    x = 0.4 * torch.randn(64, 6, generator=g)
    y = 0.4 * torch.randn(64, 6, generator=g)
    if kval < 0:
        x, y = x / max(-kval, 1.0) ** 0.5, y / max(-kval, 1.0) ** 0.5
        x[2] = 0.0
        x[2, 0] = (1.0 - 1e-6) / (-kval) ** 0.5
    y[0] = x[0]
    if kval > 0:
        y[1] = -x[1] / (kval * (x[1] * x[1]).sum())    # the antipode of x[1]
    k = torch.tensor(kval)
    grams = [(x * x).sum(1), (y * y).sum(1), (x * y).sum(1)]
    out = torch.full((64,), float("nan"))
    host_libs["manifold_dist"](0, _ptr(k.reshape(1)), *[_ptr(t) for t in grams],
                               _ptr(out), 64)
    ref = tmk.stereo_distance_ref(x, y, k)
    assert bool(torch.isfinite(out).all())
    assert bool(((out - ref).abs() <= 1e-5 * (1 + ref.abs())).all())


@pytest.mark.parametrize("kval", [-1.0, -1e-3, -4.0])
def test_lorentz_distance_tail_matches_plain_version(host_libs, kval):
    """The scalar tail of the hyperboloid distance kernel against
    ``lorentz_distance_ref`` (1e-5 relative), with x = y in row 0."""
    from mvae_torch.ops import lorentz
    g = torch.Generator().manual_seed(4)
    k = torch.tensor(kval)
    x = lorentz.exp_map_mu0(0.6 * torch.randn(64, 5, generator=g), k)
    y = lorentz.exp_map_mu0(0.6 * torch.randn(64, 5, generator=g), k)
    y[0] = x[0]
    d = y - x
    dsq = (d * d).sum(1) - 2.0 * d[:, 0] * d[:, 0]
    out = torch.full((64,), float("nan"))
    host_libs["manifold_dist"](1, _ptr(k.reshape(1)), _ptr(dsq), None, None,
                               _ptr(out), 64)
    ref = tmk.lorentz_distance_ref(x, y, k)
    assert bool(torch.isfinite(out).all())
    assert bool(((out - ref).abs() <= 1e-5 * (1 + ref.abs())).all())


def test_tf32_split_source_matches_emulation(host_libs):
    """``csrc/tf32.cuh``'s split (the code the card runs), compiled for the
    host, against ``tf32_split_ref`` bit for bit: random magnitudes, floats
    whose 13 dropped bits are exactly half (both signs), signed zeros."""
    g = torch.Generator().manual_seed(5)
    a = (torch.randn(4096, generator=g, dtype=torch.float64)
         * 10.0 ** torch.randint(-20, 20, (4096,), generator=g)).float()
    ties = ((torch.arange(1, 65, dtype=torch.int32) << 13)
            | 0x3F801000).view(torch.float32)
    a = torch.cat([a, ties, -ties, torch.tensor([0.0, -0.0, 1.0, 1.9999999,
                                                 -3.0e38])])
    hi = torch.empty(a.shape, dtype=torch.int32)
    lo = torch.empty(a.shape, dtype=torch.int32)
    host_libs["tf32"](_ptr(a), _ptr(hi), _ptr(lo), len(a))
    hi_ref, lo_ref = tdk.tf32_split_ref(a)
    assert torch.equal(hi, hi_ref.view(torch.int32))
    assert torch.equal(lo, lo_ref.view(torch.int32))


@pytest.mark.parametrize("Z,H,D", [(8, 400, 784), (6, 40, 100),
                                   (12, 33, 98), (3, 1, 1)])
def test_decode_image_source_matches_python(host_libs, Z, H, D):
    """The IWAE decode's image launch (``w_image_kernel`` of
    ``csrc/decode_bce.cu``, the code the card runs), compiled for the host
    and run block after block, thread after thread, against
    ``decode_image_ref`` bit for bit: W2's split words at their permuted
    core-matrix places, b1, W1's split chunks, zeros past Z, H and D."""
    g = torch.Generator().manual_seed(Z * H + D)
    w1 = torch.randn((Z, H), generator=g)
    b1 = torch.randn((H,), generator=g)
    w2 = 0.1 * torch.randn((H, D), generator=g)
    want = tdk.decode_image_ref(w1, b1, w2)
    img = torch.full((tdk.decode_image_bytes(Z, H, D) // 4,), -1,
                     dtype=torch.int32)
    host_libs["decode_bce"](_ptr(w1), _ptr(b1), _ptr(w2), _ptr(img), Z, H, D)
    assert torch.equal(img.reshape(want.shape), want)


@pytest.mark.parametrize("B,Z,H,D", [
    (128, 8, 400, 784), (1, 8, 400, 784), (127, 8, 400, 784),
    (1000, 8, 400, 784), (1024, 16, 600, 784), (5, 2, 33, 98),
    (128, 8, 976, 784), (128, 8, 977, 784), (128, 8, 3296, 784),
    (128, 8, 3297, 784), (40, 8, 400, 784), (0, 8, 400, 784)])
def test_train_decode_plan_source_matches_python(host_libs, B, Z, H, D):
    """``csrc/train_decode_plan.cuh`` (the plan the launcher and the kernel
    use), compiled for the host, against ``train_tile_plan``: the same
    grid, stages, resident slots, h stride, fetch, shared memory and
    partials, and the same refusal. Its h shares (``td_share``: what each
    pixel tile of the first row tile stores of the tile's contiguous block
    of h) cover the block once, each in whole float4 words."""
    want = tdk.train_tile_plan(B, Z, H, D)
    shape = torch.tensor([B, Z, H, D], dtype=torch.int32)
    plan = torch.zeros(9, dtype=torch.int64)
    share = torch.zeros(2 * -(-D // 32), dtype=torch.int32)
    host_libs["train_decode_plan"](_ptr(shape), _ptr(plan), _ptr(share))
    assert bool(plan[0]) is (want is not None)
    if want is None:
        return
    keys = ("row_tiles", "pixel_tiles", "stages", "slots", "hp", "fetch",
            "smem", "part")
    fetch = {"tma": 0, "copy": 1, "ring": 2}
    assert plan[1:].tolist() == [fetch[want[k]] if k == "fetch" else want[k]
                                 for k in keys]
    covered = []
    for lo, hi in share.view(-1, 2).tolist():
        assert lo % 4 == 0 or lo == hi
        covered += range(lo, hi)
    assert covered == list(range(min(B, 16) * H))
