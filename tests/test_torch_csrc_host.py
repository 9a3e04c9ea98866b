"""The CUDA sources of the tail and reparam kernels, compiled for the host.

The device code of ``mvae_torch/kernels/csrc`` is plain C++ apart from its
qualifiers and its launch syntax, so a machine without ``nvcc`` can still
check its arithmetic: each source is cut before its ``extern "C"`` launcher,
compiled by ``g++`` against a small stand-in for ``cuda_runtime.h`` (empty
qualifiers, ``blockIdx`` / ``threadIdx`` as globals, ``rsqrtf``), and its
kernel function is called once per thread index from a host loop. The
forward tiles, the hand-derived backward and the IWAE chunk reparam are held
against their plain PyTorch versions on the same inputs.

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
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from mvae_torch.components import parse_components
from mvae_torch.kernels import manifold_kernels as tmk
from mvae_torch.kernels import tail_kernels as ttk

CSRC = Path(ttk.__file__).resolve().parent / "csrc"

_STUB = r"""
#pragma once
#include <math.h>
#include <stddef.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(x)
struct HostIdx { int x; };
static HostIdx blockIdx, threadIdx;
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
"""

_HARNESS = {
    "tail_fwd": r"""
extern "C" void host_run(const float* raw, const float* eps, const float* k,
                         float* z, float* aux, int B, int W, int E, int Z,
                         int nc, const int* table) {
  TailTable t;
  if (!tail_table_from(table, nc, &t)) return;
  for (int row = 0; row < B; ++row) {
    blockIdx.x = row / THREADS;
    threadIdx.x = row % THREADS;
    tail_fwd_kernel(raw, eps, k, z, aux, B, W, E, Z, t);
  }
}
""",
    "tail_bwd": r"""
extern "C" void host_run(const float* raw, const float* eps, const float* k,
                         const float* dz, const float* daux, float* draw,
                         float* dk, int B, int W, int E, int Z, int nc,
                         const int* table) {
  TailTable t;
  if (!tail_table_from(table, nc, &t)) return;
  for (int row = 0; row < B; ++row) {
    blockIdx.x = row / THREADS;
    threadIdx.x = row % THREADS;
    tail_bwd_kernel(raw, eps, k, dz, daux, draw, dk, B, W, E, Z, t);
  }
}
""",
    "reparam_stereo": r"""
extern "C" void host_run(const float* eps, long long stride, const float* mu,
                         const float* sigma, const float* k, float* zt,
                         int z_off, float* lq, float* lp, int S, int B, int n,
                         int Z, int sign, int wraps) {
  for (long long i = 0; i < (long long)S * B; ++i) {
    blockIdx.x = (int)(i / THREADS);
    threadIdx.x = (int)(i % THREADS);
    reparam_stereo_kernel(eps, stride, mu, sigma, k, zt, z_off, lq, lp, S, B,
                          n, Z, sign, wraps);
  }
}
""",
}


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """name -> the kernel function's host harness, built once per module."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    work = tmp_path_factory.mktemp("csrc_host")
    (work / "cuda_runtime.h").write_text(_STUB)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    libs = {}
    for name, harness in _HARNESS.items():
        body = (CSRC / f"{name}.cu").read_text().split('extern "C"')[0]
        src = work / f"{name}.cpp"
        src.write_text(body + harness)
        out = work / f"{name}.so"
        subprocess.run([gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                        "-I", str(work), "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True)
        libs[name] = ctypes.CDLL(str(out)).host_run
        libs[name].restype = None
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
    eps = ttk.draw_noise(comps, (B,), raw, g)
    eps[1] = 0.0                                   # ... and eps = 0
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


def _comps(spec, opts):
    return tuple(parse_components(spec, fixed_curvature=False, **opts))


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
    draw = torch.full((B, W), float("nan"))
    dk = torch.full((B, nc), float("nan"))
    host_libs["tail_bwd"](_ptr(raw), _ptr(eps), _ptr(k), _ptr(dz), _ptr(daux),
                          _ptr(draw), _ptr(dk), B, W, E, Z, nc,
                          ttk._table(comps))
    draw_r, dk_r = ttk.tail_backward_ref(comps, raw, eps, k, dz, daux)
    d64, k64 = ttk.tail_backward_ref(
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
        sign, wraps)
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
