"""Roofline harness for the port's kernels on an NVIDIA Hopper card: what
each kernel takes against a floor measured on the same card, not quoted.

Counterpart of ``mvae_tpu/kernels/roofline.py``. Two pieces, as there:

1. **Calibration** (``calibrate``), measured on the card: the HBM stream
   rate of a triad ``o = x + y`` (``probe_triad``, timed in turns with
   ``torch.add(x, y, out=o)``), the FP32 FMA rate
   (``probe_fma``: 8 independent chains of 8 FMAs a word, run ``repeat``
   times), the accurate-tanh rate (``probe_tanh``), the cost of one row
   reduction (``probe_reduce``: a warp per row, shuffles) and of one (2048,
   8) relayout through shared memory (``probe_transpose``), and the bf16
   and TF32 tensor-core rates of four chained 4096^3 ``torch.matmul`` (a
   plain large product, which the JAX package left to XLA as well; TF32 is
   float32 operands with ``allow_tf32`` on for the call). A rate above 105%
   of the H100 SXM data sheet's peak (``PEAK``; ``SANITY``) means the
   measurement broke: it is measured once more and then raises
   ``CalibrationError``. There is no nominal fallback.

2. **Binding floors** for the kernels the reference measured (``main``): for
   each, an I/O skeleton with the kernel's exact launch shape and reads
   (``skel_dist``, ``skel_reparam``: the bytes floor) and a synthetic twin
   that does a lower bound of its operations (``twin_stereo``,
   ``twin_reparam``: the compute floor). ``twin_stereo(resident=True)``
   reads one 2048-row tile and holds it on chip, in registers, while it
   computes every output row that reads it, a row's Gram sums and tail
   each its own (``twin_row_instructions`` counts them in SASS), so its
   time is the arithmetic's; ``twin_reparam`` is instantiated on the
   dimension and samples a thread as B5 is, so that it stays a floor B5
   cannot beat. B5's compute floor is the
   operations its plain version needs on the row's inputs, each point on
   the branch it takes and a repeated expression once (``reparam_ops``,
   ``op_split_taken``), priced at the calibrated rates: an arithmetic op
   one FMA issue slot, each transcendental at the tanh rate (``ops_us``);
   its twin stays in the row as a second reading. A
   kernel's binding floor is the larger of the two whole-launch times:
   blocks run in parallel on 132 SMs, so the TPU's per-block cost times the
   number of blocks does not apply. Where the reference has no twin, the
   floor is priced from the calibrated rates and says so: B2's is the
   largest of its 3xTF32 tensor products at the calibrated TF32 rate, its
   FP32 part (the h product and the epilogue at the FMA rate, two
   transcendentals a logit at the tanh rate) and its bytes at the stream
   rate; B6's (``train_decode_floors``) the larger of its two products at
   the FMA rate and its bytes, and the same three floors as B2's for the
   kernel as built.

The probes are one CUDA source, ``csrc/roofline_probes.cu`` (replaces the
TPU kernels ``_elementwise_call`` with ``_fma_kernel``, ``_tanh_kernel``,
``_reduce_kernel``, ``_transpose_kernel``; ``_calibrate_once.triad``;
``_skel_dist``; ``_skel_reparam``; ``_twin_stereo``; ``_twin_reparam``).
Each wrapper launches its kernel for CUDA tensors, runs its plain PyTorch
version (``*_ref``, beside it) for CPU tensors and raises otherwise, and
counts its launches. Bound and design of each are in the source's note.

``measure`` gives a kernel's (or a library composition's) device time per
call from CUDA events around the replay of a CUDA graph of its calls, with
the median of the ``torch.profiler`` (CUPTI) trace's records of the named
kernel in another replay beside it as the cross-check (on the card the
trace's durations drift from session to session; see ``measure``).
Shapes whose bytes fit in the 50 MB L2 are timed over rotating buffer
sets, so that every launch reads from device memory as the real caller's
would.

Run on the card:  python -m mvae_torch.kernels.roofline [out.json]
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ..ops import lorentz, stable, stereographic
from ..utils.profiling import check_outputs
from ..components import parse_components
from . import _build, decoder_kernels, launches, manifold_kernels, tail_kernels

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK = {"hbm_gbps": 3350.0, "fp32_tflops": 67.0, "bf16_tflops": 989.0,
        "tf32_tflops": 495.0}
# A rate outside its window proves the measurement broke. A tanh costs at
# least one FP32 instruction (67 TFLOP/s counts an FMA as two); the reduce
# and transpose probes move bytes no faster than the stream.
SANITY = {
    "stream_gbps": (100.0, 1.05 * PEAK["hbm_gbps"]),
    "fma_tflops": (1.0, 1.05 * PEAK["fp32_tflops"]),
    "tanh_gops": (1.0, 1.05 * PEAK["fp32_tflops"] * 1e3 / 2),
    "reduce_gbps": (10.0, 1.05 * PEAK["hbm_gbps"]),
    "transpose_gbps": (10.0, 1.05 * PEAK["hbm_gbps"]),
    "bf16_tflops": (10.0, 1.05 * PEAK["bf16_tflops"]),
    "tf32_tflops": (10.0, 1.05 * PEAK["tf32_tflops"]),
}

B, N = 1 << 20, 128           # the distance and calibration shape
RESIDENT_ROWS = 2048          # csrc RESIDENT_ROWS: the resident twin's tile
RS, RN, RB = 125, 6, 2048     # production IWAE chunk reparam, sign -1
DS, DB, DZ, DH, DD = 16, 2048, 8, 400, 784   # the IWAE decode row
GEMM_M = 4096
# FMA and tanh chain blocks per word in calibration: 64 FMAs a word at
# repeat = 1 is 16 FLOP a byte, under the card's FP32 balance point (20);
# 32 puts the probe 25x past it
CAL_REPEAT = 32
ITERS = 20
# Calls a graph in B5's row (B5, its skeleton and twin), as in the tail rows:
# on the H100 a replay's fixed cost spread over ITERS calls adds ~0.5 us to
# each of these few-us kernels (chip_smoke phase 20 prints the row at both)
REPARAM_ROW_CALLS = 100

# the B7b compute price: n subtractions and n FMAs a row, one row
# reduction, and a tail of ~12 FLOP and 3 transcendentals (log1p, two
# sqrt), each a low count
LORENTZ_TAIL_FLOPS = 12
LORENTZ_TAIL_TRANSCENDENTALS = 3
# the BCE epilogue of B2 per logit: bias, x * l, softplus (max, abs, exp,
# log1p, add), the difference and the sum, two of them transcendental; per
# hidden unit: bias and ReLU
BCE_OPS_PER_LOGIT = 9
BCE_TRANSCENDENTALS_PER_LOGIT = 2
HIDDEN_OPS_PER_UNIT = 2
# B6's epilogue also forms gl = x - sigmoid(l): one more exp, an add, a
# division and a subtraction a logit
TRAIN_OPS_PER_LOGIT = BCE_OPS_PER_LOGIT + 4
TRAIN_TRANSCENDENTALS_PER_LOGIT = BCE_TRANSCENDENTALS_PER_LOGIT + 1


class CalibrationError(RuntimeError):
    pass


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} measures a CUDA card and none is "
                           f"available; no CPU time stands in for it")


# ----------------------------------------------------------------- wrappers


_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "probe_triad_launch": [_VP, _VP, _VP, _LL],
    "probe_fma_launch": [_VP, _VP, _LL, _INT],
    "probe_tanh_launch": [_VP, _VP, _LL, _INT],
    "probe_reduce_launch": [_VP, _VP, _LL, _INT],
    "probe_transpose_launch": [_VP, _VP, _LL, _INT],
    "skel_dist_launch": [_VP, _VP, _VP, _LL, _INT, _INT],
    "twin_stereo_launch": [_VP, _VP, _VP, _LL, _INT, _INT],
    "skel_reparam_launch": [_VP, _LL] + [_VP] * 5 + [_INT] + [_VP] * 2
                           + [_INT] * 5,
    "twin_reparam_launch": [_VP, _LL] + [_VP] * 5 + [_INT] + [_VP] * 2
                           + [_INT] * 5,
    "skel_tail_launch": [_VP] * 10 + [_INT] * 7 + [_VP],
}


def bind_probe(lib, name: str):
    """The launch entry ``name`` of a built probe library (the package's,
    or a previous design measured beside it: the same signatures), typed
    for ctypes."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name] + [_VP]
    return fn


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return bind_probe(_build.load("roofline_probes"), name)


def _launch(name: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(_entry(name)(*args, stream), name)


def _launched(wrapper, *outs) -> None:
    """Count a launch; with the NaN guard on, check the kernel's outputs
    (ctypes bypasses the dispatcher the guard watches)."""
    wrapper.launches += 1
    check_outputs(wrapper.__name__, *outs)


def _on_card(what: str, *tensors) -> bool:
    """False for CPU tensors (the plain version runs), True for float32
    CUDA tensors on one card (the kernel runs); raises otherwise, and on a
    machine without a card."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: operands on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: a CUDA tensor on a machine without a "
                           f"CUDA card")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what}: operands must be float32")
    return True


def _rows(what: str, x, min_cols: int = 1):
    if x.dim() != 2 or x.shape[1] < min_cols:
        raise ValueError(f"{what}: x must be (rows, >= {min_cols} cols), got "
                         f"{tuple(x.shape)}")
    return x.shape


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _fma(a, c, b):
    """a * c + b rounded once, as the kernels' ``fmaf`` (and XLA, which
    contracts the reference probes' a * c + b on the CPU). The product of
    two float32 values is exact in float64; the sum is rounded to float64,
    then to float32, which differs from one rounding only at a float32 tie.
    Python-number operands are float32 constants."""
    c = _f32(c) if isinstance(c, float) else c.double()
    b = _f32(b) if isinstance(b, float) else b.double()
    return (a.double() * c + b).to(a.dtype)


def _chain_sum(accs):
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def _tree8(a):
    return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]))


def probe_triad_ref(x, y):
    """Plain version of the triad: o = x + y."""
    return x + y


def probe_triad(x, y, out=None):
    """HBM stream probe o = x + y (B8b): several 16-byte words of each input
    in flight a thread, streaming cache hints; into ``out`` (contiguous, of
    x's shape) when given, as ``torch.add(x, y, out=o)`` writes o."""
    if x.shape != y.shape:
        raise ValueError("x and y must have one shape")
    if out is not None and (out.shape != x.shape or not out.is_contiguous()):
        raise ValueError("out must be contiguous and of x's shape")
    if not _on_card("probe_triad", x, y, *(() if out is None else (out,))):
        o = probe_triad_ref(x, y)
        return o if out is None else out.copy_(o)
    x, y = x.contiguous(), y.contiguous()
    o = torch.empty_like(x) if out is None else out
    _launch("probe_triad_launch", x.device, x.data_ptr(), y.data_ptr(),
            o.data_ptr(), x.numel())
    _launched(probe_triad, o)
    return o


def probe_fma_ref(x, repeat: int = 1):
    """Plain version of the FMA probe: 8 chains a = fma(a, 1.0000001, x)
    from a = x + j, 8 * repeat steps each, summed in order (the TPU probe
    at repeat = 1)."""
    accs = [x + float(j) for j in range(8)]
    for _ in range(8 * repeat):
        accs = [_fma(a, 1.0000001, x) for a in accs]
    return _chain_sum(accs)


def probe_fma(x, repeat: int = 1):
    """FP32 FMA-rate probe (B8a), one ``fmaf`` per chain step."""
    if repeat < 1:
        raise ValueError("repeat must be >= 1")
    if not _on_card("probe_fma", x):
        return probe_fma_ref(x, repeat)
    x = x.contiguous()
    o = torch.empty_like(x)
    _launch("probe_fma_launch", x.device, x.data_ptr(), o.data_ptr(),
            x.numel(), repeat)
    _launched(probe_fma, o)
    return o


def probe_tanh_ref(x, repeat: int = 1):
    """Plain version of the tanh probe: 4 chains of 4 * repeat tanh from
    x + j, summed in order."""
    accs = [x + float(j) for j in range(4)]
    for _ in range(4 * repeat):
        accs = [torch.tanh(a) for a in accs]
    return _chain_sum(accs)


def probe_tanh(x, repeat: int = 1):
    """Transcendental-rate probe (B8a): the accurate ``tanhf``."""
    if repeat < 1:
        raise ValueError("repeat must be >= 1")
    if not _on_card("probe_tanh", x):
        return probe_tanh_ref(x, repeat)
    x = x.contiguous()
    o = torch.empty_like(x)
    _launch("probe_tanh_launch", x.device, x.data_ptr(), o.data_ptr(),
            x.numel(), repeat)
    _launched(probe_tanh, o)
    return o


def probe_reduce_ref(x):
    """Plain version of the reduce probe: 8 row sums of x + i, tree-added,
    broadcast over the row."""
    s = [torch.sum(x + float(i), dim=1, keepdim=True) for i in range(8)]
    return _tree8(s).expand(x.shape).contiguous()


def probe_reduce(x):
    """Row-reduction probe (B8a): one warp per row, xor-shuffle sums."""
    rows, cols = _rows("probe_reduce", x, 4)
    if not _on_card("probe_reduce", x):
        return probe_reduce_ref(x)
    if cols % 4:
        raise ValueError("probe_reduce takes cols % 4 == 0")
    x = x.contiguous()
    o = torch.empty_like(x)
    _launch("probe_reduce_launch", x.device, x.data_ptr(), o.data_ptr(),
            rows, cols)
    _launched(probe_reduce, o)
    return o


def probe_transpose_ref(x):
    """Plain version of the relayout probe: every element of row r is
    sum_c sum_i (x[r, c] + i) over the first 8 columns."""
    p = x[:, 0:8]
    acc = _tree8([p + float(i) for i in range(8)])
    return acc.sum(dim=1, keepdim=True).expand(x.shape).contiguous()


def probe_transpose(x):
    """Relayout probe (B8a): eight (256, 8) tiles through shared memory."""
    rows, cols = _rows("probe_transpose", x, 8)
    if not _on_card("probe_transpose", x):
        return probe_transpose_ref(x)
    if cols % 4:
        raise ValueError("probe_transpose takes cols % 4 == 0")
    x = x.contiguous()
    o = torch.empty_like(x)
    _launch("probe_transpose_launch", x.device, x.data_ptr(), o.data_ptr(),
            rows, cols)
    _launched(probe_transpose, o)
    return o


_SKEL_VARIANTS = {"rowstore": 0, "block": 1}


def skel_dist_ref(x, y, variant: str = "rowstore"):
    """Plain version of the distance skeleton: each row's words summed; the
    "block" variant adds x[r, 0] and y[r, 0] once more."""
    s = x.sum(dim=1) + y.sum(dim=1)
    if variant == "block":
        s = (s + x[:, 0]) + y[:, 0]
    return s


def skel_dist(x, y, variant: str = "rowstore"):
    """Bytes floor of the distance kernels (B8c): "rowstore" prices
    ``stereo_dist_kernel``, "block" ``lorentz_dist_kernel``: the same
    launch, reads and one store a row, each word folded with one add."""
    if variant not in _SKEL_VARIANTS:
        raise ValueError(f"variant must be one of {sorted(_SKEL_VARIANTS)}")
    rows, n = _rows("skel_dist", x)
    if x.shape != y.shape:
        raise ValueError("x and y must have one shape")
    if not _on_card("skel_dist", x, y):
        return skel_dist_ref(x, y, variant)
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    _launch("skel_dist_launch", x.device, x.data_ptr(), y.data_ptr(),
            out.data_ptr(), rows, n, _SKEL_VARIANTS[variant])
    _launched(skel_dist, out)
    return out


# _STWIN_PREFIX_OPS, _STWIN_CHAIN_OPS, _STWIN_MERGE_OPS of the reference
STWIN_PREFIX_OPS, STWIN_CHAIN_OPS, STWIN_MERGE_OPS = 9, 18, 4


def _twin_stereo_rows(x, y):
    r1 = torch.sum(x * x, dim=1)
    r2 = torch.sum(y * y, dim=1)
    r3 = torch.sum(x * y, dim=1)
    t = _fma(r2, 1.0000001, r1) + r3
    for _ in range(STWIN_PREFIX_OPS):
        t = _fma(t, 1.0000001, 0.1)
    ta, tb, tc = t, t + 1.0, t + 2.0
    for j in range(STWIN_CHAIN_OPS):
        if j == 5:
            ta = torch.sqrt(torch.abs(ta) + 1e-6)
            tb = torch.sqrt(torch.abs(tb) + 1e-6)
            tc = torch.sqrt(torch.abs(tc) + 1e-6)
        elif j == 12:
            ta = 1.0 / (torch.abs(ta) + 1.0)
            tb = torch.exp(-torch.abs(tb) * 1e-3)
            tc = 1.0 / (torch.abs(tc) + 1.0)
        else:
            ta = _fma(ta, 1.0000001, 0.1)
            tb = _fma(tb, 1.0000002, 0.1)
            tc = _fma(tc, 1.0000003, 0.1)
    t = _fma(tb, tc, ta)
    for _ in range(STWIN_MERGE_OPS):
        t = _fma(t, 1.0000001, 0.1)
    return t


def twin_stereo_ref(x, y, resident: bool = False):
    """Plain version of the stereographic twin: per row the three Gram sums
    and the reference's lower-bound tail; ``resident`` reads row
    r mod 2048 for output row r."""
    if not resident:
        return _twin_stereo_rows(x, y)
    rows = x.shape[0]
    tile = min(rows, RESIDENT_ROWS)
    t = _twin_stereo_rows(x[:tile], y[:tile])
    return t[torch.arange(rows, device=x.device) % tile]


def twin_stereo(x, y, resident: bool = False):
    """Compute floor of ``stereo_dist_kernel`` (B8e). Streaming, at its
    launch shape (a warp a row, every row read from device memory);
    ``resident=True`` (rows of up to 128 columns) holds the 2048-row tile
    in registers, four lanes a row, and runs every output row's Gram sums
    and tail on it, so the time is the arithmetic alone."""
    rows, n = _rows("twin_stereo", x)
    if x.shape != y.shape:
        raise ValueError("x and y must have one shape")
    if not _on_card("twin_stereo", x, y):
        return twin_stereo_ref(x, y, resident)
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    _launch("twin_stereo_launch", x.device, x.data_ptr(), y.data_ptr(),
            out.data_ptr(), rows, n, int(resident))
    _launched(twin_stereo, out)
    return out


# the tail's transcendental steps (roofline_probes.cu twin_sqrt_step,
# twin_rcp_step, twin_exp_step) and how many of each a row takes
STWIN_TRANSCENDENTALS = {"sqrt": 3, "rcp": 2, "exp": 1}


def twin_stereo_row_ops(n: int, prices: dict | None = None) -> float:
    """FMA issue slots of one output row of the stereographic twin: 3 n
    Gram FMAs and the reference's 9 + 3 x 18 + 4 tail ops, each of its
    six transcendental steps priced at ``prices[kind]`` (its SASS
    instructions, ``transcendental_instructions``) or, without ``prices``,
    as one op (the reference's count)."""
    tail = STWIN_PREFIX_OPS + 3 * STWIN_CHAIN_OPS + STWIN_MERGE_OPS
    if prices:
        tail += sum(c * (prices[k] - 1)
                    for k, c in STWIN_TRANSCENDENTALS.items())
    return 3 * n + tail


# _TWIN_FULL_OPS, _TWIN_PREFIX_OPS, _TWIN_CHAIN_OPS, _TWIN_TRANSC_EVERY
TWIN_FULL_OPS, TWIN_PREFIX_OPS, TWIN_CHAIN_OPS, TWIN_TRANSC_EVERY = \
    9, 40, 40, 12


def reparam_scalars(mu, sigma):
    """The reparam probes' hoisted per-example inputs, one (3, B) array:
    sum log sigma, min sigma, |mu|^2 (the reference's ``ls``, ``smin``,
    ``x2``), computed once per example as the reference does, outside the
    probe."""
    return torch.stack([torch.log(sigma).sum(dim=1), sigma.min(dim=1).values,
                        (mu * mu).sum(dim=1)])


def skel_reparam_ref(eps, mu, sigma, k, scalars=None):
    """Plain version of the reparam skeleton: eps (S, B, n) copied to zt
    (S, n, B); log q = log p = mu_0 + sigma_0 + ... + mu_{n-1} +
    sigma_{n-1} + sum log sigma + min sigma + |mu|^2 + k per example (the
    TPU skeleton adds mu_0 + sigma_0 alone: nvcc drops an unused load)."""
    S, Bb, n = eps.shape
    ls, smin, x2 = reparam_scalars(mu, sigma) if scalars is None else scalars
    acc = torch.zeros_like(mu[:, 0])
    for j in range(n):
        acc = (acc + mu[:, j]) + sigma[:, j]
    c = (((acc + ls) + smin) + x2) + k.reshape(())
    lq = c.expand(S, Bb).contiguous()
    return eps.transpose(1, 2).contiguous(), lq, lq.clone()


def twin_reparam_ref(eps, mu, sigma, k, scalars=None):
    """Plain version of the reparam twin: 9 full-width passes
    z = fma(z, c, eps), then per (sample, example) a 40-op prefix and two
    40-op chains of fused multiply-adds with an exp every 12th op."""
    z = eps
    for _ in range(TWIN_FULL_OPS):
        z = _fma(z, 1.0000001, eps)
    ls, smin, x2 = reparam_scalars(mu, sigma) if scalars is None else scalars
    r = ((ls + smin) + x2) + k.reshape(())
    t = (z[..., 0] + mu[:, 0]) + sigma[:, 0]
    last = TWIN_TRANSC_EVERY - 1
    for i in range(TWIN_PREFIX_OPS):
        t = (torch.exp(-torch.abs(t) * 1e-3) if i % TWIN_TRANSC_EVERY == last
             else _fma(t, 1.0000001, r))
    tq, tp = t, t + 1.0
    for i in range(TWIN_CHAIN_OPS):
        if i % TWIN_TRANSC_EVERY == last:
            tq = torch.exp(-torch.abs(tq) * 1e-3)
            tp = torch.exp(-torch.abs(tp) * 1e-3)
        else:
            tq = _fma(tq, 1.0000001, r)
            tp = _fma(tp, 1.0000002, r)
    return z.transpose(1, 2).contiguous(), tq, tp


def _reparam_probe(wrapper, entry, ref, eps, mu, sigma, k, scalars, out,
                   z_off, sign):
    """The reparam probes' interface, as ``wrapped_reparam_stereo_t``'s:
    eps (S, B, n) (a view with unit stride along n is read in place), mu
    and sigma (B, n), k one value; ``scalars`` the (3, B) hoisted inputs
    (``reparam_scalars(mu, sigma)`` when None: pass them to keep their
    computation out of a timed call); with ``out`` (S, Z, B) z goes to its
    rows z_off .. z_off + n. On the card the probe takes the samples a
    thread B5 takes at the shape and the row's curvature ``sign``
    (``reparam_spt``). Returns (zt, lq, lp)."""
    if eps.dim() != 3:
        raise ValueError(f"eps must be (S, B, n), got {tuple(eps.shape)}")
    S, Bb, n = eps.shape
    k = torch.as_tensor(k)
    if tuple(mu.shape) != (Bb, n) or tuple(sigma.shape) != (Bb, n):
        raise ValueError(f"mu and sigma must be ({Bb}, {n})")
    if k.numel() != 1 or not 1 <= n <= 32:
        raise ValueError("k must be one value and 1 <= n <= 32")
    if scalars is None:
        scalars = reparam_scalars(mu, sigma)
    if tuple(scalars.shape) != (3, Bb):
        raise ValueError(f"scalars must be (3, {Bb})")
    on_card = _on_card(wrapper.__name__, eps, mu, sigma, scalars, k)
    if out is None:
        out = torch.empty((S, n, Bb), dtype=eps.dtype, device=eps.device)
        z_off = 0
    Z = out.shape[1] if out.dim() == 3 else -1
    if (tuple(out.shape) != (S, Z, Bb) or not 0 <= z_off <= Z - n
            or not out.is_contiguous() or out.device != eps.device):
        raise ValueError(f"out must be a contiguous ({S}, Z, {Bb}) buffer "
                         f"with Z >= z_off + {n}, on eps's device")
    zt = out[:, z_off:z_off + n]
    if not on_card:
        z, lq, lp = ref(eps, mu, sigma, k, scalars)
        zt.copy_(z)
        return zt, lq, lp
    if eps.stride(2) != 1 or eps.stride(0) != Bb * eps.stride(1):
        eps = eps.contiguous()
    mu, sigma = mu.contiguous(), sigma.contiguous()
    scalars = scalars.contiguous()
    k1 = k.reshape(1)
    lq = torch.empty((S, Bb), dtype=torch.float32, device=eps.device)
    lp = torch.empty((S, Bb), dtype=torch.float32, device=eps.device)
    _launch(entry, eps.device, eps.data_ptr(), eps.stride(1), mu.data_ptr(),
            sigma.data_ptr(), scalars.data_ptr(), k1.data_ptr(),
            out.data_ptr(), z_off, lq.data_ptr(), lp.data_ptr(), S, Bb, n, Z,
            manifold_kernels.reparam_spt(S, Bb, n, sign))
    _launched(wrapper, zt, lq, lp)
    return zt, lq, lp


def skel_reparam(eps, mu, sigma, k, scalars=None, out=None, z_off: int = 0,
                 sign: int = -1):
    """Bytes floor of ``reparam_stereo_kernel`` (B8d), at its launch shape
    for the curvature ``sign`` and its layout: z = eps, log q = log p = a
    per-example sum that reads every word of mu and sigma the kernel reads,
    and the hoisted scalars."""
    return _reparam_probe(skel_reparam, "skel_reparam_launch",
                          skel_reparam_ref, eps, mu, sigma, k, scalars, out,
                          z_off, sign)


def twin_reparam(eps, mu, sigma, k, scalars=None, out=None, z_off: int = 0,
                 sign: int = -1):
    """Compute floor of ``reparam_stereo_kernel`` (B8f): the reference's
    counted op volume in generic multiply-adds, at its launch shape for the
    curvature ``sign`` and on its instantiations (n = 2, 3, 6 and generic,
    the samples a thread B5 takes), on the reference's hoisted per-example
    scalars."""
    return _reparam_probe(twin_reparam, "twin_reparam_launch",
                          twin_reparam_ref, eps, mu, sigma, k, scalars, out,
                          z_off, sign)


SKEL_CHUNK = 8   # roofline_probes.cu's


def _chunk_sums(x):
    """(rows, w) -> (rows, ceil(w / 8)): each 8-word chunk of a row (zeros
    past w) summed by halves, as ``skel_tree`` in roofline_probes.cu."""
    w = x.shape[1]
    pad = -w % SKEL_CHUNK
    v = torch.nn.functional.pad(x, (0, pad)).reshape(x.shape[0], -1,
                                                     SKEL_CHUNK)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def skel_tail_ref(comps, raw, eps, k, dz=None, daux=None):
    """Plain version of the tail's I/O skeleton. Per row and component i,
    s = k_i, then the component's head and noise slices (and, for the
    backward's, its dz slice), each as its 8-word chunk sums
    (``_chunk_sums``) added in order, then (backward) daux[:, i],
    daux[:, nc] and daux[:, nc + 1]. Forward (``dz`` None):
    (z, aux), every z word of the component s, aux[:, i] = s, aux[:, nc] =
    aux[:, nc + 1] = the row's s summed over the components in order.
    Backward: (draw, dk_rows, dk), every draw word of the component s,
    dk_rows[:, i] = s, dk their fold (``tail_kernels.fold_rows_ref``)."""
    comps = tuple(comps)
    nc = len(comps)
    bwd = dz is not None
    cols, outs = [], []
    ro = eo = zo = 0
    for i, c in enumerate(comps):
        s = k[i]
        slices = [raw[:, ro:ro + c.head_width], eps[:, eo:eo + c.noise_width]]
        if bwd:
            slices.append(dz[:, zo:zo + c.ambient_dim])
        for x in slices:
            for col in _chunk_sums(x).unbind(1):
                s = s + col
        if bwd:
            for j in (i, nc, nc + 1):
                s = s + daux[:, j]
        width = c.head_width if bwd else c.ambient_dim
        outs.append(s.unsqueeze(1).expand(-1, width))
        cols.append(s)
        ro, eo, zo = ro + c.head_width, eo + c.noise_width, zo + c.ambient_dim
    if bwd:
        dk_rows = torch.stack(cols, 1)
        return (torch.cat(outs, 1), dk_rows,
                tail_kernels.fold_rows_ref(dk_rows))
    total = torch.zeros_like(cols[0])
    for col in cols:
        total = total + col
    return torch.cat(outs, 1), torch.stack(cols + [total, total], 1)


def skel_tail(comps, raw, eps, k, dz=None, daux=None, warp=False):
    """Bytes floor of the tail kernels at their own grid (``tail_forward``'s
    without ``dz``, ``tail_backward``'s with ``dz`` and ``daux``; with
    ``warp`` the warp-a-component grid every product took before the split
    geometry): reads every input word and writes every output word of the
    tail, the backward's fold included, and about one add a word read. Same
    arguments and result shapes as the kernel it prices; values as
    ``skel_tail_ref`` on either grid."""
    comps = tuple(comps)
    W, E, Z = tail_kernels._dims(comps)
    nc, B = len(comps), raw.shape[0]
    bwd = dz is not None
    want = {"raw": (raw, (B, W)), "eps": (eps, (B, E)), "k": (k, (nc,))}
    if bwd:
        want.update(dz=(dz, (B, Z)), daux=(daux, (B, nc + 2)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"skel_tail: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if not 1 <= nc <= tail_kernels.MAX_COMPS:
        raise ValueError("skel_tail: 1 to 16 components")
    ins = [t for t, _ in want.values()]
    if not _on_card("skel_tail", *ins):
        return skel_tail_ref(comps, raw, eps, k, dz, daux)
    dev = raw.device
    ins = [t.contiguous() for t in ins]
    if not bwd:
        ins += [ins[0], ins[0]]          # dz, daux: not read
    out = torch.empty((B, W if bwd else Z), dtype=torch.float32, device=dev)
    out_c = torch.empty((B, nc if bwd else nc + 2), dtype=torch.float32,
                        device=dev)
    dk = torch.empty(nc, dtype=torch.float32, device=dev)
    part = torch.empty((-(-B // 32), nc), dtype=torch.float32, device=dev)
    counter = tail_kernels._fold_counter(dev)
    _launch("skel_tail_launch", dev, *[t.data_ptr() for t in ins],
            out.data_ptr(), out_c.data_ptr(), dk.data_ptr(), part.data_ptr(),
            counter.data_ptr(), B, W, E, Z, nc, int(bwd), int(warp),
            tail_kernels._table(comps))
    outs = (out, out_c, dk) if bwd else (out, out_c)
    _launched(skel_tail, *outs)
    return outs


PROBES = (probe_triad, probe_fma, probe_tanh, probe_reduce, probe_transpose,
          skel_dist, skel_reparam, twin_stereo, twin_reparam, skel_tail)
for _p in PROBES:
    _p.launches = 0
# every counted wrapper ``measure`` may capture into a CUDA graph
COUNTED = PROBES + launches.COUNTED + (manifold_kernels.stereo_distance,
                                       manifold_kernels.lorentz_distance)


# ---------------------------------------------------------------- arithmetic


def dist_bytes(rows: int, n: int) -> int:
    """Bytes a distance kernel must move: x and y read, k, one float out."""
    return 4 * (2 * rows * n + 1 + rows)


def reparam_bytes(S: int, Bb: int, n: int) -> int:
    """Bytes of the chunk reparam: eps in, z out, log q and log p out, mu
    and sigma once, k."""
    return 4 * (2 * S * Bb * n + 2 * S * Bb + 2 * Bb * n + 1)


def reparam_chunk_bytes(S: int, Bb: int, E: int, Z: int, W: int,
                        P: int) -> int:
    """Bytes of the flagship kinds' chunk reparam (P2) over P components: E
    noise floats a point in, Z coordinates and two log-densities a point
    out, the W head pre-activations once an example, P curvatures."""
    return 4 * (S * Bb * (E + Z + 2) + Bb * W + P)


def decode_bytes(S: int, Bb: int, Z: int, H: int, D: int) -> int:
    """Bytes of the IWAE decode: z, x, the weights and biases in, (S, B)
    out."""
    return 4 * (S * Z * Bb + D * Bb + Z * H + H + H * D + D + S * Bb)


def decode_flops(S: int, Bb: int, Z: int, H: int, D: int) -> dict:
    """Operations of B2. ``gemm``: the two products 2 S B (Z H + H D) as
    float32 work, with ``elementwise`` (bias + ReLU, the BCE) and their
    ``total``: the FP32 SIMT count. The kernel runs the second product on
    the tensor cores as three TF32 products (a_lo b_hi + a_hi b_lo + a_hi
    b_hi): ``tensor_3xtf32`` = 3 x 2 S B H D. What stays on the FP32 pipe
    (``fp32_part``) is the first product 2 S B Z H and the elementwise work
    less the ``transcendentals`` (exp and log1p, two a logit)."""
    gemm = 2 * S * Bb * (Z * H + H * D)
    elem = S * Bb * (HIDDEN_OPS_PER_UNIT * H + BCE_OPS_PER_LOGIT * D)
    trans = S * Bb * D * BCE_TRANSCENDENTALS_PER_LOGIT
    return {"gemm": gemm, "elementwise": elem, "total": gemm + elem,
            "tensor_3xtf32": 3 * 2 * S * Bb * H * D,
            "fp32_part": 2 * S * Bb * Z * H + elem - trans,
            "transcendentals": trans}


def train_decode_bytes(Bb: int, Z: int, H: int, D: int) -> int:
    """Bytes of the training decode (B6): z, x, the weights and biases in,
    ll, h and gl out, each once."""
    return 4 * (Bb * Z + Bb * D + Z * H + H + H * D + D + Bb + Bb * H
                + Bb * D)


def train_decode_flops(Bb: int, Z: int, H: int, D: int) -> dict:
    """Operations of B6, in ``decode_flops``' terms: ``gemm`` the two
    products 2 B (Z H + H D) as float32 work, ``total`` with the
    elementwise work; the kernel runs h W2 as three TF32 products
    (``tensor_3xtf32`` = 3 x 2 B H D) and keeps z W1 and the epilogue on the
    FP32 pipe (``fp32_part``, less the ``transcendentals``: three a logit)."""
    gemm = 2 * Bb * (Z * H + H * D)
    elem = Bb * (HIDDEN_OPS_PER_UNIT * H + TRAIN_OPS_PER_LOGIT * D)
    trans = Bb * D * TRAIN_TRANSCENDENTALS_PER_LOGIT
    return {"gemm": gemm, "elementwise": elem, "total": gemm + elem,
            "tensor_3xtf32": 3 * 2 * Bb * H * D,
            "fp32_part": 2 * Bb * Z * H + elem - trans,
            "transcendentals": trans}


def train_decode_floors(Bb: int, Z: int, H: int, D: int, cal: dict) -> dict:
    """B6's floors (us per launch) from the calibrated rates. ``fp32``: its
    two products 2 B (Z H + H D) at ``fma_tflops``, the floor of the same
    function on the FP32 pipe; ``bytes_stream``: its bytes at
    ``stream_gbps``; and, as B2's (``decode_floors``), the kernel as built:
    ``tensor_3xtf32`` at ``tf32_tflops`` and ``fp32_part`` at
    ``fma_tflops`` with the transcendentals at ``tanh_gops``. The binding
    floor of the FP32 function is the larger of ``fp32`` and
    ``bytes_stream``; of the kernel as built, the largest of the other
    three."""
    fl = train_decode_flops(Bb, Z, H, D)
    return {"fp32": fl["gemm"] / (cal["fma_tflops"] * 1e6),
            "bytes_stream": train_decode_bytes(Bb, Z, H, D)
                            / (cal["stream_gbps"] * 1e3),
            "tensor_3xtf32": fl["tensor_3xtf32"] / (cal["tf32_tflops"] * 1e6),
            "fp32_part": (fl["fp32_part"] / (cal["fma_tflops"] * 1e6)
                          + fl["transcendentals"] / (cal["tanh_gops"] * 1e3))}


# aten ops that move, make or view data and do no arithmetic
_NO_ARITH = frozenset((
    "view", "_unsafe_view", "reshape", "expand", "slice", "select", "cat",
    "stack", "clone", "detach", "alias", "copy_", "empty", "empty_like",
    "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "fill_", "new_zeros", "new_empty", "new_full", "new_ones",
    "_to_copy", "to", "contiguous", "as_strided", "split", "unbind",
    "unsqueeze", "squeeze", "t", "transpose", "permute", "lift_fresh",
    "scalar_tensor", "_local_scalar_dense", "narrow", "slice_backward",
    "select_backward", "expand_copy", "copy", "split_with_sizes",
    "detach_", "zero_", "resize_"))
_REDUCTIONS = frozenset(("sum", "mean", "amax", "amin", "max", "min",
                         "logsumexp", "prod"))


# aten ops an accurate float32 library function evaluates, each many
# instructions (priced at the calibrated tanh rate); square roots, divisions
# and reciprocals stay arithmetic (a few instructions: a lower count)
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sin", "cos",
    "tan", "tanh", "sinh", "cosh", "asin", "acos", "atan", "atan2", "asinh",
    "acosh", "atanh", "pow", "erf", "erfc", "sigmoid"))


def op_split(fn, *args, names: bool = False, **kwargs) -> dict:
    """Operations ``fn(*args, **kwargs)`` runs, as PyTorch runs them, split
    into ``arithmetic`` and ``transcendental`` (an op of ``_TRANSCENDENTAL``,
    one per element of its output): one per element of each arithmetic op's
    output, one per input element of a reduction; ops that move, make or
    view data count none. Exact for the plain versions, which run each
    expression of a kernel as one op (both sides of a branch where the
    kernel takes one). With ``names``, also ``by_name``: the
    transcendentals by op name."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {"arithmetic": 0, "transcendental": 0}
    by_name: dict = {}

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name.split("::")[-1]
            if name in _REDUCTIONS:
                src = args[0]
                counts["arithmetic"] += (src.numel() if torch.is_tensor(src)
                                         else 0)
            elif name not in _NO_ARITH:
                res = out[0] if isinstance(out, (tuple, list)) else out
                if torch.is_tensor(res):
                    base = name.rstrip("_")
                    kind = ("transcendental" if base in _TRANSCENDENTAL
                            else "arithmetic")
                    counts[kind] += res.numel()
                    if kind == "transcendental":
                        by_name[base] = by_name.get(base, 0) + res.numel()
            return out

    with _Count():
        fn(*args, **kwargs)
    if names:
        counts["by_name"] = by_name
    return counts


def op_count(fn, *args, **kwargs) -> int:
    """``op_split``'s two counts summed: a transcendental one like an
    add."""
    return sum(op_split(fn, *args, **kwargs).values())


def tail_ops(comps, raw, eps, k, dz=None, daux=None) -> int:
    """Operations of the tail at these inputs: ``tail_op_split``'s two
    counts summed (the plain forward's or, with the cotangents, the plain
    backward's: autograd through the forward, which the kernel recomputes
    as well)."""
    split = tail_op_split(comps, raw, eps, k, dz, daux)
    return split["arithmetic"] + split["transcendental"]


def tail_op_split(comps, raw, eps, k, dz=None, daux=None) -> dict:
    """``op_split`` (with ``by_name``) of the plain forward or, with the
    cotangents, of the plain backward, counted on CPU copies."""
    cpu = [t.detach().cpu() for t in (raw, eps, k)]
    if dz is None:
        return op_split(tail_kernels.tail_forward_ref, comps, *cpu,
                        names=True)
    return op_split(tail_kernels.tail_backward_ref, comps, *cpu,
                    dz.detach().cpu(), daux.detach().cpu(), names=True)


def tail_priced_ops(split: dict, prices: dict) -> float:
    """FMA issue slots of a tail call (``tail_op_split``): an arithmetic op
    one, a transcendental its SASS instructions (``prices``,
    ``tail_transcendental_prices``: exp, log, sin, cos their own, every
    other one ``other``)."""
    return split["arithmetic"] + sum(
        n * prices.get(name, prices["other"])
        for name, n in split["by_name"].items())


def tail_floors(skel_us: float, slots: float, cal: dict,
                skel_warp_us: float | None = None) -> dict:
    """The tail kernels' floors (us per launch): ``skeleton``, the I/O
    skeleton's measured time at the kernel's grid (``skel_tail``) or, where
    the product takes the split geometry, the lower of that and the
    warp-a-component grid's (``skel_warp_us``: a floor must not rise
    because the kernel's geometry changed), and ``operations``, ``slots``
    FMA issue slots (``tail_priced_ops``) at the calibrated FMA rate."""
    skel = skel_us if skel_warp_us is None else min(skel_us, skel_warp_us)
    return {"skeleton": skel,
            "operations": 2.0 * slots / (cal["fma_tflops"] * 1e6)}


# ops a kernel does not issue: SASS applies them to an operand
_MODIFIERS = frozenset(("abs", "neg"))
# ops that make a tensor of a shape and need no input's values
_MAKERS = frozenset(("empty", "empty_like", "empty_strided", "zeros",
                     "zeros_like", "ones", "ones_like", "full", "full_like",
                     "new_zeros", "new_empty", "new_full", "new_ones",
                     "scalar_tensor"))
# ops whose output element i is input element i
_SAME = frozenset(("clone", "detach", "alias", "_to_copy", "to",
                   "contiguous", "lift_fresh", "copy"))


def _to_shape(mask, shape):
    """A needed-mask of a broadcast output, folded onto an input's shape:
    an input element is needed if any output element it feeds is."""
    if tuple(mask.shape) == tuple(shape):
        return mask
    return mask.to(torch.int32).sum_to_size(shape) > 0


def _view_needs(func, args, kwargs, src, mask):
    """The elements of ``src`` a view op's needed output elements read: the
    op run again on the indices of ``src``."""
    idx = torch.arange(src.numel(), device=src.device).reshape(src.shape)
    swapped = [idx if a is src else a for a in args]
    picked = func(*swapped, **kwargs)[mask]
    need = torch.zeros(src.numel(), dtype=torch.bool, device=src.device)
    need[picked.reshape(-1)] = True
    return need.reshape(src.shape)


def op_split_taken(fn, *args, **kwargs) -> dict:
    """Operations ``fn(*args, **kwargs)`` needs on these inputs, split as
    ``op_split`` splits them, counted as a kernel that evaluates each
    expression once and takes one side of every branch does them: an op
    that repeats an earlier one on the same inputs counts once (the wrap
    branches' shared sine); of a ``where`` only the side it selects, element
    by element, counts, and with it only the elements of the ops that feed
    the side taken; ``abs`` and ``neg`` count none (SASS applies them to an
    operand). It records the ops as they run, then walks them back from the
    outputs, marking the elements each one needs; an element counts once
    if it is needed. In-place ops are refused."""
    from torch.utils._python_dispatch import TorchDispatchMode

    nodes = []      # (op name, func, args, kwargs, output)
    node_of = {}    # id(tensor) -> node
    keep = []       # every tensor seen, so that no id is reused
    first = {}      # (func, inputs) -> node: common subexpressions

    def ref(t):
        if id(t) not in node_of:
            node_of[id(t)] = len(nodes)
            nodes.append(("input", None, (), {}, t))
            keep.append(t)
        return node_of[id(t)]

    def key(a):
        if torch.is_tensor(a):
            return ("tensor", ref(a))
        if isinstance(a, (list, tuple)):
            return tuple(key(x) for x in a)
        return (type(a).__name__, repr(a))

    class _Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func._schema.name.split("::")[-1]
            if func._schema.is_mutable:
                raise NotImplementedError(f"op_split_taken: in-place {name}")
            out = func(*args, **kwargs)
            if not torch.is_tensor(out):
                if isinstance(out, (tuple, list)) and any(
                        torch.is_tensor(o) for o in out):
                    raise NotImplementedError(
                        f"op_split_taken: {name} has several outputs")
                return out
            k = (str(func), key(args), key(sorted(kwargs.items())))
            if id(out) not in node_of:
                if k not in first:
                    first[k] = len(nodes)
                    nodes.append((name, func, args, kwargs, out))
                node_of[id(out)] = first[k]
                keep.append(out)
            return out

    with _Record():
        result = fn(*args, **kwargs)
    outs = result if isinstance(result, (tuple, list)) else (result,)
    need = [None] * len(nodes)

    def mark(t, mask):
        i = node_of[id(t)]
        need[i] = mask if need[i] is None else need[i] | mask

    for t in outs:
        if torch.is_tensor(t):
            mark(t, torch.ones(t.shape, dtype=torch.bool, device=t.device))
    counts = {"arithmetic": 0, "transcendental": 0}
    for i in range(len(nodes) - 1, -1, -1):
        name, func, a, kw, out = nodes[i]
        m = need[i]
        if name == "input" or m is None or not bool(m.any()):
            continue
        tensors = [x for x in a if torch.is_tensor(x)]
        if name in _MAKERS:
            continue
        if name == "where":
            cond, x, y = a
            c = torch.broadcast_to(cond, out.shape)
            mark(cond, _to_shape(m, cond.shape))
            for side, sel in ((x, m & c), (y, m & ~c)):
                if torch.is_tensor(side):
                    mark(side, _to_shape(sel, side.shape))
        elif name in _SAME:
            mark(a[0], _to_shape(m, a[0].shape))
            continue
        elif name in _NO_ARITH:
            if not torch.is_tensor(a[0]):
                raise NotImplementedError(f"op_split_taken: {name}")
            mark(a[0], _view_needs(func, a, kw, a[0], m))
            continue
        elif name in _REDUCTIONS:
            src = a[0]
            if out.numel() == 1:
                ms = torch.ones(src.shape, dtype=torch.bool,
                                device=src.device)
            else:
                dims = a[1] if len(a) > 1 else kw["dim"]
                dims = sorted(d % src.dim() for d in
                              (dims if isinstance(dims, (list, tuple))
                               else [dims]))
                mo = m
                if mo.dim() < src.dim():
                    for d in dims:
                        mo = mo.unsqueeze(d)
                ms = mo.expand(src.shape)
            mark(src, ms)
            counts["arithmetic"] += int(ms.sum())
            continue
        else:
            for t in tensors:
                mark(t, _to_shape(m, t.shape))
        if name in _MODIFIERS:
            continue
        kind = ("transcendental" if name.rstrip("_") in _TRANSCENDENTAL
                else "arithmetic")
        counts[kind] += int(m.sum())
    return counts


def reparam_ops(eps, mu, sigma, k, sign: int, wraps: int = 1) -> dict:
    """The chunk reparam's operations on these inputs: ``op_split_taken``
    of its plain version (``wrapped_reparam_stereo_ref``), so the branch
    each point takes and the wrap branches' shared sine count as the kernel
    does them. The plain version computes |mu|^2 and sum log sigma on
    (B, n), once per example, as the kernel does."""
    return op_split_taken(manifold_kernels.wrapped_reparam_stereo_ref, eps,
                          mu, sigma, k, wraps=wraps, sign=sign)


def ops_us(ops: dict, cal: dict) -> float:
    """An operation count's time at the calibrated rates: each arithmetic
    op one FMA issue slot (two FLOP at ``fma_tflops``), each
    transcendental at ``tanh_gops``."""
    return (2 * ops["arithmetic"] / (cal["fma_tflops"] * 1e6)
            + ops["transcendental"] / (cal["tanh_gops"] * 1e3))


_SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")


def _function_insns(sass: str, kernel: str) -> list[tuple]:
    """(address, predicated, opcode, operands) of every instruction of
    ``kernel`` in ``cuobjdump -sass`` text (an ``@PT`` guard is none)."""
    parts = re.split(r"\n\s*Function : ", sass)
    body = next((p for p in parts[1:] if kernel in p.split("\n", 1)[0]),
                None)
    if body is None:
        raise RuntimeError(f"no function {kernel} in the SASS")
    return [(int(a, 16), bool(pred) and "PT" not in pred, op, rest)
            for a, pred, op, rest in _SASS_INSN.findall(body)]


def _loop_ops(sass: str, kernel: str) -> list[tuple[int, int, list]]:
    """(start, end, opcodes) of every loop of ``kernel`` in ``cuobjdump
    -sass`` text: for every backward branch, the instructions from its
    target to it."""
    insns = _function_insns(sass, kernel)
    loops = []
    for addr, _, op, rest in insns:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and target and int(target[1], 16) <= addr:
            lo = int(target[1], 16)
            loops.append((lo, addr, [o for a, _, o, _ in insns
                                     if lo <= a <= addr]))
    return loops


def sass_loops(sass: str, kernel: str) -> list[dict]:
    """The loops of ``kernel`` in ``cuobjdump -sass`` text: for every
    backward branch, the instructions from its target to it (``count``)
    and, of those, the MUFU.EX2 and MUFU.TANH (``tanh``: an accurate
    ``tanhf`` issues one MUFU.EX2)."""
    return [{"start": lo, "end": hi, "count": len(ops),
             "tanh": sum(o in ("MUFU.EX2", "MUFU.TANH") for o in ops)}
            for lo, hi, ops in _loop_ops(sass, kernel)]


def tanh_instructions(sass: str | None = None) -> dict:
    """The instructions one accurate ``tanhf`` takes in the tanh probe as
    built: of ``probe_tanh_kernel``'s loops (``sass_loops``), the one with
    the most tanh, its instruction count (loop overhead included) over its
    tanh count (``per_tanh``). ``sass`` defaults to ``cuobjdump -sass`` of
    the built ``roofline_probes`` library."""
    if sass is None:
        sass = _probes_sass()
    loops = [lp for lp in sass_loops(sass, "probe_tanh_kernel")
             if lp["tanh"]]
    if not loops:
        raise RuntimeError("no loop of probe_tanh_kernel evaluates a tanh")
    best = max(loops, key=lambda lp: lp["tanh"])
    return {"instructions": best["count"], "tanh": best["tanh"],
            "per_tanh": best["count"] / best["tanh"]}


def _probes_sass() -> str:
    """``cuobjdump -sass`` of the built ``roofline_probes`` library."""
    _build.load("roofline_probes")
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run(
        [str(tool), "-sass", str(_build.library_path("roofline_probes"))],
        capture_output=True, text=True, timeout=300, check=True).stdout


def _executed_path(sass: str, kernel: str, lo: int, hi: int) -> list[str]:
    """The opcodes one trip of ``kernel``'s loop ``lo`` .. ``hi`` issues on
    its common path: from ``lo`` to the loop's backward branch at ``hi``, an
    unconditional branch followed, a conditional one taken only if the
    instructions it jumps over hold a CALL or a local-memory access (the
    precise functions' slow path, reached for special, denormal or, for
    sinf and cosf, huge inputs: their argument reduction's table lives in
    local memory) and otherwise not taken (a branch out of the loop, a
    divergence check), a predicated CALL counted but not followed."""
    insns = _function_insns(sass, kernel)
    at = {a: i for i, (a, *_) in enumerate(insns)}
    path, i = [], at[lo]
    while True:
        addr, pred, op, rest = insns[i]
        path.append(op)
        if addr == hi:
            return path
        if op.startswith("CALL") and not pred:
            raise RuntimeError(f"{kernel}'s loop at {lo:#x} calls a "
                               f"subroutine on its common path ({addr:#x})")
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and target:
            t = int(target[1], 16)
            if op == "BRA" and not pred:
                if not lo <= t <= hi:
                    raise RuntimeError(f"{kernel}'s loop at {lo:#x} leaves "
                                       f"it unconditionally ({addr:#x})")
                i = at[t]
                continue
            if addr < t <= hi and any(o.startswith(("CALL", "LDL", "STL"))
                                      for a, _, o, _ in insns
                                      if addr < a < t):
                i = at[t]
                continue
        i += 1


def _price_loops(sass: str, kind: str, steps=(16, 32)) -> float:
    """The SASS instructions one step of ``price_<kind>_kernel`` issues on
    its common path: of its loops the two outermost (the largest spans: a
    step may hold a loop of its own on a slow path), one of ``steps[0]``
    steps a trip and one of ``steps[1]``, the difference of their executed
    instructions (``_executed_path``) over the difference of their MUFU
    counts, or, where a step issues no MUFU (the accurate sinf, cosf and
    logf are polynomials), over the difference of their steps; the loops'
    own counter and branch cancel."""
    kernel = f"price_{kind}_kernel"
    outer = sorted(_loop_ops(sass, kernel), key=lambda lp: lp[0] - lp[1])[:2]
    loops = []
    for lo, hi, _ in outer:
        ops = _executed_path(sass, kernel, lo, hi)
        loops.append((sum(o.startswith("MUFU") for o in ops), len(ops)))
    if len(loops) < 2:
        raise RuntimeError(f"{kernel} has no two loops: {loops}")
    (m1, c1), (m2, c2) = sorted(loops, key=lambda lp: lp[1])
    if m2 > m1:
        return (c2 - c1) / (m2 - m1)
    if m1 or m2 or c2 == c1:
        raise RuntimeError(f"{kernel} has no two loops of different MUFU "
                           f"counts or, without MUFU, of different "
                           f"lengths: {loops}")
    return (c2 - c1) / (steps[1] - steps[0])


def transcendental_instructions(sass: str | None = None) -> dict:
    """The instructions each transcendental step of the stereographic
    twin's tail takes as built, on the path it runs for the twin's inputs
    (``_executed_path``: |t| + 1e-6 and |t| + 1 are normal numbers, so no
    slow path): each ``price_<kind>_kernel`` (``roofline_probes.cu``) has a
    loop of 16 steps a trip and one of 32, and the difference of their
    executed instructions over the difference of their MUFU counts is one
    step's, the loops' own counter and branch cancelling; ``tail`` the six
    steps of a row summed (``STWIN_TRANSCENDENTALS``). ``sass`` defaults to
    ``cuobjdump -sass`` of the built ``roofline_probes`` library."""
    if sass is None:
        sass = _probes_sass()
    prices = {kind: _price_loops(sass, kind)
              for kind in STWIN_TRANSCENDENTALS}
    prices["tail"] = sum(c * prices[k]
                         for k, c in STWIN_TRANSCENDENTALS.items())
    return prices


# The tail kernels' transcendentals priced by their own SASS count
# (``tail_transcendental_prices``); every other one at the accurate tanhf's
TAIL_PRICED = ("sin", "cos", "log", "exp")


def tail_transcendental_prices(sass: str | None = None,
                               steps=(16, 32)) -> dict:
    """SASS instructions of one accurate sinf, cosf, logf and expf on their
    common path as built (``price_<kind>_kernel`` of ``roofline_probes.cu``,
    loops of ``steps`` steps, counted by ``_price_loops``), and ``other``,
    an accurate tanhf's (``tanh_instructions``), the price of every other
    transcendental of the tail (tan, atan, log1p, pow, tanh)."""
    if sass is None:
        sass = _probes_sass()
    prices = {kind: _price_loops(sass, kind, steps) for kind in TAIL_PRICED}
    prices["other"] = tanh_instructions(sass)["per_tanh"]
    return prices


def twin_row_instructions(sass: str | None = None) -> dict:
    """The per-row loop of the resident stereographic twin as built (its
    128-column instantiation): of the kernel's loops the one with the most
    instructions, the instructions one trip issues on its common path
    (``instructions``, ``_executed_path``: the tail's slow paths left out,
    the loop's counter and branch in), its stores (``rows``: one a lane's
    output row), FFMA and MUFU counts and instructions a row
    (``per_row``). ``sass`` defaults to ``cuobjdump -sass`` of the built
    ``roofline_probes`` library."""
    kernel = "twin_stereo_resident_kernelILi32E"
    if sass is None:
        sass = _probes_sass()
    loops = _loop_ops(sass, kernel)
    if not loops:
        raise RuntimeError(f"{kernel} has no loop")
    lo, hi, _ = max(loops, key=lambda lp: len(lp[2]))
    ops = _executed_path(sass, kernel, lo, hi)
    rows = sum(o.startswith("STG") for o in ops)
    if not rows:
        raise RuntimeError(f"the largest loop of {kernel} stores nothing")
    return {"instructions": len(ops), "rows": rows,
            "ffma": sum(o.startswith("FFMA") for o in ops),
            "mufu": sum(o.startswith("MUFU") for o in ops),
            "per_row": len(ops) / rows}


def lorentz_compute_us(rows: int, n: int, cal: dict) -> float:
    """The B7b compute price from the calibrated rates: per row 3 n FLOP
    (n subtractions, n FMAs) and the tail's FLOP over ``fma_tflops``, one
    ``reduce_us``, the tail's transcendentals over ``tanh_gops``."""
    flops = 3 * n + LORENTZ_TAIL_FLOPS
    return rows * (flops / (cal["fma_tflops"] * 1e6) + cal["reduce_us"]
                   + LORENTZ_TAIL_TRANSCENDENTALS / (cal["tanh_gops"] * 1e3))


def rates(times_us: dict, repeat: int) -> dict:
    """Calibrated rates from the probes' device times (us per launch) at
    (B, N): the stream rate counts 3 words a triad element (and
    ``library_stream_gbps`` the same words for ``torch.add`` timed in turns
    with it, ``triad_over_library`` the time ratio), the FMA
    rate 128 * repeat FLOP a word, the tanh rate 16 * repeat a word;
    ``reduce_us`` is one row's reduction (8 a row), ``transpose_us`` one
    (2048, 8) relayout (8 per 2048 rows); ``*_gbps`` the bytes the reduce
    and transpose probes move."""
    rows, words = B, B * N
    t = {k: v * 1e-6 for k, v in times_us.items()}
    out = {
        "stream_gbps": 3 * 4 * words / t["triad"] / 1e9,
        "fma_tflops": words * 64 * 2 * repeat / t["fma"] / 1e12,
        "tanh_gops": words * 16 * repeat / t["tanh"] / 1e9,
        "reduce_us": times_us["reduce"] / (rows * 8),
        "reduce_gbps": 2 * 4 * words / t["reduce"] / 1e9,
        "transpose_us": times_us["transpose"] / (rows / 2048 * 8),
        "transpose_gbps": 4 * (rows * 8 + words) / t["transpose"] / 1e9,
    }
    if "triad_library" in t:
        out["library_stream_gbps"] = 3 * 4 * words / t["triad_library"] / 1e9
        out["triad_over_library"] = t["triad"] / t["triad_library"]
    if "gemm" in t:
        out["bf16_tflops"] = 4 * 2 * GEMM_M ** 3 / t["gemm"] / 1e12
    if "gemm_tf32" in t:
        out["tf32_tflops"] = 4 * 2 * GEMM_M ** 3 / t["gemm_tf32"] / 1e12
    return out


def out_of_window(cal: dict) -> list[str]:
    """The calibrated rates outside their ``SANITY`` window."""
    return [k for k, (lo, hi) in SANITY.items()
            if k in cal and not lo <= cal[k] <= hi]


def peak_share(us: float, nbytes: int = 0, flops: int = 0,
               pipe: str = "fp32") -> dict:
    """Achieved rates and the share of the data-sheet peaks; ``flops`` run
    on ``pipe`` ("fp32" or "tf32": ``pct_of_<pipe>_peak``)."""
    s = us * 1e-6
    out = {}
    if nbytes:
        out["gbps"] = nbytes / s / 1e9
        out["pct_of_hbm_peak"] = 100.0 * out["gbps"] / PEAK["hbm_gbps"]
    if flops:
        out["tflops"] = flops / s / 1e12
        out[f"pct_of_{pipe}_peak"] = (100.0 * out["tflops"]
                                      / PEAK[f"{pipe}_tflops"])
    return out


def binding(us: float, floors: dict) -> dict:
    """The binding floor: the largest of the floors (us per launch, each a
    whole-launch time), which one binds, and the kernel's share of it."""
    name = max(floors, key=floors.get)
    return {"floors_us": dict(floors), "binding_floor_us": floors[name],
            "bound_by": name, "pct_of_binding": 100.0 * floors[name] / us}


def buffer_sets(nbytes: int, l2_bytes: int) -> int:
    """Rotating buffer sets that put twice the L2 between two uses of one
    set (1 when a set alone is that large)."""
    return max(1, math.ceil(2 * l2_bytes / max(nbytes, 1)))


def max_rel_err(got, ref) -> float:
    """Max |got - ref| / (|ref| + 1e-2 max |ref|): relative, with a floor
    of 1% of the reference's scale (the reference's ``_accuracy``)."""
    ref = ref.double()
    scale = 1e-2 * float(ref.abs().max())
    return float(((got.double() - ref).abs() / (ref.abs() + scale)).max())


# -------------------------------------------------------------- measurement


@dataclasses.dataclass
class Timing:
    """Time per call. ``source`` "graph": device time per call from CUDA
    events around one replay of a CUDA graph of ``iters`` calls (no host
    time between them), with ``trace_us`` the median of the ``traced``
    records of the named kernel that the CUPTI trace of another replay
    holds, the cross-check (None when no kernel is named: a library
    composition). ``source`` "events": CUDA events around ``iters`` calls
    as the host issues them (the plain versions; ``trace_us`` None)."""
    us: float
    trace_us: float | None
    traced: int
    iters: int
    source: str


def _events_us(run, calls: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def measure(calls, kernel: str | None = None, iters: int = ITERS,
            graph: bool = False) -> Timing:
    """Time ``calls`` (a zero-argument callable, or a list of them cycled
    through: rotating buffer sets) on the card. With ``kernel`` (the name
    of the main device kernel each call launches once) or ``graph`` the
    calls are captured in a CUDA graph and timed by replay, the whole graph
    per call (a wrapper that launches two kernels, or a library
    composition, counts both); otherwise by an events loop. The wrappers'
    launch counts end up counting what ran on the card: the warm-up calls
    and ``iters`` launches for each of the graph's three replays.

    Why not the CUPTI trace alone: on the H100 machine the trace's kernel
    durations were off by a factor that changes from one profiling session
    to the next (-5% to +5% for one 343 us kernel in three sessions, and
    -13% and -49% in another run, where it put a kernel at 107% of the HBM
    peak), while CUDA events agreed within 1%; the graph keeps the host's
    launch cost out of the events of short kernels."""
    if callable(calls):
        calls = [calls]

    def loop():
        for i in range(iters):
            calls[i % len(calls)]()

    for c in calls:           # warm-up: one call of every buffer set
        c()
    if kernel is None and not graph:
        us = _events_us(loop, iters)
        return Timing(us, None, 0, iters, "events")
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()

    def record():
        with torch.cuda.graph(g):
            loop()

    per_replay = launches.captured_launches(record, COUNTED)
    g.replay()
    us = _events_us(g.replay, iters)
    durations = []
    if kernel is not None:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            g.replay()
            torch.cuda.synchronize()
        durations = sorted(ev.time_range.elapsed_us() for ev in prof.events()
                           if kernel in ev.name)
    else:
        g.replay()
        torch.cuda.synchronize()
    trace_us = durations[len(durations) // 2] if durations else None
    launches.count_replays(per_replay, 3)
    return Timing(us, trace_us, len(durations), iters, "graph")


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[torch.cuda.current_device()]


def _l2_bytes() -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).L2_cache_size


def _normal(shape, seed, scale=1.0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return scale * torch.randn(shape, generator=gen, device="cuda")


def _gemm_chain(x, w):
    """Four chained products (bf16, or float32 with TF32 on) with f32
    accumulation, each fed the previous one's whole output (w ~ N(0, 1 / M)
    keeps the scale)."""
    for _ in range(4):
        x = torch.matmul(x, w)
    return x


def _calibrate_once() -> dict:
    x = _normal((B, N), 0, 0.05)
    y = _normal((B, N), 1, 0.05)
    o = torch.empty_like(x)

    def triad():
        return measure(lambda: probe_triad(x, y, out=o),
                       "probe_triad_kernel")

    def library():
        return measure(lambda: torch.add(x, y, out=o), graph=True)

    # in turns with the library call of the same function: triad, library,
    # library, triad
    turns = [triad(), library(), library(), triad()]
    tm = {
        "triad": mean_timing(turns[0], turns[3]),
        "triad_library": mean_timing(turns[1], turns[2]),
        "fma": measure(lambda: probe_fma(x, CAL_REPEAT), "probe_fma_kernel"),
        "tanh": measure(lambda: probe_tanh(x, CAL_REPEAT),
                        "probe_tanh_kernel"),
        "reduce": measure(lambda: probe_reduce(x), "probe_reduce_kernel"),
        "transpose": measure(lambda: probe_transpose(x),
                             "probe_transpose_kernel"),
    }
    del x, y, o
    a = _normal((GEMM_M, GEMM_M), 2)
    w = _normal((GEMM_M, GEMM_M), 3, GEMM_M ** -0.5)
    with _tf32(True):
        tm["gemm_tf32"] = measure(lambda: _gemm_chain(a, w), graph=True)
    a, w = a.to(torch.bfloat16), w.to(torch.bfloat16)
    tm["gemm"] = measure(lambda: _gemm_chain(a, w), graph=True)
    cal = rates({k: v.us for k, v in tm.items()}, CAL_REPEAT)
    cal["repeat"] = CAL_REPEAT
    cal["triad_turns_us"] = [t.us for t in turns]
    cal["timings"] = {k: dataclasses.asdict(v) for k, v in tm.items()}
    return cal


def calibrate(retries: int = 1) -> dict:
    """Measure the card's rates (``rates``; FMA and tanh at repeat
    ``CAL_REPEAT``); a rate outside its ``SANITY`` window is measured again
    ``retries`` times, then raises ``CalibrationError``."""
    _require_cuda("calibrate()")
    cal = _calibrate_once()
    for _ in range(retries):
        bad = out_of_window(cal)
        if not bad:
            break
        _log(f"  calibration outside its windows ({bad}); measuring again")
        cal = _calibrate_once()
    bad = out_of_window(cal)
    if bad:
        raise CalibrationError(
            "calibrated rates outside their windows: "
            + ", ".join(f"{k} = {cal[k]:.4g} not in {SANITY[k]}"
                        for k in bad))
    return cal


# ------------------------------------------------------------------- rows


def _timing(t: Timing) -> dict:
    return dataclasses.asdict(t)


# The rows' inputs, made from fixed seeds on the card, so that a caller can
# hold the kernels to their plain versions on what the rows timed


def stereo_inputs():
    """B7a's row: x, y (B, N) ~ N(0, 0.05^2), inside the K = -1 ball."""
    return _normal((B, N), 0, 0.05), _normal((B, N), 1, 0.05)


def lorentz_inputs():
    """B7b's row: x, y on the K = -1 hyperboloid, (B, N)."""
    k = torch.tensor(-1.0, device="cuda")
    scale = 0.7 / (N - 1) ** 0.5
    return (lorentz.exp_map_mu0(_normal((B, N - 1), 4, scale), k),
            lorentz.exp_map_mu0(_normal((B, N - 1), 5, scale), k))


def reparam_sets(n_sets: int) -> list[tuple]:
    """B5's row: ``n_sets`` buffer sets (eps (RS, RB, RN), mu, sigma, out
    (RS, RN, RB), the hoisted scalars) at K = -1."""
    k = torch.tensor(-1.0, device="cuda")
    sets = []
    for i in range(n_sets):
        eps = _normal((RS, RB, RN), 10 + 3 * i)
        mu = stereographic.exp_map_mu0(
            _normal((RB, RN), 11 + 3 * i, 0.4), k)
        gen = torch.Generator(device="cuda").manual_seed(12 + 3 * i)
        sig = 0.5 + 0.7 * torch.rand((RB, RN), generator=gen, device="cuda")
        out = torch.empty((RS, RN, RB), device="cuda")
        sets.append((eps, mu, sig, out, reparam_scalars(mu, sig)))
    return sets


def decode_sets(n_sets: int) -> list[tuple]:
    """B2's row: ``n_sets`` argument sets (zt, xt, w1, b1, w2, b2) of
    ``fused_decode_bce_t`` at (DS, DB, DZ, DH, DD)."""
    sets = []
    for i in range(n_sets):
        s = 20 + 7 * i
        gen = torch.Generator(device="cuda").manual_seed(s)
        xt = (torch.rand((DD, DB), generator=gen, device="cuda")
              < 0.3).float()
        sets.append((_normal((DS, DZ, DB), s + 1), xt,
                     _normal((DZ, DH), s + 2, 0.3),
                     _normal((DH,), s + 3, 0.05),
                     _normal((DH, DD), s + 4, 0.08),
                     _normal((DD,), s + 5, 0.05)))
    return sets


def _row_stereo(cal, x, y):
    k = torch.tensor(-1.0, device="cuda")
    t = measure(lambda: manifold_kernels.stereo_distance(x, y, k),
                "stereo_dist_kernel")
    plain = measure(lambda: manifold_kernels.stereo_distance_ref(x, y, k),
                    iters=3)
    skel = measure(lambda: skel_dist(x, y, "rowstore"), "skel_dist_kernel")
    twin_c = measure(lambda: twin_stereo(x, y, resident=True),
                     "twin_stereo_resident_kernel")
    twin_s = measure(lambda: twin_stereo(x, y), "twin_stereo_kernel")
    m = 1 << 16
    err = max_rel_err(
        manifold_kernels.stereo_distance(x[:m], y[:m], k),
        manifold_kernels.stereo_distance_ref(x[:m].double(), y[:m].double(),
                                             k.double()))
    return {"kernel": "B7a stereo_dist", "shape": f"({B}, {N}), K = -1",
            "us": t.us, **peak_share(t.us, dist_bytes(B, N)),
            **binding(t.us, {"skeleton": skel.us, "twin_resident": twin_c.us}),
            "twin_streaming_us": twin_s.us, "plain_us": plain.us,
            "max_rel_err_vs_f64": err, "l2": "none: 1.08 GB a launch",
            "timings": {"kernel": _timing(t), "skeleton": _timing(skel),
                        "twin_resident": _timing(twin_c),
                        "twin_streaming": _timing(twin_s),
                        "plain": _timing(plain)}}


def _row_lorentz(cal, xl, yl):
    k = torch.tensor(-1.0, device="cuda")
    t = measure(lambda: manifold_kernels.lorentz_distance(xl, yl, k),
                "lorentz_dist_kernel")
    plain = measure(lambda: manifold_kernels.lorentz_distance_ref(xl, yl, k),
                    iters=3)
    skel = measure(lambda: skel_dist(xl, yl, "block"), "skel_dist_kernel")
    m = 1 << 16
    err = max_rel_err(
        manifold_kernels.lorentz_distance(xl[:m], yl[:m], k),
        manifold_kernels.lorentz_distance_ref(xl[:m].double(),
                                              yl[:m].double(), k.double()))
    model = lorentz_compute_us(B, N, cal)
    return {"kernel": "B7b lorentz_dist", "shape": f"({B}, {N}), K = -1",
            "us": t.us, **peak_share(t.us, dist_bytes(B, N)),
            **binding(t.us, {"skeleton": skel.us, "compute_model": model}),
            "compute_model": "no twin in the reference: per row 3 n FLOP + "
                             f"{LORENTZ_TAIL_FLOPS} over fma_tflops, one "
                             f"reduce_us, {LORENTZ_TAIL_TRANSCENDENTALS} "
                             "transcendentals over tanh_gops",
            "plain_us": plain.us, "max_rel_err_vs_f64": err,
            "l2": "none: 1.08 GB a launch",
            "timings": {"kernel": _timing(t), "skeleton": _timing(skel),
                        "plain": _timing(plain)}}


def _row_reparam(cal):
    k = torch.tensor(-1.0, device="cuda")
    nbytes = reparam_bytes(RS, RB, RN)
    n_sets = buffer_sets(nbytes, _l2_bytes())
    sets = reparam_sets(n_sets)

    t = measure([functools.partial(manifold_kernels.wrapped_reparam_stereo_t,
                                   e, m, s, k, out=o, sign=-1)
                 for e, m, s, o, _ in sets], "reparam_stereo_kernel",
                iters=REPARAM_ROW_CALLS)
    # the probes get the hoisted scalars made once per example, as the
    # reference's do: only what B5 cannot avoid stays in their floors
    skel = measure([functools.partial(skel_reparam, e, m, s, k, c, out=o,
                                      sign=-1)
                    for e, m, s, o, c in sets], "skel_reparam_kernel",
                   iters=REPARAM_ROW_CALLS)
    twin = measure([functools.partial(twin_reparam, e, m, s, k, c, out=o,
                                      sign=-1)
                    for e, m, s, o, c in sets], "twin_reparam_kernel",
                   iters=REPARAM_ROW_CALLS)
    eps, mu, sig, _, _ = sets[0]
    plain = measure(lambda: manifold_kernels.wrapped_reparam_stereo_ref(
        eps, mu, sig, k, sign=-1), iters=3)
    got = manifold_kernels.wrapped_reparam_stereo_t(eps, mu, sig, k, sign=-1)
    ref = manifold_kernels.wrapped_reparam_stereo_ref(
        eps.double(), mu.double(), sig.double(), k.double(), sign=-1)
    err = max(max_rel_err(a, b) for a, b in zip(got, ref))
    ops = reparam_ops(eps, mu, sig, k, -1)
    return {"kernel": "B5 reparam_stereo",
            "shape": f"S={RS} n={RN} B={RB}, sign -1, K = -1 "
                     "(production IWAE chunk)",
            "us": t.us, **peak_share(t.us, nbytes),
            **binding(t.us, {"skeleton": skel.us,
                             "operations": ops_us(ops, cal)}),
            "ops": ops, "twin_us": twin.us,
            "plain_us": plain.us, "max_rel_err_vs_f64": err,
            "l2": f"rotating {n_sets} buffer sets of {nbytes} B",
            "timings": {"kernel": _timing(t), "skeleton": _timing(skel),
                        "twin": _timing(twin), "plain": _timing(plain)}}


# The tail rows: the main path's products, B1 at the training batch and the
# eval batch, B3 at the training batch
TAIL_SPECS = (("h2,s2,e2", (-1.0, 1.0, 0.0)), ("d2,p2,e2", (-1.0, 1.0, 0.0)),
              ("u6", (0.5,)), ("s6:wrapped", (1.0,)))
TAIL_ROWS = tuple((spec, kset, kern, B) for spec, kset in TAIL_SPECS
                  for kern, B in (("B1", 128), ("B1", 512), ("B3", 128))) + (
    ("u6", (0.5,), "B3", 256), ("s6:wrapped", (1.0,), "B3", 256))


def tail_inputs(spec, kset, B):
    """Heads of the size training produces (0.5 N(0, 1)), their noise, the
    curvatures and random cotangents, on the card from a fixed seed:
    (comps, raw, eps, k, dz, daux)."""
    comps = tuple(parse_components(spec, fixed_curvature=False))
    W, _, Z = tail_kernels._dims(comps)
    g = torch.Generator(device="cuda").manual_seed(B + len(spec))
    raw = 0.5 * torch.randn(B, W, generator=g, device="cuda")
    eps = tail_kernels.draw_noise(comps, (B,), raw, g)
    k = torch.tensor(kset, device="cuda")
    dz = torch.randn(B, Z, generator=g, device="cuda")
    daux = torch.randn(B, len(comps) + 2, generator=g, device="cuda")
    return comps, raw, eps, k, dz, daux


def tail_bytes(comps, B: int, backward: bool) -> int:
    """Bytes a tail kernel must move: its inputs read once, its outputs
    written once (B3's folded dk included)."""
    W, E, Z = tail_kernels._dims(comps)
    nc = len(comps)
    if backward:
        return 4 * (B * (W + E + Z + nc + 2) + nc + B * (W + nc) + nc)
    return 4 * (B * (W + E) + nc + B * (Z + nc + 2))


def _row_tail(cal, prices, spec, kset, kern, B):
    comps, raw, eps, k, dz, daux = tail_inputs(spec, kset, B)
    bwd = kern == "B3"
    cot = (dz, daux) if bwd else ()
    fn = tail_kernels.tail_backward if bwd else tail_kernels.tail_forward
    ref = (tail_kernels.tail_backward_ref if bwd
           else tail_kernels.tail_forward_ref)
    name = "skel_tail_bwd_kernel" if bwd else "skel_tail_fwd_kernel"
    # 100 calls a graph, as chip_smoke's kernel_ms: on the H100 a replay's
    # fixed cost spread over 20 calls added ~1-3 us to a call of these
    # few-us kernels
    t = measure(lambda: fn(comps, raw, eps, k, *cot),
                "tail_bwd_kernel" if bwd else "tail_fwd_kernel", iters=100)
    skel = measure(lambda: skel_tail(comps, raw, eps, k, *cot), name,
                   iters=100)
    split_grid = any(tail_kernels.component_split(c) for c in comps)
    skel_warp = (measure(lambda: skel_tail(comps, raw, eps, k, *cot,
                                           warp=True), name, iters=100)
                 if split_grid else None)
    plain = measure(lambda: ref(comps, raw, eps, k, *cot), iters=3)
    split = tail_op_split(comps, raw, eps, k, *cot)
    ops = split["arithmetic"] + split["transcendental"]
    slots = tail_priced_ops(split, prices)
    nbytes = tail_bytes(comps, B, bwd)
    timings = {"kernel": _timing(t), "skeleton": _timing(skel),
               "plain": _timing(plain)}
    if skel_warp is not None:
        timings["skeleton_warp"] = _timing(skel_warp)
    return {"kernel": f"{kern} tail_{'bwd' if bwd else 'fwd'} {spec}",
            "shape": f"B={B}, K={kset}", "us": t.us,
            **peak_share(t.us, nbytes, ops),
            **binding(t.us, tail_floors(
                skel.us, slots, cal,
                None if skel_warp is None else skel_warp.us)),
            "plain_us": plain.us, "ops": ops, "fma_slots": slots,
            "transcendentals": split["by_name"], "bytes": nbytes,
            "geometry": "split" if split_grid else "warp a component",
            "l2": "one buffer set (the caller's heads come from L2)",
            "timings": timings}


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def mean_timing(a: Timing, b: Timing) -> Timing:
    """Two timings of one thing, taken in turns with another: their mean
    (the trace medians averaged where both have one)."""
    tr = (None if a.trace_us is None or b.trace_us is None
          else (a.trace_us + b.trace_us) / 2)
    return Timing((a.us + b.us) / 2, tr, a.traced + b.traced,
                  a.iters + b.iters, a.source)


def _two_gemm_decode(zt, xt, w1, b1, w2, b2):
    """The decode as two library products and the BCE, in full FP32 or
    TF32 as the caller sets ``allow_tf32``."""
    h = torch.relu(torch.matmul(zt.transpose(1, 2), w1) + b1)
    logits = torch.matmul(h, w2) + b2
    return torch.sum(xt.T * logits - stable.softplus(logits), dim=-1)


def two_sgemm_operands(zt, w1, b1, w2):
    """The operands of B2's library yardstick: z as (S B, Z) rows and
    h = relu(z W1 + b1), made outside the timed calls."""
    zf = zt.transpose(1, 2).reshape(-1, zt.shape[1]).contiguous()
    return zf, w1, torch.relu(zf @ w1 + b1), w2


def two_sgemms(zf, w1, hf, w2):
    """B2's library yardstick: the decoder's two products alone, one
    cuBLAS FP32 SGEMM each (no bias, ReLU or BCE)."""
    return torch.mm(zf, w1), torch.mm(hf, w2)


def decode_floors(S: int, Bb: int, Z: int, H: int, D: int, cal: dict) -> dict:
    """B2's floors (us per launch) from the calibrated rates: its 3xTF32
    tensor products at ``tf32_tflops``; its FP32 part at ``fma_tflops``
    with the transcendentals at ``tanh_gops`` (the two pipes run side by
    side with the tensor cores, so the largest binds); its bytes at
    ``stream_gbps``."""
    fl = decode_flops(S, Bb, Z, H, D)
    return {"tensor_3xtf32": fl["tensor_3xtf32"] / (cal["tf32_tflops"] * 1e6),
            "fp32_part": (fl["fp32_part"] / (cal["fma_tflops"] * 1e6)
                          + fl["transcendentals"] / (cal["tanh_gops"] * 1e3)),
            "bytes_stream": decode_bytes(S, Bb, Z, H, D)
                            / (cal["stream_gbps"] * 1e3)}


def _row_decode(cal):
    S, Bb, Z, H, D = DS, DB, DZ, DH, DD
    nbytes = decode_bytes(S, Bb, Z, H, D)
    sets = decode_sets(buffer_sets(nbytes, _l2_bytes()))
    n_sets = len(sets)
    lib_sets = [two_sgemm_operands(zt, w1, b1, w2)
                for zt, _, w1, b1, w2, _ in sets]

    def kernel():
        return measure([functools.partial(decoder_kernels.fused_decode_bce_t,
                                          *a) for a in sets],
                       "decode_bce_kernel")

    def library():
        with _tf32(False):
            return measure([functools.partial(two_sgemms, *a)
                            for a in lib_sets], graph=True)

    # in turns on one card: kernel, library, library, kernel
    turns = [kernel(), library(), library(), kernel()]
    t, lib = mean_timing(turns[0], turns[3]), mean_timing(turns[1], turns[2])
    del lib_sets
    with _tf32(False):
        plain = measure(functools.partial(decoder_kernels.decode_bce_ref,
                                          *sets[0]), iters=3)
        ref = _two_gemm_decode(*sets[0])
        ref64 = _two_gemm_decode(*[a.double() for a in sets[0]])
        got = decoder_kernels.fused_decode_bce_t(*sets[0])
    with _tf32(True):
        tf32 = measure([functools.partial(_two_gemm_decode, *a)
                        for a in sets], graph=True)
        ll_tf32 = _two_gemm_decode(*sets[0])
    fl = decode_flops(S, Bb, Z, H, D)
    return {"kernel": "B2 decode_bce", "shape": f"S={S} B={Bb} Z={Z} H={H} "
                                               f"D={D}",
            "us": t.us, **peak_share(t.us, flops=fl["tensor_3xtf32"],
                                     pipe="tf32"),
            **binding(t.us, decode_floors(S, Bb, Z, H, D, cal)),
            "fp32_calibrated_floor_us": fl["total"] / (cal["fma_tflops"]
                                                       * 1e6),
            "fp32_peak_us": fl["total"] / (PEAK["fp32_tflops"] * 1e6),
            "flops": fl, "plain_us": plain.us,
            "two_sgemm_fp32_us": lib.us, "two_gemm_tf32_us": tf32.us,
            "turns_us": [x.us for x in turns],
            "max_abs_err_nats_vs_fp32": float((got - ref).abs().max()),
            "tf32_max_abs_err_nats_vs_fp32": float((ll_tf32 - ref).abs().max()),
            "fp32_max_abs_err_nats_vs_f64": float((ref - ref64).abs().max()),
            "max_abs_err_nats_vs_f64": float((got - ref64).abs().max()),
            "l2": f"rotating {n_sets} buffer sets of {nbytes} B",
            "timings": {"kernel": _timing(t), "two_sgemm_fp32": _timing(lib),
                        "two_gemm_tf32": _timing(tf32),
                        "plain": _timing(plain)}}


def main(out_path: str | None = None) -> dict:
    """Calibrate the card, then the binding rows of B7a, B7b, B5 and B2 at
    the reference's shapes and of B1 and B3 on the main path's products
    (``TAIL_ROWS``: floor the larger of the tail's I/O skeleton and its
    operations at the calibrated FMA rate); returns them with every
    probe's timing (``probes``), and writes them to ``out_path`` as
    JSON."""
    _require_cuda("roofline.main()")
    name = card()
    _log(f"card: {name}; data sheet {PEAK}")
    cal = calibrate()
    _log("calibration: " + ", ".join(
        f"{k} {v:.4g}" for k, v in cal.items() if isinstance(v, float)))
    rows = [_row_stereo(cal, *stereo_inputs())]
    rows.append(_row_lorentz(cal, *lorentz_inputs()))
    rows.append(_row_reparam(cal))
    rows.append(_row_decode(cal))
    prices = tail_transcendental_prices()
    _log("tail transcendentals, SASS instructions (common path): "
         + ", ".join(f"{k} {v:.2f}" for k, v in prices.items()))
    rows += [_row_tail(cal, prices, *r) for r in TAIL_ROWS]
    for r in rows:
        _log(f"{r['kernel']:20s} {r['us']:10.3f} us; binding floor "
             f"{r['binding_floor_us']:10.3f} us ({r['bound_by']}) -> "
             f"{r['pct_of_binding']:5.1f}%; plain {r['plain_us']:10.3f} us")
    stereo, lor, rep = (r["timings"] for r in rows[:3])
    probes = {f"probe_{k}": cal["timings"][k]
              for k in ("triad", "fma", "tanh", "reduce", "transpose")}
    probes.update(skel_dist_rowstore=stereo["skeleton"],
                  skel_dist_block=lor["skeleton"],
                  twin_stereo_resident=stereo["twin_resident"],
                  twin_stereo_streaming=stereo["twin_streaming"],
                  skel_reparam=rep["skeleton"], twin_reparam=rep["twin"])
    for r in rows[4:]:
        probes[f"skel_tail {r['kernel']} {r['shape']}"] = \
            r["timings"]["skeleton"]
        if "skeleton_warp" in r["timings"]:
            probes[f"skel_tail warp {r['kernel']} {r['shape']}"] = \
                r["timings"]["skeleton_warp"]
    result = {"card": name, "device": torch.cuda.get_device_name(0),
              "peak": PEAK, "calibration": cal, "tail_prices": prices,
              "rows": rows, "probes": probes}
    if out_path:
        with open(out_path, "w") as f:
            f.write(json.dumps(result) + "\n")
        _log(f"wrote {out_path}")
    return result


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else None)))
