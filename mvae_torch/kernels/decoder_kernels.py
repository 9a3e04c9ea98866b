"""Fused MLP decoder + Bernoulli log-likelihood: the IWAE and training paths.

Counterpart of ``mvae_tpu/kernels/decoder_kernels.py``. The IWAE half:

    ll[s, b] = sum_pixels [ x * logits - softplus(logits) ],
    logits   = relu(z W1 + b1) W2 + b2,

for importance samples zt (S, Z, B) against targets xt (D, B), batch
contiguous -- the reference entry's public layout. ``fused_decode_bce_t``
runs it in one launch of the CUDA kernel ``csrc/decode_bce.cu`` (replaces
the TPU kernel ``decoder_kernels.fused_decode_bce_t``): the hidden layer
stays in shared memory and the logits in registers, and the product with
W2 runs on Hopper's tensor cores (warpgroup ``wgmma``) as three TF32
products (3xTF32: each float32 operand split into a TF32 pair,
``tf32_split_ref``), which keeps FP32-grade products (<= 1e-3 nats per
784-pixel row against the full-f32 plain version) where one TF32 pass
would not.

``decode_bce_ref`` is the plain PyTorch version (two full-f32 matmuls and
the stable BCE sum): the CPU path and the card check's reference.

The training half, ``train_decode_bce`` (z (B, Z), x (B, D) -> ll (B,)),
is an autograd Function whose forward runs the CUDA kernel
``csrc/train_decode.cu`` (replaces the TPU kernel
``decoder_kernels._train_decode_fwd_pallas``): it returns ll, the hidden
layer h and gl = x - sigmoid(logits) in one launch (16-row x 32-pixel
tiles, W2 fetched by the Tensor Memory Accelerator while h is computed,
h W2 as 3xTF32 on the tensor cores, the row sums folded by the last block
of a row tile: ``train_tile_plan``), so its backward is
four FP32 matrix products and two bias sums (``torch.matmul``, as the
reference leaves them to XLA). ``train_decode_ref`` is its plain version,
in full FP32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import stable
from ..utils.profiling import check_outputs
from . import _build

# The tiling of csrc/train_decode_plan.cuh: batch rows and pixels per block,
# the shared row of W2 and of a partial tile (32 + 8 words), hidden units
# per W2 stage, warps per block, the ring's stages, and its dynamic
# shared-memory ceiling (a block's, less 128 bytes for its static words
# and the dynamic region's alignment); then the per-block ceiling.
_TD_BM, _TD_BN, _TD_WS, _TD_KC, _TD_WARPS, _TD_RING = 16, 32, 40, 16, 4, 4
_TD_SMEM_LIMIT = 232320
_SMEM_LIMIT = 232448
# The tiling of csrc/decode_bce.cu: examples per block, W2 column tile,
# hidden stage, warpgroups per block, W2 stages in shared memory.
_DEC_BM, _DEC_BN, _DEC_BK, _DEC_WG, _DEC_NBUF = 64, 112, 32, 2, 2


def _td_hp(H: int) -> int:
    """Row stride of h in the training kernel's shared memory (``td_hp``):
    the stages' hidden units as an odd number of 16-byte words."""
    return 4 * ((-(-H // _TD_KC) * _TD_KC // 4) | 1)


def _td_smem(Z: int, H: int, slots: int) -> int:
    return 4 * (_TD_BM * _td_hp(H) + Z * _TD_BM + slots * _TD_KC * _TD_WS
                + _TD_WARPS * _TD_BM * _TD_WS)


def _td_slots(Z: int, H: int) -> int:
    """W2 stages resident: all of them when they fit, else the ring's."""
    stages = -(-H // _TD_KC)
    return stages if _td_smem(Z, H, stages) <= _TD_SMEM_LIMIT else _TD_RING


def smem_bytes(Z: int, H: int) -> int:
    """Dynamic shared memory the training decode kernel needs for latent
    width Z and hidden width H (its plan's ``smem``; the ring's when the
    whole W2 slice does not fit)."""
    return _td_smem(Z, H, _td_slots(Z, H))


def shape_supported(Z: int, H: int) -> bool:
    """Whether the training kernel has a plan for (Z, H): h for 16 rows
    and 4 W2 stages fit one block's shared memory (H up to 3,296 at
    Z = 8; every stage resident up to H = 976)."""
    return Z >= 1 and H >= 1 and smem_bytes(Z, H) <= _TD_SMEM_LIMIT


@functools.lru_cache(maxsize=64)
def train_tile_plan(B: int, Z: int, H: int, D: int) -> dict | None:
    """The launch of csrc/train_decode.cu (``td_plan`` of
    train_decode_plan.cuh): a grid of ``pixel_tiles`` x ``row_tiles``
    blocks of 16 rows x 32 pixels (one row-tile counter each), W2 in
    ``stages`` of 16 hidden units with ``slots`` of them resident: all
    when the slice fits, fetched by the Tensor Memory Accelerator when
    D % 4 == 0 (``fetch`` "tma") or by cp.async copies ("copy"), else a
    ring of 4 ("ring"); the shared memory and the floats of row partials
    (``part``). None when even the ring does not fit."""
    if B < 0 or D < 1 or not shape_supported(Z, H):
        return None
    stages, slots = -(-H // _TD_KC), _td_slots(Z, H)
    rows, cols = -(-B // _TD_BM), -(-D // _TD_BN)
    fetch = "ring" if slots < stages else "tma" if D % 4 == 0 else "copy"
    return {"row_tiles": rows, "pixel_tiles": cols, "stages": stages,
            "slots": slots, "hp": _td_hp(H), "fetch": fetch,
            "smem": _td_smem(Z, H, slots), "part": rows * cols * _TD_BM}


def decode_smem_bytes(Z: int, H: int) -> int:
    """Dynamic shared memory the IWAE decode kernel needs (``smem_bytes``
    of decode_bce.cu): two W2 stages, each split into a hi and a lo
    tile (14 groups of 8 columns, 4 words of padding a group), h for
    64 examples (H rounded up to the stage depth, plus 4 words a row), the
    z tile and the row partials of the two warpgroups."""
    hp = -(-H // _DEC_BK) * _DEC_BK
    split = _DEC_BN // 8 * (8 * _DEC_BK + 4)
    return 4 * (_DEC_NBUF * 2 * split + _DEC_BM * (hp + 4) + Z * _DEC_BM
                + _DEC_WG * _DEC_BM)


def decode_shape_supported(Z: int, H: int) -> bool:
    """Whether the IWAE decode kernel's resident h fits one block."""
    return decode_smem_bytes(Z, H) <= _SMEM_LIMIT


def tf32_trunc_ref(a):
    """What the tensor core reads of a float32 operand: its top 19 bits
    (sign, exponent, 10 mantissa bits), the low 13 cleared."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_rna_ref(a):
    """float32 rounded to TF32 to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: half of the 13 dropped bits added to the
    float's bits, then cleared."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split_ref(a):
    """The (hi, lo) pair of ``csrc/tf32.cuh``: hi = a rounded to TF32, lo =
    a - hi (exact in float32; the tensor core reads ``tf32_trunc_ref(lo)``)."""
    hi = tf32_rna_ref(a)
    return hi, a - hi


def decode_bce_ref(zt, xt, w1, b1, w2, b2):
    """Plain PyTorch version: (S, Z, B), (D, B) -> (S, B) log p(x | z)."""
    if zt.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("decode_bce_ref needs full-f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    h = torch.relu(torch.matmul(zt.transpose(1, 2), w1) + b1)   # (S, B, H)
    logits = torch.matmul(h, w2) + b2                           # (S, B, D)
    t = xt.T * logits - stable.softplus(logits)
    return torch.sum(t, dim=-1)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("decode_bce").decode_bce_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return fn


def fused_decode_bce_t(zt, xt, w1, b1, w2, b2):
    """log p(x | z) for a depth-1 ReLU MLP Bernoulli decoder.

    zt: (S, Z, B) latent draws; xt: (D, B) targets in [0, 1]; w1 (Z, H),
    b1 (H,), w2 (H, D), b2 (D,). Returns (S, B) float32. On CUDA tensors
    one launch of ``csrc/decode_bce.cu``; on CPU tensors
    ``decode_bce_ref``."""
    S, Z, B = zt.shape
    D = xt.shape[0]
    H = w1.shape[1]
    shapes = {"xt": (xt, (D, B)), "w1": (w1, (Z, H)), "b1": (b1, (H,)),
              "w2": (w2, (H, D)), "b2": (b2, (D,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if zt.device.type == "cpu":
        return decode_bce_ref(zt, xt, w1, b1, w2, b2)
    if zt.device.type != "cuda":
        raise ValueError(f"unsupported device {zt.device}")
    args = [zt, xt, w1, b1, w2, b2]
    for t in args:
        if t.dtype != torch.float32 or t.device != zt.device:
            raise ValueError(f"all operands must be float32 on {zt.device}")
    if not decode_shape_supported(Z, H):
        raise ValueError(f"(Z={Z}, H={H}) exceeds the kernel's shared memory")
    args = [t.contiguous() for t in args]
    out = torch.empty((S, B), dtype=torch.float32, device=zt.device)
    stream = torch.cuda.current_stream(zt.device).cuda_stream
    _build.check(_lib()(*[t.data_ptr() for t in args], out.data_ptr(),
                        S, Z, B, H, D, stream), "decode_bce_launch")
    fused_decode_bce_t.launches += 1
    check_outputs("decode_bce", out)
    return out


fused_decode_bce_t.launches = 0


# --- the training path ----------------------------------------------------------


def train_decode_ref(z, x, w1, b1, w2, b2):
    """Plain PyTorch version, full FP32: z (B, Z), x (B, D) -> (ll (B,),
    h (B, H), gl = x - sigmoid(logits) (B, D))."""
    if z.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("train_decode_ref needs full-f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    h = torch.relu(torch.matmul(z, w1) + b1)
    logits = torch.matmul(h, w2) + b2
    ll = torch.sum(x * logits - stable.softplus(logits), dim=-1)
    return ll, h, x - torch.sigmoid(logits)


@functools.lru_cache(maxsize=None)
def _lib_train():
    fn = _build.load("train_decode").train_decode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return fn


_COUNTERS: dict = {}


def _row_tile_counters(device, n: int):
    """The kernel's row-tile counters on ``device``: zeroed once, cached,
    and left at zero by every launch (the last block of a row tile resets
    its own), so calls and CUDA-graph replays reuse them. Grown outside a
    graph capture only."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("train_decode_fwd: call it once at this batch "
                               "size before capturing a CUDA graph")
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned start (the kernel's float4,
    cp.async and tensor-map accesses), copied only when it is not."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    t = t.detach().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def train_decode_fwd(z, x, w1, b1, w2, b2):
    """(ll, h, gl) of the training decode: on CUDA tensors one launch of
    ``csrc/train_decode.cu``, counted on ``train_decode_bce.launches``; on
    CPU tensors ``train_decode_ref``."""
    B, Z = z.shape
    D = x.shape[1]
    H = w1.shape[1]
    if (x.shape != (B, D) or w1.shape != (Z, H) or b1.shape != (H,)
            or w2.shape != (H, D) or b2.shape != (D,)):
        raise ValueError(
            f"for z {tuple(z.shape)}: x must be {(B, D)}, w1 {(Z, H)}, b1 "
            f"{(H,)}, w2 {(H, D)}, b2 {(D,)}; got {tuple(x.shape)}, "
            f"{tuple(w1.shape)}, {tuple(b1.shape)}, {tuple(w2.shape)}, "
            f"{tuple(b2.shape)}")
    if z.device.type == "cpu":
        return train_decode_ref(z, x, w1, b1, w2, b2)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    args = [z, x, w1, b1, w2, b2]
    for t in args:
        if t.dtype != torch.float32 or t.device != z.device:
            raise ValueError(f"all operands must be float32 on {z.device}")
    plan = train_tile_plan(B, Z, H, D)
    if plan is None:
        raise ValueError(f"(Z={Z}, H={H}, D={D}) has no plan within the "
                         f"kernel's shared memory")
    args = [_aligned(t) for t in args]
    dev = z.device
    ll = torch.empty((B,), dtype=torch.float32, device=dev)
    h = torch.empty((B, H), dtype=torch.float32, device=dev)
    gl = torch.empty((B, D), dtype=torch.float32, device=dev)
    part = torch.empty((plan["part"],), dtype=torch.float32, device=dev)
    counters = _row_tile_counters(dev, plan["row_tiles"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_lib_train()(*[t.data_ptr() for t in args], ll.data_ptr(),
                              h.data_ptr(), gl.data_ptr(), part.data_ptr(),
                              counters.data_ptr(), B, Z, H, D, stream),
                 "train_decode_launch")
    train_decode_bce.launches += 1
    check_outputs("train_decode", ll, h, gl)
    return ll, h, gl


class _TrainDecodeFn(torch.autograd.Function):
    """log p(x | z) with the saved (h, gl): the backward is the four
    products and two bias sums of the reference's
    ``_train_decode_vjp_bwd``, in FP32. The targets x get no gradient."""

    @staticmethod
    def forward(ctx, z, x, w1, b1, w2, b2):
        ll, h, gl = train_decode_fwd(z, x, w1, b1, w2, b2)
        ctx.save_for_backward(z, h, gl, w1, w2)
        return ll

    @staticmethod
    def backward(ctx, dll):
        # the cotangent scales gl once: dl = dll gl; the ReLU's mask is one
        # threshold_backward (eight device ops in all, a host-bound step's
        # cost)
        z, h, gl, w1, w2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dl = gl * dll[:, None]
        db2 = torch.sum(dl, dim=0) if need[5] else None
        dw2 = torch.matmul(h.T, dl) if need[4] else None
        dh = torch.ops.aten.threshold_backward(torch.matmul(dl, w2.T), h, 0.0)
        db1 = torch.sum(dh, dim=0) if need[3] else None
        dw1 = torch.matmul(z.T, dh) if need[2] else None
        dz = torch.matmul(dh, w1.T) if need[0] else None
        return dz, None, dw1, db1, dw2, db2


def train_decode_bce(z, x, w1, b1, w2, b2):
    """Per-example log p(x | z) of the training forward for a depth-1 ReLU
    MLP Bernoulli decoder: z (B, Z), x (B, D) -> (B,), differentiable in z
    and the weights (``_TrainDecodeFn``)."""
    return _TrainDecodeFn.apply(z, x, w1, b1, w2, b2)


train_decode_bce.launches = 0
