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
layer h and gl = x - sigmoid(logits) in one pass, so its backward is four
FP32 matrix products and two bias sums (``torch.matmul``, as the reference
leaves them to XLA). It is opt-in through the reference's own switch
``MVAE_FUSED_TRAIN_DECODER`` (``use_fused_train_decoder``).
``train_decode_ref`` is its plain version, in full FP32.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from ..ops import stable
from ..utils.profiling import check_outputs
from . import _build

# The tiling of csrc/train_decode.cu: batch rows per block, W2 pixel tile
# and hidden stage, the 16 threads along one side of a block, and the
# per-block shared-memory ceiling.
_COLS, _TD, _KC, _TY = 64, 64, 16, 16
_SMEM_LIMIT = 232448
# The tiling of csrc/decode_bce.cu: examples per block, W2 column tile,
# hidden stage, warpgroups per block, W2 stages in shared memory.
_DEC_BM, _DEC_BN, _DEC_BK, _DEC_WG, _DEC_NBUF = 64, 112, 32, 2, 2


def smem_bytes(Z: int, H: int) -> int:
    """Dynamic shared memory the training decode kernel needs for latent
    width Z and hidden width H (``smem_bytes`` of train_decode.cu)."""
    return 4 * (H * _COLS + Z * _COLS + _KC * _TD + _TY * _COLS)


def shape_supported(Z: int, H: int) -> bool:
    """Whether the training kernel's hidden tile fits one block's shared
    memory."""
    return smem_bytes(Z, H) <= _SMEM_LIMIT


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


def use_fused_train_decoder() -> bool:
    """The reference's switch ``MVAE_FUSED_TRAIN_DECODER``: "1" on, "0"
    off, "auto" (the default) off, as in the reference. Its default was
    measured on the TPU; the port's own H100 numbers are in PERF.md."""
    v = os.environ.get("MVAE_FUSED_TRAIN_DECODER", "auto")
    if v in ("0", "1"):
        return v == "1"
    return False


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
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return fn


def train_decode_fwd(z, x, w1, b1, w2, b2):
    """(ll, h, gl) of the training decode: on CUDA tensors one launch of
    ``csrc/train_decode.cu``, counted on ``train_decode_bce.launches``; on
    CPU tensors ``train_decode_ref``."""
    B, Z = z.shape
    D = x.shape[1]
    H = w1.shape[1]
    shapes = {"x": (x, (B, D)), "w1": (w1, (Z, H)), "b1": (b1, (H,)),
              "w2": (w2, (H, D)), "b2": (b2, (D,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if z.device.type == "cpu":
        return train_decode_ref(z, x, w1, b1, w2, b2)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    args = [z, x, w1, b1, w2, b2]
    for t in args:
        if t.dtype != torch.float32 or t.device != z.device:
            raise ValueError(f"all operands must be float32 on {z.device}")
    if not shape_supported(Z, H):
        raise ValueError(f"(Z={Z}, H={H}) exceeds the kernel's shared memory")
    args = [t.detach().contiguous() for t in args]
    dev = z.device
    ll = torch.empty((B,), dtype=torch.float32, device=dev)
    h = torch.empty((B, H), dtype=torch.float32, device=dev)
    gl = torch.empty((B, D), dtype=torch.float32, device=dev)
    part = torch.empty((B, -(-D // _TD)), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_lib_train()(*[t.data_ptr() for t in args], ll.data_ptr(),
                              h.data_ptr(), gl.data_ptr(), part.data_ptr(),
                              B, Z, H, D, stream), "train_decode_launch")
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
        z, h, gl, w1, w2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        hs = dll[:, None] * h
        db2 = torch.matmul(gl.T, dll) if need[5] else None
        dw2 = torch.matmul(hs.T, gl) if need[4] else None
        dh = dll[:, None] * torch.matmul(gl, w2.T) * (h > 0)
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
