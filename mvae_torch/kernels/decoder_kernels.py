"""Fused MLP decoder + Bernoulli log-likelihood for the IWAE path.

Counterpart of the IWAE half of ``mvae_tpu/kernels/decoder_kernels.py``:

    ll[s, b] = sum_pixels [ x * logits - softplus(logits) ],
    logits   = relu(z W1 + b1) W2 + b2,

for importance samples zt (S, Z, B) against targets xt (D, B), batch
contiguous -- the reference entry's public layout. ``fused_decode_bce_t``
runs it in one launch of the CUDA kernel ``csrc/decode_bce.cu`` (replaces
the TPU kernel ``decoder_kernels.fused_decode_bce_t``): the hidden layer
and the logits stay in shared memory and registers, and the FP32 FMA
GEMMs meet the reference's contract of <= 2e-3 nats per 784-pixel row
against an f32 oracle.

``decode_bce_ref`` is the plain PyTorch version (two full-f32 matmuls and
the stable BCE sum): the CPU path and the card check's reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import stable
from . import _build

# csrc/decode_bce.cu tiling: batch columns per block, W2 pixel tile and
# hidden stage, thread rows, and the per-block shared-memory ceiling.
_COLS, _TD, _KC, _TY = 64, 64, 16, 16
_SMEM_LIMIT = 232448


def smem_bytes(Z: int, H: int) -> int:
    """Dynamic shared memory the kernel needs for latent width Z and
    hidden width H (csrc/decode_bce.cu smem_bytes)."""
    return 4 * (H * _COLS + Z * _COLS + _KC * _TD + _TY * _COLS)


def shape_supported(Z: int, H: int) -> bool:
    """Whether the kernel's hidden tile fits one block's shared memory."""
    return smem_bytes(Z, H) <= _SMEM_LIMIT


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
    if not shape_supported(Z, H):
        raise ValueError(f"(Z={Z}, H={H}) exceeds the kernel's shared memory")
    args = [t.contiguous() for t in args]
    out = torch.empty((S, B), dtype=torch.float32, device=zt.device)
    stream = torch.cuda.current_stream(zt.device).cuda_stream
    _build.check(_lib()(*[t.data_ptr() for t in args], out.data_ptr(),
                        S, Z, B, H, D, stream), "decode_bce_launch")
    fused_decode_bce_t.launches += 1
    return out


fused_decode_bce_t.launches = 0
