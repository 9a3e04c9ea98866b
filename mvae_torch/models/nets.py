"""Encoder/decoder networks as init/apply functions on dicts of tensors.

Counterpart of ``mvae_tpu/models/nets.py``: the MLP stacks (ReLU, hidden
size ~400) and the conv stacks of the CIFAR model (32x32xC -> 16x16x64 ->
8x8x128 -> h_dim, and mirrored). Parameters keep the reference's layout,
so they convert leaf by leaf and checkpoints are interchangeable: linear
weights (in, out), conv weights HWIO. Activations are NHWC at the
interfaces, as the reference's; the convs run as cuDNN / ATen convolutions
on the NHWC tensors viewed channels-last, the weights permuted at use.

Every conv runs, forward and backward, at full float32: cuDNN's TF32 is
switched off around each call (``_ConvF32``), whatever
``torch.backends.cudnn.allow_tf32`` says, because the IWAE estimate is held
to float32 grade.

While a torch profiler records, the conv nets mark the layer boundaries
inside the encoder and the decoder (``utils.profiling``): ``encode_fc``
before the encoder's fc, ``decode_conv`` before the first transposed conv,
and, under autograd, ``bwd_decode_fc`` and ``bwd_encode_conv`` where the
backward reaches the gradients of the tensors entering the first
transposed conv and the encoder's fc; the MLP nets mark nothing.

Two opt-in switches, as in the reference: ``set_bf16_matmul``
(``MVAE_BF16_MATMUL=1``) rounds the linear layers' operands to bfloat16
with float32 accumulation and output; ``set_bf16_conv_activations``
(``MVAE_BF16_CONV_ACT=1``) carries the activations between the convs in
bfloat16 (weights cast at use, features and logits back at the master
dtype).
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.nn.functional as F

from ..utils import profiling

_BF16_MATMUL = os.environ.get("MVAE_BF16_MATMUL", "0") == "1"
_BF16_CONV_ACT = os.environ.get("MVAE_BF16_CONV_ACT", "0") == "1"


def set_bf16_matmul(enabled: bool):
    global _BF16_MATMUL
    _BF16_MATMUL = enabled


def set_bf16_conv_activations(enabled: bool):
    global _BF16_CONV_ACT
    _BF16_CONV_ACT = enabled


def _linear_init(in_dim: int, out_dim: int, dtype, generator=None):
    scale = math.sqrt(2.0 / in_dim)  # He init for ReLU stacks
    return {
        "w": scale * torch.randn((in_dim, out_dim), generator=generator,
                                 dtype=dtype),
        "b": torch.zeros((out_dim,), dtype=dtype),
    }


def _linear(params, x):
    w = params["w"]
    if _BF16_MATMUL and x.dtype == torch.float32:
        # bfloat16 operands, float32 products and sums: a product of two
        # bfloat16 values is exact in float32
        x, w = (t.to(torch.bfloat16).to(torch.float32) for t in (x, w))
    return x @ w + params["b"]


def mlp_encoder_init(in_dim: int, h_dim: int, dtype=torch.float32,
                     depth: int = 1, generator=None):
    dims = [in_dim] + [h_dim] * depth
    return {"layers": tuple(_linear_init(dims[i], dims[i + 1], dtype,
                                         generator)
                            for i in range(depth))}


def mlp_encoder_apply(params, x):
    """x (..., D) -> features (..., H)."""
    h = x
    for layer in params["layers"]:
        h = torch.relu(_linear(layer, h))
    return h


def mlp_decoder_init(z_dim: int, h_dim: int, out_dim: int,
                     dtype=torch.float32, depth: int = 1, generator=None):
    dims = [z_dim] + [h_dim] * depth
    return {
        "layers": tuple(_linear_init(dims[i], dims[i + 1], dtype, generator)
                        for i in range(depth)),
        "out": _linear_init(h_dim, out_dim, dtype, generator),
    }


def mlp_decoder_apply(params, z):
    """z (..., Z) -> logits (..., D)."""
    h = z
    for layer in params["layers"]:
        h = torch.relu(_linear(layer, h))
    return _linear(params["out"], h)


# --- conv encoder/decoder (CIFAR) ----------------------------------------------

_CONV_CHANNELS = (64, 128)
_K, _S = 4, 2   # every conv: 4x4 kernel, stride 2, SAME padding


@contextlib.contextmanager
def _cudnn_f32():
    """cuDNN's TF32 off for the block, restored after."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


class _ConvF32(torch.autograd.Function):
    """``aten.convolution`` (no bias) whose forward and backward both run
    with cuDNN's TF32 off: the backward runs after the forward's caller
    has returned, so a context around the call alone would not cover it."""

    @staticmethod
    def forward(ctx, x, w, padding, transposed):
        ctx.save_for_backward(x, w)
        ctx.conf = (padding, transposed)
        with _cudnn_f32():
            return torch.ops.aten.convolution(
                x, w, None, [_S, _S], padding, [1, 1], transposed, [0, 0], 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        padding, transposed = ctx.conf
        with _cudnn_f32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [_S, _S], padding, [1, 1], transposed,
                [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                            False])
        return gx, gw, None, None


def _conv_init(h, w, cin, cout, dtype, generator=None):
    scale = math.sqrt(2.0 / (h * w * cin))
    return {"w": scale * torch.randn((h, w, cin, cout), generator=generator,
                                     dtype=dtype),
            "b": torch.zeros((cout,), dtype=dtype)}


def _same_pads(size: int) -> tuple[int, int]:
    """XLA's SAME padding (lo, hi) of one spatial axis for the 4x4 stride-2
    conv: the total is split with the odd pixel at the end."""
    out = -(-size // _S)
    total = max((out - 1) * _S + _K - size, 0)
    return total // 2, total - total // 2


def _conv(params, x):
    """NHWC stride-2 conv with SAME padding: (N, H, W, Cin) -> (N, ceil(H/2),
    ceil(W/2), Cout). Weights and bias cast to the activation dtype at use."""
    (plo, phi), (qlo, qhi) = _same_pads(x.shape[1]), _same_pads(x.shape[2])
    xc = x.permute(0, 3, 1, 2)                       # channels-last view
    if (plo, qlo) != (phi, qhi):
        xc = F.pad(xc, (qlo, qhi, plo, phi))
        pad = [0, 0]
    else:
        pad = [plo, qlo]
    w = params["w"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = _ConvF32.apply(xc, w, pad, False)
    return out.permute(0, 2, 3, 1) + params["b"].to(x.dtype)


def _conv_transpose(params, x):
    """NHWC transposed conv with SAME padding, as ``lax.conv_transpose``
    (no kernel flip, weights HWIO): (N, H, W, Cin) -> (N, 2H, 2W, Cout).
    torch's transposed conv is conv2d's adjoint, so it takes the kernel
    flipped in space and as (in, out, kh, kw); padding 1 is XLA's (2, 2)
    on the stride-dilated input."""
    w = params["w"].to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)
    out = _ConvF32.apply(x.permute(0, 3, 1, 2), w, [1, 1], True)
    return out.permute(0, 2, 3, 1) + params["b"].to(x.dtype)


def conv_encoder_init(image_hw: int, cin: int, h_dim: int,
                      dtype=torch.float32, generator=None):
    c1, c2 = _CONV_CHANNELS
    spatial = image_hw // 4
    return {"conv1": _conv_init(4, 4, cin, c1, dtype, generator),
            "conv2": _conv_init(4, 4, c1, c2, dtype, generator),
            "fc": _linear_init(spatial * spatial * c2, h_dim, dtype,
                               generator)}


def conv_encoder_apply(params, x):
    """x (..., H, W, C) -> features (..., h_dim)."""
    batch = x.shape[:-3]
    x = x.reshape((-1,) + tuple(x.shape[-3:]))
    if _BF16_CONV_ACT and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    h = torch.relu(_conv(params["conv1"], x))
    h = torch.relu(_conv(params["conv2"], h))
    # flattened in (H, W, C) order, the fc weights' row order
    h = h.reshape(h.shape[0], -1).to(params["fc"]["w"].dtype)
    profiling.mark_grad(h, "bwd_encode_conv")
    profiling.mark("encode_fc", h)
    h = torch.relu(_linear(params["fc"], h))
    return h.reshape(batch + (h.shape[-1],))


def conv_decoder_init(z_dim: int, h_dim: int, image_hw: int, cout: int,
                      dtype=torch.float32, generator=None):
    c1, c2 = _CONV_CHANNELS
    spatial = image_hw // 4
    return {"fc1": _linear_init(z_dim, h_dim, dtype, generator),
            "fc2": _linear_init(h_dim, spatial * spatial * c2, dtype,
                                generator),
            "deconv1": _conv_init(4, 4, c2, c1, dtype, generator),
            "deconv2": _conv_init(4, 4, c1, cout, dtype, generator)}


def conv_decoder_apply(params, z):
    """z (..., Z) -> logits (..., H, W, C)."""
    batch = z.shape[:-1]
    z = z.reshape(-1, z.shape[-1])
    h = torch.relu(_linear(params["fc1"], z))
    h = torch.relu(_linear(params["fc2"], h))
    c = _CONV_CHANNELS[1]
    s = math.isqrt(params["fc2"]["w"].shape[1] // c)
    h = h.reshape(-1, s, s, c)
    if _BF16_CONV_ACT and h.dtype == torch.float32:
        h = h.to(torch.bfloat16)
    profiling.mark_grad(h, "bwd_decode_fc")
    profiling.mark("decode_conv", h)
    h = torch.relu(_conv_transpose(params["deconv1"], h))
    logits = _conv_transpose(params["deconv2"], h)
    # logits back at the master dtype for the Bernoulli log-likelihood
    logits = logits.to(params["fc1"]["w"].dtype)
    return logits.reshape(batch + tuple(logits.shape[1:]))
