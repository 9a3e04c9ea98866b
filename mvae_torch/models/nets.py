"""MLP encoder/decoder networks as init/apply functions on dicts of tensors.

Counterpart of the MLP half of ``mvae_tpu/models/nets.py`` (ReLU stacks,
hidden size ~400). Weights are stored (in, out), as in the reference, so
parameters convert leaf by leaf. The conv nets belong to a later slice.
"""
from __future__ import annotations

import math

import torch


def _linear_init(in_dim: int, out_dim: int, dtype, generator=None):
    scale = math.sqrt(2.0 / in_dim)  # He init for ReLU stacks
    return {
        "w": scale * torch.randn((in_dim, out_dim), generator=generator,
                                 dtype=dtype),
        "b": torch.zeros((out_dim,), dtype=dtype),
    }


def _linear(params, x):
    return x @ params["w"] + params["b"]


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
