"""Load parameters of the JAX package into the port.

The reference keeps its parameters as a pytree of arrays:
``{"encoder": {"layers": (...)}, "decoder": {"layers": (...), "out": ...},
"components": ({w_mu, b_mu, w_sig, b_sig, c_param}, ...)}`` for the MLP
VAE, and ``{"encoder": {conv1, conv2, fc}, "decoder": {fc1, fc2, deconv1,
deconv2}, ...}`` for the conv VAE. The port uses the same structure of
dicts and tuples with torch tensors, and the same layouts ((in, out) linear
weights, HWIO conv weights), so conversion is leaf by leaf through numpy
and checkpoints are interchangeable.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device=None):
    """The port's params from the reference's pytree, on ``device``; leaves
    are anything ``np.asarray`` accepts (numpy arrays, or device arrays
    converted by the caller). Dtypes are kept."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_jax(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)
