"""The work of two kernels, counted from shapes, and a launch's least time.
A model family's own counts (a training step's, an IWAE example's) are its
reference module's ``work`` (``reference/__init__.py``).

``D`` data width, ``H`` hidden width, ``Z`` the latent's ambient width,
``B`` the batch, ``S`` a decode launch's samples.

* ``train_decode`` (the fused training decode, B6) and ``decode_bce`` (the
  fused IWAE decode, B2): the forward products 2 B (Z H + H D) (times S),
  and each input byte read once and each output byte written once.
"""
from __future__ import annotations


def train_decode(B: int, Z: int, H: int, D: int) -> dict:
    """B6: z, x, the weights and biases in; the log-likelihood, the hidden
    layer and the logits' gradient out."""
    return {"flops": 2 * B * (Z * H + H * D),
            "bytes": 4 * (B * Z + B * D + Z * H + H + H * D + D + B + B * H
                          + B * D)}


def decode_bce(S: int, B: int, Z: int, H: int, D: int) -> dict:
    """B2: z, x, the weights and biases in; (S, B) log-likelihoods out."""
    return {"flops": 2 * S * B * (Z * H + H * D),
            "bytes": 4 * (S * Z * B + D * B + Z * H + H + H * D + D + S * B)}


def least_time_s(flops: int, nbytes: int, peaks: dict) -> float:
    """The larger of the two bounds: the products at the float32-grade
    tensor rate, the bytes at the memory's rate."""
    return max(flops / (peaks["float32_grade_tflops"] * 1e12),
               nbytes / (peaks["hbm_tbps"] * 1e12))
