"""The work of a step, an IWAE pass and two kernels, counted from shapes.

``D`` data width, ``H`` hidden width, ``W`` the fused head's width (every
factor's mean and scale heads), ``Z`` the latent's ambient width, ``B`` the
batch, ``n`` the importance samples, ``S`` a decode launch's samples.

* ``train_step``: the MLP VAE's matrix products a training step executes,
  in multiply-adds: the forward products (encoder D x H, heads H x W,
  decoder Z x H and H x D) three times a row (forward, input gradient,
  weight gradient) less the encoder's input gradient, which nothing
  needs. Bytes, float32 words: 8 a parameter for Adam (p, g, m, v read; p,
  m, v written; g written by autograd first) and 2 B (2 D + H) for the
  activations each written once and read once.
* ``iwae_example``: an example's IWAE-n forward products: encoder and heads
  once, the decoder's two products n times.
* ``train_decode`` (the fused training decode, B6) and ``decode_bce`` (the
  fused IWAE decode, B2): the forward products 2 B (Z H + H D) (times S),
  and each input byte read once and each output byte written once.
"""
from __future__ import annotations


def train_step(D: int, H: int, W: int, Z: int, B: int, n_params: int) -> dict:
    macs = 3 * B * (D * H + H * W + Z * H + H * D)
    return {"gemm_macs": macs, "executed_macs": macs - B * D * H,
            "bytes": 4 * (8 * n_params + 2 * B * (2 * D + H))}


def iwae_example_flops(D: int, H: int, W: int, Z: int, n: int) -> int:
    return 2 * (D * H + H * W + n * (Z * H + H * D))


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
