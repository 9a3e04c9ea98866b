"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Nothing is compiled at import; ``_build`` compiles ``csrc/*.cu`` at first
use on a machine with ``nvcc``.
"""
from .decoder_kernels import fused_decode_bce_t, train_decode_bce
from .manifold_kernels import (lorentz_distance, stereo_distance,
                               wrapped_reparam_stereo_t)

__all__ = ["stereo_distance", "lorentz_distance", "wrapped_reparam_stereo_t",
           "fused_decode_bce_t", "train_decode_bce"]
