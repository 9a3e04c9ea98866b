"""mvae-torch: mixed-curvature VAEs on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of the JAX package ``mvae_tpu``, kept beside it with the
same module layout and function names. It imports torch, numpy and the
standard library only. Entry points run on CUDA unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

__version__ = "0.1.0"

from . import components, data, distributions, models, ops, train
from .components import Component, parse_components
from .models import VAEConfig
from .ops import Manifold
from .train import TrainConfig, Trainer

__all__ = [
    "__version__", "ops", "distributions", "components", "models", "train",
    "data", "Manifold", "Component", "parse_components", "VAEConfig",
    "TrainConfig", "Trainer",
]
