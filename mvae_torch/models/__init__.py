"""Models (L4): MLP nets and the mixed-curvature VAE."""
from . import nets, vae
from .vae import VAEConfig

__all__ = ["nets", "vae", "VAEConfig"]
