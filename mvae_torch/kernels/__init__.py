"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Nothing is compiled at import; ``_build`` compiles ``csrc/*.cu`` at first
use on a machine with ``nvcc``.
"""
