"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no GPU and no explicit request this raises instead of running on
    the CPU: the CPU runs the kernels' plain PyTorch versions, which a
    caller must ask for (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mvae_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")
