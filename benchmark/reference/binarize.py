"""The pinned evaluation binarization, written again: pixel j of example i is
1 where a counter hash of (seed, i, j) falls below its intensity. The hash
is a 32-bit integer finalizer (multiply-xorshift), its top 24 bits a
uniform on [0, 1); the seed is the run's seed xored with 0xB1A."""
from __future__ import annotations

import torch

SALT = 0xB1A
_M32 = 0xFFFFFFFF


def _mix(x):
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def fixed(seed: int, rows, x):
    """Binary (len(rows), D) from intensities x (len(rows), D) of the
    examples ``rows`` (int64)."""
    cols = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    h = _mix(torch.full_like(rows, SALT ^ seed, dtype=torch.int64))
    h = _mix(h + rows.to(torch.int64))
    h = _mix(h[:, None] + cols[None, :])
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return (u < x.to(torch.float32)).to(x.dtype)
