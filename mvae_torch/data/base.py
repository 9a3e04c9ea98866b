"""Dataset abstraction (L6).

Counterpart of ``mvae_tpu/data/base.py``: each dataset exposes train/test
arrays of intensities in [0, 1], the input shape, and whether pixels are
dynamically binarized (resampled as Bernoulli(intensity) at every use).
Binarization runs on the device, in torch: from a ``torch.Generator`` for
fresh draws, or from a counter-based hash for the pinned evaluation mode,
which is a pure function of (seed, example index, pixel) and so does not
depend on the batch size or the device.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset of real-valued intensities in [0, 1]."""

    name: str
    train: np.ndarray           # (N_train, *data_shape) float32 in [0,1]
    test: np.ndarray            # (N_test, *data_shape)
    data_shape: tuple[int, ...]
    binarize: bool              # dynamic binarization on?
    likelihood: str = "bernoulli"
    synthetic: bool = False     # True when a procedural fallback was used

    @property
    def in_dim(self) -> int:
        out = 1
        for s in self.data_shape:
            out *= s
        return out

    def epoch_batches(self, epoch: int, batch_size: int,
                      split: str = "train") -> Iterator[np.ndarray]:
        """Shuffled full batches (remainder dropped): the native host-data
        engine's permutation and gather when it is available (``native``,
        built from ``native/host_data.cc`` at first use), numpy's otherwise,
        as the reference chooses."""
        from . import native
        data = self.train if split == "train" else self.test
        # stable across processes (str hash() is per-process randomized)
        seed = zlib.crc32(f"{self.name}/{split}/{epoch}".encode())
        n_full = len(data) // batch_size
        if native.available():
            idx = native.permutation(seed, len(data))
            for b in range(n_full):
                yield native.gather_rows(
                    data, idx[b * batch_size:(b + 1) * batch_size])
            return
        idx = np.random.default_rng(seed).permutation(len(data))
        for b in range(n_full):
            yield data[idx[b * batch_size:(b + 1) * batch_size]]

    def eval_batches(self, batch_size: int,
                     split: str = "test") -> Iterator[np.ndarray]:
        """Deterministic order, remainder kept (padded by caller if needed)."""
        data = self.train if split == "train" else self.test
        for b in range(0, len(data), batch_size):
            yield data[b:b + batch_size]


def binarize_batch(batch, enabled: bool, generator=None, u=None):
    """Dynamic binarization: x ~ Bernoulli(intensity), fresh every call.
    ``u`` gives the uniforms (batch's shape); drawn from ``generator``
    when not given."""
    if not enabled:
        return batch
    if u is None:
        u = torch.rand(batch.shape, generator=generator, dtype=batch.dtype,
                       device=batch.device)
    return (u < batch).to(batch.dtype)


_MASK32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit integer finalizer on int64 tensors (multipliers < 2^31, so
    no product leaves the int64 range)."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _MASK32
    return x ^ (x >> 16)


def hashed_uniform(seed: int, row_ids, n_cols: int):
    """(len(row_ids), n_cols) float32 in [0, 1) that depend only on
    (seed, row id, column) -- identical on every device and batching."""
    cols = torch.arange(n_cols, dtype=torch.int64, device=row_ids.device)
    h = _mix32(torch.full_like(row_ids, seed, dtype=torch.int64))
    h = _mix32(h + row_ids.to(torch.int64))
    h = _mix32(h[:, None] + cols[None, :])
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def binarize_rows(seed: int, row_ids, batch, enabled: bool):
    """Pinned per-row binarization: row i of ``batch`` is example
    ``row_ids[i]``, and its pixels are a pure function of (seed, example
    index), independent of the eval batch size."""
    if not enabled:
        return batch
    flat = batch.reshape(batch.shape[0], -1)
    u = hashed_uniform(seed, row_ids, flat.shape[1]).to(batch.dtype)
    return (u < flat).to(batch.dtype).reshape(batch.shape)


def to_device_dataset(ds: ArrayDataset, device, dtype=torch.float32):
    """Both splits on the device once; returns (train, test) tensors."""
    return (torch.as_tensor(ds.train, dtype=dtype, device=device),
            torch.as_tensor(ds.test, dtype=dtype, device=device))
