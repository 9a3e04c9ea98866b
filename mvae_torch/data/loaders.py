"""Dataset loaders: MNIST, Omniglot, CIFAR-10, BDP (L6).

A numpy copy of ``mvae_tpu/data/loaders.py`` (the port imports nothing of
the JAX package). Loaders read standard local formats and fall back to the
same DETERMINISTIC procedural data (flagged ``synthetic=True`` and loudly
warned), so the compute path runs everywhere; marginal-LL comparisons
against the paper require pointing MVAE_DATA_DIR at real data.

Search order for real files: $MVAE_DATA_DIR, then ./data.

  MNIST:    IDX files train-images-idx3-ubyte[.gz] etc., or mnist.npz
            (keras layout: x_train/x_test).
  Omniglot: omniglot.npz with train/test arrays (28x28), or chardata.mat.
  CIFAR:    cifar-10-batches-py/ pickled batches.
  BDP:      always generated (synthetic by definition, as in the reference):
            a binary diffusion process over a binary tree — root uniform
            random bits, children flip each bit with small probability;
            observations are the tree nodes.
"""
from __future__ import annotations

import gzip
import os
import pickle
import sys
import warnings
import zlib
from pathlib import Path

import numpy as np

from .base import ArrayDataset


def _search_dirs():
    dirs = []
    if os.environ.get("MVAE_DATA_DIR"):
        dirs.append(Path(os.environ["MVAE_DATA_DIR"]))
    dirs.append(Path("data"))
    return dirs


def _find(*names):
    for d in _search_dirs():
        for n in names:
            p = d / n
            if p.exists():
                return p
    return None


def _warn_synthetic(name: str):
    warnings.warn(
        f"{name}: no local data files found and no network access — using a "
        f"DETERMINISTIC SYNTHETIC stand-in. Throughput/training paths are "
        f"exact; likelihood values are not comparable to the paper. Point "
        f"MVAE_DATA_DIR at real data for LL reproduction.", stacklevel=3)
    print(f"[mvae-torch] WARNING: synthetic {name} fallback in use",
          file=sys.stderr)


def _read_idx(path: Path) -> np.ndarray:
    """IDX(.gz) -> uint8 array."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    ndim = magic & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i:8 + 4 * i], "big")
            for i in range(ndim)]
    return np.frombuffer(data, np.uint8,
                         offset=4 + 4 * ndim).reshape(dims)


def _synthetic_images(name: str, n_train: int, n_test: int, hw: int,
                      channels: int, n_classes: int = 10) -> tuple:
    """Procedural class-template images: seeded smooth blobs + noise,
    squashed to [0, 1]. Deterministic across runs."""
    # zlib.crc32, not hash(): str hashing is randomized per process, which
    # would make the "deterministic" stand-ins differ run to run
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64) / hw

    templates = []
    for _ in range(n_classes):
        t = np.zeros((hw, hw, channels))
        for _blob in range(4):
            cx, cy = rng.uniform(0.2, 0.8, 2)
            sx, sy = rng.uniform(0.05, 0.2, 2)
            amp = rng.uniform(0.5, 1.5)
            blob = amp * np.exp(-((xx - cx) ** 2 / (2 * sx ** 2)
                                  + (yy - cy) ** 2 / (2 * sy ** 2)))
            t += blob[..., None] * rng.uniform(0.3, 1.0, channels)
        templates.append(t)
    template_arr = np.asarray(templates, np.float32)  # (C, hw, hw, ch)

    def draw(n):
        # f32 end-to-end and vectorized gather: the f64 version allocated
        # multi-GB temporaries for CIFAR-size splits (minutes of startup)
        cls = rng.integers(0, n_classes, n)
        img = template_arr[cls]
        img = img * (0.7 + 0.6 * rng.random((n, 1, 1, 1), dtype=np.float32))
        img += 0.15 * rng.standard_normal(img.shape, dtype=np.float32)
        np.clip(img, 0.0, None, out=img)
        img /= img.max(axis=(1, 2, 3), keepdims=True) + 1e-9
        return img

    return draw(n_train), draw(n_test)


def load_mnist() -> ArrayDataset:
    # IDX layout
    tr_im = _find("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz",
                  "MNIST/raw/train-images-idx3-ubyte")
    te_im = _find("t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz",
                  "MNIST/raw/t10k-images-idx3-ubyte")
    if tr_im is not None and te_im is not None:
        train = _read_idx(tr_im).astype(np.float32) / 255.0
        test = _read_idx(te_im).astype(np.float32) / 255.0
        return ArrayDataset("mnist", train.reshape(-1, 28, 28),
                            test.reshape(-1, 28, 28), (28, 28), True)
    npz = _find("mnist.npz")
    if npz is not None:
        with np.load(npz) as d:
            train = d["x_train"].astype(np.float32) / 255.0
            test = d["x_test"].astype(np.float32) / 255.0
        return ArrayDataset("mnist", train, test, (28, 28), True)
    _warn_synthetic("mnist")
    tr, te = _synthetic_images("mnist", 60_000, 10_000, 28, 1)
    return ArrayDataset("mnist", tr[..., 0], te[..., 0], (28, 28), True,
                        synthetic=True)


def load_omniglot() -> ArrayDataset:
    npz = _find("omniglot.npz")
    if npz is not None:
        with np.load(npz) as d:
            train = d["train"].astype(np.float32)
            test = d["test"].astype(np.float32)
        if train.max() > 1.5:
            train, test = train / 255.0, test / 255.0
        return ArrayDataset("omniglot", train.reshape(-1, 28, 28),
                            test.reshape(-1, 28, 28), (28, 28), True)
    mat = _find("chardata.mat")
    if mat is not None:
        from scipy.io import loadmat
        d = loadmat(str(mat))
        train = d["data"].T.astype(np.float32).reshape(-1, 28, 28)
        test = d["testdata"].T.astype(np.float32).reshape(-1, 28, 28)
        return ArrayDataset("omniglot", train, test, (28, 28), True)
    _warn_synthetic("omniglot")
    tr, te = _synthetic_images("omniglot", 24_345, 8_070, 28, 1,
                               n_classes=50)
    return ArrayDataset("omniglot", tr[..., 0], te[..., 0], (28, 28), True,
                        synthetic=True)


def load_cifar() -> ArrayDataset:
    batch_dir = None
    for d in _search_dirs():
        p = d / "cifar-10-batches-py"
        if p.exists():
            batch_dir = p
            break
    if batch_dir is not None:
        def read_batches(names):
            arrs = []
            for n in names:
                with open(batch_dir / n, "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                arrs.append(np.asarray(d[b"data"], np.uint8))
            a = np.concatenate(arrs).reshape(-1, 3, 32, 32)
            return (a.transpose(0, 2, 3, 1).astype(np.float32) / 255.0)
        train = read_batches([f"data_batch_{i}" for i in range(1, 6)])
        test = read_batches(["test_batch"])
        return ArrayDataset("cifar", train, test, (32, 32, 3), False)
    _warn_synthetic("cifar")
    tr, te = _synthetic_images("cifar", 50_000, 10_000, 32, 3)
    return ArrayDataset("cifar", tr, te, (32, 32, 3), False, synthetic=True)


def generate_bdp(dim: int = 50, depth: int = 8, flip_prob: float = 0.05,
                 seed: int = 7) -> ArrayDataset:
    """Binary diffusion process over a binary tree (synthetic by design).

    Root ~ Bernoulli(0.5)^dim; each of two children flips every bit of its
    parent independently with ``flip_prob``; all 2^{depth+1}-1 nodes are
    observations (noisily re-sampled once more as the observation model).
    """
    rng = np.random.default_rng(seed)
    nodes = [rng.integers(0, 2, (1, dim), dtype=np.uint8)]
    level = nodes[0]
    for _ in range(depth):
        children = np.repeat(level, 2, axis=0)
        flips = rng.random(children.shape) < flip_prob
        level = children ^ flips.astype(np.uint8)
        nodes.append(level)
    all_nodes = np.concatenate(nodes).astype(np.float32)
    obs_flips = rng.random(all_nodes.shape) < flip_prob
    obs = np.abs(all_nodes - obs_flips.astype(np.float32))
    rng.shuffle(obs)
    n_test = max(1, len(obs) // 10)
    return ArrayDataset("bdp", obs[n_test:], obs[:n_test], (dim,), False)


LOADERS = {
    "mnist": load_mnist,
    "omniglot": load_omniglot,
    "cifar": load_cifar,
    "bdp": generate_bdp,
}


def load_dataset(name: str) -> ArrayDataset:
    if name not in LOADERS:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(LOADERS)}")
    return LOADERS[name]()
