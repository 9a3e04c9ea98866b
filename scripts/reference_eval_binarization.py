"""The reference's own pinned test binarization, for the port to evaluate
its weights on (queue C, C8).

The round-5 matrix scores every row on a fixed binarization of the test
split (``eval_binarize="fixed"``). The two packages pin different ones:
the reference keys row i by ``fold_in(key(0xB1A ^ seed), i)``, the port by
a counter hash of (0xB1A ^ seed, i). This runs the reference on the CPU and
writes its bits: for each seed a reference ``Trainer`` at the matrix's
settings, its ``_eval_keys`` for the test split at its eval batch, and
``data.base.binarize_rows`` on each batch -- the calls its IWAE pass makes
(``make_eval_ll``'s first line), nothing re-implemented. The binarization
depends on the seed and the example index only, so one configuration's
trainer serves every row of that seed.

Writes ``results/reference_eval_binarization.npz`` (compressed): for each
seed ``bits_s<seed>``, ``np.packbits`` of the (N, D) 0/1 test split along
its rows, with ``seeds``, ``shape`` and ``test_sha256``, the sha256 of the
float32 test intensities it binarized (the port's loader must give the same
split). ``scripts/torch_c8_binarization.py`` reads it on the card.

    JAX_PLATFORMS=cpu python scripts/reference_eval_binarization.py
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEEDS = (11, 0, 7, 19, 23)
OUT = ROOT / "results" / "reference_eval_binarization.npz"


def test_sha256(test: np.ndarray) -> str:
    """sha256 of the test split as float32 bytes, C order."""
    return hashlib.sha256(
        np.ascontiguousarray(test, np.float32).tobytes()).hexdigest()


def reference_bits(seed: int, dataset, run_dir: str) -> np.ndarray:
    """The reference trainer's fixed binarization of ``dataset.test`` at
    ``seed``: (N, D) uint8 0/1, rows in the split's order."""
    import jax
    import jax.numpy as jnp

    from mvae_tpu.components import parse_components
    from mvae_tpu.data.base import binarize_rows
    from mvae_tpu.models import VAEConfig
    from mvae_tpu.train import TrainConfig, Trainer

    cfg = VAEConfig(components=parse_components("h2,s2,e2",
                                                fixed_curvature=False),
                    data_shape=dataset.data_shape, arch="mlp", h_dim=400)
    tc = TrainConfig(batch_size=256, burnin_epochs=10, seed=seed,
                     likelihood_n=500, eval_binarize="fixed")
    tr = Trainer(cfg, dataset, tc, run_dir)
    data = tr._test_data
    bs = min(tc.eval_batch_size, len(data))
    batches, _, n = tr._split_batches(data, bs)
    k_bins, _ = tr._eval_keys(batches.shape[0], bs)
    binarize = jax.jit(binarize_rows, static_argnums=2)
    rows = [np.asarray(binarize(k_bins[i], batches[i], dataset.binarize))
            for i in range(batches.shape[0])]
    bits = np.concatenate(rows)[:n].reshape(n, -1)
    if not np.isin(bits, (0.0, 1.0)).all():
        raise RuntimeError("the reference's binarization is not 0/1")
    return bits.astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)

    from mvae_tpu.data.loaders import load_dataset

    ds = load_dataset("mnist")
    seeds = [int(s) for s in args.seeds.split(",")]
    test = np.asarray(ds.test, np.float32).reshape(len(ds.test), -1)
    out = {"seeds": np.asarray(seeds), "shape": np.asarray(test.shape),
           "test_sha256": np.asarray(test_sha256(ds.test)),
           "synthetic": np.asarray(ds.synthetic)}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in seeds:
            bits = reference_bits(seed, ds, f"{tmp}/s{seed}")
            out[f"bits_s{seed}"] = np.packbits(bits, axis=1)
            print(f"seed {seed}: {bits.shape} bits, mean "
                  f"{bits.mean():.5f} (intensity mean {test.mean():.5f})")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({Path(args.out).stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
