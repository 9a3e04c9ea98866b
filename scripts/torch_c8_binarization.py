"""C8 on the card: how much of the port's IWAE-500 offset from the reference
comes from the two packages' pinned test binarizations.

The port's 5-seed IWAE-500 means sit above the reference's on 14 of 15
matrix configurations (+0.07 to +0.20 nats on the MLP rows). Both packages
score every configuration of a seed on one fixed binarization of the test
split, but not the same one: the reference keys row i by ``fold_in(key(0xB1A
^ seed), i)``, the port by a counter hash of (0xB1A ^ seed, i). This script
trains the flagship (``h2s2e2-learnK/mnist``) and ``e6/mnist`` rows at the
matrix's settings (``mvae_torch.matrix.run_row``: 100 epochs, batch 256,
burn-in 10, IWAE-500 over the full test split x 2 passes, fixed
binarization), then evaluates each row's final weights with IWAE-500 (x 2
passes) twice from the same generator state -- the same importance draws --
on the port's binarization and on the reference's
(``results/reference_eval_binarization.npz``, written on the CPU by
``scripts/reference_eval_binarization.py``). The reference's bits go in as
intensities: the port's binarization passes a 0/1 image through unchanged
(its uniforms lie in [0, 1)).

Writes ``results/torch_c8_binarization.json``: per row the matrix row's LL,
the two evaluations and their difference; per configuration the port's
offset from the reference's matrix mean (``RESULTS_r5_matrix.json``) on
each binarization, and the share of the offset the binarization explains.

    python scripts/torch_c8_binarization.py [--seeds 11,0,7,19,23]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TAGS = ("h2s2e2-learnK/mnist", "e6/mnist")
BITS = ROOT / "results" / "reference_eval_binarization.npz"
REFERENCE = ROOT / "RESULTS_r5_matrix.json"
OUT = ROOT / "results" / "torch_c8_binarization.json"


def reference_lls(tags) -> dict:
    """(tag, seed) -> the reference's matrix LL."""
    rows = json.loads(REFERENCE.read_text())
    return {(r["tag"], r["seed"]): r["test/log_likelihood_iwae"]
            for r in rows if r.get("tag") in tags and r.get("status") == "OK"}


def reference_bits(bits, seed: int) -> np.ndarray:
    """The reference's (N, D) 0/1 test split at ``seed``, float32."""
    n, d = (int(v) for v in bits["shape"])
    return np.unpackbits(bits[f"bits_s{seed}"], axis=1,
                         count=d).astype(np.float32)


def evaluate_both(trainer, ref_test, repeats: int) -> tuple[float, float]:
    """IWAE-500 of the trainer's weights over the test split on the port's
    binarization, then on the reference's bits, each ``repeats`` passes
    from the same generator state (the same importance draws)."""
    import torch
    state = trainer.generator.get_state()
    ll_port = trainer.evaluate_log_likelihood("test", repeats=repeats)
    own = trainer._test_data
    trainer.generator.set_state(state)
    trainer._test_data = torch.as_tensor(
        ref_test, device=own.device).reshape(own.shape)
    try:
        ll_ref = trainer.evaluate_log_likelihood("test", repeats=repeats)
    finally:
        trainer._test_data = own
    return ll_port, ll_ref


def summarize(rows: list, ref: dict) -> dict:
    """Per configuration: the port's offset from the reference's 5-seed
    mean on each binarization, the binarization's shift (port minus
    reference bits), and the share of the offset that shift explains."""
    out = {}
    for tag in TAGS:
        rs = [r for r in rows if r["tag"] == tag and r["status"] == "OK"]
        if not rs:
            continue
        ref_mean = float(np.mean([ref[(tag, r["seed"])] for r in rs]))
        port_row = float(np.mean([r["row_ll"] for r in rs]))
        port_bin = float(np.mean([r["ll_port_binarization"] for r in rs]))
        ref_bin = float(np.mean([r["ll_reference_binarization"] for r in rs]))
        shift = [r["ll_port_binarization"] - r["ll_reference_binarization"]
                 for r in rs]
        offset = port_bin - ref_mean
        out[tag] = {
            "seeds": [r["seed"] for r in rs],
            "reference_matrix_mean": ref_mean,
            "port_row_mean": port_row,
            "offset_row": port_row - ref_mean,
            "offset_port_binarization": offset,
            "offset_reference_binarization": ref_bin - ref_mean,
            "binarization_shift_mean": float(np.mean(shift)),
            "binarization_shift_per_seed": shift,
            "binarization_shift_std": float(np.std(shift)),
            "share_of_offset_explained": (float(np.mean(shift)) / offset
                                          if offset else None),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="11,0,7,19,23")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--ll_repeats", type=int, default=2)
    ap.add_argument("--run_root", default="runs/torch_c8")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)

    import torch

    from mvae_torch import cli, matrix
    from mvae_torch.data import load_dataset
    sys.path.insert(0, str(ROOT / "scripts"))
    from reference_eval_binarization import test_sha256

    if not torch.cuda.is_available():
        raise SystemExit("torch_c8_binarization.py trains on a CUDA card")
    bits = np.load(BITS)
    ds = load_dataset("mnist")
    sha = test_sha256(ds.test)
    if sha != str(bits["test_sha256"]):
        raise SystemExit(f"the port's MNIST test split ({sha}) is not the one "
                         f"the reference binarized ({bits['test_sha256']})")
    ref = reference_lls(TAGS)
    seeds = [int(s) for s in args.seeds.split(",")]
    configs = dict(matrix.CONFIGS)
    settings = argparse.Namespace(epochs=args.epochs, batch_size=256,
                                  ll_repeats=args.ll_repeats,
                                  eval_binarize="fixed")
    rows = []
    t_all = time.time()
    for seed in seeds:
        ref_test = reference_bits(bits, seed)
        for tag in TAGS:
            t0 = time.time()
            row = matrix.run_row(tag, configs[tag], seed, settings,
                                 run_root=args.run_root)
            out = {"tag": tag, "seed": seed, "status": row["status"],
                   "row_ll": row.get("test/log_likelihood_iwae"),
                   "reference_ll": ref.get((tag, seed)),
                   "card": row.get("card"),
                   "train_steps_per_sec": row.get("train_steps_per_sec")}
            if row["status"] == "OK":
                run_dir = f"{args.run_root}/{tag.replace('/', '_')}_s{seed}"
                flags = cli.build_parser().parse_args(configs[tag] + [
                    "--batch_size", "256", "--burnin", "10", "--seed",
                    str(seed), "--likelihood_n", "500", "--run_dir", run_dir,
                    "--eval_binarize", "fixed"])
                trainer = cli.build_trainer(flags)
                trainer.restore_checkpoint()
                ll_port, ll_ref = evaluate_both(trainer, ref_test,
                                                args.ll_repeats)
                out.update(ll_port_binarization=ll_port,
                           ll_reference_binarization=ll_ref,
                           shift=ll_port - ll_ref, step=trainer.step)
                del trainer
                gc.collect()  # the trainer's graphs and their memory
            out["seconds"] = round(time.time() - t0, 1)
            print(json.dumps(out), flush=True)
            rows.append(out)
    summary = summarize(rows, ref)
    result = {"rows": rows, "summary": summary,
              "card": rows[0].get("card") if rows else None,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "seconds": round(time.time() - t_all, 1),
              "settings": vars(args)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1, allow_nan=False))
    print(json.dumps(summary, indent=1))
    print(f"wrote {args.out}")
    return 0 if all(r["status"] == "OK" for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
