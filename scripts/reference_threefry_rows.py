"""Round-5 matrix rows of the reference under ``--train_rng threefry``.

The reference's matrix (``scripts/run_r5_matrix.py``) trains with its
default ``rbg`` stream. This runs the same rows with the same arguments
(100 epochs, batch 256, burn-in 10, full-split IWAE-500 x 2 passes, fixed
eval binarization) but with the training noise drawn from ``threefry``, so
the two streams can be held against each other and against the port.
Run directories go under ``--run_root`` (``runs/r5_threefry_u6/`` by
default; ``runs/r5_matrix/`` stays untouched); rows are patched by
(tag, seed) into ``--out`` under a lock on it, so several processes may
share one output file, and the summary (``run_r5_matrix.summarize``) is
rewritten beside it after every row.

    JAX_PLATFORMS=cpu python scripts/reference_threefry_rows.py \
        --seeds 11,0,7,19,23 --only u6-learnK/mnist
    python scripts/torch_matrix_compare.py \
        --ref RESULTS_r5_u6_threefry_summary.json
"""
from __future__ import annotations

import argparse
import fcntl
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from run_r5_matrix import CONFIGS, finite_or_none, summarize  # noqa: E402


def _patch(out: Path, summary_out: Path, row: dict) -> None:
    """Replace (tag, seed)'s row of ``out`` by ``row`` and rewrite the
    summary, holding a lock on ``out`` for the read and both writes."""
    with open(out, "a+") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        text = out.read_text()
        rows = json.loads(text) if text.strip() else []
        rows = [r for r in rows
                if (r.get("tag"), r.get("seed")) != (row["tag"], row["seed"])]
        rows.append(row)
        out.write_text(json.dumps(rows, indent=1, allow_nan=False))
        summary_out.write_text(
            json.dumps(summarize(rows), indent=1, allow_nan=False))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--ll_repeats", type=int, default=2)
    ap.add_argument("--seeds", default="11,0,7,19,23")
    ap.add_argument("--only", default="u6-learnK/mnist",
                    help="comma-separated tag substrings of run_r5_matrix's "
                         "CONFIGS")
    ap.add_argument("--out", default=str(ROOT / "RESULTS_r5_u6_threefry.json"))
    ap.add_argument("--run_root", default="runs/r5_threefry_u6")
    args = ap.parse_args(argv)

    from mvae_tpu.cli import main as cli_main
    from mvae_tpu.train.trainer import NonFiniteError

    out = Path(args.out)
    summary_out = out.with_name(out.stem + "_summary.json")
    pats = args.only.split(",")
    configs = [(t, a) for t, a in CONFIGS if any(p in t for p in pats)]
    for seed in (int(s) for s in args.seeds.split(",")):
        for tag, cli_args in configs:
            run_dir = f"{args.run_root}/{tag.replace('/', '_')}_s{seed}"
            full = cli_args + [
                "--epochs", str(args.epochs), "--batch_size",
                str(args.batch_size), "--burnin", "10", "--seed", str(seed),
                "--likelihood_n", "500", "--run_dir", run_dir,
                "--ll_repeats", str(args.ll_repeats),
                "--eval_binarize", "fixed", "--train_rng", "threefry",
            ]
            t0 = time.time()
            try:
                result = {k: v for k, v in cli_main(full).items()
                          if k != "history"}
                ll = result.get("test/log_likelihood_iwae")
                ok = isinstance(ll, float) and math.isfinite(ll)
                result["status"] = "OK" if ok else "NAN"
            except NonFiniteError as e:
                result = {"status": "FAILED_NONFINITE",
                          "nonfinite_epoch": e.epoch,
                          "last_finite_step": e.last_finite_step,
                          "error": str(e)[:300]}
            result.update(tag=tag, seed=seed, train_rng="threefry",
                          wall_s=round(time.time() - t0, 1))
            result = finite_or_none(result)
            print(json.dumps(result), flush=True)
            _patch(out, summary_out, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
