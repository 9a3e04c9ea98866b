"""The round-5 model matrix through the port: the 15 configurations trained
to convergence and scored with FULL-test-split IWAE-500 (fixed eval
binarization, averaged over ``--ll_repeats`` passes).

Counterpart of ``scripts/run_r5_matrix.py``, with its configurations,
flags, defaults, statuses and summary. Each (config, seed) row is
appended to ``--out``, or replaces the row of the same (tag, seed), so
separate runs add up into one file; the summary sidecar gives each tag's
mean +/- std over its seeds, with the seed spread flagged past 0.3 nats.
A row keeps what ``mvae_torch.cli.main`` returns (train-only
``train_steps_per_sec`` beside the whole run's ``wall_seconds``, the
kernels it was routed through ``fused_paths``, ``graph_path``, the graph
captures, ``device``) and the card it ran on. Runs on CUDA: without a
card ``main`` raises before any row; nothing falls back to the CPU.

    python -m mvae_torch.matrix                      # all configs, seed 11
    python -m mvae_torch.matrix --seeds 0,7,19,23 \\
        --only e6,h2s2e2-learnK/mnist,u6-learnK-conv
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

from .utils.device import resolve_device

CONFIGS = [
    # (tag, cli args)
    ("e6/mnist", ["--dataset", "mnist", "--model", "e6"]),
    ("h6/mnist", ["--dataset", "mnist", "--model", "h6"]),
    ("d6/mnist", ["--dataset", "mnist", "--model", "d6"]),
    ("s6-vmf/mnist", ["--dataset", "mnist", "--model", "s6"]),
    ("s6-wrapped/mnist", ["--dataset", "mnist", "--model", "s6:wrapped"]),
    ("p6/mnist", ["--dataset", "mnist", "--model", "p6"]),
    ("u6-learnK/mnist", ["--dataset", "mnist", "--model", "u6",
                         "--fixed_curvature", "False"]),
    ("h2s2e2-learnK/mnist", ["--dataset", "mnist", "--model", "h2,s2,e2",
                             "--fixed_curvature", "False"]),
    ("h2s2e2-learnK/omniglot", ["--dataset", "omniglot", "--model",
                                "h2,s2,e2", "--fixed_curvature", "False"]),
    ("d6-riemannian/mnist", ["--dataset", "mnist", "--model",
                             "d6:riemannian"]),
    ("u6-learnK-conv/cifar", ["--dataset", "cifar", "--model", "u6",
                              "--fixed_curvature", "False"]),
    ("h4/bdp", ["--dataset", "bdp", "--model", "h4"]),
    # paper-style product table extensions (multiplier-prefix DSL)
    ("3h2-learnK/mnist", ["--dataset", "mnist", "--model", "3h2",
                          "--fixed_curvature", "False"]),
    ("3s2-learnK/mnist", ["--dataset", "mnist", "--model", "3s2",
                          "--fixed_curvature", "False"]),
    ("d2p2e2-learnK/mnist", ["--dataset", "mnist", "--model", "d2,p2,e2",
                             "--fixed_curvature", "False"]),
]

SEED_SPREAD_FLAG_NATS = 0.3


def finite_or_none(obj):
    """Map non-finite floats to None so the output is valid JSON."""
    if isinstance(obj, dict):
        return {k: finite_or_none(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite_or_none(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def summarize(rows):
    """Per-tag mean +/- std of the headline LL over seeds."""
    by_tag: dict = {}
    for r in rows:
        ll = r.get("test/log_likelihood_iwae")
        if r.get("status") == "OK" and isinstance(ll, float):
            by_tag.setdefault(r["tag"], []).append((r.get("seed"), ll))
    out = {}
    for tag, vals in sorted(by_tag.items()):
        lls = [v for _, v in vals]
        mean = sum(lls) / len(lls)
        std = (sum((v - mean) ** 2 for v in lls) / len(lls)) ** 0.5
        spread = max(lls) - min(lls)
        out[tag] = {
            "n_seeds": len(lls),
            "seeds": [s for s, _ in vals],
            "ll_mean": round(mean, 3),
            "ll_std": round(std, 4),
            "ll_per_seed": [round(v, 3) for v in lls],
            "seed_spread_nats": round(spread, 4),
            "spread_exceeds_0.3": spread > SEED_SPREAD_FLAG_NATS,
        }
    return out


def card(device: str) -> str | None:
    """The card a row ran on: ``nvidia-smi``'s name and power limit (its
    rates depend on both), or the device name where ``nvidia-smi`` is
    absent; None off CUDA."""
    if not device.startswith("cuda"):
        return None
    import torch
    index = torch.device(device).index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        out = None
    if out is not None and out.returncode == 0 and out.stdout.strip():
        return out.stdout.strip()
    return torch.cuda.get_device_name(torch.device(device))


def run_row(tag: str, cli_args: list, seed: int, args, extra=(),
            run_root: str = "runs/torch_matrix") -> dict:
    """One (config, seed) row: ``cli.main`` at the matrix's settings
    (``args``: epochs, batch_size, ll_repeats, eval_binarize; burn-in 10,
    IWAE-500), then ``extra`` CLI args, into ``<run_root>/<tag>_s<seed>``.
    Status ``OK``, ``NAN`` (a non-finite LL), ``FAILED_NONFINITE`` (the
    trainer's non-finite guard) or ``FAIL <Type>``; non-finite numbers
    written as None."""
    from .cli import main as cli_main
    from .train import NonFiniteError

    run_dir = f"{run_root}/{tag.replace('/', '_')}_s{seed}"
    full = list(cli_args) + [
        "--epochs", str(args.epochs), "--batch_size", str(args.batch_size),
        "--burnin", "10", "--seed", str(seed), "--likelihood_n", "500",
        "--run_dir", run_dir, "--ll_repeats", str(args.ll_repeats),
        "--eval_binarize", args.eval_binarize, *extra,
    ]
    t0 = time.time()
    try:
        result = {k: v for k, v in cli_main(full).items() if k != "history"}
        ll = result.get("test/log_likelihood_iwae")
        status = "OK" if (isinstance(ll, float)
                          and math.isfinite(ll)) else "NAN"
        result.update(tag=tag, seed=seed, wall_s=round(time.time() - t0, 1),
                      status=status, card=card(result["device"]))
        fp = result.get("fused_paths") or {}
        result["routing_policy"] = fp.get("routing_policy", "unknown")
    except NonFiniteError as e:
        result = {"tag": tag, "seed": seed, "status": "FAILED_NONFINITE",
                  "nonfinite_epoch": e.epoch,
                  "last_finite_step": e.last_finite_step,
                  "error": str(e)[:300],
                  "wall_s": round(time.time() - t0, 1)}
    except Exception as e:  # keep the matrix going
        traceback.print_exc()
        result = {"tag": tag, "seed": seed,
                  "status": f"FAIL {type(e).__name__}",
                  "error": str(e)[:300],
                  "wall_s": round(time.time() - t0, 1)}
    return finite_or_none(result)


def save(rows: list, out: Path, summary_out: Path) -> None:
    """Write the rows and their per-tag summary."""
    out.write_text(json.dumps(rows, indent=1, allow_nan=False))
    summary_out.write_text(json.dumps(summarize(rows), indent=1,
                                      allow_nan=False))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m mvae_torch.matrix")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--out", default="RESULTS_torch_matrix.json")
    ap.add_argument("--summary_out", default=None,
                    help="default: <out stem>_summary.json")
    ap.add_argument("--ll_repeats", type=int, default=2)
    ap.add_argument("--eval_binarize", default="fixed")
    ap.add_argument("--seeds", default="11",
                    help="comma-separated seeds; one row per (config, seed)")
    ap.add_argument("--only", default=None,
                    help="comma-separated tag substrings: run just these "
                         "configs (existing non-matching rows in --out are "
                         "kept; matching (tag, seed) rows are replaced)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device()  # the rows run on CUDA: without a card, raise here
    seeds = [int(s) for s in args.seeds.split(",")]
    configs = CONFIGS
    if args.only:
        pats = args.only.split(",")
        configs = [(t, a) for t, a in CONFIGS if any(p in t for p in pats)]
    todo = {(t, s) for t, _ in configs for s in seeds}
    out = Path(args.out)
    rows = []
    if out.exists():
        rows = [r for r in json.loads(out.read_text())
                if (r.get("tag"), r.get("seed")) not in todo]
    summary_out = Path(args.summary_out
                       or out.with_name(out.stem + "_summary.json"))

    for seed in seeds:
        for tag, cli_args in configs:
            row = run_row(tag, cli_args, seed, args)
            print(json.dumps(row), flush=True)
            rows.append(row)
            save(rows, out, summary_out)
            gc.collect()  # the row's trainer and its graphs' memory

    n_ok = sum(r.get("status") == "OK" for r in rows)
    print(f"wrote {out}: {n_ok}/{len(rows)} rows OK; summary -> "
          f"{summary_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
