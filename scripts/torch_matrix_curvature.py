"""The curvature trajectories of the port's matrix runs, from their
``metrics.jsonl`` (``python -m mvae_torch.matrix`` writes one per run under
``runs/torch_matrix/<tag>_s<seed>/``).

Prints a Markdown table with one row a (run, component) whose curvature
moved: K after the first and the last epoch, its least and largest value,
and whether and after which epoch it crossed zero (a universal ``u``
component may cross from one sign to the other).

    python scripts/torch_matrix_curvature.py
    python scripts/torch_matrix_curvature.py --run_root runs/torch_matrix
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def trajectories(metrics: Path) -> dict:
    """{component: [K after each epoch]} from one run's training records."""
    out: dict = {}
    for line in metrics.read_text().splitlines():
        rec = json.loads(line)
        if "epoch" not in rec:
            continue
        for key, value in rec.items():
            if key.startswith("train/curvature/"):
                out.setdefault(key.split("/", 2)[2], []).append(value)
    return out


def crossing(ks: list) -> int | None:
    """The first epoch (1-based) after which K has the other sign than
    after the first epoch, or None."""
    first = ks[0]
    for i, k in enumerate(ks):
        if k * first < 0 or (first == 0 and k != 0):
            return i + 1
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_root", default="runs/torch_matrix")
    args = ap.parse_args(argv)
    print("| run | component | K, epoch 1 | K, last epoch | min | max | "
          "crosses zero after epoch |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for metrics in sorted(Path(args.run_root).glob("*/metrics.jsonl")):
        for comp, ks in trajectories(metrics).items():
            if max(ks) == min(ks):
                continue
            cross = crossing(ks)
            print(f"| {metrics.parent.name} | {comp} | {ks[0]:+.4f} | "
                  f"{ks[-1]:+.4f} | {min(ks):+.4f} | {max(ks):+.4f} | "
                  f"{'-' if cross is None else cross} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
