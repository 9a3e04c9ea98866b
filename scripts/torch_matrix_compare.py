"""The port's round-5 matrix against the reference's, one row a
configuration.

Reads the reference's summary (``RESULTS_r5_matrix_summary.json``, written
by ``scripts/run_r5_matrix.py``) and the port's
(``RESULTS_torch_matrix_summary.json``, written by ``python -m
mvae_torch.matrix``) and prints a Markdown table: both IWAE-500 means and
population stds over the seeds, their difference, the bound and the
verdict. Two 5-seed means agree when

    |m_port - m_ref| <= 3 * sqrt((s_port^2 + s_ref^2) / 5).

Per-seed values are not compared: the two packages' training noise and
fixed eval binarization differ by design, and the seeds average both out.
A configuration with fewer than 5 seeds on either side is "incomplete".
A second table gives each configuration's rows of the port's matrix file
(``RESULTS_torch_matrix.json``): statuses, training steps/s (train-only
wall) and whole-row wall, each over its seeds, the graph path and
captures, and the cards the rows ran on.

    python scripts/torch_matrix_compare.py
    python scripts/torch_matrix_compare.py --port other_summary.json
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEEDS = 5
SIGMAS = 3.0


def bound(s_port: float, s_ref: float, n: int = SEEDS) -> float:
    """How far apart two n-seed means may lie: three standard errors of
    their difference."""
    return SIGMAS * math.sqrt((s_port ** 2 + s_ref ** 2) / n)


def compare(port: dict, ref: dict, tags: list) -> list[dict]:
    """One comparison a tag of ``tags``: the summaries' entries, the
    difference of the means, the bound and the verdict ("agree", "differ",
    or "incomplete" when either side lacks its 5 seeds)."""
    rows = []
    for tag in tags:
        p, r = port.get(tag), ref.get(tag)
        row = {"tag": tag, "port": p, "ref": r}
        if (p is None or r is None or p["n_seeds"] < SEEDS
                or r["n_seeds"] < SEEDS):
            row["verdict"] = "incomplete"
        else:
            row["diff"] = p["ll_mean"] - r["ll_mean"]
            row["bound"] = bound(p["ll_std"], r["ll_std"])
            row["verdict"] = ("agree" if abs(row["diff"]) <= row["bound"]
                              else "differ")
        rows.append(row)
    return rows


def _cell(entry: dict | None) -> str:
    if entry is None:
        return "none"
    return (f"{entry['ll_mean']:.3f} +- {entry['ll_std']:.3f} "
            f"({entry['n_seeds']} seeds)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref",
                    default=str(ROOT / "RESULTS_r5_matrix_summary.json"))
    ap.add_argument("--port",
                    default=str(ROOT / "RESULTS_torch_matrix_summary.json"))
    ap.add_argument("--rows", default=str(ROOT / "RESULTS_torch_matrix.json"))
    args = ap.parse_args(argv)
    from mvae_torch.matrix import CONFIGS

    ref = json.loads(Path(args.ref).read_text())
    port = json.loads(Path(args.port).read_text())
    rows = compare(port, ref, [t for t, _ in CONFIGS])
    print("| configuration | reference | port | port - ref | bound | "
          "verdict |")
    print("| --- | --- | --- | --- | --- | --- |")
    for row in rows:
        diff = f"{row['diff']:+.3f}" if "diff" in row else "-"
        lim = f"{row['bound']:.3f}" if "bound" in row else "-"
        print(f"| {row['tag']} | {_cell(row['ref'])} | {_cell(row['port'])} "
              f"| {diff} | {lim} | {row['verdict']} |")
    counts = {v: sum(r["verdict"] == v for r in rows)
              for v in ("agree", "differ", "incomplete")}
    print(f"{counts['agree']} agree, {counts['differ']} differ, "
          f"{counts['incomplete']} incomplete of {len(rows)}")
    if Path(args.rows).exists():
        print()
        rates(json.loads(Path(args.rows).read_text()),
              [t for t, _ in CONFIGS])
    return 0


def _span(values: list) -> str:
    return (f"{min(values):.1f}-{max(values):.1f}" if values else "-")


def rates(rows: list, tags: list) -> None:
    """Each configuration's rows: statuses, training steps/s and wall
    seconds over its seeds, graph path and captures, cards."""
    print("| configuration | rows | train steps/s | wall s (each) | wall s "
          "(sum) | graph path, captures | card |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for tag in tags:
        mine = [r for r in rows if r.get("tag") == tag]
        statuses = sorted({r["status"] for r in mine})
        status = ", ".join(f"{sum(r['status'] == s for r in mine)} {s}"
                           for s in statuses) or "none"
        sps = [r["train_steps_per_sec"] for r in mine
               if r.get("train_steps_per_sec") is not None]
        walls = [r["wall_s"] for r in mine if r.get("wall_s") is not None]
        graphs = sorted({f"{(r.get('graph_path') or {}).get('path')} "
                         f"{json.dumps(r.get('graph_captures'))}"
                         for r in mine})
        cards = sorted({str(r.get("card")) for r in mine})
        print(f"| {tag} | {status} | {_span(sps)} | {_span(walls)} | "
              f"{sum(walls):.1f} | {'; '.join(graphs)} | "
              f"{'; '.join(cards)} |")


if __name__ == "__main__":
    sys.exit(main())
