"""The readings that the limits of ``workloads/<cell>.json`` are set from,
at the cell's own size, several seeds in one process:

    python benchmark/control.py --workload h2s2e2.train_b1024 \
        --seeds 11,12,13 --what control,faults,program

* ``control``: the reference put in the program's place and computed in
  float32 with TF32 matrix products (the precision below the float32 the
  configuration states), held to the float64 reference as a run is;
* ``faults``: the reference put in the program's place with a fault
  planted: training, half of each batch left out (the mean taken over the
  rest) and the state left unchanged (the change's gap reads 1); IWAE, one
  answer altered (+1 nat) and half of the batch's answers left out (copies
  of the first half's);
* ``program``: whole runs of the cell (``run.run_cell``) with a short
  window, the sound runs' numbers.

Prints one JSON line a seed and reading, and the largest of each number
over the seeds at the end.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import check  # noqa: E402
import generate  # noqa: E402
import run  # noqa: E402


def train_readings(cell, seed, device, what) -> dict:
    cfg, traffic, ref = cell["config"], cell["traffic"], cell["ref"]
    train, _ = generate.dataset(cfg, seed, device)
    w0 = generate.weights(ref, cfg, seed, device)
    reference = check.reference_train(ref, cfg, traffic, seed, train, w0)
    out = {}
    if "control" in what:
        c = check.reference_train(ref, cfg, traffic, seed, train, w0,
                                  dtype=torch.float32, tf32=True)
        out["control"] = check.train_numbers(*c, w0, reference)
    if "faults" in what:
        h = check.reference_train(ref, cfg, traffic, seed, train, w0,
                                  half=True)
        out["half_batch"] = check.train_numbers(*h, w0, reference)
        out["state_unchanged"] = check.train_numbers(
            reference[0], reference[1], w0, w0, reference)
    return out


def iwae_readings(cell, seed, device, what) -> dict:
    cfg, traffic, ref = cell["config"], cell["traffic"], cell["ref"]
    _, test = generate.dataset(cfg, seed, device)
    w0 = generate.weights(ref, cfg, seed, device)
    reference = check.reference_iwae(ref, cfg, traffic, seed, test, w0, 1)
    out = {}
    if "control" in what:
        c = check.reference_iwae(ref, cfg, traffic, seed, test, w0, 1,
                                 dtype=torch.float32, tf32=True)
        out["control"] = check.iwae_numbers(c, reference)
    if "faults" in what:
        altered = reference.clone()
        altered[0] += 1.0
        out["answer_altered"] = check.iwae_numbers(altered, reference)
        _, bs = generate.eval_batches(cfg)
        half = reference.clone()
        for b0 in range(0, len(half), bs):
            blk = half[b0:b0 + bs]
            k = len(blk) // 2
            blk[k:2 * k] = blk[:k].clone()
        out["half_batch"] = check.iwae_numbers(half, reference)
    return out


READINGS = {"train": train_readings, "iwae": iwae_readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="control,faults")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    root = HERE.parent
    cell = run.find_cell(root, args.workload)
    what = set(args.what.split(","))
    worst: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        rows = READINGS[cell["traffic"]["program"]](cell, seed, device, what)
        if "program" in what:
            r = run.run_cell(args.workload, seed, args.seconds, False, device,
                             root)
            rows["program"] = r["look"]["numbers"]
            rows["program_correct"] = r["correct"]
            if "widest_leaves" in r["look"]:
                rows["program_widest_leaves"] = r["look"]["widest_leaves"]
        print(json.dumps({"seed": seed, **rows}), flush=True)
        for kind, nums in rows.items():
            if isinstance(nums, dict) and kind != "program_widest_leaves":
                for k, v in nums.items():
                    key = f"{kind}.{k}"
                    worst[key] = max(worst.get(key, v), v)
        run.free(device)
    print(json.dumps({"largest": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
