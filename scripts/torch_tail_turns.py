#!/usr/bin/env python3
"""The tail kernels (B1 ``csrc/tail_fwd.cu``, B3 ``csrc/tail_bwd.cu``, with
the B4a / B4b tiles) against their previous design, in turns, on the card.

    python3 scripts/torch_tail_turns.py [--epochs 1] [--out FILE]

The previous design is ``scripts/tail_previous`` (the four sources as they
stood at commit b875f52: every product on the warp-a-component geometry,
each stereographic or sphere tile serial on one thread), built by nvcc
beside the package's kernels. The script runs:

- the kernels: every tail row of ``roofline.TAIL_ROWS`` on its own inputs,
  the new forward's outputs bit for bit against the previous design's, both
  timed new, previous, previous, new (``roofline.measure``: CUDA events
  around the replay of a CUDA graph of 100 calls), with the tail's I/O
  skeleton on both grids (``roofline.skel_tail``);
- the matrix rows p6, u6 (learnable curvature) and s6:wrapped at the
  matrix's batch 256, MLP h_dim 400 on MNIST (the synthetic stand-in where
  the files are missing), each row in a process of its own as the matrix
  runs them (``--row TAG``): a trainer for each design from one seed (the
  previous design's launches routed through ``tail_kernels``' entries while
  its programs are captured and replayed), two warm-up graphed epochs each
  (the first captures), then ``--rounds`` rounds of turns new, previous,
  previous, new, each turn ``--epochs`` graphed epochs: steps/s over each
  turn's wall ended by a device sync, the mean of each side's turns (an
  epoch of 234 steps is ~0.1 s of wall, so a turn moves with the host by a
  few percent).

Prints the card's name and power limit, one line a row, and writes one JSON
object to ``--out`` (default ``chiprun_out/torch_tail_turns.json``). Needs a
CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from mvae_torch import TrainConfig, Trainer, VAEConfig  # noqa: E402
from mvae_torch import parse_components  # noqa: E402
from mvae_torch.data import load_mnist  # noqa: E402
from mvae_torch.kernels import _build, roofline, tail_kernels  # noqa: E402

PREVIOUS = ROOT / "scripts" / "tail_previous"
# the matrix rows whose tails run the split tiles: (tag, spec, learnable K)
MATRIX_ROWS = (("p6", "p6", False), ("u6-learnK", "u6", True),
               ("s6-wrapped", "s6:wrapped", False))


def build_previous(reuse: bool = False) -> dict:
    """The previous design's launch entries, {"fwd", "bwd"}; with
    ``reuse``, the libraries an earlier call built."""
    out = _build.BUILD_DIR / "tail_previous"
    if reuse:
        libs = {k: ctypes.CDLL(str(out / f"{k}.so")) for k in ("fwd", "bwd")}
    else:
        libs = {k: lib for k, (lib, _) in _build.build_variants({
            "fwd": (PREVIOUS / "tail_fwd.cu", _build.EXTRA_FLAGS["tail_fwd"]),
            "bwd": (PREVIOUS / "tail_bwd.cu", _build.EXTRA_FLAGS["tail_bwd"])},
            out).items()}
    return {"fwd": tail_kernels.bind_tail(libs["fwd"])["fwd"],
            "bwd": tail_kernels.bind_tail(libs["bwd"])["bwd"]}


@contextlib.contextmanager
def previous_design(prev: dict):
    """Route ``tail_forward`` and ``tail_backward`` through the previous
    design's entries for the block (their launch counts still count)."""
    saved = tail_kernels._lib, tail_kernels._lib_bwd
    tail_kernels._lib = lambda: prev["fwd"]
    tail_kernels._lib_bwd = lambda: prev["bwd"]
    try:
        yield
    finally:
        tail_kernels._lib, tail_kernels._lib_bwd = saved


def kernel_turns(prev: dict) -> list:
    """Every tail row: bit-equality of the forward, and the two designs and
    both skeletons timed in turns."""
    rows = []
    for spec, kset, kern, B in roofline.TAIL_ROWS:
        comps, raw, eps, k, dz, daux = roofline.tail_inputs(spec, kset, B)
        bwd = kern == "B3"
        args = (raw, eps, k, dz, daux) if bwd else (raw, eps, k)
        name = "tail_bwd_kernel" if bwd else "tail_fwd_kernel"
        new = functools.partial(tail_kernels.tail_backward if bwd
                                else tail_kernels.tail_forward, comps, *args)
        old = functools.partial(tail_kernels.tail_backward_launch if bwd
                                else tail_kernels.tail_forward_launch,
                                prev["bwd" if bwd else "fwd"], comps, *args)
        a, b = new(), old()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        if not bwd and not same:
            raise RuntimeError(f"{kern} {spec} B={B}: not bit-equal to the "
                               f"previous design")
        skel = f"skel_{name}"
        turns = [roofline.measure(f, name, iters=100)
                 for f in (new, old, old, new)]
        sk = [roofline.measure(functools.partial(
            roofline.skel_tail, comps, *args, warp=w), skel, iters=100).us
            for w in (False, True)]
        t = (turns[0].us + turns[3].us) / 2
        p = (turns[1].us + turns[2].us) / 2
        rows.append({"kernel": kern, "spec": spec, "B": B, "new_us": t,
                     "previous_us": p, "turns_us": [x.us for x in turns],
                     "speedup": p / t, "bit_equal": same,
                     "skeleton_us": sk[0], "skeleton_warp_us": sk[1]})
        print(f"[kernels] {kern} {spec} B={B}: new {t:.2f} us, previous "
              f"{p:.2f} us ({p / t:.2f}x; turns "
              f"{', '.join(f'{x.us:.2f}' for x in turns)}); outputs "
              f"{'bit-equal' if same else 'not bit-equal'}; skeleton "
              f"{sk[0]:.2f} us on the kernel's grid, {sk[1]:.2f} us on the "
              f"warp-a-component grid", flush=True)
    return rows


def _trainer(ds, spec: str, learn_k: bool, run_dir: str) -> Trainer:
    cfg = VAEConfig(parse_components(spec, fixed_curvature=not learn_k),
                    ds.data_shape, "mlp", h_dim=400)
    return Trainer(cfg, ds, TrainConfig(batch_size=256, seed=11,
                                        burnin_epochs=10), run_dir)


def matrix_turns(epochs: int, rounds: int) -> list:
    """The matrix rows' graphed epochs in turns, new against previous, each
    row in a process of its own (``--row``), as the matrix runs them."""
    rows = []
    for tag, _, _ in MATRIX_ROWS:
        out = subprocess.run(
            [sys.executable, __file__, "--row", tag, "--epochs", str(epochs),
             "--rounds", str(rounds)], capture_output=True, text=True)
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            raise RuntimeError(f"{tag}: the row's process failed")
        lines = out.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)
        rows.append(json.loads(lines[-1]))
    return rows


def matrix_row(prev: dict, tag: str, epochs: int, rounds: int) -> dict:
    """One matrix row's graphed epochs in turns, new against previous."""
    ds = load_mnist()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for tag, spec, learn_k in [r for r in MATRIX_ROWS if r[0] == tag]:
            new = _trainer(ds, spec, learn_k, f"{tmp}/{tag}_new")
            old = _trainer(ds, spec, learn_k, f"{tmp}/{tag}_previous")

            def run(trainer, routed, epoch):
                ctx = (previous_design(prev) if routed
                       else contextlib.nullcontext())
                with ctx:
                    torch.cuda.synchronize()
                    t0 = time.time()
                    for e in range(epochs):
                        trainer.train_one_epoch(epoch + e)
                    torch.cuda.synchronize()
                    return (epochs * trainer.steps_per_epoch
                            / (time.time() - t0))

            for e in range(2):
                run(new, False, e)
                run(old, True, e)
            if (new.graph_path["path"], old.graph_path["path"]) != (
                    "graph", "graph"):
                raise RuntimeError(f"{tag}: not on the graph path")
            rates, done = [], {False: 2, True: 2}  # epochs each has run
            for _ in range(rounds):
                for trainer, routed in ((new, False), (old, True),
                                        (old, True), (new, False)):
                    rates.append(run(trainer, routed, done[routed]))
                    done[routed] += epochs
            n = sum(rates[0::4] + rates[3::4]) / (2 * rounds)
            p = sum(rates[1::4] + rates[2::4]) / (2 * rounds)
            us = 1e6 / p - 1e6 / n
            rows.append({"row": tag, "spec": spec, "batch": 256,
                         "steps_per_epoch": new.steps_per_epoch,
                         "epochs_a_turn": epochs, "rounds": rounds,
                         "new_steps_s": n,
                         "previous_steps_s": p, "turns_steps_s": rates,
                         "us_a_step_saved": us})
            print(f"[matrix] {tag} at batch 256, {epochs} graphed epoch(s) "
                  f"of {new.steps_per_epoch} steps a turn, {rounds} rounds: "
                  f"new {n:.1f} "
                  f"steps/s, previous {p:.1f} (turns "
                  f"{', '.join(f'{r:.1f}' for r in rates)}): "
                  f"{100 * (n / p - 1):+.1f}%, {us:.1f} us a step",
                  flush=True)
    return rows[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--row", help="one matrix row alone (its process)")
    ap.add_argument("--out", default="chiprun_out/torch_tail_turns.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_tail_turns: no CUDA device", file=sys.stderr)
        return 1
    if args.row:
        _build.build_all()
        prev = build_previous(reuse=True)
        print(json.dumps(matrix_row(prev, args.row, args.epochs,
                                    args.rounds)))
        return 0
    card = roofline.card()
    print(card, flush=True)
    _build.build_all()
    prev = build_previous()
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "kernels": kernel_turns(prev),
              "matrix": matrix_turns(args.epochs, args.rounds)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
