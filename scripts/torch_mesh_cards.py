#!/usr/bin/env python3
"""The port's ("data", "model") mesh under NCCL, one card a rank, held to
one card; each rank's training step, ELBO batch and IWAE batch replayed as
CUDA graphs with their collectives inside.

    python3 scripts/torch_mesh_cards.py   # one host with four cards
    python3 scripts/torch_mesh_cards.py --shapes 1,1 --cli_shape 1,1   # one card

On each mesh of ``--shapes`` (default (4, 1), (2, 2), (1, 4): four ranks
on four cards), at the flagship ``h2,s2,e2`` at MNIST width (h_dim 400):

* one training step against one card on the same weights, batch,
  binarization uniforms and noise (``chip_smoke._mesh_step_task``): the
  loss within 1e-4 nats, every gradient within rtol 1e-3 / atol 5e-4;
* IWAE-500 of ``h2,s2,e2`` and ``d2,p2,e2`` over 1,024 test examples, the
  samples split over "model", against one card on the same noise, within
  1e-3 nats a row (``chip_smoke._mesh_iwae_task``), with each rank's B2
  (and B5) launches;
* two epochs of ``STEPS`` steps across burn-in (burn-in 1) graphed
  against the eager rank from one seed: weights, Adam state, generator and
  statistics bit for bit; the curvature frozen, then moving; B1, B3 and B6
  once a step through the replays; then the ELBO and IWAE-500 passes over
  1,024 test examples graphed and eager from one generator state; one
  capture a program a rank, and each program's kernel launches a replay;
* training in turns (eager, graph, graph, eager) at
  global batch 128 (one epoch a turn) and 1024 (two epochs a turn),
  steps/s and the device's busy share a rank (one profiled epoch each
  way), and, on ``--iwae_shapes``, the IWAE-500 pass over the 10,000 test
  examples in turns, examples/s.

Then, with the mesh closed: ``mvae_torch.cli`` with ``--mesh`` at
``--cli_shape`` for one epoch (every rank graphed, on NCCL, one capture a
program, a finite IWAE); a checkpoint written by that mesh restored on one
card and the other way round (the whole weights and step bit for bit, and
a graphed epoch on after the restore); and the same call's one-card
graphed rates beside the mesh's. Every result, with the card's name and
power limit (``nvidia-smi``) and each check, goes to ``--out``
(``chiprun_out/torch_mesh_cards.json``); the script exits 1 when a check
failed. ``chip_smoke.py`` runs ``mesh_checks`` on a (1, 1) mesh.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mvae_torch import VAEConfig, parse_components  # noqa: E402
from mvae_torch.data import load_mnist  # noqa: E402
from mvae_torch.data.base import binarize_rows  # noqa: E402
from mvae_torch.models import vae  # noqa: E402
from mvae_torch.parallel.launch import World  # noqa: E402
from mvae_torch.train import graphs  # noqa: E402
from mvae_torch.train.trainer import _leaves  # noqa: E402

IWAE_EXAMPLES = 1024
# training steps an epoch of the graphed / eager epochs and the checkpoints
STEPS = 100


class Checks:
    """Each check's outcome, printed as it is made; ``failed`` lists the
    ones that did not hold."""

    def __init__(self):
        self.items: list[dict] = []

    def __call__(self, ok, what: str) -> None:
        self.items.append({"ok": bool(ok), "what": what})
        print(f"[check] {'ok' if ok else 'FAILED'}: {what}", flush=True)

    @property
    def failed(self) -> list[dict]:
        return [c for c in self.items if not c["ok"]]


def _name(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _per_replay(trainer) -> dict:
    """Each captured program's kernel launches a replay, by kernel name."""
    names = {fn: name for name, fn in cs._counted().items()}
    return {k[0]: {names.get(fn, getattr(fn, "__name__", str(fn))): n
                   for fn, n in p.per_replay.items()}
            for k, p in trainer._programs.items()}


def _busy(fn) -> tuple[float, float]:
    """(wall seconds, device busy share) of one call of ``fn`` under the
    CUPTI trace of this process's card."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()) / 1e6
    return wall, busy / wall


def _in_turns(eager, graph, count: int) -> dict:
    """``eager`` and ``graph`` once each, then timed in turns eager, graph,
    graph, eager: ``count`` units a turn over each turn's wall (ended by a
    device sync), and each turn's value."""
    eager(), graph()
    rates, values = [], []
    for fn in (eager, graph, graph, eager):
        torch.cuda.synchronize()
        t0 = time.time()
        values.append(fn())
        torch.cuda.synchronize()
        rates.append(count / (time.time() - t0))
    return {"eager": [rates[0], rates[3]], "graph": [rates[1], rates[2]],
            "values": values}


# --- rank tasks ------------------------------------------------------------------


def _epochs_task(shape, run_dir):
    """Two flagship epochs across burn-in, graphed and eager from one seed,
    then both evaluation passes graphed and eager from one generator
    state."""
    ds = cs._cut(load_mnist(), STEPS, test=IWAE_EXAMPLES)
    rank = dist.get_rank()
    g = cs._flagship(ds, f"{run_dir}/g{rank}", seed=0, burnin_epochs=1,
                     mesh_shape=shape)
    e = cs._flagship(ds, f"{run_dir}/e{rank}", seed=0, burnin_epochs=1,
                     mesh_shape=shape)
    k0 = cs._curvatures(g)
    cs._zero_counts()
    got = [g.train_one_epoch(epoch) for epoch in range(2)]
    torch.cuda.synchronize()
    counts = cs._read_counts()
    want = [e._train_one_epoch_eager(epoch) for epoch in range(2)]
    same = cs._same_state(g, e) and got == want
    frozen = all(got[0][f"curvature/{n}"] == k0[n] for n in k0)
    moving = all(got[1][f"curvature/{n}"] != k0[n]
                 for n in ("h2#0", "s2#1"))
    evals = {}
    for graph in (True, False):
        g.generator.manual_seed(21)
        elbo = g._evaluate_elbo("test", graph)
        g.generator.manual_seed(22)
        evals["graph" if graph else "eager"] = (
            elbo, g._evaluate_log_likelihood("test", None, graph))
    return {"rank": rank, "path": g.graph_path, "backend": g.mesh.backend,
            "device": torch.cuda.get_device_name(g.device),
            "steps": g.steps_per_epoch, "train_same": same,
            "frozen_then_moving": frozen and moving,
            "train_elbo": [s["elbo"] for s in got], "counts": counts,
            "evals_same": evals["graph"] == evals["eager"],
            "elbo": evals["graph"][0]["elbo"], "iwae": evals["graph"][1],
            "captures": graphs.captures(g), "per_replay": _per_replay(g)}


def _turns_task(shape, batch, epochs, iwae, run_dir):
    """Training (and with ``iwae`` the IWAE-500 pass over the test split)
    of a full flagship in turns eager / graph on this rank, and one
    profiled epoch each way."""
    tr = cs._flagship(load_mnist(), f"{run_dir}/t{dist.get_rank()}", seed=0,
                      burnin_epochs=0, batch_size=batch, mesh_shape=shape)
    S = tr.steps_per_epoch

    def eager():
        for epoch in range(epochs):
            tr._train_one_epoch_eager(epoch)

    def graph():
        for epoch in range(epochs):
            tr.train_one_epoch(epoch)

    train = _in_turns(eager, graph, epochs * S)
    del train["values"]
    out = {"rank": dist.get_rank(), "steps_a_turn": epochs * S,
           "train": train,
           "busy_eager": _busy(lambda: tr._train_one_epoch_eager(0))[1],
           "busy_graph": _busy(lambda: tr.train_one_epoch(0))[1]}
    if iwae:
        def seeded(graph):
            def run():
                tr.generator.manual_seed(21)
                return tr._evaluate_log_likelihood("test", None, graph)
            return run
        out["iwae"] = _in_turns(seeded(False), seeded(True),
                                len(tr._test_data))
        out["iwae_busy_graph"] = _busy(seeded(True))[1]
    return out


def _ckpt_save_task(shape, run_dir):
    """A graphed epoch of the mesh, then its checkpoint: the whole
    weights and the step."""
    tr = cs._flagship(cs._cut(load_mnist(), STEPS, test=IWAE_EXAMPLES),
                      run_dir, seed=0, burnin_epochs=0, mesh_shape=shape)
    tr.train_one_epoch(0)
    tr.save_checkpoint()
    return {"params": [t.detach().clone() for t in
                       _leaves(tr.whole_params())], "step": tr.step}


def _ckpt_restore_task(shape, run_dir, own_dir):
    """A mesh that has trained a graphed epoch restores a one-card
    checkpoint into its tensors, then trains a graphed epoch on: the
    restored whole weights and step, the epoch's ELBO, the captures."""
    tr = cs._flagship(cs._cut(load_mnist(), STEPS, test=IWAE_EXAMPLES),
                      own_dir, seed=0, burnin_epochs=0, mesh_shape=shape)
    tr.train_one_epoch(0)
    tr.run_dir = run_dir
    tr.restore_checkpoint()
    restored = [t.detach().clone() for t in _leaves(tr.whole_params())]
    step = tr.step
    after = tr.train_one_epoch(1)
    return {"params": restored, "step": step, "elbo_after": after["elbo"],
            "captures": graphs.captures(tr)}


# --- the checks ----------------------------------------------------------------


def _one_card_iwae(spec, xt, noise):
    """IWAE-500 of ``spec`` on one card over ``xt`` in batches of 512."""
    cfg = VAEConfig(parse_components(spec, fixed_curvature=False), (28, 28),
                    "mlp", h_dim=400)
    params = vae.init_params(cfg, 1.0, torch.float32,
                             torch.Generator().manual_seed(0), "cuda")
    with torch.no_grad():
        return torch.cat([vae.log_likelihood(
            cfg, params, xt[b:b + 512].cuda(), 500,
            noise=noise[:, b:b + 512].cuda())
            for b in range(0, len(xt), 512)]).cpu()


def mesh_checks(world, shape, ds, card: str, check, turns: bool = False,
                iwae_turns: bool = False) -> dict:
    """The checks of one mesh ``shape`` on ``world`` (its ranks all of the
    mesh), each recorded by ``check(ok, what)``, and with ``turns`` the
    rates; the numbers by name."""
    name = _name(shape)
    n_data = shape[0]
    out: dict = {}
    t0 = time.time()

    # one step against one card
    x, u, noise = cs._mesh_step_inputs(ds)
    one = cs._flagship(cs._tiny_mnist(x), tempfile.mkdtemp(), seed=0,
                       burnin_epochs=0)
    ref_loss = -one._train_step(x.cuda(), u.cuda(), noise.cuda())[
        "elbo"].item()
    ref = [t.grad.detach().cpu() for t in _leaves(one.params)]
    ranks = world.run(cs._mesh_step_task, shape, x, u, noise)
    worst = max(((torch.as_tensor(g) - r).abs()
                 / (1e-3 * r.abs() + 5e-4)).max().item()
                for o in ranks for g, r in zip(o["grads"], ref))
    dloss = max(abs(o["loss"] - ref_loss) for o in ranks)
    out["step"] = {"d_loss_nats": dloss, "grad_contract_share": worst,
                   "counts": [o["counts"] for o in ranks]}
    print(f"[mesh {name}] {card}: one step at batch 128 against one card: "
          f"|d loss| {dloss:.3g} nats, gradients at {worst:.3g} of (rtol "
          f"1e-3, atol 5e-4); launches by rank "
          f"{[o['counts'] for o in ranks]}", flush=True)
    check(dloss <= 1e-4, f"{name}: the step's loss within 1e-4 nats of one "
          f"card")
    check(worst <= 1.0, f"{name}: every gradient within the training "
          f"contract of one card")
    check(all(o["counts"]["tail_fwd"] >= 1 and o["counts"]["tail_bwd"] >= 1
              and o["counts"]["train_decode"] >= 1 for o in ranks),
          f"{name}: every rank's step launches B1, B3 and B6")

    # IWAE-500 against one card on the same noise
    xt = binarize_rows(1234, torch.arange(IWAE_EXAMPLES),
                       torch.as_tensor(ds.test[:IWAE_EXAMPLES]), True)
    rows = IWAE_EXAMPLES // 2 // n_data
    for spec in (cs.SPEC, cs.STEREO_SPEC):
        nz = cs._mesh_noise(spec, (500, IWAE_EXAMPLES), 31)
        one_ll = _one_card_iwae(spec, xt, nz)
        ranks = world.run(cs._mesh_iwae_task, spec, xt, nz, 2, shape)
        got = torch.zeros(2, n_data, rows)       # (batch, data index, row)
        agree = True
        for o in sorted(ranks, key=lambda o: o["m"]):
            ll = torch.as_tensor(o["ll"])
            if o["m"] == 0:
                got[:, o["d"]] = ll
            agree &= torch.equal(got[:, o["d"]], ll)
        err = (got.reshape(-1) - one_ll).abs().max().item()
        counts = [o["counts"] for o in ranks]
        out[f"iwae {spec}"] = {"max_d_ll_nats": err, "counts": counts,
                               "mean_ll": got.mean().item()}
        print(f"[mesh {name}] {card}: IWAE-500 of {spec} over "
              f"{IWAE_EXAMPLES} test examples ({rows} rows, "
              f"{500 // shape[1]} samples a rank a batch) against one card "
              f"on the same noise: max |d LL| {err:.3g} nats; launches by "
              f"rank {counts}", flush=True)
        check(agree, f"{name}: IWAE {spec}, the model ranks of a data shard "
              f"agree")
        check(err <= 1e-3, f"{name}: IWAE {spec} within 1e-3 nats a row of "
              f"one card")
        check(all(c["decode_bce"] >= 1 and (c["reparam_stereo"] >= 1
                                            or spec == cs.SPEC)
                  for c in counts),
              f"{name}: IWAE {spec}, every rank launches B2 (and B5 on the "
              f"stereographic family)")

    # graphed against eager, captures and launches a replay
    ranks = world.run(_epochs_task, shape, tempfile.mkdtemp())
    S = ranks[0]["steps"]
    out["epochs"] = {k: [o[k] for o in ranks] for k in (
        "train_same", "evals_same", "captures", "per_replay", "counts",
        "train_elbo", "elbo", "iwae", "backend", "device")}
    out["epochs"]["steps_an_epoch"] = S
    for o in ranks:
        print(f"[mesh {name}] rank {o['rank']} ({o['device']}, backend "
              f"{o['backend']}): {o['path']['path']}; 2 epochs of {S} steps "
              f"graphed against eager bit for bit {o['train_same']}; "
              f"evaluations bit for bit {o['evals_same']} (ELBO "
              f"{o['elbo']:.4f}, IWAE-500 {o['iwae']:.4f}); captures "
              f"{o['captures']}; launches a replay {o['per_replay']}; "
              f"through the graphed epochs {o['counts']}", flush=True)
        r = o["rank"]
        check(o["path"]["path"] == "graph" and o["backend"] == "nccl",
              f"{name} rank {r}: graphed on NCCL ({o['path']['why']})")
        check(o["train_same"], f"{name} rank {r}: two epochs across burn-in "
              f"graphed equal eager bit for bit")
        check(o["frozen_then_moving"], f"{name} rank {r}: the curvature "
              f"frozen through burn-in, then moving")
        check(o["evals_same"], f"{name} rank {r}: the ELBO and IWAE passes "
              f"graphed equal eager bit for bit")
        check(o["captures"] == {"train_step": 1, "eval_elbo": 1,
                                "eval_ll": 1},
              f"{name} rank {r}: one capture a program")
        c = o["counts"]
        check(c["tail_fwd"] == 2 * S and c["tail_bwd"] == 2 * S
              and c["train_decode"] == 2 * S,
              f"{name} rank {r}: B1, B3 and B6 once a step through the "
              f"replays: {c}")
        check(o["per_replay"].get("eval_ll", {}).get("decode_bce", 0) >= 1,
              f"{name} rank {r}: B2 in each IWAE replay")
    print(f"[mesh {name}] checks in {time.time() - t0:.1f} s", flush=True)

    if turns:
        t0 = time.time()
        out["turns"] = {}
        for batch, epochs in ((128, 1), (1024, 2)):
            ranks = world.run(_turns_task, shape, batch, epochs,
                              iwae_turns and batch == 128,
                              tempfile.mkdtemp())
            out["turns"][f"batch {batch}"] = ranks
            for o in ranks:
                t = o["train"]
                print(f"[turns {name}] {card}: rank {o['rank']}, batch "
                      f"{batch}, {o['steps_a_turn']} steps a turn: steps/s "
                      f"eager {t['eager'][0]:.2f}, graph {t['graph'][0]:.2f}, "
                      f"graph {t['graph'][1]:.2f}, eager {t['eager'][1]:.2f}; "
                      f"busy eager {100 * o['busy_eager']:.1f}%, graph "
                      f"{100 * o['busy_graph']:.1f}%", flush=True)
                if "iwae" in o:
                    w = o["iwae"]
                    print(f"[turns {name}] {card}: rank {o['rank']}, "
                          f"IWAE-500 over the test split, examples/s eager "
                          f"{w['eager'][0]:.1f}, graph {w['graph'][0]:.1f}, "
                          f"graph {w['graph'][1]:.1f}, eager "
                          f"{w['eager'][1]:.1f}; values {w['values']}; busy "
                          f"graph {100 * o['iwae_busy_graph']:.1f}%",
                          flush=True)
                    check(max(w["values"]) - min(w["values"]) <= 1e-3,
                          f"{name} rank {o['rank']}: the IWAE turns agree "
                          f"within 1e-3 nats")
        print(f"[turns {name}] in {time.time() - t0:.1f} s", flush=True)
    return out


def _cli(shape, check) -> dict:
    from mvae_torch import cli
    t0 = time.time()
    res = cli.main(["--dataset", "mnist", "--model", cs.SPEC,
                    "--fixed_curvature", "false", "--epochs", "1",
                    "--ll_max_examples", str(IWAE_EXAMPLES), "--mesh",
                    f"{shape[0]},{shape[1]}", "--run_dir",
                    tempfile.mkdtemp()])
    ll = res["test/log_likelihood_iwae"]
    ranks = res["ranks"]
    print(f"[cli --mesh {shape[0]},{shape[1]}] one epoch: "
          f"{res['train_steps_per_sec']:.2f} train steps/s, IWAE-500 on "
          f"{IWAE_EXAMPLES} examples {ll:.4f}; ranks {ranks} "
          f"({time.time() - t0:.1f} s with the ranks' start)", flush=True)
    name = _name(shape)
    check(math.isfinite(ll), f"cli --mesh {name}: a finite IWAE")
    check(len(ranks) == shape[0] * shape[1] and all(
        r["graph_path"]["path"] == "graph" and r["backend"] == "nccl"
        and r["graph_captures"] == {"train_step": 1, "eval_elbo": 1,
                                    "eval_ll": 1} for r in ranks),
          f"cli --mesh {name}: every rank graphed on NCCL, one capture a "
          f"program")
    return {"iwae": ll, "train_steps_per_sec": res["train_steps_per_sec"],
            "ranks": ranks}


def _checkpoints(world, shape, check) -> dict:
    """The mesh's checkpoint on one card, and one card's on the mesh."""
    name = _name(shape)
    ds = cs._cut(load_mnist(), STEPS, test=IWAE_EXAMPLES)
    mesh_dir, one_dir = tempfile.mkdtemp(), tempfile.mkdtemp()
    saved = world.run(_ckpt_save_task, shape, mesh_dir)[0]
    one = cs._flagship(ds, mesh_dir, seed=0, burnin_epochs=0)
    one.restore_checkpoint()
    to_one = (one.step == saved["step"] and all(
        torch.equal(a.detach().cpu(), torch.as_tensor(b))
        for a, b in zip(_leaves(one.params), saved["params"])))
    src = cs._flagship(ds, one_dir, seed=0, burnin_epochs=0)
    src.train_one_epoch(0)
    src.save_checkpoint()
    back = world.run(_ckpt_restore_task, shape, one_dir,
                     tempfile.mkdtemp())
    to_mesh = all(o["step"] == src.step and all(
        torch.equal(torch.as_tensor(a), b.detach().cpu())
        for a, b in zip(o["params"], _leaves(src.params))) for o in back)
    on = all(math.isfinite(o["elbo_after"]) and o["captures"].get("train_step")
             == 1 for o in back)
    print(f"[checkpoint {name}] the mesh's checkpoint on one card bit for "
          f"bit {to_one}; one card's on the mesh {to_mesh}; a graphed epoch "
          f"on after the restore: ELBO {[o['elbo_after'] for o in back]}, "
          f"captures {[o['captures'] for o in back]}", flush=True)
    check(to_one, f"{name} checkpoint restores on one card bit for bit")
    check(to_mesh, f"one card's checkpoint restores on {name} bit for bit")
    check(on, f"{name}: the captured step trains on after the restore")
    return {"mesh_to_one": to_one, "one_to_mesh": to_mesh,
            "graphed_epoch_after": on}


def _one_card_rates(ds) -> dict:
    """One card's graphed training steps/s at batch 128 and 1024 and its
    graphed IWAE-500 pass over the test split, examples/s: two turns each
    after a warm-up."""
    out = {}
    for batch, epochs in ((128, 1), (1024, 2)):
        tr = cs._flagship(ds, tempfile.mkdtemp(), seed=0, burnin_epochs=0,
                          batch_size=batch)
        rates = []
        for _ in range(3):
            rates.append(cs._epoch_rate(tr, 0, epochs))
        out[f"train batch {batch}"] = rates[1:]
        out[f"busy graph batch {batch}"] = _busy(
            lambda: tr.train_one_epoch(0))[1]
        if batch == 128:
            n = len(tr._test_data)
            ll = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.time()
                tr.evaluate_log_likelihood("test")
                torch.cuda.synchronize()
                ll.append(n / (time.time() - t0))
            out["iwae examples/s"] = ll[1:]
    print(f"[one card] graphed: {out}", flush=True)
    return out


def _shape(text: str) -> tuple[int, int]:
    d, m = (int(v) for v in text.split(","))
    return d, m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", type=_shape,
                    default=[(4, 1), (2, 2), (1, 4)])
    ap.add_argument("--iwae_shapes", nargs="*", type=_shape,
                    default=[(4, 1), (1, 4)])
    ap.add_argument("--cli_shape", type=_shape, default=(2, 2))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "torch_mesh_cards.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mesh_cards: no CUDA device", file=sys.stderr)
        return 1
    sizes = {d * m for d, m in args.shapes}
    if len(sizes) != 1:
        raise SystemExit("every mesh of --shapes must have as many ranks")
    card = cs.phase_card()
    ds = load_mnist()
    check = Checks()
    result = {"card": card, "cards": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "nccl": ".".join(str(v) for v in torch.cuda.nccl.version()),
              "steps_an_epoch": STEPS, "shapes": {}}
    t0 = time.time()
    with World(sizes.pop()) as world:
        for shape in args.shapes:
            result["shapes"][_name(shape)] = mesh_checks(
                world, shape, ds, card, check, turns=True,
                iwae_turns=shape in args.iwae_shapes)
        if args.cli_shape in args.shapes:
            result["checkpoint"] = _checkpoints(world, args.cli_shape, check)
    result["cli"] = _cli(args.cli_shape, check)
    result["one_card"] = _one_card_rates(ds)
    result["seconds"] = time.time() - t0
    result["checks"] = check.items
    result["ok"] = not check.failed
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1, default=str))
    print(f"wrote {out}: {len(check.items)} checks, "
          f"{len(check.failed)} failed: {check.failed} "
          f"({result['seconds']:.1f} s)", flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
