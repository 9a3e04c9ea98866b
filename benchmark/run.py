"""Run one cell of the benchmark once and print its result as one JSON line.

    python benchmark/run.py --workload h2s2e2.train_b1024 --seed 7 \
        --seconds 10 --trace 0

A cell is ``workloads/<name>.json`` (its configuration and traffic mix),
``configs/<config>.json`` (the model and its data set: the model family's
plain reference ``reference/<reference>.py``, the ``data_shape`` and
whether it is ``binarize``d) and ``traffic/<traffic>.json`` (the program
it drives and how); the metrics it reports are ``BENCHMARK.json``'s
entries that name it, each per-layer metric read by
``metrics/<metric>.py``. Nothing here names a cell, a configuration or a
model family.

A run makes the data, the weights and every draw on the card from
``--seed``, builds the program (``programs.py``) and warms it up (set-up:
its kernel libraries loaded, compiled where the build cache has none, and
named under ``kernel_build``; its graphs captured; for training, the
checked epoch: the first epoch again from the initial state, every step a
replay), then runs the window: training epochs, or IWAE passes over the
test split, back to back for ``--seconds`` (``--trace 0``: the end-to-end
metrics), or a fixed number of them under ``torch.profiler`` (``--trace
1``: the per-layer metrics). After the window it frees the program and
holds what the replays produced (the checked epoch's first steps; the
window's passes) against the plain reference (``check.py``); the numbers
compared are printed beside their limits on standard error and under
``checks`` in the result.

Exit codes: 0 with a result line; 2 no card (or too few); 3 the program or
a file of the cell missing; 4 the JAX package or JAX loaded; 5 the run
took another path than the cell states.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import check  # noqa: E402
import devtrace  # noqa: E402
import generate  # noqa: E402
import reference  # noqa: E402
import work  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "mvae_tpu"}
# seconds from the process's start at each step of the set-up
PHASES: dict = {}


WINDOW = "benchmark.window"


def mark(phase: str) -> None:
    PHASES[phase] = time.perf_counter() - T0


class Refused(Exception):
    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise Refused(3, f"missing {path}") from None


def find_cell(root: Path, name: str) -> dict:
    """The cell's files and BENCHMARK.json's entries that concern it."""
    bench = load_json(root / "BENCHMARK.json")
    here = root / "benchmark"
    wl = load_json(here / "workloads" / f"{name}.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise Refused(3, f"{name} is not a workload of BENCHMARK.json")
    if (entry["config"], entry["traffic"]) != (wl["config"], wl["traffic"]):
        raise Refused(3, f"{name}: BENCHMARK.json and workloads/{name}.json "
                         "name another configuration or traffic")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = load_json(root / cfg_entry["file"])
    traffic = load_json(here / "traffic" / f"{wl['traffic']}.json")
    try:
        ref = reference.load(here / "reference", cfg["reference"])
    except FileNotFoundError as e:
        raise Refused(3, str(e)) from None

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {"name": name, "chips": entry["chips"], "workload": wl,
            "config": cfg, "traffic": traffic, "ref": ref,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)],
            "metrics_dir": here / "metrics"}


def read_metric(directory: Path, name: str, ctx: dict):
    """``metrics/<name>.py``'s ``read(ctx)``: a number, or None where it
    found nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", directory / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def shapes(cfg: dict, traffic: dict, ref) -> dict:
    """The cell's widths, from its configuration, traffic and reference
    module (``ref``)."""
    lats = ref.parse_spec(cfg["spec"])
    n = traffic.get("samples", cfg["likelihood_n"])
    sh = {"D": math.prod(cfg["data_shape"]), "H": cfg["h_dim"],
          "W": sum(l.head_width for l in lats),
          "Z": sum(l.ambient for l in lats),
          "n_params": sum(math.prod(s) for s in ref.param_shapes(
              lats, cfg).values()),
          "batch": traffic.get("batch_size"), "samples": n,
          "eval_batch": generate.eval_batches(cfg)[1],
          # the IWAE decode kernel's samples a launch: n's largest divisor
          # <= 128, as the program picks it
          "decode_samples": next(d for d in range(min(128, n), 0, -1)
                                 if n % d == 0)}
    return sh


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiler(device):
    """The device's activity alone: profiling the host's operations too
    slows the host enough that the device waits on it."""
    acts = [torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" \
        else [torch.profiler.ProfilerActivity.CPU]
    return torch.profiler.profile(activities=acts)


class Spans:
    """The harness's own host spans of a traced window, (name, start_ns,
    end_ns) on the profiler's clock (``time.time_ns``); off, a no-op."""

    def __init__(self, on: bool):
        self.on, self.spans = on, []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


def timed(issue, device, seconds: float, trace: bool, n_trace: int) -> dict:
    """The window: units (epochs or passes) back to back. ``issue(label,
    i)`` issues unit ``i`` and returns its ``finish()``, which waits for it
    and says whether it came out finite. Untraced, units run until
    ``seconds`` have passed; traced, ``n_trace`` units run untraced (their
    wall a unit is ``unit_s``: the profiler slows the host's issue of a
    graph), then ``n_trace`` more under the profiler, which are the
    window. ``issued`` counts both."""
    out = {"unit_s": None, "failed": 0}
    i = 0
    if trace:
        sync(device)
        t = time.perf_counter()
        for _ in range(n_trace):
            i += 1
            out["failed"] += not issue(Spans(False), i)()
        sync(device)
        out["unit_s"] = (time.perf_counter() - t) / n_trace
    prof = profiler(device) if trace else None
    label = Spans(trace)
    n = 0
    with (prof or contextlib.nullcontext()):
        sync(device)
        t0 = time.perf_counter()
        with label(WINDOW):
            while True:
                i += 1
                out["failed"] += not issue(label, i)()
                n += 1
                if n >= n_trace if trace else \
                        time.perf_counter() - t0 >= seconds:
                    break
        sync(device)
        out["window_s"] = time.perf_counter() - t0
    out.update(units=n, issued=i, prof=prof, spans=label.spans)
    return out


def finite(means: dict) -> bool:
    return all(math.isfinite(v) for v in means.values()
               if isinstance(v, float))


def peak_bytes(device):
    return (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)


def train_cell(cell, seed, seconds, trace, device, programs, run_dir):
    cfg, traffic, ref = cell["config"], cell["traffic"], cell["ref"]
    train, test = generate.dataset(cfg, seed, device)
    w0 = generate.weights(ref, cfg, seed, device)
    sync(device)
    mark("data_and_weights")
    trainer = programs.build(cfg, traffic, seed, train, test, device, run_dir)
    programs.load_weights(trainer, w0)
    sync(device)
    mark("trainer")
    prog = programs.Train(trainer)
    draws = generate.train_draws(ref, cfg, traffic, seed, 0, device)
    # the warm epoch: its first steps run eagerly, then the step's graph is
    # captured and replayed
    prog.means(prog.run(*draws))
    sync(device)
    mark("warm_epoch")
    # the checked epoch: the same epoch again from the same state, each
    # step a replay, as every step of the window
    programs.reset(trainer, w0)
    first = programs.FirstSteps(trainer, 3)
    stats = prog.run(*draws)
    losses = -stats["elbo"][:3].clone()
    prog.means(stats)
    first.close()
    del draws
    sync(device)
    mark("checked_epoch")
    setup_s = time.perf_counter() - T0

    def issue(label, i):
        with label("benchmark.epoch_draws"):
            draws = generate.train_draws(ref, cfg, traffic, seed, i, device)
        with label("benchmark.epoch_replays"):
            stats = prog.run(*draws)

        def finish():
            with label("benchmark.epoch_stats_read"):
                return finite(prog.means(stats))
        return finish

    before = programs.launches()
    out = timed(issue, device, seconds, trace, traffic["trace_epochs"])
    S, B = prog.steps, traffic["batch_size"]
    out.update(setup_s=setup_s, rate=out["units"] * S * B / out["window_s"],
               attempted=out["issued"] * S, failed=out["failed"] * S,
               steps_per_unit=S, examples_per_unit=S * B,
               launches_per_unit={k: (v - before[k]) / (out["issued"] * S)
                                  for k, v in programs.launches().items()},
               memory_peak=peak_bytes(device))
    program_out = (losses, first.grad, first.after)
    del prog, trainer, stats, first
    free(device)
    expected = check.reference_train(ref, cfg, traffic, seed, train, w0)
    out["look"] = {}
    out["numbers"] = check.train_numbers(*program_out, w0, expected,
                                         out["look"])
    return out


def iwae_cell(cell, seed, seconds, trace, device, programs, run_dir):
    cfg, traffic, ref = cell["config"], cell["traffic"], cell["ref"]
    train, test = generate.dataset(cfg, seed, device)
    del train
    w0 = generate.weights(ref, cfg, seed, device)
    sync(device)
    mark("data_and_weights")
    trainer = programs.build(cfg, traffic, seed, test, test, device, run_dir)
    programs.load_weights(trainer, w0)
    sync(device)
    mark("trainer")
    prog = programs.Iwae(trainer)
    float(prog.run(generate.iwae_noise(ref, cfg, traffic, seed, 0,
                                       device)).mean())
    sync(device)
    mark("warm_pass")
    setup_s = time.perf_counter() - T0
    kept = []

    def issue(label, i):
        with label("benchmark.pass_draws"):
            noise = generate.iwae_noise(ref, cfg, traffic, seed, i, device)
        with label("benchmark.pass_replays"):
            est = prog.run(noise)

        def finish():
            with label("benchmark.pass_mean_read"):
                float(est.mean())
            kept.append(est)
            return True
        return finish

    before = programs.launches()
    out = timed(issue, device, seconds, trace, traffic["trace_passes"])
    n = len(test)
    allv = torch.stack(kept)
    out.update(setup_s=setup_s, rate=out["units"] * n / out["window_s"],
               attempted=len(kept) * n,
               failed=int((~torch.isfinite(allv)).sum()),
               steps_per_unit=None, examples_per_unit=n,
               launches_per_unit={k: (v - before[k]) / (len(kept) * prog.nb)
                                  for k, v in programs.launches().items()},
               memory_peak=peak_bytes(device))
    del prog, trainer
    free(device)
    # the last pass and one drawn from the seed, every example of each
    passes = len(kept)
    gen = torch.Generator().manual_seed(generate.mix(seed, "check"))
    picks = sorted({passes, 1 + int(torch.randint(
        0, passes, (1,), generator=gen))})
    gaps = []
    for p in picks:
        r = check.reference_iwae(ref, cfg, traffic, seed, test, w0, p)
        gaps.append(check.iwae_numbers(allv[p - 1], r)["ll_gap_nats"])
    out["numbers"] = {"ll_gap_nats": max(gaps)}
    out["checked_passes"] = picks
    return out


CELLS = {"train": train_cell, "iwae": iwae_cell}


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def smi(fields: str) -> str | None:
    """One line of ``nvidia-smi --query-gpu=<fields>`` for the first card."""
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def metric_context(cell, run, summary) -> dict:
    """What a per-layer metric's reader reads: the traced window's device
    trace summary (``devtrace.summarize``) and its units, the wall a unit
    of the untraced stretch before it (``unit_s``), a unit's steps and
    examples, the shapes, the model family's work (its reference module's
    ``work``), ``work.py``'s kernel counts and the peaks."""
    cfg, traffic, ref = cell["config"], cell["traffic"], cell["ref"]
    return {"cell": cell["name"], "program": traffic["program"],
            "shapes": shapes(cfg, traffic, ref),
            "model_work": ref.work(cfg, ref.parse_spec(cfg["spec"]),
                                   traffic),
            "trace": summary, "units": run["units"],
            "unit_s": run["unit_s"],
            "steps_per_unit": run["steps_per_unit"],
            "examples_per_unit": run["examples_per_unit"],
            "launches_per_unit": run["launches_per_unit"], "work": work,
            "peaks": json.loads((HERE / "peaks.json").read_text())}


def check_path(cell, run) -> None:
    """The kernels each step (training) or eval batch (IWAE) launched
    against what the cell states (``workloads/<name>.json``)."""
    expect = cell["workload"].get("launches_per_unit", {})
    got = {k: run["launches_per_unit"][k] for k in expect}
    if got != expect:
        raise Refused(5, f"{cell['name']} launched {got} a "
                         f"{cell['traffic']['program']} unit, expected "
                         f"{expect}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = HERE.parent, programs=None) -> dict:
    """One run of cell ``name``; returns the result line's object. On the
    CPU (``device``) the program runs its plain versions eagerly and every
    device number is null."""
    device = torch.device(device)
    cell = find_cell(root, name)
    if programs is None:
        programs = import_program(root)
        mark("imports")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = {"seconds": None, "compiled": None}
    if device.type == "cuda":
        # the cell's kernel libraries, compiled where the build cache has
        # none (a checkout's first run): counted in set-up, and named here
        t = time.perf_counter()
        build["compiled"] = programs.load_kernels(
            k for k, v in cell["workload"].get("launches_per_unit", {}).items() if v)
        build["seconds"] = time.perf_counter() - t
        mark("kernels")
    run_dir = os.path.join(tempfile.gettempdir(), "mvae-benchmark")
    kind = cell["traffic"]["program"]
    run = CELLS[kind](cell, seed, seconds, trace, device, programs, run_dir)
    limits = cell["workload"]["limits"]
    numbers = run["numbers"]
    correct = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
                  for k in limits)
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else None,
           "count": cell["chips"] if on_card else 0,
           "memory_peak_bytes": run["memory_peak"],
           "power_limit": smi("power.limit") if on_card else None}
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"]}
    if trace:
        summary = None
        if on_card:
            summary = devtrace.summarize(run["prof"], run["spans"], WINDOW)
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = run["window_s"]
            result["breakdown"] = {
                "device_ops": devtrace.top_ops(summary["ops"]),
                "idle_gaps": devtrace.idle_gaps(summary)}
        ctx = metric_context(cell, run, summary)
        metrics = {}
        for m in cell["per_layer"]:
            v = read_metric(cell["metrics_dir"], m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if on_card:
            check_path(cell, run)
    else:
        values = {"setup_s": run["setup_s"],
                  cell["traffic"]["rate_metric"]: run["rate"]}
        metrics = {m["name"]: {"value": values[m["name"]] if on_card
                               else None, "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["launches_per_unit"] = run["launches_per_unit"]
    result["setup_phases_s"] = dict(PHASES)
    result["kernel_build"] = build
    # every number the check worked out, those compared and not
    result["look"] = {"numbers": numbers}
    if "look" in run:
        result["look"]["widest_leaves"] = run["look"]
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    return result


def import_program(root: Path):
    """``programs.py`` over the checkout's own ``mvae_torch``."""
    sys.path.insert(0, str(root))
    try:
        import mvae_torch
    except ImportError as e:
        raise Refused(3, f"the program (mvae_torch) is not in {root}: {e}")
    where = Path(mvae_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        raise Refused(3, f"mvae_torch loads from {where}, not from {root}")
    import programs
    return programs


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = find_cell(HERE.parent, args.workload)
        if not torch.cuda.is_available():
            raise Refused(2, "no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(2, f"{args.workload} needs {cell['chips']} cards, "
                             f"{torch.cuda.device_count()} present")
        torch.set_num_threads(4)
        torch.cuda.init()
        mark("card")
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0))
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return e.code
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
