"""CLI entry point (L7), with the reference's flags.

    python -m mvae_torch.cli --dataset mnist --model h2,s2,e2 \
        --fixed_curvature false --epochs 100 --likelihood_n 500
    python -m mvae_torch.cli --dataset mnist --model d6:riemannian
    python -m mvae_torch.cli --dataset cifar --model u6 \
        --fixed_curvature false          # the conv VAE (--arch conv)

Trains (``Trainer.fit``: a test ELBO per epoch, the IWAE-n estimate at
the end), writes ``<run_dir>/result.json`` and prints it as one JSON line,
with the kernels the run was routed through (``fused_paths``:
``models.route.report``) and whether it replayed CUDA graphs or ran the
eager loop, and why (``graph_path``), with the graphs it captured of each
program (``graph_captures``).
``--resume`` continues from the latest checkpoint of ``run_dir``;
``--eval_only`` restores it and evaluates the test ELBO and IWAE-n LL.
``--generate N`` then writes N prior samples and N test-set reconstructions
(with the binarized inputs they reconstruct) to ``<run_dir>/samples.npz``.
``--debug_nans`` makes every op and kernel that produces a NaN or an Inf
raise, naming it (slow; ``utils.profiling.enable_nan_guard``), for the
run; ``--profile_epochs N`` traces the training of the first N epochs into
``<run_dir>/profile`` (a Chrome trace JSON), with the program's layer spans
(``utils.profiling``): the host ranges of the epoch's copies, graph replays
and statistics read, and on a card a marker kernel ``mvae_span_<layer>``
where each layer of a replayed step starts (encode, tail, decode, loss,
bwd_decode, bwd_tail, bwd_encode, optimizer, end; the conv nets add
encode_fc, decode_conv, bwd_decode_fc and bwd_encode_conv). Runs on CUDA unless
``--device cpu`` is given. The reference's ``--train_rng`` has no
counterpart: the port's training randomness is one torch generator.

``--mesh D,M`` trains on a ("data", "model") mesh of D x M ranks, one
process each (``parallel.launch``: rank r on ``cuda:(r % device_count)``,
or on the CPU with ``--device cpu``; NCCL when each rank has a card of its
own, gloo otherwise); rank 0 logs and writes. Every rank prints its
backend, graph path and graph captures, and the result carries them, by
rank, under ``ranks``.

    python -m mvae_torch.cli --device cpu --dataset bdp --model h2,s2,e2 \
        --h_dim 16 --epochs 1 --mesh 2,2
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mvae-torch",
        description="Mixed-curvature VAE training on PyTorch/CUDA")
    p.add_argument("--dataset", default="mnist",
                   choices=["mnist", "omniglot", "cifar", "bdp"])
    p.add_argument("--model", default="e6",
                   help="latent spec, e.g. 'h2,s2,e2', '2h2', 'e6'")
    p.add_argument("--fixed_curvature", type=_str2bool, default=True)
    p.add_argument("--scalar_sigma", type=_str2bool, default=False)
    p.add_argument("--wraps", type=int, default=1)
    p.add_argument("--sigma_cap", type=_str2bool, default=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--h_dim", type=int, default=400)
    p.add_argument("--arch", default=None, choices=[None, "mlp", "conv"],
                   help="default: conv for cifar, mlp otherwise")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--curvature_lr", type=float, default=1e-4)
    p.add_argument("--init_k", type=float, default=1.0)
    p.add_argument("--burnin", type=int, default=10,
                   help="epochs with curvature frozen")
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--likelihood_n", type=int, default=500)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--run_dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval_only", action="store_true",
                   help="restore the latest checkpoint and only evaluate "
                        "the test ELBO and IWAE marginal LL (no training)")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training (or with --eval_only, from the "
                        "checkpoint) write N prior samples and N test-set "
                        "reconstructions to <run_dir>/samples.npz")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--ll_max_examples", type=int, default=None,
                   help="cap IWAE eval set size (speed)")
    p.add_argument("--eval_binarize", default="dynamic",
                   choices=["dynamic", "fixed"])
    p.add_argument("--ll_repeats", type=int, default=1)
    p.add_argument("--mesh", default=None,
                   help="train on a mesh 'DATA,MODEL' of that many ranks, "
                        "one process each (the batch must divide DATA)")
    p.add_argument("--debug_nans", action="store_true",
                   help="fail fast on the first op or kernel producing a "
                        "NaN or Inf (slow; debugging)")
    p.add_argument("--profile_epochs", type=int, default=0,
                   help="trace the training of the first N epochs into "
                        "<run_dir>/profile (torch.profiler, Chrome trace, "
                        "with the program's layer spans and markers)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU runs the "
                        "kernels' plain versions and must be asked for)")
    return p


def _mesh_shape(text: str | None) -> tuple[int, int] | None:
    if not text:
        return None
    parts = [int(v) for v in text.split(",")]
    return parts[0], parts[1] if len(parts) > 1 else 1


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh_shape = _mesh_shape(args.mesh)
    if mesh_shape is not None:
        from .parallel.launch import launch
        return launch(_main, *mesh_shape, args, device=args.device)[0]
    return _main(args)


def _main(args):
    """One process's run: the whole run, or one rank of a mesh."""
    if not args.debug_nans:
        return _run(args)
    from .utils import profiling
    profiling.enable_nan_guard()
    try:
        return _run(args)
    finally:
        profiling.disable_nan_guard()


def build_trainer(args):
    """The ``Trainer`` the flags ``args`` describe (latent, dataset,
    network, training settings, run directory), as a run builds it."""
    from .components import parse_components
    from .data import load_dataset
    from .models import VAEConfig
    from .train import TrainConfig, Trainer

    components = parse_components(args.model,
                                  fixed_curvature=args.fixed_curvature,
                                  scalar_sigma=args.scalar_sigma,
                                  wraps=args.wraps,
                                  sigma_cap=args.sigma_cap)
    dataset = load_dataset(args.dataset)
    arch = args.arch or ("conv" if args.dataset == "cifar" else "mlp")
    model_cfg = VAEConfig(components=components,
                          data_shape=dataset.data_shape, arch=arch,
                          h_dim=args.h_dim)
    mesh_shape = _mesh_shape(args.mesh)
    tc = TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                     lr=args.lr, curvature_lr=args.curvature_lr,
                     burnin_epochs=args.burnin, beta=args.beta,
                     seed=args.seed, likelihood_n=args.likelihood_n,
                     checkpoint_every=args.checkpoint_every,
                     dtype=args.dtype, mesh_shape=mesh_shape,
                     init_k=args.init_k, eval_binarize=args.eval_binarize)
    run_dir = args.run_dir or (
        f"runs/{args.dataset}_{args.model.replace(',', '-').replace(':', '.')}"
        f"_{'fixed' if args.fixed_curvature else 'learn'}_s{args.seed}")
    return Trainer(model_cfg, dataset, tc, run_dir, device=args.device)


def _run(args):
    from .components import canonical_name
    from .train import graphs

    trainer = build_trainer(args)
    model_cfg, dataset, tc = trainer.model_cfg, trainer.dataset, trainer.tc
    run_dir, mesh_shape = trainer.run_dir, tc.mesh_shape
    say = print if trainer.chief else (lambda *a, **k: None)
    say(f"model {canonical_name(model_cfg.components)} on {dataset.name} "
        f"({'synthetic stand-in' if dataset.synthetic else 'real data'}), "
        f"arch={model_cfg.arch}, dtype={args.dtype}, run_dir={run_dir}"
        + (f", mesh {mesh_shape[0]}x{mesh_shape[1]}" if mesh_shape else ""))

    def write_samples(n):
        """N prior samples and N test reconstructions. The reconstruction
        inputs go through the dataset's binarization first, as every
        training and eval input does; ``originals`` are those inputs. The
        draws come from a generator of their own (seed + 777), so the file
        does not depend on how far the trainer's generator has run. On a
        mesh every rank gathers the weights and rank 0 writes."""
        import numpy as np
        import torch

        from .data.base import binarize_batch
        from .models import vae
        params = trainer.whole_params()
        if not trainer.chief:
            return
        gen = torch.Generator(device=trainer.device)
        gen.manual_seed(tc.seed + 777)
        with torch.no_grad():
            generated = vae.generate(model_cfg, params, n, gen)
            x = binarize_batch(trainer._test_data[:n], dataset.binarize, gen)
            rec = vae.reconstruct(model_cfg, params, x, generator=gen)
        path = Path(run_dir) / "samples.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path, generated=generated.float().cpu().numpy(),
            originals=x.float().cpu().numpy(),
            reconstructions=rec.float().cpu().numpy())
        print(f"wrote {path} (generated/originals/reconstructions x{n})")

    if args.eval_only:
        trainer.restore_checkpoint()
        elbo = trainer.evaluate_elbo("test")
        ll = trainer.evaluate_log_likelihood(
            max_examples=args.ll_max_examples, repeats=args.ll_repeats)
        if args.generate:
            write_samples(args.generate)
        result = {"test/elbo": elbo["elbo"], "test/log_likelihood_iwae": ll,
                  "step": trainer.step, "eval_only": True,
                  "device": str(trainer.device),
                  "fused_paths": trainer.fused_paths,
                  "graph_path": trainer.graph_path,
                  "graph_captures": graphs.captures(trainer),
                  **_ranks(trainer)}
        say(json.dumps(result))
        return result if trainer.chief else None
    if args.resume:
        trainer.restore_checkpoint()
        say(f"resumed at step {trainer.step}")
    result = trainer.fit(ll_max_examples=args.ll_max_examples,
                         profile_epochs=args.profile_epochs,
                         ll_repeats=args.ll_repeats)
    result["fused_paths"] = trainer.fused_paths
    result["graph_path"] = trainer.graph_path
    result["graph_captures"] = graphs.captures(trainer)
    result["device"] = str(trainer.device)
    result.update(_ranks(trainer))
    if args.generate:
        write_samples(args.generate)

    if not trainer.chief:
        return None
    summary = {k: v for k, v in result.items() if k != "history"}
    Path(run_dir).mkdir(parents=True, exist_ok=True)
    (Path(run_dir) / "result.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return result


def _ranks(trainer) -> dict:
    """On a mesh, ``{"ranks": [...]}``: each rank's device, backend, graph
    path and graph captures in rank order, each rank printing its own (every
    rank takes part); on one device nothing."""
    mesh = trainer.mesh
    if mesh is None:
        return {}
    import torch.distributed as dist

    from .train import graphs
    mine = {"rank": mesh.rank, "device": str(trainer.device),
            "backend": mesh.backend, "graph_path": trainer.graph_path,
            "graph_captures": graphs.captures(trainer)}
    print(f"[rank {mesh.rank}] {mine['device']}, backend {mesh.backend}, "
          f"{trainer.graph_path['path']} ({trainer.graph_path['why']}), "
          f"captures {mine['graph_captures']}", flush=True)
    ranks = [None] * mesh.size
    dist.all_gather_object(ranks, mine, group=mesh.group)
    return {"ranks": ranks}


if __name__ == "__main__":
    main()
