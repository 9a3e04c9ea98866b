"""CLI entry point (L7), with the reference's flags.

    python -m mvae_torch.cli --dataset mnist --model h2,s2,e2 \
        --fixed_curvature false --eval_only

In this slice of the port ``--eval_only`` evaluates the seed-initialised
model (checkpoint restore comes with the checkpoint slice) and prints one
JSON line with the test ELBO, the IWAE-n log-likelihood and the kernels
the run was routed through. Training is the next slice. Runs on CUDA
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mvae-torch",
        description="Mixed-curvature VAEs on PyTorch/CUDA (evaluation)")
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
                   help="evaluate the test ELBO and IWAE marginal LL of the "
                        "seed-initialised model (no training)")
    p.add_argument("--generate", type=int, default=0, metavar="N")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--ll_max_examples", type=int, default=None,
                   help="cap IWAE eval set size (speed)")
    p.add_argument("--eval_binarize", default="dynamic",
                   choices=["dynamic", "fixed"])
    p.add_argument("--ll_repeats", type=int, default=1)
    p.add_argument("--mesh", default=None,
                   help="device mesh 'DATA,MODEL' (a later slice)")
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU runs the "
                        "kernels' plain versions and must be asked for)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.eval_only or args.resume:
        raise NotImplementedError("slice 2: training, checkpoints and resume")
    if args.generate:
        raise NotImplementedError("later slice: --generate")

    from .components import canonical_name, parse_components
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
    mesh_shape = None
    if args.mesh:
        parts = [int(v) for v in args.mesh.split(",")]
        mesh_shape = (parts[0], parts[1] if len(parts) > 1 else 1)
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

    print(f"model {canonical_name(components)} on {dataset.name} "
          f"({'synthetic stand-in' if dataset.synthetic else 'real data'}), "
          f"arch={arch}, dtype={args.dtype}")
    trainer = Trainer(model_cfg, dataset, tc, run_dir, device=args.device)
    elbo = trainer.evaluate_elbo("test")
    ll = trainer.evaluate_log_likelihood(max_examples=args.ll_max_examples,
                                         repeats=args.ll_repeats)
    result = {"test/elbo": elbo["elbo"], "test/log_likelihood_iwae": ll,
              "eval_only": True, "device": str(trainer.device),
              "fused_paths": trainer.fused_paths}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
