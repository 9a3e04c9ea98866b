"""Which basin the port's ``s6-wrapped/mnist`` matrix rows trained into:
the trained posterior scale against the sphere's injectivity cap pi / sqrt(K).

Counterpart of ``scripts/run_r5_s6wrapped_basin.py::sigma_stats``. For each
seed's run of ``python -m mvae_torch.matrix --only s6-wrapped`` it restores
the final checkpoint of ``runs/torch_matrix/s6-wrapped_mnist_s<seed>``,
encodes the first 2,048 test examples under the eval's fixed binarization
and prints one JSON line: K, the cap, the raw scale softplus(raw) (mean, max,
both over the cap), the share of rows with a coordinate above cap / 3 (where
the cap starts to bend the scale) and the capped scale's mean. It runs where
the checkpoints are (on the card, in the call that trained them).

    python scripts/torch_s6_sigma.py --seeds 11,0,7,19,23
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mvae_torch import (TrainConfig, Trainer, VAEConfig,  # noqa: E402
                        parse_components)
from mvae_torch.components.component import cap_sigma_positive_k  # noqa: E402
from mvae_torch.data import load_mnist  # noqa: E402
from mvae_torch.models import vae  # noqa: E402


def sigma_stats(trainer, n: int = 2048) -> dict:
    """The trained scale statistics of the single ``s`` component over the
    first ``n`` test examples."""
    cfg, params = trainer.model_cfg, trainer.params
    comp, cp = cfg.components[0], params["components"][0]
    rows = torch.arange(n, device=trainer.device)
    with torch.no_grad():
        x = trainer._binarize(trainer._test_data[:n], rows)
        feats = vae.encode(cfg, params, x)
        sigma_raw = torch.nn.functional.softplus(feats @ cp["w_sig"]
                                                 + cp["b_sig"])
        k = comp.curvature(cp)
        cap = math.pi / math.sqrt(max(float(k), 1e-12))
        capped = cap_sigma_positive_k(sigma_raw, k)
    return {"k": float(k), "cap_pi_over_sqrt_k": cap,
            "sigma_raw_mean": float(sigma_raw.mean()),
            "sigma_raw_max": float(sigma_raw.max()),
            "sigma_raw_over_cap_mean": float(sigma_raw.mean()) / cap,
            "sigma_raw_over_cap_max": float(sigma_raw.max()) / cap,
            "frac_rows_above_cap_third":
                float((sigma_raw > cap / 3).any(-1).float().mean()),
            "sigma_capped_mean": float(capped.mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="11,0,7,19,23")
    ap.add_argument("--run_root", default="runs/torch_matrix")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    ds = load_mnist()
    cfg = VAEConfig(parse_components("s6:wrapped"), ds.data_shape, "mlp",
                    h_dim=400)
    for seed in (int(s) for s in args.seeds.split(",")):
        run_dir = f"{args.run_root}/s6-wrapped_mnist_s{seed}"
        trainer = Trainer(cfg, ds, TrainConfig(batch_size=256, seed=seed,
                                               eval_binarize="fixed"),
                          run_dir, device=args.device)
        trainer.restore_checkpoint()
        print(json.dumps({"seed": seed, "step": trainer.step,
                          **sigma_stats(trainer)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
