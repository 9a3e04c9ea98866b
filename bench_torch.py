#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: VAE train steps/s on one CUDA card,
one JSON line last on stdout (``mvae_torch/bench.py`` says what it measures
and how its keys map to ``bench.py``'s).

    python3 bench_torch.py
    python3 bench_torch.py --steps 300 --repeats 2 --conv_steps 100
"""
import sys

from mvae_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
