"""The work counts of ``work.py`` and of the MLP family's reference
module against hand counts and against PyTorch's own count of the
program's plain step."""
from __future__ import annotations

import json

from torch.utils.flop_counter import FlopCounterMode

import generate
import work
from conftest import BENCH
from reference import vae


def test_counts_equal_hand_counts():
    # D, H, W, Z, B = 4, 3, 5, 2, 2 and 10 parameters
    step = vae.train_step(4, 3, 5, 2, 2, 10)
    assert step["gemm_macs"] == 3 * 2 * (12 + 15 + 6 + 12) == 270
    assert step["executed_macs"] == 270 - 2 * 12 == 246
    assert step["bytes"] == 4 * (8 * 10 + 2 * 2 * (2 * 4 + 3)) == 496
    assert vae.iwae_example_flops(4, 3, 5, 2, 3) == 2 * (12 + 15 + 3 * 18)
    td = work.train_decode(2, 2, 3, 4)
    assert td == {"flops": 2 * 2 * 18,
                  "bytes": 4 * (4 + 8 + 6 + 3 + 12 + 4 + 2 + 6 + 8)}
    db = work.decode_bce(3, 2, 2, 3, 4)
    assert db == {"flops": 2 * 3 * 2 * 18,
                  "bytes": 4 * (12 + 8 + 6 + 3 + 12 + 4 + 6)}
    peaks = {"float32_grade_tflops": 1e-12, "hbm_tbps": 1e-12}
    assert work.least_time_s(6, 4, peaks) == 6.0


def test_flagship_counts():
    # the flagship at batch 1024: 1,628.98 M multiply-adds a step
    assert vae.train_step(784, 400, 11, 8, 1024,
                          636397)["executed_macs"] == 1628979200
    assert work.decode_bce(125, 512, 8, 400, 784)["flops"] == 40550400000


def test_train_step_count_equals_the_flop_counter():
    """The program's plain step (CPU tensors: its decode as matmuls) at a
    small size executes exactly ``work.train_step``'s products."""
    import programs
    cfg = json.loads((BENCH / "configs/h2s2e2-mnist.json").read_text())
    cfg.update(h_dim=24, train_examples=32, test_examples=8)
    traffic = {"batch_size": 8}
    train, test = generate.dataset(cfg, 5, "cpu")
    tr = programs.build(cfg, traffic, 5, train, test, "cpu", "unused")
    perm, u, nz = generate.train_draws(vae, cfg, traffic, 5, 0, "cpu")
    with FlopCounterMode(display=False) as counter:
        tr._step_body(train[perm[0]], u[0], nz[0])
    n_params = sum(t.numel() for t in programs.flatten(tr.params).values())
    expect = vae.train_step(784, 24, 11, 8, 8, n_params)["executed_macs"]
    assert counter.get_total_flops() == 2 * expect
