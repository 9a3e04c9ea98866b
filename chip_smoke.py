#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py          # one CUDA card; exits non-zero on any failure

Phases:
 1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
    full-f32 matmuls (TF32 off);
 2. build every kernel of ``mvae_torch/kernels/csrc`` with nvcc (parallel:
    B1 tail_fwd, B2 decode_bce, B3 tail_bwd, B6 train_decode,
    B5 reparam_stereo, P2 reparam_chunk, B7 manifold_dist, B8
    roofline_probes; B4a and B4b
    live in the header B1 and B3 share) and, beside them, B5's previous
    design (``scripts/reparam_stereo_previous.cu``, ``PREVIOUS_REPARAM``),
    the compute twins' previous design (``scripts/twin_probes_previous.cu``,
    ``PREVIOUS_TWINS``), the tail kernels' previous design
    (``scripts/tail_previous``, ``PREVIOUS_TAIL``: every product on the
    warp-a-component geometry, each tile serial on one thread) and B5 built
    on its tiles, printing ptxas's registers, stack frame
    and spills of each kernel instantiation (B5's 24 one by one: n = 2, 3,
    6 and generic, one or two samples a thread, each curvature sign; those
    for n = 2, 3, 6 must spill nothing; P2's 8, its dimension classes 2, 3,
    6 and generic at one or two samples a thread, those for 2, 3, 6 with no
    spill; B8f's 8, n = 2, 3, 6 and generic at
    one or two samples a thread, those for n = 2, 3, 6 with no spill and
    no stack frame), the instructions of one accurate tanhf in the tanh
    probe's SASS loop (``roofline.tanh_instructions``, cuobjdump), which
    prices a transcendental in the kernels line's operation bounds, the
    instructions the stereographic twin's sqrt, reciprocal and exp steps
    issue on their common path (``roofline.transcendental_instructions``,
    from the price loops beside the probes), which price B8e's, and the
    SASS instructions a row of B8e's resident per-row loop issues on its
    common path
    (``roofline.twin_row_instructions``), at least a row's counted
    operations (``roofline.twin_stereo_row_ops``): no two output rows share
    a result; and the tail's sinf, cosf, logf and expf on their common path
    (``roofline.tail_transcendental_prices``), which price the tail
    kernels' operation bounds;
 3. the tail kernel (tail_fwd.cu) against ``tail_forward_ref`` at the
    flagship product h2,s2,e2, B = 512 and B = 1000 (ragged), random heads
    with large-|mu| rows and curvatures that put rows on both sides of the
    series window; then its time at B = 128 (the training call) and 512
    beside the row-per-thread kernels' (``_ROWWISE_US``);
 4. the IWAE decode kernel (decode_bce.cu: 3xTF32 on the tensor cores)
    and its previous design (``scripts/decode_bce_previous.cu``,
    ``PREVIOUS_DECODE``) against ``decode_bce_ref`` and float64 at (S=125,
    Z=8, B=512, H=400, D=784) and at B = 272 (the test split's last batch),
    ptxas's registers and spills of both, then at both IWAE cells' chunks
    and the roofline shape (``DECODE_TURNS``) its time, its previous
    design's and the two cuBLAS FP32 SGEMMs' by graph replay in turns
    (kernel, previous, library, library, previous, kernel), and its image
    launch's own time;
 5. the slice end to end: ``Trainer.evaluate_elbo`` (its decode through
    B6, on by default on the card) and
    ``Trainer.evaluate_log_likelihood`` (IWAE-500) of the h2,s2,e2 MLP VAE
    at h_dim 400 over the 10,000-example MNIST test split (the synthetic
    stand-in when no data is present), launch counts read right after,
    then both recomputed on the same noise with the plain versions (pass
    means, and per example on one batch), and a profile of where each
    pass spends the device's time;
 6. the tail backward kernel (tail_bwd.cu) against ``tail_backward_ref``
    (autograd through the plain forward) at B = 128, 1024 and 1000, the
    curvature sets and large-|mu| rows of phase 3, random cotangents; its
    time at B = 128 beside the row-per-thread kernel's recorded one;
 7. the training decode kernel (train_decode.cu: 3xTF32 on the tensor
    cores, W2 by the Tensor Memory Accelerator) against
    ``train_decode_ref`` at B = 1, 127, 128, 512, 1000, 1024 and (Z, H, D)
    = (8, 400, 784), (2, 33, 98), (16, 600, 784), (8, 1200, 784), two
    calls and ten CUDA-graph replays bit for bit; then at the flagship's
    widths and B = 128, 512, 1024 its time and the two cuBLAS FP32 SGEMMs'
    in turns, its plain version, and its floors from the card's calibrated
    rates (``roofline.train_decode_floors``) with its share of them;
 8. training end to end: ``Trainer.fit`` of the flagship for 2 epochs of
    468 steps at batch 128 (burn-in 1), B1, B3 and B6 every step (B6 is on
    by default for CUDA parameters), a test ELBO per epoch and IWAE-500 at
    the end, launch counts read right after (the optimizer kernel once a
    step), and one backward of the
    tail under autograd at the training batch: one B3 launch and no sum
    op (B3 folds the curvature gradient); then the step rate in turns
    with B6 off and on (off, on, on, off), each turn's steps/s and device
    busy share on one line with the verdict that sets the switch's
    default on the card;
 9. the same training with ``MVAE_FUSED_TRAIN_DECODER=0`` (one epoch, the
    plain decode, B6 never launched);
10. a plain replay of training: one step's gradients, and 50 steps'
    losses each from the same state, through the kernels against the plain
    versions, on the same weights and generator seed (and the gap of two
    runs left to run apart, printed beside its rounding-level floor);
11. a checkpoint saved on the card and restored into a fresh Trainer;
12. the stereographic tile (B4a) inside B1 and B3 against the plain
    versions (and B1 bit for bit against the tail's previous design, B3
    printed bit-equal or not) for the tables of d2,p2,e2, u6 and p6 at
    B = 512 and B = 128:
    curvatures +-1 and +-1e-3 (for u also 0), rows with a saturated sigma
    cap, with mu_tan = 0 and eps = 0, and a point at the ball's rim; then
    B1 at B = 128 and 512 and B3 at B = 128 timed for d2,p2,e2 and u6
    beside the row-per-thread kernels' times;
13. the IWAE chunk reparam kernel (reparam_stereo.cu, B5) against
    ``wrapped_reparam_stereo_ref`` at (S, B, n) = (125, 512, 2) and
    (125, 512, 6), signs -1, 0, +1, wraps 0 and 1, and bit for bit
    against its previous design and against itself built on the tail's
    previous tiles on each case; then its time in turns with each (kernel,
    previous, previous, kernel) at (125, 512,
    2) sign +1 and -1, (125, 512, 6) sign 0 and the production chunk (125,
    2048, 6) sign -1 over rotating buffer sets, faster on every row; its
    operation bound is the operations its plain version needs on the
    timed row's inputs, each point on the branch it takes and the wrap
    branches' sine once (``roofline.reparam_ops``), each arithmetic op one
    FMA issue slot at 67 TFLOP/s and each transcendental phase 2's tanhf
    instruction count of them;
13b. the IWAE chunk reparam of the flagship's kinds (reparam_chunk.cu,
    P2) against ``reparam_chunk_ref`` with float64 beside it at the
    production chunk (S, B) = (125, 512) for the tables of h2,s2,e2 (scalar
    and diagonal scales), d2,p2,e2 (its e2), h3,e3 and h2,e3,s2 (the
    generic instantiation), and at ragged (7, 33); on each, bit for bit
    against B1 (``tail_forward``) on the same rows with each example's heads
    repeated over its samples; then at the flagship's chunk its time by
    ``roofline.measure`` in turns with the per-component path it replaces
    (kernel, previous, previous, kernel), its plain version's time and
    its bytes bound;
14. the stereographic family end to end, d2,p2,e2 at h_dim 400 with
    learnable curvature: test ELBO and IWAE-500 over the 10,000-example
    test split through B1 (+B4a), B5 and B2 with launch counts (20, 160,
    80), recomputed on the same noise with the plain versions (pass means
    and per example); one training epoch of 468 steps at batch 128 with
    burn-in off so that both curvatures move (B1 and B3 once per step);
    the plain replay of phase 10 (one step's gradients, 50 same-state
    steps); profiles of the IWAE pass and of a training epoch;
15. u6 at h_dim 400: two runs of 150 steps from K = +1e-3 and K = -1e-3
    (finite losses on both sides of K = 0) and IWAE-500 on 1,024 examples
    through the sign-0 instance of B4a and B5;
16. the embedded-sphere tile (B4b) inside B1 and B3 against the plain
    versions (B1 bit for bit against the previous design) for the tables
    of s6:wrapped and s3:wrapped,h2,e2 at B = 512
    and B = 128: curvatures 1, 1e-3, 4, rows with a saturated sigma cap,
    with mu_tan = 0 and eps = 0, with the mean at the antipode of mu0; then
    the rows where the tile's K-dependent floors are taken, held to the
    float32 plain version directly; then B1 at B = 128 and 512 and B3 at
    B = 128 timed for s6:wrapped beside the row-per-thread kernels'; then
    B1 and B3 in turns with their previous design (new, previous,
    previous, new) on every tail row of ``roofline.TAIL_ROWS`` (B3 at
    B = 256 for u6 and s6:wrapped among them), B1's outputs bit for bit,
    with each redesign's factor against its target printed and the
    flagship's kernels within 3% or not;
17. the distance kernels (manifold_dist.cu, B7a and B7b) against their
    plain versions at (B, n) = (1,048,576, 128) and (1000, 6), K in
    {-1, -1e-3, 0, 1e-3, 1} for B7a, with device time, bytes bound and the
    plain composition's time; then the distance entry points driven as a
    user would (counts read around that run), gradients included;
18. the spherical family end to end, s6:wrapped at h_dim 400 with learnable
    curvature: test ELBO and IWAE-500 over the 10,000-example test split
    through B1 (+B4b) and B2 with launch counts, recomputed on the same
    noise with the plain versions (pass means and per example); one
    training epoch of 468 steps at batch 128 with burn-in off (B1 and B3
    once per step); the plain replay of phase 10; profiles;
19. s6 (vMF by rejection, m = 7) at h_dim 400: 150 training steps with
    finite losses and IWAE-500 on 1,024 examples; p2:vmf,e2: the ELBO of
    one batch; ``generate(16)`` and ``reconstruct`` on the card;
20. the roofline harness (``kernels/roofline.py``, B8a-B8f in
    ``roofline_probes.cu``): the triad, FMA and tanh (repeat 1 and 32),
    reduce and transpose probes at (1,048,576, 128), both distance
    skeletons and the stereographic twin (resident and streaming) there, the
    reparam skeleton and twin at (S, B, n) = (125, 2048, 6) (the twin also
    at (125, 512, 2) and at a generic n, (125, 512, 5)), the tail's
    I/O skeleton (both grids) for h2,s2,e2, d2,p2,e2, u6 and s6:wrapped at
    B = 128, 512 and 1000, each against its plain version; then
    ``roofline.main()`` with the probes' launch counts read around it: the
    calibrated rates (each within its window: at most 105% of the data
    sheet, TF32 among them; the triad timed in turns with ``torch.add(x, y,
    out=o)``, their time ratio printed) and the rows of B7a, B7b, B5 and B2
    at the
    reference's shapes and of B1 (B = 128, 512) and B3 (B = 128) for those
    four products, none above 105% of its binding floor or its peak (B2's:
    its 3xTF32 products at the calibrated TF32 rate, its FP32 part, its
    bytes; its share of the TF32 peak; B5's: its skeleton or its plain
    version's operations, arithmetic at the calibrated FMA rate and
    transcendentals at the calibrated tanh rate, its twin beside them;
    B1's and B3's: the tail skeleton, the lower of its two grids for a
    product on the split geometry, or the plain version's operations at
    the calibrated FMA rate, each transcendental at its SASS count);
    then each row's kernel held to its plain version on the row's own
    inputs (B7a, B7b and B5 at the tolerances of phases 17 and 13, float64
    beside them; B2 within 1e-3 nats per row as in phase 4); then the
    compute twins in turns with their previous design (new, previous,
    previous, new): B8e resident and streaming on B7a's row inputs, B8f at
    the production chunk, sign -1, over B5's rotating buffer sets (each
    previous design held to the plain version too; each new twin faster),
    and B8f in turns with B5 (twin, B5, B5, twin), no slower than B5; B5's
    row (B5, its skeleton, B8f) at 20 and at 100 calls a graph, each in
    turns (the row's own timing takes ``roofline.REPARAM_ROW_CALLS``, 100);
    and each twin's share of its bound (B8e's with the tail's
    transcendentals at their SASS prices). The launch
    counts of this phase count what ran on the card: ``roofline.measure``
    captures its launches in a CUDA graph and counts each replay;
21. ``Trainer.fit(profile_epochs=1)`` of a 20-step flagship epoch writes a
    Chrome trace that holds the card's kernels (B1 among them);
22. the Riemannian normal, d6:riemannian with the model matrix's flags
    (fixed curvature) at MNIST width (D = 784, h_dim 400, batch 128):
    ``log_partition`` in float32 on the card against float64 over a grid
    of (n, sigma, c) that holds sigma sqrt(c) ~ 0.05 and n = 200; 100
    training steps (the decode through B6, the tail plain PyTorch) with
    their rate and the device's busy share; IWAE-500 over 1,024 test
    examples (B2 in 125-sample launches) with its rate and busy share;
    per-example ELBO and IWAE against the plain versions on the same noise;
    one step's gradients of a learnable-curvature instance (dr/dK on the
    card) against the plain path; the rejection sampler's acceptance rate
    and mean rounds on a batch's posterior scales;
23. the conv VAE, u6 with learnable curvature at the synthetic CIFAR's
    size (32 x 32 x 3, h_dim 400, batch 128): every convolution of a
    training step and of an IWAE chunk, forward and backward, sees cuDNN's
    TF32 off while the global flag is PyTorch's default (on); 100 training
    steps (B1 and B3 once a step) and IWAE-500 over 1,024 test examples
    (B5 per 20-sample chunk), B2 and B6 never launched, with rates and
    busy shares; per-example checks as phase 22's, and the per-example
    IWAE gap of the same evaluation with TF32 on (why it is off);
24. B6's routing by batch (C4): flagship training at MNIST width with B6
    on and off in turns (on, off, off, on) at batch 64 (a (2, x) mesh
    rank's share of 128), 256 (the model matrix's), 512 and 1024, each turn
    ``C4_STEPS`` steps (shortened epochs) after a warm-up of each trainer,
    its steps/s and a profiled turn's device busy share printed with the
    card, and the verdict at each batch beside what "auto" routes there;
25. the ("data", "model") mesh (``mvae_torch.parallel``): four gloo ranks
    on the one card. One training step of the flagship at full width
    (batch 128, learnable K) on fixed noise and binarization uniforms on
    meshes (2, 1), (1, 2) and (2, 2) against the one-device
    ``Trainer._train_step`` on the same inputs (the loss within 1e-4 nats,
    every gradient within rtol 1e-3 / atol 5e-4); IWAE-500 of h2,s2,e2 and
    d2,p2,e2 over 1,024 test examples on (2, 2) on one noise block against
    the one-device ``log_likelihood`` on it (1e-3 nats per example); each
    rank's launch counts of B1, B3, B6, B5 and B2 (zero of a kernel its
    path runs fails the phase); a (2, 1) rank's profiled epoch (steps/s,
    busy); one epoch of ``--mesh 2,1`` through the CLI;
26. the reference's compiled programs as CUDA graphs
    (``mvae_torch/train/graphs.py``): two flagship epochs (burn-in 1)
    graphed and eager from one seed on the same weights, Adam state,
    generator and statistics bit for bit (else the measured reason and the
    training contract: 50 steps' losses within 0.05 nats), one capture
    across the burn-in boundary with the curvature frozen then moving, B1 /
    B3 / B6 counted once a step through the replays; graphed training after
    a checkpoint restore and after a forced non-finite rewind equal to
    uninterrupted training; the flagship, d2,p2,e2, s6:wrapped, s6,
    d6:riemannian and the conv u6 each trained two short epochs and
    evaluated (ELBO, IWAE-500) through graphs, each program captured once,
    finite, rising, every routed kernel launched; per-example ELBO and
    IWAE-500 on explicit noise graphed against eager (1e-3 nats, bit for
    bit expected); then in turns (eager, graph, graph, eager) the flagship's
    steps/s at batch 128 and 1024, d6:riemannian's, and the ELBO and
    IWAE-500 passes' examples/s of the flagship and s6:wrapped over the test
    split and of the conv u6 over 1,024 examples (the control), each turn
    of a pass from one generator seed (values within 1e-3 nats), with the
    busy shares of profiled turns;
27. the matrix runner (``mvae_torch/matrix.py``): ``matrix.run_row`` for
    the flagship and ``d2,p2,e2`` at the matrix's batch 256, one epoch,
    seed 11, IWAE-500 over 1,024 test examples; each row ``OK`` with a
    finite LL, on the graph path with one capture of each program, its
    kernels launched (the flagship: B1, B3, B6 in training, B1 in the ELBO
    pass, B2 in the IWAE; ``d2,p2,e2``: B1 and B3 with the B4a tile, B5
    and B2 in the IWAE), the summary file written; each row's training
    steps/s printed;
28. the mesh under NCCL: a (1, 1) mesh, one NCCL process on the card
    (NCCL takes one card a rank), through ``scripts/torch_mesh_cards.py``'s
    ``mesh_checks``: the rank graphed on NCCL; one step against one device
    (loss within 1e-4 nats, gradients within the training contract) with
    B1, B3 and B6 launched; IWAE-500 of the flagship and ``d2,p2,e2`` over
    1,024 test examples within 1e-3 nats a row of one device, B2 (and B5)
    launched; two 100-step epochs across burn-in graphed against the eager
    rank bit for bit (weights, Adam state, generator, statistics), B1, B3
    and B6 once a step through the replays, the ELBO and IWAE passes graphed
    against eager bit for bit, one capture of each program. On a machine
    with four cards or more the script's four-card checks run too; on fewer
    a line says they did not run and names their committed results;
29. the benchmark: ``python bench_torch.py --steps 300 --repeats 2
    --conv_steps 100`` in a fresh process (its calibration first, as in a
    bench run): its last line parsed and printed under ``[bench]``; no
    ``"error"`` (its numbers are finite: it prints with
    ``allow_nan=False``), ``pct_of_step_ceiling`` and ``step_mfu_pct`` in
    (0, 100] (the latter where the card has a quoted FP32 peak), the priced
    MACs equal to the counted ones, the flagship step graphed with B1, B3 and
    B6 launched once a step; and, where the bf16 row at h_dim 1024 routes
    its decode to B6, B6 at (Z, H, D) = (8, 1024, 784) against its plain
    version (phase 7's checks, batches 1 to 1024);
30. the optimizer kernel (``csrc/adam.cu``) at the flagship's and
    d2,p2,e2's leaves at full width, and at the flagship's in bfloat16:
    three steps against its plain version on the card, the first in
    burn-in (the learnable curvatures held), each from the kernel's state
    (float32: the parameters' change within 1e-4, the moments within 1e-6;
    bfloat16: within one ulp of the update's largest magnitude), Adam's
    count, the global step and the ticket read after each, one launch a
    step; its time by CUDA-graph replay back to back and after an
    L2 flush, beside its bytes bound (28 bytes a parameter at 3.35 TB/s), in
    turns (kernel, replaced layer, replaced layer, kernel) with the layer it
    replaced (the curvature mask's launches, ``torch.optim.Adam`` foreach
    and capturable, the step counter) and beside the library yardstick (the
    same with ``fused=True``), and the plain version's time; then the
    kernels of one eager step of the replaced layer, named by the
    operators that launched them;
31. one JSON line of kernel numbers, then the result line.

Every ``Trainer.train_one_epoch``, ``evaluate_elbo`` and
``evaluate_log_likelihood`` on the card replays graphs (phase 26 holds
them to the eager loops); each recomputation through the plain versions
(``plain_kernels``) must launch no kernel, so no plain pass replays a
graph captured through the kernels.

Where float32 does not resolve a value (a point at the K < 0 ball's rim,
a radius within an ulp of the K > 0 injectivity shell), the stereographic
checks apply the rule stated for B3 below: such entries must be finite and
no farther from the float64 plain version than ten times the float32 plain
version is.

B3 is held to the float32 backward contract of the reference (rtol 1e-3,
atol 5e-4 on the raw gradient; rtol 2e-3 on the batch-summed curvature
gradient) on every row where the float32 plain backward resolves the
gradient, i.e. lies within a tenth of that contract of its own float64
evaluation. On the other rows (large hyperbolic radius, where the
cancellation-free Lorentz forms amplify float32 rounding in the reverse
sweep by 1e4 and more) no float32 backward can be held to that contract
against another; there the kernel must be finite and no farther from the
float64 backward than ten times the float32 plain version is.

A kernel's ``ms`` is its device time per call by ``roofline.measure``:
CUDA events around the replay of a CUDA graph of its calls, so no host
launch cost is in it (a wrapper that launches several kernels is timed as
the whole graph per call); the CUPTI trace median of its main kernel in
another replay is printed beside it as the cross-check. ``library_ms`` is
timed the same way. The plain versions and the host-side walls are timed
by CUDA events around a loop of calls (``time_ms``).

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import ctypes
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from mvae_torch import TrainConfig, Trainer, VAEConfig, parse_components
from mvae_torch.data import load_cifar, load_mnist
from mvae_torch.kernels import (_build, decoder_kernels, launches,
                                manifold_kernels, optim_kernels, roofline,
                                tail_kernels)
from mvae_torch.models import route, vae
from mvae_torch.parallel import make_mesh, shard_batch, shard_params
from mvae_torch.parallel.collectives import gather_model
from mvae_torch.parallel.launch import World
from mvae_torch.train import NonFiniteError, graphs
from mvae_torch.train.trainer import _leaves, make_optimizer

# NVIDIA H100 SXM data sheet (dense, 700 W): HBM rate, FP32 FMA and TF32
# tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12

SPEC = "h2,s2,e2"
STEREO_SPEC = "d2,p2,e2"
SPHERE_SPEC = "s6:wrapped"

# The device times of the previous, row-per-thread tail kernels, us per
# call (PERF.md section 6: NVIDIA H100 80GB HBM3, 700.00 W; CUDA-graph
# replay), printed beside this run's: (kernel, spec, batch) -> us. B1 at
# the training batch has no recorded time.
_ROWWISE_US = {("tail_fwd", SPEC, 512): 5.65, ("tail_bwd", SPEC, 128): 9.30,
           ("tail_fwd", STEREO_SPEC, 512): 12.77,
           ("tail_bwd", STEREO_SPEC, 128): 36.79,
           ("tail_fwd", "u6", 512): 11.69, ("tail_bwd", "u6", 128): 33.63,
           ("tail_fwd", SPHERE_SPEC, 512): 11.31,
           ("tail_bwd", SPHERE_SPEC, 128): 34.72}


def _rowwise(kernel: str, spec: str, B: int) -> str:
    us = _ROWWISE_US.get((kernel, spec, B))
    return ("row-per-thread: not recorded" if us is None
            else f"row-per-thread: {us:.2f} us")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int, warm: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls
    after ``warm`` warm-up calls."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, kernel: str, iters: int = 50) -> tuple[float, str]:
    """(device ms per call of ``fn``, its CUPTI cross-check as text) by
    ``roofline.measure``: CUDA events around the replay of a CUDA graph of
    ``iters`` calls, and the trace median of ``kernel`` (the main device
    kernel ``fn`` launches) in another replay."""
    t = roofline.measure(fn, kernel, iters)
    trace = ("no trace records" if t.trace_us is None
             else f"CUPTI trace median {t.trace_us:.2f} us")
    return t.us / 1e3, trace


def library_ms(fn, iters: int = 20) -> float:
    """Device ms per call of a library composition, by CUDA-graph replay
    as ``kernel_ms``."""
    return roofline.measure(fn, iters=iters, graph=True).us / 1e3


# Training-step layers by device kernel name (first match wins); the GEMMs
# of the encoder, the fused head and the decoder, forward and backward, all
# go to cuBLAS and are one row.
_LAYERS = (("B1 tail_fwd", ("tail_fwd_kernel",)),
           ("B3 tail_bwd", ("tail_bwd_kernel",)),
           ("B6 train_decode", ("train_decode_kernel",)),
           ("GEMMs (cuBLAS, fwd + bwd)", ("gemm", "gemv", "xmma", "cutlass")),
           ("Adam (csrc/adam.cu)", ("adam_kernel",)),
           ("random draws (binarize, noise, perm)", ("distribution", "philox",
                                                     "randperm", "random")),
           ("reductions (BCE sums, means, bias grads)", ("reduce_kernel",)))


def profile_pass(what: str, fn, layers: bool = False) -> float:
    """Device busy share and the kernels that take the device's time over
    one call of ``fn`` (CUPTI trace; host-side profiling off); with
    ``layers``, that time grouped by the training step's layers."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"[profile] {what}: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100.0 * busy / wall:.1f}%), {sum(r[1] for r in rows)} device "
          f"ops")
    for us, count, key in rows[:8]:
        print(f"[profile]   {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
    if layers:
        groups = {}
        for us, count, key in rows:
            name = next((n for n, pats in _LAYERS
                         if any(p in key.lower() for p in pats)),
                        "other elementwise (ReLU, softplus, BCE terms, ...)")
            t, c = groups.get(name, (0.0, 0))
            groups[name] = (t + us, c + count)
        for name, (us, count) in sorted(groups.items(),
                                        key=lambda kv: -kv[1][0]):
            print(f"[layers]   {us / 1e3:9.3f} ms {count:6d} launches "
                  f"({100.0 * us / 1e6 / busy:5.1f}% of busy)  {name}")
    return busy / wall


def _plain_reparam(eps, mu, sigma, k, wraps=1, sign=0, out=None, z_off=0):
    """``wrapped_reparam_stereo_ref`` behind the kernel wrapper's interface
    (z written into the caller's buffer)."""
    z, lq, lp = manifold_kernels.wrapped_reparam_stereo_ref(
        eps, mu, sigma, k, wraps=wraps, sign=sign)
    if out is None:
        return z, lq, lp
    zt = out[:, z_off:z_off + z.shape[1]]
    zt.copy_(z)
    return zt, lq, lp


# the plain version of each kernel wrapper of ``launches.WRAPPERS`` but
# Adam's (the optimizer's step on the card is the same in every pass)
_PLAIN = {"tail_forward": tail_kernels.tail_forward_ref,
          "tail_backward": tail_kernels.tail_backward_ref,
          "reparam_chunk_t": tail_kernels.reparam_chunk_plain,
          "wrapped_reparam_stereo_t": _plain_reparam,
          "fused_decode_bce_t": decoder_kernels.decode_bce_ref,
          "train_decode_fwd": decoder_kernels.train_decode_ref}


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version (the reference
    recomputations of phases 5 and 10), and check that the block launched
    no kernel: a trainer that replayed a graph captured through the
    kernels would (its replays add to the counts)."""
    swapped = [(mod, name, getattr(mod, name))
               for mod, name in launches.WRAPPERS if name in _PLAIN]
    before = _read_counts()
    for mod, name, _ in swapped:
        setattr(mod, name, _PLAIN[name])
    try:
        yield
    finally:
        for mod, name, fn in swapped:
            setattr(mod, name, fn)
    after = _read_counts()
    check(after == before, f"a plain recomputation launched no kernel: "
          f"{before} -> {after}")


@contextlib.contextmanager
def train_decoder(on: bool):
    """MVAE_FUSED_TRAIN_DECODER set for the block (read at every forward)."""
    old = os.environ.get("MVAE_FUSED_TRAIN_DECODER")
    os.environ["MVAE_FUSED_TRAIN_DECODER"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MVAE_FUSED_TRAIN_DECODER")
        else:
            os.environ["MVAE_FUSED_TRAIN_DECODER"] = old


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 is False")
    return card


# B5's previous design: a thread per (sample, example) through the generic
# draw, the per-example scalars recomputed for every sample, the sign taken
# at run time
PREVIOUS_REPARAM = (Path(__file__).resolve().parent / "scripts"
                    / "reparam_stereo_previous.cu")
# The compute twins' previous design (B8e: a warp a row, the resident tile
# read from L2 for every output row; B8f: one generic kernel with the
# coordinates in per-thread arrays)
PREVIOUS_TWINS = (Path(__file__).resolve().parent / "scripts"
                  / "twin_probes_previous.cu")
# B2's previous design (64 examples a block; W2 loaded, split and stored by
# the threads that multiply; h resident in shared memory)
PREVIOUS_DECODE = (Path(__file__).resolve().parent / "scripts"
                   / "decode_bce_previous.cu")
# The tail kernels' previous design (B1, B3 with the B4a / B4b tiles as they
# stood at commit b875f52: every product on the warp-a-component geometry,
# each tile serial on one thread), and B5 built on its tiles
PREVIOUS_TAIL = Path(__file__).resolve().parent / "scripts" / "tail_previous"
# filled by phase_build: the previous tail design's launch entries, and the
# SASS instructions of the tail's transcendentals
# (roofline.tail_transcendental_prices)
_PREVIOUS: dict = {}
_TAIL_PRICES: dict = {}


def _reparam_on_previous_tiles() -> Path:
    """B5's source beside the previous design's tiles (``PREVIOUS_TAIL``):
    B5 as it was built before the split tail design."""
    d = _build.BUILD_DIR / "reparam_previous_tiles"
    d.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "reparam_stereo.cu", d)
    shutil.copy(PREVIOUS_TAIL / "tail_tiles.cuh", d)
    return d / "reparam_stereo.cu"


def ptxas_entries(report: str) -> dict:
    """Kernel (mangled name) -> registers, stack frame and spill bytes, from
    an nvcc -Xptxas -v report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m[1]
            out[name] = {}
        elif name and "stack frame" in line:
            st, so, sl = map(int, re.findall(r"(\d+) bytes", line)[:3])
            out[name].update(stack=st, spill_stores=so, spill_loads=sl)
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line)[1])
    return out


def reparam_instantiations(report: str) -> dict:
    """B5's instantiations (N, samples a thread, sign; 2: the sign at run
    time) -> ptxas's numbers."""
    out = {}
    for name, v in ptxas_entries(report).items():
        m = re.search(r"reparam_stereo_kernelILi(\d+)ELi(\d+)ELin?(\d+)E",
                      name)
        if m:
            sign = int(m[3]) * (-1 if "ELin" in name else 1)
            out[(int(m[1]), int(m[2]), sign)] = v
    return out


def twin_reparam_instantiations(report: str) -> dict:
    """B8f's instantiations (N, samples a thread) -> ptxas's numbers."""
    out = {}
    for name, v in ptxas_entries(report).items():
        m = re.search(r"twin_reparam_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            out[(int(m[1]), int(m[2]))] = v
    return out


def phase_build() -> dict:
    """Every kernel source built (one nvcc each, together with B5's and the
    compute twins' previous designs); ptxas's report printed; B5's, P2's
    and B8f's register-resident instantiations (n = 2, 3, 6) checked to
    spill nothing (B8f's to use no stack frame either); the instructions of one
    accurate tanhf in the tanh probe and of each transcendental step of
    B8e's tail (on its common path) counted from their SASS; B8e's
    resident per-row loop counted from its SASS and checked to hold at
    least a row's counted operations."""
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        prev = pool.submit(_build.build_variants, {
            "reparam_previous": (PREVIOUS_REPARAM,
                                 _build.EXTRA_FLAGS["reparam_stereo"]),
            "twins_previous": (PREVIOUS_TWINS,
                               _build.EXTRA_FLAGS["roofline_probes"]),
            "tail_fwd_previous": (PREVIOUS_TAIL / "tail_fwd.cu",
                                  _build.EXTRA_FLAGS["tail_fwd"]),
            "tail_bwd_previous": (PREVIOUS_TAIL / "tail_bwd.cu",
                                  _build.EXTRA_FLAGS["tail_bwd"]),
            "reparam_previous_tiles": (_reparam_on_previous_tiles(),
                                       _build.EXTRA_FLAGS["reparam_stereo"]),
            "decode_previous": (PREVIOUS_DECODE,
                                _build.EXTRA_FLAGS["decode_bce"])},
            _build.BUILD_DIR / "previous")
        reports = _build.build_all()
        variants = prev.result()
    prev_lib, prev_report = variants["reparam_previous"]
    twins_lib, twins_report = variants["twins_previous"]
    decode_prev = variants["decode_previous"][0].decode_bce_launch
    decode_prev.restype = ctypes.c_int
    decode_prev.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    _PREVIOUS.update(
        fwd=tail_kernels.bind_tail(variants["tail_fwd_previous"][0])["fwd"],
        bwd=tail_kernels.bind_tail(variants["tail_bwd_previous"][0])["bwd"],
        decode=decode_prev,
        decode_reports={"B2": reports["decode_bce"],
                        "B2, previous design": variants["decode_previous"][1]})
    print(f"[build] {len(reports)} kernels and the previous designs of B2, "
          f"B5, the twins and the tail kernels (and B5 on the previous tail "
          f"tiles) in {time.time() - t0:.1f} s")
    for name, text in reports.items():
        for line in _build.ptxas_lines(text):
            print(f"[build] {name}: {line}")
    inst = reparam_instantiations(reports["reparam_stereo"])
    for (n, spt, sign), v in sorted(inst.items()):
        print(f"[build] reparam_stereo <n={n or 'generic'}, {spt} sample(s) "
              f"a thread, sign {sign:+d}>: {v['registers']} registers, "
              f"{v['stack']} bytes stack frame, {v['spill_stores']} / "
              f"{v['spill_loads']} bytes spilled (stores / loads)")
    check(len(inst) == 24, f"B5 built in 24 instantiations: {sorted(inst)}")
    check(all(v["spill_stores"] == 0 and v["spill_loads"] == 0
              for (n, _, _), v in inst.items() if n),
          "B5's instantiations for n = 2, 3, 6 spill nothing")
    chunk = {}
    for name, v in ptxas_entries(reports["reparam_chunk"]).items():
        m = re.search(r"reparam_chunk_kernelILi(\d+)EEv", name)
        if m:
            chunk[int(m[1])] = v
    for d, v in sorted(chunk.items()):
        print(f"[build] reparam_chunk <class {d or 'generic'}>: "
              f"{v['registers']} registers, {v['stack']} bytes stack frame, "
              f"{v['spill_stores']} / {v['spill_loads']} bytes spilled "
              f"(stores / loads)")
    check(sorted(chunk) == [0, 2],
          f"P2 built in 2 instantiations: {sorted(chunk)}")
    check(all(v["spill_stores"] == 0 and v["spill_loads"] == 0
              for d, v in chunk.items() if d),
          "P2's instantiation for the class 2 spills nothing")
    for v in ptxas_entries(prev_report).values():
        print(f"[build] reparam_stereo, previous design (generic, a sample "
              f"a thread, sign at run time): {v['registers']} registers, "
              f"{v['stack']} bytes stack frame, {v['spill_stores']} / "
              f"{v['spill_loads']} bytes spilled")
    for v in ptxas_entries(twins_report).values():
        print(f"[build] twins, previous design: {v['registers']} registers, "
              f"{v['stack']} bytes stack frame, {v['spill_stores']} / "
              f"{v['spill_loads']} bytes spilled")
    twin = twin_reparam_instantiations(reports["roofline_probes"])
    for (n, spt), v in sorted(twin.items()):
        print(f"[build] twin_reparam <n={n or 'generic'}, {spt} sample(s) a "
              f"thread>: {v['registers']} registers, {v['stack']} bytes "
              f"stack frame, {v['spill_stores']} / {v['spill_loads']} bytes "
              f"spilled (stores / loads)")
    check(len(twin) == 8, f"B8f built in 8 instantiations: {sorted(twin)}")
    check(all(v["spill_stores"] == 0 and v["spill_loads"] == 0
              and v["stack"] == 0 for (n, _), v in twin.items() if n),
          "B8f's instantiations for n = 2, 3, 6 spill nothing and use no "
          "stack frame")
    tanh = roofline.tanh_instructions()
    print(f"[build] tanh probe: {tanh['instructions']} instructions in its "
          f"loop with {tanh['tanh']} tanh, {tanh['per_tanh']:.2f} a tanh "
          f"(cuobjdump -sass)")
    prices = roofline.transcendental_instructions()
    _TAIL_PRICES.update(roofline.tail_transcendental_prices())
    print("[build] the tail kernels' transcendentals as built (cuobjdump "
          "-sass, common path; 'other' at the tanh probe's count): "
          + ", ".join(f"{k} {v:.2f}" for k, v in _TAIL_PRICES.items()))
    row = roofline.twin_row_instructions()
    ops = roofline.twin_stereo_row_ops(roofline.N, prices)
    print(f"[build] B8e tail's transcendental steps as built (cuobjdump "
          f"-sass, common path, a loop of 32 steps less one of 16): sqrt "
          f"{prices['sqrt']:.2f}, reciprocal {prices['rcp']:.2f}, exp "
          f"{prices['exp']:.2f} instructions; a row's six "
          f"{prices['tail']:.2f}: {ops:.2f} counted operations a row of "
          f"{roofline.N} (was {roofline.twin_stereo_row_ops(roofline.N)})")
    print(f"[build] B8e resident per-row loop: {row['instructions']} "
          f"instructions on its common path for {row['rows']} output "
          f"row(s) a lane, {row['per_row']:.2f} a row ({row['ffma']} FFMA, "
          f"{row['mufu']} MUFU) against {ops:.2f} counted operations a row")
    check(row["per_row"] >= ops, "B8e's resident loop runs at least a "
                                 "row's counted operations for each row")
    return {"previous_reparam": manifold_kernels.bind_reparam(prev_lib),
            "reparam_previous_tiles": manifold_kernels.bind_reparam(
                variants["reparam_previous_tiles"][0]),
            "previous_twin_stereo": roofline.bind_probe(
                twins_lib, "twin_stereo_launch"),
            "previous_twin_reparam": roofline.bind_probe(
                twins_lib, "twin_reparam_launch"),
            "tanh_per": tanh["per_tanh"], "twin_prices": prices,
            "twin_row": row}


def ops_ms(ops: dict, per_tanh: float) -> float:
    """ms of an operation count (``roofline.reparam_ops``) at the data
    sheet's FP32 rate: an arithmetic op one FMA issue slot, a transcendental
    the instructions of one accurate tanhf in SASS, each such a slot (an
    FMA's two FLOP)."""
    return (2 * (ops["arithmetic"] + per_tanh * ops["transcendental"])
            / FP32_FLOPS_PER_S * 1e3)


def phase_tail(comps, gen) -> dict:
    W = sum(c.head_width for c in comps)
    nc = len(comps)
    mu_cols, off = [], 0
    for c in comps:
        mu_cols += range(off, off + c.dim)
        off += c.head_width
    worst = 0.0
    for B in (512, 1000):
        # curvatures that put rows on both sides of the |K r^2| < 1e-2
        # series window (|mu| ~ 0.1 at K = -1, ~ 1 at K = -1e-2)
        for kset in ((-1.0, 1.0, 0.0), (-1e-2, 1e-2, 0.0), (-0.25, 4.0, 0.0)):
            raw = torch.randn(B, W, generator=gen, device="cuda")
            raw[::13, mu_cols] *= 3.0             # large |mu| rows
            eps = tail_kernels.draw_noise(comps, (B,), raw, gen)
            k = torch.tensor(kset, device="cuda")
            z, aux = tail_kernels.tail_forward(comps, raw, eps, k)
            zr, auxr = tail_kernels.tail_forward_ref(comps, raw, eps, k)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(zr).all() and torch.isfinite(auxr).all()),
                  f"plain tail finite at B={B}, k={kset}")
            check(bool(torch.isfinite(z).all() and torch.isfinite(aux).all()),
                  f"tail kernel finite at B={B}, k={kset}")
            dz = (z - zr).abs()
            check(bool((dz <= 1e-5 * (1.0 + zr.abs())).all()),
                  f"tail z within 1e-5 (1+|z|) at B={B}, k={kset}: "
                  f"max {dz.max().item():.3g}")
            da = (aux - auxr).abs().max().item()
            check(da <= 1e-4, f"tail aux within 1e-4 at B={B}, k={kset}: "
                              f"{da:.3g}")
            worst = max(worst, dz.max().item(), da)
    k = torch.tensor((-1.0, 1.0, 0.0), device="cuda")
    rows = {}
    for B in (128, 512):
        raw = torch.randn(B, W, generator=gen, device="cuda")
        eps = tail_kernels.draw_noise(comps, (B,), raw, gen)
        rows[B] = _tail_time("tail_fwd", SPEC, comps, (raw, eps, k), worst)
    return rows[512]


def _tail_time(name: str, spec: str, comps, args, err: float,
               source: str = "mvae_torch/kernels/csrc/tail_fwd.cu",
               line: int = 704) -> dict:
    """Time B1 (``args`` = raw, eps, k) or B3 (``args`` with dz, daux) on
    ``args`` beside its plain version, its bounds from this run's inputs
    (bytes over the data sheet's HBM rate; the plain version's operations,
    ``roofline.tail_op_split``, in FMA issue slots over its FP32 rate, each
    transcendental at its SASS instructions, ``_TAIL_PRICES``) and the
    row-per-thread kernel's time: one row of the kernels line."""
    bwd = len(args) == 5
    fn = tail_kernels.tail_backward if bwd else tail_kernels.tail_forward
    ref = (tail_kernels.tail_backward_ref if bwd
           else tail_kernels.tail_forward_ref)
    B = args[0].shape[0]
    ms, trace = kernel_ms(lambda: fn(comps, *args),
                          "tail_bwd_kernel" if bwd else "tail_fwd_kernel",
                          100)
    plain_ms = time_ms(lambda: ref(comps, *args), 10 if bwd else 20)
    nbytes = roofline.tail_bytes(comps, B, bwd)
    split = roofline.tail_op_split(comps, *args)
    slots = roofline.tail_priced_ops(split, _TAIL_PRICES)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * slots / FP32_FLOPS_PER_S * 1e3
    kern = "tail_bwd" if bwd else "tail_fwd"
    print(f"[{name}] {spec} {'B3' if bwd else 'B1'} at B={B}: kernel "
          f"{ms * 1e3:.2f} us ({_rowwise(kern, spec, B)}; graph events; "
          f"{trace}), plain {plain_ms * 1e3:.1f} us, bytes bound "
          f"{bytes_ms * 1e3:.4f} us ({nbytes} B), ops bound "
          f"{ops_ms * 1e3:.4f} us ({split['arithmetic']} arithmetic ops and "
          f"{split['by_name']} transcendentals: {slots:.0f} FMA slots)")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": f"mvae_tpu/kernels/tail_kernels.py:{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def _decode_inputs(S, Z, B, H, D, gen):
    dev = "cuda"
    zt = torch.randn(S, Z, B, generator=gen, device=dev)
    xt = (torch.rand(D, B, generator=gen, device=dev) < 0.3).float()
    w1 = math.sqrt(2.0 / Z) * torch.randn(Z, H, generator=gen, device=dev)
    b1 = 0.1 * torch.randn(H, generator=gen, device=dev)
    w2 = math.sqrt(2.0 / H) * torch.randn(H, D, generator=gen, device=dev)
    b2 = 0.1 * torch.randn(D, generator=gen, device=dev)
    return zt, xt, w1, b1, w2, b2


def _previous_decode(args):
    """B2's previous design (``PREVIOUS_DECODE``) on ``args``: a call that
    launches it once into its own output."""
    zt, xt, w1 = args[:3]
    S, Z, B = zt.shape
    D, H = xt.shape[0], w1.shape[1]
    out = torch.empty((S, B), dtype=torch.float32, device="cuda")
    ptrs = [t.data_ptr() for t in args] + [out.data_ptr()]

    def call():
        _build.check(_PREVIOUS["decode"](
            *ptrs, S, Z, B, H, D, torch.cuda.current_stream().cuda_stream),
            "previous decode_bce_launch")
        return out
    return call


# B2's shapes timed in turns with its previous design: both IWAE cells'
# chunks and the roofline row's shape
DECODE_TURNS = ((125, 8, 512, 400, 784), (125, 6, 512, 400, 784),
                (16, 8, 2048, 400, 784))


def phase_decode(gen) -> dict:
    """B2 and its previous design against the plain version (1e-3 nats per
    row) and float64 at the production IWAE chunk and at the test split's
    last batch; ptxas's registers and spills of both; then, at each of
    ``DECODE_TURNS``, B2 / previous / previous / B2 in turns by graph
    replay beside the two cuBLAS FP32 SGEMMs (SGEMMs / SGEMMs between the
    turns), and the image launch's own time."""
    S, Z, B, H, D = 125, 8, 512, 400, 784
    err = 0.0
    for name, report in _PREVIOUS["decode_reports"].items():
        for kern, v in ptxas_entries(report).items():
            print(f"[decode_bce] {name}: {kern}: {v.get('registers')} "
                  f"registers, {v.get('stack')} bytes stack frame, "
                  f"{v.get('spill_stores')} / {v.get('spill_loads')} bytes "
                  f"spilled (stores / loads)")
    # the production chunk draws from ``gen`` alone, so that the phases
    # after this one see the same inputs whatever else this phase checks
    ragged = _decode_inputs(S, Z, 272, H, D,
                            torch.Generator(device="cuda").manual_seed(272))
    full = _decode_inputs(S, Z, B, H, D, gen)
    for b, args in ((272, ragged), (B, full)):
        out = decoder_kernels.fused_decode_bce_t(*args)
        prev = _previous_decode(args)()
        ref = decoder_kernels.decode_bce_ref(*args)
        ref64 = decoder_kernels.decode_bce_ref(*[a.double() for a in args])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"decode kernel finite, B={b}")
        e = (out - ref).abs().max().item()
        ep = (prev - ref).abs().max().item()
        check(e <= 1e-3, f"decode within 1e-3 nats per row at B={b}: {e:.3g}")
        check(ep <= 1e-3, f"decode's previous design within 1e-3 nats per "
                          f"row at B={b}: {ep:.3g}")
        err = max(err, e)
        print(f"[decode_bce] B={b}: max |err| {e:.3g} nats per row against "
              f"the FP32 plain version (previous design {ep:.3g}); kernel vs "
              f"f64 {(out - ref64).abs().max().item():.3g}, FP32 plain vs "
              f"f64 {(ref - ref64).abs().max().item():.3g}")
    row = None
    for shape in DECODE_TURNS:
        args = (full if shape == (S, Z, B, H, D) else _decode_inputs(
            *shape, torch.Generator(device="cuda").manual_seed(sum(shape))))
        zt, xt, w1, b1, w2, b2 = args
        lib_args = roofline.two_sgemm_operands(zt, w1, b1, w2)
        prev = _previous_decode(args)

        def kern(fn):
            return roofline.measure(fn, "decode_bce_kernel", 20)

        def lib():
            return roofline.measure(lambda: roofline.two_sgemms(*lib_args),
                                    iters=20, graph=True)

        new = functools.partial(decoder_kernels.fused_decode_bce_t, *args)
        turns = [kern(new), kern(prev), lib(), lib(), kern(prev), kern(new)]
        t = roofline.mean_timing(turns[0], turns[5])
        tp = roofline.mean_timing(turns[1], turns[4])
        ms, prev_ms = t.us / 1e3, tp.us / 1e3
        lib_ms = roofline.mean_timing(turns[2], turns[3]).us / 1e3
        image_us = roofline.measure(
            lambda: decoder_kernels.decode_w_image(w1, b1, w2), iters=20,
            graph=True).us
        s_, z_, b_, h_, d_ = shape
        fl = roofline.decode_flops(s_, b_, z_, h_, d_)
        ops_ms = fl["tensor_3xtf32"] / TF32_FLOPS_PER_S * 1e3
        trace = None if t.trace_us is None else round(t.trace_us, 1)
        print(f"[decode_bce] (S, Z, B, H, D) = {shape}, in turns B2 / "
              f"previous / SGEMMs / SGEMMs / previous / B2: "
              f"{', '.join(f'{x.us:.1f}' for x in turns)} us (graph "
              f"events); B2 {ms:.4f} ms (CUPTI trace median of the main "
              f"launch {trace} us; its image launch alone {image_us:.2f} "
              f"us), previous "
              f"design {prev_ms:.4f} ms: B2 {prev_ms / ms:.2f}x faster; two "
              f"cuBLAS FP32 SGEMMs {lib_ms:.4f} ms: B2 {lib_ms / ms:.2f}x "
              f"faster; {fl['tensor_3xtf32'] / ms / 1e9:.1f} TFLOP/s of "
              f"3xTF32 products, {100 * ops_ms / ms:.1f}% of 495 TFLOP/s")
        if shape == (S, Z, B, H, D):
            row = (ms, lib_ms, fl, args)
    ms, lib_ms, fl, args = row
    zt, xt, w1, b1, w2, b2 = args
    plain_ms = time_ms(
        lambda: decoder_kernels.decode_bce_ref(zt, xt, w1, b1, w2, b2), 10)
    nbytes = roofline.decode_bytes(S, B, Z, H, D)
    ops_ms = fl["tensor_3xtf32"] / TF32_FLOPS_PER_S * 1e3
    fp32_ms = (fl["fp32_part"] + fl["transcendentals"]) / FP32_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, fp32_ms, bytes_ms)
    print(f"[decode_bce] (S, Z, B, H, D) = {(S, Z, B, H, D)}: plain "
          f"{plain_ms:.3f} ms; bounds: 3xTF32 {ops_ms:.4f} ms "
          f"({fl['tensor_3xtf32'] / 1e9:.1f} GFLOP at 495 TFLOP/s), FP32 "
          f"part {fp32_ms * 1e3:.1f} us, bytes {bytes_ms * 1e3:.2f} us; the "
          f"FP32 SIMT floor it replaces "
          f"{fl['total'] / FP32_FLOPS_PER_S * 1e3:.4f} ms")
    return {"name": "decode_bce", "route": "cuda",
            "source": "mvae_torch/kernels/csrc/decode_bce.cu",
            "replaces": "mvae_tpu/kernels/decoder_kernels.py:154",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= bound_ms else "operations",
            "library_ms": lib_ms}


def _evaluate(trainer, seed):
    trainer.generator.manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.time()
    elbo = trainer.evaluate_elbo("test")["elbo"]
    t1 = time.time()
    ll = trainer.evaluate_log_likelihood("test")
    t2 = time.time()
    return elbo, ll, t1 - t0, t2 - t1


@torch.no_grad()
def per_example_check(cfg, trainer, n_samples: int, x=None) -> None:
    """Per-example ELBO and IWAE values of one 512-example batch (``x``, or
    the binarized first 512 test examples) through the kernels and through
    the plain versions, on the same explicit noise: a pass mean in float32
    cannot resolve differences below ~6e-5 nats."""
    if x is None:
        x = (trainer._test_data[:512] > 0.5).float()
    gen = torch.Generator(device="cuda").manual_seed(7)
    noise_elbo = tail_kernels.draw_noise(cfg.components, (512,), x, gen)
    noise_ll = tail_kernels.draw_noise(cfg.components, (n_samples, 512), x,
                                       gen)

    def both():
        return (vae.elbo(cfg, trainer.params, x, noise=noise_elbo)[0],
                vae.log_likelihood(cfg, trainer.params, x, n_samples,
                                   noise=noise_ll))

    elbo_k, ll_k = both()
    with plain_kernels():
        elbo_p, ll_p = both()
    d_elbo = (elbo_k - elbo_p).abs().max().item()
    d_ll = (ll_k - ll_p).abs().max().item()
    print(f"[e2e] per example, 512 examples, same noise: max |dELBO| "
          f"{d_elbo:.3g}, max |dLL| {d_ll:.3g} nats")
    check(d_elbo <= 1e-3 and d_ll <= 1e-3,
          "per-example ELBO and IWAE LL match the plain versions")


def phase_end_to_end(spec: str = SPEC) -> dict:
    """Test ELBO and IWAE-500 of ``spec`` at full width over the test
    split through the kernels, with launch counts, against the plain
    versions on the same noise."""
    ds = load_mnist()
    cfg = VAEConfig(parse_components(spec, fixed_curvature=False),
                    ds.data_shape, "mlp", h_dim=400)
    tc = TrainConfig(seed=0)
    trainer = Trainer(cfg, ds, tc)
    n_reparam = sum(c.posterior == "wrapped" and c.manifold.kind in "dpu"
                    for c in cfg.components)
    n_tiles = sum(tail_kernels.chunk_supported(c) for c in cfg.components)
    check(trainer.fused_paths["train_tail"]["active"]
          and trainer.fused_paths["iwae_decoder"]["active"]
          and sum(r["active"] for r in trainer.fused_paths["iwae_reparam"])
          == n_reparam + n_tiles, f"the kernels are routed: "
          f"{trainer.fused_paths}")
    n = len(ds.test)
    _evaluate(trainer, 1)  # warm-up pass (cuBLAS handles, allocator)

    n_chunk = int(n_tiles > 0)
    counted = {"tail_fwd": tail_kernels.tail_forward,
               "decode_bce": decoder_kernels.fused_decode_bce_t,
               "reparam_stereo": manifold_kernels.wrapped_reparam_stereo_t,
               "reparam_chunk": tail_kernels.reparam_chunk_t,
               "train_decode": decoder_kernels.train_decode_bce}
    for fn in counted.values():
        fn.launches = 0
    elbo, ll, t_elbo, t_ll = _evaluate(trainer, tc.seed)
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"[e2e] {spec} h_dim 400 on {n} test examples "
          f"({'synthetic' if ds.synthetic else 'real'} MNIST): ELBO {elbo:.4f} "
          f"in {t_elbo:.3f} s ({n / t_elbo:.0f} ex/s); IWAE-"
          f"{tc.likelihood_n} LL {ll:.4f} in {t_ll:.3f} s "
          f"({n / t_ll:.0f} ex/s); launches {launches}")
    check(math.isfinite(elbo) and math.isfinite(ll), "finite ELBO and LL")
    check(launches["tail_fwd"] >= 20, "tail kernel launched >= 20 times")
    check(launches["decode_bce"] >= 80, "decode kernel launched >= 80 times")
    check(launches["train_decode"] >= 20, "the ELBO pass's decode through B6 "
          "(on by default on the card) >= 20 times")
    check(launches["reparam_stereo"] == 80 * n_reparam,
          f"chunk reparam kernel launched {80 * n_reparam} times "
          "(20 batches x 4 chunks x its components)")
    check(launches["reparam_chunk"] == 80 * n_chunk,
          f"P2 launched {80 * n_chunk} times (20 batches x 4 chunks, once "
          "a chunk for its components)")

    with plain_kernels():
        elbo_p, ll_p, t_elbo_p, t_ll_p = _evaluate(trainer, tc.seed)
    print(f"[e2e] plain versions on the same noise: ELBO {elbo_p:.4f} "
          f"({t_elbo_p:.3f} s), IWAE LL {ll_p:.4f} ({t_ll_p:.3f} s); "
          f"|dELBO| {abs(elbo - elbo_p):.3g}, |dLL| {abs(ll - ll_p):.3g}")
    check(abs(elbo - elbo_p) <= 1e-3, "ELBO matches the plain versions")
    check(abs(ll - ll_p) <= 1e-3, "IWAE LL matches the plain versions")
    per_example_check(cfg, trainer, tc.likelihood_n)

    profile_pass(f"{spec} ELBO pass, 10000 examples",
                 lambda: trainer.evaluate_elbo("test"))
    profile_pass(f"{spec} IWAE-500 pass, 1024 examples",
                 lambda: trainer.evaluate_log_likelihood("test", 1024))
    profile_pass(f"{spec} IWAE-500 pass, 10000 examples",
                 lambda: trainer.evaluate_log_likelihood("test"))
    return launches


def _bwd_inputs(comps, B, kset, gen):
    W = sum(c.head_width for c in comps)
    Z = sum(c.ambient_dim for c in comps)
    nc = len(comps)
    mu_cols, off = [], 0
    for c in comps:
        mu_cols += range(off, off + c.dim)
        off += c.head_width
    raw = torch.randn(B, W, generator=gen, device="cuda")
    raw[::13, mu_cols] *= 3.0                     # large |mu| rows
    eps = tail_kernels.draw_noise(comps, (B,), raw, gen)
    k = torch.tensor(kset, device="cuda")
    dz = torch.randn(B, Z, generator=gen, device="cuda")
    daux = torch.randn(B, nc + 2, generator=gen, device="cuda")
    return raw, eps, k, dz, daux


def phase_tail_bwd(comps, gen) -> dict:
    """B3 against autograd through the plain forward (see the module
    docstring for the rule on rows the float32 backward cannot resolve)."""
    comps = tuple(comps)
    worst = worst_ratio = 0.0
    for B in (128, 1024, 1000):
        for kset in ((-1.0, 1.0, 0.0), (-1e-2, 1e-2, 0.0), (-0.25, 4.0, 0.0)):
            args = _bwd_inputs(comps, B, kset, gen)
            draw, dk, _ = tail_kernels.tail_backward(comps, *args)
            pr, pk, _ = tail_kernels.tail_backward_ref(comps, *args)
            p64, pk64, _ = tail_kernels.tail_backward_ref(
                comps, *[t.double() for t in args])
            torch.cuda.synchronize()
            what = f"B={B}, k={kset}"
            check(bool(torch.isfinite(draw).all() and torch.isfinite(dk).all()),
                  f"tail backward finite at {what}")
            tol = 1e-3 * pr.abs() + 5e-4
            ratio = ((draw - pr).abs() / tol).amax(1)
            plain_err = (pr.double() - p64).abs()
            res = (plain_err / tol).amax(1) <= 0.1   # float32-resolvable
            rr = ratio[res].max().item()
            check(rr <= 1.0, f"B3 raw gradient within rtol 1e-3 / atol 5e-4 "
                             f"on resolvable rows at {what}: {rr:.3g}")
            far = ((draw.double() - p64).abs().amax(1)
                   / (plain_err.amax(1) + tol.amax(1)))
            rest = far[~res].max().item() if bool((~res).any()) else 0.0
            check(rest <= 10.0, f"B3 on unresolvable rows no farther from "
                                f"float64 than 10x the plain version at "
                                f"{what}: {rest:.3g}")
            dks, pks = dk[res].sum(0), pk[res].sum(0)
            kr = ((dks - pks).abs() / (2e-3 * pks.abs() + 5e-4)).max().item()
            check(kr <= 1.0, f"B3 curvature gradient within rtol 2e-3 at "
                             f"{what}: {kr:.3g}")
            kfar = ((dk.sum(0).double() - pk64.sum(0)).abs()
                    / ((pk.sum(0).double() - pk64.sum(0)).abs()
                       + 2e-3 * pk.sum(0).abs() + 5e-4)).max().item()
            check(kfar <= 10.0, f"B3 curvature sum no farther from float64 "
                                f"than 10x the plain version at {what}")
            err = (draw - pr)[res].abs().max().item()
            worst = max(worst, err)
            worst_ratio = max(worst_ratio, rr, kr)
            print(f"[tail_bwd] {what}: {int(res.sum())}/{B} rows resolvable;"
                  f" max |err| {err:.3g} ({rr:.3g} of tol), curvature "
                  f"{kr:.3g} of tol; other rows {rest:.3g}, all rows max "
                  f"|err| {(draw - pr).abs().max().item():.3g}")
    print(f"[tail_bwd] max err {worst:.3g} ({worst_ratio:.3g} of tol)")
    args = _bwd_inputs(comps, 128, (-1.0, 1.0, 0.0), gen)
    row = _tail_time("tail_bwd", SPEC, comps, args, worst,
                     "mvae_torch/kernels/csrc/tail_bwd.cu", 735)
    return row


# B6's shapes (tests/test_torch_decoder_kernels.py): the flagship's widths;
# a narrow ragged D (4-byte copies, scalar h and gl stores); a wide H; an
# H whose W2 slice streams through the ring
TRAIN_DECODE_SHAPES = ((8, 400, 784), (2, 33, 98), (16, 600, 784),
                       (8, 1200, 784))
TRAIN_DECODE_BATCHES = (1, 127, 128, 512, 1000, 1024)


def _train_decode_weights(Z, H, D, gen):
    dev = "cuda"
    return (math.sqrt(2.0 / Z) * torch.randn(Z, H, generator=gen, device=dev),
            0.1 * torch.randn(H, generator=gen, device=dev),
            math.sqrt(2.0 / H) * torch.randn(H, D, generator=gen, device=dev),
            0.1 * torch.randn(D, generator=gen, device=dev))


def _train_decode_batch(B, Z, D, gen):
    return (torch.randn(B, Z, generator=gen, device="cuda"),
            (torch.rand(B, D, generator=gen, device="cuda") < 0.3).float())


def _train_decode_held(Z, H, D, gen) -> float:
    """B6 against ``train_decode_ref`` at every batch of
    ``TRAIN_DECODE_BATCHES`` (ll within 1e-3 nats per row, h and gl within
    1e-5 (1 + |ref|)), two calls bit for bit, and ten replays of a CUDA
    graph of it bit for bit against a direct call (its row-tile counters
    are back at 0 after every launch). Returns the largest ll error."""
    w = _train_decode_weights(Z, H, D, gen)
    worst = 0.0
    for B in TRAIN_DECODE_BATCHES:
        z, x = _train_decode_batch(B, Z, D, gen)
        out = decoder_kernels.train_decode_fwd(z, x, *w)
        again = decoder_kernels.train_decode_fwd(z, x, *w)
        llr, hr, glr = decoder_kernels.train_decode_ref(z, x, *w)
        torch.cuda.synchronize()
        ll, h, gl = out
        what = f"B6 at (B, Z, H, D) = {(B, Z, H, D)}"
        check(bool(torch.isfinite(ll).all() and torch.isfinite(gl).all()),
              f"{what} finite")
        e_ll = (ll - llr).abs().max().item()
        e_h = ((h - hr).abs() / (1 + hr.abs())).max().item()
        e_gl = ((gl - glr).abs() / (1 + glr.abs())).max().item()
        check(e_ll <= 1e-3, f"{what}: ll within 1e-3 nats per row: {e_ll:.3g}")
        check(e_h <= 1e-5 and e_gl <= 1e-5,
              f"{what}: h and gl within 1e-5 (1+|ref|): {e_h:.3g}, {e_gl:.3g}")
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"{what}: two calls bit for bit")
        worst = max(worst, e_ll)
        print(f"[train_decode] {(B, Z, H, D)}: max |dll| {e_ll:.3g} nats, h "
              f"{e_h:.3g}, gl {e_gl:.3g} (relative to 1+|ref|); two calls "
              f"equal")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        cap = decoder_kernels.train_decode_fwd(z, x, *w)
    for _ in range(10):
        for t in cap:
            t.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(cap, out)),
              f"B6 graph replay at {(B, Z, H, D)} bit for bit")
    print(f"[train_decode] {(B, Z, H, D)}: 10 graph replays equal a direct "
          f"call bit for bit")
    return worst


def phase_train_decode(gen) -> dict:
    """B6 (train_decode.cu) held to its plain version at
    ``TRAIN_DECODE_SHAPES`` x ``TRAIN_DECODE_BATCHES`` with the determinism
    checks; then at the flagship's widths and B = 128, 512 and 1024 its time
    and the two cuBLAS FP32 SGEMMs' in turns (kernel, SGEMMs, SGEMMs,
    kernel) by ``roofline.measure``, its plain version, its data-sheet
    bound and its floors from the card's calibrated rates."""
    worst = max(_train_decode_held(Z, H, D, gen)
                for Z, H, D in TRAIN_DECODE_SHAPES)
    cal = roofline.calibrate()
    print(f"[train_decode] calibrated: FMA {cal['fma_tflops']:.2f} TFLOP/s, "
          f"triad {cal['stream_gbps']:.0f} GB/s, TF32 "
          f"{cal['tf32_tflops']:.1f} TFLOP/s, tanh {cal['tanh_gops']:.0f} "
          f"Gop/s")
    Z, H, D = TRAIN_DECODE_SHAPES[0]
    w1, b1, w2, b2 = _train_decode_weights(Z, H, D, gen)
    row = {}
    for B in (128, 512, 1024):
        z, x = _train_decode_batch(B, Z, D, gen)
        h = torch.relu(z @ w1 + b1)

        def kern():
            return roofline.measure(
                lambda: decoder_kernels.train_decode_fwd(z, x, w1, b1, w2,
                                                         b2),
                "train_decode_kernel", 100)

        def lib():
            return roofline.measure(lambda: (torch.mm(z, w1), torch.mm(h, w2)),
                                    iters=100, graph=True)

        turns = [kern(), lib(), lib(), kern()]
        t = roofline.mean_timing(turns[0], turns[3])
        lib_us = roofline.mean_timing(turns[1], turns[2]).us
        plain_ms = time_ms(
            lambda: decoder_kernels.train_decode_ref(z, x, w1, b1, w2, b2),
            100)
        fl = roofline.train_decode_flops(B, Z, H, D)
        nbytes = roofline.train_decode_bytes(B, Z, H, D)
        floors = roofline.train_decode_floors(B, Z, H, D, cal)
        fp32_floor = max(floors["fp32"], floors["bytes_stream"])
        built = roofline.binding(t.us, {k: floors[k] for k in (
            "tensor_3xtf32", "fp32_part", "bytes_stream")})
        ops_ms = max(fl["tensor_3xtf32"] / TF32_FLOPS_PER_S,
                     (fl["fp32_part"] + fl["transcendentals"])
                     / FP32_FLOPS_PER_S) * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[train_decode] B={B}: in turns kernel / SGEMMs / SGEMMs / "
              f"kernel: {', '.join(f'{u.us:.2f}' for u in turns)} us (graph "
              f"events); kernel {t.us:.2f} us (CUPTI trace median "
              f"{t.trace_us if t.trace_us is None else round(t.trace_us, 2)}"
              f" us), two cuBLAS FP32 SGEMMs {lib_us:.2f} us: the kernel "
              f"{lib_us / t.us:.2f}x faster; plain {plain_ms * 1e3:.1f} us; "
              f"floors from the calibrated rates: FP32 (2 B (Z H + H D) = "
              f"{fl['gemm'] / 1e6:.1f} MFLOP at the FMA rate) "
              f"{floors['fp32']:.3f} us, bytes ({nbytes} B at the triad rate) "
              f"{floors['bytes_stream']:.3f} us -> binding {fp32_floor:.3f} us"
              f", {100.0 * fp32_floor / t.us:.1f}% of binding; as built "
              f"(3xTF32 {floors['tensor_3xtf32']:.3f} us, FP32 part "
              f"{floors['fp32_part']:.3f} us, bytes) "
              f"{built['binding_floor_us']:.3f} us ({built['bound_by']}), "
              f"{built['pct_of_binding']:.1f}%; data sheet: operations "
              f"{ops_ms * 1e3:.3f} us, bytes {bytes_ms * 1e3:.3f} us")
        if B == 128:
            row = {"name": "train_decode", "route": "cuda",
                   "source": "mvae_torch/kernels/csrc/train_decode.cu",
                   "replaces": "mvae_tpu/kernels/decoder_kernels.py:254",
                   "max_abs_err": worst, "ms": t.us / 1e3,
                   "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
                   "bound_by": "operations" if ops_ms >= bytes_ms
                   else "bytes", "library_ms": lib_us / 1e3}
    return row


def _flagship(ds, run_dir, spec=SPEC, **tc) -> Trainer:
    """A full-width (h_dim 400) trainer with learnable curvature."""
    cfg = VAEConfig(parse_components(spec, fixed_curvature=False),
                    ds.data_shape, "mlp", h_dim=400)
    return Trainer(cfg, ds, TrainConfig(**tc), run_dir)


def _epoch_rate(trainer, epoch: int, epochs: int = 1) -> float:
    """Steps/s over the wall of ``epochs`` epochs from ``epoch``, ended by
    a device sync."""
    torch.cuda.synchronize()
    t0 = time.time()
    for e in range(epoch, epoch + epochs):
        trainer.train_one_epoch(e)
    torch.cuda.synchronize()
    return epochs * trainer.steps_per_epoch / (time.time() - t0)


def phase_train(ds, tmp) -> tuple[dict, Trainer]:
    """Flagship training end to end (B1 + B3 + B6 every step: B6 is on by
    default for CUDA parameters), then the step rate with B6 off and on in
    turns (off, on, on, off; each of two epochs, after a warm-up epoch of
    each trainer right before): the turns back to back unprofiled
    (steps/s), then one epoch each profiled (device busy share), and the
    verdict that sets the switch's default on the card: B6 on faster than
    off in both turns."""
    trainer = _flagship(ds, f"{tmp}/train", seed=0, epochs=2,
                        burnin_epochs=1)
    with torch.no_grad():
        c0 = [float(cp["c_param"]) for cp in trainer.params["components"]
              if "c_param" in cp]
        k0 = {n: float(c.curvature(cp)) for n, c, cp in zip(
            trainer.component_names, trainer.model_cfg.components,
            trainer.params["components"])}
    check(trainer.fused_paths["train_tail"]["active"]
          and trainer.fused_paths["train_decoder"]["active"],
          f"training routed through B1/B3 and B6 (on by default on the "
          f"card): {trainer.fused_paths}")
    for fn in (tail_kernels.tail_forward, tail_kernels.tail_backward,
               decoder_kernels.train_decode_bce, optim_kernels.adam):
        fn.launches = 0
    result = trainer.fit(verbose=True, ll_max_examples=2048)
    launches = {"tail_fwd": tail_kernels.tail_forward.launches,
                "tail_bwd": tail_kernels.tail_backward.launches,
                "train_decode": decoder_kernels.train_decode_bce.launches,
                "adam": optim_kernels.adam.launches}
    steps = trainer.step
    print(f"[train] {SPEC} h_dim 400, batch 128, {steps} steps "
          f"({'synthetic' if ds.synthetic else 'real'} MNIST): "
          f"{result['train_steps_per_sec']:.1f} train steps/s over the "
          f"epochs' wall, IWAE-500 on 2048 test examples "
          f"{result['test/log_likelihood_iwae']:.4f}; launches {launches}")
    hist = result["history"]
    for rec in hist:
        check(all(math.isfinite(v) for v in rec.values()),
              f"finite statistics in epoch {rec['epoch']}")
    check(math.isfinite(result["test/log_likelihood_iwae"]), "finite IWAE")
    check(hist[1]["train/elbo"] > hist[0]["train/elbo"],
          f"train ELBO rises: {hist[0]['train/elbo']:.3f} -> "
          f"{hist[1]['train/elbo']:.3f}")
    for n in ("h2#0", "s2#1"):
        check(hist[0][f"train/curvature/{n}"] == k0[n],
              f"curvature {n} frozen through burn-in")
        check(hist[1][f"train/curvature/{n}"] != k0[n],
              f"curvature {n} moves after burn-in")
    c1 = [float(cp["c_param"].detach()) for cp in
          trainer.params["components"] if "c_param" in cp]
    print(f"[train] curvature K {k0} -> "
          f"{ {n: hist[1][f'train/curvature/{n}'] for n in k0} }; "
          f"c_param {c0} -> {c1}")
    check(launches["tail_bwd"] == steps, "B3 launched once per step")
    check(launches["tail_fwd"] >= steps, "B1 launched at least once a step")
    check(launches["train_decode"] >= steps,
          "B6 on by default on the card: launched every step")
    check(launches["adam"] == steps, f"adam.cu launched once per step: "
          f"{launches['adam']} launches, {steps} steps")
    _tail_fn_backward_ops(trainer.model_cfg.components)

    other = _flagship(ds, f"{tmp}/rate", seed=0, burnin_epochs=0)
    order = ((trainer, False), (other, True), (other, True), (trainer, False))
    for tr, on in order[:2]:              # an epoch of each first: warm-up
        with train_decoder(on):
            _epoch_rate(tr, 8)
    rates = []
    for turn, (tr, on) in enumerate(order):
        with train_decoder(on):
            rates.append(_epoch_rate(tr, 10 + 2 * turn, epochs=2))
    busy = []
    for turn, (tr, on) in enumerate(order):
        with train_decoder(on):
            busy.append(profile_pass(
                f"train epoch ({trainer.steps_per_epoch} steps), turn "
                f"{turn + 1}, B6 {'on' if on else 'off'}",
                lambda: tr.train_one_epoch(30 + turn), layers=turn < 2))
    on_rates = [r for (_, on), r in zip(order, rates) if on]
    off_rates = [r for (_, on), r in zip(order, rates) if not on]
    faster = min(on_rates) > max(off_rates)
    default = route.route(trainer.model_cfg, trainer.params).train_decoder
    print("[train] B6 off/on in turns, steps/s (two unprofiled epochs a "
          "turn, back to back) and device busy share (an epoch a turn, "
          "profiled): "
          + "; ".join(f"turn {i + 1} B6 {'on' if on else 'off'} {r:.1f} "
                      f"steps/s, busy {100.0 * b:.1f}%"
                      for i, ((_, on), r, b) in enumerate(zip(order, rates,
                                                              busy)))
          + f" -> B6 on faster than off in both turns: "
            f"{'yes' if faster else 'no'}; 'auto' on CUDA is "
            f"{'on' if default else 'off'}")
    return launches, trainer


def _tail_fn_backward_ops(comps) -> None:
    """One backward of ``_TailFn`` (the tail under autograd) at the training
    batch: the aten ops it issues, recorded by a dispatch mode, hold no sum
    (B3 folds the curvature gradient in its one launch)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        names: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.names.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    comps = tuple(comps)
    raw, eps, k, dz, daux = _bwd_inputs(comps, 128, (-1.0, 1.0, 0.0),
                                        torch.Generator(device="cuda")
                                        .manual_seed(5))
    raw.requires_grad_(True)
    k.requires_grad_(True)
    z, aux = tail_kernels._TailFn.apply(comps, raw, eps, k)
    before = tail_kernels.tail_backward.launches
    with Ops():
        torch.autograd.backward((z, aux), (dz, daux))
    torch.cuda.synchronize()
    sums = [n for n in Ops.names if "sum" in n]
    b3 = tail_kernels.tail_backward.launches - before
    print(f"[train] one backward of _TailFn at B=128: {b3} B3 launch, "
          f"{len(sums)} sum ops, ops issued {sorted(set(Ops.names))}")
    check(b3 == 1 and not sums and Ops.names,
          "the tail's backward is one B3 launch with no sum after it")


def phase_train_plain_decoder(ds, tmp) -> None:
    """One epoch of flagship training with MVAE_FUSED_TRAIN_DECODER=0 set
    before the Trainer is built: the plain decode, B6 never launched."""
    with train_decoder(False):
        trainer = _flagship(ds, f"{tmp}/plain_dec", seed=0, epochs=1,
                            burnin_epochs=1)
        check(not trainer.fused_paths["train_decoder"]["active"],
              f"B6 off with the switch at 0: "
              f"{trainer.fused_paths['train_decoder']}")
        for fn in (tail_kernels.tail_backward,
                   decoder_kernels.train_decode_bce):
            fn.launches = 0
        result = trainer.fit(verbose=True, ll_max_examples=512)
        launches = {"tail_bwd": tail_kernels.tail_backward.launches,
                    "train_decode": decoder_kernels.train_decode_bce.launches}
    steps = trainer.step
    print(f"[train, B6 off] {steps} steps: "
          f"{result['train_steps_per_sec']:.1f} train steps/s (first epoch, "
          f"warm-up included); launches {launches}; train ELBO "
          f"{result['history'][0]['train/elbo']:.4f}")
    check(launches["train_decode"] == 0, "B6 not launched with the switch off")
    check(launches["tail_bwd"] == steps, "B3 launched once per step")
    check(all(math.isfinite(v) for v in result["history"][0].values()),
          "finite statistics with the plain decode")


def _grads(trainer, x, noise):
    trainer.opt.zero_grad()
    loss, _ = vae.loss_fn(trainer.model_cfg, trainer.params, x, 1.0, noise)
    loss.backward()
    return [t.grad.detach().clone() for t in _leaves(trainer.params)]


def _free_run(ds, tmp, name, kern_b6, kern_kernels, perm, steps=50):
    """Max per-step |d loss| of two trainers from one seed run side by side
    for ``steps`` steps: one as given, the other all plain with B6 off."""
    a = _flagship(ds, f"{tmp}/{name}a", seed=5, burnin_epochs=0)
    b = _flagship(ds, f"{tmp}/{name}b", seed=5, burnin_epochs=0)
    bs = a.tc.batch_size
    worst = 0.0
    for s in range(steps):
        i = s % a.steps_per_epoch
        xb = a._train_data[perm[i * bs:(i + 1) * bs]]
        with train_decoder(kern_b6), (contextlib.nullcontext() if kern_kernels
                                      else plain_kernels()):
            sa = a._train_step(xb)
        with train_decoder(False), plain_kernels():
            sb = b._train_step(xb)
        worst = max(worst, (sa["elbo"] - sb["elbo"]).abs().item())
    return worst


def phase_replay(ds, tmp, spec: str = SPEC, b6: bool = True,
                 free_run: bool = True) -> None:
    """Training of ``spec`` through the kernels (B1, B3, and B6 when
    ``b6``) against the plain versions (B6 off, autograd decode), from the
    same weights and seed.

    The per-step check is teacher-forced: before each of the 50 steps the
    plain trainer takes the kernel trainer's parameters, Adam state and
    generator state, so each step compares the two paths on one training
    state. Two trainers left to run apart separate by whatever differs
    between them at the rounding level (Adam's normalized step amplifies
    it): that gap is printed with the same gap between two plain runs that
    differ only in the summation order of the decoder's backward."""
    kern = _flagship(ds, f"{tmp}/rk{spec}", spec, seed=5, burnin_epochs=0)
    plain = _flagship(ds, f"{tmp}/rp{spec}", spec, seed=5, burnin_epochs=0)
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = (kern._train_data[:128] > 0.5).float()
    noise = tail_kernels.draw_noise(kern.model_cfg.components, (128,), x, gen)
    with train_decoder(b6):
        gk = _grads(kern, x, noise)
    with train_decoder(False), plain_kernels():
        gp = _grads(plain, x, noise)
    worst = 0.0
    for a, b in zip(gk, gp):
        worst = max(worst, ((a - b).abs() / (1e-3 * b.abs() + 5e-4)).max()
                    .item())
    print(f"[replay] {spec}: one step, every parameter's gradient: max "
          f"{worst:.3g} of (rtol 1e-3, atol 5e-4)")
    check(worst <= 1.0, "one-step gradients match the plain versions")
    bs = kern.tc.batch_size
    perm = torch.randperm(len(kern._train_data), device="cuda",
                          generator=gen)
    dl, dp = [], 0.0
    for s in range(50):
        i = s % kern.steps_per_epoch
        xb = kern._train_data[perm[i * bs:(i + 1) * bs]]
        plain._load_state(_leaves(kern.params),
                          copy.deepcopy(kern.opt.state_dict()), kern.step,
                          kern.generator.get_state())
        with train_decoder(b6):
            sk = kern._train_step(xb)
        with train_decoder(False), plain_kernels():
            sp = plain._train_step(xb)
        dl.append((sk["elbo"] - sp["elbo"]).abs())
        dp = max(dp, max(((a - b).abs().max() / (b.abs().max() + 1e-12))
                         .item() for a, b in zip(_leaves(kern.params),
                                                 _leaves(plain.params))))
    dmax = torch.stack(dl).max().item()
    print(f"[replay] {spec}: 50 steps, each from the same state: max |d loss| "
          f"{dmax:.3g} nats, max parameter change apart {dp:.3g} (relative "
          f"to each tensor's largest entry)")
    check(dmax <= 0.05, "50 steps' losses within 0.05 nats of the plain run")
    if not free_run:
        return
    free = _free_run(ds, tmp, "fk", True, True, perm)
    floor = _free_run(ds, tmp, "fp", True, False, perm)
    print(f"[replay] 50 steps left to run apart: max |d loss| kernels vs "
          f"plain {free:.3g} nats; plain with the decoder's backward "
          f"summed otherwise vs plain {floor:.3g} nats")
    check(math.isfinite(free) and math.isfinite(floor),
          "free-running replay finite")


def phase_checkpoint(trainer, ds, tmp) -> None:
    trainer.save_checkpoint()
    fresh = _flagship(ds, trainer.run_dir, seed=123)
    fresh.restore_checkpoint()
    check(fresh.step == trainer.step, "checkpoint step")
    check(all(torch.equal(a, b) for a, b in zip(_leaves(trainer.params),
                                                _leaves(fresh.params))),
          "checkpoint params")
    sa, sb = trainer.opt.state_dict(), fresh.opt.state_dict()
    check(sa["param_groups"] == sb["param_groups"]
          and all(torch.equal(sa["state"][i][k], sb["state"][i][k])
                  for i in sa["state"] for k in sa["state"][i]),
          "checkpoint optimizer state")
    check(torch.equal(trainer.generator.get_state(),
                      fresh.generator.get_state()), "checkpoint generator")
    print(f"[checkpoint] step {fresh.step}: params, Adam state and generator "
          f"restored equal")


# --- the stereographic family: B4a inside B1 / B3, B5, d2,p2,e2 and u6 ---------


def held(ours, ref, ref64, tol, what: str) -> tuple[float, float]:
    """``ours`` within ``tol`` of the float32 plain version ``ref`` on every
    entry float32 resolves (``ref`` within a tenth of ``tol`` of its float64
    evaluation ``ref64``); elsewhere finite and no farther from float64 than
    ten times the plain version. Returns the worst share of ``tol`` used
    and the largest absolute error, both on the resolved entries."""
    check(bool(torch.isfinite(ours).all()), f"{what}: finite")
    plain_err = (ref.double() - ref64).abs()
    res = plain_err <= 0.1 * tol
    frac = res.double().mean().item()
    check(frac >= 0.5, f"{what}: float32 resolves most entries ({frac:.3f})")
    ratio = ((ours - ref).abs() / tol)[res].max().item()
    check(ratio <= 1.0, f"{what}: within tolerance on resolved entries "
                        f"({ratio:.3g} of it, {frac:.4f} resolved)")
    far = ((ours.double() - ref64).abs() / (plain_err + tol)).max().item()
    check(far <= 10.0, f"{what}: unresolved entries no farther from float64 "
                       f"than 10x the plain version ({far:.3g})")
    return ratio, (ours - ref).abs()[res].max().item()


def _tile_case(tag: str, comps, args, what: str):
    """One case of a wrapped tile (``tag``: B4a or B4b) inside B1 and B3
    against the plain versions, float32 and float64, and against the tail
    kernels' previous design (``PREVIOUS_TAIL``): B1's outputs bit for bit.
    Returns the shares of the tolerance used (forward, raw gradient,
    batch-summed curvature gradient), the largest errors on resolved
    entries (forward, backward), the number of rows float32 resolves and
    whether B3's outputs equal the previous design's bit for bit."""
    a64 = [t.double() for t in args]
    z, aux = tail_kernels.tail_forward(comps, *args[:3])
    z_r, aux_r = tail_kernels.tail_forward_ref(comps, *args[:3])
    z64, aux64 = tail_kernels.tail_forward_ref(comps, *a64[:3])
    draw, dk, dks_k = tail_kernels.tail_backward(comps, *args)
    pr, pk, _ = tail_kernels.tail_backward_ref(comps, *args)
    p64, pk64, _ = tail_kernels.tail_backward_ref(comps, *a64)
    z0, aux0 = tail_kernels.tail_forward_launch(_PREVIOUS["fwd"], comps,
                                                *args[:3])
    prev_bwd = tail_kernels.tail_backward_launch(_PREVIOUS["bwd"], comps,
                                                 *args)
    torch.cuda.synchronize()
    check(torch.equal(z, z0) and torch.equal(aux, aux0),
          f"{tag} B1 bit-equal to the previous design at {what}")
    same_bwd = all(torch.equal(a, b)
                   for a, b in zip((draw, dk, dks_k), prev_bwd))
    rz, ez = held(z, z_r, z64, 1e-5 * (1 + z_r.abs()), f"{tag} z at {what}")
    ra, ea = held(aux, aux_r, aux64, 1e-4 * (1 + 1e-2 * aux_r.abs()),
                  f"{tag} log-densities at {what}")
    tol = 1e-3 * pr.abs() + 5e-4
    rb, eb = held(draw, pr, p64, tol, f"{tag} raw gradient at {what}")
    # the curvature gradient is held as the reference holds it, summed over
    # the batch (a row's own value cancels terms of size 1 / K): over the
    # rows float32 resolves in both; by row it must be as near float64 as
    # the plain version
    ktol = 2e-3 * pk.abs() + 5e-4
    check(bool(torch.isfinite(dk).all()),
          f"{tag} curvature gradient finite at {what}")
    kfar = ((dk.double() - pk64).abs()
            / ((pk.double() - pk64).abs() + ktol)).max().item()
    check(kfar <= 10.0, f"{tag} curvature gradient by row no farther from "
                        f"float64 than 10x the plain version at {what}: "
                        f"{kfar:.3g}")
    res = (((pr.double() - p64).abs() <= 0.1 * tol).all(1)
           & ((pk.double() - pk64).abs() <= 0.1 * ktol).all(1))
    dks, pks = dk[res].sum(0), pk[res].sum(0)
    kr = ((dks - pks).abs() / (2e-3 * pks.abs() + 5e-4)).max().item()
    check(kr <= 1.0, f"{tag} curvature gradient within rtol 2e-3 at {what}: "
                     f"{kr:.3g} (kernel {dks.tolist()}, plain {pks.tolist()}, "
                     f"float64 {pk64[res].sum(0).tolist()})")
    return max(rz, ra), rb, kr, max(ez, ea), eb, int(res.sum()), same_bwd


def _tile_times(tag: str, spec: str, comps, f, b, prefix: str, line: int,
                err_f: float, err_b: float) -> list[dict]:
    """Times of B1 (inputs ``f``, B = 512; and at the training batch on
    ``b``'s heads) and B3 (inputs ``b``, B = 128) over a product with a
    wrapped tile, beside their bounds, the plain versions and the
    row-per-thread kernels' times:
    the tile's two rows of the kernels line (``prefix``_fwd and
    ``prefix``_bwd, replacing the TPU tile at ``line``)."""
    _tail_time(tag, spec, comps, b[:3], err_f)
    return [_tail_time(f"{prefix}_fwd", spec, comps, f[:3], err_f,
                       "mvae_torch/kernels/csrc/tail_tiles.cuh", line),
            _tail_time(f"{prefix}_bwd", spec, comps, b, err_b,
                       "mvae_torch/kernels/csrc/tail_bwd.cu", line)]


def _stereo_inputs(comps, B, kset, gen):
    """Heads of the size training produces, with the rows the tile's guards
    exist for: every 13th |mu| large, row 1 mu_tan = 0 and eps = 0, every
    17th row (from row 2) a sigma beyond the cap where K > 0, row 3 pushed
    to the ball's rim."""
    W, _, Z = tail_kernels._dims(comps)
    nc = len(comps)
    raw = 0.5 * torch.randn(B, W, generator=gen, device="cuda")
    eps = tail_kernels.draw_noise(comps, (B,), raw, gen)
    off = 0
    for c, kc in zip(comps, kset):
        mu_cols = slice(off, off + c.dim)
        sig_cols = slice(off + c.dim, off + c.head_width)
        raw[::13, mu_cols] *= 4.0
        raw[2::17, sig_cols] += 7.0 if kc > 0 else 1.0
        raw[3, mu_cols] = 40.0
        off += c.head_width
    raw[1] = 0.0
    eps[1] = 0.0
    k = torch.tensor(kset, device="cuda")
    dz = torch.randn(B, Z, generator=gen, device="cuda")
    daux = torch.randn(B, nc + 2, generator=gen, device="cuda")
    return raw, eps, k, dz, daux


_STEREO_CASES = (
    (STEREO_SPEC, ((-1.0, 1.0, 0.0), (-1e-3, 1e-3, 0.0), (-0.3, 2.5, 0.0))),
    ("u6", ((1.0,), (-1.0,), (1e-3,), (-1e-3,), (0.0,))),
    ("p6", ((1.0,), (1e-3,))))


def phase_stereo_tail(gen) -> list[dict]:
    """B4a: the stereographic tile inside B1 and B3 against the plain
    versions, then the two kernels' times at the d2,p2,e2 product."""
    worst_f = worst_b = err_f = err_b = 0.0
    for spec, ksets in _STEREO_CASES:
        comps = tuple(parse_components(spec, fixed_curvature=False))
        for B in (512, 128):
            for kset in ksets:
                what = f"{spec} B={B} k={kset}"
                rf, rb, kr, ef, eb, n_res, same = _tile_case(
                    "B4a", comps, _stereo_inputs(comps, B, kset, gen), what)
                err_f, err_b = max(err_f, ef), max(err_b, eb)
                worst_f, worst_b = max(worst_f, rf), max(worst_b, rb, kr)
                print(f"[stereo_tile] {what}: forward {rf:.3g} of tol, "
                      f"backward {rb:.3g}, curvature {kr:.3g} "
                      f"({n_res}/{B} rows resolved); against the previous "
                      f"design: B1 bit-equal, B3 "
                      f"{'bit-equal' if same else 'not bit-equal'}")
    out = []
    for spec in (STEREO_SPEC, "u6"):
        comps = tuple(parse_components(spec, fixed_curvature=False))
        kset = (-1.0, 1.0, 0.0) if spec == STEREO_SPEC else (0.5,)
        rows = _tile_times("stereo_tile", spec, comps,
                           _stereo_inputs(comps, 512, kset, gen),
                           _stereo_inputs(comps, 128, kset, gen),
                           "stereo_tile", 462, err_f, err_b)
        if spec == STEREO_SPEC:
            out = rows
    print(f"[stereo_tile] worst share of the tolerance: forward "
          f"{worst_f:.3g}, backward {worst_b:.3g}; largest error on resolved "
          f"entries: forward {err_f:.3g}, backward {err_b:.3g}")
    return out


def _reparam_row(S, B, n, kval, gen):
    """One chunk of B5's timed rows: the noise a view of a wider (S, B,
    n + 2) block, z into rows 1 .. n of an (S, n + 2, B) buffer."""
    k = torch.tensor(kval, device="cuda")
    eps = torch.randn(S, B, n + 2, generator=gen, device="cuda")[..., 1:1 + n]
    mu = _stereo_mu(B, n, k, kval, gen)
    sig = 0.2 + torch.rand(B, n, generator=gen, device="cuda")
    return eps, mu, sig, k, torch.zeros(S, n + 2, B, device="cuda"), 1


def _previous_reparam(built, eps, mu, sig, k, out, z_off, sign, wraps=1,
                      which="previous_reparam"):
    """B5's previous design (``which``: or B5 built on the previous tail
    tiles, ``reparam_previous_tiles``) on the wrapper's arguments (not
    counted)."""
    lq = torch.empty(eps.shape[:2], device="cuda")
    lp = torch.empty(eps.shape[:2], device="cuda")
    manifold_kernels.reparam_launch(built[which], eps, mu, sig,
                                    k.reshape(1), out, z_off, lq, lp, sign,
                                    wraps)
    return out[:, z_off:z_off + eps.shape[2]], lq, lp


def phase_reparam(gen, built) -> dict:
    """B5 against its plain version and, bit for bit, against its previous
    design and against itself built on the tail's previous tiles
    (``PREVIOUS_TAIL``: the split tail design must leave B5 as it was);
    then its time in turns with each on four rows: the IWAE chunk of
    d2,p2,e2's components (S = 125, B = 512, n = 2) at sign +1 and -1, of
    u6 (n = 6, sign 0), and the production chunk (125, 2048, 6) over
    rotating buffer sets."""
    S, B = 125, 512
    worst = err = 0.0
    keep = None
    for n in (2, 6):
        for sign, kval in ((-1, -1.0), (-1, -1e-3), (0, -0.5), (0, 0.0),
                           (0, 1e-3), (0, 0.9), (1, 1.0), (1, 1e-3)):
            for wraps in (0, 1):
                noise = torch.randn(S, B, n + 2, generator=gen, device="cuda")
                eps = noise[..., 1:1 + n]        # a view of a wider block
                k = torch.tensor(kval, device="cuda")
                mu = _stereo_mu(B, n, k, kval, gen)
                sig = 0.2 + torch.rand(B, n, generator=gen, device="cuda")
                out = torch.zeros(S, n + 2, B, device="cuda")
                zt, lq, lp = manifold_kernels.wrapped_reparam_stereo_t(
                    eps, mu, sig, k, wraps=wraps, sign=sign, out=out, z_off=1)
                z_r, lq_r, lp_r = manifold_kernels.wrapped_reparam_stereo_ref(
                    eps, mu, sig, k, wraps=wraps, sign=sign)
                z64, lq64, lp64 = manifold_kernels.wrapped_reparam_stereo_ref(
                    eps.double(), mu.double(), sig.double(), k.double(),
                    wraps=wraps, sign=sign)
                prev = _previous_reparam(built, eps, mu, sig, k,
                                         torch.zeros_like(out), 1, sign,
                                         wraps)
                tiles = _previous_reparam(built, eps, mu, sig, k,
                                          torch.zeros_like(out), 1, sign,
                                          wraps, "reparam_previous_tiles")
                torch.cuda.synchronize()
                check(all(torch.equal(a, b)
                          for a, b in zip((zt, lq, lp), tiles)),
                      f"B5 n={n} sign={sign} k={kval} wraps={wraps}: "
                      f"bit-equal to B5 on the previous tail tiles")
                what = f"B5 n={n} sign={sign} k={kval} wraps={wraps}"
                check(bool((out[:, 0] == 0).all()
                           and (out[:, 1 + n:] == 0).all()),
                      f"{what}: writes only its rows of the buffer")
                check(all(torch.equal(a, b)
                          for a, b in zip((zt, lq, lp), prev)),
                      f"{what}: bit-equal to the previous design")
                for ours, ref, ref64, tol, name in (
                        (zt, z_r, z64, 1e-5 * (1 + z_r.abs()), "z"),
                        (lq, lq_r, lq64, 1e-4 * (1 + 1e-2 * lq_r.abs()),
                         "log q"),
                        (lp, lp_r, lp64, 1e-4 * (1 + 1e-2 * lp_r.abs()),
                         "log p")):
                    r, e = held(ours, ref, ref64, tol, f"{what} {name}")
                    worst, err = max(worst, r), max(err, e)
                if (n, sign, wraps) == (2, 1, 1) and kval == 1.0:
                    keep = (eps, mu, sig, k, out)
    print(f"[reparam_stereo] 32 cases at (S, B) = (125, 512): worst share of "
          f"the tolerance {worst:.3g}, largest error on resolved entries "
          f"{err:.3g}; each bit-equal to the previous design and to B5 on "
          f"the previous tail tiles")
    eps, mu, sig, k, out = keep
    rl = roofline
    prod = rl.reparam_sets(rl.buffer_sets(rl.reparam_bytes(rl.RS, rl.RB,
                                                           rl.RN),
                                          rl._l2_bytes()))
    rows = (("(125, 512, 2), sign +1", 1, [(eps, mu, sig, k, out, 1)]),
            ("(125, 512, 2), sign -1", -1, [_reparam_row(S, B, 2, -1.0, gen)]),
            ("(125, 512, 6), sign 0", 0, [_reparam_row(S, B, 6, 0.5, gen)]),
            (f"production ({rl.RS}, {rl.RB}, {rl.RN}), sign -1, "
             f"{len(prod)} buffer sets", -1,
             [(e, m, sg, torch.tensor(-1.0, device="cuda"), o, 0)
              for e, m, sg, o, _ in prod]))
    ms = None
    for label, sign, sets in rows:
        def kernel():
            return rl.measure([
                lambda a=a: manifold_kernels.wrapped_reparam_stereo_t(
                    *a[:4], wraps=1, sign=sign, out=a[4], z_off=a[5])
                for a in sets], "reparam_stereo_kernel", 100)

        def previous():
            return rl.measure([
                lambda a=a: _previous_reparam(built, *a, sign)
                for a in sets], "reparam_stereo_kernel", 100)

        def on_tiles():
            return rl.measure([
                lambda a=a: _previous_reparam(built, *a, sign,
                                              which="reparam_previous_tiles")
                for a in sets], "reparam_stereo_kernel", 100)

        turns = [kernel(), previous(), previous(), kernel()]
        t = rl.mean_timing(turns[0], turns[3])
        p = rl.mean_timing(turns[1], turns[2])
        tt = [kernel(), on_tiles(), on_tiles(), kernel()]
        t2 = rl.mean_timing(tt[0], tt[3])
        p2 = rl.mean_timing(tt[1], tt[2])
        print(f"[reparam_stereo] {label}: kernel {t2.us:.2f} us, on the "
              f"previous tail tiles {p2.us:.2f} us in turns "
              f"({', '.join(f'{x.us:.2f}' for x in tt)} us): "
              f"{t2.us / p2.us:.3f} of it "
              f"({'within' if abs(t2.us / p2.us - 1) <= 0.03 else 'outside'}"
              f" 3%)")
        e0 = sets[0][0]
        spt = manifold_kernels.reparam_spt(*e0.shape, sign)
        print(f"[reparam_stereo] {label}: kernel {t.us:.2f} us ({spt} "
              f"sample(s) a thread), previous design {p.us:.2f} us in turns "
              f"(kernel, previous, previous, kernel: "
              f"{', '.join(f'{x.us:.2f}' for x in turns)} us; CUPTI trace "
              f"medians {t.trace_us}, {p.trace_us}): {p.us / t.us:.2f}x")
        check(t.us < p.us, f"B5 at {label} faster than its previous design")
        if ms is None:
            ms = t.us / 1e3
    plain_ms = time_ms(lambda: manifold_kernels.wrapped_reparam_stereo_ref(
        eps, mu, sig, k, wraps=1, sign=1), 20)
    n = 2
    nbytes = rl.reparam_bytes(S, B, n)
    ops = rl.reparam_ops(eps, mu, sig, k, 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops_ms(ops, built["tanh_per"])
    print(f"[reparam_stereo] (S, B, n) = (125, 512, 2), sign +1, wraps 1: "
          f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.1f} us, bytes "
          f"bound {bytes_ms * 1e3:.3f} us ({nbytes} B), operations bound "
          f"{o_ms * 1e3:.3f} us ({ops['arithmetic']} arithmetic ops, "
          f"{ops['transcendental']} transcendentals at "
          f"{built['tanh_per']:.2f} each, in FMA issue slots at 67 "
          f"TFLOP/s: the plain version's ops on the branch each point "
          f"takes, the wrap branches' sine once)")
    return {"name": "reparam_stereo", "route": "cuda",
            "source": "mvae_torch/kernels/csrc/reparam_stereo.cu",
            "replaces": "mvae_tpu/kernels/manifold_kernels.py:563",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, o_ms),
            "bound_by": "bytes" if bytes_ms >= o_ms else "operations",
            "library_ms": None}


def _chunk_case(spec, S, B, gen, **opts):
    """A chunk of ``spec``'s P2 components on the card: means ~0.5, 4x
    that on every 7th example from example 3, scales softplus(N(-1, 0.7)),
    curvatures -0.7 on h and 1.3 on s."""
    comps = tuple(parse_components(spec, fixed_curvature=False, **opts))
    picked = tuple(i for i, c in enumerate(comps)
                   if tail_kernels.chunk_supported(c))
    W = sum(c.head_width for c in comps)
    raw = torch.randn(B, W, generator=gen, device="cuda")
    off = 0
    for c in comps:
        raw[:, off:off + c.dim] *= 0.5
        raw[3::7, off:off + c.dim] *= 4.0
        raw[:, off + c.dim:off + c.head_width] = (
            0.7 * raw[:, off + c.dim:off + c.head_width] - 1.0)
        off += c.head_width
    noise = tail_kernels.draw_noise(comps, (S, B), raw, gen)
    k = torch.tensor([{"h": -0.7, "s": 1.3}.get(comps[i].manifold.kind, 0.0)
                      for i in picked], device="cuda")
    return comps, picked, raw, noise, k


def _previous_chunk(comps, cps, raw, noise, zt):
    """The per-component path P2 replaces, on one chunk: each component's
    ``components.reparametrize`` on its head slice and noise columns, its z
    copied transposed into its rows of zt, log q and log p summed."""
    from mvae_torch.components import reparametrize
    lq = lp = 0.0
    ro = eo = zo = 0
    for c, cp in zip(comps, cps):
        rep = reparametrize(c, cp, raw, raw=raw[:, ro:ro + c.head_width],
                            noise=noise[..., eo:eo + c.noise_width])
        zt[:, zo:zo + c.ambient_dim] = rep.z.transpose(1, 2)
        lq = lq + rep.log_q
        lp = lp + rep.log_p
        ro += c.head_width
        eo += c.noise_width
        zo += c.ambient_dim
    return lq, lp


def phase_reparam_chunk(gen) -> dict:
    """P2 against its plain version (float64 beside it) and, bit for bit,
    against B1 on the same rows; then its time at the flagship's chunk in
    turns with the per-component path it replaces."""
    worst = err = 0.0
    cases = [("h2,s2,e2", {}), ("h2,s2,e2", {"scalar_sigma": True}),
             ("d2,p2,e2", {}), ("h3,e3", {}), ("h2,e3,s2", {})]
    for (spec, opts), (S, B) in [(c, sb) for c in cases
                                 for sb in ((125, 512), (7, 33))]:
        comps, picked, raw, noise, k = _chunk_case(spec, S, B, gen, **opts)
        Z = sum(c.ambient_dim for c in comps)
        out = torch.full((S, Z, B), 7.0, device="cuda")
        lq, lp = tail_kernels.reparam_chunk_t(comps, picked, raw, noise, k,
                                              out)
        z_r, lq_r, lp_r = tail_kernels.reparam_chunk_ref(comps, picked, raw,
                                                         noise, k)
        z64, lq64, lp64 = tail_kernels.reparam_chunk_ref(
            comps, picked, raw.double(), noise.double(), k.double())
        parts = tail_kernels._picked(comps, picked)
        z = torch.cat([out[:, zo:zo + c.ambient_dim]
                       for c, _, _, zo in parts], dim=1).transpose(1, 2)
        what = f"P2 {spec} {opts or ''} at (S, B) = ({S}, {B})"
        for ours, ref, ref64, tol, name in (
                (z, z_r, z64, 1e-5 * (1 + z_r.abs()), "z"),
                (lq, lq_r, lq64, 1e-4 * (1 + 1e-2 * lq_r.abs()), "log q"),
                (lp, lp_r, lp64, 1e-4 * (1 + 1e-2 * lp_r.abs()), "log p")):
            r, e = held(ours, ref, ref64, tol, f"{what} {name}")
            worst, err = max(worst, r), max(err, e)
        others = [i for i in range(len(comps)) if i not in picked]
        check(all(bool((out[:, zo:zo + c.ambient_dim] == 7.0).all())
                  for c, _, _, zo in (tail_kernels._picked(comps,
                                                           tuple(others))
                                      if others else ())),
              f"{what}: writes only its components' rows")
        if len(picked) == len(comps):
            W, E, _ = tail_kernels._dims(comps)
            rows = raw.unsqueeze(0).expand(S, B, W).reshape(S * B, W)
            z1, aux = tail_kernels.tail_forward(comps, rows,
                                                noise.reshape(S * B, E), k)
            nc = len(comps)
            check(torch.equal(out.transpose(1, 2), z1.reshape(S, B, Z))
                  and torch.equal(lq, aux[:, nc].reshape(S, B))
                  and torch.equal(lp, aux[:, nc + 1].reshape(S, B)),
                  f"{what}: bit-equal to B1 on the repeated rows")
    print(f"[reparam_chunk] 10 cases: worst share of the tolerance "
          f"{worst:.3g}, largest error on resolved entries {err:.3g}; the "
          f"whole-product tables bit-equal to B1")

    S, B = 125, 512
    rl = roofline
    comps, picked, raw, noise, k = _chunk_case(SPEC, S, B, gen)
    cps = [c.init_params(4, 1.0, torch.float32, None, "cuda") for c in comps]
    W, E, Z = tail_kernels._dims(comps)
    out = torch.empty((S, Z, B), device="cuda")
    out_p = torch.empty((S, Z, B), device="cuda")
    kc = torch.stack([c.curvature(cp) for c, cp in zip(comps, cps)])

    def kernel():
        return rl.measure(lambda: tail_kernels.reparam_chunk_t(
            comps, picked, raw, noise, kc, out), "reparam_chunk_kernel", 100)

    def previous():
        return rl.measure(lambda: _previous_chunk(comps, cps, raw, noise,
                                                  out_p), graph=True,
                          iters=20)

    turns = [kernel(), previous(), previous(), kernel()]
    t = rl.mean_timing(turns[0], turns[3])
    p = rl.mean_timing(turns[1], turns[2])
    lq, lp = tail_kernels.reparam_chunk_t(comps, picked, raw, noise, kc, out)
    lq_p, lp_p = _previous_chunk(comps, cps, raw, noise, out_p)
    torch.cuda.synchronize()
    gap = max((lq - lq_p).abs().max().item(), (lp - lp_p).abs().max().item())
    plain_ms = time_ms(lambda: tail_kernels.reparam_chunk_ref(
        comps, picked, raw, noise, kc), 5)
    nbytes = rl.reparam_chunk_bytes(S, B, E, Z, W, len(picked))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[reparam_chunk] {SPEC} chunk (S, B) = ({S}, {B}): kernel "
          f"{t.us:.2f} us (CUPTI trace median {t.trace_us}), the per-component path it replaces {p.us:.2f} us "
          f"a chunk in turns (kernel, previous, previous, kernel: "
          f"{', '.join(f'{x.us:.2f}' for x in turns)} us): {p.us / t.us:.1f}x;"
          f" largest |d log q|, |d log p| against it {gap:.3g}; plain "
          f"{plain_ms * 1e3:.1f} us; bytes bound {bytes_ms * 1e3:.3f} us "
          f"({nbytes} B)")
    check(t.us < p.us, "P2 faster than the per-component path")
    return {"name": "reparam_chunk", "route": "cuda",
            "source": "mvae_torch/kernels/csrc/reparam_chunk.cu",
            "replaces": None, "max_abs_err": err, "ms": t.us / 1e3,
            "plain_ms": plain_ms, "previous_ms": p.us / 1e3,
            "bound_ms": bytes_ms, "bound_by": "bytes", "library_ms": None}


def _stereo_mu(B, n, k, kval, gen):
    """Posterior means on the manifold, inside the K < 0 ball."""
    from mvae_torch.ops import stereographic
    v = 0.3 * torch.randn(B, n, generator=gen, device="cuda")
    return stereographic.exp_map_mu0(v / max(abs(kval), 1.0) ** 0.5, k)


def phase_stereo_train(ds, tmp) -> dict:
    """One epoch of d2,p2,e2 at full width with burn-in off: B1 and B3 (with
    the stereographic tile) once per step, both curvatures move."""
    trainer = _flagship(ds, f"{tmp}/stereo", STEREO_SPEC, seed=0, epochs=1,
                        burnin_epochs=0)
    with torch.no_grad():
        k0 = {n: float(c.curvature(cp)) for n, c, cp in zip(
            trainer.component_names, trainer.model_cfg.components,
            trainer.params["components"])}
    check(trainer.fused_paths["train_tail"]["active"],
          f"training routed through B1/B3: {trainer.fused_paths}")
    counted = {"tail_fwd": tail_kernels.tail_forward,
               "tail_bwd": tail_kernels.tail_backward,
               "reparam_stereo": manifold_kernels.wrapped_reparam_stereo_t}
    for fn in counted.values():
        fn.launches = 0
    result = trainer.fit(verbose=True, ll_max_examples=1024)
    launches = {name: fn.launches for name, fn in counted.items()}
    steps = trainer.step
    rec = result["history"][0]
    print(f"[train] {STEREO_SPEC} h_dim 400, batch 128, {steps} steps: "
          f"{result['train_steps_per_sec']:.1f} train steps/s (first epoch, "
          f"warm-up included), train ELBO {rec['train/elbo']:.4f}, IWAE-500 "
          f"on 1024 test examples {result['test/log_likelihood_iwae']:.4f}; "
          f"launches {launches}")
    check(all(math.isfinite(v) for v in rec.values()),
          "finite statistics of the d2,p2,e2 epoch")
    check(math.isfinite(result["test/log_likelihood_iwae"]), "finite IWAE")
    check(launches["tail_bwd"] == steps, "B3 launched once per step")
    check(launches["tail_fwd"] >= steps, "B1 launched at least once a step")
    check(launches["reparam_stereo"] == 2 * 4 * 2,
          "B5 launched 2 batches x 4 chunks x 2 components in the final IWAE")
    for n in ("d2#0", "p2#1"):
        check(rec[f"train/curvature/{n}"] != k0[n],
              f"curvature {n} moves with burn-in off")
    print(f"[train] curvature K {k0} -> "
          f"{ {n: rec[f'train/curvature/{n}'] for n in k0} }")
    rates = [_epoch_rate(trainer, 10 + i) for i in range(2)]
    print(f"[train] {STEREO_SPEC} steps/s by epoch: "
          + ", ".join(f"{r:.1f}" for r in rates))
    profile_pass(f"{STEREO_SPEC} train epoch ({trainer.steps_per_epoch} "
                 f"steps)", lambda: trainer.train_one_epoch(20), layers=True)
    return launches


def phase_u6(ds, tmp) -> None:
    """u6 at full width: 150 steps from K = +1e-3 and from K = -1e-3 with
    burn-in off, so the universal tile runs on both sides of K = 0 (and
    through it in the run whose gradient points there), then IWAE-500 on
    1,024 test examples through the sign-0 instance of B5."""
    crossed = 0
    for name, k_init in (("pos", 1e-3), ("neg", -1e-3)):
        trainer = _flagship(ds, f"{tmp}/u6{name}", "u6", seed=0,
                            burnin_epochs=0, init_k=k_init)
        check(trainer.fused_paths["train_tail"]["active"]
              and trainer.fused_paths["iwae_reparam"][0]["active"],
              f"u6 routed through the kernels: {trainer.fused_paths}")
        c = trainer.params["components"][0]["c_param"]
        gen = torch.Generator(device="cuda").manual_seed(3)
        perm = torch.randperm(len(trainer._train_data), device="cuda",
                              generator=gen)
        bs = trainer.tc.batch_size
        counted = (tail_kernels.tail_forward, tail_kernels.tail_backward,
                   manifold_kernels.wrapped_reparam_stereo_t)
        for fn in counted:
            fn.launches = 0
        elbos, ks = [], []
        for s in range(150):
            stats = trainer._train_step(
                trainer._train_data[perm[s * bs:(s + 1) * bs]])
            elbos.append(stats["elbo"])
            ks.append(c.detach().clone())
        elbos, ks = torch.stack(elbos), torch.stack(ks)
        check(bool(torch.isfinite(elbos).all() and torch.isfinite(ks).all()),
              f"u6 from K={k_init}: finite loss and curvature at every step")
        check(all(bool(torch.isfinite(t).all())
                  for t in _leaves(trainer.params)),
              f"u6 from K={k_init}: finite parameters")
        check(tail_kernels.tail_forward.launches == 150
              and tail_kernels.tail_backward.launches == 150,
              "u6: B1 and B3 launched once per step")
        ll = trainer.evaluate_log_likelihood("test", 1024)
        check(math.isfinite(ll), f"u6 from K={k_init}: finite IWAE-500")
        check(manifold_kernels.wrapped_reparam_stereo_t.launches == 2 * 4,
              "u6: B5 launched 2 batches x 4 chunks")
        k_end = ks[-1].item()
        crossed += (k_end > 0) != (k_init > 0)
        print(f"[u6] from K={k_init:+.0e}: 150 steps, ELBO "
              f"{elbos[0].item():.3f} -> {elbos[-1].item():.3f}, K min "
              f"{ks.min().item():+.3e} max {ks.max().item():+.3e} end "
              f"{k_end:+.3e}; IWAE-500 on 1024 test examples {ll:.4f}")
    print(f"[u6] runs that crossed K = 0: {crossed} of 2")
    profile_pass("u6 IWAE-500 pass, 1024 examples",
                 lambda: trainer.evaluate_log_likelihood("test", 1024))



# --- the spherical family: B4b inside B1 / B3, B7, s6:wrapped, s6, p2:vmf ------


def _sphere_inputs(comps, B, kset, gen):
    """Heads of the size training produces, with the rows the sphere tile's
    guards exist for: every 13th |mu| large, row 1 mu_tan = 0 and eps = 0,
    every 17th row (from row 2) a sigma beyond the cap where K > 0, row 3
    the mean at the antipode of mu0, row 4 eps = 0 alone, row 5 mu_tan = 0
    alone."""
    W, _, Z = tail_kernels._dims(comps)
    nc = len(comps)
    raw = 0.5 * torch.randn(B, W, generator=gen, device="cuda")
    eps = tail_kernels.draw_noise(comps, (B,), raw, gen)
    off = 0
    for c, kc in zip(comps, kset):
        mu_cols = slice(off, off + c.dim)
        sig_cols = slice(off + c.dim, off + c.head_width)
        raw[::13, mu_cols] *= 4.0
        raw[2::17, sig_cols] += 7.0 if kc > 0 else 1.0
        if c.manifold.kind == "s":
            raw[3, mu_cols] = 0.0
            raw[3, off] = math.pi / kc ** 0.5
        raw[5, mu_cols] = 0.0
        off += c.head_width
    raw[1] = 0.0
    eps[1] = 0.0
    eps[4] = 0.0
    k = torch.tensor(kset, device="cuda")
    dz = torch.randn(B, Z, generator=gen, device="cuda")
    daux = torch.randn(B, nc + 2, generator=gen, device="cuda")
    return raw, eps, k, dz, daux


_SPHERE_CASES = (
    (SPHERE_SPEC, ((1.0,), (1e-3,), (4.0,))),
    ("s3:wrapped,h2,e2", ((1.0, -1.0, 0.0), (2.5, -0.3, 0.0))),
    ("s4:wrapped,s2", ((0.25, 1.0),)))


def _sphere_floor_rows(spec, kval, gen, **opts):
    """The rows where the sphere tile's K-dependent floors are taken, held
    to the float32 plain version directly (the float64 plain version floors
    elsewhere, so ``held`` compares nothing there): row 0 the mean 1e-3 rad
    from the antipode of mu0 (the transport's denominator under its floor),
    row 1 the mean at the antipode with eps = 0 (the half chord at its
    cap), row 2 mu_tan = 0 with a saturated scale and a unit draw (z next
    to the antipode), row 3 a saturated cap with a free draw, row 4
    mu_tan = 0 with eps = 0. Forward within B1's contract; the raw gradient
    within 1e-2 of the row's largest entry; the row's curvature gradient
    within rtol 1e-2 (0.1 on rows 1-2, where float32 quantizes what is left
    of two cancelling terms ~1e5 times larger)."""
    comps = tuple(parse_components(spec, fixed_curvature=False, **opts))
    n = comps[0].dim
    raw, eps, k, dz, daux = _sphere_inputs(comps, 16, (kval,), gen)
    raw[:5, :n] = 0.0
    raw[0, 0] = (math.pi - 1e-3) / kval ** 0.5
    raw[1, 0] = math.pi / kval ** 0.5
    eps[1] = 0.0
    raw[2:4, n:] = 10.0 * math.pi / kval ** 0.5
    eps[2] = 0.0
    eps[2, 1] = 1.0
    eps[4] = 0.0
    z, aux = tail_kernels.tail_forward(comps, raw, eps, k)
    z_r, aux_r = tail_kernels.tail_forward_ref(comps, raw, eps, k)
    draw, dk, _ = tail_kernels.tail_backward(comps, raw, eps, k, dz, daux)
    pr, pk, _ = tail_kernels.tail_backward_ref(comps, raw, eps, k, dz, daux)
    z0, aux0 = tail_kernels.tail_forward_launch(_PREVIOUS["fwd"], comps, raw,
                                                eps, k)
    torch.cuda.synchronize()
    what = f"B4b floor rows of {spec} {opts or ''} at K={kval}"
    check(torch.equal(z, z0) and torch.equal(aux, aux0),
          f"{what}: B1 bit-equal to the previous design")
    half = ((z_r[:, 0] - 1.0 / kval ** 0.5) ** 2
            + (z_r[:, 1:] ** 2).sum(1)).sqrt() / 2.0
    check(bool((half[1:3] > (1.0 - 1e-6) / kval ** 0.5).all()
               and (half[3:] < (1.0 - 1e-6) / kval ** 0.5).all()),
          f"{what}: the half chord's cap is taken on rows 1-2 only")
    check(bool(((z - z_r).abs() <= 1e-5 * (1 + z_r.abs())).all()),
          f"{what}: z")
    check(bool(((aux - aux_r).abs() <= 1e-4 * (1 + 1e-2 * aux_r.abs()))
               .all()), f"{what}: log-densities")
    check(bool(torch.isfinite(draw).all() and torch.isfinite(dk).all()
               and torch.isfinite(pr).all() and torch.isfinite(pk).all()),
          f"{what}: finite gradients")
    scale = pr.abs().amax(1, keepdim=True)
    r_raw = ((draw - pr).abs() / (1e-2 * scale + 5e-4)).max().item()
    check(r_raw <= 1.0, f"{what}: raw gradient ({r_raw:.3g} of tol)")
    rtol = torch.full_like(pk, 1e-2)
    rtol[1:3] = 0.1
    r_k = ((dk - pk).abs() / (rtol * pk.abs() + 5e-4)).max().item()
    check(r_k <= 1.0, f"{what}: curvature gradient by row ({r_k:.3g} of "
                      f"tol; kernel {dk[:5, 0].tolist()}, plain "
                      f"{pk[:5, 0].tolist()})")
    return max(r_raw, r_k)


def phase_sphere_tail(gen) -> list[dict]:
    """B4b: the embedded-sphere tile inside B1 and B3 against the plain
    versions, then the two kernels' times at the s6:wrapped product."""
    worst_f = worst_b = err_f = err_b = 0.0
    for spec, ksets in _SPHERE_CASES:
        comps = tuple(parse_components(spec, fixed_curvature=False))
        for B in (512, 128):
            for kset in ksets:
                what = f"{spec} B={B} k={kset}"
                rf, rb, kr, ef, eb, n_res, same = _tile_case(
                    "B4b", comps, _sphere_inputs(comps, B, kset, gen), what)
                err_f, err_b = max(err_f, ef), max(err_b, eb)
                worst_f, worst_b = max(worst_f, rf), max(worst_b, rb, kr)
                print(f"[sphere_tile] {what}: forward {rf:.3g} of tol, "
                      f"backward {rb:.3g}, curvature {kr:.3g} "
                      f"({n_res}/{B} rows resolved); against the previous "
                      f"design: B1 bit-equal, B3 "
                      f"{'bit-equal' if same else 'not bit-equal'}")
    floor = 0.0
    for spec, opts in (("s3:wrapped", {}), ("s6:wrapped",
                                            {"scalar_sigma": True}),
                       ("s2:wrapped", {"wraps": 0})):
        for kval in (1.0, 2.5, 0.2):
            floor = max(floor, _sphere_floor_rows(spec, kval, gen, **opts))
    print(f"[sphere_tile] floor rows (antipode, capped chord, saturated "
          f"sigma, 0 / 0 pin), 9 cases: worst share of their tolerance "
          f"{floor:.3g}")
    comps = tuple(parse_components(SPHERE_SPEC, fixed_curvature=False))
    rows = _tile_times("sphere_tile", SPHERE_SPEC, comps,
                       _sphere_inputs(comps, 512, (1.0,), gen),
                       _sphere_inputs(comps, 128, (1.0,), gen),
                       "sphere_tile", 301, err_f, err_b)
    print(f"[sphere_tile] worst share of the tolerance: forward "
          f"{worst_f:.3g}, backward {worst_b:.3g}; largest error on resolved "
          f"entries: forward {err_f:.3g}, backward {err_b:.3g}")
    return rows


# The kernels line's rows of the tail kernels and the tail row each one's
# previous design is timed on in turns
_TURN_ROWS = {"tail_fwd": ("B1", SPEC, 512), "tail_bwd": ("B3", SPEC, 128),
              "stereo_tile_fwd": ("B1", STEREO_SPEC, 512),
              "stereo_tile_bwd": ("B3", STEREO_SPEC, 128),
              "sphere_tile_fwd": ("B1", SPHERE_SPEC, 512),
              "sphere_tile_bwd": ("B3", SPHERE_SPEC, 128)}


def phase_tail_turns(card: str) -> dict:
    """B1 and B3 in turns with their previous design (``PREVIOUS_TAIL``) on
    every tail row of ``roofline.TAIL_ROWS`` (B3 at the matrix's batch 256
    for u6 and s6:wrapped among them), on the rows' own inputs: the new
    kernel's outputs first against the previous design's (B1's bit for bit;
    whether B3's are printed: phases 12 and 16 hold them to the contract),
    then new, previous, previous, new, each ``roofline.measure`` (CUDA
    events around the replay of a CUDA graph of 100 calls). Returns
    (kernel, spec, B) -> (new ms, previous ms)."""
    rl = roofline
    out = {}
    for spec, kset, kern, B in rl.TAIL_ROWS:
        comps, raw, eps, k, dz, daux = rl.tail_inputs(spec, kset, B)
        if kern == "B1":
            args, name = (raw, eps, k), "tail_fwd_kernel"
            new = functools.partial(tail_kernels.tail_forward, comps, *args)
            old = functools.partial(tail_kernels.tail_forward_launch,
                                    _PREVIOUS["fwd"], comps, *args)
        else:
            args, name = (raw, eps, k, dz, daux), "tail_bwd_kernel"
            new = functools.partial(tail_kernels.tail_backward, comps, *args)
            old = functools.partial(tail_kernels.tail_backward_launch,
                                    _PREVIOUS["bwd"], comps, *args)
        a, b = new(), old()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        if kern == "B1":
            check(same, f"{kern} {spec} B={B} bit-equal to the previous "
                        f"design on its tail row's inputs")
        turns = [rl.measure(f, name, iters=100) for f in (new, old, old, new)]
        t = rl.mean_timing(turns[0], turns[3])
        p = rl.mean_timing(turns[1], turns[2])
        out[(kern, spec, B)] = (t.us / 1e3, p.us / 1e3)
        print(f"[tail_turns] {card}: {kern} {spec} at B={B}: "
              f"{t.us:.2f} us, previous design {p.us:.2f} us in turns (new, "
              f"previous, previous, new: "
              f"{', '.join(f'{x.us:.2f}' for x in turns)} us): "
              f"{p.us / t.us:.2f}x; outputs "
              f"{'bit-equal' if same else 'not bit-equal'} to the previous "
              f"design's")
    for kern, B, target in (("B3", 128, 2.0), ("B1", 512, 1.3)):
        for spec in (STEREO_SPEC, "u6", SPHERE_SPEC):
            t, p = out[(kern, spec, B)]
            print(f"[tail_turns] {kern} {spec} at B={B}: {p / t:.2f}x the "
                  f"previous design (target {target}x): "
                  f"{'met' if p / t >= target else 'missed'}")
    for kern, B in (("B1", 512), ("B1", 128), ("B3", 128)):
        t, p = out[(kern, SPEC, B)]
        print(f"[tail_turns] the flagship's {kern} at B={B}: {t / p:.3f} of "
              f"the previous design's time ("
              f"{'within' if abs(t / p - 1) <= 0.03 else 'outside'} 3%)")
    return out


def _stereo_points(B, n, kval, gen):
    """Rows x, y (B, n) in the manifold's chart: norms up to 0.9 of the
    ball's radius for K < 0, up to 1.5 / sqrt(max(K, 1)) otherwise; x = y in
    row 0."""
    lim = 0.9 / (-kval) ** 0.5 if kval < 0 else 1.5 / max(kval, 1.0) ** 0.5
    out = []
    for _ in range(2):
        v = torch.randn(B, n, generator=gen, device="cuda")
        v *= (lim * torch.rand(B, 1, generator=gen, device="cuda")
              / v.norm(dim=1, keepdim=True))
        out.append(v)
    out[1][0] = out[0][0]
    return out


def _lorentz_points(B, n, kval, gen):
    """Rows x, y (B, n) ambient on the hyperboloid, tangent norms ~0.7 R."""
    from mvae_torch.ops import lorentz
    k = torch.tensor(kval, device="cuda")
    scale = 0.7 / ((n - 1) * -kval) ** 0.5
    out = [lorentz.exp_map_mu0(scale * torch.randn(
        B, n - 1, generator=gen, device="cuda"), k) for _ in range(2)]
    out[1][0] = out[0][0]
    return out


def _dist_row(name, line, fn, ref, x, y, k, err, kernel_name):
    """Times of one distance kernel at (x, y, k) beside its bytes bound."""
    B, n = x.shape
    ms, trace = kernel_ms(lambda: fn(x, y, k), kernel_name, 20)
    plain_ms = time_ms(lambda: ref(x, y, k), 5)
    nbytes = 4 * (2 * B * n + 1 + B)
    ops = B * (6 * n + 40)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    print(f"[dist] {name} at (B, n) = ({B}, {n}), K = {float(k):g}: kernel "
          f"{ms * 1e3:.2f} us ({nbytes / ms / 1e6:.1f} GB/s; graph events; "
          f"{trace}), plain composition {plain_ms * 1e3:.1f} "
          f"us, bytes bound {bytes_ms * 1e3:.2f} us ({nbytes} B), ops bound "
          f"{ops_ms * 1e3:.2f} us")
    return {"name": name, "route": "cuda",
            "source": "mvae_torch/kernels/csrc/manifold_dist.cu",
            "replaces": f"mvae_tpu/kernels/manifold_kernels.py:{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def phase_dist(gen) -> tuple[list[dict], dict]:
    """B7a and B7b against their plain versions (within 1e-5 (1 + |ref|) on
    every entry float32 resolves: the kernels sum a row across a warp, the
    plain versions in PyTorch's order), their times at the roofline shape,
    then the entry points driven with the counts read around them."""
    from mvae_torch import kernels
    from mvae_torch.ops import lorentz, stereographic
    big, small = (1 << 20, 128), (1000, 6)
    err_s = err_l = worst = 0.0
    for B, n in (big, small):
        for kval in (-1.0, -1e-3, 0.0, 1e-3, 1.0):
            x, y = _stereo_points(B, n, kval, gen)
            k = torch.tensor(kval, device="cuda")
            d = manifold_kernels.stereo_distance(x, y, k)
            d_r = manifold_kernels.stereo_distance_ref(x, y, k)
            d64 = manifold_kernels.stereo_distance_ref(x.double(), y.double(),
                                                       k.double())
            lib = stereographic.distance(x, y, k)
            torch.cuda.synchronize()
            check(d.shape == (B,), "B7a output shape")
            r, e = held(d[1:], d_r[1:], d64[1:], 1e-5 * (1 + d_r[1:].abs()),
                        f"B7a at ({B}, {n}), K={kval}")
            # at x = y the Gram form cancels a^2 |x|^2 + b^2 |y|^2 against
            # 2 a b <x, y>: what float32 leaves of it is a residue of
            # ~sqrt(eps) |x| in the Mobius difference (the reference's own
            # test bounds it by 5e-3 at |x| < 1), times the conformal factor
            x2 = float((x[0] * x[0]).sum())
            bound = 5e-3 * (1 + x2 ** 0.5) / abs(1 + kval * x2)
            check(float(d[0]) <= bound and float(d_r[0]) <= bound,
                  f"B7a d(x, x) = {float(d[0]):.3g} (plain "
                  f"{float(d_r[0]):.3g}) within {bound:.3g} at ({B}, {n}), "
                  f"K={kval}")
            # the library op (vector form) is the same distance away from
            # the Gram form's cancellation at x ~ y
            far = d_r > 1e-2 * (1.0 if kval == 0 else abs(kval) ** -0.5)
            lib_gap = ((lib - d_r).abs() / (1 + d_r.abs()))[far].max().item()
            check(lib_gap <= 1e-4, f"B7a plain version agrees with "
                                   f"ops.stereographic.distance: {lib_gap:.3g}")
            err_s, worst = max(err_s, e), max(worst, r)
        for kval in (-1.0, -1e-3, -4.0):
            x, y = _lorentz_points(B, n, kval, gen)
            k = torch.tensor(kval, device="cuda")
            d = manifold_kernels.lorentz_distance(x, y, k)
            d_r = manifold_kernels.lorentz_distance_ref(x, y, k)
            d64 = manifold_kernels.lorentz_distance_ref(
                x.double(), y.double(), k.double())
            torch.cuda.synchronize()
            r, e = held(d, d_r, d64, 1e-5 * (1 + d_r.abs()),
                        f"B7b at ({B}, {n}), K={kval}")
            check(float(d[0]) <= 1e-6 * (-kval) ** -0.5,
                  f"B7b d(x, x) = {float(d[0]):.3g} at ({B}, {n}), K={kval}")
            err_l, worst = max(err_l, e), max(worst, r)
    print(f"[dist] 16 cases: worst share of 1e-5 (1 + |ref|) on resolved "
          f"entries {worst:.3g}; largest error B7a {err_s:.3g}, B7b "
          f"{err_l:.3g}")
    rows = []
    for kval in (-1.0, 1.0):
        x, y = _stereo_points(*big, kval, gen)
        row = _dist_row("stereo_dist", 161, manifold_kernels.stereo_distance,
                        manifold_kernels.stereo_distance_ref, x, y,
                        torch.tensor(kval, device="cuda"), err_s,
                        "stereo_dist_kernel")
        lib_ms = time_ms(lambda: stereographic.distance(
            x, y, torch.tensor(kval, device="cuda")), 5)
        print(f"[dist] ops.stereographic.distance (vector form) at the same "
              f"inputs: {lib_ms * 1e3:.1f} us")
    rows.append(row)
    x, y = _lorentz_points(*big, -1.0, gen)
    k = torch.tensor(-1.0, device="cuda")
    rows.append(_dist_row("lorentz_dist", 221,
                          manifold_kernels.lorentz_distance,
                          manifold_kernels.lorentz_distance_ref, x, y, k,
                          err_l, "lorentz_dist_kernel"))
    lib_ms = time_ms(lambda: lorentz.distance(x, y, k), 5)
    print(f"[dist] ops.lorentz.distance at the same inputs: "
          f"{lib_ms * 1e3:.1f} us")
    xs, ys = _stereo_points(*small, -1.0, gen)
    xl, yl = _lorentz_points(*small, -1.0, gen)
    for name, fn, a, b, kern in (
            ("stereo_dist", manifold_kernels.stereo_distance, xs, ys,
             "stereo_dist_kernel"),
            ("lorentz_dist", manifold_kernels.lorentz_distance, xl, yl,
             "lorentz_dist_kernel")):
        small_ms, small_trace = kernel_ms(lambda: fn(a, b, k), kern, 100)
        print(f"[dist] {name} at (1000, 6): kernel {small_ms * 1e3:.2f} us "
              f"(graph events; {small_trace})")

    # the distance entry points as a user calls them: the package's exports
    # on (B, n) point sets, the big shape forward and the small one with the
    # gradients in x, y and K (backward through the library op)
    counted = {"stereo_dist": manifold_kernels.stereo_distance,
               "lorentz_dist": manifold_kernels.lorentz_distance}
    for fn in counted.values():
        fn.launches = 0
    xb, yb = _stereo_points(*big, 1.0, gen)
    d_big = kernels.stereo_distance(xb, yb, torch.tensor(1.0, device="cuda"))
    dl_big = kernels.lorentz_distance(x, y, k)
    grads = []
    for fn, a, b in ((kernels.stereo_distance, xs, ys),
                     (kernels.lorentz_distance, xl, yl)):
        a, b = a[1:].clone().requires_grad_(), b[1:].clone().requires_grad_()
        kk = k.clone().requires_grad_()
        fn(a, b, kk).sum().backward()
        grads += [a.grad, b.grad, kk.grad]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    check(bool(torch.isfinite(d_big).all() and torch.isfinite(dl_big).all()),
          "distances of the entry points finite")
    check(float(d_big.max()) <= math.pi + 1e-4,
          "K = 1 distances at most pi R")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          "distance gradients finite")
    check(launches == {"stereo_dist": 2, "lorentz_dist": 2},
          f"each distance entry point launched its kernel: {launches}")
    print(f"[dist] entry points: mean d on P^128 (K = 1) "
          f"{d_big.mean().item():.4f}, on H^127 (K = -1) "
          f"{dl_big.mean().item():.4f}; launches {launches}")
    return rows, launches


def phase_sphere_train(ds, tmp) -> tuple[dict, Trainer]:
    """One epoch of s6:wrapped at full width with burn-in off: B1 and B3
    (with the sphere tile) once per step, the curvature moves, every
    statistic finite under the non-finite guard."""
    trainer = _flagship(ds, f"{tmp}/sphere", SPHERE_SPEC, seed=0, epochs=1,
                        burnin_epochs=0)
    with torch.no_grad():
        k0 = float(trainer.model_cfg.components[0].curvature(
            trainer.params["components"][0]))
    check(trainer.fused_paths["train_tail"]["active"]
          and not trainer.fused_paths["iwae_reparam"][0]["active"],
          f"training routed through B1/B3: {trainer.fused_paths}")
    counted = {"tail_fwd": tail_kernels.tail_forward,
               "tail_bwd": tail_kernels.tail_backward,
               "decode_bce": decoder_kernels.fused_decode_bce_t}
    for fn in counted.values():
        fn.launches = 0
    result = trainer.fit(verbose=True, ll_max_examples=1024)
    launches = {name: fn.launches for name, fn in counted.items()}
    steps = trainer.step
    rec = result["history"][0]
    print(f"[train] {SPHERE_SPEC} h_dim 400, batch 128, {steps} steps: "
          f"{result['train_steps_per_sec']:.1f} train steps/s (first epoch, "
          f"warm-up included), train ELBO {rec['train/elbo']:.4f}, IWAE-500 "
          f"on 1024 test examples {result['test/log_likelihood_iwae']:.4f}; "
          f"launches {launches}")
    check(all(math.isfinite(v) for v in rec.values()),
          "finite statistics of the s6:wrapped epoch")
    check(math.isfinite(result["test/log_likelihood_iwae"]), "finite IWAE")
    check(launches["tail_bwd"] == steps, "B3 launched once per step")
    check(launches["tail_fwd"] >= steps, "B1 launched at least once a step")
    check(launches["decode_bce"] == 2 * 4,
          "B2 launched 2 batches x 4 chunks in the final IWAE")
    k1 = rec["train/curvature/s6#0"]
    check(k1 != k0, "curvature s6#0 moves with burn-in off")
    print(f"[train] curvature K(s6) {k0} -> {k1}")
    rates = [_epoch_rate(trainer, 10 + i) for i in range(2)]
    print(f"[train] {SPHERE_SPEC} steps/s by epoch: "
          + ", ".join(f"{r:.1f}" for r in rates))
    profile_pass(f"{SPHERE_SPEC} train epoch ({trainer.steps_per_epoch} "
                 f"steps)", lambda: trainer.train_one_epoch(20), layers=True)
    return launches, trainer


def _sample_check(trainer, what: str) -> None:
    """``generate(16)`` and ``reconstruct`` of 16 test examples on the card:
    Bernoulli means of the data's shape, finite, in [0, 1]."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    with torch.no_grad():
        out = vae.generate(trainer.model_cfg, trainer.params, 16, gen)
        x = (trainer._test_data[:16] > 0.5).float()
        rec = vae.reconstruct(trainer.model_cfg, trainer.params, x,
                              generator=gen)
    torch.cuda.synchronize()
    for name, t in (("generate", out), ("reconstruct", rec)):
        check(t.is_cuda and tuple(t.shape) == (16,)
              + tuple(trainer.model_cfg.data_shape),
              f"{what}: {name} shape {tuple(t.shape)} on the card")
        check(bool(torch.isfinite(t).all()) and float(t.min()) >= 0.0
              and float(t.max()) <= 1.0, f"{what}: {name} in [0, 1]")
    print(f"[generate] {what}: generate(16) mean {out.mean().item():.4f}, "
          f"reconstruct mean {rec.mean().item():.4f} (inputs "
          f"{x.mean().item():.4f})")


def phase_vmf(ds, tmp) -> None:
    """s6 (the vMF by rejection, m = 7) at full width: 150 steps with
    burn-in off, finite losses, then IWAE-500 on 1,024 examples (B2 decodes;
    the tail is plain PyTorch: the rejection cosine has no tile). Then
    p2:vmf,e2: the ELBO of one eval batch through the stereographic
    isometry."""
    trainer = _flagship(ds, f"{tmp}/s6", "s6", seed=0, burnin_epochs=0)
    check(not trainer.fused_paths["train_tail"]["active"]
          and trainer.fused_paths["iwae_decoder"]["active"],
          f"s6: plain tail, B2 decode: {trainer.fused_paths}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    perm = torch.randperm(len(trainer._train_data), device="cuda",
                          generator=gen)
    bs = trainer.tc.batch_size
    c = trainer.params["components"][0]["c_param"]
    torch.cuda.synchronize()
    t0 = time.time()
    elbos = torch.stack([trainer._train_step(
        trainer._train_data[perm[s * bs:(s + 1) * bs]])["elbo"]
        for s in range(150)])
    torch.cuda.synchronize()
    rate = 150 / (time.time() - t0)
    check(bool(torch.isfinite(elbos).all()),
          "s6: finite loss at every step")
    check(all(bool(torch.isfinite(t).all()) for t in _leaves(trainer.params)),
          "s6: finite parameters")
    check(float(elbos[-10:].mean()) > float(elbos[:10].mean()),
          "s6: the ELBO rises over 150 steps")
    decoder_kernels.fused_decode_bce_t.launches = 0
    ll = trainer.evaluate_log_likelihood("test", 1024)
    check(math.isfinite(ll), "s6: finite IWAE-500")
    check(decoder_kernels.fused_decode_bce_t.launches == 2 * 4,
          "s6: B2 launched 2 batches x 4 chunks")
    print(f"[s6] vMF m = 7 by rejection: 150 steps at {rate:.1f} steps/s "
          f"(warm-up included), ELBO {elbos[0].item():.3f} -> "
          f"{elbos[-1].item():.3f}, K(s6) {math.exp(float(c.detach())):.4f}; IWAE-500 "
          f"on 1024 test examples {ll:.4f}")
    _sample_check(trainer, "s6")

    pv = _flagship(ds, f"{tmp}/p2vmf", "p2:vmf,e2", seed=0, burnin_epochs=0)
    x = (pv._test_data[:512] > 0.5).float()
    with torch.no_grad():
        value, stats = vae.elbo(pv.model_cfg, pv.params, x,
                                generator=pv.generator)
    check(tuple(value.shape) == (512,) and bool(torch.isfinite(value).all()),
          "p2:vmf,e2: finite per-example ELBO of one batch")
    check(bool((stats["kl_per_comp"] >= 0).all()),
          "p2:vmf,e2: the analytic KLs are non-negative")
    for _ in range(20):
        pv._train_step(pv._train_data[:bs])
    check(all(bool(torch.isfinite(t).all()) for t in _leaves(pv.params)),
          "p2:vmf,e2: finite parameters after 20 steps")
    print(f"[p2:vmf,e2] ELBO of one 512-example batch "
          f"{stats['elbo'].item():.4f}, KL per component "
          f"{stats['kl_per_comp'].tolist()}")
    _sample_check(pv, "p2:vmf,e2")


def _probe_row(name, line, t, plain_ms, err, nbytes, ops, library_ms=None):
    """One B8 probe's entry of the kernels line: ``t`` its timing from
    ``roofline.main`` (the main path of this phase), its bound from this
    run's shapes."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"name": name, "route": "cuda",
            "source": "mvae_torch/kernels/csrc/roofline_probes.cu",
            "replaces": f"mvae_tpu/kernels/roofline.py:{line}",
            "max_abs_err": err, "ms": t["us"] / 1e3, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def _roofline_rows_held(rl) -> None:
    """B7a, B7b, B5, B2, B1 and B3 held to their plain versions on the
    inputs of ``roofline.main()``'s rows, at the tolerances of the earlier
    phases (B1 and B3: phases 3 and 6, every row: heads of training
    size)."""
    k = torch.tensor(-1.0, device="cuda")
    errs = {}
    for tag, inputs, fn, ref in (
            ("B7a", rl.stereo_inputs, manifold_kernels.stereo_distance,
             manifold_kernels.stereo_distance_ref),
            ("B7b", rl.lorentz_inputs, manifold_kernels.lorentz_distance,
             manifold_kernels.lorentz_distance_ref)):
        x, y = inputs()
        d, d_r = fn(x, y, k), ref(x, y, k)
        d64 = ref(x.double(), y.double(), k.double())
        torch.cuda.synchronize()
        errs[tag] = held(d, d_r, d64, 1e-5 * (1 + d_r.abs()),
                         f"{tag} on its roofline row's inputs")[1]
        del x, y, d, d_r, d64
    eps, mu, sig, _, _ = rl.reparam_sets(1)[0]
    got = manifold_kernels.wrapped_reparam_stereo_t(eps, mu, sig, k, sign=-1)
    ref = manifold_kernels.wrapped_reparam_stereo_ref(eps, mu, sig, k,
                                                      sign=-1)
    ref64 = manifold_kernels.wrapped_reparam_stereo_ref(
        eps.double(), mu.double(), sig.double(), k.double(), sign=-1)
    torch.cuda.synchronize()
    errs["B5"] = 0.0
    for ours, r, r64, name in zip(got, ref, ref64, ("z", "log q", "log p")):
        tol = (1e-5 * (1 + r.abs()) if name == "z"
               else 1e-4 * (1 + 1e-2 * r.abs()))
        errs["B5"] = max(errs["B5"], held(
            ours, r, r64, tol, f"B5 {name} on its roofline row's inputs")[1])
    args = rl.decode_sets(1)[0]
    out = decoder_kernels.fused_decode_bce_t(*args)
    ref = decoder_kernels.decode_bce_ref(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "B2 finite on its roofline row")
    errs["B2"] = (out - ref).abs().max().item()
    check(errs["B2"] <= 1e-3, f"B2 within 1e-3 nats per row of its plain "
                              f"version on its roofline row's inputs")
    for spec, kset, kern, B in rl.TAIL_ROWS:
        comps, *args = rl.tail_inputs(spec, kset, B)
        what = f"{kern} {spec} on its roofline row's inputs (B={B})"
        if kern == "B1":
            z, aux = tail_kernels.tail_forward(comps, *args[:3])
            z_r, aux_r = tail_kernels.tail_forward_ref(comps, *args[:3])
            torch.cuda.synchronize()
            check(bool(((z - z_r).abs() <= 1e-5 * (1 + z_r.abs())).all()
                       and ((aux - aux_r).abs()
                            <= 1e-4 * (1 + 1e-2 * aux_r.abs())).all()),
                  f"{what}: B1 within its contract")
            errs[f"{kern} {spec} {B}"] = max(
                (z - z_r).abs().max().item(), (aux - aux_r).abs().max().item())
            if not (torch.equal(z, z_r) and torch.equal(aux, aux_r)):
                print(f"[roofline] {what}: B1 not bit-equal to its plain "
                      f"version")
        else:
            draw, _, dk = tail_kernels.tail_backward(comps, *args)
            draw_r, _, dk_r = tail_kernels.tail_backward_ref(comps, *args)
            torch.cuda.synchronize()
            check(bool(((draw - draw_r).abs()
                        <= 1e-3 * draw_r.abs() + 5e-4).all()
                       and ((dk - dk_r).abs()
                            <= 2e-3 * dk_r.abs() + 5e-4).all()),
                  f"{what}: B3 within the float32 backward contract")
            errs[f"{kern} {spec} {B}"] = (draw - draw_r).abs().max().item()
    print("[roofline] rows' kernels against their plain versions on the "
          "rows' inputs, largest error on resolved entries: "
          + ", ".join(f"{t} {e:.3g}" for t, e in errs.items())
          + " (B2 in nats per row)")


def _previous_twin_stereo(built, x, y, resident):
    """B8e's previous design on the wrapper's arguments (not counted)."""
    out = torch.empty(x.shape[0], device="cuda")
    _build.check(built["previous_twin_stereo"](
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
        int(resident), torch.cuda.current_stream().cuda_stream),
        "previous twin_stereo_launch")
    return out


def _previous_twin_reparam(built, eps, mu, sig, k, hoist, out, sign):
    """B8f's previous design on the wrapper's arguments (z into all of
    ``out``; not counted)."""
    S, B, n = eps.shape
    lq = torch.empty(S, B, device="cuda")
    lp = torch.empty(S, B, device="cuda")
    _build.check(built["previous_twin_reparam"](
        eps.data_ptr(), eps.stride(1), mu.data_ptr(), sig.data_ptr(),
        hoist.data_ptr(), k.reshape(1).data_ptr(), out.data_ptr(), 0,
        lq.data_ptr(), lp.data_ptr(), S, B, n, out.shape[1],
        manifold_kernels.reparam_spt(S, B, n, sign),
        torch.cuda.current_stream().cuda_stream),
        "previous twin_reparam_launch")
    return out, lq, lp


def _in_turns(first, second) -> tuple:
    """first, second, second, first: the two means and the four times."""
    turns = [first(), second(), second(), first()]
    return (roofline.mean_timing(turns[0], turns[3]),
            roofline.mean_timing(turns[1], turns[2]), turns)


def _twin_turns(rl, built) -> dict:
    """B8e (resident and streaming) and B8f in turns with their previous
    design (new, previous, previous, new) on the rows' inputs, each
    previous held to the plain version too; B8f in turns with B5 (twin,
    B5, B5, twin) at the production chunk, sign -1, over the row's rotating
    buffer sets. Returns each new twin's mean time in its turns (ms)."""
    x, y = rl.stereo_inputs()
    out = {}
    for resident, label in ((True, "resident"), (False, "streaming")):
        ref = rl.twin_stereo_ref(x, y, resident)
        prev = _previous_twin_stereo(built, x, y, resident)
        torch.cuda.synchronize()
        d = (prev - ref).abs()
        check(bool((d <= 1e-4 * (ref.abs() + 1e-2 * ref.abs().max()))
                   .all()), f"B8e's previous design ({label}) within its "
                            f"tolerance of the plain version")
        new_t, prev_t, turns = _in_turns(
            lambda: rl.measure(lambda: rl.twin_stereo(x, y, resident),
                               "twin_stereo_resident_kernel" if resident
                               else "twin_stereo_kernel"),
            lambda: rl.measure(
                lambda: _previous_twin_stereo(built, x, y, resident),
                "twin_stereo_kernel"))
        print(f"[roofline] B8e twin_stereo {label} at {(rl.B, rl.N)}: "
              f"{new_t.us:.3f} us, previous design {prev_t.us:.3f} us in "
              f"turns (new, previous, previous, new: "
              f"{', '.join(f'{t.us:.3f}' for t in turns)} us; CUPTI trace "
              f"medians {new_t.trace_us}, {prev_t.trace_us}): "
              f"{prev_t.us / new_t.us:.2f}x")
        if resident:
            out["twin_stereo"] = new_t.us / 1e3
            check(new_t.us < prev_t.us, "B8e's resident twin faster than "
                                        "its previous design")
    del x, y, ref, prev
    k = torch.tensor(-1.0, device="cuda")
    sets = rl.reparam_sets(rl.buffer_sets(
        rl.reparam_bytes(rl.RS, rl.RB, rl.RN), rl._l2_bytes()))
    e, m, sg, o, c = sets[0]
    ref = rl.twin_reparam_ref(e, m, sg, k, c)
    prev = _previous_twin_reparam(built, e, m, sg, k, c, torch.empty_like(o),
                                  -1)
    torch.cuda.synchronize()
    for got, r in zip(prev, ref):
        check(bool(((got - r).abs()
                    <= 1e-4 * (r.abs() + 1e-2 * r.abs().max())).all()),
              "B8f's previous design within its tolerance of the plain "
              "version")

    def twin(calls=rl.REPARAM_ROW_CALLS):
        return rl.measure([functools.partial(rl.twin_reparam, *a[:3], k,
                                             a[4], out=a[3], sign=-1)
                           for a in sets], "twin_reparam_kernel", calls)

    def previous():
        return rl.measure([functools.partial(_previous_twin_reparam, built,
                                             *a[:3], k, a[4], a[3], -1)
                           for a in sets], "twin_reparam_kernel",
                          rl.REPARAM_ROW_CALLS)

    def b5(calls=rl.REPARAM_ROW_CALLS):
        return rl.measure([functools.partial(
            manifold_kernels.wrapped_reparam_stereo_t, *a[:3], k, out=a[3],
            sign=-1) for a in sets], "reparam_stereo_kernel", calls)

    def skel(calls):
        return rl.measure([functools.partial(rl.skel_reparam, *a[:3], k,
                                             a[4], out=a[3], sign=-1)
                           for a in sets], "skel_reparam_kernel", calls)

    # B5's row at the parent's calls a graph (ITERS) and at this row's
    # (REPARAM_ROW_CALLS), each kernel in turns (fewer, more, more, fewer)
    calls = (rl.ITERS, rl.REPARAM_ROW_CALLS)
    yard = {}
    for name, f in (("B5", b5), ("skeleton", skel), ("B8f", twin)):
        few, many, _ = _in_turns(lambda: f(calls[0]), lambda: f(calls[1]))
        yard[name] = (few.us, many.us)
    print(f"[roofline] B5's row at {calls[0]} and {calls[1]} calls a graph "
          f"(each in turns {calls[0]}, {calls[1]}, {calls[1]}, {calls[0]}): "
          + ", ".join(f"{k} {a:.3f} / {b:.3f} us" for k, (a, b)
                      in yard.items())
          + "; skeleton / B5 "
          + " / ".join(f"{100 * yard['skeleton'][i] / yard['B5'][i]:.1f}%"
                       for i in (0, 1)))
    out["twin_reparam_calls"] = {c: yard["B8f"][i] / 1e3
                                 for i, c in enumerate(calls)}

    new_t, prev_t, turns = _in_turns(twin, previous)
    tw_t, b5_t, b5_turns = _in_turns(twin, b5)
    shape = f"({rl.RS}, {rl.RB}, {rl.RN}), sign -1, {len(sets)} buffer sets"
    print(f"[roofline] B8f twin_reparam at {shape}: {new_t.us:.3f} us, "
          f"previous design {prev_t.us:.3f} us in turns (new, previous, "
          f"previous, new: {', '.join(f'{t.us:.3f}' for t in turns)} us; "
          f"CUPTI trace medians {new_t.trace_us}, {prev_t.trace_us}): "
          f"{prev_t.us / new_t.us:.2f}x")
    print(f"[roofline] B8f against B5 in turns (twin, B5, B5, twin: "
          f"{', '.join(f'{t.us:.3f}' for t in b5_turns)} us): twin "
          f"{tw_t.us:.3f} us, B5 {b5_t.us:.3f} us, twin / B5 "
          f"{tw_t.us / b5_t.us:.3f}")
    check(new_t.us < prev_t.us, "B8f faster than its previous design")
    check(tw_t.us <= b5_t.us, "B8f no slower than B5 in turns: a floor B5 "
                              "cannot beat")
    out["twin_reparam"] = (new_t.us + tw_t.us) / 2e3
    return out


def phase_roofline(gen, built) -> tuple[list[dict], dict]:
    """B8: every probe kernel against its plain version at the roofline
    shapes, then ``roofline.main()`` (calibration and the B7a, B7b, B5, B2
    rows) with the probes' launch counts read around it; then each row's
    kernel held to its plain version on the inputs the row timed."""
    from mvae_torch.kernels import roofline as rl
    B, N, R = rl.B, rl.N, rl.CAL_REPEAT
    x = 0.05 * torch.randn(B, N, generator=gen, device="cuda")
    y = 0.05 * torch.randn(B, N, generator=gen, device="cuda")
    err, plain = {}, {}

    def close(name, got, ref, tol):
        d = (got - ref).abs()
        check(bool(torch.isfinite(got).all()) and bool((d <= tol).all()),
              f"{name} within its tolerance of the plain version: max "
              f"{d.max().item():.3g}")
        err[name] = max(err.get(name, 0.0), d.max().item())

    def timed(name, fn, iters=3, warm=2):
        plain[name] = time_ms(fn, iters, warm)

    close("probe_triad", rl.probe_triad(x, y), rl.probe_triad_ref(x, y), 0.0)
    timed("probe_triad", lambda: rl.probe_triad_ref(x, y))
    for repeat in (1, R):             # rel 1e-5: fmaf rounds once
        ref = rl.probe_fma_ref(x, repeat)
        close("probe_fma", rl.probe_fma(x, repeat), ref, 1e-5 * ref.abs())
    timed("probe_fma", lambda: rl.probe_fma_ref(x, R), 1, 0)
    for repeat in (1, R):             # 4 ulp for each tanh of a chain
        ref = rl.probe_tanh_ref(x, repeat)
        close("probe_tanh", rl.probe_tanh(x, repeat), ref,
             4 * 4 * repeat * torch.finfo(torch.float32).eps * ref.abs())
    timed("probe_tanh", lambda: rl.probe_tanh_ref(x, R), 1, 1)
    # folds: 1e-5 of the row's absolute sum (warp order against PyTorch's)
    fold = 8 * (x.abs() + 7.0).sum(1, keepdim=True)
    close("probe_reduce", rl.probe_reduce(x), rl.probe_reduce_ref(x),
         1e-5 * fold)
    timed("probe_reduce", lambda: rl.probe_reduce_ref(x))
    fold = 8 * (x[:, :8].abs() + 7.0).sum(1, keepdim=True)
    close("probe_transpose", rl.probe_transpose(x), rl.probe_transpose_ref(x),
         1e-5 * fold)
    timed("probe_transpose", lambda: rl.probe_transpose_ref(x))
    fold = x.abs().sum(1) + y.abs().sum(1) + x[:, 0].abs() + y[:, 0].abs()
    for variant in ("rowstore", "block"):
        close("skel_dist", rl.skel_dist(x, y, variant),
             rl.skel_dist_ref(x, y, variant), 1e-5 * fold)
    timed("skel_dist", lambda: rl.skel_dist_ref(x, y, "rowstore"))
    for resident in (True, False):    # rel 1e-4, floored at 1% of the max
        ref = rl.twin_stereo_ref(x, y, resident)
        close("twin_stereo", rl.twin_stereo(x, y, resident), ref,
             1e-4 * (ref.abs() + 1e-2 * ref.abs().max()))
    timed("twin_stereo", lambda: rl.twin_stereo_ref(x, y, True))
    eps = torch.randn(rl.RS, rl.RB, rl.RN, generator=gen, device="cuda")
    k = torch.tensor(-1.0, device="cuda")
    from mvae_torch.ops import stereographic
    mu = stereographic.exp_map_mu0(
        0.4 * torch.randn(rl.RB, rl.RN, generator=gen, device="cuda"), k)
    sig = 0.5 + 0.7 * torch.rand(rl.RB, rl.RN, generator=gen, device="cuda")
    hoist = rl.reparam_scalars(mu, sig)
    zt, lq, lp = rl.skel_reparam(eps, mu, sig, k, hoist)
    z_r, lq_r, _ = rl.skel_reparam_ref(eps, mu, sig, k, hoist)
    close("skel_reparam", zt, z_r, 0.0)
    scale = (mu.abs().sum(1) + sig.abs().sum(1) + sig.log().abs().sum(1)
             + sig.min(1).values + (mu * mu).sum(1) + 1.0)
    close("skel_reparam", lq, lq_r, 1e-5 * scale)
    close("skel_reparam", lp, lq_r, 1e-5 * scale)
    timed("skel_reparam", lambda: rl.skel_reparam_ref(eps, mu, sig, k, hoist))
    for got, ref in zip(rl.twin_reparam(eps, mu, sig, k, hoist),
                        rl.twin_reparam_ref(eps, mu, sig, k, hoist)):
        close("twin_reparam", got, ref,
             1e-4 * (ref.abs() + 1e-2 * ref.abs().max()))
    timed("twin_reparam", lambda: rl.twin_reparam_ref(eps, mu, sig, k, hoist))
    # B8f's other instantiation families: n = 2 on the d2,p2,e2 chunk and a
    # generic n (5)
    for n in (2, 5):
        e2 = torch.randn(rl.RS, 512, n, generator=gen, device="cuda")
        m2 = stereographic.exp_map_mu0(
            0.4 * torch.randn(512, n, generator=gen, device="cuda"), k)
        s2 = 0.5 + 0.7 * torch.rand(512, n, generator=gen, device="cuda")
        h2 = rl.reparam_scalars(m2, s2)
        for got, ref in zip(rl.twin_reparam(e2, m2, s2, k, h2),
                            rl.twin_reparam_ref(e2, m2, s2, k, h2)):
            close("twin_reparam", got, ref,
                 1e-4 * (ref.abs() + 1e-2 * ref.abs().max()))
    del e2, m2, s2, h2
    for spec, kset in rl.TAIL_SPECS:
        for bt in (128, 512, 1000):
            comps, *args = rl.tail_inputs(spec, kset, bt)
            for got, ref in ((rl.skel_tail(comps, *args[:3]),
                              rl.skel_tail_ref(comps, *args[:3])),
                             (rl.skel_tail(comps, *args),
                              rl.skel_tail_ref(comps, *args))):
                for g, r in zip(got, ref):
                    close("skel_tail", g, r, 0.0)
    comps, *args = rl.tail_inputs(SPEC, (-1.0, 1.0, 0.0), 128)
    timed("skel_tail", lambda: rl.skel_tail_ref(comps, *args))
    # x.sum(1) writes (rows,) where the reduce probe writes the full matrix
    # of its tree sums: not the probe's function, so no library_ms
    print(f"[roofline] x.sum(1) at {(B, N)} (not the reduce probe's "
          f"function): {library_ms(lambda: x.sum(1)) * 1e3:.1f} us")
    print(f"[roofline] 10 probes held to their plain versions: largest "
          f"errors {', '.join(f'{k} {v:.3g}' for k, v in err.items())}")
    del x, y, ref

    for fn in rl.PROBES:
        fn.launches = 0
    t0 = time.time()
    result = rl.main()
    launches = {fn.__name__: fn.launches for fn in rl.PROBES}
    cal = result["calibration"]
    print(f"[roofline] {result['card']}: roofline.main() in "
          f"{time.time() - t0:.1f} s; launches {launches}")
    for name, (lo, hi) in rl.SANITY.items():
        print(f"[roofline] calibration {name} = {cal[name]:.6g} (window "
              f"{lo:g} .. {hi:g})")
        check(lo <= cal[name] <= hi, f"calibrated {name} in its window")
    print("[roofline] probe times, us per launch by CUDA events around a "
          "CUDA-graph replay (CUPTI trace median): " + ", ".join(
              f"{k} {t['us']:.3f} ({t['trace_us']})"
              for k, t in result["probes"].items()))
    turns = ", ".join(f"{u:.1f}" for u in cal["triad_turns_us"])
    print(f"[roofline] triad in turns with torch.add(x, y, out=o) (triad, "
          f"add, add, triad: {turns} us): {cal['stream_gbps']:.1f} against "
          f"{cal['library_stream_gbps']:.1f} GB/s, time ratio "
          f"{cal['triad_over_library']:.4f}")
    print(f"[roofline] calibration reduce_us = {cal['reduce_us']:.6g} per "
          f"row reduction, transpose_us = {cal['transpose_us']:.6g} per "
          f"(2048, 8) relayout; fma and tanh at repeat {cal['repeat']}")
    for row in result["rows"]:
        peak = next(v for k, v in row.items()
                    if k.startswith("pct_of_") and k.endswith("_peak"))
        trace = row["timings"]["kernel"]["trace_us"]
        errs = {k: v for k, v in row.items() if "err" in k}
        print(f"[roofline] {row['kernel']} at {row['shape']}: "
              f"{row['us']:.3f} us (CUPTI trace median "
              f"{'none' if trace is None else f'{trace:.3f} us'}), "
              f"{peak:.1f}% of the data-sheet peak; "
              f"floors {row['floors_us']} -> binding "
              f"{row['binding_floor_us']:.3f} us ({row['bound_by']}), "
              f"{row['pct_of_binding']:.1f}% of it; plain "
              f"{row['plain_us']:.1f} us; l2 {row['l2']}; errors {errs}"
              + (f"; streaming twin {row['twin_streaming_us']:.3f} us"
                 if "twin_streaming_us" in row else "")
              + (f"; twin {row['twin_us']:.3f} us; operations {row['ops']}"
                 if "twin_us" in row else ""))
        check(row["pct_of_binding"] <= 105.0 and peak <= 105.0,
              f"{row['kernel']} within 105% of its floor and its peak")
    dec = result["rows"][3]
    print(f"[roofline] B2 (3xTF32): {dec['us']:.1f} us, "
          f"{dec['pct_of_tf32_peak']:.1f}% of the TF32 peak ("
          f"{dec['tflops']:.1f} TFLOP/s of 3xTF32 products); floors "
          f"{ {k: round(v, 3) for k, v in dec['floors_us'].items()} } us; "
          f"the FP32 floor (not binding) {dec['fp32_calibrated_floor_us']:.1f}"
          f" us calibrated, {dec['fp32_peak_us']:.1f} us at 67 TFLOP/s")
    print(f"[roofline] B2 yardsticks in turns (kernel, library, library, "
          f"kernel: {', '.join(f'{u:.1f}' for u in dec['turns_us'])} us): "
          f"two cuBLAS FP32 SGEMMs {dec['two_sgemm_fp32_us']:.1f} us, the "
          f"kernel {dec['two_sgemm_fp32_us'] / dec['us']:.2f}x faster; the "
          f"composition with TF32 {dec['two_gemm_tf32_us']:.1f} us; error "
          f"vs FP32: kernel {dec['max_abs_err_nats_vs_fp32']:.3g}, TF32 "
          f"{dec['tf32_max_abs_err_nats_vs_fp32']:.3g} nats; vs f64: kernel "
          f"{dec['max_abs_err_nats_vs_f64']:.3g}, FP32 "
          f"{dec['fp32_max_abs_err_nats_vs_f64']:.3g} nats")
    check(all(v > 0 for v in launches.values()),
          f"every B8 probe launched by roofline.main(): {launches}")
    _roofline_rows_held(rl)
    twin_turns = _twin_turns(rl, built)

    p = result["probes"]
    words = B * N
    sb = rl.RS * rl.RB
    # both read the hoisted (3, B) scalars; the twin reads mu_0 and sigma_0
    # of mu and sigma, the skeleton every word
    skel_bytes = rl.reparam_bytes(rl.RS, rl.RB, rl.RN) + 4 * 3 * rl.RB
    twin_bytes = 4 * (2 * sb * rl.RN + 2 * sb + 5 * rl.RB + 1)
    # the tanh probe's 16 accurate tanhf a word and repeat, each the
    # instructions its SASS loop spends on one (phase 2), priced as FMAs
    tanh_flop = words * (2 * 16 * R * built["tanh_per"] + 7)
    tanh_us = tanh_flop / FP32_FLOPS_PER_S * 1e6
    print(f"[roofline] tanh probe's bound: {built['tanh_per']:.2f} "
          f"instructions a tanhf at the data sheet's FMA rate, "
          f"{tanh_us / 1e3:.3f} ms against {p['probe_tanh']['us'] / 1e3:.3f} "
          f"ms ({100 * tanh_us / p['probe_tanh']['us']:.1f}%)")
    rows = [
        _probe_row("probe_triad", 328, p["probe_triad"], plain["probe_triad"],
                   err["probe_triad"], 12 * words, words,
                   cal["timings"]["triad_library"]["us"] / 1e3),
        _probe_row("probe_fma", 204, p["probe_fma"], plain["probe_fma"],
                   err["probe_fma"], 8 * words, words * (128 * R + 15)),
        _probe_row("probe_tanh", 204, p["probe_tanh"], plain["probe_tanh"],
                   err["probe_tanh"], 8 * words, tanh_flop),
        _probe_row("probe_reduce", 204, p["probe_reduce"],
                   plain["probe_reduce"], err["probe_reduce"], 8 * words,
                   16 * words),
        _probe_row("probe_transpose", 204, p["probe_transpose"],
                   plain["probe_transpose"], err["probe_transpose"],
                   4 * (8 * B + words), 128 * B),
        _probe_row("skel_dist", 373, p["skel_dist_rowstore"],
                   plain["skel_dist"], err["skel_dist"], 4 * (2 * words + B),
                   2 * words),
        _probe_row("skel_reparam", 410, p["skel_reparam"],
                   plain["skel_reparam"], err["skel_reparam"], skel_bytes,
                   sb * (2 * rl.RN + 4)),
        # the resident twin reads one 2048-row tile and writes a float a
        # row; its tail's transcendentals at their SASS instructions
        _probe_row("twin_stereo", 478, p["twin_stereo_resident"],
                   plain["twin_stereo"], err["twin_stereo"],
                   4 * (2 * rl.RESIDENT_ROWS * N + B),
                   2 * B * rl.twin_stereo_row_ops(N, built["twin_prices"])),
        _probe_row("twin_reparam", 552, p["twin_reparam"],
                   plain["twin_reparam"], err["twin_reparam"], twin_bytes,
                   sb * (18 * rl.RN + 2 * 120 + 4)),
    ]
    # the tail skeleton has no TPU counterpart: its row is the one at the
    # flagship's B3 (B = 128), the floor it prices
    tail = next(r for r in result["rows"]
                if r["kernel"] == f"B3 tail_bwd {SPEC}")
    comps = tuple(parse_components(SPEC, fixed_curvature=False))
    skel = _probe_row("skel_tail", 0, tail["timings"]["skeleton"],
                      plain["skel_tail"], err["skel_tail"],
                      rl.tail_bytes(comps, 128, True),
                      rl.tail_bytes(comps, 128, True) // 4)
    skel["replaces"] = "mvae_tpu/kernels/tail_kernels.py:735"
    rows.append(skel)
    # the twins' shares of their bounds (B8e's operations with the tail's
    # transcendentals at their SASS prices, B8f's bytes): at least half,
    # read in roofline.main() and in the turns
    for r in rows:
        if r["name"] in ("twin_stereo", "twin_reparam"):
            t_ms = twin_turns[r["name"]]
            share = 100 * r["bound_ms"] / r["ms"]
            turns_share = 100 * r["bound_ms"] / t_ms
            print(f"[roofline] {r['name']}: {r['ms'] * 1e3:.3f} us against "
                  f"its {r['bound_by']} bound {r['bound_ms'] * 1e3:.3f} us "
                  f"({share:.1f}%); in turns {t_ms * 1e3:.3f} us "
                  f"({turns_share:.1f}%)")
            if r["name"] == "twin_reparam":
                print("[roofline] twin_reparam by calls a graph: " + ", ".join(
                    f"{c}: {v * 1e3:.3f} us "
                    f"({100 * r['bound_ms'] / v:.1f}%)" for c, v
                    in twin_turns["twin_reparam_calls"].items()))
            check(share >= 50 and turns_share >= 50,
                  f"{r['name']} at half of its bound or better")
    print("[roofline] the tail's transcendentals in SASS instructions "
          "(common path): " + ", ".join(
              f"{k} {v:.2f}" for k, v in result["tail_prices"].items()))
    for (spec, _, kern, B), r in zip(rl.TAIL_ROWS, result["rows"][4:]):
        name = "tail_bwd" if kern == "B3" else "tail_fwd"
        warp = r["timings"].get("skeleton_warp")
        print(f"[roofline] {r['kernel']} at {r['shape']}: {r['us']:.3f} us "
              f"({_rowwise(name, spec, B)}); skeleton "
              f"{r['timings']['skeleton']['us']:.3f} us on the kernel's "
              f"grid ({r['geometry']})"
              + (f", {warp['us']:.3f} us on the warp-a-component grid"
                 if warp else "")
              + f" -> {r['floors_us']['skeleton']:.3f} us; operations "
              f"{r['ops']} ({r['fma_slots']:.0f} FMA slots, the "
              f"transcendentals at their SASS instructions: "
              f"{r['transcendentals']}) at the calibrated FMA rate "
              f"{r['floors_us']['operations']:.4f} us -> binding "
              f"{r['binding_floor_us']:.3f} us ({r['bound_by']}), "
              f"{r['pct_of_binding']:.1f}% of it")
    return rows, launches


def phase_trace(ds, tmp) -> None:
    """``fit(profile_epochs=1)`` of one short flagship epoch (20 steps)
    writes a Chrome trace holding the card's kernels."""
    import dataclasses
    import glob
    small = dataclasses.replace(ds, train=ds.train[:20 * 128],
                                test=ds.test[:512])
    trainer = _flagship(small, f"{tmp}/trace", seed=0, epochs=1,
                        burnin_epochs=0)
    t0 = time.time()
    trainer.fit(verbose=False, ll_max_examples=512, profile_epochs=1)
    files = glob.glob(f"{tmp}/trace/profile/trace_*.json")
    check(len(files) == 1, f"one trace written: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    tails = sum("tail_fwd_kernel" in e.get("name", "") for e in kernels)
    print(f"[trace] fit(profile_epochs=1), {trainer.step} steps, in "
          f"{time.time() - t0:.1f} s: {len(events)} events, "
          f"{len(kernels)} CUDA kernel events ({tails} of B1), "
          f"{os.path.getsize(files[0])} bytes")
    check(len(kernels) > 0 and tails > 0,
          "the trace holds CUDA kernel events, B1 among them")


# --- the Riemannian normal and the conv VAE ---------------------------------------


# the name each launch counter of ``launches.COUNTED`` but Adam's goes by in
# the checks and the printed counts
_SHORT = {"tail_forward": "tail_fwd", "tail_backward": "tail_bwd",
          "train_decode_bce": "train_decode",
          "fused_decode_bce_t": "decode_bce",
          "wrapped_reparam_stereo_t": "reparam_stereo",
          "reparam_chunk_t": "reparam_chunk"}


def _counted():
    """The launch counters of the kernels on the training and IWAE paths,
    by name."""
    return {_SHORT[f.__name__]: f for f in launches.COUNTED
            if f.__name__ in _SHORT}


def _zero_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def _steps(trainer, n: int) -> tuple[float, torch.Tensor]:
    """(steps/s, ELBOs) of ``n`` training steps on a fixed permutation,
    the wall ended by a device sync."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    perm = torch.randperm(len(trainer._train_data), device="cuda",
                          generator=gen)
    bs, nb = trainer.tc.batch_size, trainer.steps_per_epoch
    torch.cuda.synchronize()
    t0 = time.time()
    elbos = torch.stack([trainer._train_step(
        trainer._train_data[perm[s % nb * bs:(s % nb + 1) * bs]])["elbo"]
        for s in range(n)])
    torch.cuda.synchronize()
    return n / (time.time() - t0), elbos


def _iwae(trainer, n: int) -> tuple[float, float]:
    """(IWAE LL, examples/s) over the first ``n`` test examples."""
    torch.cuda.synchronize()
    t0 = time.time()
    ll = trainer.evaluate_log_likelihood("test", n)
    torch.cuda.synchronize()
    return ll, n / (time.time() - t0)


def _grad_check(trainer_k, trainer_p, x, what: str) -> None:
    """One step's gradients through the kernels against the plain path on
    the same weights, batch and noise (rtol 1e-3, atol 5e-4)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    noise = tail_kernels.draw_noise(trainer_k.model_cfg.components,
                                    (x.shape[0],), x, gen)
    gk = _grads(trainer_k, x, noise)
    with train_decoder(False), plain_kernels():
        gp = _grads(trainer_p, x, noise)
    worst = max(((a - b).abs() / (1e-3 * b.abs() + 5e-4)).max().item()
                for a, b in zip(gk, gp))
    print(f"[{what}] one step, every parameter's gradient against the plain "
          f"path: max {worst:.3g} of (rtol 1e-3, atol 5e-4)")
    check(worst <= 1.0 and all(bool(torch.isfinite(g).all()) for g in gk),
          f"{what}: one-step gradients match the plain path")


def phase_riemannian(ds, tmp, card: str) -> dict:
    """d6:riemannian at MNIST width: the quadrature against float64, 100
    training steps, IWAE-500 on 1,024 examples, the per-example and
    gradient checks and the sampler's acceptance (phase 22)."""
    from mvae_torch.distributions import riemannian_normal as rn
    worst = 0.0
    for n in (2, 6, 200):
        for sig in (0.05, 0.1, 1.0, 5.0):
            for c in (0.1, 0.25, 1.0, 4.0):
                got = rn.log_partition(
                    n, torch.tensor([sig], device="cuda"),
                    torch.tensor(-c, device="cuda")).double().cpu()
                ref = rn.log_partition(n, torch.tensor([sig],
                                                       dtype=torch.float64),
                                       torch.tensor(-c, dtype=torch.float64))
                worst = max(worst, ((got - ref).abs()
                                    / (1.0 + ref.abs())).item())
    print(f"[riemannian] log_partition in float32 on the card against "
          f"float64, n in (2, 6, 200), sigma sqrt(c) from 0.016 to 10: max "
          f"|d| / (1 + |ref|) {worst:.3g}")
    check(worst <= 1e-5, "log_partition within 1e-5 (1 + |ref|) of float64")

    spec = "d6:riemannian"
    cfg = VAEConfig(parse_components(spec), ds.data_shape, "mlp", h_dim=400)
    trainer = Trainer(cfg, ds, TrainConfig(seed=0, burnin_epochs=0),
                      f"{tmp}/riem")
    paths = trainer.fused_paths
    check(not paths["train_tail"]["active"]
          and paths["train_decoder"]["active"]
          and paths["iwae_decoder"]["active"],
          f"{spec}: plain tail, B6 and B2: {paths}")
    _steps(trainer, 5)  # warm-up (allocator, cuBLAS handles)
    _zero_counts()
    rate, elbos = _steps(trainer, 100)
    train_counts = _read_counts()
    check(bool(torch.isfinite(elbos).all())
          and all(bool(torch.isfinite(t).all())
                  for t in _leaves(trainer.params)),
          f"{spec}: finite losses and parameters over 100 steps")
    check(train_counts["train_decode"] == 100,
          f"{spec}: B6 launched once per step: {train_counts}")
    busy = profile_pass(f"{spec} 20 training steps",
                        lambda: _steps(trainer, 20))
    _iwae(trainer, 1024)  # warm-up
    _zero_counts()
    ll, ex_s = _iwae(trainer, 1024)
    iwae_counts = _read_counts()
    check(math.isfinite(ll), f"{spec}: finite IWAE-500")
    check(iwae_counts["decode_bce"] == 2 * 4,
          f"{spec}: B2 launched 2 batches x 4 chunks of 125: {iwae_counts}")
    ll_busy = profile_pass(f"{spec} IWAE-500 pass, 1024 examples",
                           lambda: _iwae(trainer, 1024))
    print(f"[riemannian] {spec} h_dim 400 batch 128 on {card}: "
          f"{rate:.2f} steps/s (device busy {100 * busy:.1f}%), ELBO "
          f"{elbos[0].item():.3f} -> {elbos[-1].item():.3f}; IWAE-500 on "
          f"1024 test examples {ll:.4f} at {ex_s:.1f} examples/s (device "
          f"busy {100 * ll_busy:.1f}%); launches training {train_counts}, "
          f"IWAE {iwae_counts}")
    per_example_check(cfg, trainer, 500)

    # the sampler on the trained posterior's scales of one batch
    comp, cp = cfg.components[0], trainer.params["components"][0]
    with torch.no_grad():
        x = (trainer._test_data[:512] > 0.5).float()
        raw = vae._fused_head_raw(cfg, trainer.params,
                                  vae.encode(cfg, trainer.params, x))[0]
        _, sigma, k = comp.posterior_params_from_raw(cp, raw)
        gen = torch.Generator(device="cuda").manual_seed(4)
        rounds = rn.draw_rounds(comp.dim, (500, 512), x, gen)
        _, log_u, log_acc = rn.proposals(comp.dim, sigma.expand(500, 512), k,
                                         rounds)
        ok = log_u <= log_acc
        used = torch.where(ok.any(-1), ok.to(torch.int8).argmax(-1) + 1,
                           rn.ROUNDS).float()
    print(f"[riemannian] sampler on 500 x 512 draws at the trained scales "
          f"(sigma {sigma.min().item():.3g}..{sigma.max().item():.3g}): "
          f"acceptance rate {ok.float().mean().item():.4f} per round, mean "
          f"rounds used {used.mean().item():.4f}, max {int(used.max())}, "
          f"lanes never accepted {int((~ok.any(-1)).sum())}")

    # one step's gradients with learnable curvature: dr/dK on the card
    learn = VAEConfig(parse_components(spec, fixed_curvature=False),
                      ds.data_shape, "mlp", h_dim=400)
    tk = Trainer(learn, ds, TrainConfig(seed=5), f"{tmp}/riemk")
    tp = Trainer(learn, ds, TrainConfig(seed=5), f"{tmp}/riemp")
    x = (tk._train_data[:128] > 0.5).float()
    _grad_check(tk, tp, x, "riemannian")
    gk = tk.params["components"][0]["c_param"].grad
    check(gk is not None and bool(torch.isfinite(gk)) and gk.item() != 0.0,
          "d6:riemannian: a finite, non-zero curvature gradient")
    return {"train": train_counts, "iwae": iwae_counts}


class _ConvFlags(TorchDispatchMode):
    """Records cuDNN's TF32 flag at every convolution, forward or
    backward (the mode reaches the autograd engine's thread)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.convolution,
                                   torch.ops.aten.convolution_backward):
            self.seen.append((func.overloadpacket.__name__,
                              torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def cudnn_tf32():
    """The conv nets with cuDNN's TF32 on (only to show what it costs)."""
    from mvae_torch.models import nets
    saved = nets._cudnn_f32
    nets._cudnn_f32 = contextlib.nullcontext
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        nets._cudnn_f32 = saved
        torch.backends.cudnn.allow_tf32 = old


def phase_conv(ds, tmp, card: str) -> dict:
    """u6 with learnable curvature, conv nets at the synthetic CIFAR's size
    (``ds``): TF32 off on every conv, 100 training steps, IWAE-500 on 1,024
    examples, the per-example checks and the TF32 gap (phase 23)."""
    spec = "u6"
    cfg = VAEConfig(parse_components(spec, fixed_curvature=False),
                    ds.data_shape, "conv", h_dim=400)
    trainer = Trainer(cfg, ds, TrainConfig(seed=0, burnin_epochs=0),
                      f"{tmp}/conv")
    paths = trainer.fused_paths
    check(paths["train_tail"]["active"] and paths["iwae_reparam"][0]["active"]
          and not paths["train_decoder"]["active"]
          and not paths["iwae_decoder"]["active"],
          f"conv {spec}: B1/B3 and B5, no B2 or B6: {paths}")

    # TF32 off on every convolution while the global flag is on
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with _ConvFlags() as mode:
            _steps(trainer, 1)
            with torch.no_grad():
                vae.log_likelihood(cfg, trainer.params,
                                   trainer._test_data[:64], 20,
                                   generator=trainer.generator)
            torch.cuda.synchronize()
        restored = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = old
    names = sorted({name for name, _ in mode.seen})
    on = sum(flag for _, flag in mode.seen)
    print(f"[conv] cuDNN TF32 with the global flag on: {len(mode.seen)} "
          f"convolutions ({', '.join(names)}) of a training step and an "
          f"IWAE chunk, {on} with TF32 on")
    check(names == ["convolution", "convolution_backward"] and on == 0
          and restored, "every conv, forward and backward, runs TF32 off")

    _steps(trainer, 5)  # warm-up
    _zero_counts()
    rate, elbos = _steps(trainer, 100)
    train_counts = _read_counts()
    check(bool(torch.isfinite(elbos).all())
          and all(bool(torch.isfinite(t).all())
                  for t in _leaves(trainer.params)),
          f"conv {spec}: finite losses and parameters over 100 steps")
    check(train_counts["tail_fwd"] == 100 and train_counts["tail_bwd"] == 100,
          f"conv {spec}: B1 and B3 launched once per step: {train_counts}")
    busy = profile_pass(f"conv {spec} 20 training steps",
                        lambda: _steps(trainer, 20))
    _iwae(trainer, 1024)  # warm-up
    _zero_counts()
    ll, ex_s = _iwae(trainer, 1024)
    iwae_counts = _read_counts()
    check(math.isfinite(ll), f"conv {spec}: finite IWAE-500")
    check(iwae_counts["reparam_stereo"] == 2 * 25,
          f"conv {spec}: B5 launched 2 batches x 25 chunks of 20: "
          f"{iwae_counts}")
    check(train_counts["decode_bce"] + train_counts["train_decode"]
          + iwae_counts["decode_bce"] + iwae_counts["train_decode"] == 0,
          f"conv {spec}: B2 and B6 never launched")
    ll_busy = profile_pass(f"conv {spec} IWAE-500 pass, 1024 examples",
                           lambda: _iwae(trainer, 1024))
    print(f"[conv] {spec} conv h_dim 400 batch 128 on 32x32x3 "
          f"({'synthetic' if ds.synthetic else 'real'} CIFAR) on {card}: "
          f"{rate:.2f} steps/s (device busy {100 * busy:.1f}%), ELBO "
          f"{elbos[0].item():.3f} -> {elbos[-1].item():.3f}; IWAE-500 on "
          f"1024 test examples {ll:.4f} at {ex_s:.1f} examples/s (device "
          f"busy {100 * ll_busy:.1f}%); launches training {train_counts}, "
          f"IWAE {iwae_counts}")
    x = trainer._test_data[:512]
    per_example_check(cfg, trainer, 500, x)

    # the same evaluation with TF32 on: the gap it would cost
    gen = torch.Generator(device="cuda").manual_seed(13)
    noise = tail_kernels.draw_noise(cfg.components, (500, 512), x, gen)
    with torch.no_grad():
        ll32 = vae.log_likelihood(cfg, trainer.params, x, 500, noise=noise)
        with cudnn_tf32():
            ll_tf32 = vae.log_likelihood(cfg, trainer.params, x, 500,
                                         noise=noise)
    gap = (ll_tf32 - ll32).abs()
    print(f"[conv] per-example IWAE-500 with cuDNN TF32 on against off, "
          f"same noise, 512 examples: max |dLL| {gap.max().item():.4g}, mean "
          f"{gap.mean().item():.4g} nats (the path holds 1e-3)")

    learn_k = Trainer(cfg, ds, TrainConfig(seed=5), f"{tmp}/convk")
    learn_p = Trainer(cfg, ds, TrainConfig(seed=5), f"{tmp}/convp")
    _grad_check(learn_k, learn_p, learn_k._train_data[:128], "conv")
    return {"train": train_counts, "iwae": iwae_counts}


# --- B6's routing by batch (C4) and the mesh ----------------------------------------

C4_BATCHES = (64, 256, 512, 1024)
C4_STEPS = 200


def phase_c4(ds, tmp, card: str) -> dict:
    """Flagship training with B6 on and off in turns (on, off, off, on) at
    each of ``C4_BATCHES``: ``C4_STEPS`` steps a turn after 20 of each
    trainer, then one profiled turn of 50 steps each for the busy share.
    Returns {batch: (on rates, off rates)}."""
    out = {}
    for bs in C4_BATCHES:
        on_tr = _flagship(ds, f"{tmp}/c4on{bs}", seed=0, batch_size=bs,
                          burnin_epochs=0)
        off_tr = _flagship(ds, f"{tmp}/c4off{bs}", seed=0, batch_size=bs,
                           burnin_epochs=0)
        order = ((on_tr, True), (off_tr, False), (off_tr, False),
                 (on_tr, True))
        for tr, on in order[:2]:
            with train_decoder(on):
                _steps(tr, 20)
        _zero_counts()
        rates = []
        for tr, on in order:
            with train_decoder(on):
                rates.append(_steps(tr, C4_STEPS)[0])
        counts = _read_counts()
        check(counts["train_decode"] == 2 * C4_STEPS,
              f"C4 batch {bs}: B6 launched on the on turns only: {counts}")
        busy = []
        for turn, (tr, on) in enumerate(order):
            with train_decoder(on):
                busy.append(profile_pass(
                    f"C4 batch {bs} turn {turn + 1} B6 "
                    f"{'on' if on else 'off'}, 50 steps",
                    lambda: _steps(tr, 50)))
        on_r = [r for (_, on), r in zip(order, rates) if on]
        off_r = [r for (_, on), r in zip(order, rates) if not on]
        verdict = ("on faster in both turns" if min(on_r) > max(off_r) else
                   "off faster in both turns" if min(off_r) > max(on_r) else
                   "within the turns' spread")
        auto = route.route(on_tr.model_cfg, on_tr.params).train_decoder
        print(f"[c4] {card}: batch {bs}, {C4_STEPS} steps a turn: "
              + "; ".join(f"turn {i + 1} B6 {'on' if on else 'off'} "
                          f"{r:.2f} steps/s, busy {100.0 * b:.1f}%"
                          for i, ((_, on), r, b) in enumerate(
                              zip(order, rates, busy)))
              + f" -> {verdict}; 'auto' routes B6 "
                f"{'on' if auto else 'off'} at batch {bs}")
        out[bs] = (on_r, off_r)
    return out


def _mesh_noise(spec, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    comps = parse_components(spec, fixed_curvature=False)
    return tail_kernels.draw_noise(comps, shape, torch.zeros(()), gen)


def _mesh_step_inputs(ds):
    """The step phase's batch, binarization uniforms and (128, E) noise,
    from fixed seeds, on the CPU."""
    gen = torch.Generator().manual_seed(21)
    x = torch.as_tensor(ds.train[:128])
    return x, torch.rand(x.shape, generator=gen), _mesh_noise(SPEC, (128,),
                                                              22)


def _tiny_mnist(x):
    """The step's 128 examples as a dataset: the trainers' weights come from
    the seed, the batch is given."""
    from mvae_torch.data import ArrayDataset
    return ArrayDataset("mnist", x.numpy(), x.numpy(), (28, 28), True)


def _mesh_step_task(shape, x, u, noise):
    """One training step of a full-width flagship on mesh ``shape`` (None
    outside it): the loss, every parameter's whole gradient and this
    rank's launch counts."""
    if dist.get_rank() >= shape[0] * shape[1]:
        make_mesh(*shape)
        return None
    x, u, noise = (torch.as_tensor(t) for t in (x, u, noise))
    tr = _flagship(_tiny_mnist(x), tempfile.mkdtemp(prefix="mesh_step_"),
                   seed=0, burnin_epochs=0, mesh_shape=shape)
    dev = tr.device
    _zero_counts()
    stats = tr._train_step(x.to(dev), u.to(dev), noise.to(dev))
    grads = [t.grad if ax is None else gather_model(t.grad, ax, tr.mesh)
             for t, ax in zip(_leaves(tr.params), _leaves(tr._axes))]
    torch.cuda.synchronize(dev)
    return {"loss": -stats["elbo"].item(), "grads": grads,
            "counts": _read_counts(), "rows": 128 // shape[0],
            "b6": tr.fused_paths["train_decoder"]["active"]}


def _mesh_iwae_task(spec, x, noise, n_batches, shape=(2, 2)):
    """IWAE-500 of ``spec`` at full width on a mesh of ``shape`` over the
    rows of ``x`` in batches, the samples of ``noise`` split over "model";
    this rank's rows' estimates and its launch counts."""
    mesh = make_mesh(*shape)
    cfg = VAEConfig(parse_components(spec, fixed_curvature=False), (28, 28),
                    "mlp", h_dim=400)
    params = vae.init_params(cfg, 1.0, torch.float32,
                             torch.Generator().manual_seed(0), mesh.device)
    shards = shard_params(params, mesh)
    x, noise = torch.as_tensor(x), torch.as_tensor(noise)
    bs = x.shape[0] // n_batches
    _zero_counts()
    lls = []
    with torch.no_grad():
        for b in range(n_batches):
            xb = shard_batch(x[b * bs:(b + 1) * bs], mesh).to(mesh.device)
            nb = noise[:, b * bs:(b + 1) * bs][:, mesh.rows(bs)].to(
                mesh.device)
            lls.append(vae.log_likelihood_sharded(cfg, shards, xb, mesh, 500,
                                                  noise=nb))
    torch.cuda.synchronize(mesh.device)
    return {"d": mesh.data_index, "m": mesh.model_index,
            "ll": torch.stack(lls), "counts": _read_counts()}


def _mesh_epoch_task(tmp):
    """A (2, 1) rank's flagship epoch on MNIST (after a warm-up epoch),
    profiled: its steps/s and device busy share."""
    if dist.get_rank() >= 2:
        make_mesh(2, 1)
        return None
    tr = _flagship(load_mnist(), f"{tmp}/mesh_epoch", seed=0,
                   burnin_epochs=0, mesh_shape=(2, 1))
    tr.train_one_epoch(0)
    torch.cuda.synchronize(tr.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        tr.train_one_epoch(1)
        torch.cuda.synchronize(tr.device)
        wall = time.time() - t0
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()) / 1e6
    return {"rate": tr.steps_per_epoch / wall, "busy": busy / wall}


def phase_mesh(ds, tmp, card: str) -> dict:
    """Phase 25: the mesh on four gloo ranks of the one card against the
    one-device path, the ranks' launch counts and the CLI."""
    x, u, noise = _mesh_step_inputs(ds)
    one = _flagship(_tiny_mnist(x), f"{tmp}/mesh_one", seed=0,
                    burnin_epochs=0)
    stats = one._train_step(x.cuda(), u.cuda(), noise.cuda())
    ref_loss = -stats["elbo"].item()
    ref = [t.grad.detach().cpu() for t in _leaves(one.params)]
    result = {}
    with World(4) as world:
        for shape in ((2, 1), (1, 2), (2, 2)):
            t0 = time.time()
            out = [r for r in world.run(_mesh_step_task, shape, x, u, noise)
                   if r is not None]
            worst = max(((torch.as_tensor(g) - r).abs()
                         / (1e-3 * r.abs() + 5e-4)).max().item()
                        for o in out for g, r in zip(o["grads"], ref))
            dloss = max(abs(o["loss"] - ref_loss) for o in out)
            print(f"[mesh] {card}: {shape[0]}x{shape[1]} mesh, one step at "
                  f"batch 128 ({out[0]['rows']} rows a rank) against one "
                  f"device: |d loss| {dloss:.3g} nats, gradients at "
                  f"{worst:.3g} of (rtol 1e-3, atol 5e-4); launches by rank "
                  f"{[o['counts'] for o in out]}; B6 "
                  f"{'on' if out[0]['b6'] else 'off'} on the ranks "
                  f"({time.time() - t0:.1f} s)")
            check(dloss <= 1e-4, f"mesh {shape}: the loss within 1e-4 nats")
            check(worst <= 1.0, f"mesh {shape}: every gradient within the "
                                f"training contract")
            for o in out:
                c = o["counts"]
                check(c["tail_fwd"] >= 1 and c["tail_bwd"] >= 1
                      and (c["train_decode"] >= 1 or not o["b6"]),
                      f"mesh {shape}: every rank launches B1, B3 (and B6 "
                      f"when its gate is on): {c}")
            result[f"step {shape[0]}x{shape[1]}"] = (dloss, worst)

        from mvae_torch.data.base import binarize_rows
        xt = binarize_rows(1234, torch.arange(1024),
                           torch.as_tensor(ds.test[:1024]), True)
        for spec in (SPEC, STEREO_SPEC):
            cfg = VAEConfig(parse_components(spec, fixed_curvature=False),
                            (28, 28), "mlp", h_dim=400)
            params = vae.init_params(cfg, 1.0, torch.float32,
                                     torch.Generator().manual_seed(0), "cuda")
            nz = _mesh_noise(spec, (500, 1024), 31)
            with torch.no_grad():
                one_ll = torch.cat([vae.log_likelihood(
                    cfg, params, xt[b * 512:(b + 1) * 512].cuda(), 500,
                    noise=nz[:, b * 512:(b + 1) * 512].cuda())
                    for b in range(2)]).cpu()
            t0 = time.time()
            out = world.run(_mesh_iwae_task, spec, xt, nz, 2)
            wall = time.time() - t0
            got = torch.zeros(2, 2, 256)    # (batch, data index, row)
            for o in sorted(out, key=lambda o: o["m"]):
                ll = torch.as_tensor(o["ll"])     # (batch, row)
                if o["m"] == 0:
                    got[:, o["d"]] = ll
                check(torch.equal(got[:, o["d"]], ll),
                      f"mesh IWAE {spec}: the model ranks of a data shard "
                      f"agree")
            got = got.reshape(1024)
            err = (got - one_ll).abs().max().item()
            counts = [o["counts"] for o in out]
            print(f"[mesh] {card}: IWAE-500 of {spec} at h_dim 400 over "
                  f"1,024 test examples on the 2x2 mesh (256 rows, 250 "
                  f"samples a rank) against one device on the same noise: "
                  f"max |d LL| {err:.3g} nats (mean LL {got.mean():.4f}); "
                  f"launches by rank {counts} ({wall:.1f} s)")
            check(err <= 1e-3, f"mesh IWAE {spec}: within 1e-3 nats")
            for c in counts:
                check(c["decode_bce"] >= 1
                      and (c["reparam_stereo"] >= 1 or spec == SPEC),
                      f"mesh IWAE {spec}: every rank launches B2 (and B5 "
                      f"for the stereographic family): {c}")
            result[f"iwae {spec}"] = err

        ep = [r for r in world.run(_mesh_epoch_task, tmp) if r is not None]
        print(f"[mesh] {card}: a (2, 1) mesh flagship epoch (batch 128, 64 "
              f"rows a rank, gloo through the host), by rank: "
              + "; ".join(f"{r['rate']:.2f} steps/s, busy "
                          f"{100.0 * r['busy']:.1f}%" for r in ep))

    from mvae_torch import cli
    t0 = time.time()
    res = cli.main(["--dataset", "mnist", "--model", SPEC,
                    "--fixed_curvature", "false", "--epochs", "1",
                    "--ll_max_examples", "1024", "--mesh", "2,1",
                    "--run_dir", f"{tmp}/mesh_cli"])
    print(f"[mesh] {card}: CLI --mesh 2,1, one epoch: "
          f"{res['train_steps_per_sec']:.2f} train steps/s, IWAE-500 on "
          f"1,024 examples {res['test/log_likelihood_iwae']:.4f} "
          f"({time.time() - t0:.1f} s with the ranks' start)")
    check(math.isfinite(res["test/log_likelihood_iwae"]),
          "mesh CLI: finite IWAE")
    return result


# --- the compiled programs as CUDA graphs (phase 26) -------------------------------


def _cut(ds, steps: int, batch: int = 128, test: int = 1024):
    """``ds`` cut to ``steps`` training batches and ``test`` test examples."""
    import dataclasses
    return dataclasses.replace(ds, train=ds.train[:steps * batch],
                               test=ds.test[:test])


def _programs(trainer, kind: str) -> list:
    """The trainer's captured programs of ``kind`` ("train_step",
    "eval_elbo", "eval_ll")."""
    return [p for k, p in trainer._programs.items() if k[0] == kind]


def _curvatures(trainer) -> dict:
    with torch.no_grad():
        return {n: float(c.curvature(cp)) for n, c, cp in zip(
            trainer.component_names, trainer.model_cfg.components,
            trainer.params["components"])}


def _same_state(a, b) -> bool:
    """Parameters, Adam's state and the generator equal bit for bit."""
    sa, sb = a.opt.state_dict()["state"], b.opt.state_dict()["state"]
    return (all(torch.equal(x, y) for x, y in zip(_leaves(a.params),
                                                  _leaves(b.params)))
            and all(torch.equal(sa[i][k], sb[i][k]) for i in sa
                    for k in sa[i])
            and torch.equal(a.generator.get_state(), b.generator.get_state())
            and a.step == b.step)


def _philox_replay() -> str:
    """Whether a registered generator's draws in a graph replay equal the
    eager draws from the same state (the measured reason when graphed and
    eager training part)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    state = gen.get_state()
    eager = torch.randn(4096, device="cuda", generator=gen)
    gen.set_state(state)
    g = torch.cuda.CUDAGraph()
    g.register_generator_state(gen)
    torch.randn(4096, device="cuda", generator=gen)       # warm-up
    gen.set_state(state)
    with torch.cuda.graph(g):
        out = torch.randn(4096, device="cuda", generator=gen)
    g.replay()
    return (f"a graph's Philox draws from eager's state equal eager's: "
            f"{torch.equal(out, eager)} (max |d| "
            f"{(out - eager).abs().max().item():.3g})")


def _graphs_same_noise(ds, tmp) -> None:
    """Two flagship epochs (burn-in 1) graphed and eager from one seed: the
    same weights, Adam state, generator and statistics bit for bit; one
    capture across the burn-in boundary; the curvature frozen, then moving;
    B1 / B3 / B6 counted once a step through the replays."""
    graph = _flagship(ds, f"{tmp}/gg", seed=0, burnin_epochs=1)
    eager = _flagship(ds, f"{tmp}/ge", seed=0, burnin_epochs=1)
    check(graph.graph_path["path"] == "graph",
          f"one CUDA device replays graphs: {graph.graph_path}")
    k0 = _curvatures(graph)
    got, want, counts = [], [], {}
    S = graph.steps_per_epoch
    for epoch in range(2):
        _zero_counts()
        got.append(graph.train_one_epoch(epoch))
        counts = {k: counts.get(k, 0) + v for k, v in _read_counts().items()}
        if epoch == 0:
            want.append(eager._train_one_epoch_eager(epoch))
        else:           # the eager body, to keep its per-step statistics
            body = graphs.TrainEpoch(eager)
            want.append(eager._epoch_means(body.run(eager._epoch_perm(),
                                                    graph=False)))
            eager.step += S
    torch.cuda.synchronize()
    progs = _programs(graph, "train_step")
    print(f"[graphs] flagship, 2 epochs of {S} steps, burn-in 1, graphed "
          f"and eager from seed 0: captures {[p.captures for p in progs]}, "
          f"replays {[p.replays for p in progs]}; launches through the "
          f"graphed epochs {counts}")
    check(len(progs) == 1 and progs[0].captures == 1
          and progs[0].replays == 2 * S - graphs.WARMUP_STEPS,
          "one capture of the step serves burn-in and after")
    for n in ("h2#0", "s2#1"):
        check(got[0][f"curvature/{n}"] == k0[n]
              and got[1][f"curvature/{n}"] != k0[n],
              f"curvature {n} frozen through burn-in, then moving")
    check(counts["tail_bwd"] == 2 * S and counts["tail_fwd"] == 2 * S
          and counts["train_decode"] == 2 * S,
          f"B1, B3 and B6 launched once a step through the replays: {counts}")
    bit = _same_state(graph, eager) and got == want
    per_step = (graph._epoch.stats["elbo"] - body.stats["elbo"]).abs()
    print(f"[graphs] graphed against eager: weights, Adam state, generator "
          f"and epoch statistics bit for bit: {bit}; per-step ELBO of epoch "
          f"1 max |d| {per_step.max().item():.3g}")
    if not bit:
        print(f"[graphs] the trajectories part: {_philox_replay()}; held to "
              f"the training contract instead (50 steps' losses within "
              f"0.05 nats)")
        check(per_step[:50].max().item() <= 0.05,
              "graphed training within 0.05 nats of eager over 50 steps")


def _graphs_state_loads(ds, tmp) -> None:
    """Graphed training continues exactly as uninterrupted after a
    checkpoint restore and after a forced non-finite rewind (both copy
    into the tensors the captured step holds)."""
    small = _cut(ds, 60)
    ref = _flagship(small, f"{tmp}/slu", seed=0, burnin_epochs=1)
    for epoch in range(3):
        ref.train_one_epoch(epoch)
    res = _flagship(small, f"{tmp}/slr", seed=0, burnin_epochs=1)
    res.train_one_epoch(0)
    res.save_checkpoint()
    res.train_one_epoch(1)
    res.restore_checkpoint()
    res.train_one_epoch(1)
    res.train_one_epoch(2)
    rew = _flagship(small, f"{tmp}/sln", seed=0, burnin_epochs=1)
    rew.train_one_epoch(0)
    before = rew._guard_state()
    with torch.no_grad():
        rew.params["decoder"]["out"]["b"][0] = float("nan")
    bad = rew.train_one_epoch(1)
    tripped = False
    try:
        rew._check_finite(1, bad, before)
    except NonFiniteError:
        tripped = True
    rew.train_one_epoch(1)
    rew.train_one_epoch(2)
    caps = [[p.captures for p in _programs(t, "train_step")]
            for t in (ref, res, rew)]
    same = (_same_state(ref, res), _same_state(ref, rew))
    print(f"[graphs] state loads, 3 epochs of 60 steps: after a checkpoint "
          f"restore equal to uninterrupted bit for bit {same[0]}; after a "
          f"forced non-finite epoch (guard tripped {tripped}) and its "
          f"rewind {same[1]}; captures {caps}")
    check(tripped, "the non-finite guard trips on the poisoned epoch")
    check(all(same), "graphed training continues exactly after state loads")
    check(caps == [[1], [1], [1]], "state loads keep the captured step")


def _graphs_eval_same_noise(trainer) -> None:
    """Per-example ELBO and IWAE-500 of 512 test examples on explicit noise
    through a graph of them and eagerly: bit-equal expected, 1e-3 nats the
    gate."""
    cfg, params = trainer.model_cfg, trainer.params
    x = (trainer._test_data[:512] > 0.5).float()
    gen = torch.Generator(device="cuda").manual_seed(7)
    nz_e = tail_kernels.draw_noise(cfg.components, (512,), x, gen)
    nz_l = tail_kernels.draw_noise(cfg.components, (500, 512), x, gen)

    def both():
        return (vae.elbo(cfg, params, x, noise=nz_e)[0],
                vae.log_likelihood(cfg, params, x, 500, noise=nz_l))

    with torch.no_grad():
        want = both()
        prog = graphs.Graphed(both, (), trainer.generator, 1, copy_out=True)
        prog()
        got = prog()
    check(prog.captures == 1 and prog.replays == 1, "the eval graph replayed")
    d = [(a - b).abs().max().item() for a, b in zip(got, want)]
    print(f"[graphs] per example, 512 examples, explicit noise, graphed "
          f"against eager: max |dELBO| {d[0]:.3g}, max |dLL| {d[1]:.3g} nats "
          f"(bit for bit: {all(torch.equal(a, b) for a, b in zip(got, want))})")
    check(max(d) <= 1e-3, "graphed per-example ELBO and IWAE within 1e-3")


def _graphs_config(name, trainer, card) -> dict:
    """Two epochs and an ELBO and IWAE-500 pass of ``trainer`` (a cut data
    set) through graphs: finite, rising, every program captured once, each
    kernel its routing names launched."""
    _zero_counts()
    stats = [trainer.train_one_epoch(e) for e in range(2)]
    elbo = trainer.evaluate_elbo("test")["elbo"]
    ll = trainer.evaluate_log_likelihood("test")
    counts = _read_counts()
    caps = {k: [(p.captures, p.replays) for p in _programs(trainer, k)]
            for k in ("train_step", "eval_elbo", "eval_ll")}
    paths = trainer.fused_paths
    routed = {"tail_fwd": paths["train_tail"]["active"],
              "tail_bwd": paths["train_tail"]["active"],
              "train_decode": paths["train_decoder"]["active"],
              "decode_bce": paths["iwae_decoder"]["active"],
              "reparam_stereo": any(r["active"]
                                    and "reparam_stereo.cu" in r["why"]
                                    for r in paths["iwae_reparam"]),
              "reparam_chunk": any(r["active"]
                                   and "reparam_chunk.cu" in r["why"]
                                   for r in paths["iwae_reparam"])}
    print(f"[graphs] {name} through graphs on {card}: train ELBO "
          f"{stats[0]['elbo']:.3f} -> {stats[1]['elbo']:.3f}, test ELBO "
          f"{elbo:.3f}, IWAE-500 {ll:.3f}; (captures, replays) {caps}; "
          f"launches {counts}")
    check(trainer.graph_path["path"] == "graph", f"{name}: graphs")
    check(all(math.isfinite(v) for st in stats for v in st.values())
          and math.isfinite(elbo) and math.isfinite(ll),
          f"{name}: finite statistics")
    check(stats[1]["elbo"] > stats[0]["elbo"], f"{name}: train ELBO rises")
    check(all(v == [(1, v[0][1])] and v[0][1] > 0 for v in caps.values()),
          f"{name}: each program captured once and replayed")
    check(all(counts[k] > 0 for k, on in routed.items() if on)
          and all(counts[k] == 0 for k, on in routed.items() if not on),
          f"{name}: the routed kernels launched, no other: {counts}")
    return counts


def _turns(what: str, eager, graph, count: int, unit: str,
           card: str) -> list:
    """``eager`` and ``graph`` (each one turn, returning a value) in turns
    eager, graph, graph, eager after one call of each: rates in ``unit``
    per second and the four values."""
    eager(), graph()
    rates, values = [], []
    for fn in (eager, graph, graph, eager):
        torch.cuda.synchronize()
        t0 = time.time()
        values.append(fn())
        torch.cuda.synchronize()
        rates.append(count / (time.time() - t0))
    print(f"[turns] {card}: {what}, {unit}/s eager {rates[0]:.2f}, graph "
          f"{rates[1]:.2f}, graph {rates[2]:.2f}, eager {rates[3]:.2f} "
          f"(graph / eager {min(rates[1:3]) / max(rates[0], rates[3]):.2f}"
          f"-{max(rates[1:3]) / min(rates[0], rates[3]):.2f}x)")
    return values


def _train_turns(trainer, card: str, epochs: int, what: str,
                 eager_profile: bool = True) -> None:
    S = trainer.steps_per_epoch

    def eager():
        for e in range(epochs):
            trainer._train_one_epoch_eager(e)

    def graph():
        for e in range(epochs):
            trainer.train_one_epoch(e)

    _turns(f"{what}, {epochs} epoch(s) of {S} steps a turn", eager, graph,
           epochs * S, "steps", card)
    if eager_profile:
        profile_pass(f"{what}, eager epoch",
                     lambda: trainer._train_one_epoch_eager(0))
    profile_pass(f"{what}, graphed epoch", lambda: trainer.train_one_epoch(0),
                 layers=True)


def _eval_turns(trainer, card: str, n: int | None, what: str,
                elbo: bool = True, eager_profile: bool = True) -> None:
    """The ELBO and IWAE-500 passes in turns, each turn from the same
    generator seed: the four values of each must agree."""
    def seeded(fn):
        def run():
            trainer.generator.manual_seed(21)
            return fn()
        return run

    count = n or len(trainer._test_data)
    if elbo:
        vals = _turns(f"{what} ELBO pass over {count} examples",
                      seeded(lambda: trainer._evaluate_elbo("test", False)),
                      seeded(lambda: trainer._evaluate_elbo("test", True)),
                      count, "examples", card)
        elbos = [v["elbo"] for v in vals]
        print(f"[turns] {what} ELBO values of the four turns {elbos} (all "
              f"statistics bit for bit: {all(v == vals[0] for v in vals)})")
        check(max(elbos) - min(elbos) <= 1e-3,
              f"{what}: graphed and eager ELBO passes within 1e-3 nats")
    vals = _turns(
        f"{what} IWAE-500 pass over {count} examples",
        seeded(lambda: trainer._evaluate_log_likelihood("test", n, False)),
        seeded(lambda: trainer._evaluate_log_likelihood("test", n, True)),
        count, "examples", card)
    print(f"[turns] {what} IWAE-500 values of the four turns {vals} (bit "
          f"for bit: {all(v == vals[0] for v in vals)})")
    check(max(vals) - min(vals) <= 1e-3,
          f"{what}: graphed and eager IWAE passes within 1e-3 nats")
    if eager_profile:
        profile_pass(f"{what} IWAE-500 pass, eager", seeded(
            lambda: trainer._evaluate_log_likelihood("test", n, False)))
    profile_pass(f"{what} IWAE-500 pass, graphed", seeded(
        lambda: trainer._evaluate_log_likelihood("test", n, True)))


def phase_graphs(ds, cifar, tmp, card: str) -> None:
    """The reference's compiled programs as CUDA graphs (phase 26): the same
    noise graphed and eager, one capture across burn-in, state loads, every
    configuration through graphs, and the steps/s and examples/s in turns
    (eager, graph, graph, eager). The eager busy shares of
    ``d6:riemannian``, ``s6:wrapped`` and the conv ``u6`` are phases 22, 18
    and 23's."""
    t0 = time.time()
    _graphs_same_noise(ds, tmp)
    _graphs_state_loads(ds, tmp)
    print(f"[graphs] same noise and state loads in {time.time() - t0:.1f} s")
    t0 = time.time()
    small = _cut(ds, 40)
    runs = {}
    for spec in (SPEC, STEREO_SPEC, SPHERE_SPEC, "s6"):
        runs[spec] = _flagship(small, f"{tmp}/gc{spec}", spec, seed=0,
                               burnin_epochs=0)
    riem = VAEConfig(parse_components("d6:riemannian"), ds.data_shape,
                     "mlp", h_dim=400)
    runs["d6:riemannian"] = Trainer(riem, _cut(ds, 30), TrainConfig(
        seed=0, burnin_epochs=0), f"{tmp}/gcriem")
    conv = VAEConfig(parse_components("u6", fixed_curvature=False),
                     cifar.data_shape, "conv", h_dim=400)
    runs["conv u6"] = Trainer(conv, _cut(cifar, 40), TrainConfig(
        seed=0, burnin_epochs=0), f"{tmp}/gcconv")
    for name, trainer in runs.items():
        _graphs_config(name, trainer, card)
    _graphs_eval_same_noise(runs[SPEC])
    print(f"[graphs] six configurations in {time.time() - t0:.1f} s")

    # the turns: training, then the evaluation passes
    t0 = time.time()
    _train_turns(_flagship(ds, f"{tmp}/t128", seed=0, burnin_epochs=0),
                 card, 1, f"{SPEC} training, batch 128")
    _train_turns(_flagship(ds, f"{tmp}/t1024", seed=0, burnin_epochs=0,
                           batch_size=1024),
                 card, 2, f"{SPEC} training, batch 1024")
    _train_turns(runs["d6:riemannian"], card, 1,
                 "d6:riemannian training, batch 128", eager_profile=False)
    for spec in (SPEC, SPHERE_SPEC):
        full = _flagship(ds, f"{tmp}/e{spec}", spec, seed=0)
        _eval_turns(full, card, None, spec, eager_profile=spec == SPEC)
    _eval_turns(runs["conv u6"], card, 1024, "conv u6", elbo=False,
                eager_profile=False)
    print(f"[graphs] the turns in {time.time() - t0:.1f} s")


# --- the matrix runner (phase 27) ---------------------------------------------------

def phase_matrix(ds, tmp) -> None:
    """``mvae_torch.matrix.run_row`` itself, as ``python -m
    mvae_torch.matrix`` runs each row, cut to one epoch and 1,024 IWAE
    examples (phase 27): the rows' status, LL, graph path and captures,
    the kernels each launched, and the summary file."""
    import argparse

    from mvae_torch import matrix
    t0 = time.time()
    args = argparse.Namespace(epochs=1, batch_size=256, ll_repeats=1,
                              eval_binarize="fixed")
    steps = len(ds.train) // args.batch_size
    configs = dict(matrix.CONFIGS)
    rows = []
    for tag in ("h2s2e2-learnK/mnist", "d2p2e2-learnK/mnist"):
        _zero_counts()
        row = matrix.run_row(tag, configs[tag], 11, args,
                             extra=("--ll_max_examples", "1024"),
                             run_root=f"{tmp}/matrix")
        n = _read_counts()
        ll = row.get("test/log_likelihood_iwae")
        print(f"[matrix] {tag}: {row['status']}, IWAE-500 LL over 1,024 "
              f"{ll}, train_steps_per_sec {row.get('train_steps_per_sec')} "
              f"at batch {args.batch_size}, wall {row['wall_s']} s, "
              f"{row.get('graph_path', {}).get('path')}, captures "
              f"{row.get('graph_captures')}, launches {n}, card "
              f"{row.get('card')}")
        check(row["status"] == "OK" and isinstance(ll, float)
              and math.isfinite(ll), f"{tag}: row OK with a finite LL")
        check(row["graph_path"]["path"] == "graph"
              and row["graph_captures"] == {"train_step": 1, "eval_elbo": 1,
                                            "eval_ll": 1},
              f"{tag}: graphed, one capture of each program")
        check(n["tail_bwd"] == steps, f"{tag}: B3 once a training step")
        check(n["tail_fwd"] > n["tail_bwd"],
              f"{tag}: B1 in training and in the ELBO pass")
        check(n["decode_bce"] > 0, f"{tag}: B2 in the IWAE")
        if tag.startswith("h2s2e2"):
            check(n["train_decode"] >= steps, f"{tag}: B6 in training")
        else:
            check(n["reparam_stereo"] > 0, f"{tag}: B5 in the IWAE")
        rows.append(row)
    out = Path(tmp) / "matrix.json"
    summary = Path(tmp) / "matrix_summary.json"
    matrix.save(rows, out, summary)
    written = json.loads(summary.read_text())
    check(sorted(written) == sorted(r["tag"] for r in rows)
          and all(v["n_seeds"] == 1 for v in written.values()),
          "the matrix summary written, a row a tag")
    print(f"[matrix] two rows and their summary in {time.time() - t0:.1f} s")


# --- the mesh under NCCL (phase 28) ------------------------------------------------

MESH_CARDS_RESULTS = "results/torch_mesh_cards.json"


def phase_mesh_nccl(ds, card: str) -> None:
    """A (1, 1) mesh under NCCL through ``scripts/torch_mesh_cards.py``'s
    checks of one mesh (phase 28), and its four-card checks where the
    machine has the cards."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import torch_mesh_cards
    t0 = time.time()
    record = torch_mesh_cards.Checks()
    with World(1) as world:
        torch_mesh_cards.mesh_checks(world, (1, 1), ds, card, record)
    print(f"[mesh-nccl] a (1, 1) NCCL mesh: {len(record.items)} checks, "
          f"{len(record.failed)} failed ({time.time() - t0:.1f} s)")
    for c in record.items:
        check(c["ok"], c["what"])
    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"[mesh-nccl] the four-card checks ((4, 1), (2, 2), (1, 4) "
              f"under NCCL) did not run: {cards} card(s) here; their "
              f"results are {MESH_CARDS_RESULTS} (python3 "
              f"scripts/torch_mesh_cards.py on four cards)")
        return
    out = Path(tempfile.mkdtemp()) / "torch_mesh_cards.json"
    check(torch_mesh_cards.main(["--out", str(out)]) == 0,
          f"the four-card checks of scripts/torch_mesh_cards.py ({out})")


# --- the benchmark (phase 29) -----------------------------------------------------

BENCH_ARGS = ("--steps", "300", "--repeats", "2", "--conv_steps", "100")


def phase_bench(gen) -> None:
    """``bench_torch.py`` at short chunks in a fresh process, its line
    checked and printed, and B6 at the bf16 h_dim 1024 row's widths
    against its plain version where that row routes to it (phase 29)."""
    root = Path(__file__).resolve().parent
    t0 = time.time()
    out = subprocess.run([sys.executable, str(root / "bench_torch.py"),
                          *BENCH_ARGS], cwd=root, capture_output=True,
                         text=True, timeout=900)
    for ln in out.stderr.strip().splitlines()[-40:]:
        print(f"[bench] stderr: {ln}")
    check(out.returncode == 0 and out.stdout.strip(),
          f"bench_torch.py {' '.join(BENCH_ARGS)} exits 0 "
          f"(rc {out.returncode})")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"[bench] {json.dumps(line)}")
    print(f"[bench] {time.time() - t0:.1f} s in its own process")
    check("error" not in line, f"the bench's line has no error: "
          f"{line.get('error')}")
    # step_mfu_pct is null off the card its peak is quoted for
    keys = ("pct_of_step_ceiling",) + (
        ("step_mfu_pct",) if line["step_mfu_peak_tflops"] is not None else ())
    for key in keys:
        v = line.get(key)
        check(v is not None and 0 < v <= 100,
              f"the bench's {key} in (0, 100]: {v}")
    counted = line["step_model_counted"]
    check(counted["executed_minus_counted"] == 0,
          f"the bench's priced MACs are the counted ones: "
          f"{line['step_model']['executed_macs']} against {counted['macs']}")
    check(line["graph_path"] == "graph",
          f"the bench's flagship step is graphed: {line['graph_path']}")
    check(line["launches_per_step"] == {"tail_fwd": 1.0, "tail_bwd": 1.0,
                                        "train_decode": 1.0},
          f"the bench's flagship step launches B1, B3, B6 once a step: "
          f"{line['launches_per_step']}")
    row = line["bf16_matmul_rows"]["1024"]
    print(f"[bench] bf16 h_dim 1024 decode: {row['decode_route']}")
    if row["train_decode_launches_per_step"] == 1.0:
        worst = _train_decode_held(8, 1024, 784, gen)
        print(f"[bench] B6 at (Z, H, D) = (8, 1024, 784) against its plain "
              f"version: max |dll| {worst:.3g} nats a row")


def _parent_optimizer_layer(params, components, step_t, burnin, opt):
    """The optimizer layer as the trainer ran it before ``csrc/adam.cu``:
    the curvature mask's launches, ``torch.optim.Adam``'s step, the step
    counter advanced. Phase 30's yardstick; the port calls none of it."""
    unfrozen = None
    for comp, cp in zip(components, params["components"]):
        if "c_param" not in cp:
            continue
        c = cp["c_param"]
        if c.grad is None:
            c.grad = torch.zeros_like(c)
        elif comp.fixed_curvature:
            c.grad.zero_()
        else:
            if unfrozen is None:
                unfrozen = step_t >= burnin
            c.grad.mul_(unfrozen.to(c.grad.dtype))
    opt.step()
    step_t += 1


def _adam_leaves(spec: str, seed: int = 21, dtype=torch.float32):
    """``spec``'s parameters at full width on the card in ``dtype``, each
    with a gradient, and its config."""
    cfg = VAEConfig(parse_components(spec, fixed_curvature=False), (784,),
                    h_dim=400)
    params = vae.init_params(cfg, 1.0, dtype,
                             torch.Generator().manual_seed(seed),
                             torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for t in _leaves(params):
        t.requires_grad_(True)
        t.grad = (1e-2 * torch.randn(t.shape, generator=gen,
                                     device="cuda")).to(dtype)
    return cfg, params


def _bf16_ulps(a, b, *before) -> float:
    """|a - b| in bfloat16 ulps of the largest magnitude in their update:
    of a, b and the values ``before`` the step (where the update nearly
    cancels, the result is exact and the rounding is the operands')."""
    a, b = a.detach().float(), b.detach().float()
    scale = torch.maximum(a.abs(), b.abs())
    for t in before:
        scale = torch.maximum(scale, t.detach().float().abs())
    ulp = 2.0 ** (torch.floor(torch.log2(scale.clamp(min=1e-30))) - 7)
    return float(((a - b).abs() / ulp).max())


def _adam_against_plain(cfg, params, steps: int = 3):
    """``steps`` steps of the optimizer kernel over ``params`` at burn-in 1
    (the first step holds the learnable curvatures) against its plain
    version on the card, each step from the kernel's parameters and
    moments; one launch, Adam's count, the global step and the ticket
    checked after each. Returns the optimizer, the plain version's
    arguments and the worst gaps of the parameters and of the moments:
    float32 relative to the largest change or moment, bfloat16 in ulps of
    the update's largest magnitude."""
    leaves = _leaves(params)
    ours = make_optimizer(params, TrainConfig(), cfg.components,
                          torch.zeros((), dtype=torch.int64, device="cuda"),
                          1)
    kind_of = dict(zip((id(p) for g in ours.param_groups
                        for p in g["params"]), ours.kinds))
    kinds = [kind_of[id(t)] for t in leaves]
    lrs = [1e-4 if k else 1e-3 for k in kinds]
    ref = [t.detach().clone() for t in leaves]
    rm = [torch.zeros_like(t) for t in ref]
    rv = [torch.zeros_like(t) for t in ref]
    rc = torch.zeros((), device="cuda")
    rs = torch.zeros((), dtype=torch.int64, device="cuda")
    bf16 = ref[0].dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(30)
    worst = worst_m = 0.0
    for step in range(steps):
        grads = [(1e-2 * torch.randn(t.shape, generator=gen,
                                     device="cuda")).to(t.dtype)
                 for t in ref]
        with torch.no_grad():
            for i, t in enumerate(leaves):
                t.grad = grads[i]
                ref[i].copy_(t)
                if step:
                    rm[i].copy_(ours.state[t]["exp_avg"])
                    rv[i].copy_(ours.state[t]["exp_avg_sq"])
        p0, m0, v0 = ([t.clone() for t in ts] for ts in (ref, rm, rv))
        launches = optim_kernels.adam.launches
        ours.step()
        optim_kernels.adam_ref(ref, grads, rm, rv, kinds, lrs, rc, rs, 1,
                               (0.9, 0.999), 1e-8)
        torch.cuda.synchronize()
        check(optim_kernels.adam.launches == launches + 1,
              "one adam launch a step")
        count = float(ours.state[leaves[0]]["step"])
        check(count == float(rc) == step + 1
              and int(ours.step_t) == int(rs) == step + 1
              and int(ours._ticket) == 0,
              f"adam.cu's counters after step {step + 1}: count {count}, "
              f"step_t {int(ours.step_t)}, ticket {int(ours._ticket)}")
        for i, t in enumerate(leaves):
            a, m, v = t.detach(), ours.state[t]["exp_avg"], \
                ours.state[t]["exp_avg_sq"]
            if kinds[i] == optim_kernels.CURVATURE and (step == 0
                                                        or not bf16):
                check(torch.equal(a, p0[i]) == (step == 0),
                      f"curvature leaf {i} held in burn-in only (step "
                      f"{step + 1})")
            if bf16:
                worst = max(worst, _bf16_ulps(a, ref[i], p0[i]))
                worst_m = max(worst_m,
                              _bf16_ulps(m, rm[i], m0[i], 0.1 * grads[i]),
                              _bf16_ulps(v, rv[i], v0[i]))
                continue
            worst = max(worst, float((a - ref[i]).abs().max()
                                     / (ref[i] - p0[i]).abs().max()
                                     .clamp(min=1e-30)))
            for mine, theirs in ((m, rm[i]), (v, rv[i])):
                worst_m = max(worst_m, float((mine - theirs).abs().max()
                                             / theirs.abs().max()
                                             .clamp(min=1e-30)))
    return ours, (ref, grads, rm, rv, kinds, lrs, rc, rs), worst, worst_m


def _torch_adam(cfg, params, **kw):
    """``torch.optim.Adam`` over the trainer's two groups (a yardstick)."""
    groups = make_optimizer(params, TrainConfig(), cfg.components, None,
                            0).param_groups
    return torch.optim.Adam([{"params": g["params"], "lr": g["lr"]}
                             for g in groups], betas=(0.9, 0.999), eps=1e-8,
                            capturable=True, **kw)


def _cold_us(step, flush, iters: int = 50) -> float:
    """Device time of ``step`` after a write of more than the L2 cache,
    as a real step finds the optimizer's bytes: a graph of (flush, step)
    pairs less a graph of the flushes alone."""
    both = roofline.measure(lambda: (flush.zero_(), step()), iters=iters,
                            graph=True).us
    alone = roofline.measure(flush.zero_, iters=iters, graph=True).us
    return both - alone


def _name_layer_kernels(cfg, params) -> None:
    """The device kernels of one eager step of the replaced layer, by the
    operator that launched each (the source of the step's
    ``elementwise_kernel<128,2>`` rows among them)."""
    opt = _torch_adam(cfg, params, foreach=True)
    step_t = torch.zeros((), dtype=torch.int64, device="cuda")
    _parent_optimizer_layer(params, cfg.components, step_t, 0, opt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _parent_optimizer_layer(params, cfg.components, step_t, 0, opt)
        torch.cuda.synchronize()
    rows: dict = {}
    total = 0
    for ev in prof.events():
        for k in getattr(ev, "kernels", []):
            total += 1
            kname = re.sub(r"\(.*", "", k.name)
            short = ("elementwise_kernel<128,2>" if re.search(
                r"elementwise_kernel<128, ?2,", k.name) else kname[:60])
            parent = ev.cpu_parent.name if ev.cpu_parent else "-"
            key = (short, ev.name, parent)
            n, us = rows.get(key, (0, 0.0))
            rows[key] = (n + 1, us + k.duration)
    print(f"[adam] the replaced layer (mask, torch.optim.Adam foreach "
          f"capturable, counter): {total} kernels, by the operator that "
          f"launched them:")
    for (short, op, parent), (n, us) in sorted(rows.items(),
                                               key=lambda kv: -kv[1][1]):
        print(f"[adam]   {n:3d}x {us:8.2f} us  {short}  <- {op} <- {parent}")


def phase_adam(card: str) -> dict:
    """The optimizer kernel (phase 30): at the flagship's and d2,p2,e2's
    leaves, and the flagship's in bfloat16, against its plain version over
    three steps; its time by CUDA events around a
    graph replay, back to back (the leaves in L2) and after an L2 flush,
    beside its bytes bound; in turns with the layer it replaced (mask,
    torch.optim.Adam foreach capturable, counter); the library yardstick
    (the same with fused=True); the plain version's time; and the kernels
    of the replaced layer named by the operators that launched them."""
    flush = torch.empty(24 * 2 ** 20, device="cuda")     # 96 MB > the L2
    row = None
    for spec in (SPEC, STEREO_SPEC):
        cfg, params = _adam_leaves(spec)
        n = sum(t.numel() for t in _leaves(params))
        ours, plain_args, worst, worst_m = _adam_against_plain(cfg, params)
        check(worst < 1e-4 and worst_m < 1e-6,
              f"adam.cu within 1e-4 of its plain version over three steps "
              f"({spec}): change {worst:.3g}, moments {worst_m:.3g}")
        if spec == SPEC:
            _, _, ulps, ulps_m = _adam_against_plain(
                *_adam_leaves(spec, dtype=torch.bfloat16))
            check(ulps <= 1 and ulps_m <= 1,
                  f"adam.cu in bfloat16 within an ulp of its plain version "
                  f"over three steps ({spec}): parameters {ulps:.3g}, "
                  f"moments {ulps_m:.3g} ulps")
        # the replaced layer and the library yardstick on their own copies
        cfg_f, par_f = _adam_leaves(spec)
        cfg_l, par_l = _adam_leaves(spec)
        foreach = _torch_adam(cfg_f, par_f, foreach=True)
        fused = _torch_adam(cfg_l, par_l, fused=True)
        st_f = torch.zeros((), dtype=torch.int64, device="cuda")
        st_l = torch.zeros((), dtype=torch.int64, device="cuda")

        def previous():
            _parent_optimizer_layer(par_f, cfg_f.components, st_f, 0,
                                    foreach)

        def library():
            _parent_optimizer_layer(par_l, cfg_l.components, st_l, 0, fused)

        turns = [roofline.measure(ours.step, "adam_kernel", iters=100),
                 roofline.measure(previous, iters=100, graph=True),
                 roofline.measure(previous, iters=100, graph=True),
                 roofline.measure(ours.step, "adam_kernel", iters=100)]
        lib = [roofline.measure(library, iters=100, graph=True)
               for _ in range(2)]
        kern_us = (turns[0].us + turns[3].us) / 2
        prev_us = (turns[1].us + turns[2].us) / 2
        lib_us = (lib[0].us + lib[1].us) / 2
        cold = [_cold_us(ours.step, flush), _cold_us(previous, flush),
                _cold_us(previous, flush), _cold_us(ours.step, flush)]
        cold_lib = _cold_us(library, flush)
        plain_ms = time_ms(lambda: optim_kernels.adam_ref(
            *plain_args, 0, (0.9, 0.999), 1e-8), 20)
        nbytes = 28 * n
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        print(f"[adam] {spec}: {len(_leaves(params))} leaves, {n} "
              f"parameters, {nbytes} B: bound {bound_us:.2f} us at 3.35 TB/s "
              f"({card})")
        print(f"[adam] {spec}: in turns kernel / replaced layer / replaced "
              f"layer / kernel, back to back: "
              f"{', '.join(f'{t.us:.2f}' for t in turns)} us (graph events; "
              f"kernel CUPTI median {turns[0].trace_us}, "
              f"{turns[3].trace_us} us); the kernel {prev_us / kern_us:.1f}x "
              f"faster, {100.0 * bound_us / kern_us:.1f}% of its bound")
        print(f"[adam] {spec}: after an L2 flush, in turns: "
              f"{', '.join(f'{u:.2f}' for u in cold)} us; the kernel "
              f"{100.0 * bound_us / ((cold[0] + cold[3]) / 2):.1f}% of its "
              f"bound")
        print(f"[adam] {spec}: library yardstick (mask, torch.optim.Adam "
              f"fused capturable, counter) {lib[0].us:.2f}, {lib[1].us:.2f} "
              f"us back to back, {cold_lib:.2f} us after a flush: the kernel "
              f"{lib_us / kern_us:.2f}x faster; plain version "
              f"{plain_ms * 1e3:.1f} us")
        if spec == SPEC:
            _name_layer_kernels(*_adam_leaves(spec))
            row = {"name": "adam", "route": "cuda",
                   "source": "mvae_torch/kernels/csrc/adam.cu",
                   "replaces": "none (optax's Adam, fused by XLA)",
                   "max_rel_err": worst, "ms": kern_us / 1e3,
                   "cold_ms": (cold[0] + cold[3]) / 2e3,
                   "previous_ms": prev_us / 1e3, "plain_ms": plain_ms,
                   "bound_ms": bound_us / 1e3, "bound_by": "bytes",
                   "library_ms": lib_us / 1e3}
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = phase_card()
    built = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    comps = parse_components(SPEC, fixed_curvature=False)
    kernels = [phase_tail(comps, gen), phase_decode(gen)]
    launches = phase_end_to_end()
    kernels += [phase_tail_bwd(comps, gen), phase_train_decode(gen)]
    ds = load_mnist()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        train_launches, trainer = phase_train(ds, tmp)
        phase_train_plain_decoder(ds, tmp)
        phase_replay(ds, tmp)
        phase_checkpoint(trainer, ds, tmp)
        kernels += phase_stereo_tail(gen)
        kernels.append(phase_reparam(gen, built))
        kernels.append(phase_reparam_chunk(gen))
        stereo_eval = phase_end_to_end(STEREO_SPEC)
        stereo_train = phase_stereo_train(ds, tmp)
        phase_replay(ds, tmp, STEREO_SPEC, b6=False, free_run=False)
        phase_u6(ds, tmp)
        kernels += phase_sphere_tail(gen)
        turns = phase_tail_turns(card)
        for k in kernels:
            if k["name"] in _TURN_ROWS:
                k["ms_in_turns"], k["previous_ms"] = turns[
                    _TURN_ROWS[k["name"]]]
        dist_rows, dist_launches = phase_dist(gen)
        kernels += dist_rows
        sphere_eval = phase_end_to_end(SPHERE_SPEC)
        sphere_train, sphere_trainer = phase_sphere_train(ds, tmp)
        _sample_check(sphere_trainer, SPHERE_SPEC)
        phase_replay(ds, tmp, SPHERE_SPEC, b6=False, free_run=False)
        phase_vmf(ds, tmp)
        roofline_rows, roofline_launches = phase_roofline(gen, built)
        kernels += roofline_rows
        phase_trace(ds, tmp)
        phase_riemannian(ds, tmp, card)
        cifar = load_cifar()
        phase_conv(cifar, tmp, card)
        phase_c4(ds, tmp, card)
        phase_mesh(ds, tmp, card)
        phase_graphs(ds, cifar, tmp, card)
        phase_matrix(ds, tmp)
        phase_mesh_nccl(ds, card)
        phase_bench(gen)
        kernels.append(phase_adam(card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches["tail_bwd"] = train_launches["tail_bwd"]
    launches["train_decode"] = train_launches["train_decode"]
    # the stereographic tile runs inside B1 and B3: its counts are theirs
    # on the d2,p2,e2 path (evaluation, then the training epoch)
    launches["stereo_tile_fwd"] = stereo_eval["tail_fwd"]
    launches["stereo_tile_bwd"] = stereo_train["tail_bwd"]
    launches["reparam_stereo"] = stereo_eval["reparam_stereo"]
    # likewise the sphere tile on the s6:wrapped path
    launches["sphere_tile_fwd"] = sphere_eval["tail_fwd"]
    launches["sphere_tile_bwd"] = sphere_train["tail_bwd"]
    launches.update(dist_launches)
    launches.update(roofline_launches)
    launches["adam"] = train_launches["adam"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
