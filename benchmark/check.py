"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (the configuration's reference module,
``reference/__init__.py``, passed in as ``ref``; float64, TF32 off) on the
same inputs, which the reference binarizes (where the configuration does)
and draws through again itself.

Training: the first three steps of the checked epoch. Set-up runs epoch 0
once to warm up and capture the step's graph (its first steps eager), puts
the trainer back to the initial weights and a fresh Adam state in place,
and runs epoch 0 again through the window's own epoch call: each of its
steps a replay of the graph the window replays, on rows that all differ.
The reference follows those three steps from the same weights. Numbers
(a cell compares those its ``limits`` name; the rest stay in the result's
``look``):

* ``loss_rel_gap`` / ``loss_median_gap``: the largest / the median over
  the three steps of |loss - reference loss| / |reference loss|;
* ``grad_norm_gap`` / ``grad_median_gap``: over the parameter leaves, the
  largest / the median gap between the norm of the program's first
  gradient (Adam's first moment after step one over 1 - beta1) and the
  reference's, over the larger of the reference leaf's norm and the
  median leaf's;
* ``change_median_gap``: the median over the parameter leaves of the same
  gap for the parameters' change over the three steps, leaving out the
  leaves whose reference gradient is under a thousandth of the median
  leaf's (the curvature, frozen in burn-in).

The largest of a leaf or a step swings from seed to seed where one
example or one small leaf is ill-conditioned in float32 (a projected
sphere's sample near its pole, the vMF mean head): PERF.md.

IWAE: ``ll_gap_nats``, the largest |estimate - reference| over every
example of the sampled passes.
"""
from __future__ import annotations

import contextlib
import statistics

import torch

import generate
from reference import binarize

NEGLIGIBLE = 1e-3
# the reference decodes this many importance samples at a time (memory only)
REF_CHUNK = 125


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(prog: dict, refs: dict, keep=None) -> dict:
    """Leaf -> |norm(prog) - norm(ref)| / max(norm(ref), median leaf's
    norm(ref))."""
    names = [k for k in refs if keep is None or k in keep]
    pn, rn = _norms({k: prog[k] for k in names}), _norms(
        {k: refs[k] for k in names})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in names}


def worst(gaps: dict, top: int = 3) -> list:
    """The ``top`` leaves with the widest gaps, widest first."""
    return sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[
        :top]


def train_batches(ref, cfg: dict, traffic: dict, seed: int, train,
                  steps: int, dtype, half: bool = False):
    """The first ``steps`` batches of epoch 0 as the reference sees them:
    (x, binary where the configuration binarizes, noise) in ``dtype``;
    ``half`` keeps the first half of each (a fault)."""
    perm, u, nz = generate.train_draws(ref, cfg, traffic, seed, 0,
                                       train.device)
    out = []
    for k in range(steps):
        x = train[perm[k]]
        x = (x if u is None else u[k] < x).to(dtype)
        e = nz[k].to(dtype)
        if half:
            x, e = x[:len(x) // 2], e[:len(e) // 2]
        out.append((x, e))
    return out


def reference_train(ref, cfg: dict, traffic: dict, seed: int, train,
                    w0: dict, dtype=torch.float64, tf32: bool = False,
                    half: bool = False, steps: int = 3):
    """The reference's first ``steps`` Adam steps from ``w0``: (losses, the
    first gradients, the parameters after)."""
    lats = ref.parse_spec(cfg["spec"])
    batches = train_batches(ref, cfg, traffic, seed, train, steps, dtype,
                            half)
    p = {k: v.to(dtype) for k, v in w0.items()}
    S = cfg["train_examples"] // traffic["batch_size"]
    run = ref.tf32_matmuls() if tf32 else contextlib.nullcontext()
    with run:
        return ref.adam(lats, p, batches, cfg["lr"], cfg["curvature_lr"],
                        cfg["burnin_epochs"] * S, beta=cfg["beta"])


def train_numbers(losses, grad, after, w0: dict, reference,
                  look: dict | None = None) -> dict:
    """The three training numbers of a run whose first steps gave
    ``losses``, ``grad`` and ``after``, against ``reference``; ``look``
    gets the leaves with the widest gaps of each. A run that never took
    its first or third step reads infinite gaps."""
    if grad is None or after is None:
        return dict.fromkeys(("loss_rel_gap", "loss_median_gap",
                              "grad_norm_gap", "grad_median_gap",
                              "change_median_gap"), float("inf"))
    r_losses, r_grad, r_after = reference
    losses = losses.double().cpu()
    r_losses = r_losses.double().cpu()
    loss_gaps = torch.abs(losses - r_losses) / torch.abs(r_losses)
    gn = _norms(r_grad)
    med = statistics.median(gn.values())
    keep = {k for k, v in gn.items() if v >= NEGLIGIBLE * med}
    w = {k: v.double() for k, v in w0.items()}
    change = {k: after[k].double() - w[k] for k in w}
    r_change = {k: r_after[k].double() - w[k] for k in w}
    g_gaps = leaf_gaps(grad, r_grad)
    c_gaps = leaf_gaps(change, r_change, keep)
    if look is not None:
        look["grad_norm_gap"] = worst(g_gaps)
        look["change_norm_gap"] = worst(c_gaps)
    return {"loss_rel_gap": float(loss_gaps.max()),
            "loss_median_gap": float(loss_gaps.median()),
            "grad_norm_gap": max(g_gaps.values()),
            "grad_median_gap": statistics.median(g_gaps.values()),
            "change_median_gap": statistics.median(c_gaps.values())}


def eval_rows(cfg: dict, test):
    """The test split as the pass batches it: (batches (nb, bs,
    *data_shape), row ids (nb, bs)), the last batch padded with the first
    example."""
    nb, bs = generate.eval_batches(cfg)
    pad = nb * bs - len(test)
    x = (torch.cat([test, test[:1].expand((pad,) + test.shape[1:])]) if pad
         else test)
    rows = torch.arange(nb * bs, device=test.device).reshape(nb, bs)
    return x.reshape((nb, bs) + test.shape[1:]), rows


def eval_batch(cfg: dict, seed: int, rows, x):
    """An eval batch as the pass sees it: pinned binarization of the rows
    ``rows`` where the configuration binarizes."""
    if not cfg["binarize"]:
        return x
    return binarize.fixed(seed, rows, x.reshape(len(x), -1)).reshape(x.shape)


def reference_iwae(ref, cfg: dict, traffic: dict, seed: int, test,
                   w0: dict, index: int, dtype=torch.float64,
                   tf32: bool = False):
    """The reference's IWAE estimates of pass ``index`` (n_test,)."""
    lats = ref.parse_spec(cfg["spec"])
    p = {k: v.to(dtype) for k, v in w0.items()}
    batches, rows = eval_rows(cfg, test)
    noise = generate.iwae_noise(ref, cfg, traffic, seed, index, test.device)
    out = []
    with (ref.tf32_matmuls() if tf32 else contextlib.nullcontext()):
        for i in range(len(batches)):
            x = eval_batch(cfg, seed, rows[i], batches[i]).to(dtype)
            out.append(ref.iwae(lats, p, x, noise[i].to(dtype),
                                REF_CHUNK))
    return torch.cat(out)[:len(test)]


def iwae_numbers(estimates, reference) -> dict:
    return {"ll_gap_nats": float(torch.max(torch.abs(
        estimates.double() - reference.double())))}
