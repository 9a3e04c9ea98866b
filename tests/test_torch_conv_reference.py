"""The port's conv VAE with a universal-curvature latent against the
benchmark's plain reference of it (``benchmark/reference/convvae.py``), on
the CPU, float64 on both sides, on seeded random weights, at a small size
(8x8x3 intensities, h_dim 16, batch 8): the encoder's features and the
decoder's logits, the loss, each leaf's first gradient, the parameters
after three Adam steps through the trainer's step body (the curvature
frozen for the first two by the burn-in mask, free in the third), and the
IWAE estimate at n = 10 on given noise. Factors ``u2`` and ``u6`` at K = c
of +1, -1, 1e-4 (inside the series windows of both sides) and 0.

Tolerances (relative to the largest reference value, a leaf's norm or the
change's norm): both sides compute in float64 and differ only in the order
of their sums and in where they take series for closed forms (the program
in |K r^2| < 1e-2, the reference in |K r^2| < 1e-4, each exact to ~1e-15
there). The values agree to 2e-16 at these sizes; 1e-10 leaves room for
sums in other orders at other sizes. The gradients and Adam's steps are
held to 1e-8: the closed forms' derivatives just outside the reference's
series window cancel (the curvature's gradient at K = 1e-4 agrees to
3e-12), which the tolerance covers with three digits to spare. The
control (the reference in float32 with its products and convolutions
rounded to TF32) misses the loss's tolerance by orders of magnitude, and
its rounding reaches the convolutions.

The reference's own layouts are held to the definitions they restate:
XLA's SAME conv as an explicit padded correlation, ``lax.conv_transpose``
as the correlation of the stride-dilated input, an odd size included.
"""
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvae_torch.components import parse_components
from mvae_torch.data import ArrayDataset
from mvae_torch.models import vae as tvae
from mvae_torch.train import TrainConfig, Trainer

REFERENCE = (Path(__file__).resolve().parents[1] / "benchmark" / "reference"
             / "convvae.py")
SHAPE, H, B = (8, 8, 3), 16, 8
SPECS = ["u2", "u6"]
CURVATURES = [1.0, -1.0, 1e-4, 0.0]
CASES = [pytest.param(s, c, id=f"{s}-K{c:g}") for s in SPECS
         for c in CURVATURES]
# values: float64 on both sides, sums in another order, series against
# closed forms where each is exact to ~1e-15 (module docstring)
VALUE_TOL = 1e-10
# gradients and Adam's steps: the closed forms' derivatives near K = 0
# lose up to five digits to cancellation
GRAD_TOL = 1e-8


@pytest.fixture(scope="module")
def ref():
    name = "test_reference_convvae"
    spec = importlib.util.spec_from_file_location(name, REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in tree
                for k2, v in _flatten(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _flatten(t, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _cfg(c):
    return {"data_shape": list(SHAPE), "h_dim": H, "init_k": c}


def _weights(ref, spec, c, seed=0, dtype=torch.float64):
    """Seeded random weights at the reference's scales; biases drawn too,
    so every bias path is exercised; c_param = c."""
    lats = ref.parse_spec(spec)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in ref.param_shapes(lats, _cfg(c)).items():
        kind, value = ref.init(lats, _cfg(c))[k]
        if kind == "normal":
            out[k] = value * torch.randn(shape, generator=gen, dtype=dtype)
        elif k.endswith("c_param"):
            out[k] = torch.full(shape, value, dtype=dtype)
        else:
            out[k] = 0.1 * torch.randn(shape, generator=gen, dtype=dtype)
    return lats, out


def _program(spec, weights):
    cfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=False),
                         SHAPE, "conv", h_dim=H)
    params = tvae.init_params(cfg, dtype=torch.float64)
    named = _flatten(params)
    assert list(named) == list(weights)
    with torch.no_grad():
        for k, t in named.items():
            t.copy_(weights[k])
    for t in named.values():
        t.requires_grad_(True)
    return cfg, params


def _inputs(lats, n=B, samples=None, seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n,) + SHAPE, generator=gen, dtype=torch.float64)
    E = sum(l.noise_width for l in lats)
    lead = (n,) if samples is None else (samples, n)
    return x, torch.randn(lead + (E,), generator=gen, dtype=torch.float64)


def _rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("spec,c", CASES)
def test_features_and_logits(ref, spec, c):
    lats, w = _weights(ref, spec, c)
    cfg, params = _program(spec, w)
    x, _ = _inputs(lats)
    assert _rel(tvae.encode(cfg, params, x), ref.encode(w, x)) <= VALUE_TOL
    z = torch.randn((2, B, cfg.z_dim), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    logits = tvae.decode(cfg, params, z)
    assert logits.shape == (2, B) + SHAPE
    assert _rel(logits, ref.logits(w, z)) <= VALUE_TOL


@pytest.mark.parametrize("spec,c", CASES)
def test_loss(ref, spec, c):
    lats, w = _weights(ref, spec, c)
    cfg, params = _program(spec, w)
    x, eps = _inputs(lats)
    got, _ = tvae.loss_fn(cfg, params, x, 1.0, noise=eps)
    assert _rel(got, ref.loss(lats, w, x, eps)) <= VALUE_TOL


@pytest.mark.parametrize("spec,c", CASES)
def test_first_gradient_of_each_leaf(ref, spec, c):
    lats, w = _weights(ref, spec, c)
    cfg, params = _program(spec, w)
    x, eps = _inputs(lats)
    named = _flatten(params)
    got = torch.autograd.grad(tvae.loss_fn(cfg, params, x, 1.0,
                                           noise=eps)[0],
                              list(named.values()))
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want = torch.autograd.grad(ref.loss(lats, p, x, eps), list(p.values()))
    for k, g, r in zip(named, got, want):
        gap = float((g - r).norm() / r.norm())
        assert gap <= GRAD_TOL, (k, gap)


@pytest.mark.parametrize("spec,c", CASES)
def test_three_adam_steps_with_the_curvature_mask(ref, spec, c, tmp_path):
    """The trainer's step body (binarize off, loss, backward, the mask at
    the device step counter, Adam) three times: burn-in of one epoch of two
    steps freezes the curvature in steps 1 and 2 and frees it in step 3."""
    lats, w = _weights(ref, spec, c)
    data, _ = _inputs(lats, n=16, seed=3)
    cfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=False),
                         SHAPE, "conv", h_dim=H)
    ds = ArrayDataset("tiny", data.float().numpy(), data[:8].float().numpy(),
                      SHAPE, False)
    tr = Trainer(cfg, ds, TrainConfig(epochs=1, batch_size=B, lr=1e-3,
                                      curvature_lr=1e-4, burnin_epochs=1,
                                      seed=4, dtype="float64"),
                 run_dir=str(tmp_path), device="cpu")
    assert tr.burnin_steps == 2
    named = _flatten(tr.params)
    with torch.no_grad():
        for k, t in named.items():
            t.copy_(w[k])
    batches = [_inputs(lats, seed=10 + i) for i in range(3)]
    for x, eps in batches:
        tr._step_body(x, None, eps)
    _, _, after = ref.adam(lats, w, batches, 1e-3, 1e-4, burnin_steps=2)
    for k, t in named.items():
        change, want = t.detach() - w[k], after[k] - w[k]
        gap = float((change - want).norm() / want.norm())
        assert gap <= GRAD_TOL, (k, gap)
    # the curvature moved in step 3 alone, at its own rate
    c_key = "components.0.c_param"
    assert 0.0 < abs(float(after[c_key] - w[c_key])) <= 1.0001e-4


@pytest.mark.parametrize("spec,c", CASES)
def test_iwae_estimate(ref, spec, c):
    lats, w = _weights(ref, spec, c)
    cfg, params = _program(spec, w)
    x, eps = _inputs(lats, samples=10)
    with torch.no_grad():
        got = tvae.log_likelihood(cfg, params, x, 10, 5, noise=eps)
    assert _rel(got, ref.iwae(lats, w, x, eps, chunk=5)) <= VALUE_TOL


@pytest.mark.parametrize("spec", SPECS)
def test_tf32_control_fails_the_tolerance(ref, spec):
    """The reference in float32 with TF32 products and convolutions lies
    far outside the loss's tolerance, and its rounding reaches the convs:
    the encoder's features move some hundred times more than float32's."""
    lats, w = _weights(ref, spec, 1.0)
    x, eps = _inputs(lats)
    want = ref.loss(lats, w, x, eps)
    w32 = {k: v.float() for k, v in w.items()}
    x32, eps32 = x.float(), eps.float()
    plain = ref.features(w32, x32)
    with ref.tf32_matmuls():
        assert torch.backends.cudnn.allow_tf32
        got = ref.loss(lats, w32, x32, eps32)
        rounded = ref.features(w32, x32)
    assert _rel(got, want) > 100 * VALUE_TOL
    feats = ref.features(w, x)
    assert _rel(rounded, feats) > 100 * _rel(plain, feats)


@pytest.mark.parametrize("hw", [8, 5])
def test_reference_convs_restate_their_definitions(ref, hw):
    """SAME conv: the input padded by XLA's SAME split (the odd pixel at
    the end) and correlated with the HWIO kernel at stride 2; transposed
    conv: the stride-dilated input padded by 2 a side, correlated with the
    kernel as it is, sums written out."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, hw, hw, 3), generator=gen, dtype=torch.float64)
    w = torch.randn((4, 4, 3, 2), generator=gen, dtype=torch.float64)
    b = torch.randn((2,), generator=gen, dtype=torch.float64)
    lo, hi = ref.same_pads(hw)
    assert lo + hi == max((math.ceil(hw / 2) - 1) * 2 + 4 - hw, 0)
    assert hi - lo in (0, 1)
    xp = np.pad(x.numpy(), ((0, 0), (lo, hi), (lo, hi), (0, 0)))
    n_out = math.ceil(hw / 2)
    want = np.zeros((2, n_out, n_out, 2))
    for i in range(n_out):
        for j in range(n_out):
            patch = xp[:, 2 * i:2 * i + 4, 2 * j:2 * j + 4, :]
            want[:, i, j] = np.einsum("nabc,abcd->nd", patch, w.numpy())
    got = ref.conv(x, w, b)
    np.testing.assert_allclose(got.numpy(), want + b.numpy(), rtol=1e-12,
                               atol=1e-12)

    wt = torch.randn((4, 4, 3, 2), generator=gen, dtype=torch.float64)
    dil = np.zeros((2, 2 * hw - 1, 2 * hw - 1, 3))
    dil[:, ::2, ::2] = x.numpy()
    dil = np.pad(dil, ((0, 0), (2, 2), (2, 2), (0, 0)))
    want = np.zeros((2, 2 * hw, 2 * hw, 2))
    for i in range(2 * hw):
        for j in range(2 * hw):
            want[:, i, j] = np.einsum("nabc,abcd->nd",
                                      dil[:, i:i + 4, j:j + 4], wt.numpy())
    got = ref.conv_transpose(x, wt, b)
    np.testing.assert_allclose(got.numpy(), want + b.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_reference_conv_tf32_backward_rounds_its_operands(ref):
    """On the CPU the control's conv rounds its operands, the backward's
    too: its gradients equal autograd's of the rounded operands."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 8, 8, 3), generator=gen).requires_grad_(True)
    w = torch.randn((4, 4, 3, 4), generator=gen).requires_grad_(True)
    b = torch.zeros(4)
    g = torch.randn((2, 4, 4, 4), generator=gen)
    with ref.tf32_matmuls():
        gx, gw = torch.autograd.grad(ref.conv(x, w, b), (x, w), g)
    r = ref.vae.round_tf32
    xr = r(x.detach()).requires_grad_(True)
    wr = r(w.detach()).requires_grad_(True)
    want = torch.autograd.grad(
        F.conv2d(F.pad(xr.permute(0, 3, 1, 2), (1, 1, 1, 1)),
                 wr.permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1),
        (xr, wr), r(g))
    assert torch.equal(gx, want[0]) and torch.equal(gw, want[1])
