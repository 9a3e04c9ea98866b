"""The port's conv VAE (the CIFAR model) against ``mvae_tpu/models/nets.py``
and ``mvae_tpu.models.vae``, on the CPU, on converted weights.

Tolerances: the conv nets within 1e-12 relative in float64 and 1e-5
relative in float32 (the same products summed in another order), relative
to the largest output; the transposed conv's mapping (XLA's no-flip HWIO
kernel on the stride-dilated input against torch's adjoint form) on its
own, and the encoder at width 10, where XLA's SAME pads 5 -> 3
asymmetrically. The conv u4's encode, decode, ELBO and IWAE (n = 8) on the
same noise: 1e-9 in float64 (the plain paths of both packages), and in
float32 1e-5 relative with a 1e-4 floor on the per-example sums of 192
pixels (the port's tail and chunk reparam on the CPU take their kernels'
plain versions, the JAX package its tail kernel in interpret mode).

The bf16 switches mirror ``tests/models/test_vae.py``. The conv path never
reaches the decode kernels (B2, B6) and runs every convolution, forward and
backward, with cuDNN's TF32 off: on the CPU through the flag each call
sees, on the card (``-m cuda``) against a float64 reference with TF32 on
globally.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mvae_torch.components import parse_components
from mvae_torch.convert import params_from_jax
from mvae_torch.models import nets as tn
from mvae_torch.models import route as troute
from mvae_torch.models import vae as tvae

B = 6
SHAPES = [(8, 8, 3), (16, 16, 1), (32, 32, 3)]
DTYPES = [pytest.param(np.float64, 1e-12, id="f64"),
          pytest.param(np.float32, 1e-5, id="f32")]


def _close(ours, theirs, tol):
    ref = np.asarray(theirs, np.float64)
    got = ours.detach().numpy().astype(np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_conv_nets_match_jax(shape, dtype, tol):
    import jax
    import jax.numpy as jnp
    from mvae_tpu.models import nets as jn
    hw, _, c = shape
    rng = np.random.default_rng(0)
    x = rng.random((2, 3) + shape).astype(dtype)   # two leading batch dims
    z = rng.standard_normal((2, 3, 5)).astype(dtype)
    pe = jn.conv_encoder_init(jax.random.key(0), hw, c, 16, dtype)
    pd = jn.conv_decoder_init(jax.random.key(1), 5, 16, hw, c, dtype)
    _close(tn.conv_encoder_apply(params_from_jax(jax.tree.map(np.asarray,
                                                              pe)),
                                 torch.from_numpy(x)),
           jn.conv_encoder_apply(pe, jnp.asarray(x)), tol)
    _close(tn.conv_decoder_apply(params_from_jax(jax.tree.map(np.asarray,
                                                              pd)),
                                 torch.from_numpy(z)),
           jn.conv_decoder_apply(pd, jnp.asarray(z)), tol)


@pytest.mark.parametrize("hw", [8, 5])
def test_conv_transpose_mapping(hw):
    """``lax.conv_transpose`` (SAME, HWIO, no kernel flip) against the
    port's ``_conv_transpose`` in float64, 8 -> 16 and 5 -> 10."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, hw, hw, 4))
    w = rng.standard_normal((4, 4, 4, 2))
    ref = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(w), (2, 2),
                                 "SAME",
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ours = tn._conv_transpose({"w": torch.from_numpy(w),
                               "b": torch.zeros(2, dtype=torch.float64)},
                              torch.from_numpy(x))
    assert tuple(ours.shape) == (3, 2 * hw, 2 * hw, 2)
    _close(ours, ref, 1e-12)


def test_encoder_at_an_odd_width():
    """At width 10 the first conv pads (1, 1) and the second, on 5, pads
    (1, 2) (XLA's SAME); the fc of a width-12 encoder takes its 3x3x128."""
    import jax
    import jax.numpy as jnp
    from mvae_tpu.models import nets as jn
    assert tn._same_pads(10) == (1, 1) and tn._same_pads(5) == (1, 2)
    assert tn._same_pads(32) == (1, 1)
    pe = jn.conv_encoder_init(jax.random.key(2), 12, 3, 16, np.float64)
    x = np.random.default_rng(2).random((4, 10, 10, 3))
    _close(tn.conv_encoder_apply(params_from_jax(jax.tree.map(np.asarray,
                                                              pe)),
                                 torch.from_numpy(x)),
           jn.conv_encoder_apply(pe, jnp.asarray(x)), 1e-12)


def _models(dtype, spec="u4", shape=(8, 8, 3), seed=0):
    import jax
    from mvae_tpu.components import parse_components as j_parse
    from mvae_tpu.models import vae as jvae
    jcfg = jvae.VAEConfig(j_parse(spec, fixed_curvature=False), shape,
                          arch="conv", h_dim=16)
    tcfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=False),
                          shape, arch="conv", h_dim=16)
    jparams = jvae.init_params(jax.random.key(seed), jcfg, dtype=dtype)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    x = np.random.default_rng(seed).random((B,) + shape).astype(dtype)
    return jcfg, tcfg, jparams, tparams, x


CONV_DTYPES = [pytest.param(np.float64, 1e-9, 1e-9, id="f64"),
               pytest.param(np.float32, 1e-5, 1e-4, id="f32")]


@pytest.mark.parametrize("dtype,tol,atol", CONV_DTYPES)
def test_conv_vae_matches_jax(monkeypatch, dtype, tol, atol):
    """encode, decode, the ELBO and its stats, and IWAE-8 of a conv u4."""
    import jax
    import jax.numpy as jnp
    from mvae_tpu.kernels.tail_kernels import draw_noise_t
    from mvae_tpu.models import vae as jvae
    if dtype == np.float32:
        monkeypatch.setenv("MVAE_FUSED_TAIL", "1")
    jcfg, tcfg, jparams, tparams, x = _models(dtype)
    xt = torch.from_numpy(x)
    feats_j = jvae.encode(jcfg, jparams, jnp.asarray(x))
    np.testing.assert_allclose(tvae.encode(tcfg, tparams, xt).numpy(),
                               np.asarray(feats_j), rtol=tol, atol=atol)
    z = np.random.default_rng(3).standard_normal((B, tcfg.z_dim)).astype(
        dtype)
    np.testing.assert_allclose(
        tvae.decode(tcfg, tparams, torch.from_numpy(z)).numpy(),
        np.asarray(jvae.decode(jcfg, jparams, jnp.asarray(z))), rtol=tol,
        atol=atol)

    key = jax.random.key(11)
    val_j, stats_j = jvae.elbo(key, jcfg, jparams, jnp.asarray(x))
    noise = np.asarray(draw_noise_t(key, jcfg.components, B, dtype)).T
    val_t, stats_t = tvae.elbo(tcfg, tparams, xt,
                               noise=torch.from_numpy(noise.copy()))
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=tol,
                               atol=atol)
    for k in ("kl_per_comp", "curvature", "bce"):
        np.testing.assert_allclose(stats_t[k].numpy(),
                                   np.asarray(stats_j[k]), rtol=tol,
                                   atol=atol)

    # IWAE: the reference's per-sample keys of its unfused estimator
    n, chunk = 8, 4
    ll_j = jvae.log_likelihood(key, jcfg, jparams, jnp.asarray(x), n, chunk)
    rows = [np.asarray(draw_noise_t(sk, jcfg.components, B, dtype)).T
            for ck in jax.random.split(key, n // chunk)
            for sk in jax.random.split(ck, chunk)]
    ll_t = tvae.log_likelihood(tcfg, tparams, xt, n, chunk,
                               noise=torch.from_numpy(np.stack(rows)))
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=tol,
                               atol=atol)


def test_params_from_jax_on_a_conv_tree():
    import jax
    _, tcfg, jparams, tparams, _ = _models(np.float32, "h2,s2,e2",
                                           (16, 16, 3))
    flat_j, tree_j = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    flat_t, tree_t = jax.tree.flatten(
        jax.tree.map(lambda t: t.numpy(), tparams))
    assert tree_j == tree_t
    for a, b in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tuple(tparams["encoder"]["conv1"]["w"].shape) == (4, 4, 3, 64)
    assert tuple(tparams["decoder"]["deconv2"]["w"].shape) == (4, 4, 64, 3)
    assert tuple(tparams["encoder"]["fc"]["w"].shape) == (4 * 4 * 128, 16)
    # the port's own init draws the reference's structure and shapes
    own = tvae.init_params(tcfg, generator=torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in jax.tree.leaves(own)] == [
        a.shape for a in flat_j]


def test_conv_never_reaches_the_decode_kernels(monkeypatch):
    """With the training decode forced on, a conv config's gates are off
    and its ELBO, training gradient and IWAE run without B2 or B6."""
    from mvae_torch.kernels import decoder_kernels
    monkeypatch.setenv("MVAE_FUSED_TRAIN_DECODER", "1")
    tcfg = tvae.VAEConfig(parse_components("u4", fixed_curvature=False),
                          (8, 8, 3), arch="conv", h_dim=16)
    params = tvae.init_params(tcfg, generator=torch.Generator().manual_seed(0))
    r = troute.route(tcfg, params)
    assert not r.iwae_decoder and not r.train_decoder
    rep = troute.report(tcfg, params, "cpu")
    assert not rep["iwae_decoder"]["active"]
    assert not rep["train_decoder"]["active"]

    def refuse(*args, **kwargs):
        raise AssertionError("a decode kernel was called")

    for name in ("fused_decode_bce_t", "train_decode_bce",
                 "train_decode_fwd"):
        monkeypatch.setattr(decoder_kernels, name, refuse)
    for t in params["encoder"]["conv1"].values():
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((B, 8, 8, 3), generator=g)
    loss, _ = tvae.loss_fn(tcfg, params, x, generator=g)
    loss.backward()
    assert bool(torch.isfinite(params["encoder"]["conv1"]["w"].grad).all())
    ll = tvae.log_likelihood(tcfg, params, x, 8, 4, generator=g)
    assert ll.shape == (B,) and bool(torch.isfinite(ll).all())


class _ConvFlags(TorchDispatchMode):
    """Records cuDNN's TF32 flag at every convolution, forward or backward."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.convolution,
                                   torch.ops.aten.convolution_backward):
            self.seen.append((func.overloadpacket.__name__,
                              torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


def _conv_step(device, dtype=torch.float32):
    """One conv u4 loss and its gradients on ``device`` in ``dtype``, from
    weights, data and noise drawn in float64 on the CPU; returns the loss
    and the encoder's first conv weight gradient."""
    tcfg = tvae.VAEConfig(parse_components("u4", fixed_curvature=False),
                          (16, 16, 3), arch="conv", h_dim=32)
    params = tvae._tree_map(
        lambda t: t.to(device, dtype),
        tvae.init_params(tcfg, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(0)))
    w = params["encoder"]["conv1"]["w"].requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    f64 = torch.zeros((), dtype=torch.float64)
    x = torch.rand((16, 16, 16, 3), generator=g, dtype=torch.float64)
    noise = tvae.tail_kernels.draw_noise(tcfg.components, (16,), f64, g)
    loss, _ = tvae.loss_fn(tcfg, params, x.to(device, dtype),
                           noise=noise.to(device, dtype))
    loss.backward()
    return loss.detach(), w.grad


def test_conv_runs_with_cudnn_tf32_off():
    """Every convolution of a training step, forward and backward, sees
    cuDNN's TF32 off, whatever the global flag; the flag is restored."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with _ConvFlags() as mode:
            _conv_step("cpu")
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = old
    names = {name for name, _ in mode.seen}
    assert names == {"convolution", "convolution_backward"}, mode.seen
    assert not any(flag for _, flag in mode.seen), mode.seen


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's TF32 exists only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_conv_refuses_tf32_on_card(cuda_device):
    """With TF32 on globally (PyTorch's cuDNN default), the conv path's
    loss and first-layer gradient on the card agree with float64 on the
    CPU to float32 grade (TF32's 10-bit mantissa would be ~1e-3 off)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        loss, grad = _conv_step(cuda_device)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    loss64, grad64 = _conv_step("cpu", torch.float64)
    assert abs(loss.item() - loss64.item()) <= 1e-5 * abs(loss64.item())
    err = (grad.double().cpu() - grad64).abs().max() / grad64.abs().max()
    assert err.item() <= 1e-4, err.item()


def test_bf16_conv_activations_close_to_f32_and_grads_finite():
    """MVAE_BF16_CONV_ACT: bf16 activations between the convs with f32
    master weights track the f32 loss to bf16 rounding, the gradients stay
    finite in the master dtype, and off is bit-identical to before."""
    tcfg = tvae.VAEConfig(parse_components("u2"), (8, 8, 3), arch="conv",
                          h_dim=16)
    params = tvae.init_params(tcfg, generator=torch.Generator().manual_seed(0))
    x = (torch.rand((8, 8, 8, 3), generator=torch.Generator().manual_seed(1))
         > 0.5).float()
    noise = tvae.tail_kernels.draw_noise(tcfg.components, (8,), x,
                                         torch.Generator().manual_seed(2))

    def loss():
        return tvae.loss_fn(tcfg, params, x, noise=noise)[0]

    l_f32 = loss().item()
    leaves = [t for d in (params["encoder"], params["decoder"])
              for layer in d.values() for t in layer.values()]
    for t in leaves:
        t.requires_grad_(True)
    try:
        tn.set_bf16_conv_activations(True)
        l_b = loss()
        l_b.backward()
    finally:
        tn.set_bf16_conv_activations(False)
    assert np.isfinite(l_b.item())
    assert abs(l_b.item() - l_f32) / abs(l_f32) < 0.02, (l_b.item(), l_f32)
    for t in leaves:
        assert t.grad.dtype == torch.float32
        assert bool(torch.isfinite(t.grad).all())
    with torch.no_grad():
        assert loss().item() == l_f32


def test_bf16_conv_grads_finite():
    """--dtype bfloat16 with arch=conv: bf16 weights and inputs through
    the convs and their backward."""
    tcfg = tvae.VAEConfig(parse_components("u2"), (8, 8, 3), arch="conv",
                          h_dim=16)
    params = tvae.init_params(tcfg, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(0))
    leaves = [t for d in (params["encoder"], params["decoder"])
              for layer in d.values() for t in layer.values()]
    for t in leaves:
        t.requires_grad_(True)
    x = (torch.rand((4, 8, 8, 3), generator=torch.Generator().manual_seed(1))
         > 0.5).to(torch.bfloat16)
    loss, _ = tvae.loss_fn(tcfg, params, x,
                           generator=torch.Generator().manual_seed(2))
    loss.backward()
    for t in leaves:
        assert bool(torch.isfinite(t.grad.float()).all())


def test_bf16_matmul_flag_switches_gemm_precision():
    p = {"w": torch.ones((4, 3)), "b": torch.zeros(3)}
    x = torch.full((2, 4), 1.0 / 3.0)
    try:
        tn.set_bf16_matmul(True)
        lo = tn._linear(p, x)
        tn.set_bf16_matmul(False)
        hi = tn._linear(p, x)
    finally:
        tn.set_bf16_matmul(False)
    assert lo.dtype == torch.float32  # f32 accumulate and output either way
    np.testing.assert_allclose(hi.numpy(), 4.0 / 3.0, rtol=1e-7)
    assert abs(lo[0, 0].item() - 4.0 / 3.0) > 1e-4  # bf16-rounded operands
