"""The decode+Bernoulli kernels' plain versions against the JAX package,
the wrappers' CPU dispatch and checks, and the CUDA kernels against their
plain versions on the card.

IWAE path: ``decode_bce_ref`` against the JAX kernel ``fused_decode_bce_t``
run in interpret mode and against a jnp float64 oracle. Tolerances: 2e-3
nats per row against the JAX kernel (its contract: the bf16 x 3 split
drops the lo*lo term, ~1e-3 nats on a few-hundred-nat row); 1e-9 against
the float64 oracle (the same float64 arithmetic, summed in another order);
1e-3 nats per row between the CUDA kernel (FP32 FMA) and the full-f32
matmuls of its plain version.

Training path: ``train_decode_ref`` against the JAX float32 decode and
Bernoulli log-likelihood (``vae.decode`` + ``bernoulli_log_prob``), 1e-5
relative (float32 products summed in another order); against the JAX
training kernel ``train_decode_bce`` in interpret mode, 2e-3 relative on
ll (that kernel rounds both products' operands to bf16, 2^-9 relative
each, by design: ~4e-4 of |ll| measured); ``train_decode_bce``'s
gradients against autograd of the plain decode, 1e-10 in float64 and
1e-5 relative in float32. On the card, ll within 1e-3 nats per 784-pixel
row and h, gl within 1e-5 (1 + |ref|).

The JAX package is imported inside the CPU tests only, so the card tests
also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_decoder_kernels.py
"""
import numpy as np
import pytest
import torch

from mvae_torch.kernels import decoder_kernels as tdk


def _inputs(S=4, Z=6, B=64, H=32, D=64, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    zt = rng.standard_normal((S, Z, B))
    xt = (rng.random((D, B)) < 0.4).astype(np.float64)
    w1 = 0.4 * rng.standard_normal((Z, H))
    b1 = 0.1 * rng.standard_normal(H)
    w2 = 0.15 * rng.standard_normal((H, D))
    b2 = 0.1 * rng.standard_normal(D)
    return [a.astype(dtype) for a in (zt, xt, w1, b1, w2, b2)]


def _torch(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("shape", [dict(), dict(S=5, B=77),
                                   dict(S=9, B=32, D=96)])
def test_ref_matches_jax_kernel_interpret(shape):
    import jax.numpy as jnp
    from mvae_tpu.kernels.decoder_kernels import fused_decode_bce_t as \
        jax_kernel
    arrays = _inputs(**shape)
    ours = tdk.decode_bce_ref(*_torch(arrays))
    theirs = jax_kernel(*[jnp.asarray(a) for a in arrays])
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-3,
                               rtol=0)


def test_ref_matches_f64_oracle():
    import jax
    import jax.numpy as jnp

    def _jnp_oracle(zt, xt, w1, b1, w2, b2):
        h = jax.nn.relu(jnp.swapaxes(zt, 1, 2) @ w1 + b1)
        logits = h @ w2 + b2
        return jnp.sum(xt.T[None] * logits - jax.nn.softplus(logits),
                       axis=-1)

    arrays = _inputs(dtype=np.float64, S=3, B=50)
    ours = tdk.decode_bce_ref(*_torch(arrays))
    theirs = jax.jit(_jnp_oracle)(*[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-9,
                               rtol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    args = _torch(_inputs())
    before = tdk.fused_decode_bce_t.launches
    assert torch.equal(tdk.fused_decode_bce_t(*args),
                       tdk.decode_bce_ref(*args))
    assert tdk.fused_decode_bce_t.launches == before
    zt, xt, w1, b1, w2, b2 = args
    with pytest.raises(ValueError):
        tdk.fused_decode_bce_t(zt, xt[:-1], w1, b1, w2, b2)
    with pytest.raises(ValueError):
        tdk.fused_decode_bce_t(zt, xt, w1, b1[:-1], w2, b2)


def test_shared_memory_gate():
    """The flagship (Z=8, H=400) fits one block; a hidden layer whose tile
    exceeds the 227 KB per block does not."""
    assert tdk.shape_supported(8, 400)
    assert tdk.smem_bytes(8, 400) == 4 * (400 * 64 + 8 * 64 + 16 * 64
                                          + 16 * 64)
    assert not tdk.shape_supported(8, 1024)


def _train_inputs(B=16, Z=6, H=32, D=64, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, Z))
    x = (rng.random((B, D)) < 0.4).astype(np.float64)
    w1 = 0.4 * rng.standard_normal((Z, H))
    b1 = 0.1 * rng.standard_normal(H)
    w2 = 0.15 * rng.standard_normal((H, D))
    b2 = 0.1 * rng.standard_normal(D)
    return [a.astype(dtype) for a in (z, x, w1, b1, w2, b2)]


@pytest.mark.parametrize("seed", [0, 1])
def test_train_decode_ref_matches_jax_decode(seed):
    import jax.numpy as jnp
    from mvae_tpu.models import vae as jvae
    from mvae_tpu.models.nets import mlp_decoder_apply
    z, x, w1, b1, w2, b2 = _train_inputs(seed=seed)
    dec = {"layers": ({"w": jnp.asarray(w1), "b": jnp.asarray(b1)},),
           "out": {"w": jnp.asarray(w2), "b": jnp.asarray(b2)}}
    logits = mlp_decoder_apply(dec, jnp.asarray(z))
    assert logits.dtype == jnp.float32
    ll_j = np.asarray(jnp.sum(jvae.bernoulli_log_prob(logits,
                                                      jnp.asarray(x)), -1))
    gl_j = np.asarray(jnp.asarray(x) - 1.0 / (1.0 + jnp.exp(-logits)))
    h_j = np.maximum(np.asarray(jnp.asarray(z) @ jnp.asarray(w1)) + b1, 0.0)
    ll, h, gl = tdk.train_decode_ref(*_torch([z, x, w1, b1, w2, b2]))
    np.testing.assert_allclose(ll.numpy(), ll_j, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), h_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gl.numpy(), gl_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [dict(), dict(B=37, D=96)])
def test_train_decode_ref_matches_jax_kernel_interpret(shape):
    import jax.numpy as jnp
    from mvae_tpu.kernels.decoder_kernels import train_decode_bce as jk
    arrays = _train_inputs(**shape)
    ll_j = np.asarray(jk(*[jnp.asarray(a) for a in arrays]))
    ll, _, _ = tdk.train_decode_ref(*_torch(arrays))
    np.testing.assert_allclose(ll.numpy(), ll_j, rtol=2e-3, atol=0)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                        (np.float32, 1e-5)])
def test_train_decode_grads_match_autograd(dtype, rtol):
    """The Function's backward (four products, two bias sums) against
    autograd through the plain decode, with per-example cotangents."""
    arrays = _torch(_train_inputs(dtype=dtype))
    dll = torch.linspace(-1.0, 2.0, arrays[0].shape[0], dtype=arrays[0].dtype)

    def grads(fn):
        leaves = [a.clone().requires_grad_(i != 1)
                  for i, a in enumerate(arrays)]
        torch.autograd.backward(fn(*leaves), dll)
        return [leaves[i].grad for i in (0, 2, 3, 4, 5)]

    ours = grads(tdk.train_decode_bce)
    theirs = grads(lambda *a: tdk.train_decode_ref(*a)[0])
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=rtol * float(b.abs().max()))


def test_train_decode_wrapper_on_cpu_is_the_plain_version(monkeypatch):
    args = _torch(_train_inputs())
    before = tdk.train_decode_bce.launches
    ll, h, gl = tdk.train_decode_fwd(*args)
    want = tdk.train_decode_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip((ll, h, gl), want))
    assert torch.equal(tdk.train_decode_bce(*args), want[0])
    assert tdk.train_decode_bce.launches == before
    z, x, w1, b1, w2, b2 = args
    with pytest.raises(ValueError):
        tdk.train_decode_fwd(z, x[:, :-1], w1, b1, w2, b2)
    with pytest.raises(ValueError):
        tdk.train_decode_fwd(z, x, w1, b1, w2[:-1], b2)
    for value, on in (("1", True), ("0", False), ("auto", False)):
        monkeypatch.setenv("MVAE_FUSED_TRAIN_DECODER", value)
        assert tdk.use_fused_train_decoder() is on


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [128, 1000])
def test_train_kernel_matches_plain_version_on_card(cuda_device, batch):
    args = [t.to(cuda_device) for t in _torch(_train_inputs(
        B=batch, Z=8, H=400, D=784))]
    before = tdk.train_decode_bce.launches
    ll, h, gl = tdk.train_decode_fwd(*args)
    ll_r, h_r, gl_r = tdk.train_decode_ref(*args)
    torch.cuda.synchronize()
    assert tdk.train_decode_bce.launches == before + 1
    assert float((ll - ll_r).abs().max()) <= 1e-3
    assert bool(((h - h_r).abs() <= 1e-5 * (1 + h_r.abs())).all())
    assert bool(((gl - gl_r).abs() <= 1e-5 * (1 + gl_r.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [dict(S=125, Z=8, B=512, H=400, D=784),
                                   dict(S=7, Z=6, B=77, H=40, D=100)])
def test_kernel_matches_plain_version_on_card(cuda_device, shape):
    args = [t.to(cuda_device) for t in _torch(_inputs(**shape))]
    out = tdk.fused_decode_bce_t(*args)
    ref = tdk.decode_bce_ref(*args)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode kernel has no CPU mode")
    return torch.device("cuda")
