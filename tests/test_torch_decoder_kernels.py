"""The IWAE decode+Bernoulli kernel's plain version (``decode_bce_ref``)
against the JAX kernel ``fused_decode_bce_t`` run in interpret mode and
against a jnp float64 oracle; the wrapper's CPU dispatch and checks; and
the CUDA kernel against its plain version on the card.

Tolerances: 2e-3 nats per row against the JAX kernel (its contract: the
bf16 x 3 split drops the lo*lo term, ~1e-3 nats on a few-hundred-nat row);
1e-9 against the float64 oracle (the same float64 arithmetic, summed in
another order); 1e-3 nats per row between the CUDA kernel (FP32 FMA) and
the full-f32 matmuls of its plain version.

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
