"""The decode+Bernoulli kernels' plain versions against the JAX package,
the wrappers' CPU dispatch and checks, and the CUDA kernels against their
plain versions on the card.

IWAE path: ``decode_bce_ref`` against the JAX kernel ``fused_decode_bce_t``
run in interpret mode and against a jnp float64 oracle. Tolerances: 2e-3
nats per row against the JAX kernel (its contract: the bf16 x 3 split
drops the lo*lo term, ~1e-3 nats on a few-hundred-nat row); 1e-9 against
the float64 oracle (the same float64 arithmetic, summed in another order);
1e-3 nats per row between the CUDA kernel (3xTF32 on the tensor cores)
and the full-f32 matmuls of its plain version, at the production chunk, at
ragged batches (77; 272, the 10,000-example test split's last batch at
512), at a D that takes the kernel's 4-byte copies, and with logits past
|30| in every row, where softplus must stay stable.

The kernel's numerics, emulated in torch on the CPU at full width (Z = 8,
H = 400, D = 784; S = 2, B = 64): each float32 operand of h W2 is split into
a TF32 pair (``tf32_split_ref``: hi = a rounded to nearest TF32 as
``cvt.rna.tf32.f32`` rounds, by adding 0x1000 to the bits and clearing the
low 13; lo = a - hi, of which the tensor core reads the top 19 bits) and
the three products a_lo b_hi + a_hi b_lo + a_hi b_hi are summed exactly:
within 1e-3 nats per row of the float64 oracle, where one TF32 pass
(operands rounded the same way) misses the gate. The tensor core's float32 accumulation
truncates; modelled as one round-toward-zero of each k-step's exact sum
into the accumulator, a single accumulator misses the gate and the
kernel's scheme (small products apart, the large one in a partial per
32-deep stage added with a rounded add) holds it.

Training path: ``train_decode_ref`` against the JAX float32 decode and
Bernoulli log-likelihood (``vae.decode`` + ``bernoulli_log_prob``), 1e-5
relative (float32 products summed in another order); against the JAX
training kernel ``train_decode_bce`` in interpret mode, 2e-3 relative on
ll (that kernel rounds both products' operands to bf16, 2^-9 relative
each, by design: ~4e-4 of |ll| measured); ``train_decode_bce``'s
gradients against autograd of the plain decode, 1e-10 in float64 and
1e-5 relative in float32. The training kernel's tile plan
(``train_tile_plan``: a block per 16 rows x 32 pixels, W2 resident or in a
ring, the h shares) and the switch's device rule, without a card; its
3xTF32 product emulated with truncating adds, against the float64 oracle
(1e-3 nats per row) and the FP32 plain version (gl within 1e-5 (1 +
|ref|)). On the card, at four (Z, H, D) and batches 1 to 1024, ll within
1e-3 nats per row and h, gl within 1e-5 (1 + |ref|), two calls and ten
CUDA-graph replays bit for bit.

The JAX package is imported inside the CPU tests only, so the card tests
also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_decoder_kernels.py
"""
import numpy as np
import pytest
import torch

from mvae_torch.kernels import decoder_kernels as tdk


def _inputs(S=4, Z=6, B=64, H=32, D=64, dtype=np.float32, seed=0,
            big_logits=False):
    """Decode inputs; ``big_logits`` puts a bias of +-40 on every 49th
    pixel, so that every row has logits past |30| there."""
    rng = np.random.default_rng(seed)
    zt = rng.standard_normal((S, Z, B))
    xt = (rng.random((D, B)) < 0.4).astype(np.float64)
    w1 = 0.4 * rng.standard_normal((Z, H))
    b1 = 0.1 * rng.standard_normal(H)
    w2 = 0.15 * rng.standard_normal((H, D))
    b2 = 0.1 * rng.standard_normal(D)
    if big_logits:
        b2[::49] = 40.0 * (-1.0) ** np.arange(len(b2[::49]))
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


@pytest.mark.parametrize("kernel", ["decode", "train"])
def test_shared_memory_gate(kernel):
    """The flagship (Z=8, H=400) fits one block; a hidden layer whose tile
    exceeds the 227 KB per block does not. The IWAE decode (B2) keeps h for
    64 examples at H rounded up to its 32-deep stage plus 4 words a row,
    beside two W2 stages split into hi and lo tiles (14 groups of 8 x 32
    words, each padded by 4), the z tile and the 2 warpgroups' row
    partials; the training decode (B6) its own tile."""
    if kernel == "decode":
        assert tdk.decode_shape_supported(8, 400)
        assert tdk.decode_smem_bytes(8, 400) == 4 * (
            2 * 2 * 14 * 260 + 64 * (416 + 4) + 8 * 64 + 2 * 64) == 168_320
        assert tdk.decode_smem_bytes(8, 384) == tdk.decode_smem_bytes(8, 361)
        assert tdk.decode_shape_supported(8, 640)
        assert not tdk.decode_shape_supported(8, 641)
        assert not tdk.decode_shape_supported(8, 1024)
    else:
        # B6: h for 16 rows at a stride of 101 float4 words (400 units in
        # 25 stages of 16, made odd), the z tile, all 25 W2 stages of 16
        # rows of 40 words (32 pixels and 8 of padding), and the 4 warps'
        # 16 x 40 partial tiles
        assert tdk.shape_supported(8, 400)
        assert tdk.smem_bytes(8, 400) == 4 * (
            16 * 404 + 8 * 16 + 25 * 16 * 40 + 4 * 16 * 40) == 100_608
        # past 976 units W2 streams through a ring of 4 stages
        assert tdk.train_tile_plan(128, 8, 976, 784)["slots"] == 61
        assert tdk.train_tile_plan(128, 8, 977, 784)["slots"] == 4
        assert tdk.smem_bytes(8, 977) == 4 * (
            16 * 996 + 8 * 16 + 4 * 16 * 40 + 4 * 16 * 40)
        assert tdk.shape_supported(8, 3296)
        assert not tdk.shape_supported(8, 3297)
        assert not tdk.shape_supported(8, 4096)


@pytest.mark.parametrize("B,Z,H,D", [
    (128, 8, 400, 784), (1, 8, 400, 784), (127, 8, 400, 784),
    (512, 8, 400, 784), (1000, 8, 400, 784), (1024, 8, 400, 784),
    (128, 2, 33, 98), (1000, 2, 33, 98), (127, 16, 600, 784),
    (1024, 32, 400, 784), (128, 8, 2000, 784), (1, 1, 1, 1)])
def test_train_tile_plan(B, Z, H, D):
    """The training kernel's launch: a block per 16 rows x 32 pixels (at
    least one block per SM of the 132 at the flagship's B = 128) and a
    counter per row tile, W2 in 16-unit stages, all resident when they fit
    (by the Tensor Memory Accelerator where its rows are whole 16-byte
    words, D % 4 == 0, else by cp.async) and a ring of 4 otherwise, one
    row partial per (row, pixel tile)."""
    p = tdk.train_tile_plan(B, Z, H, D)
    assert p["row_tiles"] == -(-B // 16) and p["pixel_tiles"] == -(-D // 32)
    blocks = p["row_tiles"] * p["pixel_tiles"]
    assert p["part"] == 16 * blocks
    if (B, D) == (128, 784):
        assert blocks == 200 >= 132
    assert p["stages"] * 16 >= H > (p["stages"] - 1) * 16
    assert p["slots"] == (4 if H == 2000 else p["stages"])
    assert p["fetch"] == ("ring" if H == 2000 else "copy" if D % 4
                          else "tma")
    assert p["hp"] % 4 == 0 and (p["hp"] // 4) % 2 == 1
    assert p["hp"] >= p["stages"] * 16
    assert p["smem"] == tdk.smem_bytes(Z, H) <= 232_448 - 128
    assert tdk.shape_supported(Z, H)


def test_train_tile_plan_refuses_what_it_cannot_hold():
    assert tdk.train_tile_plan(128, 8, 4096, 784) is None
    assert tdk.train_tile_plan(128, 0, 400, 784) is None
    assert tdk.train_tile_plan(128, 8, 400, 0) is None
    assert not tdk.shape_supported(0, 400)
    assert tdk.train_tile_plan(0, 8, 400, 784)["row_tiles"] == 0


@pytest.mark.parametrize("value,device,on", [
    ("auto", "cpu", False), ("auto", "cuda", True), ("1", "cpu", True),
    ("1", "cuda", True), ("0", "cpu", False), ("0", "cuda", False)])
def test_train_decoder_switch_follows_the_device(monkeypatch, value, device,
                                                 on):
    """The switch's device rule, without a card: "auto" turns the training
    decode kernel on for CUDA parameters (the H100's measurement) and
    leaves CPU ones on the plain decode; "1" and "0" hold on both. The
    route reads the decoder weights' device, its report says the same, and
    the training tail does not follow the switch."""
    from mvae_torch.components import parse_components
    from mvae_torch.models import route, vae

    class Weight:
        dtype = torch.float32

        def __init__(self, device):
            self.device = torch.device(device)

    monkeypatch.setenv("MVAE_FUSED_TRAIN_DECODER", value)
    cfg = vae.VAEConfig(parse_components("h2,s2,e2"), (784,), h_dim=400)
    params = vae.init_params(cfg, device="meta")
    params["decoder"]["out"]["w"] = Weight(device)
    assert route.route(cfg, params).train_decoder is on
    rep = route.report(cfg, params, device)
    assert rep["train_decoder"]["active"] is on
    assert ("train_decode.cu" in rep["train_decoder"]["why"]) is on
    assert rep["train_tail"]["active"] and \
        "tail_bwd.cu" in rep["train_tail"]["why"]
    assert rep["optimizer"]["active"] is (device == "cuda")


def test_decode_gate_refuses_what_the_kernel_cannot_hold(monkeypatch):
    """The wrapper raises on a CUDA-typed call whose h does not fit (the
    check runs before any launch), and the IWAE route takes B2's gate."""
    from mvae_torch.components import parse_components
    from mvae_torch.models import route, vae

    def iwae_decoder(h_dim):
        cfg = vae.VAEConfig(parse_components("h2,s2,e2"), (784,),
                            h_dim=h_dim)
        return route.route(cfg, vae.init_params(cfg, device="meta")
                           ).iwae_decoder

    assert not iwae_decoder(700)
    assert iwae_decoder(400)


# --- the kernel's numerics, emulated ---------------------------------------------


def _tf32_numpy(x):
    """Round float32 to 11 significant bits, ties away from zero, through
    frexp: an independent statement of cvt.rna.tf32.f32."""
    m, e = np.frexp(x.astype(np.float64))
    r = np.copysign(np.floor(np.abs(m) * 2.0 ** 11 + 0.5), m)
    return np.ldexp(r, e - 11).astype(np.float32)


def _edge_floats():
    """Random normal floats over 60 decades, exact ties of the 13 bits TF32
    drops (both signs), mantissas that carry into the exponent, zeros."""
    rng = np.random.default_rng(0)
    return np.concatenate([
        (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)
         ).astype(np.float32),
        (np.arange(1, 65, dtype=np.uint32) << 13 | 0x3F801000).view(
            np.float32),
        -(np.arange(1, 65, dtype=np.uint32) << 13 | 0x3F801000).view(
            np.float32),
        np.array([0x3FFFF000, 0x00FFF000], dtype=np.uint32).view(np.float32),
        np.array([0.0, -0.0, 1.0, -2.5, 2e-38, -3e38], dtype=np.float32)])


def test_tf32_rna_emulation_rounds_to_eleven_bits():
    """The bit-level round to nearest (the kernel's hi, as ``cvt.rna``
    rounds) against frexp arithmetic, bit for bit."""
    x = _edge_floats()
    got = tdk.tf32_rna_ref(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), _tf32_numpy(x).view(np.uint32))
    assert not np.any(got.view(np.uint32) & 0x1FFF)


def test_tf32_split_is_exact_and_keeps_22_bits():
    """The kernel's split: hi is a rounded to TF32, hi + lo is a exactly,
    and hi + (lo as the tensor core reads it) keeps 22 of a's 24 bits."""
    x = torch.from_numpy(_edge_floats())
    hi, lo = tdk.tf32_split_ref(x)
    assert torch.equal(hi, tdk.tf32_rna_ref(x))
    assert torch.equal(hi.double() + lo.double(), x.double())
    fin = x.abs() > 1e-30            # where lo is a normal float
    seen = hi.double() + tdk.tf32_trunc_ref(lo).double()
    rel = ((seen - x.double()).abs() / x.double().abs())[fin]
    assert float(rel.max()) < 2.0 ** -21


_FULL = dict(S=2, Z=8, B=64, H=400, D=784)


def _full_inputs(seed=3):
    """Full-width decode inputs scaled as the flagship's random init (h
    ~ O(1), logits ~ N(0, 2)), float32."""
    rng = np.random.default_rng(seed)
    S, Z, B, H, D = (_FULL[k] for k in "SZBHD")
    zt = rng.standard_normal((S, Z, B)).astype(np.float32)
    xt = (rng.random((D, B)) < 0.3).astype(np.float32)
    w1 = (np.sqrt(2.0 / Z) * rng.standard_normal((Z, H))).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(H)).astype(np.float32)
    w2 = (np.sqrt(2.0 / H) * rng.standard_normal((H, D))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return [torch.from_numpy(a) for a in (zt, xt, w1, b1, w2, b2)]


def _bce_rows(logits, xt, S):
    x = xt.T.double().repeat(S, 1)
    logits = logits.double()
    return (x * logits - torch.nn.functional.softplus(logits)).sum(-1)


def _h_rows(zt, w1, b1):
    """h as the kernel computes it: float32 FMAs (here float32 matmul)."""
    return torch.relu(torch.matmul(zt.transpose(1, 2), w1) + b1).reshape(
        -1, w1.shape[1])


def test_3xtf32_decode_emulation_meets_the_gate():
    zt, xt, w1, b1, w2, b2 = _full_inputs()
    S = zt.shape[0]
    oracle = tdk.decode_bce_ref(*[a.double() for a in (zt, xt, w1, b1, w2,
                                                       b2)]).reshape(-1)
    h = _h_rows(zt, w1, b1)
    (hh, hl), (wh, wl) = tdk.tf32_split_ref(h), tdk.tf32_split_ref(w2)
    hl, wl = tdk.tf32_trunc_ref(hl), tdk.tf32_trunc_ref(wl)
    d = torch.float64
    three = ((hl.to(d) @ wh.to(d) + hh.to(d) @ wl.to(d)) + hh.to(d) @ wh.to(d))
    err3 = (_bce_rows(three.float() + b2, xt, S) - oracle).abs().max().item()
    # one pass, each operand rounded to nearest TF32
    one = (tdk.tf32_rna_ref(h).to(d) @ tdk.tf32_rna_ref(w2).to(d)).float()
    err1 = (_bce_rows(one + b2, xt, S) - oracle).abs().max().item()
    # (1.2e-5 here, the full-float32 plain version 8.7e-5; one TF32 pass
    # 3.0e-2)
    assert err3 <= 1e-3, err3
    assert err1 > 1e-3, err1


def _rz(x64):
    """float64 -> float32 rounded toward zero."""
    f = x64.float()
    over = f.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


@pytest.mark.parametrize("scheme,holds", [("single", False),
                                          ("kernel", True)])
def test_accumulation_scheme_under_truncating_adds(scheme, holds):
    """Each wgmma adds its k-step's products into the float32
    accumulator with truncation (modelled: the exact sum, rounded toward
    zero). Over the 150 mma of a logit that bias misses the 1e-3-nat gate
    in one accumulator; the kernel's scheme holds it."""
    zt, xt, w1, b1, w2, b2 = _full_inputs()
    S, H = zt.shape[0], w1.shape[1]
    oracle = tdk.decode_bce_ref(*[a.double() for a in (zt, xt, w1, b1, w2,
                                                       b2)]).reshape(-1)
    hp = -(-H // 32) * 32
    pad = hp - H
    h = torch.nn.functional.pad(_h_rows(zt, w1, b1), (0, pad))
    (hh, hl), (wh, wl) = tdk.tf32_split_ref(h), tdk.tf32_split_ref(
        torch.nn.functional.pad(w2, (0, 0, 0, pad)))
    hl, wl = tdk.tf32_trunc_ref(hl), tdk.tf32_trunc_ref(wl)
    shape = (h.shape[0], w2.shape[1])
    acc, small, part = (torch.zeros(shape) for _ in range(3))

    def mma(c, a, b, k0):
        return _rz(c.double() + a[:, k0:k0 + 8].double()
                   @ b[k0:k0 + 8].double())

    for k0 in range(0, hp, 8):
        if scheme == "single":
            for a, b in ((hl, wh), (hh, wl), (hh, wh)):
                acc = mma(acc, a, b, k0)
        else:
            small = mma(mma(small, hl, wh, k0), hh, wl, k0)
            part = mma(part, hh, wh, k0)
            if k0 % 32 == 24:
                acc, part = acc + part, torch.zeros(shape)
    err = (_bce_rows((acc + small) + b2, xt, S) - oracle).abs().max().item()
    assert (err <= 1e-3) == holds, err


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
    from mvae_torch.components import parse_components
    from mvae_torch.models import route, vae
    cfg = vae.VAEConfig(parse_components("h2,s2,e2"), (20,), h_dim=16)
    params = vae.init_params(cfg)
    for value, on in (("1", True), ("0", False), ("auto", False)):
        monkeypatch.setenv("MVAE_FUSED_TRAIN_DECODER", value)
        assert route.route(cfg, params).train_decoder is on


# the flagship's widths; a narrow ragged D (4-byte copies, scalar h and gl
# stores); a wide H; an H whose W2 slice streams through the ring
@pytest.mark.parametrize("scheme,shape,holds", [
    ("restart", dict(Z=8, H=400, D=784), True),
    ("restart", dict(Z=16, H=600, D=784), True),
    ("accumulate", dict(Z=16, H=600, D=784), False)])
def test_train_decode_3xtf32_scheme_under_truncating_adds(scheme, shape,
                                                          holds):
    """B6's product emulated on the CPU: h W2 as three TF32 products in
    8-deep mma steps, warp w taking the steps k with k % 4 == w, each add
    into the tensor core's float32 accumulator truncated (the exact sum
    rounded toward zero), the 4 warps' tiles added in order. With the large
    product accumulated over a warp's steps ("accumulate") the bias misses
    1e-3 nats a row at logits near 26; restarted from zero every step and
    added into a rounded float32 sum ("restart", the kernel's scheme) it
    holds, with gl within 1e-5 (1 + |ref|) of the FP32 plain version."""
    z, x, w1, b1, w2, b2 = _torch(_train_inputs(B=1024, **shape))
    ll_r, h_r, gl_r = tdk.train_decode_ref(z, x, w1, b1, w2, b2)
    ll64 = tdk.train_decode_ref(*[a.double() for a in (z, x, w1, b1, w2,
                                                       b2)])[0]
    H, D = w2.shape
    pad = -(-H // 16) * 16 - H
    h = torch.nn.functional.pad(h_r, (0, pad))
    (hh, hl), (wh, wl) = tdk.tf32_split_ref(h), tdk.tf32_split_ref(
        torch.nn.functional.pad(w2, (0, 0, 0, pad)))
    hl, wl = tdk.tf32_trunc_ref(hl), tdk.tf32_trunc_ref(wl)
    d = torch.float64

    def mma(c, a, b, k):
        return _rz(c.double() + a[:, 8 * k:8 * k + 8].to(d)
                   @ b[8 * k:8 * k + 8].to(d))

    tiles = []
    for w in range(4):
        small, big, total = (torch.zeros(h.shape[0], D) for _ in range(3))
        for k in range(w, h.shape[1] // 8, 4):
            small = mma(mma(small, hl, wh, k), hh, wl, k)
            if scheme == "restart":
                total = total + mma(torch.zeros_like(total), hh, wh, k)
            else:
                big = mma(big, hh, wh, k)
        tiles.append((total if scheme == "restart" else big) + small)
    logits = ((tiles[0] + tiles[1]) + tiles[2]) + tiles[3] + b2
    ll = (x * logits - torch.nn.functional.softplus(logits)).sum(-1)
    err = (ll.double() - ll64).abs().max().item()
    assert (err <= 1e-3) == holds, err
    if holds:
        gl = x - torch.sigmoid(logits)
        assert bool(((gl - gl_r).abs() <= 1e-5 * (1 + gl_r.abs())).all())


_TRAIN_SHAPES = [dict(Z=8, H=400, D=784), dict(Z=2, H=33, D=98),
                 dict(Z=16, H=600, D=784), dict(Z=8, H=1200, D=784)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _TRAIN_SHAPES)
@pytest.mark.parametrize("batch", [1, 127, 128, 512, 1000, 1024])
def test_train_kernel_matches_plain_version_on_card(cuda_device, batch,
                                                    shape):
    """B6 against its plain version at ``_TRAIN_SHAPES``, over ragged and
    full row tiles; two calls give the same bits."""
    args = [t.to(cuda_device) for t in _torch(_train_inputs(
        B=batch, **shape))]
    before = tdk.train_decode_bce.launches
    ll, h, gl = tdk.train_decode_fwd(*args)
    ll_r, h_r, gl_r = tdk.train_decode_ref(*args)
    again = tdk.train_decode_fwd(*args)
    torch.cuda.synchronize()
    assert tdk.train_decode_bce.launches == before + 2
    assert float((ll - ll_r).abs().max()) <= 1e-3
    assert bool(((h - h_r).abs() <= 1e-5 * (1 + h_r.abs())).all())
    assert bool(((gl - gl_r).abs() <= 1e-5 * (1 + gl_r.abs())).all())
    assert all(torch.equal(a, b) for a, b in zip((ll, h, gl), again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _TRAIN_SHAPES)
def test_train_kernel_graph_replays_match_a_direct_call(cuda_device, shape):
    """Ten replays of a CUDA graph of B6 give a direct call's bits: the
    last block of each row tile sets its counter back to 0."""
    args = [t.to(cuda_device) for t in _torch(_train_inputs(
        B=1000, **shape))]
    want = tdk.train_decode_fwd(*args)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = tdk.train_decode_fwd(*args)
    for _ in range(10):
        for t in out:
            t.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert torch.equal(tdk.train_decode_fwd(*args)[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    dict(S=125, Z=8, B=512, H=400, D=784),
    dict(S=125, Z=8, B=272, H=400, D=784),
    dict(S=16, Z=8, B=77, H=400, D=784),
    dict(S=16, Z=8, B=512, H=400, D=784, big_logits=True),
    dict(S=7, Z=6, B=77, H=40, D=100),
    dict(S=5, Z=3, B=70, H=33, D=98)])
def test_kernel_matches_plain_version_on_card(cuda_device, shape):
    args = [t.to(cuda_device) for t in _torch(_inputs(**shape))]
    before = tdk.fused_decode_bce_t.launches
    out = tdk.fused_decode_bce_t(*args)
    ref = tdk.decode_bce_ref(*args)
    torch.cuda.synchronize()
    assert tdk.fused_decode_bce_t.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 1e-3
    if shape.get("big_logits"):
        zt, _, w1, b1, w2, b2 = args
        h = torch.relu(torch.matmul(zt.transpose(1, 2), w1) + b1)
        assert float((h @ w2 + b2).abs().max()) > 30.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode kernel has no CPU mode")
    return torch.device("cuda")
