"""The decode+Bernoulli kernels' plain versions against the JAX package,
the wrappers' CPU dispatch and checks, and the CUDA kernels against their
plain versions on the card.

IWAE path: ``decode_bce_ref`` against the JAX kernel ``fused_decode_bce_t``
run in interpret mode and against a jnp float64 oracle. Tolerances: 2e-3
nats per row against the JAX kernel (its contract: the bf16 x 3 split
drops the lo*lo term, ~1e-3 nats on a few-hundred-nat row); 1e-9 against
the float64 oracle (the same float64 arithmetic, summed in another order);
1e-3 nats per row between the CUDA kernel (3xTF32 on the tensor cores)
and the full-f32 matmuls of its plain version, at both IWAE cells'
chunks (Z = 8 and 6), at ragged batches (77; 272, the 10,000-example test
split's last batch at 512; 1), at one sample, at H = 640, at Z = 12 (two
8-wide chunks of z) and 400 (a ring of one slot), at ragged H and D, and
with logits past |30| in every
row, where softplus must stay stable; two calls and ten CUDA-graph
replays bit for bit; its image launch bit for bit against
``decode_image_ref``. On the CPU, the image (W2, b1 and W1 split into the
stage tiles the main launch streams, their hidden units permuted so that
the h product's accumulator is the second product's A fragment), read
through the kernel's descriptors and fragment layouts, gives h W2.

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
32-deep stage added with a rounded add) holds it, with h from FP32 FMAs
and with h made as the kernel makes it (3xTF32 into one accumulator).

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
    exceeds the 227 KB per block does not. The IWAE decode (B2) keeps a
    ring of 4 stage images (W2's hi and lo tiles of 112 columns x 32
    hidden units, the stage's 32 b1 words, and a hi and a lo W1 tile of
    32 units x 8 latent dimensions for every 8 of Z) and its 8 mbarriers:
    H only sets how many stages stream through, and Z how large a stage
    is; the training decode (B6) its own tile."""
    if kernel == "decode":
        assert tdk.decode_shape_supported(8, 400)
        assert tdk.decode_smem_bytes(8, 400) == 4 * 4 * (
            2 * 112 * 32 + 32 + 2 * 32 * 8) + 8 * 8 == 123_456
        assert tdk.decode_smem_bytes(8, 384) == tdk.decode_smem_bytes(8, 361)
        assert tdk.decode_smem_bytes(8, 640) == tdk.decode_smem_bytes(8, 1)
        assert tdk.decode_smem_bytes(6, 400) == tdk.decode_smem_bytes(8, 400)
        assert tdk.decode_shape_supported(8, 640)
        # what the previous design took (H rounded to 32, + Z, <= 674) it
        # still takes, and H no longer bounds it
        assert all(tdk.decode_shape_supported(z, h) for z in (1, 8, 9, 12,
                   64, 258, 642) for h in (1, 33, 400, 640 - z + 1)
                   if h >= 1 and -(-h // 32) * 32 + z <= 674)
        assert tdk.decode_shape_supported(8, 641)
        assert tdk.decode_shape_supported(8, 4096)
        # past 14 chunks of z (Z = 112) 4 slots no longer fit: 3; past 99
        # chunks not one
        assert tdk.decode_smem_bytes(112, 400) == 4 * 4 * (
            2 * 112 * 32 + 32 + 2 * 32 * 8 * 14) + 64
        assert tdk.decode_smem_bytes(113, 400) == 4 * 3 * (
            2 * 112 * 32 + 32 + 2 * 32 * 8 * 15) + 64
        assert tdk.decode_shape_supported(792, 400)
        assert not tdk.decode_shape_supported(793, 400)
        assert tdk.decode_image_bytes(8, 400, 784) == 7 * 13 * 30_848
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
    """The IWAE route takes B2's gate: a latent of 800 dimensions, whose
    stage image does not fit a block, goes to the plain decode; the
    flagship at any hidden width, and 792 dimensions, go to B2."""
    from mvae_torch.components import parse_components
    from mvae_torch.models import route, vae

    def iwae_decoder(spec, h_dim):
        cfg = vae.VAEConfig(parse_components(spec), (784,), h_dim=h_dim)
        return route.route(cfg, vae.init_params(cfg, device="meta")
                           ).iwae_decoder

    assert not iwae_decoder("e800", 400)
    assert iwae_decoder("e792", 400)
    assert iwae_decoder("h2,s2,e2", 400)
    assert iwae_decoder("h2,s2,e2", 700)


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


def _h_rows_tensor(zt, w1, b1):
    """h as B2 makes it on the tensor cores: z's and W1's TF32 pairs; at Z
    <= 8 the three products added into one accumulator from zero with
    truncation; past that, each 8-wide k-step's large product from zero
    added into a float32 sum, rounded, and the small ones in an
    accumulator of their own; then + b1 and ReLU in float32."""
    Z = w1.shape[0]
    z = zt.transpose(1, 2).reshape(-1, Z)
    (zh, zl), (wh, wl) = tdk.tf32_split_ref(z), tdk.tf32_split_ref(w1)
    zl, wl = tdk.tf32_trunc_ref(zl), tdk.tf32_trunc_ref(wl)
    zeros = torch.zeros(z.shape[0], w1.shape[1])

    def mma(c, a, b, k0):
        return _rz(c.double() + a[:, k0:k0 + 8].double()
                   @ b[k0:k0 + 8].double())

    if Z <= 8:
        acc = zeros
        for a, b in ((zh, wh), (zl, wh), (zh, wl)):
            acc = mma(acc, a, b, 0)
        return torch.relu(acc + b1)
    acc, small = zeros, zeros
    for k0 in range(0, Z, 8):
        acc = acc + mma(zeros, zh, wh, k0)
        small = mma(mma(small, zl, wh, k0), zh, wl, k0)
    return torch.relu((acc + small) + b1)


@pytest.mark.parametrize("scheme,holds", [("single", False),
                                          ("kernel", True),
                                          ("kernel, h on the tensor cores",
                                           True)])
def test_accumulation_scheme_under_truncating_adds(scheme, holds):
    """Each wgmma adds its k-step's products into the float32
    accumulator with truncation (modelled: the exact sum, rounded toward
    zero). Over the 150 mma of a logit that bias misses the 1e-3-nat gate
    in one accumulator; the kernel's scheme holds it, with h made by FP32
    FMAs and as B2 makes it (``_h_rows_tensor``)."""
    zt, xt, w1, b1, w2, b2 = _full_inputs()
    S, H = zt.shape[0], w1.shape[1]
    oracle = tdk.decode_bce_ref(*[a.double() for a in (zt, xt, w1, b1, w2,
                                                       b2)]).reshape(-1)
    hp = -(-H // 32) * 32
    pad = hp - H
    rows = _h_rows_tensor if "tensor" in scheme else _h_rows
    h = torch.nn.functional.pad(rows(zt, w1, b1), (0, pad))
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


def _descriptor_tile(img, start, sbo_bytes, rows, depth):
    """What wgmma reads as a K-major B operand through the kernel's
    descriptor (no swizzle, 128 bytes between core matrices along k,
    ``sbo_bytes`` along n) at word ``start`` of a stage image: (n, k) ->
    the word's float."""
    n = np.arange(rows)[:, None]
    k = np.arange(depth)[None, :]
    at = (start + (n // 8) * (sbo_bytes // 4) + (k // 4) * 32 + (n % 8) * 4
          + k % 4)
    return img.view(np.float32)[at].astype(np.float64)


def _emulate_from_image(zt, w1, b1, w2, img):
    """The IWAE decode's logits as the kernel forms them from its image,
    in exact float64 products: each stage's h block from z's TF32 pair and
    the W1 tiles (m64n32k8, descriptors at the kernel's offsets), + b1,
    ReLU; each thread's accumulator registers 4j + e (row g + 8 (e >> 1),
    column 8j + 2t + (e & 1)) taken as the A fragment (a0..a3 = registers
    e = 0, 2, 1, 3 at rows g, g + 8, g, g + 8 and k positions t, t, t + 4,
    t + 4); then the split products with the W2 tiles. Rows (S B,
    flattened), D tiles of 112 and 32-unit stages as the kernel walks
    them."""
    S, Z, B = zt.shape
    H, D = w2.shape
    nK, nD, zc = -(-H // 32), -(-D // 112), -(-Z // 8)
    R = S * B
    zr = zt.transpose(0, 2, 1).reshape(R, Z).astype(np.float32)
    zp = np.zeros((R, 8 * zc), np.float32)
    zp[:, :Z] = zr
    zh, zl = (t.numpy().astype(np.float64) for t in tdk.tf32_split_ref(
        torch.from_numpy(zp)))
    # thread (warp w, g, t)'s registers -> (row, k position) of A
    w_, g_, t_ = np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                             indexing="ij")
    logits = np.zeros((R, nD * 112))
    for dt in range(nD):
        for kt in range(nK):
            st = img[dt * nK + kt]
            hblk = np.zeros((R, 32))
            for c in range(zc):
                base = 2 * 112 * 32 + 32 + 2 * 256 * c
                wh = _descriptor_tile(st, base, 256, 32, 8)
                wl = _descriptor_tile(st, base + 256, 256, 32, 8)
                zc_h, zc_l = zh[:, 8 * c:8 * c + 8], zl[:, 8 * c:8 * c + 8]
                hblk += zc_h @ wh.T + zc_l @ wh.T + zc_h @ wl.T
            bias = st[2 * 112 * 32:2 * 112 * 32 + 32].view(np.float32)
            hblk = np.maximum(hblk + bias, 0.0)
            a = np.zeros((R, 32))
            for j in range(4):
                for e in range(4):
                    f = (e >> 1) | ((e & 1) << 1)
                    # register 4j + e: h at this row and column
                    row = 16 * w_ + g_ + 8 * (e >> 1)
                    col = 8 * j + 2 * t_ + (e & 1)
                    # fragment register f: A's row and k position
                    arow = 16 * w_ + g_ + 8 * (f & 1)
                    apos = 8 * j + t_ + 4 * (f >> 1)
                    assert np.array_equal(row, arow)
                    for r0 in range(0, R, 64):
                        a[r0 + arow, apos] = hblk[r0 + row, col]
            ah, al = (t.numpy().astype(np.float64) for t in tdk.tf32_split_ref(
                torch.from_numpy(a.astype(np.float32))))
            for j in range(4):
                bh = _descriptor_tile(st, 64 * j, 1024, 112, 8)
                bl = _descriptor_tile(st, 112 * 32 + 64 * j, 1024, 112, 8)
                sl = slice(8 * j, 8 * j + 8)
                logits[:, 112 * dt:112 * dt + 112] += (
                    al[:, sl] @ bh.T + ah[:, sl] @ bl.T + ah[:, sl] @ bh.T)
    return logits[:, :D]


@pytest.mark.parametrize("Z,H,D", [(6, 40, 130), (12, 33, 98), (8, 64, 112)])
def test_decode_image_feeds_the_kernels_fragments(Z, H, D):
    """The image's permuted hidden units, its tiles read through the
    kernel's descriptors and the h accumulator taken as the A fragment
    give h W2: the emulated logits (exact float64 products of the TF32
    pairs) within 2e-5 of the float64 ones (the pairs keep ~22 bits)."""
    zt, _, w1, b1, w2, _ = _inputs(S=2, Z=Z, B=64, H=H, D=D, seed=Z)
    img = tdk.decode_image_ref(*_torch([w1, b1, w2])).numpy()
    assert img.shape == (-(-H // 32) * -(-D // 112),
                         tdk.decode_image_bytes(Z, H, D) // 4
                         // (-(-H // 32) * -(-D // 112)))
    got = _emulate_from_image(zt, w1, b1, w2, img)
    h = np.maximum(zt.transpose(0, 2, 1).reshape(-1, Z).astype(np.float64)
                   @ w1 + b1, 0.0)
    want = h @ w2.astype(np.float64)
    assert np.abs(got - want).max() <= 2e-5 * (1 + np.abs(want).max())


def test_decode_image_ref_places_the_split_words():
    """The image's words, one at a time: W2's hi and lo bits of hidden unit
    kt 32 + unit(u), column dt 112 + n at core word (n // 8) 256 + (u //
    4) 32 + (n % 8) 4 + u % 4; b1; W1's bits at (n // 8) 64 + (q // 4) 32
    + (n % 8) 4 + q % 4 of each chunk; zeros past Z, H and D. The wrapper
    on CPU tensors is this plain version, and checks the shapes."""
    Z, H, D = 10, 40, 120
    _, _, w1, b1, w2, _ = _inputs(S=1, Z=Z, B=8, H=H, D=D, seed=5)
    w1, b1, w2 = _torch([w1, b1, w2])
    img = tdk.decode_image_ref(w1, b1, w2)
    assert torch.equal(tdk.decode_w_image(w1, b1, w2), img)
    with pytest.raises(ValueError):
        tdk.decode_w_image(w1, b1[:-1], w2)
    nK = 2
    bits = lambda x: int(np.float32(x).view(np.int32))  # noqa: E731
    hi, lo = tdk.tf32_split_ref(w2)
    unit = [0, 2, 4, 6, 1, 3, 5, 7]
    for dt, kt, u, n in [(0, 0, 0, 0), (0, 0, 5, 9), (1, 1, 31, 111),
                         (1, 0, 13, 7), (0, 1, 7, 100)]:
        k = 32 * kt + 8 * (u // 8) + unit[u % 8]
        d = 112 * dt + n
        word = (n // 8) * 256 + (u // 4) * 32 + (n % 8) * 4 + u % 4
        st = img[dt * nK + kt]
        want = (bits(hi[k, d]), bits(lo[k, d])) if k < H and d < D else (0, 0)
        assert (int(st[word]), int(st[112 * 32 + word])) == want
    st = img[1 * nK + 1]
    assert [int(v) for v in st[2 * 112 * 32:2 * 112 * 32 + 8]] == [
        bits(b1[32 + i]) for i in range(8)]
    assert not st[2 * 112 * 32 + 8:2 * 112 * 32 + 32].any()
    w1h, w1l = tdk.tf32_split_ref(w1)
    for kt, c, q, n in [(0, 0, 0, 0), (0, 1, 1, 31), (1, 0, 7, 3),
                        (1, 1, 6, 5)]:
        z, k = 8 * c + q, 32 * kt + n
        word = 2 * 112 * 32 + 32 + 512 * c + (n // 8) * 64 + (q // 4) * 32 \
            + (n % 8) * 4 + q % 4
        st = img[kt]
        want = ((bits(w1h[z, k]), bits(w1l[z, k])) if z < Z and k < H
                else (0, 0))
        assert (int(st[word]), int(st[word + 256])) == want


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


_DECODE_SHAPES = [
    dict(S=125, Z=8, B=512, H=400, D=784),
    dict(S=125, Z=6, B=512, H=400, D=784),
    dict(S=125, Z=8, B=272, H=400, D=784),
    dict(S=16, Z=8, B=77, H=400, D=784),
    dict(S=125, Z=8, B=1, H=400, D=784),
    dict(S=1, Z=8, B=512, H=400, D=784),
    dict(S=16, Z=8, B=512, H=640, D=784),
    dict(S=16, Z=12, B=512, H=400, D=784),
    dict(S=16, Z=8, B=512, H=400, D=784, big_logits=True),
    dict(S=7, Z=6, B=77, H=40, D=100),
    dict(S=5, Z=3, B=70, H=33, D=98),
    dict(S=3, Z=12, B=77, H=33, D=98),
    dict(S=2, Z=400, B=70, H=40, D=100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _DECODE_SHAPES)
def test_kernel_matches_plain_version_on_card(cuda_device, shape):
    """B2 against its plain version within 1e-3 nats a row: both IWAE
    cells' chunks, ragged batches (272, the test split's last at 512; 77;
    1), one sample, the widest H of the previous design, two z chunks,
    ragged H and D (D % 4 != 0), logits past |30|, a z of 400 dimensions
    (a stage of 131 KB: a ring of one slot); a second call gives the same
    bits, and the wrapper counts one launch a call."""
    args = [t.to(cuda_device) for t in _torch(_inputs(**shape))]
    before = tdk.fused_decode_bce_t.launches
    out = tdk.fused_decode_bce_t(*args)
    ref = tdk.decode_bce_ref(*args)
    again = tdk.fused_decode_bce_t(*args)
    torch.cuda.synchronize()
    assert tdk.fused_decode_bce_t.launches == before + 2
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 1e-3
    assert torch.equal(out, again)
    if shape.get("big_logits"):
        zt, _, w1, b1, w2, b2 = args
        h = torch.relu(torch.matmul(zt.transpose(1, 2), w1) + b1)
        assert float((h @ w2 + b2).abs().max()) > 30.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [dict(S=125, Z=8, B=512, H=400, D=784),
                                   dict(S=5, Z=12, B=77, H=33, D=98)])
def test_kernel_graph_replays_match_a_direct_call(cuda_device, shape):
    """Ten replays of a CUDA graph of B2 (its image launch into a scratch
    of the graph's pool, then the main launch) give a direct call's
    bits."""
    args = [t.to(cuda_device) for t in _torch(_inputs(**shape))]
    want = tdk.fused_decode_bce_t(*args)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = tdk.fused_decode_bce_t(*args)
    for _ in range(10):
        out.fill_(float("nan"))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("Z,H,D", [(8, 400, 784), (12, 33, 98), (6, 40, 100)])
def test_image_launch_matches_its_plain_version_on_card(cuda_device, Z, H,
                                                        D):
    """B2's image launch writes ``decode_image_ref``'s words bit for bit:
    ``tf32_split_ref`` of W2 and W1 at the image places, b1, zeros."""
    _, _, w1, b1, w2, _ = _inputs(S=1, Z=Z, B=8, H=H, D=D, seed=H)
    args = _torch([w1, b1, w2])
    got = tdk.decode_w_image(*[t.to(cuda_device) for t in args])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tdk.decode_image_ref(*args))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode kernel has no CPU mode")
    return torch.device("cuda")
