"""Fused MLP decoder + Bernoulli log-likelihood: the IWAE and training paths.

Counterpart of ``mvae_tpu/kernels/decoder_kernels.py``. The IWAE half:

    ll[s, b] = sum_pixels [ x * logits - softplus(logits) ],
    logits   = relu(z W1 + b1) W2 + b2,

for importance samples zt (S, Z, B) against targets xt (D, B), batch
contiguous -- the reference entry's public layout. ``fused_decode_bce_t``
runs it with the CUDA kernel ``csrc/decode_bce.cu`` (replaces the TPU
kernel ``decoder_kernels.fused_decode_bce_t``), counted as one launch: a
first small launch writes W2 (with b1 and W1) split into TF32 pairs as the
shared-memory image of each (D tile, hidden stage) into a scratch tensor
(``decode_w_image``; its plain version ``decode_image_ref``), and the main
launch streams those stages to 128 examples a block by the copy engine,
makes h on the tensor cores and keeps the logits in registers. Both
products run on Hopper's tensor cores (warpgroup ``wgmma``) as three TF32
products (3xTF32: each float32 operand split into a TF32 pair,
``tf32_split_ref``), which keeps FP32-grade products (<= 1e-3 nats per
784-pixel row against the full-f32 plain version) where one TF32 pass
would not.

``decode_bce_ref`` is the plain PyTorch version (two full-f32 matmuls and
the stable BCE sum): the CPU path and the card check's reference.

The training half, ``train_decode_bce`` (z (B, Z), x (B, D) -> ll (B,)),
is an autograd Function whose forward runs the CUDA kernel
``csrc/train_decode.cu`` (replaces the TPU kernel
``decoder_kernels._train_decode_fwd_pallas``): it returns ll, the hidden
layer h and gl = x - sigmoid(logits) in one launch (16-row x 32-pixel
tiles, W2 fetched by the Tensor Memory Accelerator while h is computed,
h W2 as 3xTF32 on the tensor cores, the row sums folded by the last block
of a row tile: ``train_tile_plan``), so its backward is
four FP32 matrix products and two bias sums (``torch.matmul``, as the
reference leaves them to XLA). ``train_decode_ref`` is its plain version,
in full FP32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import stable
from ..utils.profiling import check_outputs
from . import _build

# The tiling of csrc/train_decode_plan.cuh: batch rows and pixels per block,
# the shared row of W2 and of a partial tile (32 + 8 words), hidden units
# per W2 stage, warps per block, the ring's stages, and its dynamic
# shared-memory ceiling (a block's, less 128 bytes for its static words
# and the dynamic region's alignment); then the per-block ceiling.
_TD_BM, _TD_BN, _TD_WS, _TD_KC, _TD_WARPS, _TD_RING = 16, 32, 40, 16, 4, 4
_TD_SMEM_LIMIT = 232320
_SMEM_LIMIT = 232448
# The tiling of csrc/decode_bce.cu: W2 column tile, hidden units per stage,
# latent dimensions per k-step of h, the ring's most slots, and the bytes of
# its barriers and counters.
_DEC_BN, _DEC_BK, _DEC_ZK, _DEC_SLOTS = 112, 32, 8, 4
_DEC_BAR_BYTES = 2 * _DEC_SLOTS * 8


def _td_hp(H: int) -> int:
    """Row stride of h in the training kernel's shared memory (``td_hp``):
    the stages' hidden units as an odd number of 16-byte words."""
    return 4 * ((-(-H // _TD_KC) * _TD_KC // 4) | 1)


def _td_smem(Z: int, H: int, slots: int) -> int:
    return 4 * (_TD_BM * _td_hp(H) + Z * _TD_BM + slots * _TD_KC * _TD_WS
                + _TD_WARPS * _TD_BM * _TD_WS)


def _td_slots(Z: int, H: int) -> int:
    """W2 stages resident: all of them when they fit, else the ring's."""
    stages = -(-H // _TD_KC)
    return stages if _td_smem(Z, H, stages) <= _TD_SMEM_LIMIT else _TD_RING


def smem_bytes(Z: int, H: int) -> int:
    """Dynamic shared memory the training decode kernel needs for latent
    width Z and hidden width H (its plan's ``smem``; the ring's when the
    whole W2 slice does not fit)."""
    return _td_smem(Z, H, _td_slots(Z, H))


def shape_supported(Z: int, H: int) -> bool:
    """Whether the training kernel has a plan for (Z, H): h for 16 rows
    and 4 W2 stages fit one block's shared memory (H up to 3,296 at
    Z = 8; every stage resident up to H = 976)."""
    return Z >= 1 and H >= 1 and smem_bytes(Z, H) <= _TD_SMEM_LIMIT


@functools.lru_cache(maxsize=64)
def train_tile_plan(B: int, Z: int, H: int, D: int) -> dict | None:
    """The launch of csrc/train_decode.cu (``td_plan`` of
    train_decode_plan.cuh): a grid of ``pixel_tiles`` x ``row_tiles``
    blocks of 16 rows x 32 pixels (one row-tile counter each), W2 in
    ``stages`` of 16 hidden units with ``slots`` of them resident: all
    when the slice fits, fetched by the Tensor Memory Accelerator when
    D % 4 == 0 (``fetch`` "tma") or by cp.async copies ("copy"), else a
    ring of 4 ("ring"); the shared memory and the floats of row partials
    (``part``). None when even the ring does not fit."""
    if B < 0 or D < 1 or not shape_supported(Z, H):
        return None
    stages, slots = -(-H // _TD_KC), _td_slots(Z, H)
    rows, cols = -(-B // _TD_BM), -(-D // _TD_BN)
    fetch = "ring" if slots < stages else "tma" if D % 4 == 0 else "copy"
    return {"row_tiles": rows, "pixel_tiles": cols, "stages": stages,
            "slots": slots, "hp": _td_hp(H), "fetch": fetch,
            "smem": _td_smem(Z, H, slots), "part": rows * cols * _TD_BM}


def _dec_stage_words(Z: int) -> int:
    """32-bit words of one stage image of decode_bce.cu (``stage_words``):
    W2's hi and lo tiles (112 columns x 32 hidden units each), the stage's
    32 b1 words, and a hi and a lo W1 tile (32 units x 8 latent
    dimensions) for every 8 latent dimensions."""
    return 2 * _DEC_BN * _DEC_BK + _DEC_BK + 2 * _DEC_BK * _DEC_ZK * (
        -(-Z // _DEC_ZK))


def _dec_slots(Z: int) -> int:
    """The IWAE decode's ring slots (``ring_slots``): as many stage images
    as fit beside the mbarriers, at most 4 (0: not one)."""
    return min(_DEC_SLOTS, (_SMEM_LIMIT - _DEC_BAR_BYTES)
               // (4 * _dec_stage_words(Z)))


def decode_smem_bytes(Z: int, H: int) -> int:
    """Dynamic shared memory the IWAE decode kernel needs: its ring of
    stage images, their full mbarriers and done counts. H only sets how
    many stages stream through the ring: 123,456 bytes at Z <= 8 for any
    H."""
    return 4 * _dec_stage_words(Z) * max(_dec_slots(Z), 1) + _DEC_BAR_BYTES


def decode_shape_supported(Z: int, H: int) -> bool:
    """Whether one stage image of the IWAE decode kernel fits a block
    (any H; Z up to 792)."""
    return Z >= 1 and H >= 1 and _dec_slots(Z) >= 1


def decode_image_bytes(Z: int, H: int, D: int) -> int:
    """Bytes of the scratch the IWAE decode writes W2's split stages into:
    a stage image for every (D tile of 112, hidden stage of 32)."""
    return 4 * _dec_stage_words(Z) * -(-H // _DEC_BK) * -(-D // _DEC_BN)


def _stage_unit() -> torch.Tensor:
    """The hidden unit at each position of a stage (``stage_unit``): each
    k-step's 8 positions hold its units 0, 2, 4, 6, 1, 3, 5, 7, so that
    the h product's accumulator is the second product's A fragment."""
    v = torch.arange(_DEC_BK) % 8
    return torch.arange(_DEC_BK) - v + torch.where(v < 4, 2 * v, 2 * v - 7)


def _core_word(n, k, k_depth: int):
    """Word of (column n, depth k) in a K-major tile of 8 x 4 core matrices
    without swizzle (``W2_AT``, ``W1_AT``): 32 words apart along k, 8
    k_depth words along n."""
    return (n // 8) * 8 * k_depth + (k // 4) * 32 + (n % 8) * 4 + k % 4


def decode_image_ref(w1, b1, w2):
    """Plain version of the IWAE decode's image launch: (stages, words)
    int32, stage dt nK + kt the bits of W2's hi and lo tiles
    (``tf32_split_ref``) at D tile dt and hidden stage kt, its hidden units
    in ``_stage_unit`` order, b1's 32 words, then each 8-wide chunk of z's
    W1 slice (hi, lo); zeros past Z, H and D."""
    Z, H = w1.shape
    D = w2.shape[1]
    nK, nD, zc = -(-H // _DEC_BK), -(-D // _DEC_BN), -(-Z // _DEC_ZK)
    f32 = dict(dtype=torch.float32, device=w2.device)
    w2p = torch.zeros(nK * _DEC_BK, nD * _DEC_BN, **f32)
    w2p[:H, :D] = w2
    w1p = torch.zeros(zc * _DEC_ZK, nK * _DEC_BK, **f32)
    w1p[:Z, :H] = w1
    b1p = torch.zeros(nK * _DEC_BK, **f32)
    b1p[:H] = b1
    img = torch.zeros(nD, nK, _dec_stage_words(Z), dtype=torch.int32,
                      device=w2.device)
    # W2: stage (dt, kt) position u, column n <- w2p[kt 32 + unit(u), dt
    # 112 + n]
    u, n = torch.meshgrid(torch.arange(_DEC_BK), torch.arange(_DEC_BN),
                          indexing="ij")
    at = _core_word(n, u, _DEC_BK).reshape(-1)
    tiles = w2p.reshape(nK, _DEC_BK, nD, _DEC_BN)[:, _stage_unit()]
    tiles = tiles.permute(2, 0, 1, 3).reshape(nD, nK, -1)
    w2w = _DEC_BN * _DEC_BK
    for off, part in zip((0, w2w), tf32_split_ref(tiles)):
        img[:, :, off + at] = part.contiguous().view(torch.int32)
    img[:, :, 2 * w2w:2 * w2w + _DEC_BK] = b1p.reshape(
        1, nK, _DEC_BK).view(torch.int32)
    # W1: chunk c, column n (unit kt 32 + n), depth q (z = c 8 + q)
    q, n = torch.meshgrid(torch.arange(_DEC_ZK), torch.arange(_DEC_BK),
                          indexing="ij")
    at = _core_word(n, q, _DEC_ZK).reshape(-1)
    w1t = w1p.reshape(zc, _DEC_ZK, nK, _DEC_BK).permute(2, 0, 1, 3)
    w1t = w1t.reshape(1, nK, zc, -1).expand(nD, nK, zc, -1)
    w1w = _DEC_BK * _DEC_ZK
    base = 2 * w2w + _DEC_BK
    for c in range(zc):
        for off, part in zip((0, w1w), tf32_split_ref(w1t[:, :, c])):
            img[:, :, base + 2 * w1w * c + off + at] = \
                part.contiguous().view(torch.int32)
    return img.reshape(nD * nK, -1)


def tf32_trunc_ref(a):
    """What the tensor core reads of a float32 operand: its top 19 bits
    (sign, exponent, 10 mantissa bits), the low 13 cleared."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_rna_ref(a):
    """float32 rounded to TF32 to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: half of the 13 dropped bits added to the
    float's bits, then cleared."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split_ref(a):
    """The (hi, lo) pair of ``csrc/tf32.cuh``: hi = a rounded to TF32, lo =
    a - hi (exact in float32; the tensor core reads ``tf32_trunc_ref(lo)``)."""
    hi = tf32_rna_ref(a)
    return hi, a - hi


def decode_bce_ref(zt, xt, w1, b1, w2, b2):
    """Plain PyTorch version: (S, Z, B), (D, B) -> (S, B) log p(x | z)."""
    if zt.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("decode_bce_ref needs full-f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    h = torch.relu(torch.matmul(zt.transpose(1, 2), w1) + b1)   # (S, B, H)
    logits = torch.matmul(h, w2) + b2                           # (S, B, D)
    t = xt.T * logits - stable.softplus(logits)
    return torch.sum(t, dim=-1)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("decode_bce")
    lib.decode_bce_launch.restype = ctypes.c_int
    lib.decode_bce_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.decode_image_launch.restype = ctypes.c_int
    lib.decode_image_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def _image_scratch(Z, H, D, device):
    return torch.empty(decode_image_bytes(Z, H, D) // 4, dtype=torch.int32,
                       device=device)


def decode_w_image(w1, b1, w2):
    """The IWAE decode's image of W2, b1 and W1 (``decode_image_ref``'s
    (stages, words) int32): on CUDA tensors the image launch of
    ``csrc/decode_bce.cu`` alone, as ``fused_decode_bce_t`` runs it before
    its main launch; on CPU tensors ``decode_image_ref``."""
    Z, H = w1.shape
    D = w2.shape[1]
    if tuple(b1.shape) != (H,) or w2.shape[0] != H:
        raise ValueError(f"for w1 {(Z, H)}: b1 must be {(H,)} and w2 "
                         f"{(H, D)}, got {tuple(b1.shape)}, "
                         f"{tuple(w2.shape)}")
    if w2.device.type == "cpu":
        return decode_image_ref(w1, b1, w2)
    if w2.device.type != "cuda":
        raise ValueError(f"unsupported device {w2.device}")
    args = [t.contiguous() for t in (w1, b1, w2)]
    if any(t.dtype != torch.float32 or t.device != w2.device for t in args):
        raise ValueError(f"all operands must be float32 on {w2.device}")
    if not decode_shape_supported(Z, H):
        raise ValueError(f"(Z={Z}, H={H}) exceeds the kernel's shared memory")
    img = _image_scratch(Z, H, D, w2.device)
    stream = torch.cuda.current_stream(w2.device).cuda_stream
    _build.check(_lib().decode_image_launch(
        *[t.data_ptr() for t in args], img.data_ptr(), Z, H, D, stream),
        "decode_image_launch")
    return img.reshape(-(-H // _DEC_BK) * -(-D // _DEC_BN), -1)


def fused_decode_bce_t(zt, xt, w1, b1, w2, b2):
    """log p(x | z) for a depth-1 ReLU MLP Bernoulli decoder.

    zt: (S, Z, B) latent draws; xt: (D, B) targets in [0, 1]; w1 (Z, H),
    b1 (H,), w2 (H, D), b2 (D,). Returns (S, B) float32. On CUDA tensors
    ``csrc/decode_bce.cu`` (its image launch into a scratch tensor, then
    the main launch: one launch on the count); on CPU tensors
    ``decode_bce_ref``."""
    S, Z, B = zt.shape
    D = xt.shape[0]
    H = w1.shape[1]
    shapes = {"xt": (xt, (D, B)), "w1": (w1, (Z, H)), "b1": (b1, (H,)),
              "w2": (w2, (H, D)), "b2": (b2, (D,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if zt.device.type == "cpu":
        return decode_bce_ref(zt, xt, w1, b1, w2, b2)
    if zt.device.type != "cuda":
        raise ValueError(f"unsupported device {zt.device}")
    args = [zt, xt, w1, b1, w2, b2]
    for t in args:
        if t.dtype != torch.float32 or t.device != zt.device:
            raise ValueError(f"all operands must be float32 on {zt.device}")
    if not decode_shape_supported(Z, H):
        raise ValueError(f"(Z={Z}, H={H}) exceeds the kernel's shared memory")
    args = [t.contiguous() for t in args]
    out = torch.empty((S, B), dtype=torch.float32, device=zt.device)
    img = _image_scratch(Z, H, D, zt.device)
    stream = torch.cuda.current_stream(zt.device).cuda_stream
    _build.check(_lib().decode_bce_launch(
        *[t.data_ptr() for t in args], out.data_ptr(), img.data_ptr(),
        S, Z, B, H, D, stream), "decode_bce_launch")
    fused_decode_bce_t.launches += 1
    check_outputs("decode_bce", out)
    return out


fused_decode_bce_t.launches = 0


# --- the training path ----------------------------------------------------------


def train_decode_ref(z, x, w1, b1, w2, b2):
    """Plain PyTorch version, full FP32: z (B, Z), x (B, D) -> (ll (B,),
    h (B, H), gl = x - sigmoid(logits) (B, D))."""
    if z.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("train_decode_ref needs full-f32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    h = torch.relu(torch.matmul(z, w1) + b1)
    logits = torch.matmul(h, w2) + b2
    ll = torch.sum(x * logits - stable.softplus(logits), dim=-1)
    return ll, h, x - torch.sigmoid(logits)


@functools.lru_cache(maxsize=None)
def _lib_train():
    fn = _build.load("train_decode").train_decode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return fn


_COUNTERS: dict = {}


def _row_tile_counters(device, n: int):
    """The kernel's row-tile counters on ``device``: zeroed once, cached,
    and left at zero by every launch (the last block of a row tile resets
    its own), so calls and CUDA-graph replays reuse them. Grown outside a
    graph capture only."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("train_decode_fwd: call it once at this batch "
                               "size before capturing a CUDA graph")
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned start (the kernel's float4,
    cp.async and tensor-map accesses), copied only when it is not."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    t = t.detach().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def train_decode_fwd(z, x, w1, b1, w2, b2):
    """(ll, h, gl) of the training decode: on CUDA tensors one launch of
    ``csrc/train_decode.cu``, counted on ``train_decode_bce.launches``; on
    CPU tensors ``train_decode_ref``."""
    B, Z = z.shape
    D = x.shape[1]
    H = w1.shape[1]
    if (x.shape != (B, D) or w1.shape != (Z, H) or b1.shape != (H,)
            or w2.shape != (H, D) or b2.shape != (D,)):
        raise ValueError(
            f"for z {tuple(z.shape)}: x must be {(B, D)}, w1 {(Z, H)}, b1 "
            f"{(H,)}, w2 {(H, D)}, b2 {(D,)}; got {tuple(x.shape)}, "
            f"{tuple(w1.shape)}, {tuple(b1.shape)}, {tuple(w2.shape)}, "
            f"{tuple(b2.shape)}")
    if z.device.type == "cpu":
        return train_decode_ref(z, x, w1, b1, w2, b2)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    args = [z, x, w1, b1, w2, b2]
    for t in args:
        if t.dtype != torch.float32 or t.device != z.device:
            raise ValueError(f"all operands must be float32 on {z.device}")
    plan = train_tile_plan(B, Z, H, D)
    if plan is None:
        raise ValueError(f"(Z={Z}, H={H}, D={D}) has no plan within the "
                         f"kernel's shared memory")
    args = [_aligned(t) for t in args]
    dev = z.device
    ll = torch.empty((B,), dtype=torch.float32, device=dev)
    h = torch.empty((B, H), dtype=torch.float32, device=dev)
    gl = torch.empty((B, D), dtype=torch.float32, device=dev)
    part = torch.empty((plan["part"],), dtype=torch.float32, device=dev)
    counters = _row_tile_counters(dev, plan["row_tiles"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_lib_train()(*[t.data_ptr() for t in args], ll.data_ptr(),
                              h.data_ptr(), gl.data_ptr(), part.data_ptr(),
                              counters.data_ptr(), B, Z, H, D, stream),
                 "train_decode_launch")
    train_decode_bce.launches += 1
    check_outputs("train_decode", ll, h, gl)
    return ll, h, gl


class _TrainDecodeFn(torch.autograd.Function):
    """log p(x | z) with the saved (h, gl): the backward is the four
    products and two bias sums of the reference's
    ``_train_decode_vjp_bwd``, in FP32. The targets x get no gradient."""

    @staticmethod
    def forward(ctx, z, x, w1, b1, w2, b2):
        ll, h, gl = train_decode_fwd(z, x, w1, b1, w2, b2)
        ctx.save_for_backward(z, h, gl, w1, w2)
        return ll

    @staticmethod
    def backward(ctx, dll):
        # the cotangent scales gl once: dl = dll gl; the ReLU's mask is one
        # threshold_backward (eight device ops in all, a host-bound step's
        # cost)
        z, h, gl, w1, w2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dl = gl * dll[:, None]
        db2 = torch.sum(dl, dim=0) if need[5] else None
        dw2 = torch.matmul(h.T, dl) if need[4] else None
        dh = torch.ops.aten.threshold_backward(torch.matmul(dl, w2.T), h, 0.0)
        db1 = torch.sum(dh, dim=0) if need[3] else None
        dw1 = torch.matmul(z.T, dh) if need[2] else None
        dz = torch.matmul(dh, w1.T) if need[0] else None
        return dz, None, dw1, db1, dw2, db2


def train_decode_bce(z, x, w1, b1, w2, b2):
    """Per-example log p(x | z) of the training forward for a depth-1 ReLU
    MLP Bernoulli decoder: z (B, Z), x (B, D) -> (B,), differentiable in z
    and the weights (``_TrainDecodeFn``)."""
    return _TrainDecodeFn.apply(z, x, w1, b1, w2, b2)


train_decode_bce.launches = 0
