"""Plain PyTorch reference of the convolutional VAE of the CIFAR-10
experiments of Skopek et al., "Mixed-curvature Variational Autoencoders"
(arXiv:1911.08411), with the universal-curvature factor ``u``.

Images ``(B, H, W, C)`` (NHWC, intensities in [0, 1], not binarized):

* encoder: conv 4x4 / 2 to 64 channels, ReLU, conv 4x4 / 2 to 128, ReLU,
  flattened in (H, W, C) order, fc to ``h_dim``, ReLU;
* one linear head per latent factor (tangent mean and softplus scale) and
  the factor's draw, log q, log p and KL term;
* decoder: fc ``Z -> h_dim``, ReLU, fc to ``(H/4) (W/4) 128``, ReLU,
  transposed conv 4x4 / 2 to 64, ReLU, transposed conv 4x4 / 2 to C logits;
* the Bernoulli log-likelihood of the intensities, ``x l - softplus(l)``
  summed over the pixels and channels.

The widths (64 and 128 channels, ``h_dim`` 400) are the ones the port and
its JAX package state, whose conv nets are marked unverified there: no
section of the paper or line of its public code was checked for them.

Layouts are the program's: conv weights HWIO, data NHWC, XLA's SAME padding
(the odd pixel at the end), the fc weights' rows in (H, W, C) order. A
transposed conv is ``lax.conv_transpose`` (SAME, no kernel flip): a
cross-correlation of the stride-dilated input, padded by 2 on each side,
with the HWIO kernel as it is. torch's ``conv_transpose2d`` is the adjoint
of ``conv2d``, which correlates the dilated input with the kernel flipped
in space, so it is called here with the kernel flipped and as (in, out,
kh, kw), and padding 1. The published PyTorch model's ``ConvTranspose2d``
weight ``W[i, o, a, b]`` is this model's ``w[3 - a, 3 - b, i, o]``: a fixed
re-indexing of the same weights, the same function.

The factor ``u``: a wrapped normal on the kappa-stereographic model whose
curvature is the free parameter itself, ``K = c`` (it may cross zero),
``z = mu (+)_K exp_0(sigma eps)`` with ``mu = exp_0(mu_tan)``, the scale
a softplus, capped at the injectivity radius pi / sqrt(K) where K > 0; log q
from the drawn radius, summed over the wrap images where K > 0 (``wraps +
3`` pairs of periods, as the program cuts them), the prior WrappedNormal(0,
1) summed over ``wraps`` pairs; the ELBO's KL term ``log q - log p``. The
ratios of K and a squared radius, ``u = K r^2`` (tan, atan and log sin of
sqrt(u) over sqrt(u), their hyperbolic forms for u < 0), are closed forms
outside ``|u| < SERIES_CUT`` and their Taylor series in u inside it, so K =
0 and K near 0 take one analytic expression with its gradient in c, as the
program's series do; which side of zero K lies on decides, as a Python
branch, whether the cap and the wrap images apply (both vanish as K -> 0+).
The other factors (e, h, s, d, p) are ``vae.py``'s, unchanged.

Every function computes in the dtype of its inputs with plain closed forms
(float64 is the reference); nothing here calls a kernel of the program.
``tf32_matmuls()`` computes the block's matrix products and convolutions
in TF32 (the card's two TF32 switches; on the CPU, each operand rounded to
TF32's 10-bit mantissa): the control of the benchmark's comparison.
``init`` and ``work`` give the weights' scales and the work counted from
shapes (``reference``'s contract).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F


def _load_vae():
    """``vae.py`` beside this file, under a name of its own (the harness
    loads reference modules by path, not as a package)."""
    name = f"{__name__}_vae"
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).with_name("vae.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


vae = _load_vae()

U_MIN = vae.U_MIN
CHANNELS = (64, 128)
KERNEL, STRIDE = 4, 2
# |K r^2| below which the universal factor's ratios are their series
SERIES_CUT = 1e-4


@dataclasses.dataclass(frozen=True)
class Latent(vae.Latent):
    """``vae.Latent`` with the universal kind, whose sign is free (0)."""

    @property
    def sign(self) -> int:
        return 0 if self.kind == "u" else vae.SIGN[self.kind]


def parse_spec(spec: str) -> tuple[Latent, ...]:
    """``"u6"`` -> the factors: ``u`` (wrapped normal) and ``vae.py``'s
    e, h, s (vMF at dim 2), d, p with their default posteriors."""
    out = []
    for part in spec.split(","):
        kind, dim = part.strip()[0], int(part.strip()[1:])
        post = "wrapped" if kind == "u" else vae.DEFAULT_POSTERIOR[kind]
        if post == "vmf" and dim != 2:
            raise ValueError("the reference's vMF is the m = 3 sphere")
        out.append(Latent(kind, dim, post))
    return tuple(out)


# --- TF32, the control's precision -------------------------------------------


@contextlib.contextmanager
def tf32_matmuls():
    """Matrix products and convolutions of the block in TF32: the card's
    matmul and cuDNN switches, and on the CPU each operand rounded to TF32
    (``vae.tf32_matmuls`` for the products, ``_ConvTF32`` here)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with vae.tf32_matmuls():
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


class _ConvTF32(torch.autograd.Function):
    """``fn(x, w)`` with its operands rounded to TF32, the backward's
    products too (the CPU's stand-in for cuDNN's TF32 switch)."""

    @staticmethod
    def forward(ctx, fn, x, w):
        ctx.fn = fn
        ctx.save_for_backward(x, w)
        return fn(vae.round_tf32(x), vae.round_tf32(w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xr = vae.round_tf32(x.detach()).requires_grad_()
            wr = vae.round_tf32(w.detach()).requires_grad_()
            out = ctx.fn(xr, wr)
        gx, gw = torch.autograd.grad(out, (xr, wr), vae.round_tf32(g))
        return None, gx, gw


def _apply(fn, x, w):
    if vae._TF32[0] and not x.is_cuda and x.dtype == torch.float32:
        return _ConvTF32.apply(fn, x, w)
    return fn(x, w)


# --- the conv nets -----------------------------------------------------------


def same_pads(size: int) -> tuple[int, int]:
    """XLA's SAME padding (lo, hi) of one axis for the 4x4 stride-2 conv:
    the total split with the odd pixel at the end."""
    out = -(-size // STRIDE)
    total = max((out - 1) * STRIDE + KERNEL - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b):
    """NHWC 4x4 stride-2 SAME conv with an HWIO kernel: (N, H, W, Cin) ->
    (N, ceil(H/2), ceil(W/2), Cout)."""
    (plo, phi), (qlo, qhi) = same_pads(x.shape[1]), same_pads(x.shape[2])
    xc = F.pad(x.permute(0, 3, 1, 2), (qlo, qhi, plo, phi))
    out = _apply(functools.partial(F.conv2d, stride=STRIDE), xc,
                 w.permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1) + b


def conv_transpose(x, w, b):
    """``lax.conv_transpose`` (SAME, HWIO, no kernel flip): (N, H, W, Cin)
    -> (N, 2H, 2W, Cout), as torch's adjoint form of the flipped kernel."""
    out = _apply(functools.partial(F.conv_transpose2d, stride=STRIDE,
                                   padding=1),
                 x.permute(0, 3, 1, 2), w.flip(0, 1).permute(2, 3, 0, 1))
    return out.permute(0, 2, 3, 1) + b


def features(p, x):
    """x (B, H, W, C) -> the flattened conv features (B, (H/4)(W/4) 128)."""
    h = torch.relu(conv(x, p["encoder.conv1.w"], p["encoder.conv1.b"]))
    h = torch.relu(conv(h, p["encoder.conv2.w"], p["encoder.conv2.b"]))
    return h.reshape(len(h), -1)


def encode(p, x):
    """x (B, H, W, C) -> the encoder's features (B, h_dim)."""
    return torch.relu(vae.mm(features(p, x), p["encoder.fc.w"])
                      + p["encoder.fc.b"])


def logits(p, z):
    """z (..., Z) -> the decoder's logits (..., H, W, C)."""
    lead = z.shape[:-1]
    h = z.reshape(-1, z.shape[-1])
    h = torch.relu(vae.mm(h, p["decoder.fc1.w"]) + p["decoder.fc1.b"])
    h = torch.relu(vae.mm(h, p["decoder.fc2.w"]) + p["decoder.fc2.b"])
    c = p["decoder.deconv1.w"].shape[2]
    s = math.isqrt(h.shape[-1] // c)
    h = h.reshape(-1, s, s, c)
    h = torch.relu(conv_transpose(h, p["decoder.deconv1.w"],
                                  p["decoder.deconv1.b"]))
    out = conv_transpose(h, p["decoder.deconv2.w"], p["decoder.deconv2.b"])
    return out.reshape(lead + out.shape[1:])


def log_px(p, z, x):
    """Bernoulli log-likelihood of the intensities x (B, H, W, C) under the
    decoder's logits at z (..., B, Z): (..., B)."""
    lg = logits(p, z)
    return torch.sum(x * lg - vae.softplus(lg), dim=(-3, -2, -1))


# --- the universal factor ----------------------------------------------------


def _window(u):
    """(|u| < SERIES_CUT, u there else 0, sqrt(u) where u > 0, sqrt(-u)
    where u < 0): each branch's input kept finite where it is not taken."""
    small = torch.abs(u) < SERIES_CUT
    cut = torch.full_like(u, SERIES_CUT)
    return (small, torch.where(small, u, torch.zeros_like(u)),
            torch.sqrt(torch.where(u >= SERIES_CUT, u, cut)),
            torch.sqrt(torch.where(u <= -SERIES_CUT, -u, cut)))


def tandiv(u):
    """tan(sqrt u) / sqrt u; tanh(sqrt -u) / sqrt -u for u < 0."""
    small, us, sp, sn = _window(u)
    series = 1.0 + us * (1.0 / 3 + us * (2.0 / 15 + us * (
        17.0 / 315 + us * 62.0 / 2835)))
    closed = torch.where(u > 0, torch.tan(sp) / sp, torch.tanh(sn) / sn)
    return torch.where(small, series, closed)


def arctandiv(u):
    """atan(sqrt u) / sqrt u; atanh(sqrt -u) / sqrt -u for u < 0."""
    small, us, sp, sn = _window(u)
    series = 1.0 + us * (-1.0 / 3 + us * (1.0 / 5 + us * (
        -1.0 / 7 + us / 9.0)))
    closed = torch.where(u > 0, torch.atan(sp) / sp, torch.atanh(sn) / sn)
    return torch.where(small, series, closed)


def log_sindiv(u):
    """log(|sin sqrt u|_soft / sqrt u), the soft floor tapered on sqrt u
    itself (``vae.log_sinc_soft``); log(sinh sqrt -u / sqrt -u) for u <
    0."""
    small, us, sp, sn = _window(u)
    series = -us * (1.0 / 6 + us * (1.0 / 180 + us * (
        1.0 / 2835 + us / 37800.0)))
    closed = torch.where(u > 0, vae.log_abs_sin_soft(sp, sp) - torch.log(sp),
                         vae.log_sinhc(sn))
    return torch.where(small, series, closed)


def _logq_universal(n, K, vsq, s2, ls, wraps):
    """log q of z = mu (+)_K exp_0(v) from the drawn tangent v (|v|^2 =
    vsq, |eps|^2 = s2, ls the scales' log-sum): where K > 0 summed over
    the preimages r + m T on the drawn geodesic."""
    half = 0.5 * n * vae.LOG_2PI
    if not K > 0:
        return -0.5 * s2 - ls - half - (n - 1) * log_sindiv(K * vsq)
    sk = torch.sqrt(K)
    T = 2.0 * math.pi / sk
    r = torch.sqrt(vsq)
    rp = torch.abs(r - T * torch.floor(r / T + 0.5))
    quad = s2 / vsq
    terms = []
    for m in range(-(wraps + 3), wraps + 4):
        rb = rp + m * T
        if m == 0:
            logdet = (n - 1) * log_sindiv(K * rp * rp)
        else:
            xb = sk * torch.abs(rb)
            logdet = (n - 1) * (vae.log_abs_sin_soft(sk * rp, xb)
                                - torch.log(xb))
        terms.append(-0.5 * rb * rb * quad - ls - half - logdet)
    return vae.logsumexp_list(terms)


def _logp_universal(n, K, r0, wraps):
    """log of the prior WrappedNormal(0, 1) at a point of radius r0: where
    K > 0 with ``wraps`` pairs of wrap images."""
    half = 0.5 * n * vae.LOG_2PI
    main = -0.5 * r0 * r0 - half - (n - 1) * log_sindiv(K * r0 * r0)
    if not K > 0 or wraps == 0:
        return main
    sk = torch.sqrt(K)
    T = 2.0 * math.pi / sk
    terms = [main]
    for s in (1.0, -1.0):
        rb = r0 + s * T
        lsk = vae.log_abs_sin_soft(sk * r0, sk * torch.abs(rb)) - torch.log(sk)
        terms.append(-0.5 * rb * rb - half
                     - (n - 1) * (lsk - torch.log(torch.abs(rb))))
    return vae.logsumexp_list(terms)


def _universal(lat, raw, eps, c, wraps: int = 1):
    """Wrapped normal on the kappa-stereographic model with K = c: z (...,
    B, n), log q, log p and the KL term log q - log p (..., B)."""
    n, K = lat.dim, c
    sign = 1 if K > 0 else -1 if K < 0 else 0
    mu_tan, sig = raw[..., :n], vae.softplus(raw[..., n:])
    if sign > 0:
        cap = math.pi / torch.sqrt(K)
        t = torch.clamp(sig / cap, max=8.0)
        sig = cap * t * (1.0 + t ** 6) ** (-1.0 / 6.0)
    mu = 0.5 * tandiv(K * torch.sum(mu_tan * mu_tan, -1, keepdim=True)
                      / 4.0) * mu_tan
    mu = vae._ball(mu, K, sign)
    v = sig * eps
    vsq = torch.sum(v * v, -1, keepdim=True)
    ex = vae._ball(0.5 * tandiv(K * vsq / 4.0) * v, K, sign)
    z = vae._ball(vae._mobius_add(mu, ex, K), K, sign)
    s2 = torch.sum(eps * eps, dim=-1)
    ls = torch.sum(torch.log(sig), dim=-1)
    lq = _logq_universal(n, K, vsq.squeeze(-1) + vae.tiny(raw.dtype), s2, ls,
                         wraps)
    zsq = torch.sum(z * z, dim=-1)
    r0 = 2.0 * torch.sqrt(zsq + vae.tiny(raw.dtype)) * arctandiv(K * zsq)
    lp = _logp_universal(n, K, r0, wraps)
    return z, lq, lp, lq - lp


def draw(lat: Latent, raw, eps, c_param=None):
    """One factor's draw (``vae.draw``'s contract); ``u`` here, the others
    ``vae.py``'s."""
    if lat.kind == "u":
        return _universal(lat, raw, eps, c_param)
    return vae.draw(lat, raw, eps, c_param)


def latent(lats, p, raw, eps):
    """The product latent: z (..., B, Z), summed log q and log p (..., B),
    the per-factor KL terms (..., B, n_factors)."""
    zs, kls, lq, lp = [], [], 0.0, 0.0
    ro = eo = 0
    for i, lat in enumerate(lats):
        z, q, pr, kl = draw(lat, raw[..., ro:ro + lat.head_width],
                            eps[..., eo:eo + lat.noise_width],
                            p.get(f"components.{i}.c_param"))
        ro += lat.head_width
        eo += lat.noise_width
        zs.append(z)
        kls.append(kl)
        lq = lq + q
        lp = lp + pr
    return torch.cat(zs, dim=-1), lq, lp, torch.stack(kls, dim=-1)


# --- the model ---------------------------------------------------------------


def param_shapes(lats, cfg: dict) -> dict:
    """Name -> shape of every parameter, in the program's tree order."""
    Hi, Wi, C = cfg["data_shape"]
    H, Z = cfg["h_dim"], sum(l.ambient for l in lats)
    c1, c2 = CHANNELS
    flat = (Hi // 4) * (Wi // 4) * c2
    shapes = {"encoder.conv1.w": (KERNEL, KERNEL, C, c1),
              "encoder.conv1.b": (c1,),
              "encoder.conv2.w": (KERNEL, KERNEL, c1, c2),
              "encoder.conv2.b": (c2,),
              "encoder.fc.w": (flat, H), "encoder.fc.b": (H,),
              "decoder.fc1.w": (Z, H), "decoder.fc1.b": (H,),
              "decoder.fc2.w": (H, flat), "decoder.fc2.b": (flat,),
              "decoder.deconv1.w": (KERNEL, KERNEL, c2, c1),
              "decoder.deconv1.b": (c1,),
              "decoder.deconv2.w": (KERNEL, KERNEL, c1, C),
              "decoder.deconv2.b": (C,)}
    for i, l in enumerate(lats):
        shapes[f"components.{i}.w_mu"] = (H, l.dim)
        shapes[f"components.{i}.b_mu"] = (l.dim,)
        shapes[f"components.{i}.w_sig"] = (H, l.n_scale)
        shapes[f"components.{i}.b_sig"] = (l.n_scale,)
        if l.kind != "e":
            shapes[f"components.{i}.c_param"] = ()
    return shapes


def init(lats, cfg: dict) -> dict:
    """Name -> ("normal", std) or ("fill", value) of every parameter:
    He-normal layers at the program's fan-ins (kh kw cin for a conv, the
    rows for an fc), N(0, 1/h_dim) heads, zero biases; c_param is K itself
    for ``u`` (init_k) and log|K| for the sign-pinned kinds."""
    out = {}
    for k, shape in param_shapes(lats, cfg).items():
        leaf = k.split(".")[-1]
        i = k.split(".")[1]
        if leaf == "w":
            out[k] = ("normal", math.sqrt(2.0 / math.prod(shape[:-1])))
        elif leaf in ("w_mu", "w_sig"):
            out[k] = ("normal", 1.0 / math.sqrt(cfg["h_dim"]))
        elif leaf == "c_param":
            kind = lats[int(i)].kind
            out[k] = ("fill", cfg["init_k"] if kind == "u"
                      else math.log(cfg["init_k"]))
        else:
            out[k] = ("fill", 0.0)
    return out


def loss(lats, p, x, eps, beta: float = 1.0):
    """-mean ELBO of the intensities x (B, H, W, C) at noise eps (B, E)."""
    z, _, _, kl = latent(lats, p, vae.heads(lats, p, encode(p, x)), eps)
    return -torch.mean(log_px(p, z, x) - beta * torch.sum(kl, dim=-1))


def adam(lats, p, batches, lr: float, curvature_lr: float,
         burnin_steps: int, step0: int = 0, beta: float = 1.0,
         betas=(0.9, 0.999), eps: float = 1e-8):
    """Adam over ``batches`` [(x, noise), ...] from parameters ``p`` (name
    -> tensor; not modified), as ``vae.adam``: the curvature leaves at
    ``curvature_lr`` and their gradient zeroed while the global step is
    below ``burnin_steps``. Returns (losses, the first step's gradients,
    the parameters after)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    b1, b2 = betas
    for t, (x, nz) in enumerate(batches, start=1):
        value = loss(lats, p, x, nz, beta)
        grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
        for k in p:
            if k.endswith("c_param") and step0 + t - 1 < burnin_steps:
                grads[k] = torch.zeros_like(grads[k])
        losses.append(value.detach())
        if first is None:
            first = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            for k, v in p.items():
                g = grads[k]
                m[k].mul_(b1).add_((1.0 - b1) * g)
                s[k].mul_(b2).add_((1.0 - b2) * g * g)
                rate = curvature_lr if k.endswith("c_param") else lr
                mh = m[k] / (1.0 - b1 ** t)
                vh = s[k] / (1.0 - b2 ** t)
                v.sub_(rate * mh / (torch.sqrt(vh) + eps))
    return (torch.stack(losses), first,
            {k: v.detach() for k, v in p.items()})


@torch.no_grad()
def iwae(lats, p, x, eps, chunk: int = 125):
    """IWAE estimate of log p(x) per row of the intensities x (B, H, W, C)
    from the importance noise eps (n, B, E), ``chunk`` samples at a
    time."""
    n = eps.shape[0]
    raw = vae.heads(lats, p, encode(p, x))
    out = []
    for c0 in range(0, n, chunk):
        z, lq, lp, _ = latent(lats, p, raw, eps[c0:c0 + chunk])
        out.append(log_px(p, z, x) + lp - lq)
    return torch.logsumexp(torch.cat(out), dim=0) - math.log(n)


# --- the work counted from shapes --------------------------------------------


def conv_macs(cfg: dict) -> dict:
    """Each convolution's forward multiply-adds an example (every tap of
    every output pixel; a transposed conv's every tap of every input
    pixel)."""
    Hi, Wi, C = cfg["data_shape"]
    c1, c2 = CHANNELS
    taps = KERNEL * KERNEL
    h1, w1 = -(-Hi // 2), -(-Wi // 2)
    h2, w2 = -(-h1 // 2), -(-w1 // 2)
    return {"conv1": h1 * w1 * c1 * taps * C,
            "conv2": h2 * w2 * c2 * taps * c1,
            "deconv1": h2 * w2 * c2 * taps * c1,
            "deconv2": h1 * w1 * c1 * taps * C}


def conv_tensors(cfg: dict) -> dict:
    """Each convolution's (input, output) floats an example and its
    kernel's floats."""
    Hi, Wi, C = cfg["data_shape"]
    c1, c2 = CHANNELS
    h1, w1 = -(-Hi // 2), -(-Wi // 2)
    h2, w2 = -(-h1 // 2), -(-w1 // 2)
    a0, a1, a2 = Hi * Wi * C, h1 * w1 * c1, h2 * w2 * c2
    taps = KERNEL * KERNEL
    return {"conv1": (a0, a1, taps * C * c1),
            "conv2": (a1, a2, taps * c1 * c2),
            "deconv1": (a2, a1, taps * c2 * c1),
            "deconv2": (a1, a0, taps * c1 * C)}


def conv_step(cfg: dict, B: int) -> dict:
    """The four convolutions of a training step at batch B: the forward,
    the data gradient (none for conv1, whose input needs none) and the
    weight gradient, FLOPs 2 a multiply-add; bytes in float32 words, each
    operand of each of those products read once and its result written
    once."""
    macs, tensors = conv_macs(cfg), conv_tensors(cfg)
    flops = words = 0
    for name, m in macs.items():
        a_in, a_out, w = tensors[name]
        x, y = B * a_in, B * a_out
        # forward: x, w -> y; weight gradient: x, dy -> dw
        products = [(x + w, y), (x + y, w)]
        if name != "conv1":
            # data gradient: dy, w -> dx
            products.append((y + w, x))
        flops += 2 * B * m * len(products)
        words += sum(r + wr for r, wr in products)
    return {"flops": flops, "bytes": 4 * words}


def forward_macs(cfg: dict, lats) -> dict:
    """An example's forward multiply-adds by part: the encoder (convs and
    fc), the heads, the decoder (fcs and transposed convs)."""
    Hi, Wi, _ = cfg["data_shape"]
    H = cfg["h_dim"]
    W = sum(l.head_width for l in lats)
    Z = sum(l.ambient for l in lats)
    flat = (Hi // 4) * (Wi // 4) * CHANNELS[1]
    m = conv_macs(cfg)
    return {"encoder": m["conv1"] + m["conv2"] + flat * H, "heads": H * W,
            "decoder": Z * H + H * flat + m["deconv1"] + m["deconv2"]}


def train_step(cfg: dict, lats, B: int, n_params: int) -> dict:
    """A training step's products, in multiply-adds: each forward product
    three times a row (forward, input gradient, weight gradient) less
    conv1's input gradient, which nothing needs. Bytes, float32 words: 8
    a parameter for Adam (p, g, m, v read; p, m, v written; g written by
    autograd first) and each activation of the forward (the image, the two
    conv outputs, the two hidden layers, the fc2 output, the deconv1
    output, the logits) written once and read once."""
    f = forward_macs(cfg, lats)
    macs = 3 * B * sum(f.values())
    Hi, Wi, C = cfg["data_shape"]
    t = conv_tensors(cfg)
    acts = (2 * Hi * Wi * C + 2 * t["conv1"][1] + 2 * t["conv2"][1]
            + 2 * cfg["h_dim"])
    return {"gemm_macs": macs,
            "executed_macs": macs - B * conv_macs(cfg)["conv1"],
            "bytes": 4 * (8 * n_params + 2 * B * acts)}


def work(cfg: dict, lats, traffic: dict) -> dict:
    """A training step's work and its convolutions' at the traffic's batch
    (None without one) and an IWAE example's FLOPs at its samples (the
    configuration's ``likelihood_n`` without them)."""
    n_params = sum(math.prod(s) for s in param_shapes(lats, cfg).values())
    B = traffic.get("batch_size")
    n = traffic.get("samples", cfg["likelihood_n"])
    f = forward_macs(cfg, lats)
    return {"train_step": None if B is None else train_step(
                cfg, lats, B, n_params),
            "conv_step": None if B is None else conv_step(cfg, B),
            "iwae_example_flops": 2 * (f["encoder"] + f["heads"]
                                       + n * f["decoder"])}
