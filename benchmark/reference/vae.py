"""Plain PyTorch reference of the mixed-curvature VAE (Skopek et al.,
"Mixed-curvature Variational Autoencoders", arXiv:1911.08411).

The MLP VAE on flat binarized data (``data_shape`` ``[D]``): encoder
``relu(x W + b)``, one linear head per latent factor (tangent mean and
softplus scale), the reparameterized draw of each factor with its log q,
its prior's log p and its KL term, decoder ``relu(z W1 + b1) W2 + b2`` and the Bernoulli
log-likelihood. The ELBO's KL is analytic for the Euclidean normal and the
von Mises-Fisher, ``log q - log p`` of the draw for the wrapped normals;
the IWAE-n estimate is ``logsumexp_i(log p(x|z_i) + log p(z_i) -
log q(z_i|x)) - log n``. Adam is written out with torch's defaults.

Factors: ``h`` the wrapped normal on the hyperboloid (K < 0), ``s`` the vMF
on the sphere (m = 3, the exact inverse-CDF cosine), ``e`` the normal,
``d`` / ``p`` the wrapped normal on the Poincare ball (K < 0) / the
projected sphere (K > 0), the latter's density summed over wrap images.
``K = sign * exp(c)`` for a learnable ``c``.

Every function computes in the dtype of its inputs with plain closed forms
(float64 is the reference; the series the float32 program evaluates near
zero agree with them there). The constants that define the model rather
than its rounding are those of the paper's public implementation as the
program states them: the positive-K scale cap at the injectivity radius,
the soft floor of ``log|sin|`` near the shell (``SHELL_DELTA``), the
vMF cosine's clamps, the ball's edge and the Mobius denominator's guard
(``FLOOR``). Departures from the paper: the wrap-image sum is cut at
``wraps`` extra pairs of periods for the prior and ``wraps + 3`` for the
posterior, as the program cuts it.

``tf32_matmuls()`` computes the block's matrix products in TF32 (the
card's flag; on the CPU, operands rounded to TF32's 10-bit mantissa): the
control of the benchmark's comparison. ``init`` and ``work`` give the
weights' scales and the work counted from shapes (``reference``'s
contract).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
LOG_4PI = math.log(4.0 * math.pi)
SHELL_DELTA = 1e-3
U_MIN = 1e-7
FLOOR = 1e-6
SIGN = {"e": 0, "h": -1, "s": 1, "d": -1, "p": 1}
DEFAULT_POSTERIOR = {"e": "normal", "h": "wrapped", "s": "vmf",
                     "d": "wrapped", "p": "wrapped"}

_TF32 = [False]


@contextlib.contextmanager
def tf32_matmuls():
    """Matrix products of the block in TF32: the card's TF32 switch, and on
    the CPU each operand rounded to TF32 before a float32 product."""
    old = torch.backends.cuda.matmul.allow_tf32
    _TF32[0] = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        _TF32[0] = False
        torch.backends.cuda.matmul.allow_tf32 = old


def round_tf32(x):
    """float32 ``x`` rounded to the nearest TF32 value (10-bit mantissa)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    """a @ b with every product's operands rounded to TF32, the backward's
    products too (the CPU's stand-in for the card's TF32 switch)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = g @ round_tf32(b).transpose(-1, -2)
        gb = (round_tf32(a).transpose(-1, -2) @ g) if b.requires_grad else None
        if gb is not None and gb.dim() > b.dim():
            gb = gb.sum(dim=tuple(range(gb.dim() - b.dim())))
        return ga, gb


def mm(a, b):
    if _TF32[0] and not a.is_cuda and a.dtype == torch.float32:
        return _MatmulTF32.apply(a, b)
    return a @ b


@dataclasses.dataclass(frozen=True)
class Latent:
    """One latent factor: manifold kind, intrinsic dim, posterior."""

    kind: str
    dim: int
    posterior: str

    @property
    def sign(self) -> int:
        return SIGN[self.kind]

    @property
    def ambient(self) -> int:
        return self.dim + 1 if self.kind in ("h", "s") else self.dim

    @property
    def n_scale(self) -> int:
        return 1 if self.posterior == "vmf" else self.dim

    @property
    def head_width(self) -> int:
        return self.dim + self.n_scale

    @property
    def noise_width(self) -> int:
        return self.dim + 1 if self.posterior == "vmf" else self.dim


def parse_spec(spec: str) -> tuple[Latent, ...]:
    """``"h2,s2,e2"`` -> the factors. Covers the factors this reference
    implements: e, h, s (vMF at dim 2), d, p with their default posteriors."""
    out = []
    for part in spec.split(","):
        kind, dim = part.strip()[0], int(part.strip()[1:])
        post = DEFAULT_POSTERIOR[kind]
        if post == "vmf" and dim != 2:
            raise ValueError("the reference's vMF is the m = 3 sphere")
        out.append(Latent(kind, dim, post))
    return tuple(out)


# --- scalar math -------------------------------------------------------------


def tiny(dtype) -> float:
    return 1e-30 if dtype == torch.float64 else 1e-15


def softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def norm(x, keepdim: bool = False):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim)
                      + tiny(x.dtype))


def _small(x, cut):
    """(x < cut, x with the small values replaced by 1): both branches of a
    ``where`` stay finite."""
    small = x < cut
    return small, torch.where(small, torch.ones_like(x), x)


def sinhc(x):
    """sinh(x) / x for x >= 0."""
    small, xc = _small(x, 1e-4)
    return torch.where(small, 1.0 + x * x / 6.0, torch.sinh(xc) / xc)


def sinc(x):
    small, xc = _small(x, 1e-4)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(xc) / xc)


def log_sinhc(x):
    """log(sinh(x) / x) for x >= 0, overflow-free."""
    small, xc = _small(x, 1e-3)
    x2 = x * x
    closed = xc + torch.log1p(-torch.exp(-2.0 * xc)) - torch.log(2.0 * xc)
    return torch.where(small, x2 / 6.0 - x2 * x2 / 180.0, closed)


def log_abs_sin_soft(x, taper):
    """log|sin x| with the soft floor 0.5 log(sin^2 x + d^2),
    d = SHELL_DELTA * min(taper / pi, 1)^3."""
    s = torch.sin(x)
    t = torch.clamp(taper / math.pi, max=1.0)
    d = SHELL_DELTA * t * t * t
    return 0.5 * torch.log(s * s + d * d)


def log_sinc_soft(x):
    """log(|sin x|_soft / x) for x >= 0."""
    small, xc = _small(x, 1e-3)
    x2 = x * x
    return torch.where(small, -x2 / 6.0 - x2 * x2 / 180.0,
                       log_abs_sin_soft(xc, xc) - torch.log(xc))


def tandiv(u, sign: int):
    """tan(sqrt(u)) / sqrt(u) for sign > 0 (u >= 0), tanh(sqrt(-u)) /
    sqrt(-u) for sign < 0 (u <= 0)."""
    a = torch.abs(u)
    small, ac = _small(a, 1e-6)
    s = torch.sqrt(ac)
    closed = torch.tan(s) / s if sign > 0 else torch.tanh(s) / s
    return torch.where(small, 1.0 + u / 3.0, closed)


def logsumexp_list(terms):
    return torch.logsumexp(torch.stack(terms, dim=-1), dim=-1)


# --- the factors -------------------------------------------------------------


def curvature(lat: Latent, c):
    return lat.sign * torch.exp(c)


def _normal(lat, raw, eps):
    n = lat.dim
    mu, sig = raw[..., :n], softplus(raw[..., n:])
    z = mu + sig * eps
    lq = torch.sum(-0.5 * (eps * eps + LOG_2PI) - torch.log(sig), dim=-1)
    lp = torch.sum(-0.5 * (z * z + LOG_2PI), dim=-1)
    kl = 0.5 * torch.sum(sig * sig + mu * mu - 1.0 - 2.0 * torch.log(sig),
                         dim=-1)
    return z, lq, lp, kl.expand(lq.shape)


def _lorentz(lat, raw, eps, c_param):
    """Wrapped normal on the hyperboloid <x, x>_L = -1/c, c = -K:
    z = exp_mu(PT_{mu0 -> mu}(0, sigma eps)), mu = exp_mu0(0, mu_tan)."""
    n = lat.dim
    c = torch.exp(c_param)
    sc = torch.sqrt(c)
    R = 1.0 / sc
    mu_tan, sig = raw[..., :n], softplus(raw[..., n:])
    mu_sp = sinhc(sc * norm(mu_tan, True)) * mu_tan
    mu_t = torch.sqrt(1.0 / c + torch.sum(mu_sp * mu_sp, -1, keepdim=True))
    v = sig * eps
    coef = c * torch.sum(mu_sp * v, -1, keepdim=True) / (1.0 + sc * mu_t)
    u_t = coef * (R + mu_t)
    u_sp = v + coef * mu_sp
    usq = torch.clamp(torch.sum(u_sp * u_sp, -1, keepdim=True) - u_t * u_t,
                      min=0.0)
    th = sc * torch.sqrt(usq + tiny(raw.dtype))
    z_sp = torch.cosh(th) * mu_sp + sinhc(th) * u_sp
    zsp2 = torch.sum(z_sp * z_sp, -1, keepdim=True)
    z_t = torch.sqrt(1.0 / c + zsp2)
    lq = (torch.sum(-0.5 * (eps * eps + LOG_2PI) - torch.log(sig), dim=-1)
          - (n - 1) * log_sinhc(sc * norm(v)))
    # the prior's radius d(mu0, z) = acosh(1 + e0) / sqrt(c)
    e0 = (torch.clamp(c * (zsp2 - (z_t - R) ** 2), min=0.0) / 2.0
          + tiny(raw.dtype))
    r0 = (torch.log1p(e0 + torch.sqrt(e0 * (e0 + 2.0))) / sc).squeeze(-1)
    lp = -0.5 * r0 * r0 - 0.5 * n * LOG_2PI - (n - 1) * log_sinhc(sc * r0)
    return torch.cat([z_t, z_sp], dim=-1), lq, lp, lq - lp


def _vmf(lat, raw, eps, c_param):
    """vMF(mu, kappa) on the sphere of radius 1/sqrt(K), m = 3."""
    K = torch.exp(c_param)
    sk = torch.sqrt(K)
    R = 1.0 / sk
    mu_tan = raw[..., :2]
    kap = softplus(raw[..., 2]) + 1.0
    th = sk * norm(mu_tan, True)
    mu = torch.cat([R * torch.cos(th), sinc(th) * mu_tan], dim=-1)
    mu_u = mu / norm(mu, True)
    kp = torch.clamp(kap, min=1e-6)
    u = eps[..., 0]
    w = 1.0 + torch.log1p((1.0 - u) * torch.expm1(-2.0 * kp)) / kp
    w = torch.clamp(w, -1.0 + 1e-7, 1.0 - 1e-7)
    g = eps[..., 1:3]
    sw = torch.sqrt(torch.clamp(1.0 - w * w, min=tiny(raw.dtype)))
    zp = torch.cat([w[..., None], sw[..., None] * g / norm(g, True)], -1)
    e1 = torch.zeros_like(mu_u)
    e1[..., 0] = 1.0
    uh = e1 - mu_u
    un = norm(uh, True)
    uhat = uh / torch.clamp(un, min=FLOOR)
    refl = zp - 2.0 * torch.sum(uhat * zp, -1, keepdim=True) * uhat
    z_u = torch.where(un < FLOOR, zp, refl)
    log_sinh = kap + torch.log1p(-torch.exp(-2.0 * kap)) - math.log(2.0)
    log_c = torch.log(kap) - LOG_4PI - log_sinh
    lq = log_c + kap * torch.sum(mu_u * z_u, dim=-1) + torch.log(K)
    lp = (torch.log(K) - LOG_4PI).expand(lq.shape)
    kl = kap * (1.0 / torch.tanh(kap) - 1.0 / kap) + log_c + LOG_4PI
    return z_u * R, lq, lp, kl.expand(lq.shape)


def _ball(x, K, sign):
    """The Poincare ball's edge: points pulled inside radius
    (1 - FLOOR) / sqrt(-K)."""
    if sign >= 0:
        return x
    smax = (1.0 - FLOOR) / torch.sqrt(-K)
    return x * torch.clamp(smax / norm(x, True), max=1.0)


def _mobius_add(x, y, K):
    x2 = torch.sum(x * x, -1, keepdim=True)
    y2 = torch.sum(y * y, -1, keepdim=True)
    xy = torch.sum(x * y, -1, keepdim=True)
    num = (1.0 - 2.0 * K * xy - K * y2) * x + (1.0 + K * x2) * y
    den = 1.0 - 2.0 * K * xy + K * K * x2 * y2
    den = torch.where(torch.abs(den) < FLOOR, torch.full_like(den, FLOOR),
                      den)
    return num / den


def _logq_drawn(n, sign, K, vsq, s2, ls, wraps):
    """log q of z = mu (+) exp_0(v) from the drawn tangent v: every preimage
    of z lies on the drawn geodesic at radius r + m T (K > 0)."""
    half = 0.5 * n * LOG_2PI
    r = torch.sqrt(vsq)
    if sign < 0:
        return -0.5 * s2 - ls - half - (n - 1) * log_sinhc(
            torch.sqrt(-K) * r)
    sk = torch.sqrt(K)
    T = 2.0 * math.pi / sk
    rp = torch.abs(r - T * torch.floor(r / T + 0.5))
    quad = s2 / vsq
    x0 = sk * rp
    terms = []
    for m in range(-(wraps + 3), wraps + 4):
        rb = rp + m * T
        if m == 0:
            logdet = (n - 1) * log_sinc_soft(x0)
        else:
            xb = sk * torch.abs(rb)
            logdet = (n - 1) * (log_abs_sin_soft(x0, xb) - torch.log(xb))
        terms.append(-0.5 * rb * rb * quad - ls - half - logdet)
    return logsumexp_list(terms)


def _logp_prior(n, sign, K, r0, wraps):
    """log of the prior WrappedNormal(mu0, 1) at a point of radius r0."""
    half = 0.5 * n * LOG_2PI
    if sign < 0:
        return -0.5 * r0 * r0 - half - (n - 1) * log_sinhc(
            torch.sqrt(-K) * r0)
    sk = torch.sqrt(K)
    main = -0.5 * r0 * r0 - half - (n - 1) * log_sinc_soft(sk * r0)
    if wraps == 0:
        return main
    T = 2.0 * math.pi / sk
    terms = [main]
    for s in (1.0, -1.0):
        rb = r0 + s * T
        lsk = log_abs_sin_soft(sk * r0, sk * torch.abs(rb)) - torch.log(sk)
        terms.append(-0.5 * rb * rb - half
                     - (n - 1) * (lsk - torch.log(torch.abs(rb))))
    return logsumexp_list(terms)


def _stereo(lat, raw, eps, c_param, wraps: int = 1):
    """Wrapped normal on the kappa-stereographic model (Poincare ball for
    K < 0, projected sphere for K > 0): z = mu (+)_K exp_0(sigma eps)."""
    n, sign = lat.dim, lat.sign
    K = curvature(lat, c_param)
    mu_tan, sig = raw[..., :n], softplus(raw[..., n:])
    if sign > 0:
        cap = math.pi / torch.sqrt(K)
        t = torch.clamp(sig / cap, max=8.0)
        sig = cap * t * (1.0 + t ** 6) ** (-1.0 / 6.0)
    mu = 0.5 * tandiv(K * torch.sum(mu_tan * mu_tan, -1, keepdim=True) / 4.0,
                      sign) * mu_tan
    mu = _ball(mu, K, sign)
    v = sig * eps
    vsq = torch.sum(v * v, -1, keepdim=True)
    ex = _ball(0.5 * tandiv(K * vsq / 4.0, sign) * v, K, sign)
    z = _ball(_mobius_add(mu, ex, K), K, sign)
    s2 = torch.sum(eps * eps, dim=-1)
    ls = torch.sum(torch.log(sig), dim=-1)
    lq = _logq_drawn(n, sign, K, vsq.squeeze(-1) + tiny(raw.dtype), s2, ls,
                     wraps)
    zn = norm(z)
    if sign > 0:
        r0 = 2.0 * torch.atan(torch.sqrt(K) * zn) / torch.sqrt(K)
    else:
        r0 = 2.0 * torch.atanh(torch.sqrt(-K) * zn) / torch.sqrt(-K)
    lp = _logp_prior(n, sign, K, r0, wraps)
    return z, lq, lp, lq - lp


def draw(lat: Latent, raw, eps, c_param=None):
    """One factor's draw from its head pre-activations ``raw`` (B,
    head_width) and standard noise ``eps`` (..., B, noise_width): z (..., B,
    ambient), log q, log p and the ELBO's KL term (..., B)."""
    if lat.posterior == "normal":
        return _normal(lat, raw, eps)
    if lat.posterior == "vmf":
        return _vmf(lat, raw, eps, c_param)
    if lat.kind == "h":
        return _lorentz(lat, raw, eps, c_param)
    return _stereo(lat, raw, eps, c_param)


# --- the model ----------------------------------------------------------------


def param_shapes(lats, cfg: dict) -> dict:
    """Name -> shape of every parameter, in the program's tree order."""
    D, H = math.prod(cfg["data_shape"]), cfg["h_dim"]
    Z = sum(l.ambient for l in lats)
    shapes = {"encoder.layers.0.w": (D, H), "encoder.layers.0.b": (H,),
              "decoder.layers.0.w": (Z, H), "decoder.layers.0.b": (H,),
              "decoder.out.w": (H, D), "decoder.out.b": (D,)}
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
    He-normal layers, N(0, 1/H) heads, zero biases, log|K| = log init_k."""
    fan_in = {"encoder.layers.0.w": math.prod(cfg["data_shape"]),
              "decoder.layers.0.w": sum(l.ambient for l in lats),
              "decoder.out.w": cfg["h_dim"]}
    out = {}
    for k in param_shapes(lats, cfg):
        leaf = k.split(".")[-1]
        if leaf == "w":
            out[k] = ("normal", math.sqrt(2.0 / fan_in[k]))
        elif leaf in ("w_mu", "w_sig"):
            out[k] = ("normal", 1.0 / math.sqrt(cfg["h_dim"]))
        elif leaf == "c_param":
            out[k] = ("fill", math.log(cfg["init_k"]))
        else:
            out[k] = ("fill", 0.0)
    return out


def encode(p, x):
    return torch.relu(mm(x, p["encoder.layers.0.w"]) + p["encoder.layers.0.b"])


def heads(lats, p, feats):
    w = torch.cat([p[f"components.{i}.{n}"] for i in range(len(lats))
                   for n in ("w_mu", "w_sig")], dim=1)
    b = torch.cat([p[f"components.{i}.{n}"] for i in range(len(lats))
                   for n in ("b_mu", "b_sig")])
    return mm(feats, w) + b


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


def log_px(p, z, x):
    """Bernoulli log-likelihood of binary x (..., B, D) under the decoder's
    logits at z (..., B, Z)."""
    h = torch.relu(mm(z, p["decoder.layers.0.w"]) + p["decoder.layers.0.b"])
    logits = mm(h, p["decoder.out.w"]) + p["decoder.out.b"]
    return torch.sum(x * logits - softplus(logits), dim=-1)


def loss(lats, p, x, eps, beta: float = 1.0):
    """-mean ELBO of the binary batch x (B, D) at noise eps (B, E)."""
    feats = encode(p, x)
    z, _, _, kl = latent(lats, p, heads(lats, p, feats), eps)
    return -torch.mean(log_px(p, z, x) - beta * torch.sum(kl, dim=-1))


def adam(lats, p, batches, lr: float, curvature_lr: float,
         burnin_steps: int, step0: int = 0, beta: float = 1.0,
         betas=(0.9, 0.999), eps: float = 1e-8):
    """Adam over ``batches`` [(x, noise), ...] from parameters ``p`` (name
    -> tensor; not modified): the curvature leaves at ``curvature_lr`` and
    their gradient zeroed while the global step is below ``burnin_steps``.
    Returns (losses, the first step's gradients, the parameters after)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    b1, b2 = betas
    for t, (x, nz) in enumerate(batches, start=1):
        value = loss(lats, p, x, nz, beta)
        grads = torch.autograd.grad(value, list(p.values()))
        grads = dict(zip(p, grads))
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
    """IWAE estimate of log p(x) per row of the binary batch x (B, D) from
    the importance noise eps (n, B, E), ``chunk`` samples at a time."""
    n = eps.shape[0]
    raw = heads(lats, p, encode(p, x))
    out = []
    for c0 in range(0, n, chunk):
        z, lq, lp, _ = latent(lats, p, raw, eps[c0:c0 + chunk])
        out.append(log_px(p, z, x) + lp - lq)
    return torch.logsumexp(torch.cat(out), dim=0) - math.log(n)


# --- the work counted from shapes --------------------------------------------


def train_step(D: int, H: int, W: int, Z: int, B: int, n_params: int) -> dict:
    """The MLP VAE's matrix products a training step executes, in
    multiply-adds: the forward products (encoder D x H, heads H x W, decoder
    Z x H and H x D) three times a row (forward, input gradient, weight
    gradient) less the encoder's input gradient, which nothing needs.
    Bytes, float32 words: 8 a parameter for Adam (p, g, m, v read; p, m, v
    written; g written by autograd first) and 2 B (2 D + H) for the
    activations each written once and read once."""
    macs = 3 * B * (D * H + H * W + Z * H + H * D)
    return {"gemm_macs": macs, "executed_macs": macs - B * D * H,
            "bytes": 4 * (8 * n_params + 2 * B * (2 * D + H))}


def iwae_example_flops(D: int, H: int, W: int, Z: int, n: int) -> int:
    """An example's IWAE-n forward products: encoder and heads once, the
    decoder's two products n times."""
    return 2 * (D * H + H * W + n * (Z * H + H * D))


def work(cfg: dict, lats, traffic: dict) -> dict:
    """A training step's work at the traffic's batch (None without one) and
    an IWAE example's FLOPs at its samples (the configuration's
    ``likelihood_n`` without them)."""
    D, H = math.prod(cfg["data_shape"]), cfg["h_dim"]
    W = sum(l.head_width for l in lats)
    Z = sum(l.ambient for l in lats)
    n_params = sum(math.prod(s) for s in param_shapes(lats, cfg).values())
    B = traffic.get("batch_size")
    return {"train_step": None if B is None else train_step(
                D, H, W, Z, B, n_params),
            "iwae_example_flops": iwae_example_flops(
                D, H, W, Z, traffic.get("samples", cfg["likelihood_n"]))}
