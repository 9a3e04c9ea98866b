"""Mixed-curvature VAE: encode / reparametrize / decode / ELBO / IWAE.

Counterpart of ``mvae_tpu/models/vae.py`` (MLP VAE, evaluation path):

  forward:  encoder(x) -> features; one fused head GEMM for every
            component -> the product-latent tail (the CUDA tail kernel when
            the product is in its family) -> z; decoder(z) -> Bernoulli
            logits; ELBO = log p(x|z) - sum_c KL_c.
  log_likelihood: IWAE-n estimate logsumexp_n[log p(x|z_i) + log p(z_i)
            - log q(z_i|x)] - log n, encoding once and drawing the
            importance samples in chunks decoded by the CUDA decode+BCE
            kernel.

Every draw takes its standard noise as an optional tensor (the layout of
``kernels.tail_kernels.draw_noise``); without it, the noise comes from the
``torch.Generator`` passed in. Params are plain dicts of tensors with the
reference's structure and (in, out) weight layout.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..components import Component, reparametrize, total_ambient_dim
from ..kernels import decoder_kernels, tail_kernels
from ..ops.stable import softplus
from . import nets


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Static model description."""

    components: tuple[Component, ...]
    data_shape: tuple[int, ...]      # (D,) flat or (H, W) images
    arch: str = "mlp"                # 'mlp' ('conv' is a later slice)
    h_dim: int = 400
    encoder_depth: int = 1
    decoder_depth: int = 1

    def __post_init__(self):
        if self.arch not in ("mlp", "conv"):
            raise ValueError(f"unknown arch {self.arch!r}")
        if self.arch == "conv":
            raise NotImplementedError("later slice: the conv VAE")

    @property
    def flat_dim(self) -> int:
        return math.prod(self.data_shape)

    @property
    def z_dim(self) -> int:
        return total_ambient_dim(self.components)


def init_params(cfg: VAEConfig, init_k: float = 1.0, dtype=torch.float32,
                generator: torch.Generator | None = None, device=None):
    """Random parameters drawn from ``generator`` (a CPU generator, so a
    seed gives the same weights on every device) and moved to ``device``."""
    params = _tree_map(lambda t: t.to(device), {
        "encoder": nets.mlp_encoder_init(cfg.flat_dim, cfg.h_dim, dtype,
                                         cfg.encoder_depth, generator),
        "decoder": nets.mlp_decoder_init(cfg.z_dim, cfg.h_dim, cfg.flat_dim,
                                         dtype, cfg.decoder_depth, generator),
    })
    params["components"] = tuple(
        comp.init_params(cfg.h_dim, init_k, dtype, generator, device)
        for comp in cfg.components)
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def encode(cfg: VAEConfig, params, x):
    flat = x.reshape(x.shape[:x.dim() - len(cfg.data_shape)]
                     + (cfg.flat_dim,))
    return nets.mlp_encoder_apply(params["encoder"], flat)


def decode(cfg: VAEConfig, params, z):
    logits = nets.mlp_decoder_apply(params["decoder"], z)
    return logits.reshape(z.shape[:-1] + cfg.data_shape)


def bernoulli_log_prob(logits, x):
    """Elementwise log Bernoulli(x | sigmoid(logits)) = x l - softplus(l)."""
    return x * logits - softplus(logits)


def _sum_data_axes(a, n_data_axes: int):
    return torch.sum(a, dim=tuple(range(a.dim() - n_data_axes, a.dim())))


class Forward:
    """Named results of one forward pass."""

    __slots__ = ("z", "log_px_z", "log_q", "log_p", "kl_per_comp",
                 "curvatures")

    def __init__(self, z, log_px_z, log_q, log_p, kl_per_comp, curvatures):
        self.z = z
        self.log_px_z = log_px_z
        self.log_q = log_q
        self.log_p = log_p
        self.kl_per_comp = kl_per_comp
        self.curvatures = curvatures


def _fused_head_raw_cat(cfg: VAEConfig, params, feats):
    """All components' mu/scale heads as one GEMM: (..., sum head_width)
    pre-activations in per-component [mu | scale] blocks."""
    ws, bs = [], []
    for cp in params["components"]:
        ws.extend((cp["w_mu"], cp["w_sig"]))
        bs.extend((cp["b_mu"], cp["b_sig"]))
    return torch.matmul(feats, torch.cat(ws, dim=1)) + torch.cat(bs)


def _fused_head_raw(cfg: VAEConfig, params, feats):
    """The fused head GEMM sliced per component."""
    raw_all = _fused_head_raw_cat(cfg, params, feats)
    return list(torch.split(raw_all, [c.head_width for c in cfg.components],
                            dim=-1))


def _fused_tail_gate(cfg: VAEConfig, params) -> tuple[bool, str]:
    """The gate for the fused tail kernel: the whole product latent in f32
    with every component in the kernel family. Returns (eligible, reason);
    the router and ``fused_path_report`` both call it. No routing table is
    taken from the TPU: every capable product takes the kernel."""
    if any(cp["w_mu"].dtype != torch.float32 for cp in params["components"]):
        return False, "non-f32 head params -> plain per-component tail"
    unsup = [f"{c.name}:{c.posterior}" for c in cfg.components
             if not tail_kernels.component_supported(c)]
    if unsup:
        return False, ("unsupported component(s): " + ",".join(unsup)
                       + " -> plain per-component tail")
    return True, ("kernel csrc/tail_fwd.cu (plain tail_forward_ref on CPU "
                  "tensors)")


def _split_noise(comps, noise):
    """Per-component slices of (..., E) product noise."""
    return torch.split(noise, [c.noise_width for c in comps], dim=-1)


def _reparam_components(cfg: VAEConfig, params, feats, noise=None,
                        generator=None):
    """Per-component reparameterization from encoder features: the
    concatenated latent, summed log q / log p, per-component KL and the
    curvatures. Routed through the fused tail when the gate allows."""
    comps = cfg.components
    if noise is None:
        noise = tail_kernels.draw_noise(comps, feats.shape[:-1], feats,
                                        generator)
    if _fused_tail_gate(cfg, params)[0]:
        raw_all = _fused_head_raw_cat(cfg, params, feats)
        return tail_kernels.reparam_all(comps, params["components"], raw_all,
                                        noise)
    zs, log_q, log_p, kls, curvs = [], 0.0, 0.0, [], []
    for comp, cp, raw, nz in zip(comps, params["components"],
                                 _fused_head_raw(cfg, params, feats),
                                 _split_noise(comps, noise)):
        rep = reparametrize(comp, cp, feats, raw=raw, noise=nz)
        zs.append(rep.z)
        log_q = log_q + rep.log_q
        log_p = log_p + rep.log_p
        kls.append(rep.kl)
        curvs.append(comp.curvature(cp))
    return (torch.cat(zs, dim=-1), log_q, log_p, torch.stack(kls, dim=-1),
            torch.stack(curvs))


def forward_from_features(cfg: VAEConfig, params, x, feats, noise=None,
                          generator=None) -> Forward:
    """Reparameterize + decode from precomputed encoder features."""
    z, log_q, log_p, kls, curvs = _reparam_components(cfg, params, feats,
                                                      noise, generator)
    logits = decode(cfg, params, z)
    log_px_z = _sum_data_axes(bernoulli_log_prob(logits, x),
                              len(cfg.data_shape))
    return Forward(z, log_px_z, log_q, log_p, kls, curvs)


def forward(cfg: VAEConfig, params, x, noise=None, generator=None) -> Forward:
    """One reparameterized forward pass: everything ELBO/IWAE need."""
    feats = encode(cfg, params, x)
    return forward_from_features(cfg, params, x, feats, noise, generator)


def elbo(cfg: VAEConfig, params, x, beta: float = 1.0, noise=None,
         generator=None):
    """Per-example ELBO and a stats dict (single-sample MC KL)."""
    fwd = forward(cfg, params, x, noise, generator)
    kl_total = torch.sum(fwd.kl_per_comp, dim=-1)
    value = fwd.log_px_z - beta * kl_total
    stats = {
        "elbo": torch.mean(value),
        "bce": torch.mean(-fwd.log_px_z),
        "kl": torch.mean(kl_total),
        "kl_per_comp": torch.mean(fwd.kl_per_comp, dim=0),
        "curvature": fwd.curvatures,
    }
    return value, stats


def _fused_decoder_eligible(cfg: VAEConfig, params) -> bool:
    """The decode+BCE kernel covers depth-1 f32 MLP decoders whose hidden
    tile fits one block's shared memory."""
    if cfg.decoder_depth != 1:
        return False
    if params["decoder"]["out"]["w"].dtype != torch.float32:
        return False
    return decoder_kernels.shape_supported(cfg.z_dim, cfg.h_dim)


def _reparam_chunk_t(cfg: VAEConfig, params, feats, chunk_size: int,
                     noise=None, generator=None):
    """IWAE chunk reparam: zt (chunk, Z, B) in the decoder kernel's layout
    plus summed log q / log p (chunk, B). ``noise`` is (chunk, B, E).
    The per-component draws are plain PyTorch, as in the reference."""
    comps = cfg.components
    B = feats.shape[0]
    if noise is None:
        noise = tail_kernels.draw_noise(comps, (chunk_size, B), feats,
                                        generator)
    zs, log_q, log_p = [], 0.0, 0.0
    for comp, cp, raw, nz in zip(comps, params["components"],
                                 _fused_head_raw(cfg, params, feats),
                                 _split_noise(comps, noise)):
        rep = reparametrize(comp, cp, feats, raw=raw, noise=nz)
        zs.append(rep.z)
        log_q = log_q + rep.log_q
        log_p = log_p + rep.log_p
    # (chunk, B, Z) -> (chunk, Z, B): batch contiguous for the kernel
    zt = torch.cat(zs, dim=-1).transpose(1, 2).contiguous()
    return zt, log_q, log_p


def _log_weights(cfg: VAEConfig, params, x, n_samples: int,
                 chunk_size: int, noise=None, generator=None):
    """(n_samples, B) IWAE log-weights log p(x|z_i) + log p(z_i)
    - log q(z_i|x). ``noise`` (n_samples, B, E) indexes samples globally,
    so the result does not depend on the chunking."""
    fused = _fused_decoder_eligible(cfg, params)
    if fused:
        # the kernel never materializes logits: the largest divisor <= 128
        # is the per-launch sample group (n = 500 -> 125 per launch)
        chunk_size = next(d for d in range(min(128, n_samples), 0, -1)
                          if n_samples % d == 0)
    if n_samples % chunk_size:
        raise ValueError("n_samples must divide into chunks")
    feats = encode(cfg, params, x)  # encode once for all importance samples
    xf = x.reshape(x.shape[0], cfg.flat_dim)
    xt = xf.T.contiguous() if fused else None
    dec = params["decoder"]
    out = []
    for c0 in range(0, n_samples, chunk_size):
        nz = None if noise is None else noise[c0:c0 + chunk_size]
        zt, log_q, log_p = _reparam_chunk_t(cfg, params, feats, chunk_size,
                                            nz, generator)
        if fused:
            ll = decoder_kernels.fused_decode_bce_t(
                zt, xt, dec["layers"][0]["w"], dec["layers"][0]["b"],
                dec["out"]["w"], dec["out"]["b"])
        else:
            logits = nets.mlp_decoder_apply(dec, zt.transpose(1, 2))
            ll = torch.sum(bernoulli_log_prob(logits, xf), dim=-1)
        out.append(ll + log_p - log_q)
    return torch.cat(out, dim=0)


def log_likelihood(cfg: VAEConfig, params, x, n_samples: int = 500,
                   chunk_size: int = 20, noise=None, generator=None):
    """IWAE marginal log-likelihood estimate per example:
    log p(x) ~= logsumexp_i [log p(x|z_i) + log p(z_i) - log q(z_i|x)]
    - log n."""
    log_w = _log_weights(cfg, params, x, n_samples, chunk_size, noise,
                         generator)
    return torch.logsumexp(log_w, dim=0) - math.log(n_samples)


def fused_path_report(cfg: VAEConfig, params) -> dict:
    """Which of the port's kernels this (config, params) routes to, and why
    not when not -- from the same gate predicates the code paths call.
    Every entry is {'active': bool, 'why': str}."""

    def entry(active: bool, why: str) -> dict:
        return {"active": bool(active), "why": why}

    if _fused_decoder_eligible(cfg, params):
        idec = entry(True, "kernel csrc/decode_bce.cu (plain decode_bce_ref "
                     "on CPU tensors)")
    else:
        idec = entry(False, "decoder not depth-1 f32 MLP within the "
                     "kernel's shared memory -> plain PyTorch decode")
    reparam = [entry(False, f"{c.name}#{i}: {c.posterior} on "
                     f"'{c.manifold.kind}' draws in plain PyTorch")
               for i, c in enumerate(cfg.components)]
    return {"train_tail": entry(*_fused_tail_gate(cfg, params)),
            "train_decoder": entry(False, "training decode kernel: later "
                                   "slice"),
            "iwae_decoder": idec, "iwae_reparam": reparam,
            "routing_policy": "capability-only (no TPU-measured routing)"}
