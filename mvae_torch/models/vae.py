"""Mixed-curvature VAE: encode / reparametrize / decode / ELBO / IWAE.

Counterpart of ``mvae_tpu/models/vae.py`` (the MLP VAE and the conv VAE
of CIFAR):

  forward:  encoder(x) -> features; one fused head GEMM for every
            component -> the product-latent tail -> z; decoder(z) ->
            Bernoulli log-likelihood; ELBO = log p(x|z) - sum_c KL_c;
            ``loss_fn`` = -mean ELBO.
  log_likelihood: IWAE-n estimate logsumexp_n[log p(x|z_i) + log p(z_i)
            - log q(z_i|x)] - log n, encoding once and drawing and
            decoding the importance samples in chunks.

Which CUDA kernel each pass runs, where one covers it, is
``route.route(cfg, params)``, computed once a call and passed down: the
tail kernels B1 / B3 and the training decode B6 in the forward, the chunk
reparam kernels B5 / P2 and the decode B2 in an IWAE chunk. Every draw
takes its standard noise as an optional tensor (the layout of
``kernels.tail_kernels.draw_noise``); without it, the noise comes from the
``torch.Generator`` passed in. While a torch profiler records, the passes
mark their layers (``utils.profiling.mark``): the forward ``tail`` and
``decode`` (and, under autograd, ``bwd_tail`` and ``bwd_encode`` where the
backward reaches z's and the encoder features' gradients), the ELBO
``loss``, and the IWAE batch ``encode``, ``reparam`` and ``decode`` a chunk,
``logsumexp`` and ``end``. Params are plain dicts of tensors with the
reference's structure and (in, out) weight layout.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import types

import torch

from ..components import (Component, reparametrize, sample_prior,
                          total_ambient_dim)
from ..kernels import decoder_kernels, manifold_kernels, tail_kernels
from ..ops.stable import acc_dtype, softplus
from ..utils import profiling
from . import nets
from .route import route


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Static model description."""

    components: tuple[Component, ...]
    data_shape: tuple[int, ...]      # (D,) flat or (H, W[, C]) images
    arch: str = "mlp"                # 'mlp' | 'conv' ((H, W, C) images)
    h_dim: int = 400
    encoder_depth: int = 1
    decoder_depth: int = 1

    def __post_init__(self):
        if self.arch not in ("mlp", "conv"):
            raise ValueError(f"unknown arch {self.arch!r}")
        if self.arch == "conv" and len(self.data_shape) != 3:
            raise ValueError("conv arch needs (H, W, C) data_shape")

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
    if cfg.arch == "mlp":
        encoder = nets.mlp_encoder_init(cfg.flat_dim, cfg.h_dim, dtype,
                                        cfg.encoder_depth, generator)
        decoder = nets.mlp_decoder_init(cfg.z_dim, cfg.h_dim, cfg.flat_dim,
                                        dtype, cfg.decoder_depth, generator)
    else:
        h, w, c = cfg.data_shape
        if h != w:
            raise ValueError("conv arch assumes square images")
        encoder = nets.conv_encoder_init(h, c, cfg.h_dim, dtype, generator)
        decoder = nets.conv_decoder_init(cfg.z_dim, cfg.h_dim, h, c, dtype,
                                         generator)
    params = _tree_map(lambda t: t.to(device),
                       {"encoder": encoder, "decoder": decoder})
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
    if cfg.arch == "conv":
        return nets.conv_encoder_apply(params["encoder"], x)
    flat = x.reshape(x.shape[:x.dim() - len(cfg.data_shape)]
                     + (cfg.flat_dim,))
    return nets.mlp_encoder_apply(params["encoder"], flat)


def decode(cfg: VAEConfig, params, z):
    if cfg.arch == "conv":
        return nets.conv_decoder_apply(params["decoder"], z)
    logits = nets.mlp_decoder_apply(params["decoder"], z)
    return logits.reshape(z.shape[:-1] + cfg.data_shape)


def bernoulli_log_prob(logits, x):
    """Elementwise log Bernoulli(x | sigmoid(logits)) = x l - softplus(l)."""
    return x * logits - softplus(logits)


def _sum_data_axes(a, n_data_axes: int):
    """Sum over the data axes, in float32 under bfloat16: a 784-element
    bfloat16 sum quantizes to whole numbers (4-nat steps near -700), which
    is what an IWAE estimate cannot survive."""
    return torch.sum(a, dim=tuple(range(a.dim() - n_data_axes, a.dim())),
                     dtype=acc_dtype(a.dtype))


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


def _split_noise(comps, noise):
    """Per-component slices of (..., E) product noise."""
    return torch.split(noise, [c.noise_width for c in comps], dim=-1)


def _reparam_components(cfg: VAEConfig, params, r, feats, noise=None,
                        generator=None):
    """Per-component reparameterization from encoder features: the
    concatenated latent, summed log q / log p, per-component KL and the
    curvatures. Through the fused tail where the route ``r`` takes it."""
    comps = cfg.components
    if noise is None:
        noise = tail_kernels.draw_noise(comps, feats.shape[:-1], feats,
                                        generator)
    if r.train_tail:
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


def forward(cfg: VAEConfig, params, x, noise=None, generator=None) -> Forward:
    """One reparameterized forward pass: everything ELBO/IWAE need. The
    training/eval-ELBO decode and its Bernoulli log-likelihood run in one
    kernel where the route takes B6 (logits never stored, backward = the
    four weight/input products)."""
    feats = encode(cfg, params, x)
    r = route(cfg, params)
    profiling.mark("tail", feats)
    profiling.mark_grad(feats, "bwd_encode")
    z, log_q, log_p, kls, curvs = _reparam_components(cfg, params, r, feats,
                                                      noise, generator)
    profiling.mark_grad(z, "bwd_tail")
    profiling.mark("decode", z)
    if r.train_decoder:
        dec = params["decoder"]
        xf = x.reshape(x.shape[:x.dim() - len(cfg.data_shape)]
                       + (cfg.flat_dim,))
        log_px_z = decoder_kernels.train_decode_bce(
            z, xf.to(torch.float32), dec["layers"][0]["w"],
            dec["layers"][0]["b"], dec["out"]["w"], dec["out"]["b"])
        return Forward(z, log_px_z, log_q, log_p, kls, curvs)
    logits = decode(cfg, params, z)
    log_px_z = _sum_data_axes(bernoulli_log_prob(logits, x),
                              len(cfg.data_shape))
    return Forward(z, log_px_z, log_q, log_p, kls, curvs)


def elbo(cfg: VAEConfig, params, x, beta: float = 1.0, noise=None,
         generator=None):
    """Per-example ELBO and a stats dict (single-sample MC KL)."""
    fwd = forward(cfg, params, x, noise, generator)
    profiling.mark("loss", fwd.log_px_z)
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


def loss_fn(cfg: VAEConfig, params, x, beta: float = 1.0, noise=None,
            generator=None, mesh=None):
    """The training loss -mean(ELBO) and the ELBO's stats dict.

    On a mesh (``parallel.Mesh``) ``params`` are this rank's shards and
    ``x`` / ``noise`` its rows (``parallel.shard_batch``): the sharded
    weights are gathered over "model" at use (their gradients come back
    reduce-scattered), and the whole step -- the fused tail kernels, the
    training decode -- runs on the rank's B / n_data rows, as the
    reference's tail runs per device under ``shard_map``. The loss and
    stats are the rank's means; the trainer averages the gradients over
    the mesh, which equal row counts make the global batch's gradient."""
    if mesh is not None:
        from ..parallel.collectives import gather_params
        params = gather_params(params, mesh, mesh_layout(cfg, mesh))
    value, stats = elbo(cfg, params, x, beta, noise, generator)
    return -torch.mean(value), stats


def _reparam_chunk_t(cfg: VAEConfig, params, r, feats, chunk_size: int,
                     noise=None, generator=None):
    """IWAE chunk reparam: zt (chunk, Z, B) in the decoder kernel's layout
    plus summed log q / log p (chunk, B). ``noise`` is (chunk, B, E).
    The components ``r.chunk`` sends to B5 run as one launch of it each;
    those it sends to P2 as one launch for all of them, whose sums the
    others' then join; each writes its rows of zt. The others draw per
    sample in plain PyTorch. All read the same columns of ``noise``."""
    comps, cps = cfg.components, params["components"]
    B = feats.shape[0]
    if noise is None:
        noise = tail_kernels.draw_noise(comps, (chunk_size, B), feats,
                                        generator)
    zt = torch.empty((chunk_size, cfg.z_dim, B), dtype=feats.dtype,
                     device=feats.device)
    raw_all = _fused_head_raw_cat(cfg, params, feats)
    raws = torch.split(raw_all, [c.head_width for c in comps], dim=-1)
    tiles = tuple(i for i, kind in enumerate(r.chunk) if kind == "tiles")
    log_q = log_p = 0.0
    if tiles:
        k = torch.stack([comps[i].curvature(cps[i]) for i in tiles])
        log_q, log_p = tail_kernels.reparam_chunk_t(comps, tiles, raw_all,
                                                    noise, k, zt)
    zo = 0
    for comp, cp, raw, nz, kind in zip(comps, cps, raws,
                                       _split_noise(comps, noise), r.chunk):
        if kind == "stereo":
            mu, scale, k = comp.posterior_params_from_raw(cp, raw)
            _, lq, lp = manifold_kernels.wrapped_reparam_stereo_t(
                nz, mu, scale.expand(mu.shape), k, wraps=comp.wraps,
                sign=comp.manifold.curvature_sign, out=zt, z_off=zo)
            log_q = log_q + lq
            log_p = log_p + lp
        elif kind == "plain":
            rep = reparametrize(comp, cp, feats, raw=raw, noise=nz)
            # (chunk, B, n) -> (chunk, n, B): batch contiguous for the kernel
            zt[:, zo:zo + comp.ambient_dim] = rep.z.transpose(1, 2)
            log_q = log_q + rep.log_q
            log_p = log_p + rep.log_p
        zo += comp.ambient_dim
    return zt, log_q, log_p


def _log_weights(cfg: VAEConfig, params, r, x, n_samples: int,
                 chunk_size: int, noise=None, generator=None):
    """(n_samples, B) IWAE log-weights log p(x|z_i) + log p(z_i)
    - log q(z_i|x). ``noise`` (n_samples, B, E) indexes samples globally,
    so the result does not depend on the chunking. Without the decode
    kernel, each chunk of ``chunk_size`` samples is decoded in plain
    PyTorch (the conv decoder too) against the image-shaped x."""
    fused = r.iwae_decoder
    if fused:
        # the kernel never materializes logits: the largest divisor <= 128
        # is the per-launch sample group (n = 500 -> 125 per launch)
        chunk_size = next(d for d in range(min(128, n_samples), 0, -1)
                          if n_samples % d == 0)
    if n_samples % chunk_size:
        raise ValueError("n_samples must divide into chunks")
    profiling.mark("encode", x)
    feats = encode(cfg, params, x)  # encode once for all importance samples
    xt = x.reshape(x.shape[0], cfg.flat_dim).T.contiguous() if fused else None
    ximg = x.reshape((x.shape[0],) + cfg.data_shape)
    dec = params["decoder"]
    out = []
    for c0 in range(0, n_samples, chunk_size):
        nz = None if noise is None else noise[c0:c0 + chunk_size]
        profiling.mark("reparam", feats)
        zt, log_q, log_p = _reparam_chunk_t(cfg, params, r, feats,
                                            chunk_size, nz, generator)
        profiling.mark("decode", feats)
        if fused:
            ll = decoder_kernels.fused_decode_bce_t(
                zt, xt, dec["layers"][0]["w"], dec["layers"][0]["b"],
                dec["out"]["w"], dec["out"]["b"])
        else:
            logits = decode(cfg, params, zt.transpose(1, 2))
            ll = _sum_data_axes(bernoulli_log_prob(logits, ximg),
                                len(cfg.data_shape))
        out.append(ll + log_p - log_q)
    profiling.mark("logsumexp", feats)
    # the log-weights in >= float32 (never a float64 oracle downgraded)
    log_w = torch.cat(out, dim=0)
    return log_w.to(acc_dtype(log_w.dtype))


def log_likelihood(cfg: VAEConfig, params, x, n_samples: int = 500,
                   chunk_size: int = 20, noise=None, generator=None):
    """IWAE marginal log-likelihood estimate per example:
    log p(x) ~= logsumexp_i [log p(x|z_i) + log p(z_i) - log q(z_i|x)]
    - log n."""
    log_w = _log_weights(cfg, params, route(cfg, params), x, n_samples,
                         chunk_size, noise, generator)
    out = torch.logsumexp(log_w, dim=0) - math.log(n_samples)
    profiling.mark("end", out)
    return out


def mesh_layout(cfg: VAEConfig, mesh):
    """The model's layout on ``mesh`` (``parallel.param_shardings`` of its
    whole parameters): which axis of each leaf is sharded over "model"."""
    return _mesh_layout(cfg, mesh.n_model)


@functools.lru_cache(maxsize=None)
def _mesh_layout(cfg: VAEConfig, n_model: int):
    from ..parallel.mesh import param_shardings
    shapes = init_params(cfg, device="meta")
    return param_shardings(types.SimpleNamespace(n_model=n_model), shapes)


def log_likelihood_sharded(cfg: VAEConfig, params, x, mesh,
                           n_samples: int = 500, chunk_size: int = 20,
                           noise=None, generator=None):
    """IWAE estimate on a ("data", "model") mesh, the counterpart of the
    reference's ``log_likelihood_sharded``: ``params`` are this rank's
    shards (the whole weights are gathered once a call) and ``x`` its rows
    of the batch (``parallel.shard_batch``); model rank m draws the
    importance samples [m n / M, (m + 1) n / M) of those rows through the
    same kernels as one device (B5 for wrapped d/p/u components, P2 for
    the normal, hyperboloid and vMF-s2 ones, B2 for the decode), reduces
    them to a partial logsumexp, and an all-gather over "model" finishes
    the n-sample logsumexp. Returns (rows,) log p(x).

    ``noise`` (n_samples, rows, E) is the rows' whole block, indexed by
    global sample as in ``log_likelihood``: the rank reads its samples of
    it, so the same block gives the one-device numbers. Without it the rank
    draws from ``generator``, which the caller seeds apart for each model
    index (the reference's ``fold_in(key, r)``). Requires n_samples %
    n_model == 0. Reads nothing on the host and allocates by shape only,
    so an NCCL rank captures it in a CUDA graph."""
    from ..parallel.collectives import all_gather_model, gather_params
    if n_samples % mesh.n_model:
        raise ValueError("n_samples must divide the model axis")
    if (noise is None) == (generator is None):
        raise ValueError("give the rank's noise block or its generator")
    per_rank = n_samples // mesh.n_model
    # the per-rank sample count must chunk evenly: the largest divisor
    chunk_size = next(d for d in range(min(chunk_size, per_rank), 0, -1)
                      if per_rank % d == 0)
    with torch.no_grad():
        params = gather_params(params, mesh, mesh_layout(cfg, mesh))
    if noise is not None:
        m = mesh.model_index
        noise = noise[m * per_rank:(m + 1) * per_rank]
    log_w = _log_weights(cfg, params, route(cfg, params), x, per_rank,
                         chunk_size, noise, generator)
    parts = all_gather_model(mesh, torch.logsumexp(log_w, dim=0))
    out = torch.logsumexp(parts, dim=0) - math.log(n_samples)
    profiling.mark("end", out)
    return out


def generate(cfg: VAEConfig, params, n: int, generator=None):
    """Ancestral sampling: one prior draw per component -> the decoder's
    Bernoulli means, (n, *data_shape) in [0, 1]."""
    dtype = params["components"][0]["w_mu"].dtype
    zs = [sample_prior(comp, cp, (n,), dtype, generator)
          for comp, cp in zip(cfg.components, params["components"])]
    return torch.sigmoid(decode(cfg, params, torch.cat(zs, dim=-1)))


def reconstruct(cfg: VAEConfig, params, x, noise=None, generator=None):
    """encode -> one posterior draw -> one decode: the Bernoulli means of
    x's reconstruction (no log-likelihood work)."""
    feats = encode(cfg, params, x)
    z = _reparam_components(cfg, params, route(cfg, params), feats, noise,
                            generator)[0]
    return torch.sigmoid(decode(cfg, params, z))
