"""Mixed-curvature VAE: encode / reparametrize / decode / ELBO / IWAE.

Counterpart of ``mvae_tpu/models/vae.py`` (the MLP VAE and the conv VAE
of CIFAR):

  forward:  encoder(x) -> features; one fused head GEMM for every
            component -> the product-latent tail (the CUDA tail kernels,
            forward and backward, when the product is in their family) ->
            z; decoder(z) -> Bernoulli log-likelihood (the CUDA training
            decode kernel for CUDA parameters: ``MVAE_FUSED_TRAIN_DECODER``
            "auto", as the H100 measured it, or "1");
            ELBO = log p(x|z) - sum_c KL_c; ``loss_fn`` = -mean ELBO.
  log_likelihood: IWAE-n estimate logsumexp_n[log p(x|z_i) + log p(z_i)
            - log q(z_i|x)] - log n, encoding once and drawing the
            importance samples in chunks: wrapped components on the
            stereographic kinds d/p/u through the CUDA chunk reparam
            kernel B5, a launch each, the normal, hyperboloid and vMF-s2
            components together through one launch of the CUDA chunk
            reparam kernel P2, the others in plain PyTorch; decoded by
            the CUDA decode+BCE kernel where the decoder is a depth-1 f32
            MLP and in plain PyTorch (the conv decoder at full float32)
            otherwise.

Every draw takes its standard noise as an optional tensor (the layout of
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
    return True, ("kernels csrc/tail_fwd.cu + csrc/tail_bwd.cu (plain "
                  "tail_forward_ref / tail_backward_ref on CPU tensors)")


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


def _fused_train_decoder_gate(cfg: VAEConfig, params) -> tuple[bool, str]:
    """The gate for the training decode kernel (decoder_kernels.
    train_decode_bce): the reference's env switch for the decoder weights'
    device (``use_fused_train_decoder``: "auto" is on for CUDA weights, the
    H100's own in-turns measurement, PERF.md section 6, and off for
    CPU weights), a depth-1 f32 MLP decoder, and a plan within the kernel's
    shared memory. Returns (eligible, reason); the router and
    ``fused_path_report`` both call it."""
    if not (cfg.arch == "mlp" and cfg.decoder_depth == 1):
        return False, "decoder not a depth-1 MLP -> plain PyTorch decode"
    w = params["decoder"]["out"]["w"]
    if not decoder_kernels.use_fused_train_decoder(w.device):
        return False, ("MVAE_FUSED_TRAIN_DECODER off, or 'auto' on CPU "
                       "parameters -> plain PyTorch decode")
    if w.dtype != torch.float32:
        return False, "non-f32 decoder -> plain PyTorch decode"
    if not decoder_kernels.shape_supported(cfg.z_dim, cfg.h_dim):
        return False, ("hidden tile beyond the kernel's shared memory -> "
                       "plain PyTorch decode")
    return True, ("kernel csrc/train_decode.cu (plain train_decode_ref on "
                  "CPU tensors; 'auto' is on for CUDA parameters by the "
                  "H100 measurement of PERF.md section 6)")


def _fused_train_decoder_eligible(cfg: VAEConfig, params) -> bool:
    return _fused_train_decoder_gate(cfg, params)[0]


def forward_from_features(cfg: VAEConfig, params, x, feats, noise=None,
                          generator=None) -> Forward:
    """Reparameterize + decode from precomputed encoder features. The
    training/eval-ELBO decode and its Bernoulli log-likelihood run in one
    kernel when ``_fused_train_decoder_eligible`` (logits never stored,
    backward = the four weight/input products)."""
    profiling.mark("tail", feats)
    profiling.mark_grad(feats, "bwd_encode")
    z, log_q, log_p, kls, curvs = _reparam_components(cfg, params, feats,
                                                      noise, generator)
    profiling.mark_grad(z, "bwd_tail")
    profiling.mark("decode", z)
    if _fused_train_decoder_eligible(cfg, params):
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


def forward(cfg: VAEConfig, params, x, noise=None, generator=None) -> Forward:
    """One reparameterized forward pass: everything ELBO/IWAE need."""
    feats = encode(cfg, params, x)
    return forward_from_features(cfg, params, x, feats, noise, generator)


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


def _fused_decoder_eligible(cfg: VAEConfig, params) -> bool:
    """The decode+BCE kernel covers depth-1 f32 MLP decoders whose hidden
    tile fits one block's shared memory."""
    if not (cfg.arch == "mlp" and cfg.decoder_depth == 1):
        return False
    if params["decoder"]["out"]["w"].dtype != torch.float32:
        return False
    return decoder_kernels.decode_shape_supported(cfg.z_dim, cfg.h_dim)


def _fused_reparam_eligible(comp, comp_params) -> bool:
    """The chunk reparam kernel (manifold_kernels.wrapped_reparam_stereo_t)
    covers wrapped posteriors on the kappa-stereographic family (Poincare
    ball / projected sphere / universal) in f32; other components draw in
    plain PyTorch, and the two mix freely inside one product latent."""
    return (comp.posterior == "wrapped"
            and comp.manifold.kind in ("d", "p", "u")
            and comp.dim <= manifold_kernels.MAX_DIM
            and comp_params["w_mu"].dtype == torch.float32)


def _chunk_tile_eligible(comp, comp_params) -> bool:
    """The flagship kinds' chunk reparam kernel (tail_kernels.
    reparam_chunk_t) covers the components whose tail tile runs a row on
    one thread -- normal on e, wrapped on h, vMF on s with m = 3 -- in f32;
    one launch a chunk draws all of them."""
    return (tail_kernels.chunk_supported(comp)
            and comp_params["w_mu"].dtype == torch.float32)


def _chunk_route(comp, comp_params) -> str:
    """Which draw an IWAE chunk takes for a component: "stereo" (B5, a
    launch for it), "tiles" (P2, one launch for all such components) or
    "plain" (``components.reparametrize``)."""
    if _fused_reparam_eligible(comp, comp_params):
        return "stereo"
    if _chunk_tile_eligible(comp, comp_params):
        return "tiles"
    return "plain"


def _reparam_chunk_t(cfg: VAEConfig, params, feats, chunk_size: int,
                     noise=None, generator=None):
    """IWAE chunk reparam: zt (chunk, Z, B) in the decoder kernel's layout
    plus summed log q / log p (chunk, B). ``noise`` is (chunk, B, E).
    Wrapped d/p/u components run as one launch of the chunk reparam kernel
    B5 each; the normal, hyperboloid and vMF-s2 components as one launch of
    P2 for all of them, whose sums the others' then join; each writes its
    rows of zt. The others draw per sample in plain PyTorch. All read
    the same columns of ``noise``."""
    comps, cps = cfg.components, params["components"]
    B = feats.shape[0]
    if noise is None:
        noise = tail_kernels.draw_noise(comps, (chunk_size, B), feats,
                                        generator)
    zt = torch.empty((chunk_size, cfg.z_dim, B), dtype=feats.dtype,
                     device=feats.device)
    raw_all = _fused_head_raw_cat(cfg, params, feats)
    raws = torch.split(raw_all, [c.head_width for c in comps], dim=-1)
    route = [_chunk_route(c, cp) for c, cp in zip(comps, cps)]
    tiles = tuple(i for i, r in enumerate(route) if r == "tiles")
    log_q = log_p = 0.0
    if tiles:
        k = torch.stack([comps[i].curvature(cps[i]) for i in tiles])
        log_q, log_p = tail_kernels.reparam_chunk_t(comps, tiles, raw_all,
                                                    noise, k, zt)
    zo = 0
    for comp, cp, raw, nz, r in zip(comps, cps, raws,
                                    _split_noise(comps, noise), route):
        if r == "stereo":
            mu, scale, k = comp.posterior_params_from_raw(cp, raw)
            _, lq, lp = manifold_kernels.wrapped_reparam_stereo_t(
                nz, mu, scale.expand(mu.shape), k, wraps=comp.wraps,
                sign=comp.manifold.curvature_sign, out=zt, z_off=zo)
            log_q = log_q + lq
            log_p = log_p + lp
        elif r == "plain":
            rep = reparametrize(comp, cp, feats, raw=raw, noise=nz)
            # (chunk, B, n) -> (chunk, n, B): batch contiguous for the kernel
            zt[:, zo:zo + comp.ambient_dim] = rep.z.transpose(1, 2)
            log_q = log_q + rep.log_q
            log_p = log_p + rep.log_p
        zo += comp.ambient_dim
    return zt, log_q, log_p


def _log_weights(cfg: VAEConfig, params, x, n_samples: int,
                 chunk_size: int, noise=None, generator=None):
    """(n_samples, B) IWAE log-weights log p(x|z_i) + log p(z_i)
    - log q(z_i|x). ``noise`` (n_samples, B, E) indexes samples globally,
    so the result does not depend on the chunking. Without the decode
    kernel, each chunk of ``chunk_size`` samples is decoded in plain
    PyTorch (the conv decoder too) against the image-shaped x."""
    fused = _fused_decoder_eligible(cfg, params)
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
        zt, log_q, log_p = _reparam_chunk_t(cfg, params, feats, chunk_size,
                                            nz, generator)
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
    log_w = _log_weights(cfg, params, x, n_samples, chunk_size, noise,
                         generator)
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
    log_w = _log_weights(cfg, params, x, per_rank, chunk_size, noise,
                         generator)
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
    z = _reparam_components(cfg, params, feats, noise, generator)[0]
    return torch.sigmoid(decode(cfg, params, z))


def fused_path_report(cfg: VAEConfig, params, mesh=None) -> dict:
    """Which of the port's kernels this (config, params, mesh) routes to,
    and why not when not -- from the same gate predicates the code paths
    call. Every entry is {'active': bool, 'why': str}. On a mesh every
    kernel runs on each rank's own rows."""

    def entry(active: bool, why: str) -> dict:
        return {"active": bool(active), "why": why}

    if _fused_decoder_eligible(cfg, params):
        idec = entry(True, "kernel csrc/decode_bce.cu (plain decode_bce_ref "
                     "on CPU tensors)")
    else:
        idec = entry(False, "decoder not depth-1 f32 MLP within the "
                     "kernel's shared memory -> plain PyTorch decode")
    why = {"stereo": "kernel csrc/reparam_stereo.cu (plain "
                     "wrapped_reparam_stereo_ref on CPU tensors)",
           "tiles": "kernel csrc/reparam_chunk.cu, one launch for the "
                    "chunk's normal, hyperboloid and vMF-s2 components "
                    "(plain reparam_chunk_ref on CPU tensors)"}
    reparam = []
    for i, (c, cp) in enumerate(zip(cfg.components, params["components"])):
        route = _chunk_route(c, cp)
        reparam.append(entry(True, f"{c.name}#{i}: {why[route]}")
                       if route in why else
                       entry(False, f"{c.name}#{i}: {c.posterior} on "
                             f"'{c.manifold.kind}' draws in plain PyTorch"))
    report = {"train_tail": entry(*_fused_tail_gate(cfg, params)),
              "train_decoder": entry(*_fused_train_decoder_gate(cfg, params)),
              "iwae_decoder": idec, "iwae_reparam": reparam}
    if mesh is not None:
        where = (f" (on each rank of the {mesh.n_data}x{mesh.n_model} mesh, "
                 f"over its rows)")
        for e in (report["train_tail"], report["train_decoder"],
                  report["iwae_decoder"], *report["iwae_reparam"]):
            if e["active"]:
                e["why"] += where
    return {**report,
            "routing_policy": ("capability, and the H100's own measurement "
                               "for the training decoder's 'auto' (no "
                               "TPU-measured routing)")}
