"""Which kernel each pass of the model runs.

``route(cfg, params)`` decides it in one place, from what the kernels can
hold, the parameters' dtype and device, and the switch
``MVAE_FUSED_TRAIN_DECODER``. The model's passes take their kernels from
the ``Route`` it returns (``models.vae``), the CUDA-graph cache key holds
it (``train.graphs.routing_key``), and ``report`` words it for a run's
result (``fused_paths``). No routing table is taken from the TPU: every
capable product takes the kernel.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from ..kernels import decoder_kernels, manifold_kernels, tail_kernels


@dataclasses.dataclass(frozen=True)
class Route:
    """The kernels of one (config, parameters): the training tail through
    B1 / B3 (``train_tail``), the training and ELBO decode through B6
    (``train_decoder``), the IWAE decode through B2 (``iwae_decoder``), each
    else its plain version; and each component's IWAE draw (``chunk``):
    "stereo" (B5, a launch for it), "tiles" (P2, one launch for all such
    components) or "plain" (``components.reparametrize``)."""

    train_tail: bool
    train_decoder: bool
    iwae_decoder: bool
    chunk: tuple[str, ...]


def _switch_on(device) -> bool:
    """``MVAE_FUSED_TRAIN_DECODER`` for parameters on ``device``, read at
    each call: "1" on, "0" off; "auto" (the default) on for CUDA, where B6
    trained faster than the plain decode in turns on the H100 at batch 64
    to 512 and within the turns' spread at 1024 (PERF.md section 6), and
    off otherwise."""
    v = os.environ.get("MVAE_FUSED_TRAIN_DECODER", "auto")
    if v in ("0", "1"):
        return v == "1"
    return torch.device(device).type == "cuda"


def _tail_refusal(cfg, params) -> str:
    """Why B1 / B3 do not take the training tail, or "": they take the
    whole product latent in f32 with every component in their family."""
    if any(cp["w_mu"].dtype != torch.float32 for cp in params["components"]):
        return "non-f32 head params"
    unsup = [f"{c.name}:{c.posterior}" for c in cfg.components
             if not tail_kernels.component_supported(c)]
    return "unsupported component(s): " + ",".join(unsup) if unsup else ""


def _train_decoder_refusal(cfg, params) -> str:
    """Why B6 does not take the training decode, or "": it takes a depth-1
    f32 MLP decoder within its shared memory when the switch is on."""
    if not (cfg.arch == "mlp" and cfg.decoder_depth == 1):
        return "decoder not a depth-1 MLP"
    w = params["decoder"]["out"]["w"]
    if not _switch_on(w.device):
        return "MVAE_FUSED_TRAIN_DECODER off, or 'auto' on CPU parameters"
    if w.dtype != torch.float32:
        return "non-f32 decoder"
    if not decoder_kernels.shape_supported(cfg.z_dim, cfg.h_dim):
        return "hidden tile beyond the kernel's shared memory"
    return ""


def _iwae_decoder_refusal(cfg, params) -> str:
    """Why B2 does not take the IWAE decode, or "": it takes a depth-1 f32
    MLP decoder whose hidden tile fits one block's shared memory."""
    if (cfg.arch == "mlp" and cfg.decoder_depth == 1
            and params["decoder"]["out"]["w"].dtype == torch.float32
            and decoder_kernels.decode_shape_supported(cfg.z_dim, cfg.h_dim)):
        return ""
    return "decoder not depth-1 f32 MLP within the kernel's shared memory"


# each boolean field of ``Route``: why its kernel is refused, the kernel's
# words, and its plain version's
_GATES = {
    "train_tail": (_tail_refusal, "kernels csrc/tail_fwd.cu + csrc/tail_bwd.cu"
                   " (plain tail_forward_ref / tail_backward_ref on CPU "
                   "tensors)", "plain per-component tail"),
    "train_decoder": (_train_decoder_refusal, "kernel csrc/train_decode.cu "
                      "(plain train_decode_ref on CPU tensors; 'auto' is on "
                      "for CUDA parameters by the H100 measurement of "
                      "PERF.md section 6)", "plain PyTorch decode"),
    "iwae_decoder": (_iwae_decoder_refusal, "kernel csrc/decode_bce.cu (plain "
                     "decode_bce_ref on CPU tensors)", "plain PyTorch decode")}
_CHUNK = {"stereo": "kernel csrc/reparam_stereo.cu (plain "
                    "wrapped_reparam_stereo_ref on CPU tensors)",
          "tiles": "kernel csrc/reparam_chunk.cu, one launch for the chunk's "
                   "normal, hyperboloid and vMF-s2 components (plain "
                   "reparam_chunk_ref on CPU tensors)"}


def _chunk(comp, comp_params) -> str:
    """A component's IWAE draw: B5 takes wrapped posteriors on the
    kappa-stereographic kinds (Poincare ball, projected sphere, universal),
    P2 the kinds whose tail tile runs a row on one thread (normal on e,
    wrapped on h, vMF on s with m = 3), both in f32."""
    if comp_params["w_mu"].dtype != torch.float32:
        return "plain"
    if (comp.posterior == "wrapped" and comp.manifold.kind in ("d", "p", "u")
            and comp.dim <= manifold_kernels.MAX_DIM):
        return "stereo"
    return "tiles" if tail_kernels.chunk_supported(comp) else "plain"


def route(cfg, params) -> Route:
    """The kernels ``cfg``'s passes run on ``params``."""
    return Route(**{k: not refuse(cfg, params)
                    for k, (refuse, _, _) in _GATES.items()},
                 chunk=tuple(_chunk(c, cp) for c, cp in
                             zip(cfg.components, params["components"])))


def report(cfg, params, device, mesh=None) -> dict:
    """``route(cfg, params)`` in words, and the optimizer's kernel for
    ``device``: every entry is {'active': bool, 'why': str}, the why naming
    the kernel or why the plain version runs. On a mesh every kernel runs
    on each rank's own rows."""
    r = route(cfg, params)
    rep = {k: {"active": getattr(r, k), "why": kernel if getattr(r, k) else
               f"{refuse(cfg, params)} -> {plain}"}
           for k, (refuse, kernel, plain) in _GATES.items()}
    rep["iwae_reparam"] = [
        {"active": k != "plain", "why": f"{c.name}#{i}: " + _CHUNK.get(
            k, f"{c.posterior} on '{c.manifold.kind}' draws in plain PyTorch")}
        for i, (c, k) in enumerate(zip(cfg.components, r.chunk))]
    if mesh is not None:
        for e in (*(rep[k] for k in _GATES), *rep["iwae_reparam"]):
            if e["active"]:
                e["why"] += (f" (on each rank of the {mesh.n_data}x"
                             f"{mesh.n_model} mesh, over its rows)")
    kind = torch.device(device).type
    rep["routing_policy"] = ("capability, and the H100's own measurement for "
                             "the training decoder's 'auto' (no TPU-measured "
                             "routing)")
    rep["optimizer"] = (
        {"active": True, "why": "kernel csrc/adam.cu: one launch a step over "
         "every leaf, the curvature mask and both learning rates inside"}
        if kind == "cuda" else
        {"active": False, "why": f"{kind} parameters: the kernel's plain "
         "version adam_ref (the kernel runs on CUDA tensors only)"})
    return rep
