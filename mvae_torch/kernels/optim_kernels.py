"""The optimizer kernel: Adam over every leaf of a model in one launch, the
curvature mask, both learning rates, the moments, the bias corrections and
the two step counters inside.

It replaces no TPU kernel: the reference's optimizer is optax's Adam,
which XLA fuses into its step's program. On the card it replaces
``torch.optim.Adam`` (foreach, capturable) and the mask launches before it,
~80 small kernels a step, with one launch of ``csrc/adam.cu``, bound by its
bytes: p, g, m and v read and p, m and v written, 28 bytes a float32
parameter, 5.3 us at 3.35 TB/s for the flagship's 636,397.

``adam(...)`` runs one step over a list of at most ``MAX_LEAVES`` leaves:
on CUDA tensors the kernel (the table of leaves in the launch's parameters,
so a CUDA graph captures it whole), counted on ``adam.launches``; on CPU
tensors its plain version ``adam_ref``; on any other device, or over more
leaves, it raises. Both compute in
float32 (the plain version float64 parameters in float64) and store p, m
and v in the parameters' type, each rounded once. The arithmetic is
``torch.optim.Adam``'s, its count on the device as in its capturable path;
the step size ``lr / (1 - b1^t)`` and ``sqrt(1 - b2^t)`` are taken in
float64 and rounded once, as its CPU path and optax in float64 take them
(its capturable path takes them in float32, where 1 - 0.999 alone is
1.3e-5 off).

``masked_grad`` is the curvature mask the step applies: the reference's
``_mask_curvature_grads``, a learnable curvature's gradient multiplied by
``step_t >= burnin`` (masked, not dropped: Adam counts every step, as
optax does), a fixed curvature's and an absent gradient zero.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# a leaf's kind: what the mask does to its gradient
PLAIN, CURVATURE, FIXED = 0, 1, 2
# the leaves one launch takes (csrc/adam.cu's ADAM_MAX_LEAVES); the port's
# widest model, the conv VAE of three components, has 29
MAX_LEAVES = 48


class _Leaf(ctypes.Structure):
    """``csrc/adam.cu``'s ``AdamLeafIn``."""
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("lr", ctypes.c_double),
                ("kind", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("adam")
    fn = lib.adam_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_double] * 3 + [ctypes.c_void_p])
    return fn


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type Adam computes in for parameters of ``dtype``: float32,
    float64 for float64 parameters (a CPU run of the plain version)."""
    return torch.promote_types(dtype, torch.float32)


def masked_grad(p, g, kind: int, unfrozen):
    """The gradient Adam takes for leaf ``p`` of ``kind``, in its compute
    type: ``g`` (a plain leaf), ``g`` times ``unfrozen`` (a learnable
    curvature; ``unfrozen`` the 0-d ``step_t >= burnin``, so an infinite
    gradient turns nan in burn-in, as the reference's does), or zeros (a
    fixed curvature, or no gradient)."""
    dtype = _compute_dtype(p.dtype)
    if g is None or kind == FIXED:
        return torch.zeros_like(p, dtype=dtype)
    g = g.to(dtype)
    if kind == CURVATURE:
        return g * unfrozen.to(dtype)
    return g


@torch.no_grad()
def adam_ref(params, grads, exp_avgs, exp_avg_sqs, kinds, lrs, count,
             step_t, burnin: int, betas, eps: float) -> None:
    """One Adam step in plain PyTorch, in place: ``params``, ``grads``
    (None: no gradient), ``exp_avgs`` and ``exp_avg_sqs`` leaf by leaf,
    ``kinds`` and ``lrs`` (floats) a leaf; ``count`` Adam's step count
    (0-d float32) and ``step_t`` the global step (0-d int64) the mask
    reads, both advanced by one. ``csrc/adam.cu``'s expressions, one op
    each, in ``_compute_dtype`` (float32 for the kernel's types); reads
    nothing on the host."""
    b1, b2 = betas
    dtype = _compute_dtype(params[0].dtype)
    t = (count + 1).double()
    bc1 = 1 - torch.pow(b1, t)
    bc2_sqrt = torch.sqrt(1 - torch.pow(b2, t)).to(dtype)
    unfrozen = step_t >= burnin
    for p, g, m, v, kind, lr in zip(params, grads, exp_avgs, exp_avg_sqs,
                                    kinds, lrs):
        g = masked_grad(p, g, kind, unfrozen)
        m_new = torch.lerp(m.to(dtype), g, 1 - b1)
        v_new = v.to(dtype) * b2 + (1 - b2) * g * g
        denom = torch.sqrt(v_new) / bc2_sqrt + eps
        step_size = (torch.full_like(bc1, lr) / bc1).to(dtype)
        p.copy_(p.to(dtype) - step_size * m_new / denom)
        m.copy_(m_new)
        v.copy_(v_new)
    count += 1
    step_t += 1


def _check(params, grads, exp_avgs, exp_avg_sqs, kinds, lrs, count, step_t,
           ticket) -> None:
    dev, dtype = params[0].device, params[0].dtype
    kinds_of_type = ((torch.float32, torch.bfloat16) if dev.type == "cuda"
                     else (torch.float32, torch.bfloat16, torch.float64))
    if dtype not in kinds_of_type:
        raise ValueError(f"adam: parameters of {kinds_of_type} on {dev}, "
                         f"got {dtype}")
    if not (len(params) == len(grads) == len(exp_avgs) == len(exp_avg_sqs)
            == len(kinds) == len(lrs)):
        raise ValueError("adam: one gradient, moment pair, kind and "
                         "learning rate a leaf")
    if len(params) > MAX_LEAVES:
        raise ValueError(f"adam: at most {MAX_LEAVES} leaves, got "
                         f"{len(params)}")
    for p, g, m, v, kind in zip(params, grads, exp_avgs, exp_avg_sqs, kinds):
        for t in (p, m, v) + (() if g is None else (g,)):
            if (t.device != dev or t.dtype != dtype or t.shape != p.shape
                    or not t.is_contiguous()):
                raise ValueError(f"adam: every leaf's p, g, m and v "
                                 f"contiguous {dtype} of one shape on {dev}")
        if kind not in (PLAIN, CURVATURE, FIXED) or p.numel() == 0:
            raise ValueError(f"adam: kind {kind} of a leaf of "
                             f"{p.numel()} elements")
    for name, t, want in (("count", count, torch.float32),
                          ("step_t", step_t, torch.int64),
                          ("ticket", ticket, torch.int32)):
        if t.device != dev or t.dtype != want or t.numel() != 1:
            raise ValueError(f"adam: {name} one {want} on {dev}")


def adam(params, grads, exp_avgs, exp_avg_sqs, kinds, lrs, count, step_t,
         ticket, burnin: int, betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam step over every leaf, in place (``adam_ref``'s arguments;
    ``ticket`` a 0-d int32 zero on the device that the kernel's blocks
    count on and leave at zero). On CUDA tensors one launch of
    ``csrc/adam.cu``; on CPU tensors ``adam_ref``."""
    dev = params[0].device
    _check(params, grads, exp_avgs, exp_avg_sqs, kinds, lrs, count, step_t,
           ticket)
    if dev.type == "cpu":
        adam_ref(params, grads, exp_avgs, exp_avg_sqs, kinds, lrs, count,
                 step_t, burnin, betas, eps)
        return
    if dev.type != "cuda":
        raise ValueError(f"adam: unsupported device {dev}")
    table = (_Leaf * len(params))(*[
        _Leaf(p.data_ptr(), None if g is None else g.data_ptr(),
              m.data_ptr(), v.data_ptr(), p.numel(), lr, kind)
        for p, g, m, v, kind, lr in zip(params, grads, exp_avgs, exp_avg_sqs,
                                        kinds, lrs)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_lib()(ctypes.addressof(table), len(params),
                        int(params[0].dtype == torch.bfloat16),
                        count.data_ptr(), step_t.data_ptr(),
                        ticket.data_ptr(), burnin, betas[0], betas[1], eps,
                        stream), "adam_launch")
    adam.launches += 1


adam.launches = 0
