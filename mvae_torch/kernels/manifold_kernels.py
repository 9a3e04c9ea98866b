"""IWAE chunk reparameterization of a wrapped normal on the
kappa-stereographic family (kinds d/p/u), as one kernel launch.

Counterpart of ``mvae_tpu/kernels/manifold_kernels.py`` (the reparam
kernel; the opt-in distance kernels are not ported yet).
``wrapped_reparam_stereo_t`` computes, for a whole chunk of importance
samples of one component,

    z    = mu (+)_K exp_0(sigma * eps)
    logq = WrappedNormal(mu, sigma).log_prob(z)   (drawn-radius branch sum)
    logp = WrappedNormal(mu0, 1).log_prob(z)      (the IWAE prior term)

in one launch of the CUDA kernel ``csrc/reparam_stereo.cu`` (replaces the
TPU kernel ``manifold_kernels.wrapped_reparam_stereo_t``), writing z
straight into the (S, Z, B) buffer the IWAE decode kernel reads. The mu
head and the sigma cap are applied before, in
``Component.posterior_params_from_raw``. Forward only: the IWAE estimate
has no backward.

``wrapped_reparam_stereo_ref`` is the plain PyTorch version: the CPU path,
the tests' subject against the JAX kernel and its oracle, and the card
check's reference. It evaluates the kernel's own expressions
(``tail_kernels._stereo_draw``, which the fused tail's stereographic tile
shares), not the library composition ``sample_projection_mu0`` +
``_sample_log_prob_drawn`` + ``log_prob_mu0``: the two agree in exact
arithmetic but round differently near the K > 0 antipode, and the tests
hold one to the other at the tolerance the reference states for its own
kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .tail_kernels import MAX_DIM, _stereo_draw


def wrapped_reparam_stereo_ref(eps, mu, sigma, k, wraps: int = 1,
                               sign: int = 0):
    """Plain PyTorch reparam: eps (S, B, n) standard-normal draws, mu and
    sigma (B, n), k a 0-d curvature, ``sign`` the kind's static curvature
    sign (-1 'd', +1 'p', 0 'u') -> (zt (S, n, B), log q (S, B),
    log p (S, B))."""
    z, lq, lp = _stereo_draw(sign, wraps, k, mu, sigma, eps)
    return z.transpose(1, 2), lq[..., 0], lp[..., 0]


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("reparam_stereo").reparam_stereo_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    return fn


def wrapped_reparam_stereo_t(eps, mu, sigma, k, wraps: int = 1,
                             sign: int = 0, out=None, z_off: int = 0):
    """The chunk reparam: on CUDA tensors one launch of
    ``csrc/reparam_stereo.cu``; on CPU tensors its plain version
    ``wrapped_reparam_stereo_ref``. Arguments and results as there; eps may
    be a view of a wider (S, B, E) noise block (unit stride along n).
    With ``out`` (S, Z, B), z is written into its rows
    ``z_off : z_off + n`` and that view is returned as zt."""
    if eps.dim() != 3:
        raise ValueError(f"eps must be (S, B, n), got {tuple(eps.shape)}")
    S, B, n = eps.shape
    k = torch.as_tensor(k)
    if tuple(mu.shape) != (B, n) or tuple(sigma.shape) != (B, n):
        raise ValueError(f"mu and sigma must be ({B}, {n}), got "
                         f"{tuple(mu.shape)} and {tuple(sigma.shape)}")
    if k.numel() != 1:
        raise ValueError("k must be one curvature")
    if n > MAX_DIM or sign not in (-1, 0, 1) or wraps < 0:
        raise ValueError(f"needs n <= {MAX_DIM}, sign in -1/0/1 and "
                         f"wraps >= 0, got n={n}, sign={sign}, wraps={wraps}")
    if out is None:
        out = torch.empty((S, n, B), dtype=eps.dtype, device=eps.device)
        z_off = 0
    Z = out.shape[1] if out.dim() == 3 else -1
    if (tuple(out.shape) != (S, Z, B) or not 0 <= z_off <= Z - n
            or not out.is_contiguous() or out.dtype != eps.dtype
            or out.device != eps.device):
        raise ValueError(f"out must be a contiguous ({S}, Z, {B}) buffer "
                         f"with Z >= z_off + {n}, of eps's type and device")
    zt = out[:, z_off:z_off + n]
    if eps.device.type == "cpu":
        z, lq, lp = wrapped_reparam_stereo_ref(eps, mu, sigma, k.reshape(()),
                                               wraps, sign)
        zt.copy_(z)
        return zt, lq, lp
    if eps.device.type != "cuda":
        raise ValueError(f"unsupported device {eps.device}")
    for name, t in (("eps", eps), ("mu", mu), ("sigma", sigma), ("k", k)):
        if t.dtype != torch.float32 or t.device != eps.device:
            raise ValueError(f"{name} must be float32 on {eps.device}")
    if eps.stride(2) != 1 or eps.stride(0) != B * eps.stride(1):
        eps = eps.contiguous()
    mu, sigma = mu.detach().contiguous(), sigma.detach().contiguous()
    k1 = k.detach().reshape(1)
    lq = torch.empty((S, B), dtype=torch.float32, device=eps.device)
    lp = torch.empty((S, B), dtype=torch.float32, device=eps.device)
    stream = torch.cuda.current_stream(eps.device).cuda_stream
    _build.check(_lib()(eps.data_ptr(), eps.stride(1), mu.data_ptr(),
                        sigma.data_ptr(), k1.data_ptr(), out.data_ptr(),
                        z_off, lq.data_ptr(), lp.data_ptr(), S, B, n, Z,
                        sign, wraps, stream), "reparam_stereo_launch")
    wrapped_reparam_stereo_t.launches += 1
    return zt, lq, lp


wrapped_reparam_stereo_t.launches = 0
