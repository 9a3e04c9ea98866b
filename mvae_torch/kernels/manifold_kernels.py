"""The manifold kernels: the IWAE chunk reparameterization of a wrapped
normal on the kappa-stereographic family (kinds d/p/u) and the two geodesic
distances, each as one kernel launch.

Counterpart of ``mvae_tpu/kernels/manifold_kernels.py``.
``wrapped_reparam_stereo_t`` computes, for a whole chunk of importance
samples of one component (a thread per example and one or two samples,
the example's |mu|^2 and sum log sigma computed once a thread; the vectors
in registers for n = 2, 3, 6; an instantiation for each curvature sign),

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

``stereo_distance(x, y, k)`` (the gyrovector distance 2 arctan_K(|(-x)
(+)_K y|), any sign of K) and ``lorentz_distance(x, y, k)`` (the
hyperboloid distance R acosh(1 + c |y - x|_L^2 / 2)) run one launch each of
``csrc/manifold_dist.cu`` on rows of (B, n) points (replace the TPU kernels
``manifold_kernels._stereo_dist_fwd_pallas`` and
``_lorentz_dist_fwd_pallas``). Each is a ``torch.autograd.Function`` whose
backward is autograd through the library op (``ops.stereographic.distance``,
``ops.lorentz.distance``), as the reference's is: no backward kernel.
``stereo_distance_ref`` and ``lorentz_distance_ref`` are the plain
versions, the kernels' own expressions (the Gram form with its guards).
The reference's ``MVAE_PALLAS`` switch routes nothing there and is not
ported: a caller picks the kernel by calling these functions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import lorentz, stable, stereographic
from ..utils.profiling import check_outputs
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


def bind_reparam(lib, entry: str = "reparam_stereo_launch"):
    """The launch entry ``entry`` of a built ``reparam_stereo.cu`` (the
    package's, its previous design, or a variant measured beside it; each
    takes ``reparam_stereo_launch``'s arguments), typed for ctypes."""
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _lib():
    return bind_reparam(_build.load("reparam_stereo"))


def reparam_spt(S: int, B: int, n: int, sign: int) -> int:
    """The samples a thread ``csrc/reparam_stereo.cu`` takes at (S, B, n)
    and this curvature sign on the current card: 1 while a thread per point
    fits on the card at once, else 2."""
    fn = _build.load("reparam_stereo").reparam_stereo_spt
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    spt = fn(S, B, n, sign)
    if spt < 1:
        _build.check(-spt, "reparam_stereo_spt")
    return spt


def reparam_launch(fn, eps, mu, sigma, k1, out, z_off, lq, lp, sign, wraps):
    """One launch of a ``bind_reparam`` entry on CUDA tensors the caller
    has checked: eps (S, B, n) with unit stride along n and its rows
    ``eps.stride(1)`` apart, contiguous mu, sigma (B, n), k1 (1,), out
    (S, Z, B), lq and lp (S, B). No launch count: the wrapper keeps it."""
    S, B, n = eps.shape
    stream = torch.cuda.current_stream(eps.device).cuda_stream
    _build.check(fn(eps.data_ptr(), eps.stride(1), mu.data_ptr(),
                    sigma.data_ptr(), k1.data_ptr(), out.data_ptr(), z_off,
                    lq.data_ptr(), lp.data_ptr(), S, B, n, out.shape[1], sign,
                    wraps, stream), "reparam_stereo_launch")


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
    reparam_launch(_lib(), eps, mu, sigma, k1, out, z_off, lq, lp, sign,
                   wraps)
    wrapped_reparam_stereo_t.launches += 1
    check_outputs("reparam_stereo", zt, lq, lp)
    return zt, lq, lp


wrapped_reparam_stereo_t.launches = 0


# --- geodesic distances ----------------------------------------------------------


def stereo_distance_ref(x, y, k):
    """Plain PyTorch gyrovector distance of rows x, y (B, n) at curvature k
    (0-d) -> (B,): |(-x) (+)_K y|^2 from the three Gram values of a row,
    the Mobius denominator guarded at |den| < 1e-6, then
    2 sqrt(w2 + 1e-30) arctandiv(K w2)."""
    x2 = torch.sum(x * x, dim=1)
    y2 = torch.sum(y * y, dim=1)
    xy = torch.sum(x * y, dim=1)
    a = 1.0 + 2.0 * k * xy - k * y2      # coefficient of -x in the numerator
    b = 1.0 + k * x2                     # coefficient of y
    den = 1.0 + 2.0 * k * xy + k * k * x2 * y2
    den = torch.where(torch.abs(den) < 1e-6, torch.full_like(den, 1e-6), den)
    w2 = (a * a * x2 + b * b * y2 - 2.0 * a * b * xy) / (den * den)
    w2 = torch.clamp(w2, min=0.0)
    return 2.0 * torch.sqrt(w2 + 1e-30) * stable.arctandiv_u(k * w2)


def lorentz_distance_ref(x, y, k):
    """Plain PyTorch hyperboloid distance of rows x, y (B, n) at curvature k
    (0-d, negative) -> (B,): the Lorentzian square of y - x in the
    difference form sum_i d_i^2 - 2 d_0^2, then
    acosh_1p(max(c dsq / 2, 0) + 1e-30) / sqrt(c), c = max(-K, 1e-30)."""
    c = torch.clamp(-k, min=1e-30)
    d = y - x
    dsq = torch.sum(d * d, dim=1) - 2.0 * d[:, 0] * d[:, 0]
    e = torch.clamp(c * dsq / 2.0, min=0.0) + 1e-30
    return stable.acosh_1p(e) / torch.sqrt(c)


@functools.lru_cache(maxsize=None)
def _dist_lib(entry: str):
    fn = getattr(_build.load("manifold_dist"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    return fn


def _distance_forward(wrapper, entry, ref, x, y, k):
    """Checks, then one launch of ``entry`` on CUDA tensors or the plain
    version ``ref`` on CPU tensors."""
    k = torch.as_tensor(k)
    if x.dim() != 2 or x.shape != y.shape or x.shape[1] < 1:
        raise ValueError(f"x and y must be (B, n), got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    if k.numel() != 1:
        raise ValueError("k must be one curvature")
    if x.device.type == "cpu":
        return ref(x, y, k.reshape(()))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("y", y), ("k", k)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 on {x.device}")
    x, y = x.detach().contiguous(), y.detach().contiguous()
    k1 = k.detach().reshape(1)
    B, n = x.shape
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_dist_lib(entry)(x.data_ptr(), y.data_ptr(), k1.data_ptr(),
                                  out.data_ptr(), B, n, stream), entry)
    wrapper.launches += 1
    check_outputs(entry, out)
    return out


class _DistanceFn(torch.autograd.Function):
    """A distance kernel under autograd: forward the kernel (its plain
    version on CPU tensors), backward autograd through the library op."""

    @staticmethod
    def forward(ctx, wrapper, entry, ref, op, x, y, k):
        ctx.op = op
        ctx.save_for_backward(x, y, k)
        return _distance_forward(wrapper, entry, ref, x, y, k)

    @staticmethod
    def backward(ctx, g):
        x, y, k = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        with torch.enable_grad():
            args = [t.detach().requires_grad_(n)
                    for t, n in zip((x, y, k), need)]
            d = ctx.op(*args)
            wanted = [a for a, n in zip(args, need) if n]
            got = iter(torch.autograd.grad(d, wanted, g))
        return (None, None, None, None,
                *[next(got) if n else None for n in need])


def stereo_distance(x, y, k):
    """Gyrovector distance d(x, y) = 2 arctan_K(|(-x) (+)_K y|) of rows
    x, y (B, n) -> (B,), any sign of K: on CUDA tensors one launch of
    ``stereo_dist_kernel`` (``csrc/manifold_dist.cu``), on CPU tensors
    ``stereo_distance_ref``. Differentiable in x, y and k through
    ``ops.stereographic.distance``."""
    return _DistanceFn.apply(stereo_distance, "stereo_dist_launch",
                             stereo_distance_ref, stereographic.distance,
                             x, y, torch.as_tensor(k))


def lorentz_distance(x, y, k):
    """Hyperboloid distance R acosh(1 + c |y - x|_L^2 / 2) of rows x, y
    (B, n) ambient -> (B,): on CUDA tensors one launch of
    ``lorentz_dist_kernel`` (``csrc/manifold_dist.cu``), on CPU tensors
    ``lorentz_distance_ref``. Differentiable in x, y and k through
    ``ops.lorentz.distance``."""
    return _DistanceFn.apply(lorentz_distance, "lorentz_dist_launch",
                             lorentz_distance_ref, lorentz.distance,
                             x, y, torch.as_tensor(k))


stereo_distance.launches = 0
lorentz_distance.launches = 0
