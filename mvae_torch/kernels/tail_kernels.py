"""Fused forward tail of the product latent: one kernel for every component.

Counterpart of the forward half of ``mvae_tpu/kernels/tail_kernels.py``.
The ELBO forward spends its tail in dozens of tiny per-component ops on
(B, n <= 12) tensors: head activations (``exp_map_mu0`` of the mu head,
softplus scales), reparameterized draws, exact log q / log p and the
single-sample KL. ``tail_forward`` runs that whole tail for the product
latent in one launch of the CUDA kernel ``csrc/tail_fwd.cu``, which
replaces the TPU kernel ``tail_kernels._fwd_pallas``.

Families in the kernel (the whole product must be in it, see
``component_supported``): 'normal' on e, 'wrapped' on h, 'vmf' on s with
m = 3. The wrapped-sphere and stereographic tiles are a later slice.

``tail_forward_ref`` is the plain PyTorch version: the CPU path, the
tests' subject against the JAX tile, and the card check's reference.
Both evaluate the tile's own expressions in the natural (B, .) layout.

The kernel is forward only: on CUDA, ``tail_forward`` refuses inputs that
require grad (the hand-derived backward kernel is the training slice).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..components.component import draw_noise as _component_noise
from ..ops import stable
from . import _build

_LOG_2PI = 1.8378770664093453
_LOG_4PI = math.log(4.0 * math.pi)

KIND_NORMAL, KIND_WRAPPED_H, KIND_VMF_S2 = 0, 1, 2
MAX_COMPS = 16  # csrc/tail_fwd.cu MAX_COMPS
MAX_DIM = 32    # csrc/tail_fwd.cu MAX_DIM


def component_supported(comp) -> bool:
    """Static (component -> kernel capability) predicate."""
    if comp.posterior == "normal":
        return comp.dim <= MAX_DIM
    if comp.posterior == "wrapped":
        return comp.manifold.kind == "h" and comp.dim <= MAX_DIM
    if comp.posterior == "vmf":
        return comp.manifold.kind == "s" and comp.dim == 2
    return False


def _kind(comp) -> int:
    if comp.posterior == "normal":
        return KIND_NORMAL
    if comp.posterior == "vmf":
        return KIND_VMF_S2
    return KIND_WRAPPED_H


def _dims(comps):
    W = sum(c.head_width for c in comps)
    E = sum(c.noise_width for c in comps)
    Z = sum(c.ambient_dim for c in comps)
    return W, E, Z


def draw_noise(comps, shape, like: torch.Tensor, generator=None):
    """(*shape, E) standard noise for the product, components in order
    (each one's layout as in ``components.draw_noise``) -- the natural
    orientation of the reference's ``draw_noise_t``."""
    return torch.cat([_component_noise(c, shape, like, generator)
                      for c in comps], dim=-1)


# --- the plain PyTorch version ----------------------------------------------


def _rowsum(a):
    """Sum over the last axis in index order (the kernel's order), keepdim."""
    out = a[..., 0:1]
    for j in range(1, a.shape[-1]):
        out = out + a[..., j:j + 1]
    return out


def _sig(comp, raw):
    """softplus scale head, broadcast to (B, dim) for diagonal math."""
    sig = stable.softplus(raw[:, comp.dim:])
    return sig.expand(raw.shape[0], comp.dim)


def _tile_normal(comp, raw, eps):
    n = comp.dim
    mu = raw[:, :n]
    sig = _sig(comp, raw)
    z = mu + sig * eps
    ls = torch.log(sig)
    lq = _rowsum(-0.5 * (eps * eps + _LOG_2PI) - ls)
    lp = _rowsum(-0.5 * (z * z + _LOG_2PI))
    kl = 0.5 * _rowsum(sig * sig + mu * mu - 1.0 - 2.0 * ls)
    return z, kl, lq, lp


def _tile_wrapped_lorentz(comp, raw, eps, k):
    """Wrapped normal on the hyperboloid (K < 0 pinned): exp_mu0 is
    injective, so log q is evaluated at the drawn tangent v itself."""
    n = comp.dim
    tin = stable.tiny(raw.dtype)
    c = torch.clamp(-k, min=tin)
    inv_sqrt_c = torch.rsqrt(c)
    mu_tan = raw[:, :n]
    sig = _sig(comp, raw)

    # mu = exp_map_mu0(mu_tan); project() recomputes the time coordinate
    r2m = _rowsum(mu_tan * mu_tan)
    mu_sp = stable._sindiv_u_kernel(k * r2m) * mu_tan
    sp2 = _rowsum(mu_sp * mu_sp)
    mu_t = torch.sqrt(1.0 / c + sp2)

    v = sig * eps
    # PT_{mu0->mu}((0, v)) with e = alpha - 1 in the difference form
    d_t = mu_t - inv_sqrt_c
    e_a = torch.clamp(c * (sp2 - d_t * d_t), min=0.0) / 2.0
    sv = _rowsum(mu_sp * v)
    coef = c * sv / (2.0 + e_a)
    u_t = coef * (inv_sqrt_c + mu_t)
    u_sp = v + coef * mu_sp
    # z = exp_map(mu, u), theta^2-argument t = -c <u,u>_L
    usq = torch.clamp(_rowsum(u_sp * u_sp) - u_t * u_t, min=0.0)
    tt = -c * usq
    cu = stable._cos_u_sgn(tt, -1)
    sd = stable._sindiv_u_kernel(tt)
    z_sp = cu * mu_sp + sd * u_sp
    zsp2 = _rowsum(z_sp * z_sp)
    z_t = torch.sqrt(1.0 / c + zsp2)

    rv2 = _rowsum(v * v)
    lq = (_rowsum(-0.5 * (eps * eps + _LOG_2PI) - torch.log(sig))
          - (n - 1.0) * stable._log_sindiv_u_sgn(k * rv2, -1))
    # log p: radius r0 = d(mu0, z) via the stable acosh_1p difference form
    dz_t = z_t - inv_sqrt_c
    e0 = torch.clamp(c * (zsp2 - dz_t * dz_t), min=0.0) / 2.0 + tin
    r0 = stable._acosh_1p(e0) * inv_sqrt_c
    r02 = r0 * r0
    lp = (-0.5 * r02 - 0.5 * n * _LOG_2PI
          - (n - 1.0) * stable._log_sindiv_u_sgn(k * r02, -1))
    return torch.cat([z_t, z_sp], dim=1), lq - lp, lq, lp


def _tile_vmf(comp, raw, eps, k):
    """vMF(mu, kappa) on S^2 (m = 3): inverse-CDF cosine, Householder
    reflection to mu, closed-form log C_3 and A_3, analytic KL."""
    n = comp.dim
    m = n + 1
    if m != 3:
        raise ValueError("the fused vMF tile is m = 3 only")
    dt = raw.dtype
    tin = stable.tiny(dt)
    e = stable.eps(dt)
    kk = torch.clamp(k, min=tin)
    sqrt_k = torch.sqrt(kk)
    r = 1.0 / sqrt_k
    mu_tan = raw[:, :n]
    kap = stable.softplus(raw[:, n:n + 1]) + 1.0

    # mu = exp_map_mu0 on the sphere; project() renormalizes to radius R
    r2m = _rowsum(mu_tan * mu_tan)
    t_m = kk * r2m
    m_t = stable._cos_u_sgn(t_m, 1) * r
    m_sp = stable._sindiv_u_kernel(t_m) * mu_tan
    mnorm = torch.sqrt(m_t * m_t + _rowsum(m_sp * m_sp) + tin)
    scale = r / mnorm
    mu_u_t = m_t * scale * sqrt_k
    mu_u_sp = m_sp * scale * sqrt_k

    # cosine via the exact inverse CDF
    u_eps = eps[:, 0:1]
    kap_s = torch.clamp(kap, min=1e-6)
    w = 1.0 + torch.log1p((1.0 - u_eps)
                          * (torch.exp(-2.0 * kap_s) - 1.0)) / kap_s
    w = torch.clamp(w, -1.0 + 1e-7, 1.0 - 1e-7)
    g = eps[:, 1:3]
    gn = torch.sqrt(_rowsum(g * g) + tin)
    sin_w = torch.sqrt(torch.clamp(1.0 - w * w, min=tin))
    zp_sp = sin_w * (g / gn)

    # Householder e1 -> mu_unit (degenerate at mu ~ e1 -> identity)
    uh_t = 1.0 - mu_u_t
    uh_sp = -mu_u_sp
    un = torch.sqrt(uh_t * uh_t + _rowsum(uh_sp * uh_sp) + tin)
    inv_un = 1.0 / torch.clamp(un, min=e)
    uht = uh_t * inv_un
    uhs = uh_sp * inv_un
    dotu = uht * w + _rowsum(uhs * zp_sp)
    zu_t = w - 2.0 * dotu * uht
    zu_sp = zp_sp - 2.0 * dotu * uhs
    deg = un < e
    zu_t = torch.where(deg, w, zu_t)
    zu_sp = torch.where(deg, zp_sp, zu_sp)
    z = torch.cat([zu_t * r, zu_sp * r], dim=1)

    # log C_3(kappa) with log I_{1/2}(x) e^{-x}
    #   = 0.5 log(2/(pi x)) + log1p(-e^{-2x}) - log 2
    log_ive_nu = (0.5 * torch.log(2.0 / (math.pi * kap))
                  + torch.log1p(-torch.exp(-2.0 * kap)) - math.log(2.0))
    a_m = 1.0 / torch.tanh(kap) - 1.0 / kap
    log_cm = ((m / 2.0 - 1.0) * torch.log(kap) - (m / 2.0) * _LOG_2PI
              - (log_ive_nu + kap))
    cos = mu_u_t * zu_t + _rowsum(mu_u_sp * zu_sp)
    area = (m - 1) / 2.0 * torch.log(kk)
    lq = log_cm + kap * cos + area
    lp = (-_LOG_4PI + area).expand_as(lq)
    kl = kap * a_m + log_cm + _LOG_4PI
    return z, kl, lq, lp


def tail_forward_ref(comps, raw, eps, k):
    """Plain PyTorch tail: raw (B, W) head pre-activations, eps (B, E)
    standard noise, k (nc,) curvatures -> (z (B, Z), aux (B, nc + 2) =
    [KL per component, sum log q, sum log p])."""
    zs, kls = [], []
    lq = lp = 0.0
    ro = eo = 0
    for i, comp in enumerate(comps):
        r = raw[:, ro:ro + comp.head_width]
        ro += comp.head_width
        e = eps[:, eo:eo + comp.noise_width]
        eo += comp.noise_width
        if comp.posterior == "normal":
            z, kl, q, p = _tile_normal(comp, r, e)
        elif comp.posterior == "vmf":
            z, kl, q, p = _tile_vmf(comp, r, e, k[i])
        else:
            z, kl, q, p = _tile_wrapped_lorentz(comp, r, e, k[i])
        zs.append(z)
        kls.append(kl)
        lq = lq + q
        lp = lp + p
    return torch.cat(zs, dim=1), torch.cat(kls + [lq, lp], dim=1)


# --- the kernel wrapper -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _table(comps):
    """The kernel's component table: (kind, dim, n_scale, raw offset, eps
    offset, z offset) per component."""
    rows, ro, eo, zo = [], 0, 0, 0
    for c in comps:
        rows += [_kind(c), c.dim, c.n_scale, ro, eo, zo]
        ro += c.head_width
        eo += c.noise_width
        zo += c.ambient_dim
    return (ctypes.c_int * len(rows))(*rows)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("tail_fwd").tail_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_void_p])
    return fn


def tail_forward(comps, raw, eps, k):
    """The fused tail: on a CUDA tensor one launch of ``csrc/tail_fwd.cu``;
    on a CPU tensor its plain version ``tail_forward_ref``. Same arguments
    and results as ``tail_forward_ref``."""
    comps = tuple(comps)
    W, E, Z = _dims(comps)
    nc = len(comps)
    if raw.dim() != 2 or raw.shape[1] != W:
        raise ValueError(f"raw must be (B, {W}), got {tuple(raw.shape)}")
    B = raw.shape[0]
    if tuple(eps.shape) != (B, E) or tuple(k.shape) != (nc,):
        raise ValueError(f"eps must be ({B}, {E}) and k ({nc},), got "
                         f"{tuple(eps.shape)} and {tuple(k.shape)}")
    if not all(component_supported(c) for c in comps):
        raise ValueError("product has a component outside the kernel family")
    if raw.device.type == "cpu":
        return tail_forward_ref(comps, raw, eps, k)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    if any(t.requires_grad for t in (raw, eps, k)):
        raise RuntimeError("tail_forward is forward only on CUDA; its "
                           "backward kernel is not ported yet")
    for name, t in (("raw", raw), ("eps", eps), ("k", k)):
        if t.dtype != torch.float32 or t.device != raw.device:
            raise ValueError(f"{name} must be float32 on {raw.device}")
    if nc > MAX_COMPS:
        raise ValueError(f"at most {MAX_COMPS} components")
    raw, eps, k = raw.contiguous(), eps.contiguous(), k.contiguous()
    z = torch.empty((B, Z), dtype=torch.float32, device=raw.device)
    aux = torch.empty((B, nc + 2), dtype=torch.float32, device=raw.device)
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    _build.check(_lib()(raw.data_ptr(), eps.data_ptr(), k.data_ptr(),
                        z.data_ptr(), aux.data_ptr(), B, W, E, Z, nc,
                        _table(comps), stream), "tail_fwd_launch")
    tail_forward.launches += 1
    return z, aux


tail_forward.launches = 0


def reparam_all(comps, comp_params, raw_all, noise=None, generator=None):
    """Full product-latent reparameterization from the fused head GEMM
    output (B, W) through ``tail_forward``. ``noise`` (B, E) in the
    ``draw_noise`` layout; drawn from ``generator`` when not given.
    Returns (z (B, Z), log_q (B,), log_p (B,), kl (B, nc), curvatures)."""
    comps = tuple(comps)
    B = raw_all.shape[0]
    kvec = torch.stack([c.curvature(cp)
                        for c, cp in zip(comps, comp_params)]).to(raw_all.dtype)
    if noise is None:
        noise = draw_noise(comps, (B,), raw_all, generator)
    z, aux = tail_forward(comps, raw_all, noise, kvec)
    nc = len(comps)
    return z, aux[:, nc], aux[:, nc + 1], aux[:, :nc], kvec
