"""Fused tail of the product latent: one forward and one backward kernel.

Counterpart of ``mvae_tpu/kernels/tail_kernels.py``. The ELBO forward
spends its tail in dozens of tiny per-component ops on (B, n <= 12)
tensors: head activations (``exp_map_mu0`` of the mu head, softplus
scales), reparameterized draws, exact log q / log p and the single-sample
KL. ``tail_forward`` runs that whole tail for the product latent in one
launch of the CUDA kernel ``csrc/tail_fwd.cu`` (replaces the TPU kernel
``tail_kernels._fwd_pallas``); ``tail_backward`` runs its vector-Jacobian
product with respect to the raw heads and the curvatures in one launch of
``csrc/tail_bwd.cu`` (replaces ``tail_kernels._bwd_pallas``). ``_TailFn``
wires the two into autograd; the noise gets no gradient.

Families in the kernels (the whole product must be in them, see
``component_supported``): 'normal' on e, 'wrapped' on h, on the
stereographic kinds d/p/u and on the embedded sphere s (sigma cap,
drawn-radius branch sum and prior wrap pair in the tile), 'vmf' on s with
m = 3. The vMF with m != 3 draws its cosine by rejection and takes the
plain per-component tail, as does an uncapped positive-curvature wrapped
component.

``reparam_chunk_t`` draws an IWAE chunk of importance samples for the
components of those kinds the one-row tiles cover (normal on e, wrapped
on h, vMF on s2) in one launch of ``csrc/reparam_chunk.cu``: the tiles
on a thread a (sample, example) point, z written into the (S, Z, B)
buffer the IWAE decode kernel reads. Its plain version
``reparam_chunk_ref`` is ``tail_forward_ref`` on the rows with the heads
repeated over the samples.

``tail_forward_ref`` is the plain PyTorch forward: the CPU path, the
tests' subject against the JAX tile, and the card check's reference.
Both evaluate the tile's own expressions in the natural (B, .) layout.
``tail_backward_ref`` is the plain backward: ``torch.autograd.grad``
through ``tail_forward_ref``, whose conventions the hand-derived CUDA
backward follows (a clamp passes the whole gradient at a tie, each branch
of a series window is differentiated as written).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..components.component import cap_sigma_positive_k
from ..components.component import draw_noise as _component_noise
from ..ops import stable
from ..utils.profiling import check_outputs
from . import _build

_LOG_2PI = 1.8378770664093453
_LOG_4PI = math.log(4.0 * math.pi)

KIND_NORMAL, KIND_WRAPPED_H, KIND_VMF_S2, KIND_WRAPPED_STEREO = 0, 1, 2, 3
KIND_WRAPPED_S = 4
MAX_COMPS = 16  # csrc/tail_tiles.cuh MAX_COMPS
MAX_DIM = 32    # csrc/tail_tiles.cuh MAX_DIM


def component_supported(comp) -> bool:
    """Static (component -> kernel capability) predicate."""
    if comp.posterior == "normal":
        return comp.dim <= MAX_DIM
    if comp.posterior == "wrapped":
        kind = comp.manifold.kind
        if (comp.manifold.curvature_sign >= 0 and kind != "e"
                and not comp.sigma_cap):
            return False  # the tile bakes the sigma cap in; an uncapped
            # positive-capable component takes the plain tail
        return kind in ("h", "d", "p", "u", "s") and comp.dim <= MAX_DIM
    if comp.posterior == "vmf":
        return comp.manifold.kind == "s" and comp.dim == 2
    return False


def chunk_supported(comp) -> bool:
    """Whether the IWAE chunk reparam kernel (``reparam_chunk_t``) draws
    this component: the tail's kinds whose tile runs a row on one thread
    (normal on e, wrapped on h, vMF on s with m = 3)."""
    return (component_supported(comp)
            and _kind(comp) in (KIND_NORMAL, KIND_WRAPPED_H, KIND_VMF_S2))


def component_split(comp) -> bool:
    """Whether the tail kernels run this component's rows split over a
    row's threads (``csrc/tail_grid.cuh``: the stereographic and wrapped
    embedded-sphere tiles)."""
    return _kind(comp) in (KIND_WRAPPED_STEREO, KIND_WRAPPED_S)


def _kind(comp) -> int:
    if comp.posterior == "normal":
        return KIND_NORMAL
    if comp.posterior == "vmf":
        return KIND_VMF_S2
    if comp.manifold.kind == "h":
        return KIND_WRAPPED_H
    if comp.manifold.kind == "s":
        return KIND_WRAPPED_S
    return KIND_WRAPPED_STEREO


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


def _tile_wrapped_sphere(comp, raw, eps, k):
    """Wrapped normal on the embedded sphere S^n (K > 0 pinned; the chord
    forms of ``ops/sphere.py``): exp_map_mu0 mean head, the capped scale,
    parallel transport mu0 -> mu with its norm pinned to |v|, exp at mu with
    the renormalizing projection; log q by the drawn-radius branch sum and
    log p at the chord-form arcsin distance from mu0, both through the
    helpers the stereographic tile evaluates."""
    n = comp.dim
    tin = stable.tiny(raw.dtype)
    e = stable.eps(raw.dtype)
    kk = torch.clamp(k, min=tin)
    sqrt_k = torch.sqrt(kk)
    r_rad = 1.0 / sqrt_k
    mu_tan = raw[:, :n]
    sig = cap_sigma_positive_k(_sig(comp, raw), k)

    # mu = exp_map_mu0(mu_tan); project() renormalizes to radius R
    r2m = _rowsum(mu_tan * mu_tan)
    t_m = kk * r2m
    m_t = stable._cos_u_sgn(t_m, 1) * r_rad
    m_sp = stable._sindiv_u_kernel(t_m) * mu_tan
    sp2_m = _rowsum(m_sp * m_sp)
    mnorm = torch.sqrt(m_t * m_t + sp2_m + tin)
    sc = r_rad / mnorm
    mu_t = m_t * sc
    mu_sp = m_sp * sc
    sp2 = sp2_m * sc * sc

    v = sig * eps
    vsq = _rowsum(v * v)
    s2 = _rowsum(eps * eps)
    ls = _rowsum(torch.log(torch.clamp(sig, min=tin)))

    # PT_{mu0->mu}((0, v)): chord-form alpha, norm pinned to |v|
    d_t = mu_t - r_rad
    chord2 = d_t * d_t + sp2
    alpha = 1.0 - kk * chord2 / 2.0
    den = torch.clamp(1.0 + alpha, min=e)
    coef = kk * _rowsum(mu_sp * v) / den
    w_t = -coef * (r_rad + mu_t)
    w_sp = v - coef * mu_sp
    nv = torch.sqrt(vsq + tin)
    nw = torch.sqrt(w_t * w_t + _rowsum(w_sp * w_sp) + tin)
    pin = nv / nw
    u_t = w_t * pin
    u_sp = w_sp * pin

    # z = exp_map(mu, u); project() renormalizes
    usq = u_t * u_t + _rowsum(u_sp * u_sp)
    tt = kk * usq
    cu = stable._cos_u_sgn(tt, 1)
    sd = stable._sindiv_u_kernel(tt)
    z_t = cu * mu_t + sd * u_t
    z_sp = cu * mu_sp + sd * u_sp
    zn = torch.sqrt(z_t * z_t + _rowsum(z_sp * z_sp) + tin)
    zsc = r_rad / zn
    z_t = z_t * zsc
    z_sp = z_sp * zsc

    logq = _logq_drawn_rows(n, comp.wraps, 1, kk, vsq, s2, ls)

    # log p: r0 = 2R asin(|z - mu0| / 2R), the chord form of sphere.distance
    dz_t = z_t - r_rad
    chord0 = dz_t * dz_t + _rowsum(z_sp * z_sp)
    half = torch.sqrt(chord0 + tin) / 2.0
    half = torch.clamp(half, max=(1.0 - e) * r_rad)
    r0 = 2.0 * half * stable._arcsindiv_u_pos(kk * half * half)
    logp = _logp_prior_rows(n, comp.wraps, 1, kk, r0)
    return torch.cat([z_t, z_sp], dim=1), logq - logp, logq, logp


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


def _ball_scale(k, smax, xn2, tin):
    """The factor of ``stereographic.project``: pulls a K < 0 point of
    squared norm xn2 inside the open ball of radius smax; 1 for K >= 0."""
    inside = torch.clamp(smax * torch.rsqrt(torch.clamp(xn2, min=tin)),
                         max=1.0)
    return torch.where(k < 0, inside, torch.ones_like(inside))


def _logsumexp_terms(terms):
    """log sum exp over a list of terms, shifted by their largest (a
    constant of the gradient, which is each term's softmax weight)."""
    mx = terms[0]
    for t in terms[1:]:
        mx = torch.maximum(mx, t)
    mx = mx.detach()
    acc = torch.zeros_like(mx)
    for t in terms:
        acc = acc + torch.exp(t - mx)
    return mx + torch.log(acc)


def _dead(like):
    return torch.full_like(like, -1e30)


def _logq_drawn_rows(n, wraps, sign, k, vsq, s2, ls):
    """Drawn-radius branch-sum log q on (..., 1) rows: the twin of
    ``distributions.wrapped_normal._sample_log_prob_drawn`` without a round
    trip (r^2 quad == |eps|^2 exactly). Shared by the stereographic tile
    and the IWAE chunk reparam, so both evaluate the same expressions."""
    tin = stable.tiny(vsq.dtype)
    vsq_g = vsq + tin
    r = torch.sqrt(vsq_g)
    quad = s2 / vsq_g
    half_l2pi = 0.5 * n * _LOG_2PI

    if sign < 0:
        # pinned negative curvature never wraps: principal preimage = v
        return (-0.5 * s2 - ls - half_l2pi
                - (n - 1.0) * stable._log_sindiv_u_sgn_soft(k * vsq_g, sign))
    kpos = torch.clamp(k, min=1e-20)
    sqk = torch.sqrt(kpos)
    period = 2.0 * math.pi / sqk
    rp_w = torch.abs(r - period * torch.floor(r / period + 0.5))
    rp = rp_w if sign > 0 else torch.where(k > 0, rp_w, r)
    # the m = 0 branch's log-det argument: its zero at rp = 0 is the
    # removable one, so it takes the series-windowed log(sin x / x)
    u0 = (kpos * rp * rp if sign > 0
          else torch.where(k > 0, kpos * rp * rp, k * vsq_g))
    if wraps == 0:
        return (-0.5 * rp * rp * quad - ls - half_l2pi
                - (n - 1.0) * stable._log_sindiv_u_sgn_soft(u0, sign))
    x_red = sqk * rp
    terms = []
    for m in range(-(wraps + 3), wraps + 4):
        rb_raw = rp + m * period
        if m == 0:
            live, rb = None, rb_raw
            logdet = (n - 1.0) * stable._log_sindiv_u_sgn_soft(u0, sign)
        else:
            live = (k > 0) & (rb_raw * rb_raw * quad < 1e30)
            rb = torch.where(live, rb_raw, rp)
            xb = sqk * torch.abs(rb)
            sph = (stable.log_abs_sin_soft(x_red, taper_x=xb)
                   - torch.log(torch.clamp(xb, min=tin)))
            if sign == 0:
                sph = torch.where(k > 0, sph, stable._log_sindiv_u_sgn_soft(
                    k * vsq_g, sign))
            logdet = (n - 1.0) * sph
        t_b = -0.5 * rb * rb * quad - ls - half_l2pi - logdet
        if live is not None:
            t_b = torch.where(live, t_b, _dead(t_b))
        terms.append(t_b)
    return _logsumexp_terms(terms)


def _logp_prior_rows(n, wraps, sign, k, r0):
    """Prior WrappedNormal(mu0, 1) log-density on (..., 1) rows from the
    preimage radius r0 (principal branch plus one wrap-image pair for the
    positive-capable kinds): the twin of
    ``wrapped_normal._log_prob_from_principal`` at isotropic sigma = 1."""
    tin = stable.tiny(r0.dtype)
    half_l2pi = 0.5 * n * _LOG_2PI
    r02 = r0 * r0
    logp = (-0.5 * r02 - half_l2pi
            - (n - 1.0) * stable._log_sindiv_u_sgn_soft(k * r02, sign))
    if wraps <= 0 or sign < 0:
        return logp
    sqk0 = torch.sqrt(torch.clamp(k, min=1e-20))
    period = 2.0 * math.pi / sqk0
    terms = [logp]
    for sgn in (1.0, -1.0):
        rb_raw = r0 + sgn * period
        live = (k > 0) & (torch.abs(rb_raw) < 1e15)
        rb = torch.where(live, rb_raw, r0)
        logn_b = -0.5 * rb * rb - half_l2pi
        lsk_b = stable.log_abs_sin_soft(
            sqk0 * r0, taper_x=sqk0 * torch.abs(rb)) - torch.log(sqk0)
        logd_b = (n - 1.0) * (lsk_b - stable._log_max(torch.abs(rb), tin))
        terms.append(torch.where(live, logn_b - logd_b, _dead(logp)))
    return _logsumexp_terms(terms)


def _stereo_draw(sign, wraps, k, mu, sig, eps):
    """z = mu (+)_K exp_0(sig eps) on the kappa-stereographic family by
    per-row Gram coefficients, its log q by the drawn-radius branch sum and
    the prior's log p at z. mu and sig broadcast against eps (..., n);
    returns (z (..., n), log q (..., 1), log p (..., 1))."""
    n = eps.shape[-1]
    e = stable.eps(eps.dtype)
    tin = stable.tiny(eps.dtype)
    smax = (1.0 - e) * torch.rsqrt(-torch.clamp(k, max=-tin))  # K<0 ball
    x2 = _rowsum(mu * mu)
    ls = _rowsum(torch.log(torch.clamp(sig, min=tin)))
    v = sig * eps
    vsq = _rowsum(v * v)
    xv = _rowsum(mu * v)
    s2 = _rowsum(eps * eps)

    g = 0.5 * stable._tandiv_u_sgn(k * vsq / 4.0, sign)
    if sign <= 0:
        g = g * _ball_scale(k, smax, g * g * vsq, tin)
    gxv = g * xv
    g2v = g * g * vsq
    a = 1.0 - 2.0 * k * gxv - k * g2v
    b = (1.0 + k * x2) * g
    den = 1.0 - 2.0 * k * gxv + k * k * x2 * g2v
    den = torch.where(torch.abs(den) < 1e-6, torch.full_like(den, 1e-6), den)
    inv_den = 1.0 / den
    z = (a * inv_den) * mu + (b * inv_den) * v
    zn2 = _rowsum(z * z)
    if sign <= 0:
        s = _ball_scale(k, smax, zn2, tin)
        z = z * s
        zn2 = torch.clamp(zn2 * s * s, min=0.0)

    logq = _logq_drawn_rows(n, wraps, sign, k, vsq, s2, ls)
    # the prior's preimage radius straight from z (isotropic sigma = 1)
    r0 = 2.0 * torch.sqrt(zn2 + tin) * stable._arctandiv_u_sgn(k * zn2, sign)
    logp = _logp_prior_rows(n, wraps, sign, k, r0)
    return z, logq, logp


def _tile_wrapped_stereo(comp, raw, eps, k):
    """Wrapped normal on the kappa-stereographic family (d/p/u): the scale
    saturating at the positive-K injectivity radius
    (``components.cap_sigma_positive_k``), the mu head (exp_map_mu0 of the
    raw tangent), then ``_stereo_draw``."""
    sign = comp.manifold.curvature_sign
    n = comp.dim
    e = stable.eps(raw.dtype)
    tin = stable.tiny(raw.dtype)
    mu_tan = raw[:, :n]
    sig = _sig(comp, raw)
    if sign >= 0:
        sig = cap_sigma_positive_k(sig, k)
    # mu = exp_map_mu0(mu_tan) = project(0.5 tandiv mu_tan)
    r2m = _rowsum(mu_tan * mu_tan)
    gm = 0.5 * stable._tandiv_u_sgn(k * r2m / 4.0, sign)
    mu = gm * mu_tan
    if sign <= 0:
        smax = (1.0 - e) * torch.rsqrt(-torch.clamp(k, max=-tin))
        mu = mu * _ball_scale(k, smax, gm * gm * r2m, tin)
    z, logq, logp = _stereo_draw(sign, comp.wraps, k, mu, sig, eps)
    return z, logq - logp, logq, logp


def tail_forward_ref(comps, raw, eps, k):
    """Plain PyTorch tail: raw (B, W) head pre-activations, eps (B, E)
    standard noise, k (nc,) curvatures, or (B, nc) per row -> (z (B, Z),
    aux (B, nc + 2) = [KL per component, sum log q, sum log p])."""
    zs, kls = [], []
    lq = lp = 0.0
    ro = eo = 0
    for i, comp in enumerate(comps):
        r = raw[:, ro:ro + comp.head_width]
        ro += comp.head_width
        e = eps[:, eo:eo + comp.noise_width]
        eo += comp.noise_width
        ki = k[i] if k.dim() == 1 else k[:, i:i + 1]
        if comp.posterior == "normal":
            z, kl, q, p = _tile_normal(comp, r, e)
        elif comp.posterior == "vmf":
            z, kl, q, p = _tile_vmf(comp, r, e, ki)
        elif comp.manifold.kind == "h":
            z, kl, q, p = _tile_wrapped_lorentz(comp, r, e, ki)
        elif comp.manifold.kind == "s":
            z, kl, q, p = _tile_wrapped_sphere(comp, r, e, ki)
        else:
            z, kl, q, p = _tile_wrapped_stereo(comp, r, e, ki)
        zs.append(z)
        kls.append(kl)
        lq = lq + q
        lp = lp + p
    return torch.cat(zs, dim=1), torch.cat(kls + [lq, lp], dim=1)


# --- the kernel wrapper -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _table(comps):
    """The kernel's component table: (kind, dim, n_scale, raw offset, eps
    offset, z offset, static curvature sign, wrap-image pairs) per
    component."""
    rows, ro, eo, zo = [], 0, 0, 0
    for c in comps:
        rows += [_kind(c), c.dim, c.n_scale, ro, eo, zo,
                 c.manifold.curvature_sign, c.wraps]
        ro += c.head_width
        eo += c.noise_width
        zo += c.ambient_dim
    return (ctypes.c_int * len(rows))(*rows)


def bind_tail(lib):
    """The two launch entries of a built tail library (the package's, or the
    previous design ``scripts/tail_previous`` measured beside it; each takes
    ``tail_fwd_launch``'s or ``tail_bwd_launch``'s arguments), typed for
    ctypes: {"fwd": fn or None, "bwd": fn or None}."""
    out = {}
    for kind, n_ptr in (("fwd", 5), ("bwd", 10)):
        fn = getattr(lib, f"tail_{kind}_launch", None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                           + [ctypes.c_void_p, ctypes.c_void_p])
        out[kind] = fn
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    return bind_tail(_build.load("tail_fwd"))["fwd"]


def _check_fwd(comps, raw, eps, k):
    """Shapes, family and device of a forward call; True for a CPU one."""
    W, E, _ = _dims(comps)
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
        return True
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    for name, t in (("raw", raw), ("eps", eps), ("k", k)):
        if t.dtype != torch.float32 or t.device != raw.device:
            raise ValueError(f"{name} must be float32 on {raw.device}")
    if nc > MAX_COMPS:
        raise ValueError(f"at most {MAX_COMPS} components")
    return False


def tail_forward_launch(fn, comps, raw, eps, k):
    """One launch of a forward entry ``fn`` (``bind_tail``) on CUDA tensors
    checked by the caller: (z, aux). Counts nothing."""
    W, E, Z = _dims(comps)
    nc, B = len(comps), raw.shape[0]
    raw, eps, k = raw.contiguous(), eps.contiguous(), k.contiguous()
    z = torch.empty((B, Z), dtype=torch.float32, device=raw.device)
    aux = torch.empty((B, nc + 2), dtype=torch.float32, device=raw.device)
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    _build.check(fn(raw.data_ptr(), eps.data_ptr(), k.data_ptr(),
                    z.data_ptr(), aux.data_ptr(), B, W, E, Z, nc,
                    _table(comps), stream), "tail_fwd_launch")
    return z, aux


def tail_forward(comps, raw, eps, k):
    """The fused tail: on a CUDA tensor one launch of ``csrc/tail_fwd.cu``;
    on a CPU tensor its plain version ``tail_forward_ref``. Same arguments
    and results as ``tail_forward_ref``."""
    comps = tuple(comps)
    if _check_fwd(comps, raw, eps, k):
        return tail_forward_ref(comps, raw, eps, k)
    z, aux = tail_forward_launch(_lib(), comps, raw, eps, k)
    tail_forward.launches += 1
    check_outputs("tail_fwd", z, aux)
    return z, aux


tail_forward.launches = 0


# --- the IWAE chunk reparameterization ---------------------------------------


def _picked(comps, picked):
    """(component, raw offset, eps offset, z offset) of each picked
    component, offsets into the whole product's head, noise and z."""
    out, ro, eo, zo = [], 0, 0, 0
    for i, c in enumerate(comps):
        if i in picked:
            out.append((c, ro, eo, zo))
        ro += c.head_width
        eo += c.noise_width
        zo += c.ambient_dim
    return out


@functools.lru_cache(maxsize=None)
def _chunk_table(comps, picked):
    """The chunk kernel's table: (kind, dim, n_scale, raw offset, eps
    offset, z offset) per picked component, in product order."""
    rows = []
    for c, ro, eo, zo in _picked(comps, picked):
        rows += [_kind(c), c.dim, c.n_scale, ro, eo, zo]
    return (ctypes.c_int * len(rows))(*rows)


def reparam_chunk_ref(comps, picked, raw, noise, k):
    """Plain PyTorch chunk reparam: ``tail_forward_ref``'s tiles on the S B
    rows of the picked components (indices into the product ``comps``),
    each example's heads repeated over the S samples. raw (B, W) the whole
    product's head pre-activations, noise (S, B, E) its noise, k (P,) the
    picked components' curvatures -> (z (S, B, Zp) the picked components'
    coordinates in order, sum log q (S, B), sum log p (S, B))."""
    S, B = noise.shape[:2]
    parts = _picked(comps, picked)
    sub = tuple(c for c, _, _, _ in parts)
    raw_p = torch.cat([raw[:, ro:ro + c.head_width]
                       for c, ro, _, _ in parts], dim=1)
    eps_p = torch.cat([noise[..., eo:eo + c.noise_width]
                       for c, _, eo, _ in parts], dim=2)
    rows = raw_p.unsqueeze(0).expand(S, B, raw_p.shape[1])
    z, aux = tail_forward_ref(sub, rows.reshape(S * B, -1),
                              eps_p.reshape(S * B, -1), k)
    nc = len(sub)
    return (z.reshape(S, B, -1), aux[:, nc].reshape(S, B),
            aux[:, nc + 1].reshape(S, B))


def reparam_chunk_plain(comps, picked, raw, noise, k, out):
    """``reparam_chunk_ref`` behind ``reparam_chunk_t``'s interface, on any
    device: z written into the picked components' rows of ``out``; returns
    (sum log q, sum log p)."""
    z, lq, lp = reparam_chunk_ref(comps, picked, raw, noise, k)
    zp = 0
    for c, _, _, zo in _picked(comps, picked):
        out[:, zo:zo + c.ambient_dim] = z[..., zp:zp + c.ambient_dim] \
            .transpose(1, 2)
        zp += c.ambient_dim
    return lq, lp


def bind_chunk(lib):
    """The launch entry of a built ``reparam_chunk.cu``, typed for
    ctypes."""
    fn = lib.reparam_chunk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    return fn


@functools.lru_cache(maxsize=None)
def _lib_chunk():
    return bind_chunk(_build.load("reparam_chunk"))


def _check_chunk(comps, picked, raw, noise, k, out):
    """Shapes, family and device of a chunk call; True for a CPU one."""
    W, E, Z = _dims(comps)
    if noise.dim() != 3 or noise.shape[2] != E:
        raise ValueError(f"noise must be (S, B, {E}), got "
                         f"{tuple(noise.shape)}")
    S, B = noise.shape[:2]
    if tuple(raw.shape) != (B, W) or tuple(k.shape) != (len(picked),):
        raise ValueError(f"raw must be ({B}, {W}) and k ({len(picked)},), "
                         f"got {tuple(raw.shape)} and {tuple(k.shape)}")
    if (tuple(out.shape) != (S, Z, B) or not out.is_contiguous()
            or out.dtype != raw.dtype or out.device != raw.device):
        raise ValueError(f"out must be a contiguous ({S}, {Z}, {B}) buffer "
                         f"of raw's type and device")
    if (not picked or list(picked) != sorted(set(picked))
            or not 0 <= picked[0] <= picked[-1] < len(comps)
            or not all(chunk_supported(comps[i]) for i in picked)):
        raise ValueError(f"picked {picked} must be ascending indices of "
                         "components the chunk kernel draws")
    if raw.device.type == "cpu":
        return True
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    for name, t in (("raw", raw), ("noise", noise), ("k", k)):
        if t.dtype != torch.float32 or t.device != raw.device:
            raise ValueError(f"{name} must be float32 on {raw.device}")
    if len(picked) > MAX_COMPS:
        raise ValueError(f"at most {MAX_COMPS} components")
    return False


def reparam_chunk_launch(fn, comps, picked, raw, noise, k, out):
    """One launch of a ``bind_chunk`` entry on CUDA tensors checked by the
    caller: z into ``out``'s rows of the picked components; returns
    (log q, log p), each (S, B). Counts nothing."""
    S, B, _ = noise.shape
    if noise.stride(2) != 1 or noise.stride(0) != B * noise.stride(1):
        noise = noise.contiguous()
    raw, k = raw.detach().contiguous(), k.detach().contiguous()
    lq = torch.empty((S, B), dtype=torch.float32, device=raw.device)
    lp = torch.empty((S, B), dtype=torch.float32, device=raw.device)
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    _build.check(fn(noise.data_ptr(), noise.stride(1), raw.data_ptr(),
                    raw.shape[1], k.data_ptr(), out.data_ptr(),
                    lq.data_ptr(), lp.data_ptr(), S, B, out.shape[1],
                    len(picked), _chunk_table(comps, picked), stream),
                 "reparam_chunk_launch")
    return lq, lp


def reparam_chunk_t(comps, picked, raw, noise, k, out):
    """The IWAE chunk reparam of the components ``picked`` (ascending
    indices into the product ``comps``, each ``chunk_supported``): on CUDA
    tensors one launch of ``csrc/reparam_chunk.cu``; on CPU tensors its
    plain version ``reparam_chunk_ref``. raw (B, W) the fused head's
    pre-activations, noise (S, B, E) the product's noise block (read where
    it lies), k (P,) the picked components' curvatures, out (S, Z, B) the
    decode kernel's buffer: each picked component's z is written into its
    rows. Returns (sum log q, sum log p) over the picked components, each
    (S, B). On CPU tensors it is ``reparam_chunk_plain``."""
    comps, picked = tuple(comps), tuple(picked)
    if _check_chunk(comps, picked, raw, noise, k, out):
        return reparam_chunk_plain(comps, picked, raw, noise, k, out)
    lq, lp = reparam_chunk_launch(_lib_chunk(), comps, picked, raw, noise, k,
                                  out)
    reparam_chunk_t.launches += 1
    check_outputs("reparam_chunk", lq, lp,
                  *[out[:, zo:zo + c.ambient_dim]
                    for c, _, _, zo in _picked(comps, picked)])
    return lq, lp


reparam_chunk_t.launches = 0


# --- the backward ---------------------------------------------------------------


def fold_rows_ref(dk_rows):
    """The backward kernel's fold of per-row values over the batch, in its
    order: each block of 32 rows summed in row order, then the blocks'
    sums in block order (``tail_backward_ref`` sums in PyTorch's)."""
    parts = []
    for b in range(0, dk_rows.shape[0], 32):
        s = dk_rows[b]
        for r in range(b + 1, min(b + 32, dk_rows.shape[0])):
            s = s + dk_rows[r]
        parts.append(s)
    if not parts:
        return torch.zeros_like(dk_rows[0:1].sum(0))
    out = parts[0]
    for s in parts[1:]:
        out = out + s
    return out


def tail_backward_ref(comps, raw, eps, k, dz, daux):
    """Plain PyTorch backward of the tail: the vector-Jacobian product of
    ``tail_forward_ref`` at (raw, eps, k) with cotangents dz (B, Z) and
    daux (B, nc + 2), by ``torch.autograd.grad`` with eps held constant.
    Returns (draw (B, W), dk_rows (B, nc), dk (nc,)): the curvature
    gradient of each row, and its sum over the batch (the transpose of the
    curvature's broadcast to the rows)."""
    comps = tuple(comps)
    B = raw.shape[0]
    with torch.enable_grad():
        raw_ = raw.detach().requires_grad_(True)
        kx = k.detach().reshape(1, -1).expand(B, len(comps)).clone()
        kx.requires_grad_(True)
        z, aux = tail_forward_ref(comps, raw_, eps.detach(), kx)
        draw, dk_rows = torch.autograd.grad((z, aux), (raw_, kx),
                                            (dz, daux), allow_unused=True)
    if dk_rows is None:
        dk_rows = torch.zeros_like(kx)
    return draw, dk_rows, dk_rows.sum(0)


@functools.lru_cache(maxsize=None)
def _lib_bwd():
    return bind_tail(_build.load("tail_bwd"))["bwd"]


_FOLD_COUNTERS: dict = {}


def _fold_counter(device):
    """The backward kernel's fold counters on ``device``, one a component:
    zeroed once, cached, and left at zero by every launch (a component's
    last block resets its own), so calls and CUDA-graph replays reuse
    them."""
    buf = _FOLD_COUNTERS.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("tail_backward: call it once on this device "
                               "before capturing a CUDA graph")
        buf = torch.zeros(MAX_COMPS, dtype=torch.int32, device=device)
        _FOLD_COUNTERS[device] = buf
    return buf


def _check_bwd(comps, raw, eps, k, dz, daux):
    """Shapes, family and device of a backward call; True for a CPU one."""
    W, E, Z = _dims(comps)
    nc = len(comps)
    B = raw.shape[0]
    shapes = {"raw": (raw, (B, W)), "eps": (eps, (B, E)), "k": (k, (nc,)),
              "dz": (dz, (B, Z)), "daux": (daux, (B, nc + 2))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not all(component_supported(c) for c in comps):
        raise ValueError("product has a component outside the kernel family")
    if raw.device.type == "cpu":
        return True
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    for name, (t, _) in shapes.items():
        if t.dtype != torch.float32 or t.device != raw.device:
            raise ValueError(f"{name} must be float32 on {raw.device}")
    if nc > MAX_COMPS:
        raise ValueError(f"at most {MAX_COMPS} components")
    return False


def tail_backward_launch(fn, comps, raw, eps, k, dz, daux):
    """One launch of a backward entry ``fn`` (``bind_tail``) on CUDA tensors
    checked by the caller: (draw, dk_rows, dk). Counts nothing."""
    W, E, Z = _dims(comps)
    nc, B = len(comps), raw.shape[0]
    args = [t.detach().contiguous() for t in (raw, eps, k, dz, daux)]
    dev = raw.device
    draw = torch.empty((B, W), dtype=torch.float32, device=dev)
    dk_rows = torch.empty((B, nc), dtype=torch.float32, device=dev)
    dk = torch.empty(nc, dtype=torch.float32, device=dev)
    part = torch.empty((-(-B // 32), nc), dtype=torch.float32, device=dev)
    counter = _fold_counter(dev)
    if B == 0:
        dk.zero_()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(*[t.data_ptr() for t in args], draw.data_ptr(),
                    dk_rows.data_ptr(), dk.data_ptr(), part.data_ptr(),
                    counter.data_ptr(), B, W, E, Z, nc, _table(comps),
                    stream), "tail_bwd_launch")
    return draw, dk_rows, dk


def tail_backward(comps, raw, eps, k, dz, daux):
    """The tail's backward: on a CUDA tensor one launch of
    ``csrc/tail_bwd.cu``, which also folds the per-row curvature gradients
    over the batch; on a CPU tensor its plain version ``tail_backward_ref``.
    Same arguments and results as ``tail_backward_ref``."""
    comps = tuple(comps)
    if _check_bwd(comps, raw, eps, k, dz, daux):
        return tail_backward_ref(comps, raw, eps, k, dz, daux)
    draw, dk_rows, dk = tail_backward_launch(_lib_bwd(), comps, raw, eps, k,
                                             dz, daux)
    tail_backward.launches += 1
    check_outputs("tail_bwd", draw, dk_rows, dk)
    return draw, dk_rows, dk


tail_backward.launches = 0


class _TailFn(torch.autograd.Function):
    """The fused tail under autograd: forward ``tail_forward``, backward
    ``tail_backward``, whose curvature gradient comes summed over the batch
    (on the card inside the kernel's one launch). The noise is a
    constant."""

    @staticmethod
    def forward(ctx, comps, raw, eps, k):
        ctx.comps = comps
        ctx.save_for_backward(raw, eps, k)
        return tail_forward(comps, raw, eps, k)

    @staticmethod
    def backward(ctx, dz, daux):
        raw, eps, k = ctx.saved_tensors
        draw, _, dk = tail_backward(ctx.comps, raw, eps, k, dz.contiguous(),
                                    daux.contiguous())
        return None, draw, None, dk if ctx.needs_input_grad[3] else None


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
    z, aux = _TailFn.apply(comps, raw_all, noise, kvec)
    nc = len(comps)
    return z, aux[:, nc], aux[:, nc + 1], aux[:, :nc], kvec
