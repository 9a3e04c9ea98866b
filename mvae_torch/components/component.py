"""Latent-space components: one constant-curvature factor + posterior family.

Counterpart of ``mvae_tpu/components/component.py``. A Component binds
(manifold, latent dim, posterior family, curvature parameter, encoder
heads); its sampling procedure maps encoder features to a reparameterized
draw with log q / log p / KL (analytic KL for the Euclidean normal and the
vMF, the single-sample estimate ``log q - log p`` otherwise).

A Component is a static dataclass; its learnable state is a plain dict of
tensors {w_mu, b_mu, w_sig, b_sig, c_param} inside the model params.

Posterior families: 'normal' on e, 'wrapped' on every kind, 'vmf' on s
and p (the exact inverse-CDF cosine at dim 2, the Wood rejection cosine
otherwise) and 'riemannian' on h and d (the Riemannian normal, its radius
by rejection on the rounds its noise carries; prior RiemannianNormal(mu0,
1)).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..distributions import (hyperspherical_uniform, normal,
                             riemannian_normal, von_mises_fisher,
                             wrapped_normal)
from ..ops import Manifold, sphere, stable

POSTERIORS = ("wrapped", "normal", "vmf", "riemannian")

DEFAULT_POSTERIOR = {
    "e": "normal",
    "h": "wrapped",
    "d": "wrapped",
    "s": "vmf",
    "p": "wrapped",
    "u": "wrapped",
}

_VALID = {
    "normal": ("e",),
    "wrapped": ("e", "h", "d", "s", "p", "u"),
    "vmf": ("s", "p"),
    "riemannian": ("h", "d"),
}


@dataclasses.dataclass(frozen=True)
class Component:
    """Static descriptor of one latent factor (fields as in the reference:
    ``scalar_sigma`` = one isotropic scale per component, ``wraps`` =
    wrap-image pairs in positive-K wrapped densities, ``sigma_cap`` = the
    injectivity-radius soft cap on positive-K wrapped scales)."""

    manifold: Manifold
    posterior: str
    fixed_curvature: bool = True
    scalar_sigma: bool = False
    wraps: int = 1
    sigma_cap: bool = True

    def __post_init__(self):
        if self.posterior not in POSTERIORS:
            raise ValueError(f"unknown posterior {self.posterior!r}")
        if self.manifold.kind not in _VALID[self.posterior]:
            raise ValueError(
                f"posterior {self.posterior!r} unsupported on manifold kind "
                f"{self.manifold.kind!r} (valid: {_VALID[self.posterior]})")

    @property
    def dim(self) -> int:
        return self.manifold.dim

    @property
    def ambient_dim(self) -> int:
        return self.manifold.ambient_dim

    @property
    def name(self) -> str:
        return f"{self.manifold.kind}{self.manifold.dim}"

    # --- parameters ---------------------------------------------------------

    def init_params(self, feature_dim: int, init_k: float = 1.0,
                    dtype=torch.float32, generator=None, device=None):
        """Head weights + curvature leaf: Linear -> tangent mu at mu0,
        Linear -> softplus scale. Drawn from ``generator`` (a CPU
        generator) and moved to ``device``."""
        scale = 1.0 / math.sqrt(feature_dim)
        params = {
            "w_mu": scale * torch.randn((feature_dim, self.dim),
                                        generator=generator, dtype=dtype),
            "b_mu": torch.zeros((self.dim,), dtype=dtype),
            "w_sig": scale * torch.randn((feature_dim, self.n_scale),
                                         generator=generator, dtype=dtype),
            "b_sig": torch.zeros((self.n_scale,), dtype=dtype),
        }
        if self.manifold.has_curvature_param:
            params["c_param"] = self.manifold.init_curvature_param(init_k,
                                                                   dtype)
        return {name: t.to(device) for name, t in params.items()}

    def curvature(self, params):
        if not self.manifold.has_curvature_param:
            return torch.zeros((), dtype=params["w_mu"].dtype,
                               device=params["w_mu"].device)
        return self.manifold.curvature(params["c_param"])

    # --- posterior parameter heads ------------------------------------------

    @property
    def n_scale(self) -> int:
        """Width of the scale head (1 for scalar-concentration families)."""
        if self.posterior in ("vmf", "riemannian") or self.scalar_sigma:
            return 1
        return self.dim

    @property
    def head_width(self) -> int:
        """Total head output width (mu tangent + scale), for GEMM fusion."""
        return self.dim + self.n_scale

    @property
    def noise_width(self) -> int:
        """Noise values one draw consumes: the tangent normals; for the
        vMF led by the cosine's uniform and, where the cosine is drawn by
        rejection (dim != 2), followed by the rejection draw's numbers
        (``von_mises_fisher.wood_proposals``); for the Riemannian normal
        followed by the radius's rejection rounds
        (``riemannian_normal.draw_rounds``)."""
        if self.posterior == "riemannian":
            return self.dim + 3 * riemannian_normal.ROUNDS
        if self.posterior != "vmf":
            return self.dim
        wood = 0 if self.dim == 2 else 2 * von_mises_fisher.OVERSAMPLE
        return self.dim + 1 + wood

    def posterior_params_from_raw(self, params, raw):
        """raw (..., head_width) pre-activations -> (mu ambient, scale, k)."""
        k = self.curvature(params)
        mu = self.manifold.exp_map_mu0(raw[..., :self.dim], k)
        raw_sig = raw[..., self.dim:]
        if self.posterior == "vmf":
            # concentration: softplus + 1 (the s-vae-style head)
            return mu, stable.softplus(raw_sig).squeeze(-1) + 1.0, k
        scale = stable.softplus(raw_sig)
        if self.posterior == "riemannian":
            scale = scale.squeeze(-1)
        elif (self.posterior == "wrapped"
              and self.manifold.curvature_sign >= 0
              and self.manifold.kind != "e" and self.sigma_cap):
            scale = cap_sigma_positive_k(scale, k)
        return mu, scale, k

    def posterior_params(self, params, features):
        """features (..., F) -> (mu ambient, scale, k)."""
        raw = torch.cat([features @ params["w_mu"] + params["b_mu"],
                         features @ params["w_sig"] + params["b_sig"]],
                        dim=-1)
        return self.posterior_params_from_raw(params, raw)


def cap_sigma_positive_k(sigma, k):
    """Saturating posterior-scale cap at the positive-K injectivity radius
    pi R: sigma_eff = cap * t * (1 + t^6)^(-1/6), t = sigma/cap (identity
    to <0.02% for sigma <= cap/3; smooth in K through 0)."""
    cap = math.pi * torch.rsqrt(torch.clamp(k, min=1e-12))
    t = torch.clamp(sigma / cap, max=8.0)
    t2 = t * t
    return cap * t * (1.0 + t2 * t2 * t2) ** (-1.0 / 6.0)


class Reparametrized(NamedTuple):
    """Per-component reparameterization result."""

    z: torch.Tensor        # (..., ambient_dim) latent draw
    log_q: torch.Tensor    # (...,) posterior log-density at z
    log_p: torch.Tensor    # (...,) prior log-density at z
    kl: torch.Tensor       # (...,) KL estimate used in the ELBO


def draw_noise(comp: Component, shape, like: torch.Tensor, generator=None):
    """Standard noise (*shape, noise_width) for one component: N(0, 1)
    tangent draws, led by the cosine's U[1e-7, 1) for the vMF and, for the
    rejection cosine (dim != 2), followed by its proposals; for the
    Riemannian normal followed by the radius's rejection rounds."""
    shape = tuple(shape)
    if comp.posterior == "riemannian":
        return riemannian_normal.draw_noise(comp.dim, shape, like, generator)
    g = normal.standard_normal(shape + (comp.dim,), like, generator)
    if comp.posterior != "vmf":
        return g
    cols = [von_mises_fisher.uniform(shape + (1,), like, generator), g]
    if comp.dim != 2:
        cols.append(von_mises_fisher.wood_proposals(comp.dim + 1, shape, like,
                                                    generator))
    return torch.cat(cols, dim=-1)


def reparametrize(comp: Component, params, features, raw=None, noise=None,
                  generator=None) -> Reparametrized:
    """Sample z ~ q(.|features) with log q, log p and the ELBO KL term.

    ``raw`` is the component's slice of the fused head GEMM (skips the
    per-component head matmuls). ``noise`` is the component's standard
    noise (..., noise_width) and may carry extra leading sample dims; it is
    drawn from ``generator`` when not given."""
    man = comp.manifold
    if raw is None:
        mu, scale, k = comp.posterior_params(params, features)
    else:
        mu, scale, k = comp.posterior_params_from_raw(params, raw)
    if noise is None:
        noise = draw_noise(comp, mu.shape[:-1], mu, generator)
    dtype = features.dtype

    if comp.posterior == "normal":
        z = normal.sample(mu, scale, noise=noise)
        one = torch.ones((), dtype=dtype, device=z.device)
        log_q = normal.log_prob(z, mu, scale)
        log_p = normal.log_prob(z, 0.0 * one, one)
        kl = normal.kl_std(mu, scale)
        return Reparametrized(z, log_q, log_p, kl.expand(log_q.shape))

    if comp.posterior == "wrapped":
        z, log_q = wrapped_normal.sample_and_log_prob(
            man, mu, scale, k, wraps=comp.wraps, noise=noise)
        log_p = wrapped_normal.log_prob_mu0(
            man, z, torch.ones((), dtype=dtype, device=z.device), k,
            wraps=comp.wraps)
        return Reparametrized(z, log_q, log_p, log_q - log_p)

    if comp.posterior == "vmf":
        m = comp.dim + 1
        proposals = noise[..., m:] if m != 3 else None
        if man.kind == "p":
            # sample on the embedded sphere and push through the
            # stereographic isometry: projected coordinates carry no norm
            # constraint, so the vMF machinery runs at the sphere pre-images
            # (densities w.r.t. the Riemannian measure are invariant)
            mu_s = sphere.projected_to_sphere(mu, k)
            z_s = von_mises_fisher.sample(mu_s, scale, k, noise=noise,
                                          proposals=proposals)
            z = sphere.sphere_to_projected(z_s, k)
        else:
            mu_s = mu
            z_s = z = von_mises_fisher.sample(mu, scale, k, noise=noise,
                                              proposals=proposals)
        log_q = von_mises_fisher.log_prob(z_s, mu_s, scale, k)
        log_p = hyperspherical_uniform.log_prob(z_s, k)
        kl = von_mises_fisher.kl_to_uniform(m, scale)
        return Reparametrized(z, log_q, log_p, kl.expand(log_q.shape))

    if comp.posterior == "riemannian":
        z, log_q = riemannian_normal.sample_and_log_prob(man, mu, scale, k,
                                                         noise=noise)
        mu0 = man.mu0(k, dtype)
        log_p = riemannian_normal.log_prob(
            man, z, mu0, torch.ones((), dtype=dtype, device=z.device), k)
        return Reparametrized(z, log_q, log_p, log_q - log_p)

    raise AssertionError(comp.posterior)


def sample_prior(comp: Component, params, shape, dtype=torch.float32,
                 generator=None):
    """Draw (*shape, ambient_dim) from the component's prior, on the device
    of ``params``: the standard normal, the uniform on the sphere (pushed
    through the stereographic isometry for 'p'), or the wrapped or
    Riemannian normal at mu0 with unit scale."""
    man = comp.manifold
    shape = tuple(shape)
    k = comp.curvature(params)
    like = torch.zeros((), dtype=dtype, device=k.device)
    if comp.posterior == "normal":
        return normal.standard_normal(shape + (comp.dim,), like, generator)
    if comp.posterior == "vmf":
        z_s = hyperspherical_uniform.sample(shape, comp.dim + 1, k, like,
                                            generator)
        if man.kind == "p":
            return sphere.sphere_to_projected(z_s, k)
        return z_s
    mu0 = torch.broadcast_to(man.mu0(k, dtype), shape + (man.ambient_dim,))
    if comp.posterior == "riemannian":
        sigma = torch.ones(shape, dtype=dtype, device=k.device)
        return riemannian_normal.sample(man, mu0, sigma, k,
                                        generator=generator)
    return wrapped_normal.sample(man, mu0, torch.ones_like(like), k,
                                 generator=generator)
