"""Latent-space spec-string DSL (the public API of the model zoo).

Counterpart of ``mvae_tpu/components/spec.py``: comma-separated factors,
each ``[multiplier] kind dim [":" posterior]``, e.g. "e6", "h2,s2,e2",
"2h2", "u6", "s6:wrapped", "d6:riemannian".
"""
from __future__ import annotations

import re
from typing import Sequence

from ..ops import Manifold
from .component import DEFAULT_POSTERIOR, Component

_FACTOR_RE = re.compile(
    r"^(?P<mult>\d+)?(?P<kind>[ehdspu])(?P<dim>\d+)(?::(?P<post>[a-z]+))?$")


def parse_components(spec: str, fixed_curvature: bool = True,
                     scalar_sigma: bool = False,
                     wraps: int = 1,
                     sigma_cap: bool = True) -> tuple[Component, ...]:
    """Parse a latent spec string into a tuple of Components."""
    spec = spec.strip().lower()
    if not spec:
        raise ValueError("empty latent spec")
    comps: list[Component] = []
    for factor in spec.split(","):
        factor = factor.strip()
        m = _FACTOR_RE.match(factor)
        if not m:
            raise ValueError(
                f"bad latent factor {factor!r}; expected "
                "[multiplier]kind dim[:posterior], e.g. 'h2', '2s2', "
                "'d6:riemannian'")
        mult = int(m.group("mult") or 1)
        kind = m.group("kind")
        posterior = m.group("post") or DEFAULT_POSTERIOR[kind]
        if mult < 1:
            raise ValueError(f"multiplier must be >= 1 in {factor!r}")
        comp = Component(Manifold(kind, int(m.group("dim"))), posterior,
                         fixed_curvature=fixed_curvature,
                         scalar_sigma=scalar_sigma, wraps=wraps,
                         sigma_cap=sigma_cap)
        comps.extend([comp] * mult)
    return tuple(comps)


_PRETTY = {"e": "E", "h": "H", "d": "D", "s": "S", "p": "P", "u": "U"}


def canonical_name(components: Sequence[Component]) -> str:
    """Display name, e.g. '(H^2)x(S^2)x(E^2)'."""
    return "x".join(
        f"({_PRETTY[c.manifold.kind]}^{c.manifold.dim})" for c in components)


def total_ambient_dim(components: Sequence[Component]) -> int:
    """Decoder input width: concatenated ambient coordinates."""
    return sum(c.ambient_dim for c in components)


def total_true_dim(components: Sequence[Component]) -> int:
    return sum(c.dim for c in components)
