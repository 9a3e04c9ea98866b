"""Training statistics accumulators.

A copy of ``mvae_tpu/train/stats.py`` (the port imports nothing of the JAX
package): running means of ELBO / BCE / per-component KL / curvatures, a
console line, and a plain-dict export.
"""
from __future__ import annotations

import numpy as np


class EpochStats:
    """Accumulates batch stat dicts; exposes epoch means."""

    def __init__(self, component_names):
        self.component_names = list(component_names)
        self._sums: dict = {}
        self._count = 0

    def update(self, stats: dict, weight: float = 1.0):
        """Accumulate one batch's means with ``weight`` (= its real example
        count when batches are unevenly sized, e.g. a padded+masked tail)."""
        self._count += weight
        for k, v in stats.items():
            v = weight * np.asarray(v)
            if k in self._sums:
                self._sums[k] = self._sums[k] + v
            else:
                self._sums[k] = v.copy()

    def means(self) -> dict:
        if self._count == 0:
            return {}
        out = {}
        for k, v in self._sums.items():
            m = v / self._count
            if k == "kl_per_comp":
                for name, val in zip(self.component_names, np.atleast_1d(m)):
                    out[f"kl/{name}"] = float(val)
            elif k == "curvature":
                for name, val in zip(self.component_names, np.atleast_1d(m)):
                    out[f"curvature/{name}"] = float(val)
            else:
                out[k] = float(m)
        return out

    def summary_line(self, prefix: str = "") -> str:
        m = self.means()
        parts = [f"{prefix}elbo={m.get('elbo', float('nan')):.2f}",
                 f"bce={m.get('bce', float('nan')):.2f}",
                 f"kl={m.get('kl', float('nan')):.3f}"]
        curvs = [f"{k.split('/')[1]}:{v:+.3f}" for k, v in m.items()
                 if k.startswith("curvature/")]
        if curvs:
            parts.append("K[" + " ".join(curvs) + "]")
        return " ".join(parts)
