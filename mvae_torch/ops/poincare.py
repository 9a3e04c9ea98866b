"""Poincare ball D^n_K (K < 0): the gyrovector API over the stereographic
core, with the curvature clamped strictly negative. Counterpart of
``mvae_tpu/ops/poincare.py``."""
from __future__ import annotations

import torch

from . import stable, stereographic
from .lorentz import lorentz_to_poincare, poincare_to_lorentz  # noqa: F401

KIND = "d"
CURVATURE_SIGN = -1

ambient_dim = stereographic.ambient_dim
mu0 = stereographic.mu0


def _k(k):
    """Clamp K strictly negative (the ball model requires K < 0)."""
    return torch.clamp(k, max=-stable.tiny(k.dtype))


def _wrap(fn):
    def wrapped(*args):
        *rest, k = args
        return fn(*rest, _k(k))
    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped


lambda_x = _wrap(stereographic.lambda_x)
project = _wrap(stereographic.project)
mobius_add = _wrap(stereographic.mobius_add)
mobius_scalar_mul = _wrap(stereographic.mobius_scalar_mul)
gyration = _wrap(stereographic.gyration)
distance = _wrap(stereographic.distance)
exp_map = _wrap(stereographic.exp_map)
log_map = _wrap(stereographic.log_map)
parallel_transport = _wrap(stereographic.parallel_transport)
exp_map_mu0 = _wrap(stereographic.exp_map_mu0)
log_map_mu0 = _wrap(stereographic.log_map_mu0)
transp_mu0 = _wrap(stereographic.transp_mu0)
inv_transp_mu0 = _wrap(stereographic.inv_transp_mu0)
sample_projection_mu0 = _wrap(stereographic.sample_projection_mu0)
inverse_sample_projection_mu0 = _wrap(
    stereographic.inverse_sample_projection_mu0)
