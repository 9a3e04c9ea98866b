"""Universal sign-agnostic curvature space U^n over the stereographic core.

Counterpart of ``mvae_tpu/ops/universal.py``: one constant-curvature
gyrovector space whose curvature K is an unconstrained learnable scalar
that may cross zero during training. Every op of
:mod:`mvae_torch.ops.stereographic` is well-defined and smooth for K of any
sign, so this module re-exports it with no clamping at all.
"""
from __future__ import annotations

from . import stereographic

KIND = "u"
CURVATURE_SIGN = 0  # free

ambient_dim = stereographic.ambient_dim
mu0 = stereographic.mu0
lambda_x = stereographic.lambda_x
project = stereographic.project
mobius_add = stereographic.mobius_add
mobius_scalar_mul = stereographic.mobius_scalar_mul
gyration = stereographic.gyration
distance = stereographic.distance
exp_map = stereographic.exp_map
log_map = stereographic.log_map
parallel_transport = stereographic.parallel_transport
exp_map_mu0 = stereographic.exp_map_mu0
log_map_mu0 = stereographic.log_map_mu0
transp_mu0 = stereographic.transp_mu0
inv_transp_mu0 = stereographic.inv_transp_mu0
sample_projection_mu0 = stereographic.sample_projection_mu0
inverse_sample_projection_mu0 = stereographic.inverse_sample_projection_mu0
