"""The Riemannian normal's float32 gradients against the reference's.

The model matrix trains ``d6:riemannian`` in float32, where neither
package's gradient of this posterior is close to its float64 value (the
quadrature log-partition and the implicit radius gradient lose digits).
So the port is not held to the reference's float32 numbers directly but to
the reference's own float32 error: on JAX's weights and on the noise JAX
draws in float32 (its key chain rebuilt by ``test_torch_riemannian.
jax_noise``), each leaf's largest distance of the port's float32 gradient
from the float64 gradient of the same computation must be within
K = 10 times the reference's float32 distance from it, plus 1e-6 of the
leaf's largest float64 gradient (where the reference's float32 lands on
float64, as a curvature that gets no gradient does). The float64 gradient
is the port's in float64 on the same noise, which the float64 tests hold
to JAX's float64 within 1e-8 (``test_reparametrize_gradients_match_jax``,
``test_one_epoch_riemannian_matches_jax_trainer``). K = 10 is the bound
``chip_smoke.py::held`` puts on a kernel where float32 does not resolve a
value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvae_tpu.components import parse_components as j_parse
from mvae_tpu.components import reparametrize as j_reparametrize
from mvae_tpu.models import vae as jvae
from mvae_torch.components import parse_components as t_parse
from mvae_torch.components import reparametrize as t_reparametrize
from mvae_torch.convert import params_from_jax
from mvae_torch.models import vae as tvae
from mvae_torch.train.trainer import _leaves
from tests.test_torch_riemannian import jax_noise

K = 10.0


def _held(ours32, ref32, ref64, name):
    """Each leaf's worst distance to float64, port against reference;
    returns the worst ratio."""
    worst = 0.0
    for a, b, c, leaf in zip(ours32, ref32, ref64, name):
        c = np.asarray(c, np.float64)
        ours = np.max(np.abs(np.asarray(a, np.float64) - c))
        ref = np.max(np.abs(np.asarray(b, np.float64) - c))
        floor = 1e-6 * np.max(np.abs(c))
        assert np.all(np.isfinite(a)), leaf
        assert ours <= K * ref + floor, (
            f"{leaf}: port {ours:.3g} from float64, reference {ref:.3g}")
        worst = max(worst, ours / (ref + floor))
    return worst


def _as(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


@pytest.mark.parametrize("spec,fixed", [("d6:riemannian", True),
                                        ("d2:riemannian", False),
                                        ("h3:riemannian", False)])
def test_component_float32_gradients(spec, fixed):
    """sum(kl) + sum(sin z) of one component over 48 lanes: every head
    weight's gradient and the curvature's (dr/dK, the implicit gradient)."""
    (jc,) = j_parse(spec, fixed_curvature=fixed)
    (tc,) = t_parse(spec, fixed_curvature=fixed)
    params32 = jc.init_params(jax.random.key(0), 16, 1.0, np.float32)
    params32["b_sig"] = params32["b_sig"] - 1.5
    feats = (0.5 * np.random.default_rng(6).standard_normal((48, 16))
             ).astype(np.float32)
    ck = jax.random.key(8)

    def objective(p):
        rep = j_reparametrize(ck, jc, p, jnp.asarray(feats))
        return jnp.sum(rep.kl) + jnp.sum(jnp.sin(rep.z))

    g_j = jax.jit(jax.grad(objective))(params32)
    noise = jax_noise(ck, jc.dim, len(feats), np.float32)

    def port(dtype):
        params = params_from_jax(_as(params32, dtype))
        for t in params.values():
            t.requires_grad_(True)
        rep = t_reparametrize(tc, params, torch.from_numpy(
            feats.astype(dtype)), noise=torch.from_numpy(noise.astype(dtype)))
        (torch.sum(rep.kl) + torch.sum(torch.sin(rep.z))).backward()
        return {k: t.grad.numpy() for k, t in params.items()}

    g32, g64 = port(np.float32), port(np.float64)
    names = sorted(g32)
    _held([g32[k] for k in names], [np.asarray(g_j[k]) for k in names],
          [g64[k] for k in names], names)


def test_d6_riemannian_loss_float32_gradients():
    """One step's gradient of ``d6:riemannian``'s loss (the model matrix's
    flags: fixed curvature; an MLP at h_dim 32 on 24 examples of 64 pixels)
    in every parameter."""
    D, H, B = 64, 32, 24
    jcfg = jvae.VAEConfig(j_parse("d6:riemannian", fixed_curvature=True),
                          (D,), h_dim=H)
    tcfg = tvae.VAEConfig(t_parse("d6:riemannian", fixed_curvature=True),
                          (D,), h_dim=H)
    params32 = jvae.init_params(jax.random.key(4), jcfg, dtype=np.float32)
    x = (np.random.default_rng(4).random((B, D)) < 0.3).astype(np.float32)
    key = jax.random.key(9)

    def loss(p):
        return jvae.loss_fn(key, jcfg, p, jnp.asarray(x))[0]

    g_j = jax.jit(jax.grad(loss))(params32)
    (ck,) = jax.random.split(key, 1)
    noise = jax_noise(ck, 6, B, np.float32)

    def port(dtype):
        params = params_from_jax(_as(params32, dtype))
        for t in _leaves(params):
            t.requires_grad_(True)
        value, _ = tvae.loss_fn(tcfg, params, torch.from_numpy(
            x.astype(dtype)), noise=torch.from_numpy(noise.astype(dtype)))
        value.backward()
        return [t.grad for t in _leaves(params)]

    g32, g64 = port(np.float32), port(np.float64)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(g_j)[0]]
    used = [i for i, g in enumerate(g32) if g is not None]
    _held([g32[i].numpy() for i in used],
          [np.asarray(jax.tree.leaves(g_j)[i]) for i in used],
          [g64[i].numpy() for i in used], [paths[i] for i in used])
