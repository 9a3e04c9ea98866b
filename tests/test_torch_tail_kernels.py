"""The fused tail's plain version (``tail_forward_ref``) against the JAX
tile math ``tail_kernels._tail_tile`` (through ``reparam_all_jnp``), with
the noise of ``draw_noise_t``; the wrapper's CPU dispatch and checks; and
the CUDA kernel against its plain version on the card.

Tolerances: 1e-10 in float64 (the same expressions; library last-digit
differences only) and 1e-5 in float32 relative with a 1e-4 absolute floor
on log-densities of magnitude ~10-100 (a few ulps through the chains).
On the card the kernel and its plain version evaluate the same float32
operations in the same order (the kernel is built with --fmad=false), so
they are held to 1e-5 (1 + |z|) on z and 1e-4 on the log-densities.

The JAX package is imported inside the CPU tests only, so the card tests
also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_tail_kernels.py
"""
import numpy as np
import pytest
import torch

from mvae_torch.components import parse_components as t_parse
from mvae_torch.convert import params_from_jax
from mvae_torch.kernels import tail_kernels as ttk

B, F = 40, 24
SPECS = ["h2,s2,e2", "2h2", "3s2", "e2", "h3,e4"]


def _setup(spec, dtype, scalar_sigma=False, seed=0):
    import jax
    from mvae_tpu.components import parse_components as j_parse
    jc = j_parse(spec, fixed_curvature=False, scalar_sigma=scalar_sigma)
    tc = t_parse(spec, fixed_curvature=False, scalar_sigma=scalar_sigma)
    k_init, k_feat, k_rep = jax.random.split(jax.random.key(seed), 3)
    params = tuple(c.init_params(kk, F, 1.0, dtype)
                   for c, kk in zip(jc, jax.random.split(k_init, len(jc))))
    feats = 0.7 * jax.random.normal(k_feat, (B, F), dtype)
    raw = np.concatenate(
        [np.concatenate([np.asarray(feats @ cp["w_mu"] + cp["b_mu"]),
                         np.asarray(feats @ cp["w_sig"] + cp["b_sig"])],
                        axis=1) for cp in params], axis=1)
    return jc, tc, params, raw, k_rep


def _kvec(tc, params):
    import jax
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    return torch.stack([c.curvature(cp) for c, cp in zip(tc, tparams)])


@pytest.mark.parametrize("dtype,tol,atol", [
    pytest.param(np.float64, 1e-10, 1e-10, id="f64"),
    pytest.param(np.float32, 1e-5, 1e-4, id="f32")])
@pytest.mark.parametrize("spec,scalar_sigma",
                         [(s, False) for s in SPECS] + [("h2,s2,e2", True)])
def test_tail_forward_ref_matches_jax_tile(spec, scalar_sigma, dtype, tol,
                                           atol):
    from mvae_tpu.kernels import tail_kernels as jtk
    jc, tc, params, raw, k_rep = _setup(spec, dtype, scalar_sigma)
    z_j, lq_j, lp_j, kl_j, kv_j = jtk.reparam_all_jnp(k_rep, jc, params, raw)
    eps = np.asarray(jtk.draw_noise_t(k_rep, jc, B, dtype)).T
    kvec = _kvec(tc, params)
    np.testing.assert_allclose(kvec.numpy(), np.asarray(kv_j), rtol=tol)
    z, aux = ttk.tail_forward_ref(tc, torch.from_numpy(raw),
                                  torch.from_numpy(eps.copy()), kvec)
    nc = len(tc)
    for ours, theirs in ((z, z_j), (aux[:, :nc], kl_j), (aux[:, nc], lq_j),
                         (aux[:, nc + 1], lp_j)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=tol, atol=atol)


def test_reparam_all_on_cpu_is_the_plain_version():
    import jax
    from mvae_tpu.kernels import tail_kernels as jtk
    jc, tc, params, raw, k_rep = _setup("h2,s2,e2", np.float32)
    eps = torch.from_numpy(np.asarray(jtk.draw_noise_t(k_rep, jc, B,
                                                       np.float32)).T.copy())
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    before = ttk.tail_forward.launches
    z, lq, lp, kl, kvec = ttk.reparam_all(tc, tparams, torch.from_numpy(raw),
                                          noise=eps)
    z_r, aux_r = ttk.tail_forward_ref(tc, torch.from_numpy(raw), eps, kvec)
    assert torch.equal(z, z_r) and torch.equal(lq, aux_r[:, 3])
    assert torch.equal(kl, aux_r[:, :3]) and torch.equal(lp, aux_r[:, 4])
    assert ttk.tail_forward.launches == before  # CPU: no kernel launch


def test_draw_noise_layout():
    tc = t_parse("h2,s2,e2")
    g = torch.Generator().manual_seed(0)
    noise = ttk.draw_noise(tc, (5, 7), torch.zeros(()), g)
    assert noise.shape == (5, 7, 7)          # 2 (h) + 1 + 2 (vMF) + 2 (e)
    u = noise[..., 2]                        # the vMF cosine's uniform
    assert float(u.min()) >= 1e-7 and float(u.max()) < 1.0


def test_wrapper_rejects_bad_input():
    tc = t_parse("h2,s2,e2")
    raw, eps, k = torch.zeros(4, 11), torch.zeros(4, 7), torch.zeros(3)
    with pytest.raises(ValueError):
        ttk.tail_forward(tc, raw[:, :10], eps, k)
    with pytest.raises(ValueError):
        ttk.tail_forward(tc, raw, eps[:, :6], k)
    with pytest.raises(ValueError):  # wrapped sphere: a later slice's tile
        ttk.tail_forward(t_parse("s2:wrapped"), torch.zeros(4, 4),
                         torch.zeros(4, 2), torch.ones(1))


def test_capability_predicate():
    sup = [ttk.component_supported(c) for c in t_parse(
        "h2,s2,e2,s3,s2:wrapped,d2,u2,h33")]
    assert sup == [True, True, True, False, False, False, False, False]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [512, 1000])
def test_kernel_matches_plain_version_on_card(cuda_device, batch):
    comps = t_parse("h2,s2,e2")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    raw = torch.randn(batch, 11, generator=gen, device=cuda_device)
    eps = ttk.draw_noise(comps, (batch,), raw, gen)
    k = torch.tensor([-1.0, 1.0, 0.0], device=cuda_device)
    z, aux = ttk.tail_forward(comps, raw, eps, k)
    z_r, aux_r = ttk.tail_forward_ref(comps, raw, eps, k)
    torch.cuda.synchronize()
    assert bool(((z - z_r).abs() <= 1e-5 * (1 + z_r.abs())).all())
    assert float((aux - aux_r).abs().max()) <= 1e-4
    with pytest.raises(RuntimeError):  # forward only
        ttk.tail_forward(comps, raw.requires_grad_(), eps, k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tail kernel has no CPU mode")
    return torch.device("cuda")
