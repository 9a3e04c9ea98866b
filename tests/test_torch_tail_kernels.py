"""The fused tail's plain versions against the JAX package: the forward
(``tail_forward_ref``) against the JAX tile math ``tail_kernels._tail_tile``
(through ``reparam_all_jnp``), with the noise of ``draw_noise_t``; the
backward (``tail_backward_ref``, and ``_TailFn`` through
``loss.backward()``) against ``jax.grad`` of ``reparam_all_jnp`` and of the
Pallas ``reparam_all`` in interpret mode (which runs ``_bwd_pallas``); the
wrappers' CPU dispatch and checks; and both CUDA kernels against their
plain versions on the card.

Tolerances: forward, 1e-10 in float64 (the same expressions; library
last-digit differences only) and 1e-5 in float32 relative with a 1e-4
absolute floor on log-densities of magnitude ~10-100 (a few ulps through
the chains). Backward, 1e-9 in float64 (autograd against JAX's AD of the
same expressions, summed in another order); in float32 the reference's
own contract for its in-kernel VJP against plain AD of the same tile
(tests/kernels/test_tail_kernels.py): rtol 1e-3 / atol 5e-4 on the raw
gradient, rtol 2e-3 on the curvature gradient (a cancelling batch sum).
On the card the forward kernel and its plain version evaluate the same
float32 operations in the same order (built with --fmad=false), so they
are held to 1e-5 (1 + |z|) on z and 1e-4 on the log-densities; the
backward kernel, whose reverse sweep is derived by hand, to the float32
backward contract above. The stereographic tile (d/p/u) and the
embedded-sphere tile (wrapped on s) in float64 are held to 1e-7 where the
others are held to 1e-10 and 1e-9: the reference spells atan as a polynomial
within 6.3e-9 of it, the port calls atan.

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


def _setup(spec, dtype, scalar_sigma=False, seed=0, wraps=1, c_params=None):
    """Components of both packages, JAX head params (``c_params`` overrides
    the curvature leaves of the components that have one, in order), the
    raw heads of B random feature rows, and the reparam key."""
    import jax
    import jax.numpy as jnp
    from mvae_tpu.components import parse_components as j_parse
    jc = j_parse(spec, fixed_curvature=False, scalar_sigma=scalar_sigma,
                 wraps=wraps)
    tc = t_parse(spec, fixed_curvature=False, scalar_sigma=scalar_sigma,
                 wraps=wraps)
    k_init, k_feat, k_rep = jax.random.split(jax.random.key(seed), 3)
    params = tuple(c.init_params(kk, F, 1.0, dtype)
                   for c, kk in zip(jc, jax.random.split(k_init, len(jc))))
    if c_params is not None:
        with_c = [cp for cp in params if "c_param" in cp]
        for cp, c in zip(with_c, c_params, strict=True):
            cp["c_param"] = jnp.asarray(c, dtype)
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
    with pytest.raises(ValueError):  # the rejection cosine has no tile
        ttk.tail_forward(t_parse("s3"), torch.zeros(4, 4),
                         torch.zeros(4, 36), torch.ones(1))
    with pytest.raises(ValueError):  # nor has an uncapped wrapped sphere
        ttk.tail_forward(t_parse("s2:wrapped", sigma_cap=False),
                         torch.zeros(4, 4), torch.zeros(4, 2), torch.ones(1))
    z, aux = ttk.tail_forward(t_parse("s2:wrapped"), torch.zeros(4, 4),
                              torch.zeros(4, 2), torch.ones(1))
    assert z.shape == (4, 3) and aux.shape == (4, 3)


def _loss_cotangents(B, Z, nc, dtype):
    """(dz, daux) of loss = mean_b |z_b|^2 + mean(kl) + 0.1 mean(lq - lp)
    at z: the loss of the reference's kernel-gradient test."""
    daux = np.zeros((B, nc + 2), dtype)
    daux[:, :nc] = 1.0 / (B * nc)
    daux[:, nc] = 0.1 / B
    daux[:, nc + 1] = -0.1 / B
    return daux


def _jax_grads(jc, params, raw, k_rep, fused):
    """jax.grad of the loss w.r.t. (raw heads, c_param per component),
    through reparam_all_jnp or (fused) the Pallas reparam_all."""
    import jax
    import jax.numpy as jnp
    from mvae_tpu.kernels import tail_kernels as jtk

    def loss(raw_all, cps):
        fn = jtk.reparam_all if fused else jtk.reparam_all_jnp
        z, lq, lp, kl, _ = fn(k_rep, jc, cps, raw_all)
        return (jnp.mean(jnp.sum(z * z, -1)) + jnp.mean(kl)
                + 0.1 * jnp.mean(lq - lp))

    g_raw, g_cps = jax.grad(loss, argnums=(0, 1))(jnp.asarray(raw), params)
    g_c = [np.asarray(g["c_param"]) for g in g_cps if "c_param" in g]
    return np.asarray(g_raw), g_c


BWD_DTYPES = [pytest.param(np.float64, 1e-9, 1e-9, 1e-9, id="f64"),
              pytest.param(np.float32, 1e-3, 5e-4, 2e-3, id="f32")]


@pytest.mark.parametrize("dtype,rtol,atol,ktol", BWD_DTYPES)
@pytest.mark.parametrize("spec,scalar_sigma",
                         [(s, False) for s in ("h2,s2,e2", "2h2", "3s2",
                                               "e2")] + [("h2,s2,e2", True)])
def test_tail_backward_matches_jax_grad(spec, scalar_sigma, dtype, rtol,
                                        atol, ktol):
    import jax
    from mvae_tpu.kernels import tail_kernels as jtk
    jc, tc, params, raw, k_rep = _setup(spec, dtype, scalar_sigma)
    g_raw_j, g_c_j = _jax_grads(jc, params, raw, k_rep, fused=False)
    eps = torch.from_numpy(np.asarray(
        jtk.draw_noise_t(k_rep, jc, B, dtype)).T.copy())
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    curv = [cp["c_param"].requires_grad_() for cp in tparams
            if "c_param" in cp]
    raw_t = torch.from_numpy(raw).requires_grad_()

    # _TailFn under loss.backward()
    z, lq, lp, kl, kvec = ttk.reparam_all(tc, tparams, raw_t, noise=eps)
    loss = (torch.mean(torch.sum(z * z, -1)) + torch.mean(kl)
            + 0.1 * torch.mean(lq - lp))
    loss.backward()
    np.testing.assert_allclose(raw_t.grad.numpy(), g_raw_j, rtol=rtol,
                               atol=atol)
    assert len(curv) == len(g_c_j)
    for ours, theirs in zip(curv, g_c_j):
        np.testing.assert_allclose(ours.grad.numpy(), theirs, rtol=ktol,
                                   atol=atol)

    # tail_backward_ref at the loss's cotangents; dK/dc = K (K = +-e^c)
    nc = len(tc)
    daux = torch.from_numpy(_loss_cotangents(B, z.shape[1], nc, dtype))
    draw, dk_rows, _ = ttk.tail_backward_ref(tc, torch.from_numpy(raw), eps,
                                          kvec.detach(),
                                          2.0 * z.detach() / B, daux)
    np.testing.assert_allclose(draw.numpy(), g_raw_j, rtol=rtol, atol=atol)
    dc = (dk_rows.sum(0) * kvec.detach()).numpy()
    idx = [i for i, c in enumerate(tc) if c.manifold.has_curvature_param]
    for i, theirs in zip(idx, g_c_j):
        np.testing.assert_allclose(dc[i], theirs, rtol=ktol, atol=atol)


@pytest.mark.parametrize("spec", ["h2,s2,e2", "2h2"])
def test_tail_backward_matches_pallas_bwd_interpret(monkeypatch, spec):
    """Against the JAX kernel's own backward (_bwd_pallas, interpret mode,
    MVAE_FUSED_TAIL=1 as in the reference's kernel tests), float32."""
    import jax
    from mvae_tpu.kernels import tail_kernels as jtk
    monkeypatch.setenv("MVAE_FUSED_TAIL", "1")
    jc, tc, params, raw, k_rep = _setup(spec, np.float32)
    g_raw_j, g_c_j = _jax_grads(jc, params, raw, k_rep, fused=True)
    eps = torch.from_numpy(np.asarray(
        jtk.draw_noise_t(k_rep, jc, B, np.float32)).T.copy())
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    curv = [cp["c_param"].requires_grad_() for cp in tparams
            if "c_param" in cp]
    raw_t = torch.from_numpy(raw).requires_grad_()
    z, lq, lp, kl, _ = ttk.reparam_all(tc, tparams, raw_t, noise=eps)
    (torch.mean(torch.sum(z * z, -1)) + torch.mean(kl)
     + 0.1 * torch.mean(lq - lp)).backward()
    np.testing.assert_allclose(raw_t.grad.numpy(), g_raw_j, rtol=1e-3,
                               atol=5e-4)
    assert len(curv) == len(g_c_j)
    for ours, theirs in zip(curv, g_c_j):
        np.testing.assert_allclose(ours.grad.numpy(), theirs, rtol=2e-3,
                                   atol=5e-4)


@pytest.mark.parametrize("spec,scalar_sigma", [("h2,s2,e2", False),
                                               ("h3,e2", True)])
def test_tail_fn_gradcheck_f64(spec, scalar_sigma):
    """torch.autograd.gradcheck of _TailFn (float64, CPU): the backward's
    wiring (raw and curvature; no gradient for the noise) against finite
    differences."""
    tc = tuple(t_parse(spec, fixed_curvature=False,
                       scalar_sigma=scalar_sigma))
    W, E, _ = ttk._dims(tc)
    g = torch.Generator().manual_seed(3)
    raw = torch.randn(6, W, generator=g, dtype=torch.float64)
    eps = ttk.draw_noise(tc, (6,), raw, g)
    k = torch.tensor([-0.7, 1.3, 0.0][:len(tc)], dtype=torch.float64)
    if spec == "h3,e2":
        k = torch.tensor([-0.7, 0.0], dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda r, kk: ttk._TailFn.apply(tc, r, eps, kk),
        (raw.requires_grad_(), k.requires_grad_()))


def test_mu_tan_zero_row_has_finite_gradients():
    """A row whose hyperbolic mean head is exactly 0 puts the clamp of the
    transport's e = max(c (|mu_sp|^2 - (mu_t - R)^2), 0) exactly at its
    bound. The port follows torch.clamp there (the whole gradient passes),
    where jnp.maximum would pass half; the backward kernel follows the
    port's plain version. The gradients stay finite and the float32 plain
    backward agrees with its float64 evaluation at that row."""
    tc = tuple(t_parse("h2,s2,e2", fixed_curvature=False))
    g = torch.Generator().manual_seed(5)
    raw = torch.randn(4, 11, generator=g)
    raw[1, :2] = 0.0
    eps = ttk.draw_noise(tc, (4,), raw, g)
    k = torch.tensor([-1.0, 1.0, 0.0])
    dz = torch.randn(4, 8, generator=g)
    daux = torch.randn(4, 5, generator=g)
    draw, dk, _ = ttk.tail_backward_ref(tc, raw, eps, k, dz, daux)
    assert bool(torch.isfinite(draw).all() and torch.isfinite(dk).all())
    d64, k64, _ = ttk.tail_backward_ref(tc, raw.double(), eps.double(),
                                     k.double(), dz.double(), daux.double())
    np.testing.assert_allclose(draw[1].numpy(), d64[1].numpy(), rtol=1e-3,
                               atol=5e-4)
    np.testing.assert_allclose(dk[1].numpy(), k64[1].numpy(), rtol=1e-3,
                               atol=5e-4)


def test_tail_backward_on_cpu_is_the_plain_version():
    tc = tuple(t_parse("h2,s2,e2", fixed_curvature=False))
    g = torch.Generator().manual_seed(1)
    raw = torch.randn(5, 11, generator=g)
    eps = ttk.draw_noise(tc, (5,), raw, g)
    k = torch.tensor([-1.0, 1.0, 0.0])
    dz, daux = torch.randn(5, 8, generator=g), torch.randn(5, 5, generator=g)
    before = ttk.tail_backward.launches
    got = ttk.tail_backward(tc, raw, eps, k, dz, daux)
    want = ttk.tail_backward_ref(tc, raw, eps, k, dz, daux)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ttk.tail_backward.launches == before
    with pytest.raises(ValueError):
        ttk.tail_backward(tc, raw, eps, k, dz[:, :7], daux)
    with pytest.raises(ValueError):
        ttk.tail_backward(tc, raw, eps, k[:2], dz, daux)


def test_capability_predicate():
    sup = [ttk.component_supported(c) for c in t_parse(
        "h2,s2,e2,s3,s2:wrapped,d2,u2,h33,s32:wrapped,s33:wrapped,p2:vmf")]
    assert sup == [True, True, True, False, True, True, True, False, True,
                   False, False]
    # the tile bakes the sigma cap in: uncapped positive-capable components
    # are outside the family, an uncapped 'd' is not
    sup = [ttk.component_supported(c) for c in t_parse(
        "p2,u2,d2,p33,s6:wrapped", sigma_cap=False)]
    assert sup == [False, False, True, False, False]


# --- the stereographic tile (d/p/u) ---------------------------------------------

# (spec, scalar_sigma, wraps, c_params): the universal tile at K = -1e-3, 0,
# 1e-3 runs both of its run-time branches next to the series window
STEREO = [
    pytest.param("d2,p2,e2", False, 1, None, id="d2p2e2"),
    pytest.param("d2,p2,e2", True, 1, None, id="d2p2e2-scalar"),
    pytest.param("d2,p2,e2", False, 0, None, id="d2p2e2-wraps0"),
    pytest.param("d2,p2,e2", False, 1, (np.log(0.3), np.log(2.5)),
                 id="d2p2e2-K-0.3+2.5"),
    pytest.param("u6", False, 1, None, id="u6"),
    pytest.param("u6", False, 0, (0.5,), id="u6-wraps0"),
    pytest.param("u6", False, 1, (-1.0,), id="u6-K-1"),
    pytest.param("u6", False, 1, (-1e-3,), id="u6-K-1e-3"),
    pytest.param("u6", False, 1, (0.0,), id="u6-K0"),
    pytest.param("u6", False, 1, (1e-3,), id="u6-K+1e-3"),
    pytest.param("p6", False, 1, None, id="p6"),
    pytest.param("p6", True, 1, (np.log(3.0),), id="p6-scalar-K3"),
    pytest.param("d6", False, 1, None, id="d6"),
    pytest.param("u2,h2,p3", False, 1, (0.5, np.log(0.7), np.log(1.3)),
                 id="u2h2p3"),
]


# against reparam_all_jnp in both types, and against the Pallas reparam_all in
# interpret mode in float32 (the TPU kernel's type)
FWD_MODES = [pytest.param(np.float64, 1e-7, 1e-7, False, id="f64-jnp"),
             pytest.param(np.float32, 1e-5, 1e-4, False, id="f32-jnp"),
             pytest.param(np.float32, 1e-5, 1e-4, True, id="f32-pallas")]
BWD_MODES = [pytest.param(np.float64, 1e-7, 1e-7, 1e-7, False, id="f64-jnp"),
             pytest.param(np.float32, 1e-3, 5e-4, 2e-3, False, id="f32-jnp")]
# the interpreted Pallas backward takes 5-20 s a case: one case per family
PALLAS_BWD = [p for p in STEREO
              if p.id in ("d2p2e2", "u6", "u6-K-1e-3", "p6", "d6")]


@pytest.mark.parametrize("dtype,tol,atol,fused", FWD_MODES)
@pytest.mark.parametrize("spec,scalar_sigma,wraps,c_params", STEREO)
def test_stereo_tile_forward_matches_jax(monkeypatch, spec, scalar_sigma,
                                         wraps, c_params, dtype, tol, atol,
                                         fused):
    monkeypatch.setenv("MVAE_FUSED_TAIL", "1")
    _check_tile_forward(spec, scalar_sigma, wraps, c_params, dtype, tol, atol,
                        fused)


def _check_tile_forward(spec, scalar_sigma, wraps, c_params, dtype, tol, atol,
                        fused):
    from mvae_tpu.kernels import tail_kernels as jtk
    jc, tc, params, raw, k_rep = _setup(spec, dtype, scalar_sigma, 1, wraps,
                                        c_params)
    fn = jtk.reparam_all if fused else jtk.reparam_all_jnp
    z_j, lq_j, lp_j, kl_j, kv_j = fn(k_rep, jc, params, raw)
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


def _dk_dc(tc, kvec):
    """dK/dc per component: K for the pinned kinds (K = +-e^c), 1 for the
    universal kind (K = c)."""
    return torch.stack([torch.ones(()) if c.manifold.kind == "u" else k
                        for c, k in zip(tc, kvec.detach())])


@pytest.mark.parametrize("dtype,rtol,atol,ktol,fused", BWD_MODES)
@pytest.mark.parametrize("spec,scalar_sigma,wraps,c_params", STEREO)
def test_stereo_tile_backward_matches_jax(spec, scalar_sigma, wraps,
                                          c_params, dtype, rtol, atol, ktol,
                                          fused):
    """``_TailFn`` under ``loss.backward()`` and ``tail_backward_ref``
    against ``jax.grad`` of ``reparam_all_jnp``, the curvature gradient
    included."""
    _check_stereo_backward(spec, scalar_sigma, wraps, c_params, dtype, rtol,
                           atol, ktol, fused)


@pytest.mark.parametrize("spec,scalar_sigma,wraps,c_params", PALLAS_BWD)
def test_stereo_tile_backward_matches_pallas_bwd_interpret(
        monkeypatch, spec, scalar_sigma, wraps, c_params):
    """Against the JAX kernel's own backward (``_bwd_pallas`` in interpret
    mode, MVAE_FUSED_TAIL=1), float32, the curvature gradient included."""
    monkeypatch.setenv("MVAE_FUSED_TAIL", "1")
    _check_stereo_backward(spec, scalar_sigma, wraps, c_params, np.float32,
                           1e-3, 5e-4, 2e-3, True)


def _check_stereo_backward(spec, scalar_sigma, wraps, c_params, dtype, rtol,
                           atol, ktol, fused):
    import jax
    from mvae_tpu.kernels import tail_kernels as jtk
    jc, tc, params, raw, k_rep = _setup(spec, dtype, scalar_sigma, 2, wraps,
                                        c_params)
    g_raw_j, g_c_j = _jax_grads(jc, params, raw, k_rep, fused=fused)
    eps = torch.from_numpy(np.asarray(
        jtk.draw_noise_t(k_rep, jc, B, dtype)).T.copy())
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    curv = [cp["c_param"].requires_grad_() for cp in tparams
            if "c_param" in cp]
    raw_t = torch.from_numpy(raw).requires_grad_()
    z, lq, lp, kl, kvec = ttk.reparam_all(tc, tparams, raw_t, noise=eps)
    (torch.mean(torch.sum(z * z, -1)) + torch.mean(kl)
     + 0.1 * torch.mean(lq - lp)).backward()
    np.testing.assert_allclose(raw_t.grad.numpy(), g_raw_j, rtol=rtol,
                               atol=atol)
    assert len(curv) == len(g_c_j)
    for ours, theirs in zip(curv, g_c_j):
        np.testing.assert_allclose(ours.grad.numpy(), theirs, rtol=ktol,
                                   atol=atol)
    if fused:
        return
    nc = len(tc)
    daux = torch.from_numpy(_loss_cotangents(B, z.shape[1], nc, dtype))
    draw, dk_rows, _ = ttk.tail_backward_ref(tc, torch.from_numpy(raw), eps,
                                          kvec.detach(),
                                          2.0 * z.detach() / B, daux)
    np.testing.assert_allclose(draw.numpy(), g_raw_j, rtol=rtol, atol=atol)
    dc = (dk_rows.sum(0) * _dk_dc(tc, kvec)).numpy()
    idx = [i for i, c in enumerate(tc) if c.manifold.has_curvature_param]
    for i, theirs in zip(idx, g_c_j):
        np.testing.assert_allclose(dc[i], theirs, rtol=ktol, atol=atol)


@pytest.mark.parametrize("spec,kset,scalar_sigma,wraps", [
    ("d2,p2,e2", (-0.7, 1.3, 0.0), False, 1),
    ("d2,p2", (-0.7, 1.3), True, 0),
    ("u3", (0.8,), False, 1), ("u3", (-0.8,), False, 1),
    ("u3", (1e-3,), False, 1), ("u3", (-1e-3,), False, 1)])
def test_stereo_tail_fn_gradcheck_f64(spec, kset, scalar_sigma, wraps):
    """torch.autograd.gradcheck of _TailFn over the stereographic tile
    (float64, CPU): raw heads and curvature against finite differences,
    the sigma heads large enough that the cap's gradient matters."""
    tc = tuple(t_parse(spec, fixed_curvature=False,
                       scalar_sigma=scalar_sigma, wraps=wraps))
    W, E, _ = ttk._dims(tc)
    g = torch.Generator().manual_seed(4)
    raw = torch.randn(5, W, generator=g, dtype=torch.float64)
    raw[::2] += 1.0
    eps = ttk.draw_noise(tc, (5,), raw, g)
    k = torch.tensor(kset, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda r, kk: ttk._TailFn.apply(tc, r, eps, kk),
        (raw.requires_grad_(), k.requires_grad_()))


@pytest.mark.parametrize("kset", [(-1.0, 1.0, 1.0), (-1e-3, 1e-3, 1e-3),
                                  (-1.0, 1.0, 0.0), (-1.0, 1.0, -1e-3)])
def test_stereo_tie_rows_have_finite_gradients(kset):
    """Rows at the ties of the stereographic tile: mu_tan = 0 with eps = 0
    (every norm at its floor), mu_tan = 0 alone, eps = 0 alone, a saturated
    sigma cap, and a point pushed to the K < 0 ball's rim. Values and
    gradients stay finite in float32, and on the rows float32 resolves (all
    but the rim) the plain backward agrees with its float64 evaluation."""
    tc = tuple(t_parse("d2,p2,u2", fixed_curvature=False))
    g = torch.Generator().manual_seed(6)
    raw = 0.5 * torch.randn(6, 12, generator=g)
    eps = ttk.draw_noise(tc, (6,), raw, g)
    mu_cols = [0, 1, 4, 5, 8, 9]
    sig_cols = [6, 7, 10, 11]                # of p2 and u2: the capped kinds
    raw[0, mu_cols] = 0.0
    eps[0] = 0.0
    raw[1, mu_cols] = 0.0
    eps[2] = 0.0
    raw[3, sig_cols] = 9.0                   # sigma far beyond the cap
    raw[4, mu_cols] = 40.0                   # the rim of the ball
    k = torch.tensor(kset)
    dz = torch.randn(6, 6, generator=g)
    daux = torch.randn(6, 5, generator=g)
    z, aux = ttk.tail_forward_ref(tc, raw, eps, k)
    assert bool(torch.isfinite(z).all() and torch.isfinite(aux).all())
    draw, dk, _ = ttk.tail_backward_ref(tc, raw, eps, k, dz, daux)
    assert bool(torch.isfinite(draw).all() and torch.isfinite(dk).all())
    d64, k64, _ = ttk.tail_backward_ref(tc, raw.double(), eps.double(),
                                     k.double(), dz.double(), daux.double())
    rows = [0, 1, 2, 3, 5]
    np.testing.assert_allclose(draw[rows].numpy(), d64[rows].numpy(),
                               rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(dk[rows].numpy(), k64[rows].numpy(),
                               rtol=2e-3, atol=5e-4)


# --- the embedded-sphere tile (wrapped on s) ------------------------------------

# (spec, scalar_sigma, wraps, c_params): K = e^c in {1, 1e-3, 4}; the
# reference's own products (tests/kernels/test_tail_kernels.py SPECS)
SPHERE = [
    pytest.param("s6:wrapped", False, 1, None, id="s6w"),
    pytest.param("s6:wrapped", False, 1, (np.log(1e-3),), id="s6w-K1e-3"),
    pytest.param("s6:wrapped", False, 1, (np.log(4.0),), id="s6w-K4"),
    pytest.param("s6:wrapped", True, 1, (np.log(4.0),), id="s6w-scalar-K4"),
    pytest.param("s6:wrapped", False, 0, None, id="s6w-wraps0"),
    pytest.param("s4:wrapped,s2", False, 1, (np.log(2.5), 0.0), id="s4w-s2"),
    pytest.param("s3:wrapped,h2,e2", False, 1, None, id="s3w-h2-e2"),
    pytest.param("s32:wrapped", False, 1, (np.log(0.25),), id="s32w"),
]
SPHERE_PALLAS_BWD = [p for p in SPHERE
                     if p.id in ("s6w", "s6w-K4", "s3w-h2-e2")]


@pytest.mark.parametrize("dtype,tol,atol,fused", FWD_MODES)
@pytest.mark.parametrize("spec,scalar_sigma,wraps,c_params", SPHERE)
def test_sphere_tile_forward_matches_jax(monkeypatch, spec, scalar_sigma,
                                         wraps, c_params, dtype, tol, atol,
                                         fused):
    """``_tile_wrapped_sphere`` inside ``tail_forward_ref`` against the
    reference's tile (``reparam_all_jnp``, and the Pallas kernel in
    interpret mode): 1e-7 in float64, 1e-5 relative with a 1e-4 floor in
    float32."""
    monkeypatch.setenv("MVAE_FUSED_TAIL", "1")
    _check_tile_forward(spec, scalar_sigma, wraps, c_params, dtype, tol, atol,
                        fused)


@pytest.mark.parametrize("dtype,rtol,atol,ktol,fused", BWD_MODES)
@pytest.mark.parametrize("spec,scalar_sigma,wraps,c_params", SPHERE)
def test_sphere_tile_backward_matches_jax(spec, scalar_sigma, wraps, c_params,
                                          dtype, rtol, atol, ktol, fused):
    """``_TailFn`` under ``loss.backward()`` and ``tail_backward_ref`` over
    the sphere tile against ``jax.grad`` of the reference's tile, the
    curvature gradient included."""
    _check_stereo_backward(spec, scalar_sigma, wraps, c_params, dtype, rtol,
                           atol, ktol, fused)


@pytest.mark.parametrize("spec,scalar_sigma,wraps,c_params",
                         SPHERE_PALLAS_BWD)
def test_sphere_tile_backward_matches_pallas_bwd_interpret(
        monkeypatch, spec, scalar_sigma, wraps, c_params):
    """Against the JAX kernel's own backward (``_bwd_pallas`` in interpret
    mode differentiates the tile in-kernel), float32."""
    monkeypatch.setenv("MVAE_FUSED_TAIL", "1")
    _check_stereo_backward(spec, scalar_sigma, wraps, c_params, np.float32,
                           1e-3, 5e-4, 2e-3, True)


@pytest.mark.parametrize("spec,kset,scalar_sigma,wraps", [
    ("s3:wrapped", (1.3,), False, 1), ("s3:wrapped", (0.2,), True, 1),
    ("s2:wrapped,h2", (2.5, -0.7), False, 0),
    ("s4:wrapped", (1e-3,), False, 1)])
def test_sphere_tail_fn_gradcheck_f64(spec, kset, scalar_sigma, wraps):
    """torch.autograd.gradcheck of _TailFn over the sphere tile (float64,
    CPU), the sigma heads large enough that the cap's gradient matters."""
    tc = tuple(t_parse(spec, fixed_curvature=False,
                       scalar_sigma=scalar_sigma, wraps=wraps))
    W, E, _ = ttk._dims(tc)
    g = torch.Generator().manual_seed(4)
    raw = torch.randn(5, W, generator=g, dtype=torch.float64)
    raw[::2] += 1.0
    eps = ttk.draw_noise(tc, (5,), raw, g)
    k = torch.tensor(kset, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda r, kk: ttk._TailFn.apply(tc, r, eps, kk),
        (raw.requires_grad_(), k.requires_grad_()))


@pytest.mark.parametrize("kval", [1.0, 1e-3, 4.0])
def test_sphere_tie_rows_have_finite_gradients(kval):
    """Rows at the ties of the sphere tile: mu_tan = 0 with eps = 0 (the norm
    pin nv / nw at 0 / 0 gives 1), mu_tan = 0 alone, eps = 0 alone, a
    saturated sigma cap, the mean at the antipode of mu0 (the transport's
    denominator at its floor) and the mean there with eps = 0 (z at the
    antipode: the half chord at its cap). Values and gradients stay finite
    in float32, and on the rows float32 resolves (all but the two antipode
    rows, whose floors sit elsewhere in float64) the plain backward agrees
    with its float64 evaluation."""
    tc = tuple(t_parse("s3:wrapped,s2:wrapped", fixed_curvature=False,
                       scalar_sigma=False))
    g = torch.Generator().manual_seed(6)
    raw = 0.5 * torch.randn(7, 11, generator=g) / kval ** 0.5
    eps = ttk.draw_noise(tc, (7,), raw, g)
    mu_cols = [0, 1, 2, 6, 7]
    sig_cols = [3, 4, 5, 8, 9]
    raw[:, sig_cols] = raw[:, sig_cols] * kval ** 0.5 - 1.0
    raw[0, mu_cols] = 0.0
    eps[0] = 0.0
    raw[1, mu_cols] = 0.0
    eps[2] = 0.0
    raw[3, sig_cols] = 12.0 * np.pi / kval ** 0.5    # far beyond the cap
    raw[4:6, mu_cols] = 0.0
    raw[4:6, 0] = np.pi / kval ** 0.5
    raw[4:6, 6] = np.pi / kval ** 0.5
    eps[5] = 0.0
    k = torch.tensor([kval, kval])
    dz = torch.randn(7, 7, generator=g)
    daux = torch.randn(7, 4, generator=g)
    z, aux = ttk.tail_forward_ref(tc, raw, eps, k)
    assert bool(torch.isfinite(z).all() and torch.isfinite(aux).all())
    # every z on the sphere of radius 1 / sqrt(K)
    np.testing.assert_allclose((z[:, :4] ** 2).sum(1).numpy() * kval, 1.0,
                               rtol=1e-5)
    draw, dk, _ = ttk.tail_backward_ref(tc, raw, eps, k, dz, daux)
    assert bool(torch.isfinite(draw).all() and torch.isfinite(dk).all())
    d64, k64, _ = ttk.tail_backward_ref(tc, raw.double(), eps.double(),
                                     k.double(), dz.double(), daux.double())
    rows = [0, 1, 2, 3, 6]
    scale = d64[rows].abs().amax(1, keepdim=True).numpy()
    assert np.all(np.abs(draw[rows].numpy() - d64[rows].numpy())
                  <= 1e-3 * scale + 5e-4)
    np.testing.assert_allclose(dk[rows].numpy(), k64[rows].numpy(),
                               rtol=2e-3, atol=5e-4)


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
    # an input that needs a gradient goes through the same kernel
    z_g, _ = ttk.tail_forward(comps, raw.requires_grad_(), eps, k)
    assert torch.equal(z_g, z)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [128, 1000])
def test_backward_kernel_matches_plain_version_on_card(cuda_device, batch):
    """B3 against autograd through the plain forward, at heads of the
    magnitude training produces (|raw| ~ N(0, 1)), where the float32 plain
    backward resolves every row; the float32 backward contract."""
    comps = tuple(t_parse("h2,s2,e2", fixed_curvature=False))
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for kset in ((-1.0, 1.0, 0.0), (-1e-2, 1e-2, 0.0)):
        raw = torch.randn(batch, 11, generator=gen, device=cuda_device)
        eps = ttk.draw_noise(comps, (batch,), raw, gen)
        k = torch.tensor(kset, device=cuda_device)
        dz = torch.randn(batch, 8, generator=gen, device=cuda_device)
        daux = torch.randn(batch, 5, generator=gen, device=cuda_device)
        before = ttk.tail_backward.launches
        draw, dk, _ = ttk.tail_backward(comps, raw, eps, k, dz, daux)
        draw_r, dk_r, _ = ttk.tail_backward_ref(comps, raw, eps, k, dz, daux)
        torch.cuda.synchronize()
        assert ttk.tail_backward.launches == before + 1
        assert bool(((draw - draw_r).abs()
                     <= 1e-3 * draw_r.abs() + 5e-4).all())
        dks, dks_r = dk.sum(0), dk_r.sum(0)
        assert bool(((dks - dks_r).abs() <= 2e-3 * dks_r.abs() + 5e-4).all())


STEREO_CARD = [("d2,p2,e2", (-1.0, 1.0, 0.0)), ("d2,p2,e2", (-1e-3, 1e-3, 0.0)),
               ("u6", (1.0,)), ("u6", (-1.0,)), ("u6", (0.0,)),
               ("u6", (1e-3,)), ("u6", (-1e-3,)), ("p6", (1.0,)),
               ("d6", (-1.0,)),
               ("s6:wrapped", (1.0,)), ("s6:wrapped", (1e-3,)),
               ("s6:wrapped", (4.0,)), ("s3:wrapped,h2,e2", (1.0, -1.0, 0.0)),
               ("s4:wrapped,s2", (2.5, 1.0)), ("s32:wrapped", (0.25,))]


def _stereo_card_inputs(comps, batch, kset, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    W, _, Z = ttk._dims(comps)
    raw = 0.5 * torch.randn(batch, W, generator=gen, device=device)
    eps = ttk.draw_noise(comps, (batch,), raw, gen)
    raw[0], eps[0] = 0.0, 0.0                # mu_tan = 0, eps = 0
    k = torch.tensor(kset, device=device)
    dz = torch.randn(batch, Z, generator=gen, device=device)
    daux = torch.randn(batch, len(comps) + 2, generator=gen, device=device)
    return raw, eps, k, dz, daux


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [128, 512])
@pytest.mark.parametrize("spec,kset", STEREO_CARD)
def test_stereo_tile_kernels_match_plain_version_on_card(cuda_device, spec,
                                                         kset, batch):
    """B1 and B3 over the stereographic and the embedded-sphere tiles against
    the plain versions, at
    heads of the size training produces: z within 1e-5 (1 + |z|), the
    log-densities within 1e-4 (1 + 0.01 |ref|), the backward within the
    float32 contract."""
    comps = tuple(t_parse(spec, fixed_curvature=False))
    raw, eps, k, dz, daux = _stereo_card_inputs(comps, batch, kset,
                                                cuda_device, 3)
    z, aux = ttk.tail_forward(comps, raw, eps, k)
    z_r, aux_r = ttk.tail_forward_ref(comps, raw, eps, k)
    draw, dk, _ = ttk.tail_backward(comps, raw, eps, k, dz, daux)
    draw_r, dk_r, _ = ttk.tail_backward_ref(comps, raw, eps, k, dz, daux)
    torch.cuda.synchronize()
    assert bool(((z - z_r).abs() <= 1e-5 * (1 + z_r.abs())).all())
    assert bool(((aux - aux_r).abs() <= 1e-4 * (1 + 1e-2 * aux_r.abs()))
                .all())
    assert bool(torch.isfinite(draw).all() and torch.isfinite(dk).all())
    assert bool(((draw - draw_r).abs() <= 1e-3 * draw_r.abs() + 5e-4).all())
    dks, dks_r = dk.sum(0), dk_r.sum(0)
    assert bool(((dks - dks_r).abs() <= 2e-3 * dks_r.abs() + 5e-4).all())


# The launch geometry (32 rows a block, a warp a component) on ragged
# batches, for every kind, each instantiation (n = 2, 3, 6 and the generic
# one) and nc = 16 (two components a warp)
NC16 = "h2,s2,e2,d2,p2,u2,h2,e2,d2,p2,u2,h2,s2,e2,s2:wrapped,e2"
GEOMETRY_CARD = [
    ("h2,s2,e2", (-1.0, 1.0, 0.0)), ("d2,p2,e2", (-1.0, 1.0, 0.0)),
    ("u6", (0.5,)), ("s6:wrapped", (1.0,)), ("p3,h3,s3:wrapped", (1.0, -1.0,
                                                                  1.0)),
    ("h7,e12", (-0.7, 0.0)), ("s3:wrapped,h2,e2", (1.0, -1.0, 0.0)),
    (NC16, (-1.0, 1.0, 0.0, -0.5, 0.8, 0.3, -2.0, 0.0, -1e-3, 1e-3, -0.4,
            -0.3, 2.0, 0.0, 1.5, 0.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 31, 33, 127, 129, 512, 1000])
@pytest.mark.parametrize("spec,kset", GEOMETRY_CARD)
def test_kernels_geometry_on_card(cuda_device, spec, kset, batch):
    """B1 and B3 on ragged batches against the plain versions: z within
    1e-5 (1 + |z|), the log-densities within 1e-4 (1 + 0.01 |ref|), the
    raw gradient within the float32 backward contract, the folded
    curvature gradient equal to the fold of the kernel's rows and held to
    the plain version's ``dk_rows.sum(0)`` by the batch-summed contract
    (rtol 2e-3 where float32 resolves the sum), one launch each."""
    comps = tuple(t_parse(spec, fixed_curvature=False))
    raw, eps, k, dz, daux = _stereo_card_inputs(comps, batch, kset,
                                                cuda_device, 5)
    fwd, bwd = ttk.tail_forward.launches, ttk.tail_backward.launches
    z, aux = ttk.tail_forward(comps, raw, eps, k)
    draw, dk_rows, dk = ttk.tail_backward(comps, raw, eps, k, dz, daux)
    z_r, aux_r = ttk.tail_forward_ref(comps, raw, eps, k)
    draw_r, dk_rows_r, dk_r = ttk.tail_backward_ref(comps, raw, eps, k, dz,
                                                    daux)
    torch.cuda.synchronize()
    assert (ttk.tail_forward.launches, ttk.tail_backward.launches) == (
        fwd + 1, bwd + 1)
    assert bool(((z - z_r).abs() <= 1e-5 * (1 + z_r.abs())).all())
    assert bool(((aux - aux_r).abs() <= 1e-4 * (1 + 1e-2 * aux_r.abs()))
                .all())
    assert bool(torch.isfinite(draw).all() and torch.isfinite(dk_rows).all())
    assert bool(((draw - draw_r).abs() <= 1e-3 * draw_r.abs() + 5e-4).all())
    assert torch.equal(dk_r, dk_rows_r.sum(0))
    # the fold is of the kernel's own rows, in its order
    assert torch.equal(dk, ttk.fold_rows_ref(dk_rows))
    # against the plain version's sum: the batch-summed contract (rtol
    # 2e-3) where the float32 plain sum is within a tenth of it of float64;
    # where it is not (a sum that cancels terms of size 1 / K), no farther
    # from float64 than ten times the plain sum
    dk64 = ttk.tail_backward_ref(
        comps, *[t.double() for t in (raw, eps, k, dz, daux)])[2]
    tol = 2e-3 * dk_r.abs() + 5e-4
    plain_err = (dk_r.double() - dk64).abs()
    res = plain_err <= 0.1 * tol
    assert bool(((dk - dk_r).abs() <= tol)[res].all())
    assert bool(((dk.double() - dk64).abs() <= 10 * (plain_err + tol)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("spec,kset", [("h2,s2,e2", (-1.0, 1.0, 0.0)),
                                       ("d2,p2,e2", (-1.0, 1.0, 0.0)),
                                       ("s6:wrapped", (1.0,)),
                                       ("u6", (0.5,))])
def test_backward_graph_replays_bit_equal_on_card(cuda_device, spec, kset):
    """B3 captured in a CUDA graph and replayed ten times: every output,
    the folded curvature gradient included, equal bit for bit to the eager
    call's (the fold's counters are back at zero after every launch)."""
    comps = tuple(t_parse(spec, fixed_curvature=False))
    args = _stereo_card_inputs(comps, 128, kset, cuda_device, 6)
    eager = ttk.tail_backward(comps, *args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ttk.tail_backward(comps, *args)
    for _ in range(10):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert not ttk._fold_counter(args[0].device).any()


@pytest.mark.cuda
def test_tail_fn_backward_issues_no_sum_on_card(cuda_device):
    """``_TailFn``'s backward on the card takes the folded curvature
    gradient from the kernel: no sum op after B3."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    comps = tuple(t_parse("h2,s2,e2", fixed_curvature=False))
    raw, eps, k, dz, daux = _stereo_card_inputs(comps, 128,
                                                (-1.0, 1.0, 0.0),
                                                cuda_device, 7)
    raw.requires_grad_(True)
    k.requires_grad_(True)
    z, aux = ttk._TailFn.apply(comps, raw, eps, k)
    before = ttk.tail_backward.launches
    with Ops() as ops:
        torch.autograd.backward((z, aux), (dz, daux))
    assert ttk.tail_backward.launches == before + 1
    assert any("empty" in n for n in ops.names), ops.names  # ops recorded
    assert not [n for n in ops.names if "sum" in n], ops.names
    dk_r = ttk.tail_backward_ref(comps, raw.detach(), eps, k.detach(), dz,
                                 daux)[2]
    assert bool(((k.grad - dk_r).abs() <= 2e-3 * dk_r.abs() + 5e-4).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tail kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def previous_design(tmp_path_factory):
    """The tail kernels' previous design (``scripts/tail_previous``: every
    product on the warp-a-component geometry, each tile serial on one
    thread) and B5 built on its tiles, compiled by nvcc: {"fwd", "bwd",
    "reparam"} launch entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU mode")
    import shutil
    from pathlib import Path

    from mvae_torch.kernels import _build
    from mvae_torch.kernels import manifold_kernels as tmk

    prev = Path(__file__).resolve().parents[1] / "scripts" / "tail_previous"
    work = tmp_path_factory.mktemp("tail_previous")
    shutil.copy(_build.CSRC / "reparam_stereo.cu", work)
    shutil.copy(prev / "tail_tiles.cuh", work)
    built = _build.build_variants({
        "fwd": (prev / "tail_fwd.cu", _build.EXTRA_FLAGS["tail_fwd"]),
        "bwd": (prev / "tail_bwd.cu", _build.EXTRA_FLAGS["tail_bwd"]),
        "reparam": (work / "reparam_stereo.cu",
                    _build.EXTRA_FLAGS["reparam_stereo"])}, work / "build")
    return {"fwd": ttk.bind_tail(built["fwd"][0])["fwd"],
            "bwd": ttk.bind_tail(built["bwd"][0])["bwd"],
            "reparam": tmk.bind_reparam(built["reparam"][0])}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 128, 256, 512])
@pytest.mark.parametrize("spec,kset", [("h2,s2,e2", (-1.0, 1.0, 0.0)),
                                       ("d2,p2,e2", (-1.0, 1.0, 0.0)),
                                       ("u6", (0.5,)),
                                       ("s6:wrapped", (1.0,))])
def test_kernels_against_previous_design_on_card(previous_design, spec, kset,
                                                 batch):
    """B1 and B3 against their previous design on the card: the forward's
    z and aux bit for bit (the split geometry evaluates the previous tiles'
    expressions and sums in the same order), the backward within the
    float32 backward contract of it (rtol 1e-3 / atol 5e-4 on the raw
    gradient, rtol 2e-3 on the folded curvature gradient), its fold equal
    to the fold of its own rows."""
    comps = tuple(t_parse(spec, fixed_curvature=False))
    raw, eps, k, dz, daux = _stereo_card_inputs(comps, batch, kset,
                                                torch.device("cuda"), 8)
    z, aux = ttk.tail_forward(comps, raw, eps, k)
    z0, aux0 = ttk.tail_forward_launch(previous_design["fwd"], comps, raw,
                                       eps, k)
    draw, dk_rows, dk = ttk.tail_backward(comps, raw, eps, k, dz, daux)
    d0, _, k0 = ttk.tail_backward_launch(previous_design["bwd"], comps, raw,
                                         eps, k, dz, daux)
    torch.cuda.synchronize()
    assert torch.equal(z, z0) and torch.equal(aux, aux0)
    assert bool(((draw - d0).abs() <= 1e-3 * d0.abs() + 5e-4).all())
    assert bool(((dk - k0).abs() <= 2e-3 * k0.abs() + 5e-4).all())
    assert torch.equal(dk, ttk.fold_rows_ref(dk_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("wraps", [0, 1])
@pytest.mark.parametrize("sign,kval", [(-1, -1.0), (-1, -1e-3), (0, -0.5),
                                       (0, 0.0), (0, 1e-3), (0, 0.9),
                                       (1, 1.0), (1, 1e-3)])
@pytest.mark.parametrize("n", [2, 6])
def test_reparam_bit_equal_on_previous_tiles_on_card(previous_design, n,
                                                     sign, kval, wraps):
    """B5 (``csrc/reparam_stereo.cu``, a thread a point through
    ``stereo_draw_at``) against itself built on the previous design's tiles,
    bit for bit, at the IWAE chunk (S, B) = (125, 512): the split tail's
    refactoring of the shared device functions leaves B5's arithmetic as it
    was."""
    from mvae_torch.kernels import manifold_kernels as tmk

    g = torch.Generator(device="cuda").manual_seed(100 * n + 10 * sign + wraps)
    S, Bb = 125, 512
    eps = torch.randn(S, Bb, n + 2, generator=g, device="cuda")[..., 1:1 + n]
    k = torch.tensor(kval, device="cuda")
    mu = 0.3 * torch.randn(Bb, n, generator=g, device="cuda")
    if kval < 0:
        mu = 0.5 * mu / max(-kval, 1.0) ** 0.5
    sig = 0.2 + torch.rand(Bb, n, generator=g, device="cuda")
    out = torch.zeros(S, n + 2, Bb, device="cuda")
    got = tmk.wrapped_reparam_stereo_t(eps, mu, sig, k, wraps=wraps,
                                       sign=sign, out=out, z_off=1)
    out0 = torch.zeros_like(out)
    lq0 = torch.empty(S, Bb, device="cuda")
    lp0 = torch.empty(S, Bb, device="cuda")
    tmk.reparam_launch(previous_design["reparam"], eps, mu, sig,
                       k.reshape(1), out0, 1, lq0, lp0, sign, wraps)
    torch.cuda.synchronize()
    assert torch.equal(out, out0)
    assert torch.equal(got[1], lq0) and torch.equal(got[2], lp0)
