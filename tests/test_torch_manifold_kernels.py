"""The IWAE chunk reparam (``mvae_torch.kernels.manifold_kernels``) against
the JAX package: its plain version ``wrapped_reparam_stereo_ref`` against
the Pallas kernel ``wrapped_reparam_stereo_t`` in interpret mode (the same
Gram-coefficient expressions), against the oracle ``_wrapped_reparam_jnp``
(the library composition sample projection + drawn-radius log q + prior
log p) and against the port's own composition; the wrapper's CPU dispatch,
output buffer and checks; and the CUDA kernel against the plain version on
the card.

Tolerances. Against the Pallas kernel in float32: z rtol 3e-5 / atol 1e-6,
log-densities rtol 1e-4 / atol 3e-4 (the same expressions; the reference
spells atan as a polynomial within 6.3e-9 of it and tan as sin / cos, and
log q near the K > 0 antipode amplifies last-digit differences). Against
the composition: the reference's own bounds for its kernel
(tests/kernels/test_manifold_kernels.py: z rtol 3e-5 / atol 1e-6,
log-densities rtol 1e-4 / atol 3e-3) in float32, and 1e-8 in float64. On
the card kernel and plain version run the same float32 operations: z within
1e-5 (1 + |z|), log-densities within 1e-4 where float32 resolves them.

The distance kernels' plain versions ``stereo_distance_ref`` and
``lorentz_distance_ref`` are held within 1e-5 relative of the JAX kernels in
interpret mode (the same Gram-form expressions; the reference spells atan
as a polynomial) and of the library ops ``ops.*.distance``; the gradients
in x, y and k, which both packages take through the library op, within
1e-4 relative. On the card the kernels sum a row across a warp, in another
order than PyTorch's reduction: 1e-5 (1 + |ref|), except next to the K < 0
ball's rim, where the atanh clamp amplifies the last digit of the Gram
values (held there against float64 like every such entry).

The JAX package is imported inside the CPU tests only, so the card tests
also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_manifold_kernels.py
"""
import numpy as np
import pytest
import torch

from mvae_torch.distributions import wrapped_normal as t_wn
from mvae_torch.kernels import manifold_kernels as tmk
from mvae_torch.ops import Manifold, stereographic as t_stereo

KS = [-1.0, -0.2, 0.0, 0.3, 0.9]


def _setup(seed, S=16, n=4, b=200, k=0.5, mu_scale=0.3, sig_lo=0.2,
           sig_hi=1.2, dtype=np.float32):
    """eps (S, b, n), mu (b, n) on the manifold, sigma (b, n), from numpy."""
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal((S, b, n)).astype(dtype)
    mu = t_stereo.exp_map_mu0(
        torch.from_numpy((mu_scale * rng.standard_normal((b, n)))
                         .astype(dtype)), torch.tensor(k, dtype=_tt(dtype)))
    sig = (sig_lo + (sig_hi - sig_lo) * rng.random((b, n))).astype(dtype)
    return eps, mu.numpy(), sig


def _tt(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def _ref(eps, mu, sig, k, wraps, sign=0):
    dt = _tt(eps.dtype)
    return [t.numpy() for t in tmk.wrapped_reparam_stereo_ref(
        torch.from_numpy(eps), torch.from_numpy(mu), torch.from_numpy(sig),
        torch.tensor(k, dtype=dt), wraps=wraps, sign=sign)]


def _sign(k, pinned):
    return 0 if not pinned or k == 0 else (1 if k > 0 else -1)


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("wraps", [0, 1])
@pytest.mark.parametrize("k", KS)
def test_ref_matches_pallas_kernel_interpret(k, wraps, pinned):
    import jax.numpy as jnp
    from mvae_tpu.kernels import manifold_kernels as jmk
    eps, mu, sig = _setup(4, k=k)
    sign = _sign(k, pinned)
    z_j, lq_j, lp_j = jmk.wrapped_reparam_stereo_t(
        jnp.asarray(eps.transpose(2, 0, 1)), jnp.asarray(mu.T),
        jnp.asarray(sig.T), jnp.float32(k), wraps=wraps, sign=sign)
    z, lq, lp = _ref(eps, mu, sig, k, wraps, sign)
    np.testing.assert_allclose(z, np.asarray(z_j).transpose(1, 0, 2),
                               rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(lq, np.asarray(lq_j), rtol=1e-4, atol=3e-4)
    np.testing.assert_allclose(lp, np.asarray(lp_j), rtol=1e-4, atol=3e-4)


@pytest.mark.parametrize("dtype,ztol,ltol", [
    pytest.param(np.float32, (3e-5, 1e-6), (1e-4, 3e-3), id="f32"),
    pytest.param(np.float64, (1e-8, 1e-10), (1e-8, 1e-8), id="f64")])
@pytest.mark.parametrize("wraps", [0, 1])
@pytest.mark.parametrize("k", KS)
def test_ref_matches_jax_composition(k, wraps, dtype, ztol, ltol):
    import jax.numpy as jnp
    from mvae_tpu.kernels import manifold_kernels as jmk
    eps, mu, sig = _setup(4, k=k, dtype=dtype)
    z_j, lq_j, lp_j = jmk._wrapped_reparam_jnp(
        jnp.asarray(eps.transpose(2, 0, 1)), jnp.asarray(mu.T),
        jnp.asarray(sig.T), jnp.asarray(k, dtype), wraps=wraps)
    z, lq, lp = _ref(eps, mu, sig, k, wraps)
    np.testing.assert_allclose(z, np.asarray(z_j).transpose(1, 0, 2),
                               rtol=ztol[0], atol=ztol[1])
    np.testing.assert_allclose(lq, np.asarray(lq_j), rtol=ltol[0],
                               atol=ltol[1])
    np.testing.assert_allclose(lp, np.asarray(lp_j), rtol=ltol[0],
                               atol=ltol[1])


@pytest.mark.parametrize("kind,k", [("d", -1.0), ("d", -1e-3), ("p", 1.0),
                                    ("p", 1e-3), ("u", -0.5), ("u", 0.0),
                                    ("u", 0.7)])
@pytest.mark.parametrize("wraps", [0, 1])
def test_ref_matches_port_composition_f64(kind, k, wraps):
    """The Gram-coefficient form against the port's own library path
    (sample_projection_mu0 + _sample_log_prob_drawn + log_prob_mu0) in
    float64: 1e-8 (the two are equal in exact arithmetic)."""
    eps, mu, sig = _setup(6, n=3, k=k, dtype=np.float64)
    man = Manifold(kind, 3)
    kt = torch.tensor(k, dtype=torch.float64)
    v = torch.from_numpy(eps * sig)
    z_c = man.sample_projection_mu0(v, torch.from_numpy(mu), kt)
    lq_c = t_wn._sample_log_prob_drawn(man, v, torch.from_numpy(sig), kt,
                                       wraps)
    lp_c = t_wn.log_prob_mu0(man, z_c, torch.ones((), dtype=torch.float64),
                             kt, wraps=wraps)
    z, lq, lp = _ref(eps, mu, sig, k, wraps, man.curvature_sign)
    np.testing.assert_allclose(z, z_c.numpy().transpose(0, 2, 1), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(lq, lq_c.numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(lp, lp_c.numpy(), rtol=1e-8, atol=1e-8)


def test_wrap_images_carry_mass_at_large_sigma():
    """Large sigma on K > 0 puts mass on the wrap images: wraps = 1 tracks
    the JAX oracle in float64 and differs measurably from wraps = 0."""
    import jax.numpy as jnp
    from mvae_tpu.kernels import manifold_kernels as jmk
    eps, mu, sig = _setup(5, k=1.0, sig_lo=1.8, sig_hi=2.5,
                          dtype=np.float64)
    _, lq_j, lp_j = jmk._wrapped_reparam_jnp(
        jnp.asarray(eps.transpose(2, 0, 1)), jnp.asarray(mu.T),
        jnp.asarray(sig.T), jnp.float64(1.0), wraps=1)
    _, lq1, lp1 = _ref(eps, mu, sig, 1.0, 1)
    _, lq0, _ = _ref(eps, mu, sig, 1.0, 0)
    np.testing.assert_allclose(lq1, np.asarray(lq_j), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(lp1, np.asarray(lp_j), rtol=1e-8, atol=1e-8)
    assert float(np.abs(lq1 - lq0).max()) > 1e-3


def test_negative_k_boundary_stays_in_ball():
    """Huge tangents may not escape the K < 0 ball, and the densities stay
    finite (their value there is set by the clamps)."""
    eps, mu, _ = _setup(7, mu_scale=3.0, k=-1.0)
    sig = np.full(mu.shape, 40.0, np.float32)
    z, lq, lp = _ref(eps, mu, sig, -1.0, 1, -1)
    assert float(np.sqrt((z * z).sum(1)).max()) <= (1 - 1e-6) * (1 + 1e-6)
    assert np.isfinite(lq).all() and np.isfinite(lp).all()


def test_wrapper_on_cpu_is_the_plain_version():
    eps, mu, sig = _setup(8, S=5, n=2, b=33, k=0.7)
    g = torch.Generator().manual_seed(0)
    noise = torch.randn(5, 33, 7, generator=g)
    noise[..., 3:5] = torch.from_numpy(eps)
    args = (torch.from_numpy(mu), torch.from_numpy(sig), torch.tensor(0.7))
    before = tmk.wrapped_reparam_stereo_t.launches
    want = tmk.wrapped_reparam_stereo_ref(torch.from_numpy(eps), *args,
                                          wraps=1, sign=1)
    # a strided view of a wider noise block, into rows 1:3 of a buffer
    out = torch.full((5, 4, 33), 7.0)
    zt, lq, lp = tmk.wrapped_reparam_stereo_t(noise[..., 3:5], *args, wraps=1,
                                              sign=1, out=out, z_off=1)
    assert zt.data_ptr() == out[:, 1:3].data_ptr()
    assert all(torch.equal(a, b) for a, b in zip((zt, lq, lp), want))
    assert bool((out[:, 0] == 7.0).all() and (out[:, 3] == 7.0).all())
    got = tmk.wrapped_reparam_stereo_t(torch.from_numpy(eps), *args, wraps=1,
                                       sign=1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tmk.wrapped_reparam_stereo_t.launches == before  # CPU: no launch
    with pytest.raises(ValueError):
        tmk.wrapped_reparam_stereo_t(torch.from_numpy(eps), args[0][:, :1],
                                     args[1], args[2])
    with pytest.raises(ValueError):
        tmk.wrapped_reparam_stereo_t(torch.from_numpy(eps), *args, sign=2)
    with pytest.raises(ValueError):
        tmk.wrapped_reparam_stereo_t(torch.from_numpy(eps), *args, out=out,
                                     z_off=3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 6])
@pytest.mark.parametrize("sign,k", [(-1, -1.0), (-1, -1e-3), (0, -0.5),
                                    (0, 0.0), (0, 1e-3), (0, 0.9), (1, 1.0),
                                    (1, 1e-3)])
@pytest.mark.parametrize("wraps", [0, 1])
def test_kernel_matches_plain_version_on_card(cuda_device, sign, k, wraps, n):
    S, B, E, Z = 125, 512, n + 3, n + 2
    gen = torch.Generator(device=cuda_device).manual_seed(n + wraps)
    noise = torch.randn(S, B, E, generator=gen, device=cuda_device)
    eps = noise[..., 2:2 + n]
    kt = torch.tensor(k, device=cuda_device)
    mu = t_stereo.exp_map_mu0(
        0.3 * torch.randn(B, n, generator=gen, device=cuda_device)
        / max(abs(k), 1.0) ** 0.5, kt)
    sig = 0.2 + torch.rand(B, n, generator=gen, device=cuda_device)
    out = torch.zeros(S, Z, B, device=cuda_device)
    before = tmk.wrapped_reparam_stereo_t.launches
    zt, lq, lp = tmk.wrapped_reparam_stereo_t(eps, mu, sig, kt, wraps=wraps,
                                              sign=sign, out=out, z_off=1)
    z_r, lq_r, lp_r = tmk.wrapped_reparam_stereo_ref(eps, mu, sig, kt,
                                                     wraps=wraps, sign=sign)
    _, lq64, lp64 = tmk.wrapped_reparam_stereo_ref(
        eps.double(), mu.double(), sig.double(), kt.double(), wraps=wraps,
        sign=sign)
    torch.cuda.synchronize()
    assert tmk.wrapped_reparam_stereo_t.launches == before + 1
    assert bool((out[:, 0] == 0).all() and (out[:, 1 + n:] == 0).all())
    assert bool(((zt - z_r).abs() <= 1e-5 * (1 + z_r.abs())).all())
    for ours, ref, ref64 in ((lq, lq_r, lq64), (lp, lp_r, lp64)):
        assert bool(torch.isfinite(ours).all())
        # held where float32 resolves the density (off the K > 0 shell)
        res = (ref.double() - ref64).abs() <= 1e-5
        assert float(res.double().mean()) >= 0.95
        assert float((ours - ref).abs()[res].max()) <= 1e-4


def _held(ours, ref, ref64, tol):
    """chip_smoke's rule: within ``tol`` of the float32 plain version where
    float32 resolves the value (``ref`` within a tenth of ``tol`` of float64),
    elsewhere (the K < 0 ball's rim) finite and no farther from float64 than
    ten times the plain version."""
    assert bool(torch.isfinite(ours).all())
    plain_err = (ref.double() - ref64).abs()
    res = plain_err <= 0.1 * tol
    assert float(res.double().mean()) >= 0.5
    assert float(((ours - ref).abs() / tol)[res].max()) <= 1.0
    far = (ours.double() - ref64).abs() / (plain_err + tol)
    assert float(far.max()) <= 10.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 6, 7])
@pytest.mark.parametrize("sign,k", [(-1, -1.0), (0, -0.5), (0, 0.9),
                                    (1, 1.0)])
@pytest.mark.parametrize("S,B", [(125, 512), (125, 2048), (3, 37)])
def test_instantiations_match_plain_version_on_card(cuda_device, n, sign, k,
                                                    S, B):
    """Each instantiation (n = 2, 3, 6 in registers, 7 the generic one) at
    a sample a thread (S B fits on the card) and two (the production chunk
    does not; S = 3 leaves the last thread a sample short), every 7th
    example's mean at the K < 0 ball's rim: z within 1e-5 (1 + |z|) and
    the log-densities within 1e-4 (1 + 0.01 |ref|) of the plain version
    where float32 resolves them, as chip_smoke holds them."""
    gen = torch.Generator(device=cuda_device).manual_seed(7 * n + S)
    eps = torch.randn(S, B, n + 1, generator=gen, device=cuda_device)[..., 1:]
    kt = torch.tensor(k, device=cuda_device)
    mu = t_stereo.exp_map_mu0(
        0.3 * torch.randn(B, n, generator=gen, device=cuda_device)
        / max(abs(k), 1.0) ** 0.5, kt)
    if k < 0:
        mu[::7] *= (1 - 1e-7) / (-k) ** 0.5 / mu[::7].norm(dim=1,
                                                            keepdim=True)
    sig = 0.2 + torch.rand(B, n, generator=gen, device=cuda_device)
    got = tmk.wrapped_reparam_stereo_t(eps, mu, sig, kt, sign=sign)
    ref = tmk.wrapped_reparam_stereo_ref(eps, mu, sig, kt, sign=sign)
    ref64 = tmk.wrapped_reparam_stereo_ref(eps.double(), mu.double(),
                                           sig.double(), kt.double(),
                                           sign=sign)
    torch.cuda.synchronize()
    assert tmk.reparam_spt(S, B, n, sign) in (1, 2)
    _held(got[0], ref[0], ref64[0], 1e-5 * (1 + ref[0].abs()))
    for ours, r, r64 in zip(got[1:], ref[1:], ref64[1:]):
        _held(ours, r, r64, 1e-4 * (1 + 1e-2 * r.abs()))


# --- the geodesic distances -----------------------------------------------------

DIST_KS = [-1.0, -1e-3, 0.0, 1e-3, 1.0]


def _dist_points(seed, b, n, k):
    """Rows x, y inside the manifold's chart (within 0.8 of the ball's
    radius for K < 0), with x = y in row 0."""
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((b, n))).astype(np.float32)
    y = (0.3 * rng.standard_normal((b, n))).astype(np.float32)
    if k < 0:
        lim = 0.8 / np.sqrt(-k)
        x *= np.minimum(1.0, lim / np.linalg.norm(x, axis=1, keepdims=True))
        y *= np.minimum(1.0, lim / np.linalg.norm(y, axis=1, keepdims=True))
    y[0] = x[0]
    return x, y


@pytest.mark.parametrize("b,n", [(300, 6), (37, 128), (5, 1)])
@pytest.mark.parametrize("k", DIST_KS)
def test_stereo_distance_ref_matches_jax_kernel_interpret(k, b, n):
    import jax.numpy as jnp
    from mvae_tpu.kernels import manifold_kernels as jmk
    from mvae_tpu.ops import stereographic as j_stereo
    x, y = _dist_points(11, b, n, k)
    want = np.asarray(jmk.stereo_distance(jnp.asarray(x), jnp.asarray(y),
                                          jnp.float32(k)))
    lib = np.asarray(j_stereo.distance(jnp.asarray(x), jnp.asarray(y),
                                       jnp.float32(k)))
    kt = torch.tensor(k)
    got = tmk.stereo_distance_ref(torch.from_numpy(x), torch.from_numpy(y),
                                  kt)
    assert got.shape == (b,)
    ours = t_stereo.distance(torch.from_numpy(x), torch.from_numpy(y), kt)
    for other in (want, lib, ours.numpy()):
        np.testing.assert_allclose(got.numpy()[1:], other[1:], rtol=1e-5,
                                   atol=1e-6)
    # x = y: the Gram form cancels to w2 = 0 exactly here and the distance
    # is the floor 2 sqrt(1e-30); the reference's kernel keeps a rounding
    # residue of the cancellation (~sqrt(eps) |x|)
    assert float(got[0]) <= 1e-6 and abs(float(want[0])) < 5e-3


@pytest.mark.parametrize("b,n", [(300, 7), (37, 128)])
@pytest.mark.parametrize("k", [-1.0, -1e-3, -4.0])
def test_lorentz_distance_ref_matches_jax_kernel_interpret(k, b, n):
    import jax.numpy as jnp
    from mvae_tpu.kernels import manifold_kernels as jmk
    from mvae_torch.ops import lorentz as t_lorentz
    rng = np.random.default_rng(12)
    kt = torch.tensor(k)
    scale = 0.5 / np.sqrt(n - 1)
    x = t_lorentz.exp_map_mu0(torch.from_numpy(
        (scale * rng.standard_normal((b, n - 1))).astype(np.float32)), kt)
    y = t_lorentz.exp_map_mu0(torch.from_numpy(
        (scale * rng.standard_normal((b, n - 1))).astype(np.float32)), kt)
    y[0] = x[0]
    want = np.asarray(jmk.lorentz_distance(jnp.asarray(x.numpy()),
                                           jnp.asarray(y.numpy()),
                                           jnp.float32(k)))
    got = tmk.lorentz_distance_ref(x, y, kt)
    # atol 3e-6: at x = y (row 0) the kernel's floor 1e-30 gives
    # sqrt(2e-30) R; the library op floors at tiny(float32) = 1e-15 and
    # gives sqrt(2e-15) R = 1.4e-6 at K = -1e-3, as the reference's
    # interpreted kernel does
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=3e-6)
    np.testing.assert_allclose(got.numpy(),
                               t_lorentz.distance(x, y, kt).numpy(),
                               rtol=1e-5, atol=3e-6)


@pytest.mark.parametrize("k", DIST_KS)
def test_stereo_distance_gradients_match_jax(k):
    """``stereo_distance`` under autograd (CPU: the plain forward, the
    library op's backward) against ``jax.grad`` of the JAX kernel entry, in
    x, y and k."""
    import jax
    import jax.numpy as jnp
    from mvae_tpu.kernels import manifold_kernels as jmk
    x, y = _dist_points(13, 64, 6, k)
    x, y = x[1:], y[1:]          # d is not differentiable at x = y
    w = np.random.default_rng(1).standard_normal(63).astype(np.float32)
    gj = jax.grad(lambda a, b, c: jnp.sum(jmk.stereo_distance(a, b, c) * w),
                  (0, 1, 2))(jnp.asarray(x), jnp.asarray(y), jnp.float32(k))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    kt = torch.tensor(k, requires_grad=True)
    before = tmk.stereo_distance.launches
    (tmk.stereo_distance(xt, yt, kt) * torch.from_numpy(w)).sum().backward()
    assert tmk.stereo_distance.launches == before     # CPU: no launch
    for ours, theirs in zip((xt, yt, kt), gj):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)
    # only the gradients asked for are computed
    xt.grad = None
    tmk.stereo_distance(xt, torch.from_numpy(y), k).sum().backward()
    assert xt.grad is not None


@pytest.mark.parametrize("k", [-1.0, -0.05])
def test_lorentz_distance_gradients_match_jax(k):
    import jax
    import jax.numpy as jnp
    from mvae_tpu.kernels import manifold_kernels as jmk
    from mvae_torch.ops import lorentz as t_lorentz
    rng = np.random.default_rng(14)
    kt0 = torch.tensor(k)
    x = t_lorentz.exp_map_mu0(torch.from_numpy(
        (0.4 * rng.standard_normal((48, 3))).astype(np.float32)), kt0)
    y = t_lorentz.exp_map_mu0(torch.from_numpy(
        (0.4 * rng.standard_normal((48, 3))).astype(np.float32)), kt0)
    gj = jax.grad(lambda a, b, c: jnp.sum(jmk.lorentz_distance(a, b, c)),
                  (0, 1, 2))(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                             jnp.float32(k))
    xt, yt = x.clone().requires_grad_(), y.clone().requires_grad_()
    kt = torch.tensor(k, requires_grad=True)
    tmk.lorentz_distance(xt, yt, kt).sum().backward()
    for ours, theirs in zip((xt, yt, kt), gj):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)


def test_distance_wrappers_reject_bad_input():
    from mvae_torch import kernels
    assert kernels.stereo_distance is tmk.stereo_distance
    assert kernels.lorentz_distance is tmk.lorentz_distance
    x = torch.zeros(4, 3)
    for fn in (tmk.stereo_distance, tmk.lorentz_distance):
        with pytest.raises(ValueError):
            fn(x, torch.zeros(4, 2), torch.tensor(-1.0))
        with pytest.raises(ValueError):
            fn(x[0], x[0], torch.tensor(-1.0))
        with pytest.raises(ValueError):
            fn(x, x, torch.tensor([-1.0, -2.0]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(100000, 128), (1000, 6), (33, 7), (5, 1)])
@pytest.mark.parametrize("k", DIST_KS)
def test_stereo_distance_kernel_matches_plain_version_on_card(cuda_device, k,
                                                              b, n):
    x, y = (torch.from_numpy(a).to(cuda_device)
            for a in _dist_points(15, b, n, k))
    kt = torch.tensor(k, device=cuda_device)
    before = tmk.stereo_distance.launches
    got = tmk.stereo_distance(x, y, kt)
    ref = tmk.stereo_distance_ref(x, y, kt)
    torch.cuda.synchronize()
    assert tmk.stereo_distance.launches == before + 1
    assert got.shape == (b,) and bool(torch.isfinite(got).all())
    assert bool(((got - ref).abs() <= 1e-5 * (1 + ref.abs()))[1:].all())
    # x = y (row 0): the Gram form's cancellation leaves at most the
    # rounding residue the reference's kernel keeps (~sqrt(eps) |x|)
    assert float(got[0]) < 5e-3 and float(ref[0]) < 5e-3
    # the backward goes through the library op, on the card too
    xg = x.clone().requires_grad_()
    tmk.stereo_distance(xg, y, kt).sum().backward()
    assert bool(torch.isfinite(xg.grad).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(100000, 128), (1000, 7), (33, 2)])
@pytest.mark.parametrize("k", [-1.0, -1e-3, -4.0])
def test_lorentz_distance_kernel_matches_plain_version_on_card(cuda_device,
                                                               k, b, n):
    from mvae_torch.ops import lorentz as t_lorentz
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    kt = torch.tensor(k, device=cuda_device)
    scale = 0.5 / max(n - 1, 1) ** 0.5
    x = t_lorentz.exp_map_mu0(scale * torch.randn(
        b, n - 1, generator=gen, device=cuda_device), kt)
    y = t_lorentz.exp_map_mu0(scale * torch.randn(
        b, n - 1, generator=gen, device=cuda_device), kt)
    y[0] = x[0]
    before = tmk.lorentz_distance.launches
    got = tmk.lorentz_distance(x, y, kt)
    ref = tmk.lorentz_distance_ref(x, y, kt)
    torch.cuda.synchronize()
    assert tmk.lorentz_distance.launches == before + 1
    assert bool(torch.isfinite(got).all())
    # the Lorentzian square cancels sum d_i^2 against 2 d_0^2: an ulp of the
    # 128-term sum is ~1e-6 of the distance's square
    assert bool(((got - ref).abs() <= 1e-5 * (1 + ref.abs())
                 + 3e-4 * (n > 16)).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the reparam kernel has no CPU mode")
    return torch.device("cuda")
