"""The IWAE chunk reparameterization of the flagship's kinds (P2,
``tail_kernels.reparam_chunk_t``, ``csrc/reparam_chunk.cu``) and its route
in ``models/vae.py``.

The plain version ``reparam_chunk_ref`` is ``tail_forward_ref``'s tiles on
the chunk's rows, each example's heads repeated over its samples. It is
held to the library composition ``components.reparametrize`` on the same
noise (float64: 1e-9, the same quantities; float32: z within 3e-5
relative and 1e-6 absolute, the log-densities within 1e-5 relative and
1e-4 absolute, two float32 evaluations of one quantity, the hyperboloid's
log p by the tile's acosh_1p radius against the library's log-map round
trip, which part by ~1e-5 relative at a large radius), and through the
route to the JAX package's chunk on
rebuilt keys at the tolerances ``test_reparam_chunk_matches_jax`` holds B5
to. The CUDA source is compiled for the host (as in
``test_torch_csrc_host.py``) and held to the plain version and, on the same
rows, to B1's source bit for bit: P2 evaluates the tiles' expressions, an
example part once an example and a draw part once a sample, in the same
order. On a card (``-m cuda``) the kernel is held to the plain version, to
B1 bit for bit, counted through CUDA-graph replays, and a flagship IWAE
batch launches P2 four times and neither B1 nor B5; the tests that hold
the port to the JAX package import it inside, as the card machine has no
JAX.
"""
import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mvae_torch.components import parse_components, reparametrize
from mvae_torch.kernels import manifold_kernels as tmk
from mvae_torch.kernels import tail_kernels as ttk
from mvae_torch.models import route as troute
from mvae_torch.models import vae as tvae
from tests.test_torch_csrc_host import _HARNESS, _STUB, CSRC, _held, _ptr

# (spec, options): the kinds P2 draws at the dimensions the kernel
# instantiates in registers (2, 3), a scalar scale, and the flagship
KINDS = [("e2", {}), ("e3", {}), ("e2", {"scalar_sigma": True}),
         ("h2", {}), ("h3", {}), ("h2", {"scalar_sigma": True}),
         ("s2", {})]


def _comps(spec, opts=None):
    return tuple(parse_components(spec, fixed_curvature=False,
                                  **(opts or {})))


def _params(comps, dtype, seed):
    """Component parameters whose learnable curvature leaf is moved off
    its initial value (K away from -1 / +1), and the generator for the
    rest of the inputs."""
    g = torch.Generator().manual_seed(seed)
    cps = [c.init_params(4, 1.0, dtype, g) for c in comps]
    for cp in cps:
        if "c_param" in cp:
            cp["c_param"] = cp["c_param"] + 0.3 * torch.randn((), generator=g,
                                                              dtype=dtype)
    return cps, g


def _raw(comps, B, dtype, g):
    """(B, W) head pre-activations: means ~0.5, 4x that on every 7th
    example from example 3 (a hyperbolic radius up to ~6), scales
    softplus(N(-1, 0.7)); example 1 at mu_tan = 0."""
    W = sum(c.head_width for c in comps)
    raw = torch.randn(B, W, generator=g, dtype=dtype)
    off = 0
    for c in comps:
        raw[:, off:off + c.dim] *= 0.5
        raw[3::7, off:off + c.dim] *= 4.0
        raw[:, off + c.dim:off + c.head_width] = (
            0.7 * raw[:, off + c.dim:off + c.head_width] - 1.0)
        off += c.head_width
    raw[1:2] = 0.0
    return raw


def _zero_tangent(comps, noise, b):
    """Example b's tangent normals at 0 in every sample, for the normal and
    the hyperboloid (the vMF's noise, its cosine's uniform in [1e-7, 1) and
    a direction's normals, left as drawn)."""
    eo = 0
    for c in comps:
        if c.posterior != "vmf":
            noise[:, b:b + 1, eo:eo + c.dim] = 0.0
        eo += c.noise_width


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("S", [1, 5, 125])
@pytest.mark.parametrize("spec,opts", KINDS)
def test_plain_version_matches_reparametrize(spec, opts, S, dtype):
    """One component a call, B = 37 (not a multiple of 32): z, log q and
    log p against ``components.reparametrize`` on the same noise. Float64:
    1e-9. Float32, at the float32 tolerance of the repo's kernel-route
    against library-route tests (z: 3e-5 relative, 1e-6 absolute; the
    densities: 1e-5 relative, 1e-4 absolute): within it of the library's
    float32 value wherever that resolves its float64 value (``_held``);
    elsewhere (a large hyperbolic radius, where the library's log-map round
    trip and the tile's acosh_1p radius both lose digits) no farther from
    float64 than ten times the library."""
    comps = _comps(spec, opts)
    (c,), B = comps, 37
    cps, g = _params(comps, dtype, 3 + S)
    raw = _raw(comps, B, dtype, g)
    noise = ttk.draw_noise(comps, (S, B), raw, g)
    _zero_tangent(comps, noise, 4)
    k = torch.stack([c.curvature(cps[0])])
    z, lq, lp = ttk.reparam_chunk_ref(comps, (0,), raw, noise, k)
    rep = reparametrize(c, cps[0], torch.zeros((), dtype=dtype), raw=raw,
                        noise=noise)
    assert z.shape == (S, B, c.ambient_dim) and lq.shape == (S, B)
    if dtype == torch.float64:
        for ours, ref in ((z, rep.z), (lq, rep.log_q), (lp, rep.log_p)):
            torch.testing.assert_close(ours, ref, rtol=1e-9, atol=1e-9)
        return
    cp64 = {name: t.double() for name, t in cps[0].items()}
    rep64 = reparametrize(c, cp64, torch.zeros((), dtype=torch.float64),
                          raw=raw.double(), noise=noise.double())
    _held(z, rep.z, rep64.z, 1e-6 + 3e-5 * rep.z.abs(), 0.9)
    for ours, ref, ref64 in ((lq, rep.log_q, rep64.log_q),
                             (lp, rep.log_p, rep64.log_p)):
        _held(ours, ref, ref64, 1e-4 + 1e-5 * ref.abs(), 0.9)


@pytest.mark.parametrize("spec,c_params", [
    pytest.param("h2,s2,e2", None, id="h2s2e2"),
    pytest.param("h2,s2,e2", (np.log(0.3), np.log(2.5)),
                 id="h2s2e2-K-0.3+2.5"),
    pytest.param("d2,p2,e2", None, id="d2p2e2")])
def test_route_matches_jax(monkeypatch, spec, c_params):
    """One IWAE chunk through the port's route (P2's plain version for the
    flagship's kinds, B5's for d / p) against the JAX package's chunk on
    its rebuilt keys, at ``test_reparam_chunk_matches_jax``'s tolerances."""
    import jax

    from mvae_tpu.models import vae as jvae
    from tests import test_torch_vae as tv
    monkeypatch.setenv("MVAE_FUSED_REPARAM", "1")
    jcfg, tcfg, jparams, tparams, x = tv._models(np.float32, 2, spec,
                                                 c_params)
    ck, chunk = jax.random.key(5), 4
    feats = jvae.encode(jcfg, jparams, jax.numpy.asarray(x))
    zt_j, lq_j, lp_j = jvae._reparam_chunk_t(ck, jcfg, jparams, feats, chunk)
    noise = tv._chunk_noise(ck, jcfg, jparams, chunk, np.float32, True)
    zt, lq, lp = tvae._reparam_chunk_t(
        tcfg, tparams, troute.route(tcfg, tparams), torch.from_numpy(np.asarray(feats)), chunk,
        torch.from_numpy(noise))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zt_j), rtol=3e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lq.numpy(), np.asarray(lq_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-5,
                               atol=1e-4)


def _spy(monkeypatch):
    """Record the picked components of each P2 call and count B5's."""
    calls = {"tiles": [], "stereo": 0}
    chunk, stereo = ttk.reparam_chunk_t, tmk.wrapped_reparam_stereo_t

    def tiles(comps, picked, *args):
        calls["tiles"].append(tuple(picked))
        return chunk(comps, picked, *args)

    def b5(*args, **kw):
        calls["stereo"] += 1
        return stereo(*args, **kw)

    monkeypatch.setattr(ttk, "reparam_chunk_t", tiles)
    monkeypatch.setattr(tmk, "wrapped_reparam_stereo_t", b5)
    return calls


@pytest.mark.parametrize("spec,opts,dtype,tiles,stereo", [
    ("h2,s2,e2", {}, torch.float32, (0, 1, 2), 0),
    ("d2,p2,e2", {}, torch.float32, (2,), 2),
    ("s3:wrapped,h2,e2", {}, torch.float32, (1, 2), 0),
    ("p2:vmf,s3,h7", {}, torch.float32, (2,), 0),
    ("h2,s2,e2", {}, torch.float64, (), 0),
    ("s6:wrapped", {}, torch.float32, (), 0)])
def test_route_reads_the_component(monkeypatch, spec, opts, dtype, tiles,
                                   stereo):
    """Normal on e, wrapped on h and vMF on s2 in float32 go together to one
    P2 call a chunk, wrapped d / p / u to B5 a component, every other
    component (wrapped s, the rejection vMF, vMF on p, float64) to the
    plain per-component draw; ``route.report`` names the same."""
    comps = _comps(spec, opts)
    cfg = tvae.VAEConfig(comps, (20,), h_dim=12)
    params = tvae.init_params(cfg, dtype=dtype,
                              generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = (torch.rand(9, 20, generator=g) < 0.4).to(dtype)
    calls = _spy(monkeypatch)
    ll = tvae.log_likelihood(cfg, params, x, 6, 6, generator=g)
    assert bool(torch.isfinite(ll).all())
    assert calls["tiles"] == ([tiles] if tiles else [])
    assert calls["stereo"] == stereo
    rep = troute.report(cfg, params, "cpu")["iwae_reparam"]
    for i, r in enumerate(rep):
        assert r["active"] == (i in tiles or ("reparam_stereo" in r["why"]))
        assert ("reparam_chunk.cu" in r["why"]) == (i in tiles)
    assert sum("reparam_stereo" in r["why"] for r in rep) == stereo


@pytest.mark.parametrize("spec", ["h2,s2,e2", "d2,p2,e2"])
def test_log_likelihood_matches_previous_path(monkeypatch, spec):
    """A batch's IWAE estimate through P2's plain version against the
    per-component path it replaces (``components.reparametrize``), float32,
    the same noise: 1e-5 relative with a 1e-4 floor, the float32 tolerance
    of ``test_log_likelihood_matches_jax``."""
    from tests import test_torch_vae as tv
    _, tcfg, _, tparams, x = tv._models(np.float32, 4, spec)
    g = torch.Generator().manual_seed(6)
    xt = torch.from_numpy(x)
    noise = ttk.draw_noise(tcfg.components, (8, xt.shape[0]), xt, g)
    new = tvae.log_likelihood(tcfg, tparams, xt, 8, 4, noise=noise)
    monkeypatch.setattr(ttk, "chunk_supported", lambda c: False)
    assert "tiles" not in troute.route(tcfg, tparams).chunk
    old = tvae.log_likelihood(tcfg, tparams, xt, 8, 4, noise=noise)
    np.testing.assert_allclose(new.numpy(), old.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors: the plain version, z into the picked components'
    rows of ``out`` (the others untouched), no launch counted; bad calls
    raise."""
    comps = _comps("d2,h2,s2,e2")
    cps, g = _params(comps, torch.float32, 8)
    S, B = 3, 11
    raw = _raw(comps, B, torch.float32, g)
    noise = ttk.draw_noise(comps, (S, B), raw, g)
    picked = (1, 2, 3)
    k = torch.stack([comps[i].curvature(cps[i]) for i in picked])
    out = torch.full((S, 10, B), 7.0)
    before = ttk.reparam_chunk_t.launches
    lq, lp = ttk.reparam_chunk_t(comps, picked, raw, noise, k, out)
    assert ttk.reparam_chunk_t.launches == before
    z, lq_r, lp_r = ttk.reparam_chunk_ref(comps, picked, raw, noise, k)
    assert torch.equal(lq, lq_r) and torch.equal(lp, lp_r)
    assert torch.equal(out[:, 2:], z.transpose(1, 2))
    assert bool((out[:, :2] == 7.0).all())
    for bad in ((0, 1), (2, 1), (), (1, 4)):
        with pytest.raises(ValueError):
            ttk.reparam_chunk_t(comps, bad, raw, noise, k[:len(bad)], out)
    with pytest.raises(ValueError):
        ttk.reparam_chunk_t(comps, picked, raw, noise, k, out[:, :9])


# --- the CUDA source, compiled for the host ----------------------------------

_CHUNK_HARNESS = r"""
template <int D>
static void run_chunk(const float* eps, long long stride, const float* raw,
                      int W, const float* k, float* zt, float* lq, float* lp,
                      int S, int B, int Z, const ChunkTable& t) {
  for (long long i = 0; i < (long long)S * B; ++i) {
    blockIdx.x = (int)(i / CHUNK_THREADS);
    threadIdx.x = (int)(i % CHUNK_THREADS);
    reparam_chunk_kernel<D>(eps, stride, raw, W, k, zt, lq, lp, S, B, Z, t);
  }
}

// The kernel, thread after thread, on the instantiation the launcher picks
// for the table; the table's dimension class, or -1 for a table the
// launcher refuses
extern "C" int host_run(const float* eps, long long stride, const float* raw,
                        int W, const float* k, float* zt, float* lq,
                        float* lp, int S, int B, int Z, int nc,
                        const int* table) {
  ChunkTable t;
  if (!chunk_table_from(table, nc, W, Z, stride, &t)) return -1;
  const int d = chunk_dim_class(t);
  if (d == 2)
    run_chunk<2>(eps, stride, raw, W, k, zt, lq, lp, S, B, Z, t);
  else
    run_chunk<0>(eps, stride, raw, W, k, zt, lq, lp, S, B, Z, t);
  return d;
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host builds of ``reparam_chunk.cu`` and of B1's ``tail_fwd.cu``
    (``test_torch_csrc_host``'s harness), each source cut before its
    launchers: {"chunk": fn, "tail_fwd": fn}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    work = tmp_path_factory.mktemp("chunk_host")
    (work / "cuda_runtime.h").write_text(_STUB)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    procs = {}
    for name, base, harness in (("chunk", "reparam_chunk", _CHUNK_HARNESS),
                                ("tail_fwd", "tail_fwd",
                                 _HARNESS["tail_fwd"])):
        text = (CSRC / f"{base}.cu").read_text()
        src = work / f"{base}.cpp"
        src.write_text(text.split("// --- launchers")[0] + harness)
        out = work / f"{base}.so"
        procs[name] = (subprocess.Popen(
            [gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I",
             str(work), "-o", str(out), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    fns = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ failed for {name}:\n{log}"
        fns[name] = ctypes.CDLL(str(out)).host_run
    fns["chunk"].restype = ctypes.c_int
    fns["tail_fwd"].restype = None
    return fns


def _chunk_inputs(spec, S, B, seed, opts=None):
    comps = _comps(spec, opts)
    picked = tuple(i for i, c in enumerate(comps) if ttk.chunk_supported(c))
    cps, g = _params(comps, torch.float32, seed)
    raw = _raw(comps, B, torch.float32, g)
    noise = ttk.draw_noise(comps, (S, B), raw, g)
    _zero_tangent(comps, noise, 4)
    k = torch.stack([comps[i].curvature(cps[i]) for i in picked])
    return comps, picked, raw, noise, k


def _host_chunk(host, comps, picked, raw, noise, k, fill=7.0):
    S, B, E = noise.shape
    _, _, Z = ttk._dims(comps)
    zt = torch.full((S, Z, B), fill)
    lq = torch.full((S, B), float("nan"))
    lp = torch.full((S, B), float("nan"))
    d = host["chunk"](_ptr(noise), ctypes.c_longlong(noise.stride(1)),
                      _ptr(raw), raw.shape[1], _ptr(k), _ptr(zt), _ptr(lq),
                      _ptr(lp), S, B, Z, len(picked),
                      ttk._chunk_table(comps, picked))
    return d, zt, lq, lp


def _held_chunk(comps, picked, raw, noise, k, zt, lq, lp):
    """A chunk's kernel results against the plain version (``_held``): z
    within 1e-5 (1 + |z|) and the log-densities within 1e-4 (1 + 1e-2 |l|)
    where the float32 plain version resolves its float64 value (libm and
    CUDA round a transcendental a few ulps off PyTorch's CPU kernels), on
    at least 70% of the points (every 7th example's mean lies far out)."""
    z_r, lq_r, lp_r = ttk.reparam_chunk_ref(comps, picked, raw, noise, k)
    z64, lq64, lp64 = ttk.reparam_chunk_ref(comps, picked, raw.double(),
                                            noise.double(), k.double())
    z = torch.cat([zt[:, zo:zo + c.ambient_dim]
                   for c, _, _, zo in ttk._picked(comps, picked)], dim=1)
    _held(z.transpose(1, 2), z_r, z64, 1e-5 * (1 + z_r.abs()), 0.7)
    _held(lq, lq_r, lq64, 1e-4 * (1 + 1e-2 * lq_r.abs()), 0.7)
    _held(lp, lp_r, lp64, 1e-4 * (1 + 1e-2 * lp_r.abs()), 0.7)


# (spec, options, the dimension class the launcher instantiates)
SOURCE_CASES = [("h2,s2,e2", {}, 2), ("h2,s2,e2", {"scalar_sigma": True}, 2),
                ("d2,p2,e2", {}, 2), ("h3,e3", {}, 0), ("s2", {}, 2),
                ("e6,h6", {}, 0), ("h2,e3,s2", {}, 0), ("h7", {}, 0)]

# (S, B): a chunk inside one block, and one whose blocks end inside an
# example's samples (400 points, 128 a block)
SOURCE_SIZES = [(5, 37), (2, 200)]


@pytest.mark.parametrize("S,B", SOURCE_SIZES)
@pytest.mark.parametrize("spec,opts,dclass", SOURCE_CASES)
def test_source_matches_plain_version(host, spec, opts, dclass, S, B):
    """The compiled source on both instantiations (2 in registers, 0 the
    generic one): z within 1e-5 (1 + |z|) and the log-densities within
    1e-4 (1 + 1e-2 |l|) of the plain version where float32 resolves them;
    the other components' rows untouched."""
    comps, picked, raw, noise, k = _chunk_inputs(spec, S, B, 11, opts)
    d, zt, lq, lp = _host_chunk(host, comps, picked, raw, noise, k)
    assert d == dclass
    _held_chunk(comps, picked, raw, noise, k, zt, lq, lp)
    theirs = [i for i in range(len(comps)) if i not in picked]
    for c, _, _, zo in ttk._picked(comps, tuple(theirs)) if theirs else ():
        assert bool((zt[:, zo:zo + c.ambient_dim] == 7.0).all())


@pytest.mark.parametrize("S,B", SOURCE_SIZES)
@pytest.mark.parametrize("spec,opts", [("h2,s2,e2", {}),
                                       ("h2,s2,e2", {"scalar_sigma": True}),
                                       ("h3,e3", {}), ("h2,e3,s2", {})])
def test_source_bit_equal_to_tail_forward_source(host, spec, opts, S, B):
    """The compiled source against B1's (the forward tail, one thread a
    row) on the chunk's S B rows with each example's heads repeated: z, sum
    log q and sum log p bit for bit."""
    comps, picked, raw, noise, k = _chunk_inputs(spec, S, B, 12, opts)
    assert picked == tuple(range(len(comps)))
    _, zt, lq, lp = _host_chunk(host, comps, picked, raw, noise, k)
    W, E, Z = ttk._dims(comps)
    nc = len(comps)
    rows = raw.unsqueeze(0).expand(S, B, W).reshape(S * B, W).contiguous()
    eps = noise.reshape(S * B, E).contiguous()
    z1 = torch.full((S * B, Z), float("nan"))
    aux = torch.full((S * B, nc + 2), float("nan"))
    host["tail_fwd"](_ptr(rows), _ptr(eps), _ptr(k), _ptr(z1), _ptr(aux),
                     S * B, W, E, Z, nc, ttk._table(comps))
    assert bool(torch.isfinite(aux).all())
    assert torch.equal(zt.transpose(1, 2), z1.reshape(S, B, Z))
    assert torch.equal(lq, aux[:, nc].reshape(S, B))
    assert torch.equal(lp, aux[:, nc + 1].reshape(S, B))


def test_source_refuses_other_kinds(host):
    """A table with a kind P2 does not draw (the stereographic d2) or a
    vMF beyond m = 3 is refused before any thread runs."""
    S, B = 2, 5
    raw = torch.zeros(B, 6)
    noise = torch.zeros(S, B, 4)
    k = torch.zeros(2)
    rows = (ctypes.c_int * 12)(3, 2, 2, 0, 0, 0, 0, 2, 2, 4, 2, 2)
    zt, lq, lp = torch.zeros(S, 4, B), torch.zeros(S, B), torch.zeros(S, B)
    assert host["chunk"](_ptr(noise), ctypes.c_longlong(4), _ptr(raw), 6,
                         _ptr(k), _ptr(zt), _ptr(lq), _ptr(lp), S, B, 4, 2,
                         rows) == -1
    vmf = (ctypes.c_int * 6)(2, 3, 1, 0, 0, 0)
    assert host["chunk"](_ptr(noise), ctypes.c_longlong(4), _ptr(raw), 6,
                         _ptr(k), _ptr(zt), _ptr(lq), _ptr(lp), S, B, 4, 1,
                         vmf) == -1


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chunk reparam kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def _card_inputs(spec, S, B, seed, device):
    comps, picked, raw, noise, k = _chunk_inputs(spec, S, B, seed)
    return comps, picked, raw.to(device), noise.to(device), k.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["h2,s2,e2", "d2,p2,e2", "h3,e3",
                                  "h2,e3,s2"])
@pytest.mark.parametrize("S,B", [(125, 512), (125, 1000), (7, 33), (1, 1)])
def test_kernel_matches_plain_version_on_card(cuda_device, spec, S, B):
    """P2 at the production chunk and at ragged sizes: z within 1e-5
    (1 + |z|) and the log-densities within 1e-4 (1 + 1e-2 |l|) of the plain
    version on the card where float32 resolves them (CUDA's float32
    transcendentals and the CPU's part by more than that at a large
    hyperbolic radius), one launch counted, the other components' rows
    untouched."""
    comps, picked, raw, noise, k = _card_inputs(spec, S, B, 21, cuda_device)
    _, _, Z = ttk._dims(comps)
    out = torch.full((S, Z, B), 7.0, device=cuda_device)
    before = ttk.reparam_chunk_t.launches
    lq, lp = ttk.reparam_chunk_t(comps, picked, raw, noise, k, out)
    torch.cuda.synchronize()
    assert ttk.reparam_chunk_t.launches == before + 1
    _held_chunk(comps, picked, raw, noise, k, out, lq, lp)
    theirs = tuple(i for i in range(len(comps)) if i not in picked)
    for c, _, _, zo in ttk._picked(comps, theirs) if theirs else ():
        assert bool((out[:, zo:zo + c.ambient_dim] == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["h2,s2,e2", "h3,e3", "h2,e3,s2"])
@pytest.mark.parametrize("S,B", [(125, 512), (7, 33)])
def test_kernel_bit_equal_to_tail_forward_on_card(cuda_device, spec, S, B):
    """P2 against B1 (``tail_forward``) on the chunk's S B rows with each
    example's heads repeated: z, sum log q and sum log p bit for bit (both
    built with --fmad=false from the same tile expressions)."""
    comps, picked, raw, noise, k = _card_inputs(spec, S, B, 22, cuda_device)
    W, E, Z = ttk._dims(comps)
    nc = len(comps)
    out = torch.empty((S, Z, B), device=cuda_device)
    lq, lp = ttk.reparam_chunk_t(comps, picked, raw, noise, k, out)
    rows = raw.unsqueeze(0).expand(S, B, W).reshape(S * B, W)
    z1, aux = ttk.tail_forward(comps, rows, noise.reshape(S * B, E), k)
    assert torch.equal(out.transpose(1, 2), z1.reshape(S, B, Z))
    assert torch.equal(lq, aux[:, nc].reshape(S, B))
    assert torch.equal(lp, aux[:, nc + 1].reshape(S, B))


@pytest.mark.cuda
def test_kernel_counted_through_graph_replays(cuda_device):
    """P2 captured in a CUDA graph (``graphs.Graphed``): each replay counts
    one launch and gives the eager call's values bit for bit."""
    from mvae_torch.train import graphs
    comps, picked, raw, noise, k = _card_inputs("h2,s2,e2", 125, 512, 23,
                                                cuda_device)
    _, _, Z = ttk._dims(comps)
    out = torch.empty((125, Z, 512), device=cuda_device)
    statics = [noise.clone()]

    def body(nz):
        lq, lp = ttk.reparam_chunk_t(comps, picked, raw, nz, k, out)
        return out, lq, lp

    eager = [t.clone() for t in body(noise)]
    g = graphs.Graphed(body, statics, torch.Generator(device=cuda_device), 1,
                       copy_out=True)
    g(noise)                                        # warm-up
    g(noise)                                        # capture, then replay
    before = ttk.reparam_chunk_t.launches
    for _ in range(3):
        got = g(noise)
    torch.cuda.synchronize()
    assert ttk.reparam_chunk_t.launches == before + 3
    for a, b in zip(got, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flagship_iwae_batch_launches(cuda_device):
    """A flagship IWAE-500 batch of 512 at MNIST width: four P2 launches
    (one a chunk of 125), four B2, and neither B1 (``tail_forward``) nor B5
    (``wrapped_reparam_stereo_t``): the counts the benchmark's workload
    files state for ``h2s2e2.iwae500``."""
    from mvae_torch.kernels import decoder_kernels as tdk
    cfg = tvae.VAEConfig(_comps("h2,s2,e2"), (784,), h_dim=400)
    params = tvae.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = (torch.rand(512, 784, generator=g, device=cuda_device) < 0.3).float()
    fns = (ttk.reparam_chunk_t, tdk.fused_decode_bce_t, ttk.tail_forward,
           tmk.wrapped_reparam_stereo_t)
    before = [f.launches for f in fns]
    ll = tvae.log_likelihood(cfg, params, x, 500, generator=g)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ll).all())
    assert [f.launches - b for f, b in zip(fns, before)] == [4, 4, 0, 0]
    assert math.isfinite(float(ll.mean()))
