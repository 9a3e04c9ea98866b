"""The port's ("data", "model") mesh on torch.distributed against the JAX
package's mesh, on the CPU.

One world of four gloo ranks (``parallel.launch.World``) serves the module;
the JAX side runs on conftest's eight virtual CPU devices with the same mesh
shapes, at ``tests/parallel/test_sharding.py``'s small flagship (h_dim 32,
D 16, batch 32). Each rank is handed the same weights (``params_from_jax``)
and the noise JAX's mesh draws for the rows it holds:

* the training step: JAX's fused tail runs per data shard under
  ``shard_map`` (``MVAE_FUSED_TAIL=1``, the Pallas kernel in interpret mode)
  on ``draw_noise_t(fold_in(key, d))``; loss and every gradient within 5e-4;
* the sample-sharded IWAE: JAX's ``log_likelihood_sharded`` with its decode
  and reparam kernels in interpret mode (``MVAE_FUSED_DECODER=1``,
  ``MVAE_FUSED_REPARAM=1``) on the draws of ``fold_in(key, r)``; within the
  tolerance of ``test_torch_vae.py``'s IWAE parity (1e-5 relative, 5e-3
  nats: the reference's decode kernel splits its products in three bf16
  passes), and within 1e-5 relative, 1e-4 absolute of the port's one-device
  estimate on the same block.

The rank tasks are module-level functions that import no JAX (the ranks
import this module to run them).
"""
import json

import numpy as np
import pytest
import torch

from mvae_torch import cli
from mvae_torch.components import parse_components
from mvae_torch.convert import params_from_jax
from mvae_torch.data import ArrayDataset
from mvae_torch.models import vae as tvae
from mvae_torch.parallel import make_mesh, param_shardings, shard_params
from mvae_torch.parallel.collectives import gather_model
from mvae_torch.parallel.launch import RankError, World, launch
from mvae_torch.parallel.mesh import Mesh
from mvae_torch.train import TrainConfig, Trainer
from mvae_torch.train.trainer import _leaves

H, D, B = 32, 16, 32


@pytest.fixture(scope="module")
def world():
    with World(4, device="cpu") as w:
        yield w


# --- rank tasks (no JAX) ---------------------------------------------------------


def _trainer(spec, shape, run_dir, whole=None, **tc):
    """A CPU Trainer (mesh ``shape`` or one device) on a tiny dataset of
    intensities that is not binarized, with ``whole`` (a numpy params tree)
    loaded as its weights."""
    rng = np.random.default_rng(0)
    train = (rng.random((64, D)) < 0.4).astype(np.float32)
    cfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=False), (D,),
                         h_dim=H)
    tc = {"batch_size": B, "burnin_epochs": 0, "seed": 3,
          "eval_batch_size": 16, "likelihood_n": 8, "likelihood_chunk": 4,
          "mesh_shape": shape, **tc}
    tr = Trainer(cfg, ArrayDataset("tiny", train, train[:40], (D,), False),
                 TrainConfig(**tc), run_dir=run_dir, device="cpu")
    if whole is not None:
        params = params_from_jax(whole)
        if tr.mesh is not None:
            params = shard_params(params, tr.mesh)
        with torch.no_grad():
            for leaf, v in zip(_leaves(tr.params), _leaves(params)):
                leaf.copy_(v)
    return tr


def _outside(shape) -> bool:
    """Whether this rank is outside a mesh smaller than the world; such a
    rank still takes part in the mesh's process groups."""
    import torch.distributed as dist
    if dist.get_rank() < shape[0] * shape[1]:
        return False
    make_mesh(*shape, device="cpu")
    return True


def _whole_grads(tr):
    out = []
    for t, axis in zip(_leaves(tr.params), _leaves(tr._axes)):
        g = t.grad
        if axis is not None:
            g = gather_model(g, axis, tr.mesh)
        out.append(g)
    return out


def _step_task(spec, shape, whole, x, noise, run_dir):
    tr = _trainer(spec, shape, run_dir, whole)
    stats = tr._train_step(torch.from_numpy(x), None,
                           torch.from_numpy(noise))
    return {"elbo": stats["elbo"], "grads": _whole_grads(tr)}


def _iwae_task(spec, shape, whole, x, noise, n, chunk):
    mesh = make_mesh(*shape, device="cpu")
    cfg = tvae.VAEConfig(parse_components(spec, fixed_curvature=False), (D,),
                         h_dim=H)
    params = params_from_jax(whole)
    rows = mesh.rows(x.shape[0])
    xs = torch.from_numpy(x[rows])
    nz = torch.from_numpy(noise[:, rows])
    with torch.no_grad():
        ll = tvae.log_likelihood_sharded(cfg, shard_params(params, mesh), xs,
                                         mesh, n, chunk, noise=nz)
        one = tvae.log_likelihood(cfg, params, xs, n, chunk, noise=nz)
    return {"d": mesh.data_index, "m": mesh.model_index, "ll": ll,
            "one_device": one}


def _epoch_inputs(steps, seed=1):
    """(batch rows, binarization uniforms, (B, E) noise) of each step, the
    noise in ``tail_kernels.draw_noise``'s layout from a seeded generator."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    comps = parse_components("h2,s2,e2", fixed_curvature=False)
    perm = rng.permutation(64)
    return [(perm[s * B:(s + 1) * B],
             rng.random((B, D)).astype(np.float32),
             tvae.tail_kernels.draw_noise(comps, (B,), torch.zeros(()),
                                          gen).numpy())
            for s in range(steps)]


def _epoch_task(shape, steps, run_dir):
    """``steps`` Adam steps on given batches, binarization uniforms and
    noise; the whole parameters afterwards (None outside the mesh)."""
    if shape is not None and _outside(shape):
        return None
    tr = _trainer("h2,s2,e2", shape, run_dir)
    data = torch.from_numpy(tr.dataset.train)
    for idx, u, noise in _epoch_inputs(steps):
        tr._train_step(data[torch.from_numpy(idx)], torch.from_numpy(u),
                       torch.from_numpy(noise))
    return [t.detach().clone() for t in _leaves(tr.whole_params())]


def _checkpoint_task(run_dir, restore_dir):
    """A (2, 2) mesh trains an epoch and writes its checkpoint; then it
    restores a one-device checkpoint from ``restore_dir``."""
    tr = _trainer("h2,s2,e2", (2, 2), run_dir)
    tr.train_one_epoch(0)
    tr.save_checkpoint()
    saved = [t.detach().clone() for t in _leaves(tr.whole_params())]
    moments = tr.state()["opt_state"]
    other = _trainer("h2,s2,e2", (2, 2), restore_dir)
    other.restore_checkpoint()
    return {"saved": saved, "moments": moments, "step": tr.step,
            "restored": [t.detach().clone()
                         for t in _leaves(other.whole_params())],
            "restored_step": other.step}


def _raise_on_rank_one():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank one refuses")
    dist.all_reduce(torch.ones(1))  # rank 0 waits in a collective
    return "unreachable"


def _too_small_mesh():
    try:
        make_mesh(3, 2, device="cpu")
    except ValueError as err:
        return str(err)
    return None


# --- tests -------------------------------------------------------------------------


def _jax_model(spec="h2,s2,e2", seed=0):
    import jax
    import jax.numpy as jnp
    from mvae_tpu.components import parse_components as j_parse
    from mvae_tpu.models import VAEConfig, init_params
    cfg = VAEConfig(components=j_parse(spec, fixed_curvature=False),
                    data_shape=(D,), arch="mlp", h_dim=H)
    params = init_params(jax.random.key(seed), cfg, dtype=jnp.float32)
    x = (jax.random.uniform(jax.random.key(1), (B, D)) > 0.5).astype(
        jnp.float32)
    return cfg, params, np.asarray(x)


def _port_cfg(spec, shape, arch="mlp"):
    return tvae.VAEConfig(parse_components(spec, fixed_curvature=False),
                          shape, arch, h_dim=H)


def _model_axes(jax_tree_shardings):
    import jax
    return [s.spec.index("model") if "model" in s.spec else None
            for s in jax.tree.leaves(jax_tree_shardings)]


@pytest.mark.parametrize("arch,spec,shape", [
    ("mlp", "h2,s2,e2", (D,)), ("conv", "u4", (8, 8, 3))])
def test_param_shardings_match_jax(arch, spec, shape):
    """The same axis of every leaf is sharded over "model" as in JAX's
    layout (but for a leaf whose axis does not divide the model axis, which
    the port keeps whole where JAX pads: the conv decoder's 3 output
    channels), and the model ranks' shards put back together are the
    whole."""
    import jax
    import jax.numpy as jnp
    from mvae_tpu.components import parse_components as j_parse
    from mvae_tpu.models import VAEConfig, init_params
    from mvae_tpu.parallel import make_mesh as j_make_mesh
    from mvae_tpu.parallel import param_shardings as j_param_shardings
    cfg = VAEConfig(components=j_parse(spec, fixed_curvature=False),
                    data_shape=shape, arch=arch, h_dim=H)
    jparams = init_params(jax.random.key(0), cfg, dtype=jnp.float32)
    expected = _model_axes(j_param_shardings(j_make_mesh(2, 2), jparams))
    whole = params_from_jax(jax.tree.map(np.asarray, jparams))
    meshes = [Mesh({"data": 2, "model": 2}, 0, m, torch.device("cpu"),
                   "gloo", None, None, None) for m in range(2)]
    axes = _leaves(param_shardings(meshes[0], whole))
    uneven = [a is not None and leaf.shape[a] % 2 != 0
              for a, leaf in zip(expected, _leaves(whole))]
    assert axes == [None if u else a for a, u in zip(expected, uneven)]
    assert any(a is not None for a in axes)
    assert sum(uneven) == (arch == "conv")
    assert _leaves(tvae.mesh_layout(_port_cfg(spec, shape, arch),
                                    meshes[0])) == axes
    shards = [shard_params(whole, mesh) for mesh in meshes]
    for i, (leaf, axis) in enumerate(zip(_leaves(whole), axes)):
        parts = [_leaves(s)[i] for s in shards]
        if axis is None:
            assert all(p is leaf for p in parts)
        else:
            assert parts[0].shape[axis] * 2 == leaf.shape[axis]
            assert torch.equal(torch.cat(parts, dim=axis), leaf)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_train_step_matches_jax_mesh(world, monkeypatch, tmp_path, shape):
    """One step's loss and gradients on the mesh against ``jax.jit`` of the
    reference's ``loss_fn(..., mesh=mesh)`` on the noise JAX's
    ``fold_in(key, data index)`` draws for each shard's rows."""
    import jax
    from mvae_tpu.kernels.tail_kernels import draw_noise_t
    from mvae_tpu.models import vae as jvae
    from mvae_tpu.parallel import make_mesh as j_make_mesh
    from mvae_tpu.parallel import shard_batch as j_shard_batch
    from mvae_tpu.parallel import shard_params as j_shard_params
    monkeypatch.setenv("MVAE_FUSED_TAIL", "1")
    cfg, params, x = _jax_model()
    key = jax.random.key(7)
    mesh = j_make_mesh(*shape)

    def scalar(p, xx):
        return jvae.loss_fn(key, cfg, p, xx, allow_fused=False, mesh=mesh)[0]

    loss_j, g_j = jax.jit(jax.value_and_grad(scalar))(
        j_shard_params(params, mesh), j_shard_batch(x, mesh))
    bs = B // shape[0]
    noise = np.concatenate([np.asarray(draw_noise_t(
        jax.random.fold_in(key, d), cfg.components, bs, np.float32)).T
        for d in range(shape[0])])
    whole = jax.tree.map(np.asarray, params)
    out = world.run(_step_task, "h2,s2,e2", shape, whole, x, noise,
                    str(tmp_path))
    for r in out:
        np.testing.assert_allclose(-r["elbo"], float(loss_j), rtol=1e-5,
                                   atol=1e-5)
        for a, b in zip(r["grads"], jax.tree.leaves(g_j)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4,
                                       atol=5e-4)


def _jax_rank_noise(key, cfg, params, rows, per_rank):
    """(per_rank, rows, E) noise of one rank of JAX's sharded estimator:
    ``_log_weights(fold_in(key, r), ...)`` with the fused decoder (one
    chunk of the largest divisor <= 128) and the fused reparam, whose kernel
    components read ``normal(fold_in(ck, ci), (dim, chunk, rows))``."""
    import jax
    from mvae_tpu.models import vae as jvae
    from tests.test_torch_distributions import jax_noise
    chunk = next(d for d in range(min(128, per_rank), 0, -1)
                 if per_rank % d == 0)
    blocks = []
    for ck in jax.random.split(key, per_rank // chunk):
        nz = np.stack([jax_noise(sk, cfg.components, rows, np.float32)
                       for sk in jax.random.split(ck, chunk)])
        off = 0
        for ci, (comp, cp) in enumerate(zip(cfg.components,
                                            params["components"])):
            width = comp.dim
            if comp.posterior == "vmf":
                width += 1 + (0 if comp.dim == 2 else 32)
            if jvae._fused_reparam_eligible(comp, cp):
                eps = jax.random.normal(jax.random.fold_in(ck, ci),
                                        (comp.dim, chunk, rows), np.float32)
                nz[:, :, off:off + width] = np.asarray(eps).transpose(1, 2, 0)
            off += width
        blocks.append(nz)
    return np.concatenate(blocks)


@pytest.mark.parametrize("spec", ["h2,s2,e2", "d2,p2,e2"])
def test_sharded_iwae_matches_jax(world, monkeypatch, spec):
    """The sample-sharded IWAE on a (2, 2) mesh: batch over "data", samples
    over "model", on the draws of JAX's ``fold_in(key, r)``."""
    import jax
    from mvae_tpu.models import vae as jvae
    from mvae_tpu.parallel import make_mesh as j_make_mesh
    from mvae_tpu.parallel import shard_batch as j_shard_batch
    from mvae_tpu.parallel import shard_params as j_shard_params
    monkeypatch.setenv("MVAE_FUSED_DECODER", "1")
    monkeypatch.setenv("MVAE_FUSED_REPARAM", "1")
    cfg, params, x = _jax_model(spec, seed=2)
    key, n, chunk, shape = jax.random.key(13), 32, 8, (2, 2)
    mesh = j_make_mesh(*shape)
    ll_j = np.asarray(jax.jit(lambda p, xx: jvae.log_likelihood_sharded(
        key, cfg, p, xx, mesh, n, chunk))(j_shard_params(params, mesh),
                                           j_shard_batch(x, mesh)))
    bs, per_rank = B // shape[0], n // shape[1]
    width = sum(c.noise_width for c in parse_components(
        spec, fixed_curvature=False))
    noise = np.zeros((n, B, width), np.float32)
    for r in range(shape[1]):
        block = _jax_rank_noise(jax.random.fold_in(key, r), cfg, params, bs,
                                per_rank)
        for d in range(shape[0]):
            noise[r * per_rank:(r + 1) * per_rank, d * bs:(d + 1) * bs] = block
    out = world.run(_iwae_task, spec, shape, jax.tree.map(np.asarray, params),
                    x, noise, n, chunk)
    ll = np.concatenate([o["ll"] for o in sorted(out, key=lambda o: o["d"])
                         if o["m"] == 0])
    for o in out:  # every model rank holds its data shard's estimate
        np.testing.assert_array_equal(o["ll"], ll[o["d"] * bs:
                                                  (o["d"] + 1) * bs])
        np.testing.assert_allclose(o["ll"], o["one_device"], rtol=1e-5,
                                   atol=1e-4)
    np.testing.assert_allclose(ll, ll_j, rtol=1e-5, atol=5e-3)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_mesh_trainer_matches_one_device(world, tmp_path, shape):
    """Two Adam steps (an epoch of the 64-example set) of a mesh Trainer
    against the port's one-device Trainer on the same batches, binarization
    uniforms and noise: the same weights within 5e-4 relative."""
    mesh_params = world.run(_epoch_task, shape, 2, str(tmp_path / "m"))[0]
    one = _epoch_task(None, 2, str(tmp_path / "one"))
    for a, b in zip(mesh_params, one):
        b = b.numpy()
        assert np.max(np.abs(a - b) / (np.abs(b) + 1e-3)) < 5e-4


def test_mesh_checkpoint_restores_on_one_device(world, tmp_path):
    """A (2, 2) mesh checkpoint (the whole weights and Adam moments, by
    rank 0) restores into a one-device Trainer, and a one-device checkpoint
    into the mesh."""
    one = _trainer("h2,s2,e2", None, str(tmp_path / "one"))
    one.train_one_epoch(0)
    one.save_checkpoint()
    out = world.run(_checkpoint_task, str(tmp_path / "mesh"),
                    str(tmp_path / "one"))[0]
    fresh = _trainer("h2,s2,e2", None, str(tmp_path / "mesh"))
    fresh.restore_checkpoint()
    assert fresh.step == out["step"] > 0
    for a, b in zip(_leaves(fresh.params), out["saved"]):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    saved = fresh.opt.state_dict()["state"]
    for i, st in out["moments"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(saved[i][k].numpy(), st[k])
    assert out["restored_step"] == one.step
    for a, b in zip(out["restored"], _leaves(one.params)):
        np.testing.assert_array_equal(a, b.detach().numpy())


def _evaluate_task(run_dir, likelihood_n):
    tr = _trainer("h2,s2,e2", (2, 2), run_dir, likelihood_n=likelihood_n)
    tr.train_one_epoch(0)
    return {"ll": tr.evaluate_log_likelihood("test"),
            "elbo": tr.evaluate_elbo("test")["elbo"]}


@pytest.mark.parametrize("likelihood_n", [8, 7])
def test_mesh_trainer_evaluates(world, tmp_path, likelihood_n):
    """An epoch on a (2, 2) mesh, then the test ELBO over data shards of
    the 40-example split (eval batch 16 + pad rows) and the IWAE with its
    samples over "model" (n = 8) or, when n does not divide the model axis,
    the one-device estimator with rank 0's value: finite and the same on
    every rank."""
    out = world.run(_evaluate_task, str(tmp_path), likelihood_n)
    assert all(np.isfinite(r["ll"]) and np.isfinite(r["elbo"]) for r in out)
    assert len({r["ll"] for r in out}) == 1
    assert len({r["elbo"] for r in out}) == 1


def test_cli_trains_on_a_cpu_mesh(tmp_path, capsys):
    run = tmp_path / "run"
    result = cli.main(["--dataset", "bdp", "--model", "h2,s2,e2", "--h_dim",
                       "16", "--likelihood_n", "4", "--ll_max_examples",
                       "16", "--epochs", "1", "--device", "cpu", "--mesh",
                       "2,1", "--run_dir", str(run)])
    assert np.isfinite(result["test/log_likelihood_iwae"])
    summary = json.loads((run / "result.json").read_text())
    assert "2x1 mesh" in summary["fused_paths"]["train_tail"]["why"]
    assert (run / "ckpt").exists()


def test_a_failing_rank_makes_the_launcher_raise():
    with pytest.raises(RankError, match="rank one refuses") as exc_info:
        launch(_raise_on_rank_one, 2, 1, device="cpu")
    assert exc_info.value.rank == 1


def test_make_mesh_refuses_a_world_too_small(world):
    assert world.run(_too_small_mesh) == [
        "mesh 3x2 needs 6 processes, have 4"] * 4


def test_a_mesh_without_a_device_refuses_the_cpu():
    """Without a card, a mesh asked for no device raises instead of
    starting ranks on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch(_too_small_mesh, 2, 1)
