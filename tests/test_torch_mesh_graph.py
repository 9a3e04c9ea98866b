"""A mesh rank's compiled programs (``mvae_torch/train/graphs.py`` on a
``parallel`` mesh) on the CPU, where they run as the eager loop of the same
bodies.

One world of four gloo ranks (``parallel.launch.World``) serves the module,
at ``tests/test_torch_mesh.py``'s small flagship (h_dim 32, D 16, batch 32):

* ``graphs.path``: "graph" on an NCCL rank of its own card, "eager" with
  its reason on a gloo rank, on the CPU and under the NaN guard; the
  launcher's backend (NCCL naming the cards, gloo when ranks share one);
  ``make_mesh`` makes a shape's process groups once a world;
* the step body a rank's graph captures (``graphs.TrainEpoch.step``), run
  eagerly for two epochs across burn-in on (2, 1), (1, 2) and (2, 2),
  equals the eager mesh step (``Trainer._train_one_epoch_eager``) bit for
  bit, and on the weights and noise of ``test_torch_mesh.py`` equals the
  JAX mesh step within the same 5e-4;
* the on-device row gather of ``TrainEpoch`` gives each step exactly the
  rows ``parallel.shard_batch`` gives the eager step;
* a ``TorchFunctionMode`` finds no host read in a mesh rank's step, ELBO
  and IWAE bodies (the collectives are not torch functions);
* the NCCL branch's reduce-scatter (one ``reduce_scatter_tensor``) equals
  gloo's all-reduce and slice on the same inputs, and its gather the
  shards put together;
* the sharded IWAE's importance draws are seeded apart by model rank,
  once a pass, and repeat from the same generator state.

On a card (``cuda`` marker; skipped here): a (1, 1) NCCL mesh trains
through graphs bit for bit as its eager loop, one capture a program.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from mvae_torch.parallel import make_mesh, shard_batch
from mvae_torch.parallel.collectives import (_all_gather,
                                             _reduce_scatter_mean,
                                             gather_model)
from mvae_torch.parallel.launch import World, launch
from mvae_torch.train import graphs
from mvae_torch.train.trainer import _leaves
from mvae_torch.utils import profiling
from tests.test_torch_graph import HostReads
from tests.test_torch_mesh import B, D, _outside, _trainer, _whole_grads


@pytest.fixture(scope="module")
def world():
    with World(4, device="cpu") as w:
        yield w


# --- rank tasks (no JAX) ---------------------------------------------------------


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_leaves(a.params),
                                                  _leaves(b.params)))


def _body_epochs_task(shape, run_dir):
    """Two epochs (burn-in 1) of the eager mesh loop and of the graph's
    step body run eagerly, from one seed: (statistics equal, weights equal,
    generators equal, steps)."""
    if _outside(shape):
        return None
    a = _trainer("h2,s2,e2", shape, f"{run_dir}/a", burnin_epochs=1)
    b = _trainer("h2,s2,e2", shape, f"{run_dir}/b", burnin_epochs=1)
    body = graphs.TrainEpoch(b)
    stats_equal = []
    for epoch in range(2):
        want = a._train_one_epoch_eager(epoch)
        got = b._epoch_means(body.run(b._epoch_perm(), graph=False))
        b.step += b.steps_per_epoch
        stats_equal.append(got == want)
    return {"stats": stats_equal, "params": _same(a, b),
            "rng": torch.equal(a.generator.get_state(),
                               b.generator.get_state()),
            "steps": (a.step, b.step, int(b._step_t))}


def _body_step_task(spec, shape, whole, x, noise, run_dir):
    """One step of the graph's step body (run eagerly) on the whole batch
    ``x`` and noise ``noise``: its loss and every whole gradient."""
    if _outside(shape):
        return None
    tr = _trainer(spec, shape, run_dir, whole)
    tr._train_data = torch.from_numpy(x)
    tr.steps_per_epoch = 1
    body = graphs.TrainEpoch(tr)
    stats = body.run(torch.arange(B)[None], torch.zeros((1, B, D)),
                     torch.from_numpy(noise)[None], graph=False)
    return {"elbo": stats["elbo"][0], "grads": _whole_grads(tr)}


def _row_gather_task(shape, run_dir):
    """The rows each step of ``TrainEpoch`` gathers on the device against
    ``shard_batch`` of the global batch."""
    if _outside(shape):
        return None
    tr = _trainer("h2,s2,e2", shape, run_dir)
    seen = []

    def record(x, u, nz):
        seen.append(x.clone())
        return {"elbo": torch.zeros(())}

    tr._step_body = record
    perm = tr._epoch_perm()
    graphs.TrainEpoch(tr).run(perm, graph=False)
    batches = perm.reshape(tr.steps_per_epoch, B)
    return [torch.equal(x, shard_batch(tr._train_data[batches[k]], tr.mesh))
            for k, x in enumerate(seen)]


def _host_reads_task(run_dir):
    """The host reads a (2, 2) rank's step, ELBO and IWAE bodies make after
    one warm-up call of each."""
    tr = _trainer("h2,s2,e2", (2, 2), run_dir, burnin_epochs=1)
    body = graphs.TrainEpoch(tr)
    body.perm.copy_(tr._epoch_perm().reshape(tr.steps_per_epoch, B)[
        :, body.rows])
    x = tr._test_data[:B]
    mask = torch.ones(B)
    rows = torch.arange(B)

    def calls():
        body.step()
        with torch.no_grad():
            tr._elbo_batch(tr.whole_params(), x, mask, rows)
            tr._ll_batch_sharded(tr.params, x, mask, rows)

    calls()
    with HostReads() as mode:
        calls()
    return sorted(set(mode.seen))


def _reduce_scatter_task(shape, axis):
    """gloo's all-reduce and slice against the NCCL branch's
    reduce-scatter, and the gather's two branches, on dyadic values (every
    sum exact): (reduce-scatters equal, gathers equal)."""
    import torch.distributed as dist
    if _outside(shape):
        return None
    mesh = make_mesh(*shape, device="cpu")
    nccl = dataclasses.replace(mesh, backend="nccl")
    gen = torch.Generator().manual_seed(dist.get_rank())
    g = torch.randint(-64, 64, (8, 12), generator=gen).float() / 8
    rs = [_reduce_scatter_mean(m, g, axis) for m in (mesh, nccl)]
    whole = gather_model(rs[0], axis, mesh)
    parts = _all_gather(nccl, rs[1], mesh.model_group, mesh.n_model)
    return {"rs": torch.equal(rs[0], rs[1]),
            "shape": tuple(rs[1].shape),
            "gather": torch.equal(whole, torch.cat(parts.unbind(0), axis))}


def _sample_seeds_task(run_dir):
    """A (2, 2) rank's sharded IWAE pass twice from one generator state:
    (data index, model index, the importance draws' seed of each pass, the
    two estimates)."""
    tr = _trainer("h2,s2,e2", (2, 2), run_dir)
    state = tr.generator.get_state()
    seeds, lls = [], []
    for _ in range(2):
        tr.generator.set_state(state)
        lls.append(tr.evaluate_log_likelihood("test"))
        seeds.append(tr._sample_generator.initial_seed())
    return {"d": tr.mesh.data_index, "m": tr.mesh.model_index,
            "seeds": seeds, "lls": lls}


def _mesh_twice_task():
    """Whether a shape's second ``make_mesh`` returns its first mesh, and
    another shape a mesh of its own."""
    a = make_mesh(2, 2, device="cpu")
    b = make_mesh(2, 2, device="cpu")
    c = make_mesh(4, 1, device="cpu")
    return a is b and c is not a and c.shape == {"data": 4, "model": 1}


def _nccl_graphs_task(run_dir):
    """On one card: a (1, 1) NCCL mesh's two epochs through graphs and
    through the eager loop, then its ELBO and IWAE passes."""
    g = _trainer_on_card((1, 1), f"{run_dir}/g")
    e = _trainer_on_card((1, 1), f"{run_dir}/e")
    stats = []
    for epoch in range(2):
        stats.append(g.train_one_epoch(epoch) == e._train_one_epoch_eager(
            epoch))
    g.evaluate_elbo("test")
    g.evaluate_log_likelihood("test")
    return {"path": g.graph_path["path"], "backend": g.mesh.backend,
            "stats": stats, "params": _same(g, e),
            "captures": graphs.captures(g)}


def _trainer_on_card(shape, run_dir):
    from mvae_torch.components import parse_components
    from mvae_torch.data import ArrayDataset
    from mvae_torch.models import vae
    from mvae_torch.train import TrainConfig, Trainer
    rng = np.random.default_rng(0)
    train = (rng.random((64 * 8, 784)) < 0.4).astype(np.float32)
    # two eval batches of 512: the first is the warm-up, the second captured
    test = (rng.random((1024, 784)) < 0.4).astype(np.float32)
    cfg = vae.VAEConfig(parse_components("h2,s2,e2", fixed_curvature=False),
                        (784,), h_dim=400)
    return Trainer(cfg, ArrayDataset("tiny", train, test, (784,), True),
                   TrainConfig(batch_size=64, burnin_epochs=1, seed=3,
                               likelihood_n=500, mesh_shape=shape), run_dir)


# --- tests -------------------------------------------------------------------------


def _fake(device, backend=None):
    mesh = None if backend is None else types.SimpleNamespace(
        backend=backend, rank=1, n_data=2, n_model=2)
    return types.SimpleNamespace(device=torch.device(device), mesh=mesh)


@pytest.mark.parametrize("device,backend,path,why", [
    ("cuda", "nccl", "graph", "NCCL rank 1 of the 2x2 mesh"),
    ("cuda", None, "graph", "one CUDA graph of a training step"),
    ("cuda", "gloo", "eager", "gloo mesh rank"),
    ("cpu", "gloo", "eager", "CUDA devices only"),
    ("cpu", None, "eager", "CUDA devices only")])
def test_path_on_mesh_ranks(device, backend, path, why):
    got = graphs.path(_fake(device, backend))
    assert got["path"] == path and why in got["why"], got


def test_nan_guard_takes_the_eager_path_on_an_nccl_rank():
    profiling.enable_nan_guard()
    try:
        got = graphs.path(_fake("cuda", "nccl"))
    finally:
        profiling.disable_nan_guard()
    assert got["path"] == "eager" and "--debug_nans" in got["why"]


@pytest.mark.parametrize("ranks,backend,why", [
    (4, "nccl", "4 ranks on 4 of 4 cards, one card a rank (cuda:0 H100"),
    (2, "nccl", "2 ranks on 2 of 4 cards"),
    (8, "gloo", "8 ranks share 4 card(s)")])
def test_backend_for_names_the_cards(monkeypatch, ranks, backend, why):
    """NCCL when every rank has a card of its own, the reason naming the
    cards; gloo, printed as staged through the host, when ranks share."""
    from mvae_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "H100")
    got, reason = mesh.backend_for(ranks)
    assert got == backend and why in reason, reason
    if backend == "gloo":
        assert "through the host" in reason


def test_make_mesh_reuses_a_shapes_groups(world):
    assert world.run(_mesh_twice_task) == [True] * 4


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_step_body_equals_eager_mesh_epochs(world, tmp_path, shape):
    out = [r for r in world.run(_body_epochs_task, shape, str(tmp_path))
           if r is not None]
    assert len(out) == shape[0] * shape[1]
    for r in out:
        assert r["stats"] == [True, True]
        assert r["params"] and r["rng"]
        assert r["steps"] == (4, 4, 4)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_step_body_matches_jax_mesh(world, monkeypatch, tmp_path, shape):
    """The step body on ``test_torch_mesh.py``'s weights, batch and noise
    against ``jax.jit`` of the reference's mesh ``loss_fn`` (loss and every
    gradient within 5e-4, as that file holds the eager step)."""
    import jax
    from mvae_tpu.kernels.tail_kernels import draw_noise_t
    from mvae_tpu.models import vae as jvae
    from mvae_tpu.parallel import make_mesh as j_make_mesh
    from mvae_tpu.parallel import shard_batch as j_shard_batch
    from mvae_tpu.parallel import shard_params as j_shard_params
    from tests.test_torch_mesh import _jax_model
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
    out = [r for r in world.run(_body_step_task, "h2,s2,e2", shape,
                                jax.tree.map(np.asarray, params), x, noise,
                                str(tmp_path)) if r is not None]
    assert len(out) == shape[0] * shape[1]
    for r in out:
        np.testing.assert_allclose(-r["elbo"], float(loss_j), rtol=1e-5,
                                   atol=1e-5)
        for a, b in zip(r["grads"], jax.tree.leaves(g_j)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4,
                                       atol=5e-4)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_row_gather_equals_shard_batch(world, tmp_path, shape):
    out = world.run(_row_gather_task, shape, str(tmp_path))
    assert all(r == [True, True] for r in out)


def test_no_host_reads_in_mesh_bodies(world, tmp_path):
    assert world.run(_host_reads_task, str(tmp_path)) == [[]] * 4


@pytest.mark.parametrize("shape,axis", [((2, 2), 0), ((2, 2), 1),
                                        ((1, 4), 1)])
def test_reduce_scatter_equals_all_reduce_slice(world, shape, axis):
    out = [r for r in world.run(_reduce_scatter_task, shape, axis)
           if r is not None]
    want = [8, 12]
    want[axis] //= shape[1]
    assert len(out) == 4
    assert all(r["rs"] and r["gather"] and r["shape"] == tuple(want)
               for r in out)


def test_sharded_iwae_draws_apart_by_model_rank(world, tmp_path):
    """The sharded IWAE's draws come from a generator seeded once a pass
    from the data shard's generator and the model index: every rank its
    own seed, the same seed and estimate again from the same state, and
    one estimate on every rank."""
    out = world.run(_sample_seeds_task, str(tmp_path))
    assert sorted((r["d"], r["m"]) for r in out) == [(0, 0), (0, 1), (1, 0),
                                                     (1, 1)]
    assert len({r["seeds"][0] for r in out}) == 4
    for r in out:
        assert r["seeds"][0] == r["seeds"][1]
        assert r["lls"][0] == r["lls"][1] and np.isfinite(r["lls"][0])
    assert len({r["lls"][0] for r in out}) == 1


@pytest.mark.cuda
def test_nccl_mesh_graphs_equal_eager_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and CUDA graphs exist only there")
    out = launch(_nccl_graphs_task, 1, 1, str(tmp_path))[0]
    assert out["path"] == "graph" and out["backend"] == "nccl"
    assert out["stats"] == [True, True] and out["params"]
    assert out["captures"] == {"train_step": 1, "eval_elbo": 1,
                               "eval_ll": 1}
