"""The ("data", "model") mesh and its sharding layout on torch.distributed.

Counterpart of ``mvae_tpu/parallel/mesh.py``. The reference lays a mesh
over the devices one process drives; the port runs one process a mesh
position (``parallel.launch``), rank ``d * n_model + m`` at data index ``d``
and model index ``m``, and keeps the reference's layout:

* the batch axis is sharded over "data": a rank sees B / n_data rows
  (``shard_batch``);
* the wide encoder / decoder weights are sharded over "model"
  (``_spec_for_param``: linear kernels on their hidden side, conv kernels on
  their output channels): a rank holds one slice of each, and of its Adam
  moments (``shard_params``);
* everything small (component heads, biases, curvatures) is replicated.

The ranks of one data index compute the same rows on the same noise; the
model axis splits the weights' storage and the IWAE's importance samples
(``models.vae.log_likelihood_sharded``). ``collectives`` gathers a sharded
weight at use and reduce-scatters its gradient back.

The process group is the launcher's: ``nccl`` when every rank has a card of
its own, ``gloo`` when ranks share a card or run on the CPU
(``backend_for``). Under NCCL a rank's step and eval batches are CUDA
graphs with their collectives inside (``train.graphs``); under gloo they
run eagerly.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the mesh and the process groups of its axes:
    ``data_group`` holds the ranks of its model index (the "data" axis it
    reduces over), ``model_group`` those of its data index."""

    shape: dict
    data_index: int
    model_index: int
    device: torch.device
    backend: str
    group: object
    data_group: object
    model_group: object

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.model_index

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    def rows(self, n: int) -> slice:
        """This data shard's rows of a batch of ``n``."""
        if n % self.n_data:
            raise ValueError(f"batch {n} does not divide the data axis "
                             f"{self.n_data}")
        per = n // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)


def fold_seed(seed: int, index: int) -> int:
    """A generator seed from (seed, index), distinct per index: the
    counterpart of ``fold_in(key, index)`` for a torch generator."""
    h = (seed * 0x9E3779B97F4A7C15 + index + 1) & (2**64 - 1)
    h ^= h >> 31
    h = (h * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    return (h ^ (h >> 29)) & (2**63 - 1)


def backend_for(n_ranks: int, device=None) -> tuple[str, str]:
    """(backend, reason): ``nccl`` when each of ``n_ranks`` CUDA ranks has
    a card of its own, ``gloo`` when ranks share a card or run on the
    CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", "ranks on the CPU"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mvae_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    cards = torch.cuda.device_count()
    if n_ranks <= cards:
        names = ", ".join(f"cuda:{i} {torch.cuda.get_device_name(i)}"
                          for i in range(n_ranks))
        return "nccl", (f"{n_ranks} ranks on {n_ranks} of {cards} cards, "
                        f"one card a rank ({names})")
    return "gloo", (f"{n_ranks} ranks share {cards} card(s): NCCL takes one "
                    f"card a rank, so the collectives are staged through "
                    f"the host and the ranks run eagerly")


def rank_device(rank: int, device=None) -> torch.device:
    """``cuda:(rank % device_count)``, or the CPU when asked for."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mvae_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


# meshes made in this process, by (world group, shape, device): NCCL makes a
# communicator, with its buffers on the card, for each process group at its
# first collective, so the trainers of one process share their mesh's groups
# instead of making new ones (the key holds the world group itself, so a
# later world cannot take its id)
_MESHES: dict = {}


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device=None) -> Mesh | None:
    """The mesh of the first n_data x n_model ranks of the initialized
    world (``n_data`` defaults to world size // n_model). Every rank of the
    world calls it, in the same order as every other collective; a rank
    outside the mesh gets None. A shape's process groups are made at its
    first call in the world; later calls return the same mesh."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group of "
                           "mvae_torch.parallel.launch")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model} has no rank")
    if n_data * n_model > world:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} processes, "
            f"have {world}")
    key = (dist.group.WORLD, n_data, n_model, str(device))
    if key in _MESHES:
        return _MESHES[key]
    grid = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    # every rank of the world enters every new_group, members or not
    group = dist.new_group(list(range(n_data * n_model)))
    data_groups = [dist.new_group([grid[d][m] for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group(grid[d]) for d in range(n_data)]
    mesh = None
    if rank < n_data * n_model:
        d, m = divmod(rank, n_model)
        mesh = Mesh({"data": n_data, "model": n_model}, d, m,
                    rank_device(rank, device), dist.get_backend(), group,
                    data_groups[m], model_groups[d])
    _MESHES[key] = mesh
    return mesh


def batch_sharding(mesh: Mesh) -> tuple:
    """The batch layout: axis 0 over "data" (the reference's P("data"))."""
    return ("data",)


def replicated(mesh: Mesh) -> tuple:
    """Every axis whole on every rank (the reference's P())."""
    return ()


def _spec_for_param(path: str, leaf) -> tuple:
    """Model-parallel layout: shard the wide hidden dimension (the
    reference's PartitionSpec as a tuple, one entry an axis)."""
    if leaf.ndim == 2:
        # Linear kernels (in, out): encoder hidden out / decoder hidden in
        if "encoder" in path and "w" in path:
            return (None, "model")
        if "decoder" in path and "w" in path:
            # fc layers into/out of the hidden dim: shard hidden side
            return ("model", None) if path.endswith("out/w") else (
                None, "model")
    if leaf.ndim == 4 and "conv" in path:  # HWIO kernels: shard out channels
        return (None, None, None, "model")
    return ()


def _paths(tree, prefix: str = ""):
    """(path, leaf) in the reference's pytree order ("/"-joined keys and
    indices, dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a params tree, keeping its structure; the
    leaves are visited in ``_paths`` order."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], f"{prefix}{k}/") for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return tuple(_map(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def param_shardings(mesh: Mesh, params) -> dict:
    """The layout of a whole params tree: each leaf's axis sharded over
    "model" (``_spec_for_param``), or None when it is replicated. A leaf
    whose axis does not divide the model axis (a conv decoder's 3 output
    channels over 2 ranks) stays replicated, where the reference pads its
    shards."""
    def axis(path, leaf):
        spec = _spec_for_param(path, leaf)
        if "model" not in spec:
            return None
        ax = spec.index("model")
        return ax if leaf.shape[ax] % mesh.n_model == 0 else None
    return _map(axis, params)


def shard_params(params, mesh: Mesh):
    """This rank's params from a whole tree: its model index's slice of
    each sharded leaf (a copy), the replicated leaves as they are."""
    axes = iter(_leaves(param_shardings(mesh, params)))

    def shard(path, leaf):
        ax = next(axes)
        if ax is None:
            return leaf
        return leaf.detach().chunk(mesh.n_model, ax)[mesh.model_index].clone()
    return _map(shard, params)


def _leaves(tree) -> list:
    return [leaf for _, leaf in _paths(tree)]


def shard_batch(x, mesh: Mesh):
    """This data shard's rows of ``x`` (a view)."""
    return x[mesh.rows(x.shape[0])]
