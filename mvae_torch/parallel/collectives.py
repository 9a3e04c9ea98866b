"""The mesh's collectives, with autograd where the model needs it.

* ``gather_model``: a weight sharded over "model" put back together at use;
  its backward is a reduce-scatter over "model" (the mean of the model
  ranks' gradients of the whole weight, sliced: the ranks of one data index
  compute the same rows, so their gradients are copies of one gradient).
* ``all_reduce_mean_``: the gradient and statistics sync of a step over
  "data" (or the whole mesh), every tensor in one flat buffer, one
  collective a call.
* ``all_gather_model``: the IWAE's per-rank partial logsumexps over "model".

Under NCCL (a card a rank) every collective works on the card, on the
current stream, into a buffer whose shape the inputs fix, and reads
nothing on the host: a CUDA graph of a rank's step or eval batch captures
them (``train.graphs``). The gather is one ``all_gather_into_tensor`` and
the gradient's reduce-scatter one ``reduce_scatter_tensor``.

Under gloo (ranks that share a card), a CUDA tensor is copied to the
host, summed or gathered there by gloo between the processes and copied
back (``_on_host``): a copy around the collective, not a fallback; every
operation of the model runs on the card. Those host copies cannot be
captured, so gloo ranks run eagerly. Gloo's reduce-scatter is an all-reduce
followed by this rank's slice, which needs no collective of its own on the
host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh


def _on_host(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _reduce_one_(mesh: Mesh, t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place."""
    if _on_host(mesh, t):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _all_gather(mesh: Mesh, t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *t.shape): the ``n`` ranks' copies of ``t`` over ``group``, in
    rank order."""
    src = t.detach().contiguous()
    if _on_host(mesh, src):
        parts = [torch.empty_like(src, device="cpu") for _ in range(n)]
        dist.all_gather(parts, src.cpu(), group=group)
        return torch.stack(parts).to(t.device)
    out = src.new_empty((n,) + src.shape)
    dist.all_gather_into_tensor(out.view(-1), src.view(-1), group=group)
    return out


def _reduce_scatter_mean(mesh: Mesh, g: torch.Tensor, axis: int):
    """This model rank's slice along ``axis`` of the mean of the model
    ranks' ``g``: under gloo an all-reduce then the slice, else one
    reduce-scatter of ``g``'s slices stacked in rank order."""
    n = mesh.n_model
    if mesh.backend == "gloo":
        g = _reduce_one_(mesh, g.contiguous().clone(), mesh.model_group) / n
        return g.chunk(n, axis)[mesh.model_index].contiguous()
    stacked = torch.stack(g.chunk(n, axis))
    part = stacked.new_empty(stacked.shape[1:])
    dist.reduce_scatter_tensor(part.view(-1), stacked.view(-1),
                               group=mesh.model_group)
    return part / n


class _GatherModel(torch.autograd.Function):
    """The whole weight from the model ranks' slices along ``axis``."""

    @staticmethod
    def forward(ctx, shard, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        parts = _all_gather(mesh, shard, mesh.model_group, mesh.n_model)
        return torch.cat(parts.unbind(0), dim=axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_mean(ctx.mesh, g, ctx.axis), None, None


def gather_model(shard: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """The whole weight of a leaf sharded along ``axis`` over "model"."""
    if mesh.n_model == 1:
        return shard
    return _GatherModel.apply(shard, axis, mesh)


def gather_params(params, mesh: Mesh, axes):
    """The whole params tree from this rank's shards, differentiable in
    the shards; ``axes`` is the whole tree's layout
    (``parallel.mesh.param_shardings``)."""
    from .mesh import _leaves, _map
    axes = iter(_leaves(axes))

    def gather(path, leaf):
        ax = next(axes)
        return leaf if ax is None else gather_model(leaf, ax, mesh)
    return _map(gather, params)


def all_reduce_mean_(mesh: Mesh, tensors: list, group=None) -> None:
    """Replace each tensor by its mean over ``group`` (the whole mesh by
    default), in place, through one flat buffer."""
    group = mesh.group if group is None else group
    all_reduce_sum_(mesh, tensors, group, 1.0 / dist.get_world_size(group))


def all_reduce_sum_(mesh: Mesh, tensors: list, group=None,
                    scale: float = 1.0) -> None:
    """Replace each tensor by ``scale`` times its sum over ``group`` (the
    whole mesh by default), in place, through one flat buffer."""
    if not tensors:
        return
    group = mesh.group if group is None else group
    dtype = (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
             else torch.float32)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    _reduce_one_(mesh, flat, group)
    if scale != 1.0:
        flat *= scale
    o = 0
    for t in tensors:
        k = t.numel()
        t.copy_(flat[o:o + k].reshape(t.shape))
        o += k


def all_gather_model(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(n_model, ...) the model ranks' ``t``, stacked in model order."""
    return _all_gather(mesh, t, mesh.model_group, mesh.n_model)
