"""The mesh's collectives, with autograd where the model needs it.

* ``gather_model``: a weight sharded over "model" put back together at use;
  its backward is a reduce-scatter over "model" (the mean of the model
  ranks' gradients of the whole weight, sliced: the ranks of one data index
  compute the same rows, so their gradients are copies of one gradient).
* ``all_reduce_mean_``: the gradient and statistics sync of a step over
  "data" (or the whole mesh), every tensor in one flat buffer, one
  collective a call.
* ``all_gather_model``: the IWAE's per-rank partial logsumexps over "model".

Under gloo (ranks that share a card), a CUDA tensor is copied to the
host, summed or gathered there by gloo between the processes and copied
back (``_on_host``): a copy around the collective, not a fallback; every
operation of the model runs on the card. NCCL works on the card.
A reduce-scatter is an all-reduce followed by this rank's slice, so gloo
needs no reduce-scatter of its own.
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


def _all_gather(mesh: Mesh, t: torch.Tensor, group, n: int) -> list:
    """The ``n`` ranks' copies of ``t`` over ``group``, in rank order."""
    src = t.detach().contiguous()
    if _on_host(mesh, src):
        parts = [torch.empty_like(src, device="cpu") for _ in range(n)]
        dist.all_gather(parts, src.cpu(), group=group)
        return [p.to(t.device) for p in parts]
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return parts


class _GatherModel(torch.autograd.Function):
    """The whole weight from the model ranks' slices along ``axis``."""

    @staticmethod
    def forward(ctx, shard, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return torch.cat(_all_gather(mesh, shard, mesh.model_group,
                                     mesh.n_model), dim=axis)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = _reduce_one_(mesh, g.contiguous().clone(), mesh.model_group)
        g = g / mesh.n_model
        part = g.chunk(mesh.n_model, ctx.axis)[mesh.model_index]
        return part.contiguous(), None, None


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
    return torch.stack(_all_gather(mesh, t, mesh.model_group, mesh.n_model))
