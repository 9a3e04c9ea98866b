"""Parallelism: the ("data", "model") mesh on ``torch.distributed``.

Counterpart of ``mvae_tpu/parallel``: one process a mesh position
(``launch``), the batch over "data", the wide encoder and decoder weights
over "model" (``mesh``), gathered at use with their gradients
reduce-scattered back (``collectives``).
"""
from .mesh import (Mesh, batch_sharding, make_mesh, param_shardings,
                   replicated, shard_batch, shard_params)

__all__ = ["Mesh", "make_mesh", "batch_sharding", "replicated",
           "param_shardings", "shard_params", "shard_batch"]
