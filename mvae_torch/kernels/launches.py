"""The model's kernel wrappers, and the launches a CUDA graph's replays add.

``WRAPPERS`` names every kernel wrapper the model calls through its module,
as (module, attribute): a plain recomputation swaps those attributes
(``chip_smoke.py``'s ``plain_kernels``), and the graph cache key holds
their current objects (``train.graphs.routing_key``). ``COUNTED`` is the
functions whose ``launches`` count those wrappers' calls; a graph's replays
add what its capture recorded, so the counts are what ran on the card.
"""
from __future__ import annotations

from . import decoder_kernels, manifold_kernels, optim_kernels, tail_kernels

WRAPPERS = ((tail_kernels, "tail_forward"),
            (tail_kernels, "tail_backward"),
            (tail_kernels, "reparam_chunk_t"),
            (manifold_kernels, "wrapped_reparam_stereo_t"),
            (decoder_kernels, "fused_decode_bce_t"),
            (decoder_kernels, "train_decode_fwd"),
            (optim_kernels, "adam"))

# B6's forward is counted on its autograd entry point train_decode_bce
COUNTED = tuple(decoder_kernels.train_decode_bce if name == "train_decode_fwd"
                else getattr(mod, name) for mod, name in WRAPPERS)


def captured_launches(record, counted=COUNTED) -> dict:
    """Run ``record``, which captures wrapper calls into a CUDA graph, and
    return each ``counted`` function's calls in it, taken back off its
    count; each replay of the graph adds them (``count_replays``)."""
    before = {f: f.launches for f in counted}
    record()
    per_replay = {f: f.launches - n for f, n in before.items()
                  if f.launches != n}
    for f in per_replay:
        f.launches = before[f]
    return per_replay


def count_replays(per_replay: dict, replays: int) -> None:
    for f, n in per_replay.items():
        f.launches += n * replays
