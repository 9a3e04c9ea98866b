"""The trainer's compiled programs as CUDA graphs (L5).

Counterpart of the reference's jitted programs and their memoization
(``mvae_tpu/train/trainer.py::make_train_epoch``, ``make_eval_elbo``,
``make_eval_ll``, ``_memoized``). The reference compiles a whole epoch into
one ``lax.scan`` so that the host never issues a step; here one training
step, one ELBO batch and one IWAE batch are each captured once into a CUDA
graph and replayed, so a step reaches the card as one graph launch instead
of ~90 host-issued ops:

* ``TrainEpoch`` holds the static buffers of the epoch: the batch order
  ``perm`` (steps, batch), the step index ``k`` on the device, the step's
  statistics written at row ``k`` of (steps, ...) buffers. ``TrainEpoch.step``
  is the body the graph captures: it gathers its batch at ``k`` and runs
  ``Trainer._step_body`` (binarize, loss, backward, the curvature mask at
  the device step counter, Adam). The burn-in mask is traced, as the
  reference's, so one capture serves burn-in and after.
* ``Graphed`` runs a body over static buffers: its first calls are real
  calls on a side stream (they initialise Adam's state, the kernels'
  scratch and the cached tables, and their results are used), then it
  captures the body once and replays it. Randomness comes from the
  trainer's generator, registered with each graph, so each replay draws
  the next Philox numbers exactly as an eager call would.
* ``routing_key`` is the cache key's part that the reference takes from
  its routing switches: the route a capture froze (``models.route``), and
  the kernel wrappers it called (``kernels.launches.WRAPPERS``: a swapped
  wrapper, as ``chip_smoke.py``'s plain recomputations swap them, gets its
  own capture).

A rank of an NCCL mesh (a card a rank, ``parallel``) captures the same
programs with its collectives inside: the weight gathers and gradient
reduce-scatters over "model", the flat all-reduce of the gradients and
statistics, the IWAE's all-gather of partial logsumexps. Its warm-up calls
run every collective of the program once, so NCCL has made the
communicator of each process group before the capture; the capture runs
in ``thread_local`` mode, so that NCCL's watchdog thread may query its
events meanwhile. ``TrainEpoch`` keeps only the rank's columns of the
batch order, so a step gathers its rows on the card.

Each replay adds to the kernel wrappers' ``launches`` what its capture
recorded (``launches.captured_launches`` / ``count_replays``), so the counts
are what ran on the card. ``Graphed`` captures each body twice: the plain
graph, and beside it a graph of the same body with the layer markers of
``utils.profiling`` (a graph keeps no host range, so its layers show in a
trace as marker kernels); a replay takes the marked one while a torch
profiler records and the plain one otherwise, and the calls' copies, the
replays and the capture are host spans then. A capture that fails raises:
nothing falls back to the eager loop on a CUDA device. ``path`` says where
the graphs do not apply (the CPU, a gloo mesh rank, the NaN guard) and why.
"""
from __future__ import annotations

import torch

from ..kernels import launches
from ..models import nets
from ..models.route import route
from ..utils import profiling

# real steps (batches) run on a side stream before a capture: PyTorch's
# recipe for capturing a training step (optimizer state, cuBLAS workspaces)
WARMUP_STEPS = 3
WARMUP_BATCHES = 1


def path(trainer) -> dict:
    """Whether ``trainer`` replays graphs ("graph") or runs the eager loop
    ("eager"), and why. The choice follows the device and the mesh's
    backend, as the reference's follows its backend."""
    if trainer.device.type != "cuda":
        return {"path": "eager", "why": f"{trainer.device.type} device: "
                "CUDA graphs exist on CUDA devices only"}
    mesh = trainer.mesh
    if mesh is not None and mesh.backend != "nccl":
        return {"path": "eager", "why": f"{mesh.backend} mesh rank: ranks "
                "that share a card stage their collectives through the "
                "host, which a CUDA graph cannot capture"}
    if profiling.nan_guard_enabled():
        return {"path": "eager", "why": "the NaN guard (--debug_nans) reads "
                "every op's output on the host"}
    where = ("" if mesh is None else
             f" on NCCL rank {mesh.rank} of the {mesh.n_data}x{mesh.n_model} "
             f"mesh, its collectives inside")
    return {"path": "graph", "why": "one CUDA graph of a training step, of "
            "an ELBO batch and of an IWAE batch, each captured once per "
            f"(shape, routing) and replayed{where}"}


def captures(trainer) -> dict:
    """How many graphs ``trainer`` captured, by program kind ("train_step",
    "eval_elbo", "eval_ll"): one of each a run where every call shares its
    shapes and routing."""
    out: dict = {}
    for key, prog in trainer._programs.items():
        out[key[0]] = out.get(key[0], 0) + prog.captures
    return out


def routing_key(cfg, params) -> tuple:
    """Every routing decision a capture of ``cfg``'s step or eval batch
    freezes: the route (``MVAE_FUSED_TRAIN_DECODER`` is read at every
    forward), the kernel wrappers themselves, and the TF32 switches of
    cuBLAS and of the conv nets."""
    return (route(cfg, params),
            tuple(getattr(mod, name) for mod, name in launches.WRAPPERS),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, nets._cudnn_f32)


_SIDE: dict = {}


def _side_stream(device) -> torch.cuda.Stream:
    s = _SIDE.get(device)
    if s is None:
        s = _SIDE[device] = torch.cuda.Stream(device)
    return s


class Graphed:
    """``fn(*statics)`` as a CUDA graph. A call copies its inputs into the
    static buffers ``statics``; the first ``warmup`` calls run ``fn`` on a
    side stream (their results are the call's), the next captures it once
    and every call from then on replays it. ``generator`` (one, or a tuple)
    is registered with the graph: each replay draws its next numbers.
    ``copy_out`` returns a copy of the static outputs (a tensor or a tuple
    or dict of them) of each replay. ``marked`` is the same body captured
    with the layer markers, in a pool of its own, replayed instead of
    ``graph`` while a torch profiler records."""

    def __init__(self, fn, statics, generator, warmup: int,
                 copy_out: bool = False):
        self.fn = fn
        self.statics = statics
        self.generators = (generator if isinstance(generator, tuple)
                           else (generator,))
        self.warmup = warmup
        self.copy_out = copy_out
        self.graph = self.marked = None
        self.out = self.marked_out = None
        self.per_replay: dict = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, *inputs):
        marked = profiling.markers_on()
        span = profiling.span if marked else profiling.no_span
        with span("graph.copy_in"):
            for s, x in zip(self.statics, inputs):
                if s is not None:
                    s.copy_(x)
        if self.graph is None and self.warmup > 0:
            self.warmup -= 1
            return self._warm()
        if self.graph is None:
            self._capture()
        with span("graph.replay"):
            (self.marked if marked else self.graph).replay()
        self.replays += 1
        launches.count_replays(self.per_replay, 1)
        out = self.marked_out if marked else self.out
        if not self.copy_out:
            return out
        with span("graph.copy_out"):
            return _copy(out)

    def _warm(self):
        cur = torch.cuda.current_stream()
        side = _side_stream(cur.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(*self.statics)
        cur.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(cur)
        return out

    def _record(self, marks: bool) -> None:
        """One capture of the body, with its markers (``marked``,
        ``marked_out``) or without (``graph``, ``out``)."""
        g = torch.cuda.CUDAGraph()
        for gen in self.generators:
            g.register_generator_state(gen)
        # thread_local: another thread's CUDA calls (NCCL's watchdog
        # querying its events) do not break the capture
        with profiling.marking(marks), \
                torch.cuda.graph(g, capture_error_mode="thread_local"):
            out = self.fn(*self.statics)
        if marks:
            self.marked, self.marked_out = g, out
        else:
            self.graph, self.out = g, out

    def _capture(self):
        with profiling.span("graph.capture"):
            self.per_replay = launches.captured_launches(
                lambda: self._record(False))
            # the marked graph's wrapper calls are the plain one's: its
            # capture leaves the launch counts as they were
            launches.captured_launches(lambda: self._record(True))
        self.captures += 1


def _tensors(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return [v for v in out.values() if torch.is_tensor(v)]
    if isinstance(out, (tuple, list)):
        return [v for v in out if torch.is_tensor(v)]
    return []


def _copy(out):
    if torch.is_tensor(out):
        return out.clone()
    if isinstance(out, dict):
        return {k: v.clone() for k, v in out.items()}
    return type(out)(v.clone() for v in out)


class TrainEpoch:
    """The static buffers of a training epoch and the step body that the
    graph captures (``make_train_epoch``'s scan body). ``u_bin`` and
    ``noise`` (steps, batch, ...) are explicit binarization uniforms and
    reparameterization noise, for runs that hold the step to another
    implementation on the same draws; without them the step draws from the
    trainer's generator. On a mesh the buffers hold the rank's columns of
    the global batch (``Mesh.rows``), cut once an epoch on the card: a
    step gathers exactly the rows ``parallel.shard_batch`` gives the eager
    step."""

    def __init__(self, trainer):
        self.trainer = trainer
        S, bs, dev = trainer.steps_per_epoch, trainer.tc.batch_size, \
            trainer.device
        # this rank's columns of a (steps, batch) buffer
        mesh = trainer.mesh
        self.rows = slice(None) if mesh is None else mesh.rows(bs)
        per_rank = bs if mesh is None else bs // mesh.n_data
        self.perm = torch.zeros((S, per_rank), dtype=torch.int64, device=dev)
        self.k = torch.zeros(1, dtype=torch.int64, device=dev)
        self.u_bin = self.noise = None
        self.explicit = False
        self.stats: dict | None = None

    def step(self) -> None:
        """One step from the static buffers: the batch at row ``k`` of
        ``perm``, its statistics written at row ``k``, ``k`` advanced; its
        markers open with ``encode`` and close with ``end``."""
        tr = self.trainer
        profiling.mark("encode", self.k)
        x = tr._train_data.index_select(0, self.perm.index_select(
            0, self.k)[0])
        u = nz = None
        if self.explicit:
            u = self.u_bin.index_select(0, self.k)[0]
            nz = self.noise.index_select(0, self.k)[0]
        stats = tr._step_body(x, u, nz)
        if self.stats is None:
            self.stats = {name: torch.zeros((len(self.perm),) + v.shape,
                                            dtype=v.dtype, device=v.device)
                          for name, v in stats.items()}
        for name, v in stats.items():
            self.stats[name].index_copy_(0, self.k, v.unsqueeze(0))
        self.k += 1
        profiling.mark("end", self.k)

    def run(self, perm, u_bin=None, noise=None, graph: bool = True) -> dict:
        """One epoch over ``perm`` (steps x batch example indices): replays
        of the step's graph (``graph``) or the step body run eagerly.
        Returns the (steps, ...) statistics buffers."""
        tr = self.trainer
        S = len(self.perm)
        with profiling.span("epoch.copy_in"):
            self.perm.copy_(perm.reshape(S, -1)[:, self.rows])
            self.k.zero_()
            self.explicit = u_bin is not None
            if self.explicit:
                u_bin, noise = u_bin[:, self.rows], noise[:, self.rows]
                if self.u_bin is None:
                    self.u_bin = torch.empty_like(u_bin)
                    self.noise = torch.empty_like(noise)
                self.u_bin.copy_(u_bin)
                self.noise.copy_(noise)
        if not graph:
            with profiling.span("epoch.replays"):
                for _ in range(S):
                    self.step()
        else:
            key = ("train_step", tuple(tr._train_data.shape[1:]),
                   tr._train_data.dtype, tuple(self.perm.shape),
                   self.explicit, tr.tc.beta, tr.burnin_steps,
                   routing_key(tr.model_cfg, tr.params))
            prog = tr._program(key, lambda: Graphed(
                self.step, (), tr.generator, WARMUP_STEPS))
            with profiling.span("epoch.replays"):
                for _ in range(S):
                    prog()
        return self.stats
