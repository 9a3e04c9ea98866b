"""Start the ranks of a mesh: one process a (data, model) position.

The reference drives every device of its mesh from one process; the port
starts n_data x n_model processes with ``torch.multiprocessing`` (start
method ``spawn``: the parent may have touched CUDA) that join one process
group through a file store in a temporary directory. Rank r runs on
``cuda:(r % device_count)``, or on the CPU when the caller asks for it.
The backend is NCCL when every rank has a card of its own and gloo when
ranks share a card or run on the CPU (``mesh.backend_for``); a rank whose
NCCL setup fails raises like any other (no rank falls back to gloo).

    results = launch(fn, n_data, n_model, *args, device=None)

runs ``fn(*args)`` on every rank (``fn`` a module-level function, so that
the ranks can import it) and returns the ranks' results in rank order,
tensors as numpy arrays. ``World`` keeps the ranks for several calls. An
exception in any rank ends every rank, and the launcher raises
``RankError`` with that rank's traceback; a rank that dies without a
result is reported the same way.

The kernels are built once in the launching process before the ranks start
(``kernels._build.build_all``), so ranks that share a card never build them
at once.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import backend_for, rank_device


# the process group's timeout: a collective that waits longer raises
_TIMEOUT = datetime.timedelta(seconds=600)


class RankError(RuntimeError):
    """A rank raised or died; ``traceback`` is what it reported."""

    def __init__(self, rank: int, traceback_text: str):
        self.rank = rank
        self.traceback = traceback_text
        super().__init__(f"rank {rank} failed:\n{traceback_text}")


def _host(value):
    """``value`` with every tensor as a numpy array (results cross the
    process boundary by value)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_host(v) for v in value)
    return value


def _report_failure(rank, results) -> None:
    """Send this rank's traceback to the launcher, flushed before the
    process group goes down, so that it precedes the errors of ranks that
    then lose their peer."""
    results.put((rank, False, traceback.format_exc()))
    results.close()
    results.join_thread()


def _rank_main(rank, n_ranks, store, backend, device, tasks, results):
    try:
        # the card first: NCCL binds a communicator to the current device
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
        if backend == "nccl":
            # every rank is a process of this host: NCCL's bootstrap (its
            # socket handshake; the collectives themselves go over NVLink)
            # stays on the loopback, which a machine without a network
            # still has, instead of searching the interfaces
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=n_ranks,
                                timeout=_TIMEOUT)
    except BaseException:
        _report_failure(rank, results)
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            fn, args = task
            try:
                results.put((rank, True, _host(fn(*args))))
            except BaseException:
                # the launcher raises it; this rank's collectives are in an
                # unknown state, so it takes no further task
                _report_failure(rank, results)
                return
    finally:
        dist.destroy_process_group()


class World:
    """``n_ranks`` rank processes in one process group, kept for several
    ``run`` calls; ``close`` (or the end of a ``with`` block) ends them."""

    def __init__(self, n_ranks: int, device=None):
        backend, why = backend_for(n_ranks, device)
        if backend == "nccl" or rank_device(0, device).type == "cuda":
            from ..kernels import _build
            _build.build_all()
        print(f"[mesh] {n_ranks} ranks, backend {backend} ({why})",
              flush=True)
        self.n_ranks = n_ranks
        self._dir = tempfile.mkdtemp(prefix="mvae_mesh_")
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(n_ranks)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main,
            args=(r, n_ranks, os.path.join(self._dir, "store"), backend,
                  device, self._tasks[r], self._results),
            daemon=True) for r in range(n_ranks)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args) -> list:
        """``fn(*args)`` on every rank; the results in rank order."""
        if not self._procs:
            raise RuntimeError("the world is closed")
        for q in self._tasks:
            q.put((fn, args))
        out, pending = [None] * self.n_ranks, set(range(self.n_ranks))
        while pending:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in sorted(pending)
                        if not self._procs[r].is_alive()]
                if dead:
                    code = self._procs[dead[0]].exitcode
                    self.close()
                    raise RankError(dead[0], f"exited with code {code} "
                                    f"without a result") from None
                continue
            if not ok:
                self.close()
                raise RankError(rank, value)
            out[rank] = value
            pending.discard(rank)
        return out

    def close(self) -> None:
        """End every rank (those blocked in a collective are terminated)
        and remove the store."""
        for p, q in zip(self._procs, self._tasks):
            if p.is_alive():
                q.put(None)
        deadline = time.time() + 10.0
        for p in self._procs:
            p.join(timeout=max(0.1, deadline - time.time()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def launch(fn, n_data: int, n_model: int = 1, *args, device=None) -> list:
    """Start n_data x n_model ranks, run ``fn(*args)`` on each (it makes
    its mesh with ``make_mesh(n_data, n_model, device)``) and return their
    results in rank order."""
    with World(n_data * n_model, device) as world:
        return world.run(fn, *args)
