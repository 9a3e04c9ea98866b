"""Tracing and a NaN/Inf guard: the port's counterpart of
``mvae_tpu/utils/profiling.py``.

``trace(log_dir)`` records a ``torch.profiler`` trace of a block (host ops,
and on a CUDA device the card's kernels through CUPTI) and writes it as a
Chrome trace JSON under ``log_dir`` (open it in Perfetto or
chrome://tracing):

    with profiling.trace("runs/profile"):
        trainer.train_one_epoch(0)

Layer spans, on only while a torch profiler records (``recording()``:
there is no switch of their own). ``span(name)`` is a host span: its
``(name, start_ns, end_ns, parent)`` on ``time.time_ns``, the clock of the
profiler's events, goes to ``host_spans()``, and it is a ``record_function``
range of the trace too. ``mark(layer, like)`` is a layer boundary on
``like``'s device: on a card a one-thread empty kernel
``mvae_span_<layer>`` (``kernels/csrc/spans.cu``, one a name of ``LAYERS``)
on the current stream, so a layer runs on the device from its marker to the
next and ``mvae_span_end`` closes a unit (a training step, an eval batch);
on the CPU an instant host span of that name. Off, both return after one
check. A CUDA graph keeps no host range, so ``train.graphs`` captures a
second graph of each body with its markers (``marking(True)``) and replays
it while the profiler records. ``counters["host_syncs"]`` counts the
program's device-to-host reads.

``enable_nan_guard()`` / ``disable_nan_guard()`` are the counterpart of the
reference's ``jax_debug_nans`` + ``jax_debug_infs``: while on, every
PyTorch op whose floating output holds a NaN or an Inf raises
``FloatingPointError`` naming the op (a ``TorchDispatchMode`` that checks
each op's outputs), and autograd's anomaly mode names the forward op of a
backward that produced a NaN. The hand-written CUDA kernels are called
through ``ctypes`` and bypass the dispatcher, so their wrappers check their
own outputs with ``check_outputs``. Every check waits for the device: the
guard is for debugging, not for measured runs.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
# ops whose output is uninitialized memory: nothing computed it yet
_UNINITIALIZED = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                  _aten.new_empty, _aten.new_empty_strided}


# the layers of a unit, in the order a training step and an IWAE batch
# mark them (the ``_fc`` and ``_conv`` layers: the conv nets' only);
# ``kernels/csrc/spans.cu`` defines one marker kernel a name
LAYERS = ("encode", "encode_fc", "tail", "decode", "decode_conv", "loss",
          "bwd_decode", "bwd_decode_fc", "bwd_tail", "bwd_encode",
          "bwd_encode_conv", "optimizer", "reparam", "logsumexp", "end")
_INDEX = {layer: i for i, layer in enumerate(LAYERS)}

counters = {"host_syncs": 0}

_HOST: list = []        # (name, start_ns, end_ns, parent) of finished spans
_OPEN: list = []        # names of the open host spans, innermost last
_FORCED: list = []      # marking(on)'s stack: it overrides recording()
_NOOP = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch profiler records: the one switch of the spans."""
    return torch.autograd._profiler_enabled()


def markers_on() -> bool:
    """Whether ``mark`` launches: while the profiler records, unless a
    ``marking`` block says otherwise."""
    return _FORCED[-1] if _FORCED else recording()


def host_spans() -> list:
    """The host spans recorded so far, in the order they ended."""
    return list(_HOST)


def clear_host_spans() -> None:
    _HOST.clear()


def host_sync(name: str):
    """A device-to-host read of the program: counted in
    ``counters["host_syncs"]``, and a host span ``name`` around it."""
    counters["host_syncs"] += 1
    return span(name)


def no_span(name: str):
    """``span`` for a caller that has already found the spans off."""
    return _NOOP


def span(name: str):
    """A host span ``name`` around a block while the profiler records; the
    shared no-op context otherwise."""
    if not recording():
        return _NOOP
    return _Span(name)


class _Span:
    """A host span, and the profiler's low-cost range of the same name
    (kept where the profiler records the CPU's activity)."""

    __slots__ = ("name", "parent", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _OPEN[-1] if _OPEN else None
        _OPEN.append(self.name)
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.range.__exit__(*exc)
        _OPEN.pop()
        _HOST.append((self.name, self.t0, t1, self.parent))
        return False


@contextlib.contextmanager
def marking(on: bool):
    """Markers on (or off) inside the block whatever the profiler does: a
    CUDA graph's capture, which runs nothing, takes its markers from this,
    and a profile that times the plain program turns them off."""
    _FORCED.append(on)
    try:
        yield
    finally:
        _FORCED.pop()


def mark(layer: str, like) -> None:
    """The start of ``layer`` on the device of the tensor ``like``: a
    marker kernel on the current CUDA stream, or an instant host span on
    the CPU. Nothing while the markers are off."""
    if not markers_on():
        return
    index = _INDEX[layer]
    if like.device.type == "cuda":
        _launch_marker(index, like.device)
        return
    with _RecordFunctionFast(f"mvae_span_{layer}"):
        t = time.time_ns()
    _HOST.append((f"mvae_span_{layer}", t, t, _OPEN[-1] if _OPEN else None))


def mark_grad(t, layer: str) -> None:
    """Mark ``layer`` when the backward reaches ``t``'s gradient (a hook
    registered only while the markers are on, on a tensor that needs
    one)."""
    if not (t.requires_grad and markers_on()):
        return
    t.register_hook(lambda g: mark(layer, g))


def _launch_marker(index: int, device) -> None:
    from ..kernels import _build
    _build.check(_marker_launcher()(
        index, torch.cuda.current_stream(device).cuda_stream),
        f"the marker mvae_span_{LAYERS[index]}")


@functools.lru_cache(maxsize=None)
def _marker_launcher():
    """``csrc/spans.cu``'s launcher, the library built at first use."""
    from ..kernels import _build
    launch = _build.load("spans").mvae_span_launch
    launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return launch


@contextlib.contextmanager
def trace(log_dir: str = "runs/profile", device=None):
    """Profile the block and write ``<log_dir>/trace_<pid>_<ns>.json``.

    CUDA activity is recorded when ``device`` is a CUDA device, or, with no
    device named, whenever a card is present. The program's spans are on
    inside: the trace shows the host spans as ranges and, on a card, the
    marker kernels between each layer's kernels; ``host_spans()`` holds
    the block's spans. Yields the profiler; the file is written when the
    block ends, also when it raises."""
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_host_spans()
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield prof
            finally:
                if cuda:
                    torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _nonfinite(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and not bool(torch.isfinite(t).all()))


class _NanGuard(TorchDispatchMode):
    """Raises on the first op with a non-finite floating output. Views and
    the allocators of uninitialized memory compute no value and are not
    checked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in _UNINITIALIZED:
            return out
        if any(_nonfinite(t) for t in tree_leaves(out)):
            raise FloatingPointError(f"non-finite value (NaN or Inf) in the "
                                     f"output of {func}")
        return out


_GUARD: list[_NanGuard] = []


def nan_guard_enabled() -> bool:
    return bool(_GUARD)


def enable_nan_guard() -> None:
    """Fail fast, naming the op, on any NaN or Inf an op produces (slow;
    debugging only). Applies to this thread and to autograd's backward."""
    if _GUARD:
        return
    torch.autograd.set_detect_anomaly(True)
    mode = _NanGuard()
    mode.__enter__()
    _GUARD.append(mode)


def disable_nan_guard() -> None:
    if not _GUARD:
        return
    _GUARD.pop().__exit__(None, None, None)
    torch.autograd.set_detect_anomaly(False)


def check_outputs(name: str, *tensors) -> None:
    """With the guard on, raise if a kernel's output holds a NaN or an Inf
    (the CUDA kernels' wrappers call this: ctypes bypasses the dispatcher);
    a no-op otherwise."""
    if not _GUARD:
        return
    with _disable_current_modes():      # the check's own ops go unchecked
        bad = any(_nonfinite(t) for t in tensors)
    if bad:
        raise FloatingPointError(f"non-finite value (NaN or Inf) in the "
                                 f"output of the kernel {name}")
