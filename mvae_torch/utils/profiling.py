"""Tracing and a NaN/Inf guard: the port's counterpart of
``mvae_tpu/utils/profiling.py``.

``trace(log_dir)`` records a ``torch.profiler`` trace of a block (host ops,
and on a CUDA device the card's kernels through CUPTI) and writes it as a
Chrome trace JSON under ``log_dir`` (open it in Perfetto or
chrome://tracing):

    with profiling.trace("runs/profile"):
        trainer.train_one_epoch(0)

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
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
# ops whose output is uninitialized memory: nothing computed it yet
_UNINITIALIZED = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                  _aten.new_empty, _aten.new_empty_strided}


@contextlib.contextmanager
def trace(log_dir: str = "runs/profile", device=None):
    """Profile the block and write ``<log_dir>/trace_<pid>_<ns>.json``.

    CUDA activity is recorded when ``device`` is a CUDA device, or, with no
    device named, whenever a card is present. Yields the profiler; the file
    is written when the block ends, also when it raises."""
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
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
