"""The trace reading on made-up profiler events: the device's busy time is
the union of its operations (host ranges mirrored on the device left out),
and each idle gap goes to the host operation running where it starts."""
from __future__ import annotations

from torch.autograd import DeviceType

import devtrace


class Ev:
    def __init__(self, name, start, end, cuda=True, kind="kernel"):
        self._n, self._s, self._d = name, start, end - start
        self._cuda, self._kind = cuda, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def activity_type(self):
        return self._kind

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")


def events():
    us = 1000
    return [Ev("win", 0, 1000 * us, cuda=False, kind="user_annotation"),
            Ev("win", 0, 1000 * us, kind="gpu_user_annotation"),
            Ev("replays", 0, 600 * us, cuda=False, kind="user_annotation"),
            Ev("cudaStreamSynchronize", 600 * us, 700 * us, cuda=False,
               kind="cuda_runtime"),
            Ev("gemm", 0, 300 * us),
            Ev("adam multi_tensor_apply_kernel", 250 * us, 400 * us),
            Ev("tail_fwd_kernel", 403 * us, 600 * us),
            Ev("memcpy", 800 * us, 900 * us, kind="gpu_memcpy")]


def test_host_ranges_on_the_device_are_no_operations():
    evs = [Ev("win", 0, 10, cuda=False, kind="user_annotation"),
           Ev("win", 0, 10, kind="gpu_user_annotation"), Ev("gemm", 2, 5)]
    s = devtrace.summarize_events(evs, "win")
    assert [o[0] for o in s["ops"]] == ["gemm"]


def test_busy_is_the_union_of_device_operations():
    s = devtrace.summarize_events(events(), "win")
    assert s["span"] == (0, 1000_000_000 // 1000)
    assert len(s["ops"]) == 4
    assert abs(s["busy_s"] - (400 + 197 + 100) * 1e-6) < 1e-12
    assert devtrace.matching(s["ops"], ("multi_tensor",)) == (150e-6, 1)


def test_host_spans_label_the_gaps_and_bound_the_window():
    evs = [e for e in events() if e.device_type() == DeviceType.CUDA]
    spans = [("win", 0, 1_000_000), ("sync", 600_000, 700_000)]
    s = devtrace.summarize_events(evs, "win", spans)
    assert dict(devtrace.idle_gaps(s))["sync"] == 200e-6
    late = [(n, a + 10**12, b + 10**12) for n, a, b in spans]
    s = devtrace.summarize_events(evs, "win", late)
    assert s["ops"] == [] and s["busy_s"] == 0


def test_idle_gaps_are_labelled_by_the_host():
    s = devtrace.summarize_events(events(), "win")
    gaps = dict(devtrace.idle_gaps(s))
    assert abs(gaps["cudaStreamSynchronize"] - 200e-6) < 1e-12
    assert abs(gaps[devtrace._SHORT] - 3e-6) < 1e-12
    assert abs(gaps["host: no operation recorded"] - 100e-6) < 1e-12
    top = devtrace.top_ops(s["ops"], 2)
    assert top[0][0] == "gemm"
