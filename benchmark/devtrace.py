"""Reading a ``torch.profiler`` trace of the window: the device's operations
(kernels, copies, sets) as intervals, the union of them (busy time), the
time by kernel name, and the idle gaps labelled by what the host was doing
(the harness's own spans: the profile records the device alone).

Reads the profiler's raw events (``kineto_results.events()``), which skips
building the profiler's per-event Python tree.
"""
from __future__ import annotations

import bisect
import collections

from torch.autograd import DeviceType


def _raw_events(prof):
    return prof.profiler.kineto_results.events()


def summarize(prof, spans, window_label: str) -> dict:
    """``summarize_events`` of a finished profile and the harness's host
    spans [(name, start_ns, end_ns)]."""
    return summarize_events(_raw_events(prof), window_label, spans)


def summarize_events(events, window_label: str, spans=()) -> dict:
    """{"ops": [(name, start_ns, end_ns)] of the device, "busy_s" their
    union's length, "merged" the union, "span": (start_ns, end_ns) of the
    host's ``window_label`` range, "host": [(name, start_ns, end_ns)]} from
    the profiler's events and the host spans on its clock (a host range's
    image on the device timeline, ``record_function``'s, is no
    operation). The window's operations are those inside its span."""
    ops, host, span = [], [], None
    for ev in events:
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                ops.append((ev.name(), start, end))
        elif ev.name() == window_label:
            span = (start, end)
        else:
            host.append((ev.name(), start, end))
    for name, start, end in spans:
        if name == window_label:
            span = (start, end)
        else:
            host.append((name, start, end))
    if span is None:
        raise ValueError(f"no {window_label} span in the trace")
    ops = [o for o in ops if o[2] > span[0] and o[1] < span[1]]
    merged = _union(ops)
    return {"ops": ops, "busy_s": sum(e - s for s, e in merged) / 1e9,
            "merged": merged, "span": span, "host": host}


def _union(ops):
    out = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def time_by_name(ops) -> dict:
    """Device seconds and launches by operation name."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e in ops:
        out[name][0] += (e - s) / 1e9
        out[name][1] += 1
    return dict(out)


def matching(ops, patterns) -> tuple[float, int]:
    """(device seconds, launches) of the operations whose lowercase name
    holds any of ``patterns``."""
    secs, count = 0.0, 0
    for name, s, e in ops:
        low = name.lower()
        if any(p in low for p in patterns):
            secs += (e - s) / 1e9
            count += 1
    return secs, count


SHORT_GAP_NS = 10_000
_SHORT = "device: gaps under 10 us between operations"


def idle_gaps(summary: dict, top: int = 10) -> list:
    """The device's idle time inside the window by what the host was doing
    where each gap starts (the latest-starting host operation that covers
    that instant); gaps under 10 us, the launch latency between one
    graph's kernels, in a row of their own. The ``top`` largest."""
    span, merged = summary["span"], summary["merged"]
    gaps, t = [], span[0]
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if span[1] > t:
        gaps.append((t, span[1]))
    host = sorted(summary["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    by = collections.defaultdict(float)
    for g0, g1 in gaps:
        label = _SHORT
        if g1 - g0 >= SHORT_GAP_NS:
            label = "host: no operation recorded"
            i = bisect.bisect_right(starts, g0) - 1
            for j in range(i, max(i - 5000, -1), -1):
                if host[j][2] >= g0:
                    label = host[j][0]
                    break
        by[label] += (g1 - g0) / 1e9
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def top_ops(ops, top: int = 10) -> list:
    rows = sorted(time_by_name(ops).items(), key=lambda kv: -kv[1][0])
    return [[name, secs] for name, (secs, _) in rows[:top]]
