"""The program's layer spans in a traced window: the device's operations cut
at the program's marker kernels (``mvae_span_<layer>``, launched at each
layer boundary of a training step and an IWAE batch while a profiler
records), and the program's own host spans.

A unit (a step, an eval batch) opens at an ``encode`` marker and closes at
``end``; a layer runs from its marker to the next. A marker's own time and
the gap from it to the next operation would not be there without the
marker, so no layer counts them: a layer's interval runs from the first
operation after its marker to the next marker's start, and the unit's last
layer ends with its last operation. A unit that the window cuts (its
``encode`` or its ``end`` outside) is left out, as is a unit opened again
before its ``end``. The units are read from the marker names alone;
``program_host_spans`` reads the program's list of host spans as data.
"""
from __future__ import annotations

import devtrace

PREFIX = "mvae_span_"
FIRST, LAST = "encode", "end"


def _busy(ops, start: int, end: int) -> int:
    """The length of the union of ``ops`` [(start, end)] clipped to
    [start, end]."""
    clipped = [("", max(s, start), min(e, end)) for s, e in ops
               if min(e, end) > max(s, start)]
    return sum(e - s for s, e in devtrace._union(clipped))


def _close(layers: list) -> dict:
    """A unit from its layers [(layer, marker start, [(start, end)])]."""
    out = []
    for i, (name, _, ops) in enumerate(layers):
        if i + 1 < len(layers):
            end = layers[i + 1][1]
        else:
            end = max((e for _, e in ops), default=0)
        start = min((s for s, _ in ops), default=end)
        end = max(end, start)
        out.append({"layer": name, "start": start, "end": end,
                    "busy": _busy(ops, start, end), "ops": len(ops)})
    return {"layers": out, "interval": sum(l["end"] - l["start"] for l in out),
            "busy": sum(l["busy"] for l in out),
            "ops": sum(l["ops"] for l in out)}


def units(ops) -> list:
    """The window's whole units from its device operations [(name,
    start_ns, end_ns)], in order: each {"layers": [{"layer", "start",
    "end", "busy", "ops"}], "interval", "busy", "ops"} in ns (busy: the
    union of the operations inside the interval; ops: how many, markers
    left out)."""
    out, layers = [], None
    for name, s, e in sorted(ops, key=lambda o: (o[1], o[2])):
        if not name.startswith(PREFIX):
            if layers is not None:
                layers[-1][2].append((s, e))
            continue
        tag = name[len(PREFIX):]
        if tag == FIRST:
            layers = [(tag, s, [])]
        elif layers is not None and tag == LAST:
            out.append(_close(layers))
            layers = None
        elif layers is not None:
            layers.append((tag, s, []))
    return out


def layer_time(unit_list, layer: str) -> int:
    """ns of ``layer``'s intervals over the units."""
    return sum(l["end"] - l["start"] for u in unit_list for l in u["layers"]
               if l["layer"] == layer)


def gap_pct(unit_list):
    """The device's idle share inside the units' intervals, or None."""
    total = sum(u["interval"] for u in unit_list)
    if total <= 0:
        return None
    return 100.0 * (total - sum(u["busy"] for u in unit_list)) / total


def program_host_spans():
    """The program's host spans [(name, start_ns, end_ns, parent)], or None
    where the program keeps none (read as data)."""
    try:
        from mvae_torch.utils import profiling
        return profiling.host_spans()
    except (ImportError, AttributeError):
        return None


def issue_idle_pct(summary: dict, spans, prefixes) -> float | None:
    """The device's idle time in gaps of 10 us or more inside
    the window (``devtrace.summarize``'s "merged" and "span") that the
    host spent in the program's spans whose names start with one of
    ``prefixes``, over the window's wall; None where the window holds no
    such span."""
    lo, hi = summary["span"]
    host = devtrace._union([(name, max(s, lo), min(e, hi))
                            for name, s, e, *_ in spans
                            if name.startswith(tuple(prefixes))
                            and e > lo and s < hi])
    if not host or hi <= lo:
        return None
    gaps, t = [], lo
    for s, e in summary["merged"]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    idle, j = 0, 0
    for g0, g1 in gaps:
        if g1 - g0 < devtrace.SHORT_GAP_NS:
            continue
        while j < len(host) and host[j][1] <= g0:
            j += 1
        k = j
        while k < len(host) and host[k][0] < g1:
            idle += max(0, min(g1, host[k][1]) - max(g0, host[k][0]))
            k += 1
    return 100.0 * idle / (hi - lo)
