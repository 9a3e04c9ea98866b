"""The device's idle share of the traced window of the train cell: 100 less
the device's busy time (the union of its operations' intervals) over the
window's wall, both from the profiler's trace. The profiler slows the
host's issue of a graph, so this reads some points above an untraced
epoch's idle share; the busy time of one stretch is never set against the
wall of another."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["program"] != "train" or tr is None or tr["busy_s"] <= 0:
        return None
    start, end = tr["span"]
    return 100.0 * (1.0 - tr["busy_s"] / ((end - start) / 1e9))
