"""The device's idle time that the host spent in the program's epoch loop,
as a share of the traced window: gaps of 10 us or more between the
device's operations, where they overlap the program's host spans of the
epoch (``epoch.copy_in``, ``epoch.replays``, ``epoch.stats_read``) and of
its graph calls (``graph.*``), over the window's wall. The spans are read
from the program's list (``profiling.host_spans``) as data; None where the
program keeps none."""

PREFIXES = ("epoch.", "graph.")


def read(ctx):
    tr = ctx["trace"]
    if ctx["program"] != "train" or tr is None:
        return None
    import layerspans
    spans = layerspans.program_host_spans()
    if spans is None:
        return None
    return layerspans.issue_idle_pct(tr, spans, PREFIXES)
