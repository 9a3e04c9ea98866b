"""The device's idle share inside the program's units of the train cell:
over the traced window's whole units (a training step, from its ``encode``
marker to ``end``, ``layerspans.units``), their time with no device
operation running over their time, the markers' own time and the gap after
each left out of both. None where the trace holds no marker (a program
without layer spans)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["program"] != "train" or tr is None:
        return None
    import layerspans
    return layerspans.gap_pct(layerspans.units(tr["ops"]))
