"""The optimizer layer's device time a training step: the interval of the
``optimizer`` layer (from its marker to the step's ``end``: the curvature
mask and Adam's foreach kernels, the gaps between them included) over the
traced window's whole steps (``layerspans.units``). Reads the layer by its
marker, not by the optimizer's kernel names. None where the trace holds no
marker."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["program"] != "train" or tr is None:
        return None
    import layerspans
    steps = layerspans.units(tr["ops"])
    if not steps:
        return None
    return layerspans.layer_time(steps, "optimizer") / 1e3 / len(steps)
