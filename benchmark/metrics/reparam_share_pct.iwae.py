"""The reparameterization's share of the IWAE eval batch: the ``reparam``
layers' intervals (a chunk's draws, densities and the chunk's head GEMM,
before its decode) over the batches' intervals, from the traced window's
whole batches (``layerspans.units``). None where the trace holds no
marker."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["program"] != "iwae" or tr is None:
        return None
    import layerspans
    batches = layerspans.units(tr["ops"])
    total = sum(b["interval"] for b in batches)
    if total <= 0:
        return None
    return 100.0 * layerspans.layer_time(batches, "reparam") / total
