"""The IWAE decode kernel's (B2, ``decode_bce_kernel``) share of its
roofline: the least time of one launch at (S, B) = (the samples a launch,
the eval batch) and the cell's widths (``work.decode_bce``: the forward
products at the float32-grade 165 TFLOP/s, or each byte read and written
once at 3.35 TB/s, the larger) over its mean device time a launch."""

PATTERNS = ("decode_bce_kernel",)


def read(ctx):
    tr = ctx["trace"]
    if ctx["program"] != "iwae" or tr is None:
        return None
    from devtrace import matching
    secs, count = matching(tr["ops"], PATTERNS)
    if not count:
        return None
    s, w = ctx["shapes"], ctx["work"]
    c = w.decode_bce(s["decode_samples"], s["eval_batch"], s["Z"], s["H"],
                     s["D"])
    return 100.0 * w.least_time_s(c["flops"], c["bytes"], ctx["peaks"]) / (
        secs / count)
