"""The training decode kernel's (B6, ``train_decode_kernel``) share of its
roofline: the least time of one launch at the cell's shapes
(``work.train_decode``: the forward products at the float32-grade 165
TFLOP/s, or each byte read and written once at 3.35 TB/s, the larger) over
its mean device time a launch in the traced window."""

PATTERNS = ("train_decode_kernel",)


def read(ctx):
    tr = ctx["trace"]
    if ctx["program"] != "train" or tr is None:
        return None
    from devtrace import matching
    secs, count = matching(tr["ops"], PATTERNS)
    if not count:
        return None
    s, w = ctx["shapes"], ctx["work"]
    c = w.train_decode(s["batch"], s["Z"], s["H"], s["D"])
    return 100.0 * w.least_time_s(c["flops"], c["bytes"], ctx["peaks"]) / (
        secs / count)
