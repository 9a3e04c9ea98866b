"""The optimizer's share of the device's busy time in the traced window:
``torch.optim.Adam`` (foreach, capturable) runs as the foreach kernels
(``multi_tensor_apply_kernel``), which nothing else in the step launches."""

PATTERNS = ("multi_tensor_apply",)


def read(ctx):
    tr = ctx["trace"]
    if ctx["program"] != "train" or tr is None or tr["busy_s"] <= 0:
        return None
    from devtrace import matching
    secs, count = matching(tr["ops"], PATTERNS)
    return 100.0 * secs / tr["busy_s"] if count else None
