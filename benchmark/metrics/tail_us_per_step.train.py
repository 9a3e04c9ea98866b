"""Device time of the tail kernels a training step: the forward (B1,
``tail_fwd_kernel*``) and the backward (B3, ``tail_bwd_kernel*``), from the
traced window's kernels, over its steps."""

PATTERNS = ("tail_fwd_kernel", "tail_bwd_kernel")


def read(ctx):
    tr = ctx["trace"]
    if ctx["program"] != "train" or tr is None:
        return None
    from devtrace import matching
    secs, count = matching(tr["ops"], PATTERNS)
    steps = ctx["units"] * ctx["steps_per_unit"]
    return 1e6 * secs / steps if count else None
