"""The IWAE pass's share of the card's float32-grade peak: an example's
forward matrix products (encoder and heads once, the decoder's two
products once a sample: ``work.iwae_example_flops``) times a pass's
examples, over the wall of a pass in the untraced stretch that precedes
the traced window, over 165 TFLOP/s."""


def read(ctx):
    if ctx["program"] != "iwae" or ctx["trace"] is None:
        return None
    s, w = ctx["shapes"], ctx["work"]
    flops = w.iwae_example_flops(s["D"], s["H"], s["W"], s["Z"],
                                 s["samples"])
    rate = flops * ctx["examples_per_unit"] / ctx["unit_s"]
    return 100.0 * rate / (ctx["peaks"]["float32_grade_tflops"] * 1e12)
