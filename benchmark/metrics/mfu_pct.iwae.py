"""The IWAE pass's share of the card's float32-grade peak: an example's
forward matrix products (for the MLP: encoder and heads once, the
decoder's two products once a sample; its reference module's
``work(...)["iwae_example_flops"]``) times a pass's
examples, over the wall of a pass in the untraced stretch that precedes
the traced window, over 165 TFLOP/s."""


def read(ctx):
    if ctx["program"] != "iwae" or ctx["trace"] is None:
        return None
    flops = ctx["model_work"]["iwae_example_flops"]
    rate = flops * ctx["examples_per_unit"] / ctx["unit_s"]
    return 100.0 * rate / (ctx["peaks"]["float32_grade_tflops"] * 1e12)
