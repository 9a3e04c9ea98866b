"""The conv layers' share of their roofline in a training step: the least
time of the four convolutions' forward, data-gradient and weight-gradient
products at the cell's batch (the model family's ``work(...)["conv_step"]``,
``work.least_time_s``: the products at the float32-grade 165 TFLOP/s, or
each operand read and each result written once at 3.35 TB/s, the larger)
over the device time a step of the layers that run them (``encode``: conv1
and conv2; ``decode_conv``: the transposed convs and the likelihood;
``bwd_decode``: their backward; ``bwd_encode_conv``: the convs' backward;
``layerspans.units``). None where the family counts no conv work or the
trace holds no step with the conv layers' markers."""

LAYERS = ("encode", "decode_conv", "bwd_decode", "bwd_encode_conv")


def read(ctx):
    tr = ctx["trace"]
    conv = ctx["model_work"].get("conv_step")
    if ctx["program"] != "train" or tr is None or conv is None:
        return None
    import layerspans
    steps = [u for u in layerspans.units(tr["ops"])
             if {"decode_conv", "bwd_encode_conv"}
             <= {l["layer"] for l in u["layers"]}]
    if not steps:
        return None
    ns = sum(layerspans.layer_time(steps, layer) for layer in LAYERS)
    if ns <= 0:
        return None
    least = ctx["work"].least_time_s(conv["flops"], conv["bytes"],
                                     ctx["peaks"])
    return 100.0 * least / (ns / 1e9 / len(steps))
