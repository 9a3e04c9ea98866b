"""The training step's share of the card's float32-grade peak: the
model's executed matrix products a step (its reference module's
``work(...)["train_step"]``, from shapes) times an epoch's steps, over the wall of an epoch in the untraced stretch
that precedes the traced window, over 165 TFLOP/s (the data sheet's dense
TF32 495 TFLOP/s over the three TF32 products a float32-grade product
costs)."""


def read(ctx):
    if ctx["program"] != "train" or ctx["trace"] is None:
        return None
    macs = ctx["model_work"]["train_step"]["executed_macs"]
    rate = 2 * macs * ctx["steps_per_unit"] / ctx["unit_s"]
    return 100.0 * rate / (ctx["peaks"]["float32_grade_tflops"] * 1e12)
