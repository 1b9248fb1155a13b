"""The whole train step's share of the card's bf16 peak: the model FLOPs
of the timed window's steps (``counts.step_model_flops``, fixed by the
shapes) over its device time times 989 TFLOP/s, in percent."""


def read(ctx):
    c = ctx["counts"]
    flops = c.total_model_flops(ctx["shape"]) * ctx["steps"]
    return 100.0 * flops / (ctx["event_s"] * c.PEAK_BF16)
