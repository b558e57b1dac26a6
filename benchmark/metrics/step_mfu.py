"""The whole step's model FLOPs (the benchmark's own count) over the time
a step takes untraced and the card's FP32 peak, in %."""


def read(ctx):
    if ctx.peak is None:
        return None
    return 100.0 * ctx.work["step"]["flops"] / ctx.step_s / ctx.peak["fp32_flops"]
