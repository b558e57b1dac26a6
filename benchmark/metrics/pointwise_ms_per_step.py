"""Device milliseconds a step of the fused pointwise provider's kernels
(csrc/pointwise.cu: K3, K4 and K4's reduction)."""

KERNELS = ("k3_kernel", "k4_kernel", "k4_reduce")


def read(ctx):
    return ctx.per_step_ms(KERNELS)
