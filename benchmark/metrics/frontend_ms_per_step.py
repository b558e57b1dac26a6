"""Device milliseconds a step of the Fourier front end's kernels under the
fused pointwise provider (csrc/pointwise.cu: K9, K10)."""

KERNELS = ("k9_kernel", "k10_kernel")


def read(ctx):
    return ctx.per_step_ms(KERNELS)
