"""Device milliseconds a step of the kinetic Langevin sampler's kernel
(csrc/langevin.cu: K1, K2)."""

KERNELS = ("langevin_kernel",)


def read(ctx):
    return ctx.per_step_ms(KERNELS)
