"""Device milliseconds a step of the host-to-device copies: the streaming
loader's upload of each chunk's gathered batches (``pde.upload``,
training/trainer.py) and any other such copy of the step."""

KERNELS = ("Memcpy HtoD",)


def read(ctx):
    return ctx.per_step_ms(KERNELS)
