"""Device operations (kernels, copies, fills) launched a step: what the
trainer, the optimizer and the losses' PyTorch code dispatch from the host."""


def read(ctx):
    return sum(ctx.summary.counts.values()) / ctx.steps
