"""Device milliseconds a step of the operations that no port source
defines: PyTorch's own kernels, copies and fills under the losses, the
samplers and the optimizer."""

from benchmark.trace import matches


def read(ctx):
    s = ctx.summary
    us = sum(v for k, v in s.device_us.items() if not matches(k, s.port_kernels))
    return 1e-3 * us / ctx.steps
