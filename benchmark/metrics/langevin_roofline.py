"""The Langevin sampler's least time (its function's work at the FP32 and
memory peaks, from the benchmark's own count) over its kernel's device
time, in %."""

from benchmark.metrics import langevin_ms_per_step as layer
from benchmark.trace import roofline_share


def read(ctx):
    return roofline_share(ctx, "langevin", layer.KERNELS)
