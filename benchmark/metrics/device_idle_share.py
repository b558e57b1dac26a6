"""The share of a step in which no operation ran on the device, in %: the
traced chunk's device-busy time a step over the time a step of the same
chunk run untraced just before it (the profiler slows the host, so the
traced window's own length would overstate the idle time)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.summary.busy_s / ctx.steps / ctx.step_s)
