"""Device milliseconds a step of the blockwise pairwise provider's kernels
(csrc/pairwise.cu: K5-K8 and the row sums that finish them)."""

KERNELS = ("k5_kernel", "k6_kernel", "k7_kernel", "k8_kernel", "pw_fwd_kernel", "pw_bwd_kernel",
           "sum_rows_kernel", "sum_rows_in_order_kernel")


def read(ctx):
    return ctx.per_step_ms(KERNELS)
