"""Sum of ``spike_matmul``'s bounds over its device time in the traced window."""

from perfbench.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "spike_matmul_kernel")
