"""Sum of ``sparse_accum``'s bounds (the events of these inputs) over its
device time in the traced window."""

from perfbench.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "sparse_accum_kernel")
