"""Dense-equivalent integer operations of the candidates scored in the traced
window, over the window, as a share of the int8 tensor-core peak."""

from perfbench.trace import mfu_pct as read  # noqa: F401
