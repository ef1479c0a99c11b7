"""100 - the card's busy share of the traced window (torch.profiler)."""

from perfbench.trace import idle_pct as read  # noqa: F401
